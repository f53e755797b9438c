"""The port's corpus recorder (testing/record_corpus.py): real multi-client
sessions over the port's Tinylicious, fetched back through alfred's
/deltas route and written as corpora with pins.

It records only into the directory it is given: each workload is recorded
into a temporary directory at a small size (the recorder asserts that a
fresh replica replaying the written log reaches the live clients' state),
the port's testing/corpus.replay reads what it wrote, and so does the JAX
package's. tests/corpus/, whose pins the port replays, is refused and left
as it is.
"""

import hashlib
import os

import pytest
import torch

from fluidframework_tpu_torch.testing import corpus, record_corpus

torch.set_num_threads(1)

WORKLOADS = {"text": "keystroke", "matrix": "matrix_storm",
             "directory": "directory_merge", "items": "number_sequence"}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_records_replay_equal_to_live(name, tmp_path):
    pins = record_corpus.main(str(tmp_path), {name}, device="cpu",
                              n_ops=60)
    workload = WORKLOADS[name]
    assert set(pins) == {workload}
    path = tmp_path / pins[workload]["file"]
    assert pins[workload]["ops"] > 0
    # The port's replay reads what the recorder wrote, to the pinned
    # digest; so does the JAX package's (the format is the reference's).
    assert corpus.replay_digest(str(path), device="cpu") == \
        pins[workload]["digest"]
    from fluidframework_tpu.testing import corpus as jax_corpus
    assert jax_corpus.replay_digest(str(path)) == pins[workload]["digest"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["pins.json", pins[workload]["file"]])


def _tree_digest(root: str) -> str:
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            with open(os.path.join(dirpath, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_pinned_corpora_are_refused(tmp_path):
    before = _tree_digest(corpus.CORPUS_DIR)
    for target in (corpus.CORPUS_DIR,
                   os.path.join(corpus.CORPUS_DIR, "sub"),
                   os.path.join(corpus.CORPUS_DIR, ".")):
        with pytest.raises(ValueError, match="pinned corpora"):
            record_corpus.main(target, {"text"}, device="cpu", n_ops=4)
    assert _tree_digest(corpus.CORPUS_DIR) == before
    assert not os.path.exists(os.path.join(corpus.CORPUS_DIR, "sub"))


def test_outdir_is_required():
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.testing."
         "record_corpus"], cwd=repo, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode != 0
    assert "usage" in proc.stderr
