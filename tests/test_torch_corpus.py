"""The port's corpora held to the JAX package's pins: a mirror of
tests/test_corpus.py (the recorded-session corpora under tests/corpus/
replay to the digests of tests/corpus/pins.json, and the keystroke corpus
through the bulk path equals its scalar replay) and of
tests/test_quality_gates.py::TestSnapshotPins::test_formats_match_pins
(the port's snapshot digests equal tests/snapshots/pinned.json).

The pins are the JAX package's; the port reads them and never writes
them. Its channels and containers run on the CPU here (device="cpu").
"""

import json
import os
import runpy
import sys

import pytest
import torch

from fluidframework_tpu_torch.testing import corpus as C
from fluidframework_tpu_torch.testing import snapshot_corpus as S

torch.set_num_threads(1)

PINS = C.load_pins()
SNAPSHOT_PINS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "snapshots", "pinned.json")


@pytest.mark.parametrize("workload", sorted(PINS))
def test_replay_matches_pin(workload):
    pin = PINS[workload]
    path = os.path.join(C.CORPUS_DIR, pin["file"])
    assert C.replay_digest(path, device="cpu") == pin["digest"]


def test_corpus_rows_are_wellformed():
    assert sorted(PINS) == ["directory_merge", "keystroke", "matrix_storm",
                            "number_sequence"]
    for workload, pin in PINS.items():
        header, rows = C.read_corpus(os.path.join(C.CORPUS_DIR, pin["file"]))
        assert len(rows) == pin["ops"]
        seqs = [r["sequence_number"] for r in rows]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        assert header["channel_type"] in ("sequence", "items",
                                          "matrix", "directory")


def test_text_corpus_bulk_replay_matches_scalar():
    """The keystroke corpus through MergeTreeClient.apply_bulk (the plain
    scan here, the scan-apply kernel on the card) equals the scalar
    replay; both consume corpus.channel_ops."""
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient

    pin = PINS["keystroke"]
    header, rows = C.read_corpus(os.path.join(C.CORPUS_DIR, pin["file"]))
    scalar_chan = C.replay(header, rows, device="cpu")
    tail = [(contents, seq, ref, ordinal, msn or 0)
            for contents, seq, ref, ordinal, msn
            in C.channel_ops(header, rows)]
    bulk = MergeTreeClient(client_id=999, device="cpu")
    bulk.apply_bulk(tail)
    assert bulk.get_text() == scalar_chan.get_text()


def test_replay_channels_take_their_device(monkeypatch):
    """A corpus replica runs on `device` (a detached runtime's), the card
    by default: without CUDA make_channel raises."""
    for kind in ("sequence", "items", "matrix", "directory"):
        assert C.make_channel(kind, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unknown corpus channel type"):
        C.make_channel("tree", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.make_channel("sequence")


def test_formats_match_pins():
    with open(SNAPSHOT_PINS) as f:
        pinned = json.load(f)
    assert S.corpus_digests(device="cpu") == pinned
    assert os.path.realpath(S.PINS_PATH) == os.path.realpath(SNAPSHOT_PINS)


def test_pins_are_read_never_written(tmp_path, monkeypatch, capsys):
    """fluidframework_tpu/testing/snapshot_corpus.py __main__: run with no
    argument, the JAX module writes its digests to the relative path
    tests/snapshots/pinned.json, the pin file it is held to when run from
    the repository's root. The port's module prints them instead, and its
    write_pins refuses the pin file."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tests" / "snapshots").mkdir(parents=True)
    with open(SNAPSHOT_PINS) as f:
        pinned = json.load(f)
    monkeypatch.setattr(sys, "argv", ["snapshot_corpus"])
    name = "fluidframework_tpu.testing.snapshot_corpus"
    monkeypatch.delitem(sys.modules, name, raising=False)
    runpy.run_module(name, run_name="__main__")
    written = tmp_path / "tests" / "snapshots" / "pinned.json"
    assert json.loads(written.read_text()) == pinned
    written.unlink()
    assert S.main(["--device", "cpu"]) == 0
    assert not written.exists()
    printed = capsys.readouterr().out
    assert all(f"{name}: {digest}" in printed
               for name, digest in pinned.items())
    with pytest.raises(ValueError, match="never writes"):
        S.write_pins(S.PINS_PATH, device="cpu")
    out = tmp_path / "digests.json"
    assert S.write_pins(str(out), device="cpu") == pinned
    assert json.loads(out.read_text()) == pinned
