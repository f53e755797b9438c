"""Snapshot-format regression corpus.

Capability parity with reference packages/test/snapshots (replays recorded
documents and byte-compares generated snapshots across code versions) and
sequence/src/test/snapshotVersion.spec.ts (pins the serialized snapshot
format against checked-in files): deterministic builders produce documents
covering every serialization path; their canonical summary bytes are
hashed and pinned in tests/snapshots/pinned.json. A pin mismatch means the
on-disk format changed — either a regression, or an intentional format
evolution that must update the pin file (and, in a live deployment, ship a
format-version bump with a loader for the old format).

A port of fluidframework_tpu's testing/snapshot_corpus.py. The builders
run their containers on `device` (None means "cuda", which raises without
CUDA). The port holds its digests to the JAX package's pins in
tests/snapshots/pinned.json and never writes that file: `write_pins`
refuses it, and running this module with no path prints the digests
instead of writing them.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
from typing import Callable, Dict

from ..dds.directory import SharedDirectory
from ..dds.map import SharedMap
from ..dds.matrix import SharedMatrix
from ..dds.sequence import SharedNumberSequence, SharedString
from ..loader.container import Container
from ..loader.drivers.local import LocalDocumentServiceFactory
from ..protocol.summary import summary_tree_to_dict
from ..server.local_server import LocalServer


# The JAX package's pins, which the port reads and never writes.
PINS_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "snapshots",
    "pinned.json")


def _detached(doc_id: str, device) -> Container:
    service = LocalDocumentServiceFactory(
        LocalServer()).create_document_service(doc_id)
    return Container.create_detached(doc_id, service, device=device)


def _commit_detached(container: Container) -> Container:
    """Fold pending detached edits into permanent channel state (the attach
    path does this via store.connect) WITHOUT attaching — attaching would
    pull in wire client ids (uuid-based) and break determinism."""
    for store in container.runtime.datastores.values():
        store.connect()
    return container


def build_text_document(device=None) -> Container:
    c = _detached("pin-text", device)
    ds = c.runtime.create_datastore("default")
    text = ds.create_channel("text", SharedString.TYPE)
    text.insert_text(0, "The quick brown fox jumps over the lazy dog. " * 8)
    text.insert_marker(45, {"type": "paragraph"})
    text.annotate_range(4, 9, {"fontWeight": "bold"})
    text.remove_text(10, 16)
    text.insert_text(0, "Title\n", {"header": 1})
    return _commit_detached(c)


def build_kv_document(device=None) -> Container:
    c = _detached("pin-kv", device)
    ds = c.runtime.create_datastore("default")
    m = ds.create_channel("map", SharedMap.TYPE)
    for i in range(16):
        m.set(f"key-{i:02d}", {"index": i, "squares": [i, i * i]})
    m.delete("key-03")
    d = ds.create_channel("dir", SharedDirectory.TYPE)
    d.set("top", "level")
    sub = d.create_sub_directory("nested")
    sub.set("deep", {"a": [1, 2, 3]})
    return _commit_detached(c)


def build_matrix_document(device=None) -> Container:
    random.seed(1234)  # permutation-vector run nonces draw from global rng
    c = _detached("pin-matrix", device)
    ds = c.runtime.create_datastore("default")
    mx = ds.create_channel("matrix", SharedMatrix.TYPE)
    mx.insert_rows(0, 8)
    mx.insert_cols(0, 4)
    for r in range(8):
        mx.set_cell(r, r % 4, r * 10)
    mx.remove_rows(2, 2)
    return _commit_detached(c)


def build_sequence_document(device=None) -> Container:
    c = _detached("pin-numseq", device)
    ds = c.runtime.create_datastore("default")
    ns = ds.create_channel("nums", SharedNumberSequence.TYPE)
    ns.insert_range(0, list(range(20)))
    ns.remove_range(5, 10)
    ns.insert_range(3, [100, 200])
    return _commit_detached(c)


def build_trace_document(device=None) -> Container:
    """A realistic editing session (keystroke bursts, backspaces, word
    deletes, pastes, format sweeps — testing/traces.py) pinned end-state:
    the corpus analog of the reference's recorded-log replay
    (packages/test/snapshots/src/replayMultipleFiles.ts)."""
    from .traces import keystroke_trace

    c = _detached("pin-trace", device)
    ds = c.runtime.create_datastore("default")
    text = ds.create_channel("text", SharedString.TYPE)
    for op, *_ in keystroke_trace(1500, seed=77):
        if op["type"] == 0:
            text.insert_text(op["pos1"], op["seg"]["text"],
                             op["seg"].get("props"))
        elif op["type"] == 1:
            text.remove_text(op["pos1"], op["pos2"])
        else:
            text.annotate_range(op["pos1"], op["pos2"], op["props"])
    return _commit_detached(c)


BUILDERS: Dict[str, Callable[..., Container]] = {
    "text": build_text_document,
    "kv": build_kv_document,
    "matrix": build_matrix_document,
    "number-sequence": build_sequence_document,
    "keystroke-trace": build_trace_document,
}


def canonical(container: Container) -> str:
    return json.dumps(summary_tree_to_dict(container._assemble_summary()),
                      sort_keys=True)


def corpus_digests(device=None) -> Dict[str, str]:
    return {name: hashlib.sha256(
        canonical(build(device)).encode()).hexdigest()
        for name, build in BUILDERS.items()}


def write_pins(path: str, device=None) -> Dict[str, str]:
    """Write the digests to `path`, which must not be the JAX package's
    pin file."""
    if os.path.realpath(path) == os.path.realpath(PINS_PATH):
        raise ValueError(f"{path} holds the JAX package's pins, which the "
                         "port compares against and never writes")
    digests = corpus_digests(device)
    with open(path, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    return digests


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m fluidframework_tpu_torch.testing.snapshot_corpus",
        description="Print the snapshot corpus's digests, or write them to "
                    "OUT (never to the JAX package's pin file).")
    parser.add_argument("out", nargs="?")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    digests = (write_pins(args.out, args.device) if args.out
               else corpus_digests(args.device))
    for name, digest in digests.items():
        print(f"{name}: {digest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
