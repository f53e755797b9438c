"""The sequencer lambda's scenarios, run the same way on either package.

Each scenario takes a `Package`: the lambda class, QueuedMessage, the
wire decoder, the collection type and the delta store's key of one
package, plus keyword arguments for the lambda (device="cuda" or "cpu"
for the port). chip_smoke.py phase 16 runs them on the card and, in a
child process, on the CPU; tests/test_torch_lambda_golden.py runs them
through the JAX package to build and check
testing/golden/lambda_golden.json. A scenario returns digests (sha256 of
a canonical JSON) of what the lambda emitted and materialized, so two
runs compare by equality. Apart from `port_package`, which loads the
port's modules, this module needs neither torch nor JAX.

- `serving_run`: the serving-ingest fleet (ingest.serving_waves) through
  `handler_raw` with `emit_window` and the pipelined ring: warm waves
  (cold growth, promotions, the first fold), `measured` waves, then
  `extra` waves; hooks let the card time and count each part.
- `storm_run`: the ragged storm fleet (ingest.storm_waves) on paged
  lanes, "sync" (each window dispatched and read back alone) or "mega"
  (pipelined: each flush's windows leave as megakernel rings).
- `mixed_run`: the mixed-family stream (ingest.mixed_waves) with a share
  of heavy typists: the first half through `handler` (decoded boxcars),
  a checkpoint and a restart from the checkpoint and the delta store,
  the second half through `handler_raw`; then summarize_documents and
  catchup_snapshot.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from . import ingest

# Columns of the pump's staging (server/pump.py), read from the windows.
_KIND, _CLIENT, _CSEQ, _REFSEQ = 1, 2, 3, 4


class Package(NamedTuple):
    Lambda: Any            # TpuSequencerLambda
    QueuedMessage: Any
    from_wire: Callable    # wire.boxcar_from_wire
    Collection: Any        # database.Collection
    delta_key: Callable    # lambdas.scriptorium.delta_key
    counters: Any          # telemetry.counters
    kwargs: dict           # extra lambda arguments (device=...)


def port_package(device) -> Package:
    """The port's Package on `device` (its modules import torch, so they
    load here, on the first call)."""
    from ..server import tpu_sequencer, wire
    from ..server.database import Collection
    from ..server.lambdas.scriptorium import delta_key
    from ..server.log import QueuedMessage
    from ..telemetry import counters
    return Package(tpu_sequencer.TpuSequencerLambda, QueuedMessage,
                   wire.boxcar_from_wire, Collection, delta_key, counters,
                   {"device": device})


class _Ctx:
    def checkpoint(self, *_):
        pass

    def error(self, err, restart=False):
        raise err


def emit_key(doc_id: str, m) -> list:
    return [doc_id, m.sequence_number, m.minimum_sequence_number, m.type,
            m.client_id, m.client_sequence_number,
            m.reference_sequence_number,
            json.dumps(m.contents, sort_keys=True), m.data]


def nack_key(doc_id: str, client_id: str, n) -> list:
    return [doc_id, client_id, n.sequence_number, n.content.code,
            n.content.message, n.operation.client_sequence_number]


def plain(x):
    """A comparable form of summaries, snapshots and views: Run and Items
    payloads by content, numpy arrays and bytes as lists, tuple keys as
    strings."""
    if isinstance(x, dict):
        return {(repr(k) if isinstance(k, tuple) else k): plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ["ndarray", str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (bytes, bytearray)):
        return ["bytes", bytes(x).hex()]
    if hasattr(x, "base") and hasattr(x, "encode"):       # Run
        return ["run", list(x.encode())]
    if type(x).__name__ == "Items":
        return ["items", plain(list(x.values))]
    return x


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(plain(obj), sort_keys=True,
                                     default=str).encode()).hexdigest()


def windows_digest(windows) -> dict:
    """The emitted stream of SequencedWindows without building message
    objects: per window, the admitted rows' documents, seqs, msns, kinds,
    client ordinals, clientSeqs and refSeqs, in emit order."""
    h = hashlib.sha256()
    admitted = 0
    for w in windows:
        keep = np.asarray(w.seqs) > 0
        rows = np.asarray(w.rows)[keep]
        admitted += int(keep.sum())
        docs = [d for d, k in zip(w.doc_ids, keep.tolist()) if k]
        h.update("\n".join(docs).encode())
        for arr in (np.asarray(w.seqs)[keep], np.asarray(w.msns)[keep],
                    w.cols[_KIND, rows], w.cols[_CLIENT, rows],
                    w.cols[_CSEQ, rows], w.cols[_REFSEQ, rows]):
            h.update(np.ascontiguousarray(arr, dtype=np.int64).tobytes())
    return {"admitted": admitted, "sha256": h.hexdigest()}


def texts_digest(lam, docs: List[str], channel: str = "t") -> dict:
    texts = [lam.channel_text(d, "s", channel) or "" for d in docs]
    return {"chars": sum(len(t) for t in texts),
            "sha256": digest(list(zip(docs, texts)))}


def _feed_raw(pkg: Package, lam, frames) -> None:
    for off, doc, data in frames:
        lam.handler_raw(pkg.QueuedMessage(topic="rawdeltas", partition=0,
                                          offset=off, key=doc, value=data))


def _feed_object(pkg: Package, lam, frames) -> None:
    for off, doc, data in frames:
        try:
            value = pkg.from_wire(data)
        except ValueError:
            value = data        # undecodable: handler routes bytes raw
        lam.handler(pkg.QueuedMessage(topic="rawdeltas", partition=0,
                                      offset=off, key=doc, value=value))


def _nothing(_lam, fn):
    fn()


def serving_run(pkg: Package, docs: int, ops: int, measured: int = 3,
                extra: int = 1, paged: bool = False,
                hooks: Optional[Dict[str, Callable]] = None) -> dict:
    """The serving-ingest fleet. hooks: "measure" and "extra", each
    called as hook(lam, run) around its waves (run() feeds them and
    flushes after each; the default just calls run); run(flush_ms) also
    appends each flush's host milliseconds to the list it is given."""
    hooks = hooks or {}
    nacks: List[tuple] = []
    windows: list = []
    lam = pkg.Lambda(_Ctx(), emit=lambda *_a: None,
                     nack=lambda *a: nacks.append(a), client_timeout_s=0.0,
                     paged_lanes=paged, **pkg.kwargs)
    lam.emit_window = windows.append
    lam.pipelined = True
    warm = ingest.warm_waves(ops)
    waves = ingest.serving_waves(docs, ops, warm + measured + extra)

    def runner(part):
        def run(flush_ms: Optional[list] = None):
            for frames in part:
                _feed_raw(pkg, lam, frames)
                t0 = time.perf_counter()
                lam.flush()
                if flush_ms is not None:
                    flush_ms.append((time.perf_counter() - t0) * 1e3)
        return run

    runner(waves[:warm])()
    lam.drain()
    hooks.get("measure", _nothing)(lam, runner(waves[warm:warm + measured]))
    lam.drain()
    hooks.get("extra", _nothing)(lam, runner(waves[warm + measured:]))
    lam.drain()
    names = [f"d{d}" for d in range(docs)]
    return {"docs": docs, "ops": ops, "waves": len(waves), "paged": paged,
            "nacks": len(nacks), "stream": windows_digest(windows),
            "texts": texts_digest(lam, names)}


def storm_run(pkg: Package, mode: str, waves: int = 15, docs: int = 64,
              storm_ops: int = 128) -> dict:
    """The ragged storm fleet on paged lanes, "sync" or "mega"."""
    keys: List[list] = []

    def on_window(window):
        for doc_id, msg in window.messages():
            keys.append(emit_key(doc_id, msg)[:7])

    c = pkg.counters
    names = ("serving.burst_dispatch_total", "serving.burst_windows",
             "serving.megakernel_rings", "serving.recovery_dispatches")
    before = {n: c.get(n) for n in names}
    lam = pkg.Lambda(_Ctx(), emit=lambda *_a: None, nack=lambda *_a: None,
                     client_timeout_s=0.0, paged_lanes=True, **pkg.kwargs)
    lam.emit_window = on_window
    lam.pipelined = mode != "sync"
    for frames in ingest.storm_waves(waves, docs=docs,
                                     storm_ops=storm_ops):
        _feed_raw(pkg, lam, frames)
        lam.flush()
    lam.drain()
    delta = {n: c.get(n) - before[n] for n in names}
    served = delta["serving.burst_windows"]
    return {"mode": mode, "messages": len(keys), "stream": digest(keys),
            "texts": texts_digest(lam, [f"m{d}" for d in range(docs)]),
            "rings": int(delta["serving.megakernel_rings"]),
            "served_windows": int(served),
            "dispatches_per_window":
                delta["serving.burst_dispatch_total"] / served
                if served else None}


def mixed_run(pkg: Package, docs: int, waves: int, seed: int = 16,
              heavy: tuple = (8, 24), view_docs: int = 32) -> dict:
    """The mixed-family stream: the first half on the object path, a
    checkpoint, a restart from it and the delta store, the second half on
    the raw path; then summaries and catch-up artifacts."""
    stream = ingest.mixed_waves(docs, waves, seed=seed, poison=True,
                                heavy=heavy)
    half = waves // 2
    checkpoints = pkg.Collection()
    deltas = pkg.Collection(unique_key=pkg.delta_key)
    emits: List[list] = []
    nacks: List[list] = []

    def emit(doc_id, msg):
        emits.append(emit_key(doc_id, msg))
        record = asdict(msg)
        record["traces"] = []
        record["documentId"] = doc_id
        deltas.insert_one(record)

    def make():
        return pkg.Lambda(_Ctx(), emit=emit,
                          nack=lambda d, c, n: nacks.append(
                              nack_key(d, c, n)),
                          client_timeout_s=0.0, checkpoints=checkpoints,
                          deltas=deltas, **pkg.kwargs)

    first = make()
    for frames in stream[:half]:
        _feed_object(pkg, first, frames)
        first.flush()
    first.close()
    promoted_before = sum(1 for b, _l in first.merge.where.values()
                          if b > 0)
    lam = make()
    restored_docs = len(lam.docs)
    for frames in stream[half:]:
        _feed_raw(pkg, lam, frames)
        lam.flush()
    lam.drain()
    names = sorted({d for frames in stream for _o, d, _b in frames})
    views = {}
    for d in names[:view_docs]:
        for ch in ("t", "m", "c", "n", "x", "dir"):
            views[f"{d}/{ch}"] = [
                lam.channel_text(d, "s", ch), lam.channel_snapshot(d, "s", ch),
                lam.channel_matrix(d, "s", ch),
                lam.channel_directory(d, "s", ch)]
    catchup = {doc: {k: v for k, v in art.items() if k != "gen"}
               for doc, art in lam.catchup_snapshot().items()}
    return {"docs": docs, "waves": waves, "messages": len(emits),
            "nacks": len(nacks), "restored_docs": restored_docs,
            "promoted": sum(1 for b, _l in lam.merge.where.values()
                            if b > 0),
            "promoted_before_restart": promoted_before,
            "opaque": len(lam.merge.opaque) + len(lam.lww.opaque),
            "poison": lam.poison_frames,
            "stream": digest(emits), "nacks_digest": digest(sorted(nacks)),
            "views": digest(views),
            "summary": digest(lam.summarize_documents()),
            "catchup_docs": len(catchup), "catchup": digest(catchup),
            "seqs": digest(lam.doc_sequence_numbers())}
