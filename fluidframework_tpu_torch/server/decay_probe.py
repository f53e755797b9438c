"""Sustained-typing serving decay probe: does ingest throughput stay
flat as documents age? (A port of fluidframework_tpu's
server/decay_probe.py.)

Drives waves of same-document typing boxcars through the REAL
TpuSequencerLambda raw fast path (handler_raw, the pipelined ring) and
reports per-wave rates. Before the host zamboni pack, steady-state
throughput decayed as lanes climbed capacity buckets (apply cost scales
with C); with the overflow-time fold it stays flat, with a bounded fold
wave every ~capacity/window waves.

    python -m fluidframework_tpu_torch.server.decay_probe          # quick
    python -m fluidframework_tpu_torch.server.decay_probe --docs 256 \\
        --ops 16 --waves 40

Prints one JSON line: fast-wave median rate, fold-wave stats, sustained
rate, and lane-health counters. Exit nonzero if the LAST quartile of
fast waves is >2x slower than the first (decay = the regression this
tool exists to catch). Runs on the card.

The verdict is timing; what the waves do to the lanes is not:
`lane_digest` reads the lane-health counters and every lane's text, the
part of a run that two runs (or two packages) can be held equal on.

Reference analog: the deli lambda's steady-state throughput under
sustained per-document traffic (deli/lambda.ts:142 ticket loop, whose
cost does not grow with document age because the TS merge-tree zamboni
packs acked segments, mergeTree.ts:1289)."""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time
from typing import List, Optional, Tuple

import torch

from ..core.device import resolve_device

LANE_HEALTH = ("folds", "payload_compactions", "blocks_aged",
               "overflow_drops")


class _Ctx:
    def checkpoint(self, *_):
        pass

    def error(self, err, restart=False):
        raise err


def _message(csn: int, ref: int, kind: str, contents=None,
             data=None) -> dict:
    """A DocumentMessage as server/wire.py encodes it (its dataclass
    fields, in order, as dataclasses.asdict gives them)."""
    return {"client_sequence_number": csn, "reference_sequence_number": ref,
            "type": kind, "contents": contents, "metadata": None,
            "server_metadata": None, "traces": [], "data": data}


def build_wave(docs: int, ops: int, wave: int) -> list:
    """One wave: a boxcar of `ops` typing inserts per document (a join
    first in wave 0), as raw wire frames in QueuedMessages. The frames
    are server/wire.py's boxcar_to_wire bytes, written from plain dicts:
    its dataclasses.asdict pass took ~80% of the build."""
    from ..mergetree.client import OP_INSERT
    from ..protocol.messages import MessageType
    from .log import QueuedMessage

    rng = random.Random(17 + wave)
    out = []
    base_csn = wave * ops
    typed = {n: {"address": "s", "contents": {"address": "t", "contents": {
        "type": OP_INSERT, "pos1": 0, "seg": {"text": "x" * n}}}}
        for n in (1, 2, 3)}
    for d in range(docs):
        contents = []
        if wave == 0:
            contents.append(_message(
                0, -1, MessageType.CLIENT_JOIN,
                data=json.dumps({"clientId": f"c{d}", "detail": {}})))
        for i in range(ops):
            contents.append(_message(
                base_csn + i + 1, base_csn, MessageType.OPERATION,
                typed[rng.randrange(1, 4)]))
        out.append(QueuedMessage(
            topic="rawdeltas", partition=0, offset=wave * docs + d,
            key=f"d{d}",
            value=json.dumps({"tenantId": "b", "documentId": f"d{d}",
                              "clientId": f"c{d}",
                              "contents": contents}).encode("utf-8")))
    return out


def lane_digest(lam, docs: int) -> dict:
    """The deterministic part of a run: the merge store's lane-health
    counters and every lane's text (sha256 of canonical JSON), for a
    lambda of either package."""
    out = {name: int(getattr(lam.merge, name)) for name in LANE_HEALTH}
    texts = [[f"d{d}", lam.channel_text(f"d{d}", "s", "t") or ""]
             for d in range(docs)]
    out["chars"] = sum(len(t) for _, t in texts)
    out["texts_sha256"] = hashlib.sha256(json.dumps(
        texts, separators=(",", ":")).encode()).hexdigest()
    out["sha256"] = hashlib.sha256(json.dumps(
        out, sort_keys=True, separators=(",", ":")).encode()).hexdigest()
    return out


def probe(docs: int, ops: int, waves: int,
          device: str | torch.device | None = None,
          prebuilt: Optional[List[list]] = None
          ) -> Tuple[dict, object, List[float]]:
    """run()'s result, the lambda it drove (for lane_digest) and each
    wave's ops/s. `prebuilt` holds the waves' messages
    (build_wave(docs, ops, w) for w in range(waves)) when the caller
    built them before; they are built here otherwise."""
    from ..telemetry import counters
    from .tpu_sequencer import TpuSequencerLambda

    dev = resolve_device(device)
    # The lambda builds the native wire pump and raises where it cannot.
    lam = TpuSequencerLambda(_Ctx(), emit=lambda *a: None,
                             nack=lambda *a: None, client_timeout_s=0.0,
                             device=dev)
    lam.emit_window = lambda w: None
    lam.pipelined = True

    rates: List[float] = []
    if prebuilt is None:
        prebuilt = [build_wave(docs, ops, w) for w in range(waves)]
    elif len(prebuilt) != waves:
        raise ValueError(f"{len(prebuilt)} prebuilt waves, not {waves}")
    for msgs in prebuilt:
        t0 = time.perf_counter()
        for qm in msgs:
            lam.handler_raw(qm)
        lam.flush()
        lam.drain()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rates.append(docs * ops / (time.perf_counter() - t0))
        # Live gauge per wave: the monitor/health surface sees sustained-
        # typing throughput (and its decay) while the probe runs.
        counters.gauge("decay_probe.wave_ops_s", rates[-1])
        counters.increment("decay_probe.waves")
    # Warmup (builds, first promotions) = first quarter; classify the
    # rest into fast waves vs maintenance (fold) waves by median gap.
    tail = rates[waves // 4:]
    med = sorted(tail)[len(tail) // 2]
    fast = [r for r in tail if r >= med / 3]
    folds = [r for r in tail if r < med / 3]
    total_ops = docs * ops * len(tail)
    sustained = total_ops / sum(docs * ops / r for r in tail)
    q = max(1, len(fast) // 4)
    first_q = sorted(fast[:q])[q // 2]
    last_q = sorted(fast[-q:])[q // 2]
    decayed = bool(last_q * 2 < first_q)
    # Final verdict + sustained rate into the process counters: a monitor
    # watching this process exports them via /health and /metrics.prom.
    counters.gauge("decay_probe.sustained_ops_s", sustained)
    counters.gauge("decay_probe.decayed", 1.0 if decayed else 0.0)
    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else dev.type)
    return {
        "backend": backend,
        "docs": docs, "ops_per_wave": ops, "waves": waves,
        "fast_wave_median_ops_per_sec": round(med, 1),
        "fast_wave_first_quartile_median": round(first_q, 1),
        "fast_wave_last_quartile_median": round(last_q, 1),
        "maintenance_waves": len(folds),
        "sustained_ops_per_sec": round(sustained, 1),
        "folds": lam.merge.folds,
        "payload_compactions": lam.merge.payload_compactions,
        "blocks_aged": lam.merge.blocks_aged,
        "overflow_drops": lam.merge.overflow_drops,
        "decayed": decayed,
    }, lam, rates


def run(docs: int, ops: int, waves: int,
        device: str | torch.device | None = None) -> dict:
    """The probe's verdict; device None is the card (raises without
    CUDA)."""
    return probe(docs, ops, waves, device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--ops", type=int, default=16)
    ap.add_argument("--waves", type=int, default=40)
    args = ap.parse_args(argv)
    out = run(args.docs, args.ops, args.waves)
    print(json.dumps(out))
    return 1 if out["decayed"] else 0


if __name__ == "__main__":
    sys.exit(main())
