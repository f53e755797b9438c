"""Micro-perf harness: µs/op timings for the core engines (a port of
fluidframework_tpu's tools/microbench.py).

Capability parity with reference merge-tree `wordUnitTests.ts:18-60` and
`beastTest.ts` (timed micro-loops over insert/remove/annotate/snapshot,
reported in µs/op) plus the internal perf counters surfaced by
`MergeTreeStats` (mergeTree.ts:185). Run:

    python -m fluidframework_tpu_torch.tools.microbench [n_ops]

Prints one row per probe: name, ops, total ms, µs/op. The device-kernel
probe runs the scan apply (mergetree/kernel.apply_ops_batched, the
hand-written kernels/csrc/scan_apply.cu) on the card, or its plain
version where the caller passes device="cpu"; the card is synchronized
inside the timed region."""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Tuple

import torch

from ..mergetree.client import MergeTreeClient
from ..mergetree.oracle import MergeTreeOracle


def _timed(fn: Callable[[], int]) -> Tuple[int, float]:
    start = time.perf_counter()
    n = fn()
    return n, time.perf_counter() - start


def probe_oracle_insert(n_ops: int) -> Tuple[int, float]:
    tree = MergeTreeOracle(local_client=0)
    rng = random.Random(0)

    def run():
        seq = 0
        for i in range(n_ops):
            seq += 1
            tree.insert_text(rng.randint(0, tree.get_length()), "word ",
                             seq - 1, 0, seq)
            tree.update_seq(seq)
        return n_ops

    return _timed(run)


def probe_oracle_remove(n_ops: int) -> Tuple[int, float]:
    tree = MergeTreeOracle(local_client=0)
    seq = 0
    for _ in range(n_ops):
        seq += 1
        tree.insert_text(0, "xxxx", seq - 1, 0, seq)
        tree.update_seq(seq)
    rng = random.Random(1)

    def run():
        nonlocal seq
        for _ in range(n_ops // 2):
            seq += 1
            length = tree.get_length()
            if length < 4:
                break
            start = rng.randint(0, length - 2)
            tree.remove_range(start, min(length, start + 2), seq - 1, 0, seq)
            tree.update_seq(seq)
        return n_ops // 2

    return _timed(run)


def probe_client_roundtrip(n_ops: int) -> Tuple[int, float]:
    """Local submit + ack (the interactive latency path)."""
    client = MergeTreeClient(client_id=0)
    rng = random.Random(2)

    def run():
        seq = 0
        for _ in range(n_ops):
            seq += 1
            client.insert_text_local(
                rng.randint(0, client.get_length()), "w")
            client.apply_msg({"type": 0, "pos1": 0,
                              "seg": {"text": "w"}}, seq, seq - 1, 0)
        return n_ops

    return _timed(run)


def probe_snapshot(n_segments: int) -> Tuple[int, float]:
    tree = MergeTreeOracle(local_client=0)
    seq = 0
    for _ in range(n_segments):
        seq += 1
        tree.insert_text(0, "seg", seq - 1, 1, seq)  # distinct clients block
        tree.update_seq(seq)

    def run():
        for _ in range(10):
            tree.snapshot_segments()
        return 10

    return _timed(run)


def probe_kernel_throughput(n_docs: int = 512, n_ops: int = 64,
                            device: str | torch.device | None = None
                            ) -> Tuple[int, float]:
    from .. import interop
    from ..core.device import resolve_device
    from ..mergetree import kernel
    from ..mergetree.state import make_state
    from ..testing.traces import gen_traces

    dev = resolve_device(device)
    cols = gen_traces(n_docs, n_ops, seed=0)
    ops = interop.packed_ops_from_numpy(cols, device=dev)
    state = make_state(128, 1, batch=n_docs, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kernel.apply_ops_batched(state, ops)  # build + warm
    sync()

    def run():
        kernel.apply_ops_batched(state, ops)
        sync()
        return n_docs * n_ops

    return _timed(run)


PROBES: Dict[str, Callable[[int], Tuple[int, float]]] = {
    "oracle.insert": probe_oracle_insert,
    "oracle.remove": probe_oracle_remove,
    "client.roundtrip": probe_client_roundtrip,
    "oracle.snapshot(10x)": probe_snapshot,
}


def run_all(n_ops: int = 2000, with_kernel: bool = True,
            device: str | torch.device | None = None) -> List[dict]:
    """Every probe's row; the kernel row runs on `device` (None: the
    card, raising without CUDA)."""
    rows = []
    for name, probe in PROBES.items():
        n, elapsed = probe(n_ops)
        rows.append({"probe": name, "ops": n,
                     "total_ms": round(elapsed * 1000, 2),
                     "us_per_op": round(elapsed / max(1, n) * 1e6, 2)})
    if with_kernel:
        n, elapsed = probe_kernel_throughput(device=device)
        rows.append({"probe": "kernel.apply_batched", "ops": n,
                     "total_ms": round(elapsed * 1000, 2),
                     "us_per_op": round(elapsed / max(1, n) * 1e6, 3)})
    return rows


def main() -> None:
    import sys
    n_ops = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    for row in run_all(n_ops):
        print(f"{row['probe']:24} {row['ops']:>8} ops  "
              f"{row['total_ms']:>9.2f} ms  {row['us_per_op']:>8.2f} µs/op")


if __name__ == "__main__":
    main()
