"""On-card kernel conformance: the fused apply against the scan apply,
bit for bit, on the real GPU (the twin of fluidframework_tpu's
tools/tpu_conformance.py).

The test suite holds both kernels' plain versions against the JAX package
on the CPU, and chip_smoke.py holds each kernel against its plain
version; this tool holds the two hand-written kernels against each other
(kernels/csrc/fused_apply.cu against kernels/csrc/scan_apply.cu) at the
JAX tool's shapes. Run it before trusting a new card, toolchain or torch:

    python -m fluidframework_tpu_torch.tools.gpu_conformance          # quick
    python -m fluidframework_tpu_torch.tools.gpu_conformance --heavy  # +cap-1024

Exits 2 without a card, 1 on any mismatch. Times are CUDA events around
three chained applies (mean per apply).

The JAX tool's check_fused_sp (the fused apply with the capacity axis
sharded over a mesh) is multi-device and waits with the port's mesh
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Optional

import torch

SHAPES = ((512, 64, 256, 0), (2048, 100, 256, 1), (128, 48, 512, 2))
HEAVY_SHAPE = (512, 128, 1024, 3)   # the capacity-1,024 tables
RUNS_SHAPE = (256, 64, 256, 7)
HEAVY_RUNS_SHAPE = (512, 96, 512, 8)


def _traces(b: int, t: int, seed: int, removes: bool = True):
    from ..mergetree.oppack import HostOp, OpKind

    rng = random.Random(seed)
    out = []
    for d in range(b):
        ops, length, seq = [], 0, 0
        for i in range(t):
            seq += 1
            if removes and length > 4 and rng.random() < 0.25:
                a = rng.randrange(length - 2)
                width = rng.randrange(1, 3)
                ops.append(HostOp(kind=OpKind.REMOVE, seq=seq,
                                  ref_seq=seq - 1, client=d % 3,
                                  pos1=a, pos2=a + width, op_id=i))
                length -= width
                continue
            n = rng.randrange(1, 4)
            ops.append(HostOp(kind=OpKind.INSERT, seq=seq, ref_seq=seq - 1,
                              client=d % 3, pos1=rng.randrange(length + 1),
                              op_id=i, new_len=n))
            length += n
        out.append(ops)
    return out


def _chained_ms(fn, state, ops, first, dev) -> Optional[float]:
    """Mean CUDA-event milliseconds of three chained applies (None off
    the card: a host clock is not a device time)."""
    if dev.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    chained = fn(state, ops)
    for _ in range(2):
        chained = fn(chained._replace(overflow=first.overflow), ops)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 3


def _fmt(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.3f}ms"


def _mismatches(ref, got) -> list:
    return [f for f in ref._fields
            if not torch.equal(getattr(ref, f), getattr(got, f))]


def check(b: int, t: int, cap: int, seed: int, device=None) -> bool:
    from .. import interop
    from ..core.device import resolve_device
    from ..mergetree import kernel
    from ..mergetree.oppack import pack_ops
    from ..mergetree.pallas_apply import apply_ops_fused, launch_geometry
    from ..mergetree.state import make_state

    dev = resolve_device(device)
    packed = interop.packed_ops_from_numpy(pack_ops(_traces(b, t, seed)),
                                           device=dev)
    results = {}
    for name, fn in (("scan", kernel.apply_ops_batched_keep),
                     ("fused", apply_ops_fused)):
        out = fn(make_state(cap, 2, batch=b, device=dev), packed)
        ms = _chained_ms(fn, make_state(cap, 2, batch=b, device=dev),
                         packed, out, dev)
        results[name] = (out, ms)
    ref, scan_ms = results["scan"]
    got, fused_ms = results["fused"]
    bad = _mismatches(ref, got)
    for f in bad:
        print(f"  MISMATCH in {f} (b={b} t={t} cap={cap} seed={seed})")
    geo = launch_geometry(b, cap, ref.overlap_slots, ref.anno_slots)
    print(f"  b={b} t={t} cap={cap} path={geo.path}: "
          f"{'FAIL' if bad else 'OK'}  scan {_fmt(scan_ms)} "
          f"fused {_fmt(fused_ms)}", flush=True)
    return not bad


def check_runs(b: int, t_ops: int, cap: int, seed: int,
               device=None) -> bool:
    """INSERT_RUN conformance: pack typing-burst streams and compare the
    fused runs variant against the scan kernel WITH the same RunCols."""
    import numpy as np

    from .. import interop
    from ..core.device import resolve_device
    from ..mergetree import kernel
    from ..mergetree.oppack import (HostOp, OpKind, pack_run_slots,
                                    pack_slots)
    from ..mergetree.pallas_apply import apply_ops_fused
    from ..mergetree.state import make_state

    dev = resolve_device(device)
    rng = random.Random(seed)
    docs = []
    for _ in range(b):
        ops, length, seq = [], 0, 0
        while len(ops) < t_ops:
            if rng.random() < 0.7:  # typing burst, frozen ref
                ref = seq
                pos = rng.randrange(length + 1) if length else 0
                for _ in range(rng.randrange(3, 12)):
                    seq += 1
                    ops.append(HostOp(kind=OpKind.INSERT, seq=seq,
                                      ref_seq=ref, client=1, pos1=pos,
                                      op_id=len(ops), new_len=1))
                    pos += 1
                    length += 1
            elif length > 4:
                seq += 1
                a = rng.randrange(length - 2)
                ops.append(HostOp(kind=OpKind.REMOVE, seq=seq,
                                  ref_seq=seq - 1, client=1, pos1=a,
                                  pos2=a + 1, op_id=len(ops)))
                length -= 1
            else:
                seq += 1
                ops.append(HostOp(kind=OpKind.INSERT, seq=seq,
                                  ref_seq=seq - 1, client=1, pos1=0,
                                  op_id=len(ops), new_len=2))
                length += 2
        docs.append(pack_run_slots(ops[:t_ops], base_seq=0))
    t_slots = max(len(s) for s in docs)
    packed_l, runs_l = zip(*(pack_slots(s, steps=t_slots) for s in docs))
    packed = interop.packed_ops_from_numpy(
        {f: np.stack([p[f] for p in packed_l]) for f in packed_l[0]},
        device=dev)
    runs = interop.run_cols_from_numpy(
        {f: np.stack([r[f] for r in runs_l]) for f in runs_l[0]},
        device=dev)
    out_scan = kernel.apply_ops_batched_keep(
        make_state(cap, 2, batch=b, device=dev), packed, runs)
    out_fused = apply_ops_fused(make_state(cap, 2, batch=b, device=dev),
                                packed, runs=runs)
    bad = _mismatches(out_scan, out_fused)
    for f in bad:
        print(f"  RUNS MISMATCH in {f} (b={b} t={t_ops} cap={cap} "
              f"seed={seed})")
    print(f"  runs b={b} t={t_ops} cap={cap}: {'FAIL' if bad else 'OK'}",
          flush=True)
    return not bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--heavy", action="store_true")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("no CUDA device reachable — run tests/test_torch_*.py for the "
              "plain versions' conformance instead")
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    shapes = list(SHAPES) + ([HEAVY_SHAPE] if args.heavy else [])
    results = [check(*s) for s in shapes]  # run EVERY shape
    results.append(check_runs(*RUNS_SHAPE))
    if args.heavy:
        results.append(check_runs(*HEAVY_RUNS_SHAPE))
    ok = all(results)
    print("CONFORMANCE", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
