"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version (bit-exact: all state is int32/bool), holds the fused
apply and the pipeline step against the JAX outputs committed in
fluidframework_tpu_torch/testing/golden/, then drives the north-star step
(10,000 docs x 100 ops, capacity 256, ticket table K=8) through the
kernels, checks it against the plain composition, and times it with CUDA
events. Prints one {"kernels": [...]} line, and as its last line
{"ok": true, "device": {...}}. Any mismatch or exception exits nonzero
before that line. Exits nonzero when CUDA is not available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEVICE = "cuda"
DOCS, OPS, CAPACITY, ANNO, TICKET_K = 10_000, 100, 256, 1, 8
TRIALS = 5
# H100 SXM published peaks: HBM bytes/s, and the
# non-tensor 32-bit rate used for the integer lane operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi unavailable ({exc})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def ms_of(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two tuples of integer/bool tensors."""
    err = 0
    for x, y in zip(a, b):
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max().item()) if d.numel() else 0)
    return err


def assert_tuple_equal(got, want, what: str) -> None:
    for name, g, w in zip(got._fields, got, want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}: {name} dtype/shape {g.dtype}{tuple(g.shape)} vs "
                f"{w.dtype}{tuple(w.shape)}")
        if not bool((g == w).all()):
            bad = int((g != w).sum())
            raise SmokeFailure(f"{what}: field {name} differs in {bad} "
                               "elements")


def assert_matches_numpy(got, want: dict, what: str) -> None:
    for name, g in zip(got._fields, got):
        if g is None:
            continue
        arr = g.cpu().numpy()
        require(arr.dtype == want[name].dtype,
                f"{what}: {name} dtype {arr.dtype} vs {want[name].dtype}")
        if not np.array_equal(arr, want[name]):
            raise SmokeFailure(f"{what}: field {name} differs from the JAX "
                               "golden output")


def random_tables(seed: int, batch: int, capacity: int, device):
    """Arbitrary segment tables for the summary-length comparisons."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree.constants import (
        DEV_NO_REMOVE, DEV_UNASSIGNED)
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 200, (batch, capacity)).astype(np.int32)
    pick = rng.integers(0, 4, (batch, capacity))
    st = {
        "length": rng.integers(0, 9, (batch, capacity)).astype(np.int32),
        "ins_seq": np.where(pick == 0, DEV_UNASSIGNED, seqs).astype(np.int32),
        "rem_seq": np.where(pick == 1, seqs + 5,
                            np.where(pick == 2, DEV_UNASSIGNED,
                                     DEV_NO_REMOVE)).astype(np.int32),
        "count": rng.integers(0, capacity + 1, batch).astype(np.int32),
        "seq": rng.integers(0, 220, batch).astype(np.int32),
    }
    k, a = 3, 1
    st.update(
        ins_client=np.zeros((batch, capacity), np.int32),
        local_seq=np.zeros((batch, capacity), np.int32),
        rem_local_seq=np.zeros((batch, capacity), np.int32),
        rem_clients=np.full((batch, capacity, k), -1, np.int32),
        origin_op=np.zeros((batch, capacity), np.int32),
        origin_off=np.zeros((batch, capacity), np.int32),
        anno=np.full((batch, capacity, a), -1, np.int32),
        min_seq=np.zeros(batch, np.int32),
        overflow=np.zeros(batch, bool))
    return interop.doc_state_from_numpy(st, device)


def fused_apply_lane_ops(kinds: np.ndarray, capacity: int, k: int,
                         a: int) -> float:
    """Integer lane operations the fused apply's formulation needs for the
    [B, T] op kinds (every phase touches every slot of the document):
    visibility + scan (8 + K per slot), boundary test (4), shift of all planes (2 per plane),
    insert stop test (8) and fill (P), remove (10 + 3K), annotate (4 + A),
    ack (6). Counted from the kinds actually in the stream."""
    planes = 8 + k + a
    vis = 8 + k
    boundary = vis + 4 + 2 * planes
    n = {kind: int((kinds == kind).sum()) for kind in range(6)}
    per_slot = (
        n[1] * (boundary + vis + 8 + 2 * planes + planes)       # insert
        + n[2] * (2 * boundary + vis + 10 + 3 * k)              # remove
        + n[3] * (2 * boundary + vis + 4 + a)                   # annotate
        + (n[4] + n[5]) * 6)                                    # acks
    return float(per_slot) * capacity


def main() -> int:
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from fluidframework_tpu_torch import interop, kernels
    from fluidframework_tpu_torch.kernels import build
    from fluidframework_tpu_torch.mergetree import pallas_apply, pallas_ops
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import gen_traces

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}", flush=True)

    # -- phase 1: build + selftest ---------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"setup: kernel build {time.perf_counter() - t0:.2f} s "
          f"({build.source_hash()})", flush=True)
    ptxas = build.BUILD_ROOT / build.source_hash() / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or "rc=" in line:
                print(f"  ptxas: {line.strip()}")
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    st_out = kernels.selftest(x)
    torch.cuda.synchronize()
    require(bool((st_out == kernels.selftest_plain(x)).all()),
            "selftest differs from 2 * x")
    print("phase 1: selftest bit-exact", flush=True)

    # -- phase 2: summary length kernel vs plain -------------------------
    for seed, (b, c) in enumerate([(10_000, 256), (37, 64), (8, 1024)]):
        st = random_tables(seed, b, c, dev)
        got, want = pallas_ops.summary_lengths(st), \
            pallas_ops.summary_lengths_plain(st)
        torch.cuda.synchronize()
        require(bool((got == want).all()),
                f"summary_lengths differs at B={b} C={c}")
        print(f"phase 2: summary_lengths bit-exact at B={b} C={c}",
              flush=True)

    # -- phase 3: fused apply kernel vs plain vs JAX golden --------------
    def check_apply(state, ops, what):
        got = pallas_apply.apply_ops_fused(state, ops)
        want = pallas_apply.apply_ops_fused_plain(state, ops)
        torch.cuda.synchronize()
        assert_tuple_equal(got, want, what)
        return got

    cols = gen_traces(2048, 100, seed=1)
    check_apply(make_state(CAPACITY, ANNO, batch=2048, device=dev),
                interop.packed_ops_from_numpy(cols, dev),
                "apply gen_traces(2048, 100) C=256")
    print("phase 3: apply bit-exact on gen_traces(2048, 100) C=256",
          flush=True)
    cols = gen_traces(6, 120, seed=2)
    check_apply(make_state(1100, 2, batch=6, device=dev),
                interop.packed_ops_from_numpy(cols, dev),
                "apply gen_traces(6, 120) C=1100")
    print("phase 3: apply bit-exact at C=1100 (two thread chunks)",
          flush=True)
    g = golden.load()
    got = check_apply(interop.doc_state_from_numpy(g["apply_in"], dev),
                      interop.packed_ops_from_numpy(g["apply_op"], dev),
                      "apply golden")
    assert_matches_numpy(got, g["apply_out"], "apply golden vs JAX")
    tout, mout, ticketed, total = pipeline.full_step(
        interop.ticket_state_from_numpy(g["step_tin"], dev),
        interop.doc_state_from_numpy(g["step_min"], dev),
        interop.raw_ops_from_numpy(g["step_raw"], dev),
        interop.packed_ops_from_numpy(g["step_op"], dev))
    assert_matches_numpy(tout, g["step_tout"], "full_step golden tstate")
    assert_matches_numpy(mout, g["step_mout"], "full_step golden mstate")
    assert_matches_numpy(ticketed, g["step_ticketed"],
                         "full_step golden ticketed")
    require(np.array_equal(total.cpu().numpy(),
                           g["step_total"]["total_len"]),
            "full_step golden total_len")
    print("phase 3: apply and full_step equal the JAX golden outputs",
          flush=True)

    # -- phase 4: the north-star step through the kernels ----------------
    cols = gen_traces(DOCS, OPS, seed=0)
    ops = interop.packed_ops_from_numpy(cols, dev)
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)

    def fresh():
        return (tk.make_ticket_state(TICKET_K, DOCS, device=dev),
                make_state(CAPACITY, ANNO, batch=DOCS, device=dev))

    wrappers = {"selftest": kernels.selftest,
                "summary_len": pallas_ops.summary_lengths,
                "fused_apply": pallas_apply.apply_ops_fused}
    for fn in wrappers.values():
        fn.launches = 0
    tout, mout, ticketed, total = pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    require(launches["fused_apply"] > 0 and launches["summary_len"] > 0,
            f"main path did not launch every kernel: {launches}")
    require(not bool(mout.overflow.any()), "north-star step overflowed")
    require(total.shape == (DOCS,) and total.dtype == torch.int32
            and bool((total >= 0).all()), "total_len shape/dtype/range")
    p_tout, p_mout, p_ticketed, p_total = pipeline.make_full_step(
        plain=True)(*fresh(), raw, ops)
    torch.cuda.synchronize()
    assert_tuple_equal(mout, p_mout, "north-star mstate vs plain")
    assert_tuple_equal(tout, p_tout, "north-star tstate vs plain")
    assert_tuple_equal(ticketed, p_ticketed, "north-star ticketed vs plain")
    require(bool((total == p_total).all()), "north-star total_len vs plain")
    print(f"phase 4: full_step {DOCS}x{OPS} C={CAPACITY} through the "
          f"kernels, launches {launches}, equal to the plain composition",
          flush=True)

    # warm timing: one warm-up, then p50 of TRIALS from fresh state
    pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    step_ms, host_ms = [], []
    for _ in range(TRIALS):
        ts, ms = fresh()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        pipeline.full_step(ts, ms, raw, ops)
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(e0.elapsed_time(e1))
    stage = {"ticket": [], "apply": [], "summary": []}
    for _ in range(TRIALS):
        ts, ms = fresh()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        ts, tkd = tk.scan_tickets(ts, raw)
        ev[1].record()
        ms = pallas_apply.apply_ops_fused(ms, pipeline.admit_ops(ops, tkd))
        ev[2].record()
        pallas_ops.summary_lengths(ms)
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(stage):
            stage[key].append(ev[i].elapsed_time(ev[i + 1]))
    p50 = float(np.median(step_ms))
    split = {k: round(float(np.median(v)), 3) for k, v in stage.items()}
    print(f"full_step: {DOCS * OPS / (p50 / 1e3):.0f} ops/s, p50 {p50:.3f} "
          f"ms (host clock p50 {float(np.median(host_ms)):.3f} ms, trials "
          f"{[round(v, 3) for v in step_ms]}), stage p50 ms {split}; "
          f"card {card}", flush=True)

    # -- phase 5: per-kernel numbers at the main path's shapes -----------
    mstate0 = fresh()[1]
    admitted = pipeline.admit_ops(ops, ticketed)
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    state_bytes = (8 + 3 + ANNO) * CAPACITY * 4 + 13
    apply_bytes = DOCS * (2 * state_bytes + 10 * OPS * 4)
    apply_ops_n = fused_apply_lane_ops(admitted.kind.cpu().numpy(),
                                       CAPACITY, 3, ANNO)
    summary_bytes = DOCS * (3 * CAPACITY * 4 + 3 * 4)
    rows = [
        dict(name="selftest", source="fluidframework_tpu_torch/kernels/"
             "csrc/selftest.cu",
             replaces="fluidframework_tpu/mergetree/pallas_ops.py:42",
             on_main_path=False,
             err=max_abs_err([kernels.selftest(x)], [x * 2]),
             ms=ms_of(lambda: kernels.selftest(x), 200),
             plain_ms=ms_of(lambda: kernels.selftest_plain(x), 200),
             library_ms=ms_of(lambda: torch.mul(x, 2), 200),
             bytes=8 * 128 * 4 * 2, ops=8 * 128),
        dict(name="summary_len", source="fluidframework_tpu_torch/kernels/"
             "csrc/summary_len.cu",
             replaces="fluidframework_tpu/mergetree/pallas_ops.py:58",
             on_main_path=True,
             err=max_abs_err([pallas_ops.summary_lengths(mout)],
                             [pallas_ops.summary_lengths_plain(mout)]),
             ms=ms_of(lambda: pallas_ops.summary_lengths(mout), 50),
             plain_ms=ms_of(lambda: pallas_ops.summary_lengths_plain(mout),
                            10),
             library_ms=None, bytes=summary_bytes,
             ops=DOCS * CAPACITY * 6),
        dict(name="fused_apply", source="fluidframework_tpu_torch/kernels/"
             "csrc/fused_apply.cu",
             replaces="fluidframework_tpu/mergetree/pallas_apply.py:462",
             on_main_path=True,
             err=max_abs_err(pallas_apply.apply_ops_fused(mstate0, admitted),
                             p_mout),
             ms=ms_of(lambda: pallas_apply.apply_ops_fused(mstate0,
                                                           admitted), 5),
             plain_ms=ms_of(lambda: pallas_apply.apply_ops_fused_plain(
                 mstate0, admitted), 1),
             library_ms=None, bytes=apply_bytes, ops=apply_ops_n),
    ]
    out = []
    for r in rows:
        b_ms = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        o_ms = r["ops"] / PEAK_OPS_PER_S * 1e3
        require(r["err"] == 0, f"{r['name']}: max_abs_err {r['err']}")
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "on_main_path": r["on_main_path"], "max_abs_err": r["err"],
            "bit_exact": True, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
