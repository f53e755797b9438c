"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version (bit-exact: all state is int32/int16/bool), holds the
fused apply, the pipeline step and one serving ring against the JAX outputs
committed in fluidframework_tpu_torch/testing/golden/, then drives the two
main paths through the kernels, checks each against its plain composition
and times it with CUDA events:
  - the north-star step (10,000 docs x 100 ops, capacity 256, ticket table
    K=8): phases 1-5;
  - the paged serving megakernel: the fused apply's runs= and extract=True
    variants (phase 6), the golden ring (phase 7), and two rings back to
    back of a 10,000-document partition (testing/serving.py FULL_RING:
    8 windows x 16 ticket steps, ~214k merge ops per ring in three page
    groups, 1,000 LWW lanes), the second one timed (phase 8).
The fused apply has two paths (one warp or one block per document) that
mergetree/pallas_apply.launch_geometry chooses from the shape: the main
paths must take the path the rule names, both paths are timed at the main
paths' shapes (the rule's may be at most PATH_MARGIN slower), and phase 9
holds both paths in all four variants bit-exact against the plain version
on fuzzed tables and op streams. Each fused-apply row's bound counts the
work of this run's data (the rows in use, live_slots) and, beside it,
every slot of every table.
The scan apply (mergetree/kernel.py over kernels/csrc/scan_apply.cu, any
capacity) has four paths (the table in one block's shared memory, in a
thread-block cluster's, or in device memory, and the first design,
global_chunked) that mergetree/kernel.scan_geometry chooses from the
shape; phase 10 holds every path (each cluster size that holds the
table) bit-exact against the plain scan on a fuzz grid up to C = 65,536,
and against the fused kernel where that applies. Then one document's bulk
catch-up runs at full size (phase 11): the 100,000-op keystroke trace of
BASELINE.json config #2 through mergetree/catchup.device_apply_tail,
every chunk on the rule's path, held to the JAX golden digest, its first
10,000 ops to the plain composition entry by entry, timed with a
host/device split, and once more with every chunk forced onto
global_chunked; and full_step above the fused capacity (1,024 docs x 100
ops at C = 8,192) against its plain composition. At its three shapes
(the first catch-up chunk at C = 4,096 and at C = 16,384, and full_step)
every path is timed and the rule's may be at most PATH_MARGIN slower than
the fastest; every path is also timed, for the smem path's rows, on two
inputs whose tables fit one block (the C = 4,096 chunk with one annotate
slot, where it must also equal the fused apply, and full_step's ops on
C = 1,024 tables).
Phase 12 is a paged flush with hot documents (testing/serving.py
HOT_RING: FULL_RING's partition plus 64 documents pre-seeded to 3,500
live rows): one megakernel ring, whose hot page group (C = 4,096) lies
above the fused capacity and takes the scan apply beside the fused
apply's groups; then a backlog staged as the JAX sequencer's paged
applier stages it (apply_ops_paged per group, serve_paged_burst for the
hot documents' 700 ops each at C = 8,192), a rollback_pages round trip
and compact_pages; every output held to the plain composition, the scan
launches per kernel held to the rule, the ring and the burst timed.
Phase 13 replays the 100,000-op keystroke trace op by op through the
port's MergeTreeClient (a prefix, within SCALAR_BUDGET_S), holds its
text to the device catch-up's, and fits the cost model
(mergetree/costmodel.py): scalar cost per op against live segments,
device wall per chunk and per op, and the crossover.
Prints one {"kernels": [...]} line, and as its last line
{"ok": true, "device": {...}}. Any mismatch or exception exits nonzero
before that line. Exits nonzero when CUDA is not available.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEVICE = "cuda"
DOCS, OPS, CAPACITY, ANNO, TICKET_K = 10_000, 100, 256, 1, 8
TRIALS = 5
RUN_K = 8          # mergetree/oppack.RUN_K (checked in main)
K_SLOTS, A_SLOTS = 3, 4   # the serving defaults: MAX_OVERLAP_CLIENTS, anno
RING_STAGES = ("gather", "ticket", "admit", "apply_extract",
               "apply_runs_extract", "lww", "pack", "scatter")
RING_SPEC = "FULL_RING"   # testing/serving.py fleet of the timed rings
VARIANT_BATCH = 2048      # documents of phase 6's first variant batch
# H100 SXM peaks: HBM bytes/s (data sheet), and the integer rate for the
# lane operations: 64 INT32 lanes per SM per clock (NVIDIA Hopper
# architecture white paper, SM table), 132 SMs, 1.98 GHz boost clock.
# Each row also gives its bound at PEAK_FP32_OPS_PER_S, the data sheet's
# 67 TFLOP/s (an FMA counted as two), four times the integer rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_FP32_OPS_PER_S = 67e12
# Phase 9: capacities fuzzed on each path (the warp path takes C <= 512),
# (K, A) pairs, seeds and documents (a batch that leaves the last block of
# a multi-document warp launch partly empty).
FUZZ_CAPACITIES = (1, 31, 32, 33, 63, 64, 100, 255, 256, 257, 512, 1000,
                   1024, 1100)
FUZZ_SLOTS = ((3, 1), (3, 4))
FUZZ_SEEDS = (0, 1)
FUZZ_DOCS, FUZZ_OPS = 1059, 40
PATHS = ("warp", "block")
# At each main-path shape the rule's path may be at most this much slower
# on the device than the other path (timing noise; the rule's table is
# calibrate_fused_apply.py's).
PATH_MARGIN = 0.10
# Phase 10: the scan apply's fuzz grid (capacities x documents x annotate
# slots, both variants, K=3), ops per stream by capacity, and the largest
# state (int32 elements) a cell may hold: a larger cell is dropped and
# printed (the plain version's temporaries are several states).
SCAN_CAPACITIES = (1, 33, 256, 1100, 4096, 4141, 4200, 16384, 65536)
SCAN_BATCHES = (1, 8, 256)
SCAN_ANNO = (1, 4, 64)
SCAN_MAX_INTS = 2**31
# Cluster sizes forced in phases 10 and 11 where they hold the table.
SCAN_CLUSTER_SIZES = (2, 4, 8, 16)
SM_COUNT = 132
# Phase 11's second path: full_step above the fused capacity (documents,
# ops, capacity; K=3, A=1).
SCAN_STEP = (1024, 100, 8192)
# The plain composition of phase 11 replays this prefix of the trace.
PLAIN_PREFIX = 10_000
# Phase 12: the testing/serving.py fleet with hot documents, its pool in
# pages, and each hot document's backlog in ops (the other documents take
# one window's worth of their class's ops).
HOT_SPEC = "HOT_RING"
HOT_POOL_PAGES = 32_768
HOT_BACKLOG = 700
RING_SCAN_STAGES = RING_STAGES + ("apply_scan_plain", "apply_scan_runs")
# Phase 13: the scalar replay stops after the block that crosses this many
# seconds (a stated prefix of the trace); blocks of this many ops are the
# points of the scalar fit; the device catch-up is timed on these
# prefixes of the same trace (and on the whole trace) for the device fit.
SCALAR_BUDGET_S = 60.0
SCALAR_BLOCK = 2_500
DEVICE_PREFIXES = (64, 256, 512, 2_048, 8_192, 32_768)
CROSSOVER_SEGMENTS = (20, 100, 300, 1_000, 3_000)
# fused_apply.cu's ptxas registers as PERF.md §6 records them: the block
# path 64 in every variant; the warp path by (kR, runs).
FUSED_WARP_REGISTERS = {(1, 0): 73, (1, 1): 76, (2, 0): 71, (2, 1): 77,
                        (4, 0): 73, (4, 1): 79, (8, 0): 97, (8, 1): 110,
                        (16, 0): 126, (16, 1): 127}


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


def kernel_device_ms(fn, reps: int) -> dict:
    """Device milliseconds per call of each CUDA kernel fn launches, from
    torch.profiler's CUPTI trace over `reps` calls (after one warm-up):
    {kernel name: (ms per call, launches per call)}. Unlike ms_of, the
    host's pace between launches is not counted."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0:
            out[ev.key] = (us / 1e3 / reps, ev.count / reps)
    return out


def one_kernel_ms(fn, reps: int, kernel: str):
    """Device milliseconds per launch of the kernels whose name contains
    `kernel` (fn launches one), from kernel_device_ms; a trace that holds
    no such kernel is taken once more, then None (not measured)."""
    for _ in range(2):
        trace = kernel_device_ms(fn, reps)
        got = [(ms, n) for name, (ms, n) in trace.items() if kernel in name]
        if got:
            return sum(ms for ms, _n in got) / sum(n for _ms, n in got)
    print(f"  profiler: no {kernel} in the trace; it holds "
          f"{sorted(trace)[:6]}", flush=True)
    return None


def path_times(state, ops, runs, extract: bool, reps: int) -> dict:
    """{path: {"device_ms", "ms"}} of one fused-apply launch on each path,
    forced whatever the rule says: the path's kernel device time
    (torch.profiler) and the mean of back-to-back calls (CUDA events)."""
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    out = {}
    for p in PATHS:
        geo = pa._forced_geometry(p, state.capacity, state.overlap_slots,
                                  state.anno_slots)

        def run():
            return pa._launch(state, ops, runs, extract, geo)
        out[p] = {"device_ms": one_kernel_ms(run, reps,
                                             f"fused_apply_kernel_{p}"),
                  "ms": ms_of(run, reps)}
    return out


def check_paths(what: str, row: dict, card: str) -> None:
    """Print both paths' times at a main-path shape, and fail unless the
    rule's path is measured and at most PATH_MARGIN slower on the device
    than the other."""
    times = "; ".join(f"{p} {fmt_ms(t['device_ms'])} device, "
                      f"{t['ms']:.4f} ms back to back"
                      for p, t in row["paths"].items())
    print(f"  fused_apply paths at {what}: {times}; the rule takes "
          f"{row['path']}; card {card}", flush=True)
    dev_ms = {p: t["device_ms"] for p, t in row["paths"].items()}
    require(None not in dev_ms.values(),
            f"fused_apply paths at {what}: device time not measured")
    other = min(ms for p, ms in dev_ms.items() if p != row["path"])
    require(dev_ms[row["path"]] <= other * (1 + PATH_MARGIN),
            f"fused_apply at {what}: the rule's {row['path']} path "
            f"({dev_ms[row['path']]:.4f} ms) is more than {PATH_MARGIN:.0%} "
            f"slower than the other ({other:.4f} ms)")


def fused_registers_recorded(key: str):
    """The recorded register count of a fused-apply kernel named as
    ptxas_report names it."""
    args = [int(x) for x in re.findall(r"\d+", key.split("<", 1)[-1])]
    if key.startswith("fused_apply_kernel_block"):
        return 64
    return FUSED_WARP_REGISTERS.get((args[0], args[1])) if args else None


def once_ms(fn) -> float:
    """Device milliseconds of one call of fn (CUDA events, no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def long_kernel_ms(fn, reps: int):
    """(device ms per launch, how) of a function that launches one long
    kernel: the least of `reps` single launches between two CUDA events,
    after one warm-up (for a kernel of a tenth of a millisecond or more
    the events add a few microseconds). torch.profiler's traces of the
    scan kernel came back empty, or held part of its time (3.0963 ms for
    a 6.3 ms launch), on the H100, so every path is timed the same
    way."""
    fn()
    return min(once_ms(fn) for _ in range(reps)), "events"


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} from the
    nvcc -Xptxas -v log, kernels named readably (fused_apply_kernel_warp
    <kR,runs,extract>, fused_apply_kernel_block<runs,extract>)."""
    out, entry, cur = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m[1])
    pretty = {}
    for name, rep in out.items():
        if "registers" not in rep:  # a device function, not a kernel
            continue
        m = re.search(r"([a-z_]*kernel[a-z_]*)", name)
        args = re.findall(r"L[ib](\d+)E", name)
        key = (m.group(1) if m else name) + \
            (f"<{','.join(args)}>" if args else "")
        pretty[key] = rep
    return pretty


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


def fused_apply_lane_ops(kinds: np.ndarray, slots, k: int, a: int) -> float:
    """Integer lane operations the fused apply's formulation needs for the
    [B, T] op kinds when op (b, t) touches slots[b, t] slots of its
    document (a scalar: the same for every op): per slot, visibility +
    scan (8 + K), boundary test (4), shift of all planes (2 per plane),
    insert stop test (8) and fill (P), remove (10 + 3K), annotate (4 + A),
    ack (6), and for an INSERT_RUN a boundary test, a visibility pass, the
    stop test, a shift of every plane, the RUN_K-term member selects of
    length/seq/op_id (2 per term), the live/dead masks (4) and the fill
    (P). Counted from the kinds actually in the stream."""
    planes = 8 + k + a
    vis = 8 + k
    boundary = vis + 4 + 2 * planes
    per_slot = np.zeros(7, np.int64)
    per_slot[1] = boundary + vis + 8 + 2 * planes + planes      # insert
    per_slot[2] = 2 * boundary + vis + 10 + 3 * k               # remove
    per_slot[3] = 2 * boundary + vis + 4 + a                    # annotate
    per_slot[4] = per_slot[5] = 6                               # acks
    per_slot[6] = boundary + vis + 8 + 2 * planes + 3 * 2 * RUN_K + 4 \
        + planes                                                # runs
    return float((per_slot[kinds] * np.broadcast_to(
        np.asarray(slots, np.int64), kinds.shape)).sum())


def live_slots(state, ops, runs=None) -> np.ndarray:
    """[B, T]: the slots op t of document b has to touch, from the plain
    version's count before it: the rows in use and those the op may add
    (count + 2, count + RUN_K + 1 for a run, at most C) when the padding
    past count holds one value per plane, which no op moves or changes
    but an ack (an ack that reaches the padding is counted at these rows
    too); else all C slots. The work of the function on this run's data,
    where fused_apply_lane_ops(kinds, C, ...) counts every slot."""
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.oppack import OpKind
    k, a = state.overlap_slots, state.anno_slots
    c = state.capacity
    st = pa._to_planes(state)
    fields, cols = pa.op_cols(ops, runs)
    lane = torch.arange(c, device=state.length.device)
    out = []
    for t in range(ops.steps):
        count = st["count"]
        pad = lane >= count
        at = count.clamp(0, c - 1).long()
        uniform = (count >= 0) & (count <= c)
        for name in pa._plane_names(k, a):
            first = st[name].gather(1, at)
            uniform &= ((st[name] == first) | ~pad).all(1, keepdim=True)
        op = {f: cols[f][:, t:t + 1] for f in fields}
        need = 2 if runs is None else torch.where(
            op["kind"] == OpKind.INSERT_RUN, RUN_K + 1, 2)
        out.append(torch.where(uniform, (count + need).clamp(max=c), c))
        st = pa._apply_one_batched(st, op, k, a, with_runs=runs is not None)
    return torch.cat(out, 1).cpu().numpy()


def fused_apply_bytes(batch: int, capacity: int, steps: int, k: int, a: int,
                      runs: bool, extract: bool) -> float:
    """Bytes the fused apply must move: the state read once and written
    once ((8 + K + A) int32 planes + three int32 scalars + the overflow
    byte per document), the 10 op columns, the 3 RunCols columns with
    runs=, and the 14 narrow bytes per document with extract=True."""
    state = (8 + k + a) * capacity * 4 + 13
    per_doc = 2 * state + 10 * steps * 4 + \
        (3 * steps * RUN_K * 4 if runs else 0) + (14 if extract else 0)
    return float(batch * per_doc)


def assert_trees_equal(got, want, what: str) -> None:
    """Two output trees of the same structure (NamedTuples, tuples,
    tensors): every leaf equal in dtype, shape and value."""
    if want is None:
        require(got is None, f"{what}: expected None")
    elif hasattr(want, "_fields"):
        for name, g, w in zip(want._fields, got, want):
            assert_trees_equal(g, w, f"{what}.{name}")
    elif isinstance(want, (tuple, list)):
        require(len(got) == len(want), f"{what}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{what}[{i}]")
    else:
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"{what}: dtype/shape {got.dtype}{tuple(got.shape)} vs "
                f"{want.dtype}{tuple(want.shape)}")
        if not bool((got == want).all()):
            raise SmokeFailure(f"{what}: differs in "
                               f"{int((got != want).sum())} elements")


def long_table(dev, batch: int, capacity: int, rows: int):
    """`rows` one-char segments at seq 0 per document (phase 6: so that
    every shift moves lanes across the 1,024-thread chunk boundary), K=3,
    A=4, built on `dev`."""
    from fluidframework_tpu_torch.mergetree.state import make_state
    st = make_state(capacity, A_SLOTS, K_SLOTS, batch=batch, device=dev)
    st.length[:, :rows] = 1
    st.ins_seq[:, :rows] = 0
    st.ins_client[:, :rows] = 0
    st.origin_op[:, :rows] = torch.arange(rows, dtype=torch.int32,
                                          device=st.length.device)
    st.count[:] = rows
    return st


def ring_trial(serve, ts, pool_pre, lww, args, stage_names=None):
    """One timed megakernel ring from a copy of the pre-ring pool: (device
    ms, host ms, {stage: device ms} when stage_names is given)."""
    pool = type(pool_pre)(*(t.clone() for t in pool_pre))
    torch.cuda.synchronize()
    marks = []

    def stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    serve(ts, pool, lww, *args, stats=True,
          stage=stage if stage_names is not None else None)
    e1.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - h0) * 1e3
    split = None
    if stage_names is not None:
        split = dict.fromkeys(stage_names, 0.0)
        prev = e0
        for name, ev in marks:
            split[name] += prev.elapsed_time(ev)
            prev = ev
    return e0.elapsed_time(e1), host, split


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
    require(ptxas.exists(), f"no ptxas report beside the library ({ptxas})")
    report = ptxas_report(ptxas.read_text())
    for kern, r in sorted(report.items()):
        print(f"  ptxas: {kern}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spill stores / loads")
    apply_kernels = {k: r for k, r in report.items() if "fused_apply" in k}
    require(len(apply_kernels) == 24,
            f"expected 24 fused apply kernels, ptxas reports "
            f"{sorted(apply_kernels)}")
    scan_kernels = {k: r for k, r in report.items() if "scan_apply" in k}
    require(len(scan_kernels) == 8,
            f"expected 8 scan apply kernels (4 paths x 2 variants), ptxas "
            f"reports {sorted(scan_kernels)}")
    spilled = sorted(k for k, r in {**apply_kernels, **scan_kernels}.items()
                     if r.get("stack") or r.get("spill_stores")
                     or r.get("spill_loads"))  # refused after the timings
    moved = {k: (r.get("registers"), fused_registers_recorded(k))
             for k, r in apply_kernels.items()
             if r.get("registers") != fused_registers_recorded(k)}
    print("  ptxas: fused_apply registers "
          + ("equal to the table recorded in PERF.md" if not moved else
             f"differ from the table recorded in PERF.md (now, then): "
             f"{moved}"), flush=True)
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

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        pallas_apply.reset_launches()

    def read_counts():
        got = {k: fn.launches for k, fn in wrappers.items()}
        got.update({f"fused_apply[{v}]": n for v, n in
                    pallas_apply.apply_ops_fused.variant_launches.items()})
        got.update({f"fused_apply<{p}>": n for p, n in
                    pallas_apply.apply_ops_fused.path_launches.items()})
        return got

    reset_counts()
    tout, mout, ticketed, total = pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    launches = read_counts()
    require(launches["fused_apply"] > 0 and launches["summary_len"] > 0,
            f"main path did not launch every kernel: {launches}")
    geo = pallas_apply.launch_geometry(DOCS, CAPACITY, 3, ANNO)
    require(launches[f"fused_apply<{geo.path}>"] == launches["fused_apply"],
            f"the north-star apply did not take the {geo.path} path that "
            f"launch_geometry names: {launches}")
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
          f"kernels ({geo}), launches {launches}, equal to the plain "
          "composition", flush=True)

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

    # -- phase 5: per-kernel numbers at the north-star path's shapes -------
    mstate0 = fresh()[1]
    admitted = pipeline.admit_ops(ops, ticketed)
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    summary_bytes = DOCS * (3 * CAPACITY * 4 + 3 * 4)
    rows = [
        dict(name="selftest", variant=None, source="fluidframework_tpu_"
             "torch/kernels/csrc/selftest.cu",
             replaces="fluidframework_tpu/mergetree/pallas_ops.py:42",
             on_main_path=False, launches=launches["selftest"],
             err=max_abs_err([kernels.selftest(x)], [x * 2]),
             ms=ms_of(lambda: kernels.selftest(x), 200),
             device_ms=one_kernel_ms(lambda: kernels.selftest(x), 200,
                                     "selftest_kernel"),
             plain_ms=ms_of(lambda: kernels.selftest_plain(x), 200),
             library_ms=ms_of(lambda: torch.mul(x, 2), 200),
             bytes=8 * 128 * 4 * 2, ops=8 * 128),
        dict(name="summary_len", variant=None, source="fluidframework_tpu_"
             "torch/kernels/csrc/summary_len.cu",
             replaces="fluidframework_tpu/mergetree/pallas_ops.py:58",
             on_main_path=True, launches=launches["summary_len"],
             err=max_abs_err([pallas_ops.summary_lengths(mout)],
                             [pallas_ops.summary_lengths_plain(mout)]),
             ms=ms_of(lambda: pallas_ops.summary_lengths(mout), 50),
             device_ms=one_kernel_ms(
                 lambda: pallas_ops.summary_lengths(mout), 50,
                 "summary_len_kernel"),
             plain_ms=ms_of(lambda: pallas_ops.summary_lengths_plain(mout),
                            10),
             library_ms=None, bytes=summary_bytes,
             ops=DOCS * CAPACITY * 6),
        dict(name="fused_apply", variant="plain", source="fluidframework_"
             "tpu_torch/kernels/csrc/fused_apply.cu",
             replaces="fluidframework_tpu/mergetree/pallas_apply.py:462",
             on_main_path=True, launches=launches["fused_apply[plain]"],
             err=max_abs_err(pallas_apply.apply_ops_fused(mstate0, admitted),
                             p_mout),
             ms=ms_of(lambda: pallas_apply.apply_ops_fused(mstate0,
                                                           admitted), 5),
             device_ms=one_kernel_ms(
                 lambda: pallas_apply.apply_ops_fused(mstate0, admitted), 5,
                 "fused_apply_kernel"),
             path=geo.path,
             paths=path_times(mstate0, admitted, None, False, 5),
             plain_ms=ms_of(lambda: pallas_apply.apply_ops_fused_plain(
                 mstate0, admitted), 1),
             library_ms=None,
             bytes=fused_apply_bytes(DOCS, CAPACITY, OPS, 3, ANNO, False,
                                     False),
             ops=fused_apply_lane_ops(admitted.kind.cpu().numpy(),
                                      live_slots(mstate0, admitted), 3,
                                      ANNO),
             ops_every_slot=fused_apply_lane_ops(
                 admitted.kind.cpu().numpy(), CAPACITY, 3, ANNO)),
    ]
    check_paths(f"north-star [{DOCS} x {CAPACITY}] x T {OPS}", rows[-1],
                card)
    del mstate0, mout, p_mout, tout, p_tout, ticketed, p_ticketed, admitted

    rows += serving_phases(dev, card)
    fuzz_phase(dev)
    scan_fuzz_phase(dev)
    rows += scan_full_step_phase(dev, card)
    catchup_rows, catchup_entries = catchup_phases(dev, card)
    rows += catchup_rows
    rows += paged_phase(dev, card)
    scalar_phase(dev, card, catchup_entries)

    require(not spilled, f"apply kernels use stack or spill: {spilled}")
    out = []
    for r in rows:
        b_ms = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        o_ms = r["ops"] / PEAK_OPS_PER_S * 1e3
        require(r["err"] == 0, f"{r['name']}: max_abs_err {r['err']}")
        row = {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "variant": r["variant"],
            "launches": r["launches"], "on_main_path": r["on_main_path"],
            "max_abs_err": r["err"], "bit_exact": True, "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": r["library_ms"]}
        if "ops_every_slot" in r:  # the apply kernels: both work counts
            every = r["ops_every_slot"]
            row.update(
                bound_ms_every_slot=max(b_ms, every / PEAK_OPS_PER_S * 1e3),
                bound_ms_every_slot_fp32_peak=max(
                    b_ms, every / PEAK_FP32_OPS_PER_S * 1e3))
        if "sms" in r:  # the scan rows: the bound on the SMs it can use
            row["bound_ms_sms"] = max(b_ms, r["ops"] / (
                PEAK_OPS_PER_S * r["sms"] / SM_COUNT) * 1e3)
        row.update({key: r[key] for key in ("path", "paths", "shape",
                                            "device_ms_by", "sms",
                                            "blocks", "threads")
                    if key in r})
        out.append(row)
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def serving_phases(dev, card: str) -> list:
    """Phases 6-8, the paged serving megakernel; returns the kernel rows
    of the fused apply's extract and runs+extract variants."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import oppack
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.paging import PagedMergeStore
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import serve_step
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.server.lww_kernel import make_lww_state
    from fluidframework_tpu_torch.testing import golden, serving
    from fluidframework_tpu_torch.testing.traces import (gen_run_traces,
                                                         gen_traces)

    require(oppack.RUN_K == RUN_K, "RUN_K differs from mergetree/oppack")

    # -- phase 6: the runs= and extract=True variants vs plain -----------
    def check_variants(what, state, cols, runs_np):
        ops = interop.packed_ops_from_numpy(cols, dev)
        runs = interop.run_cols_from_numpy(runs_np, dev)
        plain_ops = interop.packed_ops_from_numpy(
            gen_traces(state.length.shape[0], cols["kind"].shape[1],
                       seed=7), dev)
        for o, r, ex in ((ops, runs, False), (plain_ops, None, True),
                         (ops, runs, True)):
            got = pa.apply_ops_fused(state, o, runs=r, extract=ex)
            want = pa.apply_ops_fused_plain(state, o, runs=r, extract=ex)
            torch.cuda.synchronize()
            assert_trees_equal(got, want, f"{what} "
                               f"[{pa.variant_name(r, ex)}]")
        print(f"phase 6: runs / extract / runs+extract bit-exact: {what}",
              flush=True)

    cols, runs = gen_run_traces(VARIANT_BATCH, 64, seed=11)
    check_variants(f"gen_run_traces({VARIANT_BATCH}, 64) C=512",
                   make_state(512, A_SLOTS, batch=VARIANT_BATCH,
                              device=dev), cols, runs)
    cols, runs = gen_run_traces(8, 6, seed=12)
    check_variants("C=1100, 1030 rows: shifts by 8 across the chunk "
                   "boundary", long_table(dev, 8, 1100, 1030), cols, runs)
    cols, runs = gen_run_traces(128, 100, seed=13)
    check_variants("1,024-row page-group view, gen_run_traces(128, 100)",
                   make_state(1024, A_SLOTS, batch=128, device=dev),
                   cols, runs)

    # -- phase 7: the golden ring vs the JAX outputs ---------------------
    g = golden.load(golden.SERVE_GOLDEN_PATH)
    n_lww = sum(1 for k in g if k.startswith("lww_in_"))
    ring = interop.ring_args_from_numpy(serving.ring_from_arrays(g["ring"]),
                                        dev)
    ts, pool, lww, flat16_k, msn_k, pre = serve_step.serve_megakernel(
        interop.ticket_state_from_numpy(g["tstate_in"], dev),
        interop.page_pool_from_numpy(g["pool_in"], dev),
        [interop.lww_state_from_numpy(g[f"lww_in_{i}"], dev)
         for i in range(n_lww)], *ring, stats=True)
    assert_matches_numpy(ts, g["tstate_out"], "golden ring tstate")
    assert_matches_numpy(pool, g["pool_out"], "golden ring pool")
    for i, s in enumerate(lww):
        assert_matches_numpy(s, g[f"lww_out_{i}"], f"golden ring lww {i}")
    for i, v in enumerate(pre):
        assert_matches_numpy(v, g[f"pre_{i}"], f"golden ring pre view {i}")
    require(np.array_equal(flat16_k.cpu().numpy(), g["wire"]["flat16_k"]),
            "golden ring flat16_k")
    require(np.array_equal(msn_k.cpu().numpy(), g["wire"]["msn_k"]),
            "golden ring msn_k")
    print("phase 7: serve_megakernel equals the JAX golden ring (tstate, "
          "pool, LWW, flat16_k, msn_k, pre views)", flush=True)

    # -- phase 8: two full-size rings through the kernels ----------------
    fleet = serving.ServingFleet(getattr(serving, RING_SPEC), seed=0)
    spec = fleet.spec
    store = PagedMergeStore(pages=16384, device=dev)
    plain_serve = serve_step.make_serve_megakernel(keep=True, plain=True)
    wrappers = (pa.apply_ops_fused,)

    def run_ring(ts, lww):
        t0 = time.perf_counter()
        staged = fleet.stage_ring(store)
        stage_s = time.perf_counter() - t0
        args = interop.ring_args_from_numpy(staged.args, dev)
        pool_pre = type(store.pool)(*(t.clone() for t in store.pool))
        want = plain_serve(ts, pool_pre, lww, *args, stats=True)
        torch.cuda.synchronize()
        pa.reset_launches()
        got = serve_step.serve_megakernel(ts, store.pool, lww, *args,
                                          stats=True)
        torch.cuda.synchronize()
        counts = dict(wrappers[0].variant_launches)
        paths = dict(wrappers[0].path_launches)
        assert_trees_equal(got, want, "ring vs the plain composition")
        expect = dict.fromkeys(paths, 0)
        for gi, view in enumerate(got[5]):
            b, c = view.length.shape
            expect[pa.launch_geometry(b, c, K_SLOTS, A_SLOTS).path] += \
                args.merge_xs[gi].shape[0]
        require(paths == expect, f"ring path launches {paths}, the rule "
                f"names {expect}")
        b, t = spec.docs, spec.steps
        layout = serve_step.flat16_layout(b, t, staged.merge_lanes,
                                          staged.lww_lanes, True, True)
        lo, _hi = layout["overflow"]
        over = got[3][-1, lo:lo + sum(staged.merge_lanes)].cpu().numpy()
        expected = np.concatenate(staged.expected_overflow)
        require(np.array_equal(over != 0, expected),
                f"ring overflow lanes {np.flatnonzero(over)} differ from "
                f"the mispredicted-run lanes {np.flatnonzero(expected)}")
        serving.adopt_ring(store, staged, got[3][-1].cpu().numpy(),
                           stats=True)
        return staged, args, pool_pre, got, counts, stage_s

    ts0 = tk.make_ticket_state(serving.TICKET_CLIENTS, spec.docs,
                               device=dev)
    lww0 = [make_lww_state(spec.lww_capacity, fleet.lww_lanes, device=dev)]
    r1 = run_ring(ts0, lww0)
    print(f"phase 8: ring 1 (from empty) {r1[0].counts}, groups "
          f"{[tuple(p.shape) for p in r1[0].args.page_ids]}, staged in "
          f"{r1[5]:.2f} s, equal to the plain composition, each group on "
          "its rule's path", flush=True)
    ts1, lww1 = r1[3][0], r1[3][2]
    staged, args, pool_pre, got, counts, stage_s = run_ring(ts1, lww1)
    require(counts["extract"] > 0 and counts["runs_extract"] > 0,
            f"the ring did not launch both variants: {counts}")
    print(f"phase 8: ring 2 {staged.counts}, groups "
          f"{[tuple(p.shape) for p in staged.args.page_ids]} x Tm "
          f"{[m.shape[-1] for m in staged.args.merge_xs]}, pages in use "
          f"{store.pages_in_use}, staged in {stage_s:.2f} s; launches "
          f"{counts}, paths {dict(pa.apply_ops_fused.path_launches)}; equal "
          "to the plain composition; overflow only on "
          f"the {staged.counts['mispredicted_docs']} mispredicted-run "
          "lanes", flush=True)

    trials = [ring_trial(serve_step.serve_megakernel, ts1, pool_pre, lww1,
                         args) for _ in range(TRIALS)]
    splits = [ring_trial(serve_step.serve_megakernel, ts1, pool_pre, lww1,
                         args, RING_STAGES)[2] for _ in range(TRIALS)]
    ring_ms = float(np.median([t[0] for t in trials]))
    host_ms = float(np.median([t[1] for t in trials]))
    split = {k: round(float(np.median([s[k] for s in splits])), 3)
             for k in RING_STAGES}
    n_ops = staged.counts["merge_ops"] + staged.counts["lww_ops"]
    pool_copy = type(pool_pre)(*(t.clone() for t in pool_pre))
    trace = kernel_device_ms(lambda: serve_step.serve_megakernel(
        ts1, pool_copy, lww1, *args, stats=True), 1)
    if trace:
        busy = sum(ms for ms, _n in trace.values())
        apply_ms = sum(ms for name, (ms, _n) in trace.items()
                       if "fused_apply_kernel" in name)
        print(f"serve_megakernel ring device trace (torch.profiler, one "
              f"ring): {sum(n for _ms, n in trace.values()):.0f} kernel "
              f"launches, device busy {busy:.3f} ms of the {ring_ms:.3f} "
              f"ms p50 ring (idle share {1 - busy / ring_ms:.3f}), "
              f"fused_apply kernels {apply_ms:.3f} ms", flush=True)
    else:
        print("serve_megakernel ring device trace: not measured "
              "(torch.profiler recorded no device activity)", flush=True)
    print(f"serve_megakernel ring: {n_ops / (ring_ms / 1e3):.0f} ops/s "
          f"({staged.counts['merge_ops']} merge + "
          f"{staged.counts['lww_ops']} LWW ops, "
          f"{staged.counts['messages']} messages), p50 {ring_ms:.3f} ms "
          f"(host clock p50 {host_ms:.3f} ms, trials "
          f"{[round(t[0], 3) for t in trials]}), stage p50 ms {split}; "
          f"card {card}", flush=True)

    # -- per-variant numbers at the ring's shapes: window 0 of each group
    _ts, ticketed = tk.scan_tickets(
        ts1, tk.RawOps(client=args.ticket_xs[0, 1],
                       client_seq=args.ticket_xs[0, 2],
                       ref_seq=args.ticket_xs[0, 3],
                       kind=args.ticket_xs[0, 0]), require_join=True)
    per_group = []
    for gi, view in enumerate(got[5]):
        ops2, runs, _over = serve_step.admit_merge_ops(
            ticketed.seq, ticketed.min_seq, args.merge_xs[gi][0],
            None if args.runs_xs[gi] is None else args.runs_xs[gi][0])
        b, c = view.length.shape
        kern = pa.apply_ops_fused(view, ops2, runs=runs, extract=True)
        plain = pa.apply_ops_fused_plain(view, ops2, runs=runs,
                                         extract=True)
        torch.cuda.synchronize()
        variant = pa.variant_name(runs, True)
        r = dict(
            name=f"fused_apply_{variant}", variant=variant, group=gi,
            source="fluidframework_tpu_torch/kernels/csrc/fused_apply.cu",
            replaces="fluidframework_tpu/mergetree/pallas_apply.py:462",
            on_main_path=True, launches=counts[variant],
            err=max_abs_err(kern[0] + kern[1], plain[0] + plain[1]),
            ms=ms_of(lambda: pa.apply_ops_fused(view, ops2, runs=runs,
                                                extract=True), 20),
            device_ms=one_kernel_ms(lambda: pa.apply_ops_fused(
                view, ops2, runs=runs, extract=True), 20,
                "fused_apply_kernel"),
            path=pa.launch_geometry(b, c, K_SLOTS, A_SLOTS).path,
            paths=path_times(view, ops2, runs, True, 20),
            plain_ms=ms_of(lambda: pa.apply_ops_fused_plain(
                view, ops2, runs=runs, extract=True), 1),
            library_ms=None, cells=b * c,
            bytes=fused_apply_bytes(b, c, ops2.steps, K_SLOTS, A_SLOTS,
                                    runs is not None, True),
            ops=fused_apply_lane_ops(ops2.kind.cpu().numpy(),
                                     live_slots(view, ops2, runs), K_SLOTS,
                                     A_SLOTS),
            ops_every_slot=fused_apply_lane_ops(ops2.kind.cpu().numpy(), c,
                                                K_SLOTS, A_SLOTS))
        bound = max(r["bytes"] / PEAK_BYTES_PER_S,
                    r["ops"] / PEAK_OPS_PER_S) * 1e3
        print(f"  fused_apply[{variant}] window 0 of group {gi} "
              f"[{b} x {c}] x Tm {ops2.steps}: {r['ms']:.4f} ms back to "
              f"back, {fmt_ms(r['device_ms'])} kernel device time (bound "
              f"{bound:.4f} ms over the rows in use), plain "
              f"{r['plain_ms']:.3f} ms, max_abs_err {r['err']}", flush=True)
        check_paths(f"group {gi}", r, card)
        require(r["err"] == 0, f"group {gi}: kernel vs plain differ")
        per_group.append(r)
    # the JSON row of a variant is its largest group
    rows = []
    for variant in ("extract", "runs_extract"):
        mine = [r for r in per_group if r["variant"] == variant]
        require(bool(mine), f"no page group runs the {variant} variant")
        rows.append(max(mine, key=lambda r: r["cells"]))
    return rows


def fuzz_phase(dev) -> None:
    """Phase 9: both fused-apply paths, in all four variants, bit-exact
    against the plain version at every capacity of FUZZ_CAPACITIES that
    the path takes: fuzz_tables (empty documents and near-full ones, so
    every capacity gate trips) under gen_fuzz_traces (every op kind, four
    clients, pending local ops and their acks, stale perspectives,
    positions past the end, INSERT_RUN steps with dead members, whose
    8-row shifts and fills straddle the rows of the warp path)."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                         gen_fuzz_traces)
    t0 = time.perf_counter()
    checked = dict.fromkeys(PATHS, 0)
    flagged = 0
    for c in FUZZ_CAPACITIES:
        for k, a in FUZZ_SLOTS:
            for seed in FUZZ_SEEDS:
                tables = fuzz_tables(FUZZ_DOCS, c, k, a, seed=seed)
                state = interop.doc_state_from_numpy(tables, dev)
                length = tables["count"] * 2
                cols = gen_fuzz_traces(FUZZ_DOCS, FUZZ_OPS, seed=seed,
                                       length=length)
                rcols, rruns = gen_fuzz_traces(FUZZ_DOCS, FUZZ_OPS,
                                               seed=seed + 100, runs=True,
                                               length=length)
                cases = []
                for ops, runs in (
                        (interop.packed_ops_from_numpy(cols, dev), None),
                        (interop.packed_ops_from_numpy(rcols, dev),
                         interop.run_cols_from_numpy(rruns, dev))):
                    want = pa.apply_ops_fused_plain(state, ops, runs=runs)
                    flagged += int(want.overflow.sum())
                    cases.append((ops, runs, want))
                for path in PATHS:
                    if path == "warp" and c > pa.WARP_MAX_CAPACITY:
                        continue
                    geo = pa._forced_geometry(path, c, k, a)
                    for ops, runs, want in cases:
                        for ex in (False, True):
                            got = pa._launch(state, ops, runs, ex, geo)
                            torch.cuda.synchronize()
                            assert_trees_equal(
                                got, (want, pa.narrow_of(want)) if ex
                                else want,
                                f"fuzz C={c} K={k} A={a} seed={seed} {path} "
                                f"[{pa.variant_name(runs, ex)}]")
                            checked[path] += 1
    print(f"phase 9: fuzz bit-exact on both paths, {checked} launches "
          f"(4 variants x capacities {FUZZ_CAPACITIES} x (K, A) "
          f"{FUZZ_SLOTS} x seeds {FUZZ_SEEDS}, {FUZZ_DOCS} docs x "
          f"{FUZZ_OPS} ops; {flagged} overflowed documents in the plain "
          f"results), {time.perf_counter() - t0:.1f} s", flush=True)


def fused_takes(pa, capacity: int, k: int, a: int) -> bool:
    """Whether the fused apply takes this shape (at most 32 planes, the
    table in one block's shared memory)."""
    try:
        return capacity <= pa.max_fused_capacity(k, a)
    except ValueError:
        return False


def scan_geometries(batch: int, capacity: int, k: int, a: int) -> dict:
    """{label: ScanGeometry} of every scan-apply path that holds the table,
    at the rule's threads for `batch` documents: global_chunked, global,
    smem, and each cluster of SCAN_CLUSTER_SIZES."""
    from fluidframework_tpu_torch.mergetree import kernel
    out = {p: kernel._forced_geometry(p, capacity, k, a, batch=batch)
           for p in ("global_chunked", "global")}
    try:
        out["smem"] = kernel._forced_geometry("smem", capacity, k, a,
                                              batch=batch)
    except ValueError:
        pass
    for n in SCAN_CLUSTER_SIZES:
        try:
            out[f"cluster{n}"] = kernel._forced_geometry(
                "cluster", capacity, k, a, blocks=n, batch=batch)
        except ValueError:
            pass
    return out


def scan_label(geo) -> str:
    return f"cluster{geo.blocks}" if geo.path == "cluster" else geo.path


def scan_fuzz_phase(dev) -> None:
    """Phase 10: every scan-apply path (scan_geometries) bit-exact against
    the plain scan on fuzz_tables under gen_fuzz_traces over
    SCAN_CAPACITIES x SCAN_BATCHES x SCAN_ANNO, plain and runs variants; a
    one-document cell takes the near-full document of a fuzzed pair. Where
    the fused apply takes the capacity, the scan kernel must also equal
    the fused kernel, bit for bit."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                         gen_fuzz_traces)
    t0 = time.perf_counter()
    checked, vs_fused, flagged, dropped = {}, 0, 0, []
    for ci, c in enumerate(SCAN_CAPACITIES):
        steps = 24 if c <= 4200 else 12 if c <= 16384 else 8
        for b in SCAN_BATCHES:
            for a in SCAN_ANNO:
                if b * c * (8 + 3 + a) > SCAN_MAX_INTS:
                    dropped.append((b, c, a))
                    continue
                seed = 1000 + 10 * ci + a
                tables = fuzz_tables(max(b, 2), c, 3, a, seed=seed)
                if b == 1:  # the near-full document
                    tables = {f: v[1:2] for f, v in tables.items()}
                state = interop.doc_state_from_numpy(tables, dev)
                length = tables["count"] * 2
                geos = scan_geometries(b, c, 3, a)
                for with_runs in (False, True):
                    got = gen_fuzz_traces(b, steps, seed=seed + with_runs,
                                          runs=with_runs, length=length)
                    cols, run_np = got if with_runs else (got, None)
                    ops = interop.packed_ops_from_numpy(cols, dev)
                    runs = None if run_np is None else \
                        interop.run_cols_from_numpy(run_np, dev)
                    want = kernel.scan_ops_plain(state, ops, True, runs)
                    flagged += int(want.overflow.sum())
                    what = f"scan C={c} B={b} A={a} runs={with_runs}"
                    for label, geo in geos.items():
                        out = kernel._launch(state, ops, runs, geo)
                        torch.cuda.synchronize()
                        assert_trees_equal(out, want, f"{what} {label}")
                        checked[label] = checked.get(label, 0) + 1
                    if fused_takes(pa, c, 3, a):
                        fused = pa.apply_ops_fused(state, ops, runs)
                        torch.cuda.synchronize()
                        assert_trees_equal(want, fused, f"{what} vs fused")
                        vs_fused += 1
                del state, out, want
    print(f"phase 10: every scan_apply path bit-exact against the plain "
          f"scan, launches by path {checked} (capacities "
          f"{SCAN_CAPACITIES} x documents {SCAN_BATCHES} x A {SCAN_ANNO} x "
          f"plain/runs, K=3; {flagged} overflowed documents in the plain "
          f"results), and equal to the fused kernel in the {vs_fused} "
          f"cells where it applies; dropped cells (B, C, A): "
          f"{dropped or 'none'}; {time.perf_counter() - t0:.1f} s",
          flush=True)


def scan_rows(what: str, state, ops, runs, kernel_launches: dict,
              reps: int, shape: str, card: str,
              main_path: bool = True) -> list:
    """The kernel rows of one scan-apply input ([B, C] CUDA tensors) on
    every path (scan_geometries): kernel device ms (CUDA events,
    long_kernel_ms) and back-to-back ms, the launches of the rule's path
    in the main path's run (0 on the other rows), the plain scan's ms,
    the bound's work (the rows
    in use and every slot) and the SMs the launch can occupy. Fails unless
    every path equals the plain scan and, for a main path's input, the
    rule's path is at most PATH_MARGIN slower on the device than the
    fastest."""
    from fluidframework_tpu_torch.mergetree import kernel
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    variant = "runs" if runs is not None else "plain"
    want = kernel.scan_ops_plain(state, ops, True, runs)
    plain_ms = once_ms(lambda: kernel.scan_ops_plain(state, ops, True,
                                                      runs))
    torch.cuda.synchronize()
    kinds = ops.kind.cpu().numpy()
    work = dict(
        bytes=fused_apply_bytes(b, c, ops.steps, k, a, runs is not None,
                                False),
        ops=fused_apply_lane_ops(kinds, live_slots(state, ops, runs), k, a),
        ops_every_slot=fused_apply_lane_ops(kinds, c, k, a))
    rule_geo = kernel.scan_geometry(b, c, k, a)
    rule = scan_label(rule_geo)
    geos = scan_geometries(b, c, k, a)
    require(geos.get(rule) == rule_geo,
            f"scan_apply at {shape}: the rule's {rule_geo} is not among "
            f"the forced geometries")
    rows = []
    for label, geo in geos.items():
        def run(geo=geo):
            return kernel._launch(state, ops, runs, geo)
        r = dict(
            name="scan_apply", variant=variant, shape=shape, path=label,
            blocks=geo.blocks, threads=geo.threads,
            source="fluidframework_tpu_torch/kernels/csrc/scan_apply.cu",
            replaces="fluidframework_tpu/mergetree/kernel.py:396",
            on_main_path=main_path and label == rule,
            launches=kernel_launches.get(f"{geo.path}[{variant}]", 0)
            if label == rule else 0,
            err=max_abs_err(run(), want), ms=ms_of(run, reps),
            plain_ms=plain_ms, library_ms=None,
            sms=min(b * geo.blocks, SM_COUNT), **work)
        r["device_ms"], r["device_ms_by"] = long_kernel_ms(run, reps)
        require(r["err"] == 0, f"scan_apply {what} {label}: kernel vs "
                "plain differ")
        rows.append(r)
    bound = max(work["bytes"] / PEAK_BYTES_PER_S,
                work["ops"] / PEAK_OPS_PER_S) * 1e3
    every = max(work["bytes"] / PEAK_BYTES_PER_S,
                work["ops_every_slot"] / PEAK_OPS_PER_S) * 1e3
    print(f"  scan_apply[{variant}] {what} [{shape}]: bound {bound:.5f} ms "
          f"over the rows in use, {every:.5f} ms over every slot; plain "
          f"{plain_ms:.3f} ms; the rule takes {rule}; card {card}",
          flush=True)
    for r in rows:
        sm_bound = max(work["bytes"] / PEAK_BYTES_PER_S, work["ops"] / (
            PEAK_OPS_PER_S * r["sms"] / SM_COUNT)) * 1e3
        print(f"    {r['path']} ({r['blocks']} block(s) x {r['threads']} "
              f"threads): {fmt_ms(r['device_ms'])} device "
              f"({r['device_ms_by']}), {r['ms']:.4f} ms back to back; "
              f"bound on its {r['sms']} SM(s) {sm_bound:.5f} ms",
              flush=True)
    dev_ms = {r["path"]: r["device_ms"] for r in rows}
    best = min(dev_ms.values())
    require(not main_path or dev_ms[rule] <= best * (1 + PATH_MARGIN),
            f"scan_apply at {shape}: the rule's {rule} path "
            f"({dev_ms[rule]:.4f} ms) is more than {PATH_MARGIN:.0%} slower "
            f"than the fastest path ({best:.4f} ms)")
    return rows


def catchup_split(catchup, kernel, tail, dev, captured, n_ops: int,
                  what: str, card: str) -> dict:
    """A timed catch-up run, the compaction's device time, then a profiled
    run (the longest trace of the script): wall, device busy and idle
    share, the scan kernels' device time, the host's ms by stage."""
    stats = {}
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    entries = catchup.device_apply_tail([], tail, 0, 0, device=dev,
                                        stats=stats)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - h0) * 1e3
    compact_ms = 0.0
    for c, n in stats["compacts"].items():
        st = captured[c][0]
        per = kernel_device_ms(lambda: kernel.compact(st), 3)
        compact_ms += n * sum(ms for ms, _n in per.values())
    trace = kernel_device_ms(lambda: catchup.device_apply_tail(
        [], tail, 0, 0, device=dev), 1)
    busy = sum(ms for ms, _n in trace.values()) if trace else None
    scan_ms = sum(ms for name, (ms, _n) in trace.items()
                  if "scan_apply_kernel" in name) if trace else None
    host = {k: round(v * 1e3, 3) for k, v in stats.items()
            if k.endswith("_s")}
    print(f"catch-up ({what}): {n_ops / (wall_ms / 1e3):.0f} ops/s, wall "
          f"{wall_ms:.3f} ms; chunks {stats['chunks']}, folds "
          f"{stats.get('folds', 0)}, retries {stats.get('retries', 0)}, "
          f"compacts {stats['compacts']}, host reads {stats['host_reads']}; "
          f"scan_apply kernels {fmt_ms(scan_ms)} device (profiler), "
          f"compact {compact_ms:.3f} ms device; host ms {host}; device busy "
          f"{fmt_ms(busy)} of the {wall_ms:.3f} ms wall (idle share "
          + (f"{1 - busy / wall_ms:.3f}" if busy else "not measured")
          + f"); card {card}", flush=True)
    return {"entries": entries, "wall_ms": wall_ms, "busy_ms": busy,
            "scan_ms": scan_ms}


def catchup_phases(dev, card: str):
    """Phase 11, the configuration at full size: keystroke_trace(100,000,
    seed=12) through mergetree/catchup.device_apply_tail on the card,
    every chunk on the scan-apply kernel and on the path scan_geometry
    names, held to the JAX golden digest; its first PLAIN_PREFIX ops also
    through the plain composition, entry by entry; every path timed at
    the first chunk of each capacity; a timed and a profiled run, then the
    same with every chunk forced onto global_chunked. Returns the scan
    kernel's rows and the catch-up's entries."""
    from fluidframework_tpu_torch.mergetree import catchup, kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    g = golden.load_catchup()
    n_ops, seed, n_clients = g["full"]["trace"]
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)

    # The main path, counted: every apply launches the kernel once, on the
    # rule's path. The first chunk at each capacity is kept for the
    # timings below.
    captured, expected = {}, {}
    apply_keep = kernel.apply_ops_keep

    def capture(state, ops, runs=None):
        captured.setdefault(state.capacity, (
            type(state)(*(t.clone() for t in state)), ops, runs))
        geo = kernel.scan_geometry(1, state.capacity, state.overlap_slots,
                                   state.anno_slots)
        key = f"{geo.path}[{'plain' if runs is None else 'runs'}]"
        expected[key] = expected.get(key, 0) + 1
        return apply_keep(state, ops, runs)

    stats = {}
    kernel.apply_ops_keep = capture
    try:
        kernel.reset_launches()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        entries = catchup.device_apply_tail([], tail, 0, 0, device=dev,
                                            stats=stats)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - h0) * 1e3
        launches = kernel.scan_apply.launches
        by_kernel = {k: n for k, n in
                     kernel.scan_apply.kernel_launches.items() if n}
    finally:
        kernel.apply_ops_keep = apply_keep
    applies = sum(stats["chunks"].values())
    require(launches > 0 and launches == applies,
            f"catch-up: {launches} scan_apply launches for {applies} chunk "
            "applies")
    require(by_kernel == expected,
            f"catch-up: launches by kernel {by_kernel}, the rule names "
            f"{expected}")
    digest = golden.entries_digest(entries)
    require(digest == g["full"]["digest"],
            f"catch-up of {n_ops} ops: {digest} differs from the JAX "
            f"golden {g['full']['digest']}")
    print(f"phase 11: catch-up of keystroke_trace({n_ops}, seed={seed}) "
          f"on the card equals the JAX golden (entries {digest['count']}, "
          f"visible length {digest['visible_length']}, entries and text "
          f"sha256); scan_apply launches {launches} by kernel {by_kernel}, "
          f"each on the rule's path; first run {first_ms:.1f} ms",
          flush=True)
    small_n, small_seed, small_clients = g["small"]["trace"]
    small = catchup.device_apply_tail(
        [], keystroke_trace(small_n, seed=small_seed,
                            n_clients=small_clients), 0, 0, device=dev)
    require(small == g["small"]["entries"],
            f"catch-up of the {small_n}-op golden trace differs from JAX")

    head = tail[:PLAIN_PREFIX]
    got = catchup.device_apply_tail([], head, 0, 0, device=dev)
    want = catchup.device_apply_tail([], head, 0, 0, device=dev, plain=True)
    require(len(got) == len(want), f"first {PLAIN_PREFIX} ops: "
            f"{len(got)} entries vs {len(want)} in the plain composition")
    for i, (x, y) in enumerate(zip(got, want)):
        require(x == y, f"first {PLAIN_PREFIX} ops: entry {i} differs "
                f"from the plain composition: {x} vs {y}")
    print(f"phase 11: the first {PLAIN_PREFIX} ops equal the plain "
          f"composition entry by entry ({len(got)} entries)", flush=True)

    # every path's times at the catch-up's shapes (first chunk of each)
    rows = []
    for c in sorted(captured):
        state, ops, runs = captured[c]
        bs, bo = kernel._lift(state), kernel._lift(ops)
        br = kernel._lift(runs)
        rows += scan_rows("catch-up chunk", bs, bo, br, by_kernel, 3,
                          f"1 x C={c} x T {ops.steps}", card)
    # the C = 4,096 chunk with its annotate ring cut to one slot: the table
    # then fits one block (the smem path's row) and the fused apply takes
    # it too, which must agree
    if 4096 in captured:
        state, ops, runs = captured[4096]
        bs = kernel._lift(state)
        bs = bs._replace(anno=bs.anno[..., :1].contiguous())
        bo, br = kernel._lift(ops), kernel._lift(runs)
        require(4096 <= pa.max_fused_capacity(3, 1), "C=4096 > fused limit")
        fused_out = pa.apply_ops_fused(bs, bo, br)
        scan_out = kernel.scan_apply(bs, bo, br)
        torch.cuda.synchronize()
        assert_trees_equal(scan_out, fused_out, "C=4096 A=1 scan vs fused")
        f_dev = long_kernel_ms(lambda: pa.apply_ops_fused(bs, bo, br), 3)
        print(f"  C=4096 chunk at A=1: fused_apply {f_dev[0]:.4f} ms device "
              f"({f_dev[1]}; {pa.launch_geometry(1, 4096, 3, 1).path} "
              "path), equal to the scan apply", flush=True)
        rows += scan_rows("catch-up chunk at A=1", bs, bo, br, by_kernel, 3,
                          f"1 x C=4096 x T {ops.steps}, A=1", card,
                          main_path=False)

    new = catchup_split(catchup, kernel, tail, dev, captured, n_ops,
                        "the rule's paths", card)
    require(new["entries"] == entries, "catch-up: the timed run differs")
    rule = kernel.scan_geometry
    kernel.scan_geometry = lambda b, c, k, a: kernel._forced_geometry(
        "global_chunked", c, k, a)
    try:
        old = catchup_split(catchup, kernel, tail, dev, captured, n_ops,
                            "every chunk on global_chunked", card)
    finally:
        kernel.scan_geometry = rule
    require(old["entries"] == entries,
            "catch-up on global_chunked differs from the rule's paths")
    return rows, entries


def scan_full_step_phase(dev, card: str) -> list:
    """full_step above the fused capacity: SCAN_STEP documents x ops at
    capacity C through the scan-apply and summary-length kernels, counted,
    against the plain composition; returns the scan kernel's row."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree import pallas_ops
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing.traces import gen_traces

    b, t, c = SCAN_STEP
    require(c > pa.max_fused_capacity(3, 1), "SCAN_STEP fits the fused apply")
    ops = interop.packed_ops_from_numpy(gen_traces(b, t, seed=3), dev)
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)

    def fresh():
        return (tk.make_ticket_state(TICKET_K, b, device=dev),
                make_state(c, 1, batch=b, device=dev))

    kernel.reset_launches()
    pa.reset_launches()
    pallas_ops.summary_lengths.launches = 0
    out = pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    by_kernel = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                 if n}
    launches = {"scan_apply": kernel.scan_apply.launches,
                "summary_len": pallas_ops.summary_lengths.launches,
                "fused_apply": pa.apply_ops_fused.launches}
    require(launches == {"scan_apply": 1, "summary_len": 1,
                         "fused_apply": 0},
            f"full_step at C={c}: launches {launches}")
    rule = kernel.scan_geometry(b, c, 3, 1)
    require(by_kernel == {f"{rule.path}[plain]": 1},
            f"full_step at C={c}: scan launches {by_kernel}, the rule names "
            f"{rule.path}")
    want = pipeline.make_full_step(plain=True)(*fresh(), raw, ops)
    torch.cuda.synchronize()
    assert_trees_equal(out, want, f"full_step {b}x{t} C={c} vs plain")
    require(not bool(out[1].overflow.any()), f"full_step C={c} overflowed")
    step_ms = once_ms(lambda: pipeline.full_step(*fresh(), raw, ops))
    print(f"phase 11: full_step {b}x{t} at C={c} (above the fused "
          f"capacity) through the kernels, launches {launches}, equal to "
          f"the plain composition; {b * t / (step_ms / 1e3):.0f} ops/s, "
          f"step {step_ms:.3f} ms; card {card}", flush=True)
    admitted = pipeline.admit_ops(ops, out[2])
    rows = scan_rows("full_step", fresh()[1], admitted, None, by_kernel, 2,
                     f"{b} x C={c} x T {t}", card)
    # the same ops on tables that fit one block (the smem path's row)
    return rows + scan_rows("full_step's ops", make_state(
        1024, 1, batch=b, device=dev), admitted, None, by_kernel, 2,
        f"{b} x C=1024 x T {t}", card, main_path=False)


def device_busy_ms(fn):
    """Device busy milliseconds of one call of fn: torch.profiler's device
    time of every kernel it traced, except the scan-apply kernels, whose
    launches through ctypes the trace often misses: those are timed with
    a CUDA event pair around each launch (kernel._launch) in the same
    call. None when the profiler recorded nothing."""
    from torch.profiler import ProfilerActivity, profile

    from fluidframework_tpu_torch.mergetree import kernel
    launch, pairs = kernel._launch, []

    def timed(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(*args, **kwargs)
        e1.record()
        pairs.append((e0, e1))
        return out

    torch.cuda.synchronize()
    kernel._launch = timed
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        kernel._launch = launch
    other = [ev.self_device_time_total / 1e3 for ev in prof.key_averages()
             if ev.self_device_time_total > 0
             and "scan_apply_kernel" not in ev.key]
    if not other and not pairs:
        return None
    return sum(other) + sum(a.elapsed_time(b) for a, b in pairs)


def clone_state(st):
    return type(st)(*(t.clone() for t in st))


def paged_phase(dev, card: str) -> list:
    """Phase 12, a paged flush with hot documents: FULL_RING's partition
    plus HOT_RING's 64 documents pre-seeded to 3,500 live rows.
    (a) One megakernel ring: the small page groups on the fused apply,
    the hot group (C = 4,096, above max_fused_capacity) on the scan apply,
    counted per kernel, held to the plain composition, timed with a stage
    split. (b) A backlog staged as the JAX sequencer's
    MergeLaneStore._apply_paged stages it (testing/serving.
    stage_paged_groups): one apply_ops_paged per group of small documents,
    one serve_paged_burst for the hot documents' HOT_BACKLOG ops each (K =
    3 chunks at T = 256, padded to 4, C = 8,192), every output held to
    plain=True; the burst timed (events, device idle share); a
    rollback_pages round trip on a sub-plane of the hot group, then
    compact_pages over it. Returns the scan kernel's rows at the ring's
    hot-group window 0 and at the burst's first chunk."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.oppack import PackedOps
    from fluidframework_tpu_torch.mergetree.paging import (PagedMergeStore,
                                                           pow2_pages)
    from fluidframework_tpu_torch.server import serve_step
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.server.lww_kernel import make_lww_state
    from fluidframework_tpu_torch.testing import serving

    fleet = serving.ServingFleet(getattr(serving, HOT_SPEC), seed=0)
    spec = fleet.spec
    store = PagedMergeStore(pages=HOT_POOL_PAGES, device=dev)
    limit = pa.max_fused_capacity(K_SLOTS, A_SLOTS)

    # -- (a) one ring: fused apply on the small groups, scan on the hot one
    t0 = time.perf_counter()
    staged = fleet.stage_ring(store)
    stage_s = time.perf_counter() - t0
    args = interop.ring_args_from_numpy(staged.args, dev)
    caps = [p.shape[1] * store.page_rows for p in staged.args.page_ids]
    hot = [g for g, c in enumerate(caps) if c > limit]
    require(len(hot) == 1, f"phase 12: page group capacities {caps}, "
            f"expected one above {limit}")
    hot_g = hot[0]
    ts0 = tk.make_ticket_state(serving.TICKET_CLIENTS, spec.docs,
                               device=dev)
    lww0 = [make_lww_state(spec.lww_capacity, fleet.lww_lanes, device=dev)]
    pool_pre = clone_state(store.pool)
    want = serve_step.make_serve_megakernel(keep=True, plain=True)(
        ts0, pool_pre, lww0, *args, stats=True)
    torch.cuda.synchronize()
    pa.reset_launches()
    kernel.reset_launches()
    got = serve_step.serve_megakernel(ts0, store.pool, lww0, *args,
                                      stats=True)
    torch.cuda.synchronize()
    fused_n = pa.apply_ops_fused.launches
    fused_by = {v: n for v, n in pa.apply_ops_fused.variant_launches.items()
                if n}
    ring_scan = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                 if n}
    assert_trees_equal(got, want, "phase 12 ring vs the plain composition")
    n_pad = staged.args.page_ids[hot_g].shape[0]
    geo = kernel.scan_geometry(n_pad, caps[hot_g], K_SLOTS, A_SLOTS)
    variant = "plain" if staged.args.runs_xs[hot_g] is None else "runs"
    require(ring_scan == {f"{geo.path}[{variant}]": spec.windows},
            f"phase 12 ring: scan launches {ring_scan}, expected "
            f"{spec.windows} on {geo.path}[{variant}]")
    require(fused_n == spec.windows * (len(caps) - 1),
            f"phase 12 ring: {fused_n} fused launches for "
            f"{len(caps) - 1} groups x {spec.windows} windows")
    layout = serve_step.flat16_layout(spec.docs, spec.steps,
                                      staged.merge_lanes, staged.lww_lanes,
                                      True, True)
    lo, _hi = layout["overflow"]
    over = got[3][-1, lo:lo + sum(staged.merge_lanes)].cpu().numpy()
    require(np.array_equal(over != 0,
                           np.concatenate(staged.expected_overflow)),
            "phase 12 ring: overflow lanes differ from the mispredicted "
            "runs")
    print(f"phase 12: ring of {spec.docs} documents ({staged.counts}), "
          f"groups {[tuple(p.shape) for p in staged.args.page_ids]} (C "
          f"{caps}; the hot group above max_fused_capacity {limit}), "
          f"staged in {stage_s:.2f} s; fused launches {fused_by}, scan "
          f"launches {ring_scan} ({geo}); equal to the plain composition",
          flush=True)
    trials = [ring_trial(serve_step.serve_megakernel, ts0, pool_pre, lww0,
                         args) for _ in range(TRIALS)]
    splits = [ring_trial(serve_step.serve_megakernel, ts0, pool_pre, lww0,
                         args, RING_SCAN_STAGES)[2] for _ in range(TRIALS)]
    ring_ms = float(np.median([t[0] for t in trials]))
    split = {k: round(float(np.median([x[k] for x in splits])), 3)
             for k in RING_SCAN_STAGES}
    n_ops = staged.counts["merge_ops"] + staged.counts["lww_ops"]
    print(f"phase 12 ring: {n_ops / (ring_ms / 1e3):.0f} ops/s, p50 "
          f"{ring_ms:.3f} ms (host clock p50 "
          f"{float(np.median([t[1] for t in trials])):.3f} ms, trials "
          f"{[round(t[0], 3) for t in trials]}), stage p50 ms {split}; "
          f"card {card}", flush=True)
    ring_view = got[5][hot_g]
    serving.adopt_ring(store, staged, got[3][-1].cpu().numpy(), stats=True)
    del want, trials, splits

    # -- (b) the backlog: apply_ops_paged per group, a burst for the hot one
    streams = fleet.backlog(lambda cls: HOT_BACKLOG if cls.rows else cls.ops)
    groups = serving.stage_paged_groups(store, streams)
    bursts = [g for g in groups if g.burst]
    require(len(bursts) == 1 and bursts[0].ops["kind"].shape[0] == 4
            and bursts[0].page_ids.shape[1] * store.page_rows == 8192,
            f"phase 12 backlog: expected one 4-chunk burst at C = 8,192, "
            f"got {[(g.page_ids.shape, g.burst) for g in groups]}")

    def dispatch(pool, g, plain):
        dargs = [torch.from_numpy(x).to(dev) for x in (
            g.page_ids, g.counts, g.min_seqs, g.seqs)]
        ops = interop.packed_ops_from_numpy(g.ops, dev)
        fn = serve_step.serve_paged_burst if g.burst \
            else kernel.apply_ops_paged
        return fn(pool, *dargs, ops, stats=True, plain=plain)

    backlog_pre = clone_state(store.pool)
    ref_pool = clone_state(store.pool)
    refs = [dispatch(ref_pool, g, True) for g in groups]
    torch.cuda.synchronize()
    pa.reset_launches()
    kernel.reset_launches()
    outs = [dispatch(store.pool, g, False) for g in groups]
    torch.cuda.synchronize()
    backlog_scan = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                    if n}
    expect = {}
    for g in groups:
        b, p2 = g.page_ids.shape
        geo = kernel.scan_geometry(b, p2 * store.page_rows, K_SLOTS, A_SLOTS)
        key = f"{geo.path}[plain]"
        expect[key] = expect.get(key, 0) + (
            g.ops["kind"].shape[0] if g.burst else 1)
    require(backlog_scan == expect and pa.apply_ops_fused.launches == 0,
            f"phase 12 backlog: scan launches {backlog_scan}, expected "
            f"{expect}; fused launches {pa.apply_ops_fused.launches}")
    assert_trees_equal(store.pool, ref_pool, "phase 12 backlog pool")
    for g, out, ref in zip(groups, outs, refs):
        assert_trees_equal(out[1:], ref[1:], f"phase 12 backlog group "
                           f"{g.page_ids.shape}")
        require(not bool(out[5].any()), f"phase 12 backlog group "
                f"{g.page_ids.shape} overflowed")
    del ref_pool, refs
    print(f"phase 12: backlog of {sum(g.n_ops for g in groups)} ops in "
          f"{len(groups)} page groups "
          f"{[(tuple(g.page_ids.shape), 'burst' if g.burst else 'apply') for g in groups]}"
          f", scan launches by kernel {backlog_scan}; every output equal "
          "to plain=True", flush=True)

    hb = bursts[0]
    hot_i = groups.index(hb)
    hot_out = outs[hot_i]
    bargs = [torch.from_numpy(x).to(dev) for x in (
        hb.page_ids, hb.counts, hb.min_seqs, hb.seqs)]
    bops = interop.packed_ops_from_numpy(hb.ops, dev)
    burst_ms = []
    for _ in range(TRIALS):
        pool = clone_state(backlog_pre)
        burst_ms.append(once_ms(lambda: serve_step.serve_paged_burst(
            pool, *bargs, bops)))
    pool = clone_state(backlog_pre)
    busy = device_busy_ms(lambda: serve_step.serve_paged_burst(
        pool, *bargs, bops))
    b_ms = float(np.median(burst_ms))
    print(f"phase 12 burst: {hb.n_ops} ops of {len(hb.keys)} hot documents"
          f" in {hb.ops['kind'].shape[0]} chunks of [{hb.page_ids.shape[0]}"
          f" x C={hb.page_ids.shape[1] * store.page_rows}] x T "
          f"{hb.ops['kind'].shape[-1]}: {hb.n_ops / (b_ms / 1e3):.0f} "
          f"ops/s, p50 {b_ms:.3f} ms (trials "
          f"{[round(x, 3) for x in burst_ms]}); device busy "
          f"{fmt_ms(busy)} (profiler, scan kernels by events; idle share "
          + (f"{1 - busy / b_ms:.3f}" if busy else "not measured")
          + f"); card {card}", flush=True)
    del pool, backlog_pre

    # rollback_pages round trip on the hot group's first two lanes
    sub = torch.arange(2, device=dev)
    sub_pids = bargs[0][sub]
    pre_sub = type(hot_out[7])(*(t[sub] for t in hot_out[7]))
    post_sub = kernel.gather_pages(store.pool, sub_pids, hot_out[2][sub],
                                   hot_out[3][sub], hot_out[4][sub])
    after_burst = clone_state(store.pool)
    want_back = kernel.rollback_pages_keep(store.pool, sub_pids, pre_sub)
    kernel.rollback_pages(store.pool, sub_pids, pre_sub)
    assert_trees_equal(store.pool, want_back, "phase 12 rollback_pages")
    back = kernel.gather_pages(store.pool, sub_pids, pre_sub.count,
                               pre_sub.min_seq, pre_sub.seq)
    assert_trees_equal(back, pre_sub, "phase 12 rolled-back rows")
    kernel.rollback_pages(store.pool, sub_pids, post_sub)
    assert_trees_equal(store.pool, after_burst, "phase 12 rollback round "
                       "trip")
    del after_burst, want_back
    for g, out in zip(groups, outs):
        serving.adopt_paged_group(store, g, out[2].cpu().numpy(),
                                  out[3].cpu().numpy(), out[4].cpu().numpy())

    # compact_pages over the hot group (its min_seq trails the removes)
    keys = hb.keys
    width = pow2_pages(max(len(store.tables[k]) for k in keys))
    cargs = [torch.from_numpy(x).to(dev) for x in
             (store.page_ids_array(keys, width),
              *store.scalars_arrays(keys))]
    want_c = kernel.compact_pages_keep(store.pool, *cargs)
    got_c = kernel.compact_pages(store.pool, *cargs)
    assert_trees_equal(got_c, want_c, "phase 12 compact_pages")
    before = int(cargs[1].sum())
    after = int(got_c[2].sum())
    require(after < before, "phase 12 compact_pages freed no row")
    pages = store.pages_in_use
    _counts, mins, seqs = store.scalars_arrays(keys)
    store.adopt_scalars(keys, got_c[2].cpu().numpy(), mins, seqs)
    store.release_trailing_many(keys)
    print(f"phase 12: rollback_pages round trip on 2 hot lanes exact; "
          f"compact_pages over the hot group: {before} -> {after} rows, "
          f"pages in use {pages} -> {store.pages_in_use}, fill "
          f"{store.page_fill_frac():.3f}; equal to compact_pages_keep",
          flush=True)

    # the scan kernel's rows at the new paths' inputs
    _ts, ticketed = tk.scan_tickets(
        ts0, tk.RawOps(client=args.ticket_xs[0, 1],
                       client_seq=args.ticket_xs[0, 2],
                       ref_seq=args.ticket_xs[0, 3],
                       kind=args.ticket_xs[0, 0]), require_join=True)
    ops0, runs0, _over = serve_step.admit_merge_ops(
        ticketed.seq, ticketed.min_seq, args.merge_xs[hot_g][0],
        None if args.runs_xs[hot_g] is None else args.runs_xs[hot_g][0])
    rows = scan_rows("phase 12 ring hot group, window 0", ring_view, ops0,
                     runs0, ring_scan, 3,
                     f"{ring_view.length.shape[0]} x C={caps[hot_g]} x Tm "
                     f"{ops0.steps}", card)
    chunk0 = PackedOps(*(col[0] for col in bops))
    rows += scan_rows("phase 12 burst, chunk 0", hot_out[7], chunk0, None,
                      backlog_scan, 3,
                      f"{hb.page_ids.shape[0]} x C="
                      f"{hb.page_ids.shape[1] * store.page_rows} x T "
                      f"{chunk0.steps}", card)
    return rows


def scalar_phase(dev, card: str, catchup_entries) -> None:
    """Phase 13, scalar against device catch-up: keystroke_trace(100,000,
    seed=12) replayed op by op through the port's MergeTreeClient.apply_msg
    on the host (the whole trace, or the prefix reached within
    SCALAR_BUDGET_S), its text equal to the device catch-up's (phase 11's
    for the whole trace); the scalar cost per op fitted against the live
    segments (least squares over blocks of SCALAR_BLOCK ops), the device
    wall fitted to the cost model's formula on prefixes of the same trace,
    and where mergetree/costmodel.device_bulk_wins puts the crossover, by
    the fit and by the committed constants."""
    from fluidframework_tpu_torch.mergetree import catchup, costmodel
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    n_ops, seed, n_clients = golden.load_catchup()["full"]["trace"]
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    client = MergeTreeClient(client_id=99, device=dev)
    points, done = [], 0
    t0 = time.perf_counter()
    while done < n_ops and time.perf_counter() - t0 < SCALAR_BUDGET_S:
        block = tail[done:done + SCALAR_BLOCK]
        segs0 = len(client.tree.segments)
        b0 = time.perf_counter()
        for op, sq, ref, cl, msn in block:
            client.apply_msg(op, sq, ref, cl, min_seq=msn)
        dt = time.perf_counter() - b0
        points.append(((segs0 + len(client.tree.segments)) / 2,
                       dt / len(block)))
        done += len(block)
    scalar_s = time.perf_counter() - t0
    if done == n_ops:
        want_text = golden.entries_text(catchup_entries)
        device_s = None
    else:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        entries = catchup.device_apply_tail([], tail[:done], 0, 0,
                                            device=dev)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - h0
        want_text = golden.entries_text(entries)
    require(client.get_text() == want_text,
            f"phase 13: the scalar replay of {done} ops differs from the "
            "device catch-up's text")
    segs = np.asarray([p[0] for p in points])
    per_op = np.asarray([p[1] for p in points])
    base, per_seg = np.linalg.lstsq(
        np.stack([np.ones_like(segs), segs], 1), per_op, rcond=None)[0]
    how = "least squares"
    if base < 0:   # keep the model's scalar cost positive at 0 segments
        base, per_seg = 0.0, float((segs @ per_op) / (segs @ segs))
        how = "least squares through the origin (the free fit's base < 0)"
    print(f"phase 13: scalar replay of {done} of {n_ops} ops "
          f"(keystroke_trace seed {seed}) through MergeTreeClient.apply_msg:"
          f" {scalar_s * 1e3:.1f} ms ({done / scalar_s:.0f} ops/s), text "
          f"equal to the device catch-up's; live segments "
          f"{int(segs[0])} -> {len(client.tree.segments)}; (live segments,"
          f" us per op) by block of {SCALAR_BLOCK} ops "
          f"{[(int(x), round(y * 1e6, 1)) for x, y in points]}",
          flush=True)

    # the device side: the catch-up's wall on prefixes of the same trace
    catchup.device_apply_tail([], tail[:DEVICE_PREFIXES[0]], 0, 0,
                              device=dev)
    walls = []
    for n in DEVICE_PREFIXES + (n_ops,):
        runs = []
        for _ in range(1 if n == n_ops else 3):
            stats = {}
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            catchup.device_apply_tail([], tail[:n], 0, 0, device=dev,
                                      stats=stats)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - h0)
        walls.append((n, float(np.median(runs)),
                      sum(stats["chunks"].values())))
    chunk_t = catchup.CHUNK_T
    a = np.asarray([[-(-n // chunk_t), n] for n, _w, _c in walls], float)
    w = np.asarray([wall for _n, wall, _c in walls])
    # relative least squares: every prefix weighs alike
    chunk_s, op_s = np.linalg.lstsq(a / w[:, None], np.ones_like(w),
                                    rcond=None)[0]
    if chunk_s < 0:   # keep the floor per chunk non-negative
        chunk_s, op_s = 0.0, float(np.mean(w / a[:, 1]))
    print(f"phase 13: device catch-up wall by prefix (ops, ms, chunks "
          f"applied): {[(n, round(x * 1e3, 3), c) for n, x, c in walls]}; "
          f"fit wall = ceil(ops / {chunk_t}) x {chunk_s * 1e3:.4f} ms + ops "
          f"x {op_s * 1e6:.4f} us (fitted walls "
          f"{[round(float(v) * 1e3, 3) for v in a @ [chunk_s, op_s]]} ms);"
          f" card {card}", flush=True)
    print(f"phase 13: costmodel fit (chip_smoke.py phase 13, this run): "
          f"SCALAR_BASE_S = {base:.4g}, SCALAR_PER_SEG_S = {per_seg:.4g} "
          f"({how}), DEVICE_CHUNK_S = {chunk_s:.4g}, DEVICE_PER_OP_S = "
          f"{op_s:.4g}; committed: SCALAR_BASE_S = "
          f"{costmodel.SCALAR_BASE_S:.4g}, SCALAR_PER_SEG_S = "
          f"{costmodel.SCALAR_PER_SEG_S:.4g}, DEVICE_CHUNK_S = "
          f"{costmodel.DEVICE_CHUNK_S:.4g}, DEVICE_PER_OP_S = "
          f"{costmodel.DEVICE_PER_OP_S:.4g}", flush=True)
    if device_s is not None:
        print(f"phase 13: at the same {done}-op prefix the device catch-up "
              f"took {device_s * 1e3:.1f} ms against the scalar replay's "
              f"{scalar_s * 1e3:.1f} ms", flush=True)

    def wins(n, live, consts):
        sb, ss, dc, do = consts
        dev_s = -(-n // chunk_t) * dc + n * do
        return n * (sb + ss * live) > dev_s * costmodel.HYSTERESIS

    fitted = (base, per_seg, chunk_s, op_s)
    committed = (costmodel.SCALAR_BASE_S, costmodel.SCALAR_PER_SEG_S,
                 costmodel.DEVICE_CHUNK_S, costmodel.DEVICE_PER_OP_S)
    for name, consts in (("fit", fitted), ("committed", committed)):
        cross = {}
        for live in CROSSOVER_SEGMENTS:
            n = 1
            while n <= 2**20 and not wins(n, live, consts):
                n *= 2
            cross[live] = n if n <= 2**20 else None
        print(f"phase 13: crossover by the {name} constants (smallest "
              f"power-of-two tail that routes to the device, by live "
              f"segments; None = never up to 2^20 ops): {cross}",
              flush=True)
    if os.environ.get("FLUID_TPU_FORCE_BULK") is None:
        for live in CROSSOVER_SEGMENTS:
            for n in (64, 4096, 2**20):
                require(costmodel.device_bulk_wins(n, live, backend="cuda")
                        == wins(n, live, committed),
                        "phase 13: device_bulk_wins differs from its "
                        "formula")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
