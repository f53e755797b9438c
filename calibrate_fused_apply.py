"""Calibration of the fused apply's and the scan apply's launch geometry on
one NVIDIA GPU.

    python3 calibrate_fused_apply.py          # the fused apply
    python3 calibrate_fused_apply.py --scan   # the scan apply


Times the kernel (torch.profiler device time, the median of three
interleaved rounds of 10 launches) on the block path and on the warp path
at 1, 2, 4 and 8 documents per block:
  - at the main paths' shapes: the north-star apply (10,000 docs x 100
    ops, C=256, K=3, A=1, its admitted op stream) and the serving ring's
    page groups (K=3, A=4; the ring's op mix on half-full tables, as its
    views are);
  - over a grid of B x C on empty and half-full tables with the ring's op
    mix (gen_run_traces, 16 steps, runs= and extract=True).
These are the tables behind mergetree/pallas_apply.launch_geometry
(WARP_MIN_DOCS, WARP_DOCS_PER_BLOCK); chip_smoke.py checks at the main
paths' shapes that the rule's path is the faster one. Prints one line per
cell, then one {"calibration": ...} JSON line. Exits nonzero when CUDA is
not available.

With --scan: the scan apply (mergetree/kernel.py over kernels/csrc/
scan_apply.cu). The kernel's device time (torch.profiler, the median of
two interleaved rounds of SCAN_REPS launches) on every path that holds
the table (smem and global at 128, 256 and 512 threads, each cluster
size), the outputs of all paths equal on every input:
  - at the main paths' scan inputs: the first chunk at each capacity of
    the 100,000-op keystroke catch-up, and full_step's 1,024 x 100
    admitted ops at C = 8,192 (chip_smoke.py phase 11);
  - over SCAN_GRID_DOCS x SCAN_GRID_CAPACITIES x SCAN_GRID_FILLS (K=3,
    A=4, tables filled to that share of C with one-char rows,
    SCAN_GRID_STEPS INSERT_RUN-mix steps of gen_run_traces).
These are the tables behind mergetree/kernel.scan_geometry; it prints one
{"scan_calibration": ...} line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from chip_smoke import (A_SLOTS, K_SLOTS, SCAN_STEP, SmokeFailure,
                        assert_trees_equal, card_line, fmt_ms, long_table,
                        one_kernel_ms, scan_kernel_name)

WARP_DOCS = (1, 2, 4, 8)
GRID_DOCS = (128, 256, 512, 768, 1024, 4096, 16384)
GRID_CAPACITIES = (32, 64, 128, 256, 512)
GRID_FILLS = (0.0, 0.5)   # rows in use on entry, as a share of C
ROUNDS, REPS = 3, 10
# (name, B, C, T, runs, extract) of the serving ring's page groups
# (testing/serving.py FULL_RING, rings 1 and 2; PERF.md §4).
RING_GROUPS = (("ring extract group", 16_384, 64, 4, False, True),
               ("ring runs+extract group", 1_024, 256, 16, True, True),
               ("ring 1 runs+extract group", 1_024, 128, 16, True, True),
               ("ring storm group", 128, 512, 16, True, True),
               ("ring 1 storm group", 256, 256, 16, True, True))
SCAN_GRID_DOCS = (1, 8, 132, 1024)
SCAN_GRID_CAPACITIES = (1024, 4096, 8192, 16384)
SCAN_GRID_FILLS = (0.02, 0.15, 0.35, 0.9)
SCAN_GRID_STEPS = 64
SCAN_REPS = 3
SCAN_THREADS = (128, 256, 512)   # global and smem
SCAN_CATCHUP = (100_000, 12)     # chip_smoke.py's catch-up: keystroke_trace


def geometries(capacity: int, k: int, a: int) -> dict:
    """{label: Geometry}: the block path and the warp path at each W."""
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    out = {"block": pa._forced_geometry("block", capacity, k, a)}
    for w in WARP_DOCS:
        geo = pa._warp_geometry(capacity, k, a, docs_per_block=w)
        if geo.docs_per_block == w:
            out[f"warp W={w}"] = geo
    return out


def time_geometries(state, ops, runs, extract: bool) -> dict:
    """{label: device ms per launch} over geometries(), interleaved rounds
    in alternating order, the median of ROUNDS."""
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    geos = geometries(state.capacity, state.overlap_slots, state.anno_slots)
    samples = {label: [] for label in geos}
    order = list(geos)
    for rnd in range(ROUNDS):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            geo = geos[label]
            ms = one_kernel_ms(
                lambda: pa._launch(state, ops, runs, extract, geo), REPS,
                f"fused_apply_kernel_{geo.path}")
            if ms is None:
                raise SmokeFailure(f"no device time for {label}")
            samples[label].append(ms)
    return {label: float(np.median(v)) for label, v in samples.items()}


def report(what: str, times: dict, rule: str) -> None:
    print(f"  {what}: " + ", ".join(f"{label} {fmt_ms(ms)}"
                                    for label, ms in times.items())
          + f"; the rule takes {rule}", flush=True)


def main() -> int:
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("calibrate_fused_apply: CUDA is not available", file=sys.stderr)
        return 2
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.kernels import build
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing.traces import (gen_run_traces,
                                                         gen_traces)
    if "--scan" in sys.argv[1:]:
        return scan_main(card)
    dev = torch.device("cuda")
    build.library()

    def rule(b, c, k, a):
        geo = pa.launch_geometry(b, c, k, a)
        return geo.path + (f" W={geo.docs_per_block}"
                           if geo.path == "warp" else "")

    shapes = []
    # the north-star apply on its admitted op stream
    docs, steps, cap = 10_000, 100, 256
    ops = interop.packed_ops_from_numpy(gen_traces(docs, steps, seed=0), dev)
    _ts, ticketed = tk.scan_tickets(
        tk.make_ticket_state(8, docs, device=dev),
        tk.RawOps(client=ops.client, client_seq=ops.seq,
                  ref_seq=ops.ref_seq))
    state = make_state(cap, 1, batch=docs, device=dev)
    times = time_geometries(state, pipeline.admit_ops(ops, ticketed), None,
                            False)
    report(f"north-star apply [{docs} x {cap}] x T {steps}", times,
           rule(docs, cap, 3, 1))
    shapes.append({"name": "north-star apply", "docs": docs,
                   "capacity": cap, "steps": steps, "times": times,
                   "rule": rule(docs, cap, 3, 1)})
    for name, b, c, steps, with_runs, extract in RING_GROUPS:
        if with_runs:
            cols, runs_np = gen_run_traces(b, steps, seed=b + c)
            runs = interop.run_cols_from_numpy(runs_np, dev)
        else:
            cols, runs = gen_traces(b, steps, seed=b + c), None
        state = long_table(dev, b, c, c // 2)
        times = time_geometries(state, interop.packed_ops_from_numpy(
            cols, dev), runs, extract)
        report(f"{name} [{b} x {c}] x T {steps}, half full", times,
               rule(b, c, K_SLOTS, A_SLOTS))
        shapes.append({"name": name, "docs": b, "capacity": c,
                       "steps": steps, "times": times,
                       "rule": rule(b, c, K_SLOTS, A_SLOTS)})

    grid = []
    for fill in GRID_FILLS:
        for c in GRID_CAPACITIES:
            for b in GRID_DOCS:
                cols, runs_np = gen_run_traces(b, 16, seed=c + b)
                state = long_table(dev, b, c, int(c * fill)) if fill else \
                    make_state(c, A_SLOTS, batch=b, device=dev)
                times = time_geometries(
                    state, interop.packed_ops_from_numpy(cols, dev),
                    interop.run_cols_from_numpy(runs_np, dev), True)
                report(f"grid fill {fill} B={b} C={c}", times,
                       rule(b, c, K_SLOTS, A_SLOTS))
                grid.append({"fill": fill, "docs": b, "capacity": c,
                             "times": times,
                             "rule": rule(b, c, K_SLOTS, A_SLOTS)})
                del state
    print(json.dumps({"calibration": {"shapes": shapes, "grid": grid,
                                      "card": card}}), flush=True)
    return 0


def scan_geometries(capacity: int, k: int, a: int) -> dict:
    """{label: ScanGeometry}: every live path that holds the table (smem
    and global at each of SCAN_THREADS, each cluster size)."""
    from fluidframework_tpu_torch.mergetree import kernel
    out = {}
    for thr in SCAN_THREADS:
        try:
            out[f"smem t={thr}"] = kernel._forced_geometry(
                "smem", capacity, k, a, threads=thr)
        except ValueError:
            break
    n = kernel.cluster_blocks(capacity, k, a)
    while n is not None and n <= kernel.MAX_CLUSTER:
        out[f"cluster n={n}"] = kernel._forced_geometry("cluster", capacity,
                                                        k, a, blocks=n)
        n *= 2
    for thr in SCAN_THREADS:
        out[f"global t={thr}"] = kernel._forced_geometry(
            "global", capacity, k, a, threads=thr)
    return out


def scan_label(geo) -> str:
    if geo.path == "cluster":
        return f"cluster n={geo.blocks}"
    return f"{geo.path} t={geo.threads}"


def time_scan(kernel, state, ops, runs, geos: dict, what: str) -> dict:
    """{label: device ms per launch} of every geometry on one input,
    interleaved rounds in alternating order, the median of two; every
    geometry's output equal to the first's."""
    outs = {label: kernel._launch(state, ops, runs, geo)
            for label, geo in geos.items()}
    first = next(iter(outs))
    for label, out in outs.items():
        assert_trees_equal(out, outs[first], f"{what}: {label} vs {first}")
    del outs
    samples = {label: [] for label in geos}
    order = list(geos)
    for rnd in range(2):
        for label in (order if rnd == 0 else order[::-1]):
            geo = geos[label]
            ms = one_kernel_ms(
                lambda: kernel._launch(state, ops, runs, geo), SCAN_REPS,
                scan_kernel_name(geo))
            if ms is None:
                raise SmokeFailure(f"no device time for {label} at {what}")
            samples[label].append(ms)
    return {label: float(np.median(v)) for label, v in samples.items()}


def scan_shapes(dev) -> list:
    """The main paths' scan inputs: the first chunk at each capacity of
    the 100,000-op keystroke catch-up (chip_smoke.py phase 11), and
    full_step's 1,024 documents x 100 admitted ops at C = 8,192."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import catchup, kernel
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing.traces import (gen_traces,
                                                         keystroke_trace)
    captured = {}
    apply_keep = kernel.apply_ops_keep

    def capture(state, ops, runs=None):
        captured.setdefault(state.capacity, (
            type(state)(*(t.clone() for t in state)), ops, runs))
        return apply_keep(state, ops, runs)

    kernel.apply_ops_keep = capture
    try:
        n, seed = SCAN_CATCHUP
        catchup.device_apply_tail([], keystroke_trace(n, seed=seed), 0, 0,
                                  device=dev)
    finally:
        kernel.apply_ops_keep = apply_keep
    shapes = [(f"catch-up chunk 1 x C={c} x T {ops.steps}",
               kernel._lift(st), kernel._lift(ops), kernel._lift(runs))
              for c, (st, ops, runs) in sorted(captured.items())]
    b, t, c = SCAN_STEP
    ops = interop.packed_ops_from_numpy(gen_traces(b, t, seed=3), dev)
    _ts, ticketed = tk.scan_tickets(
        tk.make_ticket_state(8, b, device=dev),
        tk.RawOps(client=ops.client, client_seq=ops.seq,
                  ref_seq=ops.ref_seq))
    shapes.append((f"full_step {b} x C={c} x T {t}",
                   make_state(c, 1, batch=b, device=dev),
                   pipeline.admit_ops(ops, ticketed), None))
    return shapes


def scan_main(card: str) -> int:
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.kernels import build
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.testing.traces import gen_run_traces
    dev = torch.device("cuda")
    build.library()

    shapes = []
    for what, state, ops, runs in scan_shapes(dev):
        b, c = state.length.shape
        k, a = state.overlap_slots, state.anno_slots
        times = time_scan(kernel, state, ops, runs,
                          scan_geometries(c, k, a), what)
        rule = scan_label(kernel.scan_geometry(b, c, k, a))
        report(what, times, rule)
        shapes.append({"name": what, "times": times, "rule": rule,
                       "best": min(times, key=times.get)})
        del state

    grid = []
    for c in SCAN_GRID_CAPACITIES:
        geos = scan_geometries(c, K_SLOTS, A_SLOTS)
        for b in SCAN_GRID_DOCS:
            cols, runs_np = gen_run_traces(b, SCAN_GRID_STEPS, seed=c + b)
            ops = interop.packed_ops_from_numpy(cols, dev)
            runs = interop.run_cols_from_numpy(runs_np, dev)
            for fill in SCAN_GRID_FILLS:
                state = long_table(dev, b, c, int(c * fill))
                what = f"scan grid B={b} C={c} fill {fill}"
                times = time_scan(kernel, state, ops, runs, geos, what)
                rule = scan_label(kernel.scan_geometry(b, c, K_SLOTS,
                                                       A_SLOTS))
                report(what, times, rule)
                grid.append({"docs": b, "capacity": c, "fill": fill,
                             "times": times, "rule": rule,
                             "best": min(times, key=times.get)})
                del state
    print(json.dumps({"scan_calibration": {"shapes": shapes, "grid": grid,
                                           "card": card,
                                           "steps": SCAN_GRID_STEPS}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"calibrate_fused_apply: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
