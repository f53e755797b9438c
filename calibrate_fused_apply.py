"""Calibration of the fused apply's launch geometry on one NVIDIA GPU.

    python3 calibrate_fused_apply.py

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
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from chip_smoke import (A_SLOTS, K_SLOTS, SmokeFailure, card_line, fmt_ms,
                        long_table, one_kernel_ms)

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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"calibrate_fused_apply: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
