"""Calibration of the fused apply's and the scan apply's launch geometry on
one NVIDIA GPU.

    python3 calibrate_fused_apply.py                  # the fused apply
    python3 calibrate_fused_apply.py --scan           # the scan apply
    python3 calibrate_fused_apply.py --scan --paged   # at paged shapes
    python3 calibrate_fused_apply.py --zamboni        # zamboni's paths
    python3 calibrate_fused_apply.py --zamboni --rule-only [--package DIR]


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
scan_apply.cu). The kernel's device time (the least of SCAN_REPS single
launches between CUDA events, the median of two interleaved rounds; the
profiler's traces of this kernel were not reliable) on every path that
holds the table (smem and global at 128, 256 and 512 threads, each
cluster size), the outputs of all paths equal on every input:
  - at the main paths' scan inputs: the first chunk at each capacity of
    the 100,000-op keystroke catch-up, and full_step's 1,024 x 100
    admitted ops at C = 8,192 (chip_smoke.py phase 11);
  - over SCAN_GRID_DOCS x SCAN_GRID_CAPACITIES x SCAN_GRID_FILLS (K=3,
    A=4, tables filled to that share of C with one-char rows,
    SCAN_GRID_STEPS INSERT_RUN-mix steps of gen_run_traces).
These are the tables behind mergetree/kernel.scan_geometry; it prints one
{"scan_calibration": ...} line. With --scan --paged, only the grid at the
paged serving shapes: SCAN_PAGED_DOCS x SCAN_PAGED_CAPACITIES x
SCAN_PAGED_FILLS (chip_smoke.py phase 12's hot page groups are 64
documents at C = 4,096 and 8,192), with the same op mix and with plain
inserts and removes (gen_traces: the paged burst's and apply's ops).

With --zamboni: zamboni.cu (mergetree/kernel.py zamboni over kernels/csrc/
zamboni.cu). First the compiler's report of its nine kernels (no stack or
spill) and every path bit-exact to the plain versions, in all three modes
with stats, on fuzzed tables (testing/traces.fuzz_tables) at ZAMBONI_CHECK
shapes, an anno plane off its 16-byte alignment too. Then, by events over
a CUDA graph (chip_smoke.graph_ms: no host launch between the kernels),
every geometry of zamboni_geometries at the ZAMBONI_SHAPES (three modes)
and over ZAMBONI_GRID_DOCS x ZAMBONI_GRID_CAPACITIES (the compact mode) on
tables filled on the card (zamboni_table). These are the tables behind
mergetree/kernel.zamboni_geometry; it prints one {"zamboni_calibration":
...} line. --rule-only times the three modes through their wrappers at
the ZAMBONI_SHAPES alone, with only what every version of the port has,
so that `--package DIR` (a checkout of another version of the port, put
first on the import path) times that version's kernel in the same way;
it prints one {"zamboni_rule": ...} line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from chip_smoke import (A_SLOTS, K_SLOTS, SCAN_STEP, SmokeFailure,
                        assert_trees_equal, card_line, fmt_ms, graph_ms,
                        long_table, long_kernel_ms, ms_of, one_kernel_ms,
                        ptxas_report, zamboni_path_label)

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
SCAN_PAGED_DOCS = (16, 32, 64, 128)
SCAN_PAGED_CAPACITIES = (4096, 8192)
SCAN_PAGED_FILLS = (0.02, 0.15, 0.35, 0.6, 0.9)
SCAN_REPS = 3
SCAN_THREADS = (128, 256, 512)   # global and smem
SCAN_CATCHUP = (100_000, 12)     # chip_smoke.py's catch-up: keystroke_trace
# --zamboni: the check's fuzzed shapes (B, C, A); the shapes timed in all
# three modes (label, B, C, A, the share of C in use, the share of those
# rows removed at or before min_seq): chip_smoke.py phase 14's four (the
# north-star state, the lane store's first bucket, the paged hot view,
# the catch-up fold) and the capacity soak's lane-store buckets; the grid
# (the compact mode, half-full tables, a fifth of the rows freed; at most
# ZAMBONI_GRID_MAX_ROWS rows a cell); the geometries timed
# (zamboni_geometries: the warp path at W documents a block, the block
# path, clusters of n ranks at t threads a block where t is at most a
# rank's slots rounded up to 32, or the rule's threads); calls a graph
# holds.
ZAMBONI_CHECK = ((9, 300, 4), (5, 1100, 1), (3, 4096, 4), (1, 4096, 1),
                 (61, 8192, 4), (132, 64, 4))
ZAMBONI_SHAPES = (("NS-like", 10_000, 256, 1, 0.5, 0.2),
                  ("L-like", 16_384, 64, 4, 0.8, 0.2),
                  ("L-like, every other document empty", 16_384, 64, 4,
                   0.8, 0.2),
                  ("P-like", 61, 8_192, 4, 0.5, 0.2),
                  ("F-like", 1, 4_096, 1, 0.95, 0.05),
                  ("lane 256 x 64", 256, 64, 4, 0.8, 0.2),
                  ("lane 64 x 256", 64, 256, 4, 0.8, 0.2),
                  ("lane 16 x 1024", 16, 1_024, 4, 0.8, 0.2))
ZAMBONI_GRID_DOCS = (1, 4, 16, 61, 132, 512, 2_048, 10_000)
ZAMBONI_GRID_CAPACITIES = (64, 256, 1_024, 2_048, 4_096, 8_192, 16_384)
ZAMBONI_GRID_MAX_ROWS = 1 << 24
ZAMBONI_WARP_DOCS = (1, 2, 4, 8)
ZAMBONI_RANKS = (2, 4, 8, 16)
ZAMBONI_THREADS = (128, 256, 512)
ZAMBONI_REPS = 20


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
    if "--package" in sys.argv[1:]:   # another checkout's port, first
        sys.path.insert(0, sys.argv[sys.argv.index("--package") + 1])
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
    if "--zamboni" in sys.argv[1:]:
        return zamboni_main(card)
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
            ms, _how = long_kernel_ms(
                lambda: kernel._launch(state, ops, runs, geo), SCAN_REPS)
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
    from fluidframework_tpu_torch.testing.traces import (gen_run_traces,
                                                         gen_traces)
    dev = torch.device("cuda")
    build.library()

    paged = "--paged" in sys.argv[1:]
    shapes = []
    for what, state, ops, runs in ([] if paged else scan_shapes(dev)):
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
    for mix in ("runs", "plain") if paged else ("runs",):
        for c in SCAN_PAGED_CAPACITIES if paged else SCAN_GRID_CAPACITIES:
            geos = scan_geometries(c, K_SLOTS, A_SLOTS)
            for b in SCAN_PAGED_DOCS if paged else SCAN_GRID_DOCS:
                if mix == "runs":
                    cols, runs_np = gen_run_traces(b, SCAN_GRID_STEPS,
                                                   seed=c + b)
                    runs = interop.run_cols_from_numpy(runs_np, dev)
                else:
                    cols, runs = gen_traces(b, SCAN_GRID_STEPS,
                                            seed=c + b), None
                ops = interop.packed_ops_from_numpy(cols, dev)
                for fill in SCAN_PAGED_FILLS if paged else SCAN_GRID_FILLS:
                    state = long_table(dev, b, c, int(c * fill))
                    what = f"scan grid {mix} B={b} C={c} fill {fill}"
                    times = time_scan(kernel, state, ops, runs, geos, what)
                    rule = scan_label(kernel.scan_geometry(b, c, K_SLOTS,
                                                           A_SLOTS))
                    report(what, times, rule)
                    grid.append({"mix": mix, "docs": b, "capacity": c,
                                 "fill": fill, "times": times, "rule": rule,
                                 "best": min(times, key=times.get)})
                    del state
    print(json.dumps({"scan_calibration": {"shapes": shapes, "grid": grid,
                                           "card": card,
                                           "steps": SCAN_GRID_STEPS}}),
          flush=True)
    return 0


def zamboni_geometries(capacity: int) -> dict:
    """{label: ZamboniGeometry} of the geometries timed at capacity C: the
    warp path at each of ZAMBONI_WARP_DOCS, the block path, and each
    cluster of ZAMBONI_RANKS whose ranks hold a strip, at each of
    ZAMBONI_THREADS up to its slots and at the rule's threads."""
    from fluidframework_tpu_torch.mergetree import kernel
    geos = [kernel._forced_zamboni_geometry("warp", capacity,
                                            docs_per_block=w)
            for w in ZAMBONI_WARP_DOCS]
    geos.append(kernel._forced_zamboni_geometry("block", capacity))
    for n in ZAMBONI_RANKS:
        if capacity < 32 * n:
            break
        rule = kernel._forced_zamboni_geometry("cluster", capacity, ranks=n)
        rows = -(-capacity // n // 32) * 32
        geos += [kernel._forced_zamboni_geometry("cluster", capacity,
                                                 ranks=n, threads=t)
                 for t in sorted({rule.threads, *(t for t in ZAMBONI_THREADS
                                                  if t <= rows)})]
    return {zamboni_path_label(g): g for g in geos}


def zamboni_table(dev, b: int, c: int, a: int, fill: float, freed: float,
                  seed: int, half_empty: bool = False):
    """A [B, C] state filled on the card: round(fill C) rows a document of
    1-4 chars at seqs 0-8, a `freed` share of them removed at seqs 1-4
    (under min_seq 4, with an overlap client), the rest never removed,
    every anno slot set; K = K_SLOTS. half_empty: every other document's
    count is 0 (its rows stay, as stale rows past the count)."""
    from fluidframework_tpu_torch.mergetree.constants import DEV_NO_REMOVE
    from fluidframework_tpu_torch.mergetree.state import make_state
    st = make_state(c, a, K_SLOTS, batch=b, device=dev)
    rows = min(c, round(c * fill))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(lo, hi, *shape):
        return torch.randint(lo, hi, (b, rows, *shape), generator=gen,
                             device=dev, dtype=torch.int32)
    gone = torch.rand((b, rows), generator=gen, device=dev) < freed
    st.length[:, :rows] = rnd(1, 5)
    st.ins_seq[:, :rows] = rnd(0, 9)
    st.ins_client[:, :rows] = rnd(0, 4)
    st.origin_op[:, :rows] = torch.arange(rows, dtype=torch.int32,
                                          device=dev)
    st.origin_off[:, :rows] = rnd(0, 4)
    st.rem_seq[:, :rows] = torch.where(gone, rnd(1, 5), DEV_NO_REMOVE)
    st.rem_clients[:, :rows, 0] = torch.where(gone, rnd(0, 4), -1)
    st.anno[:, :rows] = rnd(0, 1000, a)
    st.count.fill_(rows)
    if half_empty:   # as the lane store's buckets and fuzz_tables hold
        st.count[::2] = 0
    st.min_seq.fill_(4)
    return st


def zamboni_modes(kernel) -> dict:
    """{mode: the wrapper's call} with what every version of the port has."""
    return {"compact": kernel.compact_batched,
            "compact_extract": lambda s: kernel.compact_extract_batched(
                s, stats=True),
            "extract": kernel.extract_visible_batched}


def to_cpu(tree):
    """A (nested) tuple or NamedTuple of tensors, copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(x) for x in tree))
    return tuple(to_cpu(x) for x in tree)


def zamboni_check(dev) -> None:
    """The ptxas report of zamboni.cu's kernels (no stack or spill), then
    every geometry of every mode (stats=True) against the plain versions
    on CPU copies of fuzzed tables, an anno plane off its 16-byte
    alignment too (the anno span's int path at A = 4)."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.kernels import build
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.testing.traces import fuzz_tables
    log = build.BUILD_ROOT / build.source_hash() / "ptxas.log"
    report = {k: r for k, r in ptxas_report(log.read_text()).items()
              if k.startswith("zamboni_kernel_")}
    for k, r in sorted(report.items()):
        print(f"  ptxas: {k}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spill stores / loads",
              flush=True)
    bad = [k for k, r in report.items()
           if r.get("stack") or r.get("spill_stores") or r.get("spill_loads")]
    if len(report) != 9 or bad:
        raise SmokeFailure(f"zamboni.cu: {len(report)} kernels, stack or "
                           f"spill in {bad}")
    plains = {"compact": kernel.compact_batched_plain,
              "compact_extract":
                  lambda s: kernel.compact_extract_batched_plain(s, True),
              "extract": kernel.extract_visible_batched_plain}
    pick = {"compact": lambda o: o[0], "compact_extract": lambda o: o,
            "extract": lambda o: o[1]}
    checked = 0
    for b, c, a in ZAMBONI_CHECK:
        tab = fuzz_tables(b, c, K_SLOTS, a, seed=b + c + a, free=c // 4)
        tab["min_seq"] = np.random.default_rng(b + c).integers(
            0, 9, b).astype(np.int32)
        states = {"aligned": interop.doc_state_from_numpy(tab, dev)}
        if a % 4 == 0:
            st = states["aligned"]
            buf = torch.empty(st.anno.numel() + 1, dtype=torch.int32,
                              device=dev)
            off = buf[1:].view(st.anno.shape)
            off.copy_(st.anno)
            states["anno off 16-byte alignment"] = st._replace(anno=off)
        aligned = states["aligned"]
        cpu_state = type(aligned)(*(x.cpu() for x in aligned))
        want = {m: f(cpu_state) for m, f in plains.items()}
        for what, st in states.items():
            for label, geo in zamboni_geometries(c).items():
                for mode in kernel.ZAMBONI_MODES:
                    out = kernel._zamboni_launch(st, mode, True, geo)
                    name = f"zamboni {mode} B={b} C={c} A={a} {what} {label}"
                    assert_trees_equal(to_cpu(pick[mode](out)), want[mode],
                                       name)
                    assert_trees_equal(out[2].cpu(), cpu_state.count,
                                       f"{name}: pre-compaction counts")
                    checked += 1
    torch.cuda.synchronize()
    print(f"zamboni check: {checked} launches over {len(ZAMBONI_CHECK)} "
          "shapes, every path and mode bit-exact to the plain versions",
          flush=True)


def zamboni_reps(state) -> int:
    """ZAMBONI_REPS calls a graph, fewer where the outputs of that many
    calls would pass 4 GB."""
    out_bytes = sum(x.numel() for x in state) * 4 * 2
    return max(3, min(ZAMBONI_REPS, int(4e9 // max(out_bytes, 1))))


def zamboni_rule_times(dev, kernel) -> list:
    """The three modes through their wrappers at the ZAMBONI_SHAPES: events
    over a CUDA graph, and back to back (chip_smoke.ms_of)."""
    out = []
    for i, (label, b, c, a, fill, freed) in enumerate(ZAMBONI_SHAPES):
        st = zamboni_table(dev, b, c, a, fill, freed, seed=i,
                           half_empty="empty" in label)
        reps = zamboni_reps(st)
        times = {}
        for mode, fn in zamboni_modes(kernel).items():
            times[mode] = {"graph_ms": graph_ms(lambda: fn(st), reps),
                           "b2b_ms": ms_of(lambda: fn(st), 10)}
        print(f"  zamboni rule {label} [{b} x C {c}], A {a}: " + ", ".join(
            f"{m} {t['graph_ms']:.4f} ms graph events / {t['b2b_ms']:.4f} "
            f"back to back" for m, t in times.items()), flush=True)
        out.append({"name": label, "docs": b, "capacity": c, "anno": a,
                    "times": times})
        del st
    return out


def zamboni_main(card: str) -> int:
    from fluidframework_tpu_torch.kernels import build
    from fluidframework_tpu_torch.mergetree import kernel
    dev = torch.device("cuda")
    build.library()
    if "--rule-only" in sys.argv[1:]:
        print(json.dumps({"zamboni_rule": {
            "package": kernel.__file__, "card": card,
            "shapes": zamboni_rule_times(dev, kernel)}}), flush=True)
        return 0
    zamboni_check(dev)
    shapes = []
    for i, (label, b, c, a, fill, freed) in enumerate(ZAMBONI_SHAPES):
        st = zamboni_table(dev, b, c, a, fill, freed, seed=i,
                           half_empty="empty" in label)
        reps = zamboni_reps(st)
        rule = zamboni_path_label(kernel.zamboni_geometry(b, c, K_SLOTS, a))
        for mode in kernel.ZAMBONI_MODES:
            times = {lb: graph_ms(lambda geo=geo: kernel._zamboni_launch(
                st, mode, mode == "compact_extract", geo), reps)
                for lb, geo in zamboni_geometries(c).items()}
            report(f"zamboni {mode} {label} [{b} x C {c}], A {a}", times,
                   rule)
            shapes.append({"name": label, "mode": mode, "docs": b,
                           "capacity": c, "anno": a, "times": times,
                           "rule": rule, "best": min(times, key=times.get)})
        del st
    grid = []
    for c in ZAMBONI_GRID_CAPACITIES:
        geos = zamboni_geometries(c)
        for b in ZAMBONI_GRID_DOCS:
            if b * c > ZAMBONI_GRID_MAX_ROWS:
                continue
            st = zamboni_table(dev, b, c, A_SLOTS, 0.5, 0.2, seed=b + c)
            reps = zamboni_reps(st)
            times = {lb: graph_ms(lambda geo=geo: kernel._zamboni_launch(
                st, "compact", False, geo), reps) for lb, geo in geos.items()}
            rule = zamboni_path_label(kernel.zamboni_geometry(b, c, K_SLOTS,
                                                         A_SLOTS))
            report(f"zamboni grid compact B={b} C={c}", times, rule)
            grid.append({"docs": b, "capacity": c, "times": times,
                         "rule": rule, "best": min(times, key=times.get)})
            del st
    print(json.dumps({"zamboni_calibration": {
        "shapes": shapes, "grid": grid, "card": card,
        "rule_shapes": zamboni_rule_times(dev, kernel)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"calibrate_fused_apply: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
