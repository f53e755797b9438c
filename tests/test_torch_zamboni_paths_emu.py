"""Every path of zamboni.cu (fluidframework_tpu_torch/kernels/csrc/
zamboni.cu: a warp a document, a block a document, a thread-block cluster
of 2, 4 or 8 blocks a document) in all three modes, run on the CPU under
the SIMT emulator (tests/simt/simt_emu.h) against the JAX package's
functions, bit for bit; and the rule that picks a path
(mergetree/kernel.zamboni_geometry) as a pure function.

Each path is forced through kernel._zamboni_launch with stats=True: the
compact mode against JAX's compact_batched, the fused mode against
compact_extract_batched(stats=True), the extract mode against
extract_visible_batched, and every mode's pre-compaction counts against
the input's counts as JAX's stats plane gives them. Inputs: seeded numpy
tables (tests/test_torch_extract.py's fuzz_state, whose every fourth
document holds stale rows past its count) at B in {1, 3, 5, 9}, C in {8,
64, 300, 1,100, 4,096} (one strip to 128 strips, widths that are not a
multiple of 32), K = 3, A in {1, 4} (A = 4 moves the anno span in 16-byte
units); spans longer than a lane's batch (K = 5 and 8, A = 8 and 5) or
empty (A = 0) at C = 301; the edge tables of
tests/test_torch_zamboni_emu.py and a batch of zero documents on every
path. Tolerance: exact equality (every field is int32). The emulator
resumes every thread once a round, so a missing __syncthreads or cluster
barrier does not show here: those were read by hand. Only the card
(chip_smoke.py phase 14) shows that nvcc builds the kernels and what each
path costs.
"""

import ctypes

import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel as jkernel

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.state import DocState, make_state

from test_torch_extract import fuzz_state
from test_torch_paged_ops import (assert_tree_equal, jax_state, port_state,
                                  to_np)
from test_torch_zamboni_emu import (INVALID_VALUE, build_emulated,
                                    edge_arrays, use_emulated)

# (label, path, forced geometry's arguments): the warp path at two
# documents a block (odd batches leave a block half used), the block
# path, and clusters of 2, 4 and 8 ranks at the rule's threads.
PATHS = (("warp", "warp", {"docs_per_block": 2}),
         ("block", "block", {}),
         ("cluster2", "cluster", {"ranks": 2}),
         ("cluster4", "cluster", {"ranks": 4}),
         ("cluster8", "cluster", {"ranks": 8}))
BATCHES = (1, 3, 5, 9)
CAPACITIES = (8, 64, 300, 1100, 4096)
ANNO = (1, 4)
K_SLOTS = 3


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("zamboni_paths_emu"))


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    use_emulated(monkeypatch, emu_lib)
    return emu_lib


_CASES = {}


def fuzz_case(b: int, c: int, a: int):
    """(arrays, JAX's outputs) at one shape, made once per module."""
    key = (b, c, a)
    if key not in _CASES:
        arrays = fuzz_state(b * 100 + c + a, b, c, K_SLOTS, a)
        _CASES[key] = (arrays, jax_outputs(arrays))
    return _CASES[key]


def jax_outputs(arrays) -> dict:
    """The JAX package's three functions on the state, as numpy trees."""
    js = jax_state(arrays)
    return {"compact": to_np(jkernel.compact_batched(js)),
            "compact_extract": to_np(jkernel.compact_extract_batched(
                js, stats=True)),
            "extract": to_np(jkernel.extract_visible_batched(js))}


def check_path(arrays, want: dict, path: str, kwargs: dict,
               what: str) -> None:
    """The three modes with stats=True on one forced path against JAX,
    each one launch on that path; the input is not written."""
    b, c = arrays["length"].shape
    geo = tkernel._forced_zamboni_geometry(path, c, **kwargs)
    counts = want["compact_extract"][2]
    for mode in tkernel.ZAMBONI_MODES:
        state = port_state(arrays)
        copies = [x.clone() for x in state]
        before = dict(tkernel.zamboni.path_launches)
        comp, packed, pre = tkernel._zamboni_launch(state, mode, True, geo)
        for x, x0 in zip(state, copies):
            assert torch.equal(x, x0), \
                f"{what} {mode}: the kernel wrote its input"
        launched = {p: n - before[p] for p, n in
                    tkernel.zamboni.path_launches.items() if n != before[p]}
        assert launched == ({path: 1} if b else {}), (what, mode, launched)
        if mode == "compact":
            got = (to_np(comp), to_np(pre))
            ref = (want["compact"], counts)
        elif mode == "compact_extract":
            got = to_np((comp, packed, pre))
            ref = want["compact_extract"]
        else:
            got = (to_np(packed), to_np(pre))
            ref = (want["extract"], counts)
        assert_tree_equal(got, ref, f"{what} {mode} on {geo}")


@pytest.mark.parametrize("a", ANNO)
@pytest.mark.parametrize("c", CAPACITIES)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("label,path,kwargs", PATHS,
                         ids=[p[0] for p in PATHS])
def test_path_matches_jax(emulated, label, path, kwargs, b, c, a):
    arrays, want = fuzz_case(b, c, a)
    check_path(arrays, want, path, kwargs, f"{label} B={b} C={c} A={a}")


@pytest.mark.parametrize("k,a", [(5, 8), (8, 5), (1, 0)])
@pytest.mark.parametrize("label,path,kwargs", PATHS,
                         ids=[p[0] for p in PATHS])
def test_path_wide_slots_match_jax(emulated, label, path, kwargs, k, a):
    """Spans longer than one batch a lane (K = 5 or 8 ints, A = 8 in two
    16-byte units, A = 5 in ints) and no anno slot at all, at C = 301
    (documents whose planes start and end off 16-byte boundaries: the
    padding's scalar heads and tails)."""
    arrays = fuzz_state(k * 10 + a, 5, 301, k, max(a, 1))
    arrays["anno"] = np.ascontiguousarray(arrays["anno"][..., :a])
    check_path(arrays, jax_outputs(arrays), path, kwargs,
               f"{label} B=5 C=301 K={k} A={a}")


@pytest.mark.parametrize("label,path,kwargs", PATHS,
                         ids=[p[0] for p in PATHS])
def test_path_edge_tables_match_jax(emulated, label, path, kwargs):
    """count 0, count = C, every row removed, the remove sentinels beside
    real removes, a count past C; at A = 4 (16-byte anno units)."""
    for a in ANNO:
        arrays = edge_arrays(c=40, a=a)
        check_path(arrays, jax_outputs(arrays), path, kwargs,
                   f"{label} edges A={a}")


@pytest.mark.parametrize("label,path,kwargs", PATHS,
                         ids=[p[0] for p in PATHS])
def test_path_zero_documents(emulated, label, path, kwargs):
    """B = 0 launches nothing on any path and gives JAX's empty outputs."""
    arrays = interop.to_numpy(make_state(16, 2, batch=0, device="cpu"))
    check_path(arrays, jax_outputs(arrays), path, kwargs, f"{label} B=0")


# The rule at the shapes it was measured at (PERF.md §6): the north-star
# state, the lane store's first bucket, the capacity soak's lane-store
# buckets, the paged hot view, one catch-up fold, and the shapes on each
# side of its thresholds.
WARP = ("warp", 1, 32 * tkernel.ZAMBONI_WARP_DOCS, tkernel.ZAMBONI_WARP_DOCS)
RULE_TABLE = (
    ((10_000, 256, 3, 1), WARP),
    ((16_384, 64, 3, 4), WARP),
    ((512, 256, 3, 4), WARP),          # 2^17 rows
    ((2_048, 64, 3, 4), WARP),
    ((10_000, 512, 3, 4), WARP),
    ((511, 256, 3, 4), ("block", 1, 256, 1)),
    ((512, 64, 3, 4), ("block", 1, 64, 1)),
    ((256, 64, 3, 4), ("block", 1, 64, 1)),
    ((64, 256, 3, 4), ("block", 1, 256, 1)),
    ((16, 1024, 3, 4), ("block", 1, 256, 1)),
    ((10_000, 1024, 3, 4), ("block", 1, 256, 1)),
    ((1, 2048, 3, 4), ("block", 1, 256, 1)),
    ((3, 8, 3, 1), ("block", 1, 32, 1)),
    ((61, 8192, 3, 4), ("cluster", 2, 512, 1)),
    ((61, 4096, 3, 4), ("cluster", 2, 512, 1)),
    ((1, 4096, 3, 1), ("cluster", 16, 256, 1)),
    ((16, 16384, 3, 4), ("cluster", 8, 256, 1)),
    ((33, 4096, 3, 4), ("cluster", 4, 256, 1)),
    ((67, 8192, 3, 4), ("block", 1, 256, 1)),   # no pair fits one wave
    ((132, 8192, 3, 4), ("block", 1, 256, 1)),
    ((0, 4096, 3, 1), ("cluster", 16, 256, 1)),
)


@pytest.mark.parametrize("shape,want", RULE_TABLE,
                         ids=[f"B{s[0]}xC{s[1]}" for s, _w in RULE_TABLE])
def test_geometry_rule(shape, want):
    geo = tkernel.zamboni_geometry(*shape)
    assert tuple(geo) == want
    assert tkernel.zamboni_geometry(*shape) == geo   # pure: same answer
    b, c = shape[:2]
    assert geo.ranks == tkernel.zamboni_cluster_ranks(b, c) \
        or geo.path != "cluster"
    if geo.path == "cluster":
        assert b * geo.ranks <= tkernel.SM_COUNT \
            and c >= geo.ranks * tkernel.ZAMBONI_RANK_MIN_ROWS


@pytest.mark.parametrize("args", [(-1, 64, 3, 1), (4, 0, 3, 1),
                                  (4, 64, 0, 1), (4, 64, 3, -1)])
def test_geometry_rule_refuses_bad_shapes(args):
    with pytest.raises(ValueError):
        tkernel.zamboni_geometry(*args)


@pytest.mark.parametrize("path,kwargs", [
    ("sweep", {}), ("warp", {"docs_per_block": 17}),
    ("warp", {"docs_per_block": 2, "threads": 96}), ("warp", {"ranks": 2}),
    ("block", {"threads": 128}), ("block", {"ranks": 2}),
    ("cluster", {"ranks": 1}), ("cluster", {"ranks": 17}),
    ("cluster", {"ranks": 2, "threads": 48}),
    ("cluster", {"ranks": 2, "threads": 1024}),
    ("cluster", {"ranks": 2, "docs_per_block": 2})])
def test_forced_geometry_refuses_what_the_kernel_does_not_take(path, kwargs):
    with pytest.raises(ValueError):
        tkernel._forced_zamboni_geometry(path, 300, **kwargs)


def test_entry_point_refuses_bad_geometries(emu_lib):
    """fluid_zamboni checks a geometry against its own formulas: each of
    these returns cudaErrorInvalidValue and writes nothing, while the
    geometries the Python side makes are taken."""
    arrays = fuzz_state(3, 2, 300, K_SLOTS, 4)
    state = port_state(arrays)
    out = tkernel.compact_batched_plain(state)
    ptrs = [getattr(state, f).data_ptr()
            for f in (*tkernel._ROW_FIELDS, "count", "min_seq")]
    zeros = [torch.zeros_like(getattr(out, f))
             for f in (*tkernel._ROW_FIELDS, "count")]
    ptrs += [z.data_ptr() for z in zeros] + [None] * 10
    arr = (ctypes.c_void_p * 33)(*ptrs)

    def launch(path, ranks, threads, dpb):
        return emu_lib.fluid_zamboni(arr, 0, 2, 300, K_SLOTS, 4, path, ranks,
                                     threads, dpb, None)
    for bad in [(0, 1, 96, 2), (0, 2, 64, 2), (0, 1, 17 * 32, 17),
                (1, 1, 128, 1), (1, 1, 320, 1), (1, 2, 256, 1),
                (2, 1, 256, 1), (2, 17, 256, 1), (2, 2, 48, 1),
                (2, 2, 1024, 1), (2, 2, 256, 2), (3, 1, 128, 1)]:
        assert launch(*bad) == INVALID_VALUE, bad
        assert all(not z.any() for z in zeros), bad
    for geo in (tkernel._forced_zamboni_geometry("warp", 300),
                tkernel._forced_zamboni_geometry("block", 300),
                tkernel._forced_zamboni_geometry("cluster", 300, ranks=4)):
        assert launch(tkernel.ZAMBONI_PATHS.index(geo.path), geo.ranks,
                      geo.threads, geo.docs_per_block) == 0, geo
        assert_tree_equal(to_np(tuple(zeros)), to_np(tuple(
            getattr(out, f) for f in (*tkernel._ROW_FIELDS, "count"))),
            f"compact on {geo}")
        for z in zeros:
            z.zero_()


def test_rule_paths_route_through_the_wrappers(emulated, monkeypatch):
    """The wrappers launch on the rule's path: the block path for a small
    fleet, the warp path once the fleet holds ZAMBONI_WARP_MIN_ROWS rows
    (lowered here to 256, so that the emulator runs it), a cluster for one
    wide document; counted per path and per (mode, path, B, C)."""
    tkernel.reset_zamboni_launches()
    small = port_state(fuzz_case(5, 64, 1)[0])
    wide = port_state(fuzz_case(1, 4096, 4)[0])
    tkernel.compact_batched(small)
    monkeypatch.setattr(tkernel, "ZAMBONI_WARP_MIN_ROWS", 256)
    tkernel.extract_visible_batched(small)
    tkernel.extract_visible_batched(wide)
    tkernel.compact_extract_batched(wide, stats=True)
    assert tkernel.zamboni.path_launches == {"warp": 1, "block": 1,
                                             "cluster": 2}
    assert tkernel.zamboni.shape_launches == {
        ("compact", "block", 5, 64): 1, ("extract", "warp", 5, 64): 1,
        ("extract", "cluster", 1, 4096): 1,
        ("compact_extract", "cluster", 1, 4096): 1}
    count = DocState._fields.index("count")
    assert np.array_equal(to_np(tkernel.compact_batched(wide).count),
                          fuzz_case(1, 4096, 4)[1]["compact"][count])
