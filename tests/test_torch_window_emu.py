"""The CUDA sources of the serving window's merge admission and flat16 pack
(fluidframework_tpu_torch/kernels/csrc/window_admit.cu, window_pack.cu),
with the LWW lane scan's admit mode (lww_scan.cu), run on the CPU under
tests/simt/simt_emu.h against the JAX package's _serve_window_impl, bit for
bit.

The emulated library stands in for the card's behind the port's own
wrappers (serve_step.admit_merge_ops, serve_step._pack_window,
lww_kernel.apply_lww_window route CPU tensors to their launches here), and
the port's serving entry points run SMALL_RING rings from testing/serving
(INSERT_RUN slots, a mispredicted run, nacks, duplicates, LWW lanes):
the paged megakernel (paged_scalars on) with stats on and off, and the
bucketed serve_window and serve_burst (paged_scalars off; the burst with
noop_skip). Every output (the flat16 planes, the states, the msn planes)
equals JAX's. The admission is also held, column by column, to the plain
version on windows with negative and out-of-range ticket indices (the
kernel follows JAX's gather rule there: count from the end, clamp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree.state import DocState as JaxDocState
from fluidframework_tpu.server import lww_kernel as jlk
from fluidframework_tpu.server import serve_step as jss
from fluidframework_tpu.server import ticket_kernel as jtk

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.server import lww_kernel as lk
from fluidframework_tpu_torch.server import serve_step as tss

from test_torch_lww_emu import build_emulated, use_emulated
from test_torch_serving import (_NAMES, Fleet, _jax_tree, assert_tree_equal,
                                jax_megakernel, port_megakernel, to_np)

SOURCES = ["lww_scan.cu", "window_admit.cu", "window_pack.cu"]


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("window_emu"), SOURCES)


class Counted:
    """A stand-in wrapper that sends every call to a launch and carries
    the wrapper's launch count."""

    def __init__(self, launch):
        self.launch, self.launches = launch, 0

    def __call__(self, *args):
        return self.launch(*args)


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """The window's three kernels on the emulator, whatever the device:
    returns {kernel: wrapper} whose counts the launches raise."""
    use_emulated(monkeypatch, emu_lib, lk, tss)
    admit = Counted(tss._admit_launch)
    pack = Counted(tss._pack_launch)
    window = Counted(lambda s, c, q: lk._launch(s, None, c, q))
    monkeypatch.setattr(tss, "admit_merge_ops", admit)
    monkeypatch.setattr(tss, "_pack_window", pack)
    monkeypatch.setattr(lk, "apply_lww_window", window)
    monkeypatch.setattr(lk.apply_lww_batched, "launches", 0)
    return {"window_admit": admit, "window_pack": pack,
            "lww_scan": lk.apply_lww_batched}


@pytest.mark.parametrize("stats", [True, False])
def test_emulated_megakernel_ring_matches_jax(emulated, stats):
    """A ring of K = 2 windows (paged_scalars on), twice: from empty
    documents, then from the first ring's state."""
    f = Fleet(0)
    expect = {"window_pack": 0, "window_admit": 0, "lww_scan": 0}
    for _ in range(2):
        ring = f.stage()
        want = jax_megakernel(f.tstate, f.pool, f.lww, ring.args,
                              stats=stats)
        got = port_megakernel(f.tstate, f.pool, f.lww, ring.args,
                              stats=stats)
        for name, g, w in zip(_NAMES, got, want):
            assert_tree_equal(g, w, f"{name} (stats={stats})")
        f.advance(ring, want)
        k = ring.args.ticket_xs.shape[0]
        expect["window_pack"] += k
        expect["window_admit"] += k * len(ring.args.merge_xs)
        expect["lww_scan"] += k * len(ring.args.lww_xs)
    assert {name: w.launches for name, w in emulated.items()} == expect


def test_emulated_bucketed_window_and_burst_match_jax(emulated):
    """serve_window (stats on) and serve_burst (noop_skip, stats on) over
    the gathered views as capacity buckets: paged_scalars off."""
    f = Fleet(4)
    ring = f.stage()
    views = jax_megakernel(f.tstate, f.pool, f.lww, ring.args)[5]
    a = ring.args

    def jax_states():
        return (_jax_tree(f.tstate, jtk.TicketState),
                [_jax_tree(v, JaxDocState) for v in views],
                [_jax_tree(s, jlk.LwwState) for s in f.lww])

    def port_states():
        return (interop.ticket_state_from_numpy(f.tstate._asdict(), "cpu"),
                [interop.doc_state_from_numpy(v._asdict(), "cpu")
                 for v in views],
                [interop.lww_state_from_numpy(s._asdict(), "cpu")
                 for s in f.lww])

    t_args = interop.ring_args_from_numpy(a, "cpu")
    j_ts, j_views, j_lww = jax_states()
    want = to_np(jss.serve_window_keep(
        j_ts, jnp.asarray(a.ticket_xs[0]), j_views,
        [jnp.asarray(m[0]) for m in a.merge_xs], j_lww,
        [jnp.asarray(x[0]) for x in a.lww_xs], False,
        [None if r is None else jnp.asarray(r[0]) for r in a.runs_xs],
        True))
    t_ts, t_views, t_lww = port_states()
    got = to_np(tss.serve_window(
        t_ts, t_args.ticket_xs[0], t_views,
        [m[0] for m in t_args.merge_xs], t_lww,
        [x[0] for x in t_args.lww_xs],
        [None if r is None else r[0] for r in t_args.runs_xs], stats=True))
    assert_tree_equal(got, want, "serve_window")
    j_ts, j_views, j_lww = jax_states()
    want = to_np(jss.serve_burst(
        j_ts, j_views, j_lww, jnp.asarray(a.ticket_xs),
        [jnp.asarray(m) for m in a.merge_xs],
        [jnp.asarray(x) for x in a.lww_xs],
        [None if r is None else jnp.asarray(r) for r in a.runs_xs],
        False, True))
    t_ts, t_views, t_lww = port_states()
    got = to_np(tss.serve_burst(t_ts, t_views, t_lww, t_args.ticket_xs,
                                t_args.merge_xs, t_args.lww_xs,
                                t_args.runs_xs, stats=True))
    assert_tree_equal(got, want, "serve_burst")
    assert emulated["window_pack"].launches == 1 + a.ticket_xs.shape[0]


def _admission_inputs(rng, with_runs):
    lanes, tm, docs, steps, run_k = 6, 37, 5, 9, 8
    mc = rng.integers(0, 50, (12, lanes, tm)).astype(np.int32)
    mc[0] = rng.choice([0, 1, 2, 3, 4, 5, 6, 6], (lanes, tm))
    mc[10] = rng.integers(-docs, docs + 3, (lanes, tm))
    mc[11] = rng.integers(-steps, steps + 2, (lanes, tm))
    seq = rng.integers(-1, 40, (docs, steps)).astype(np.int32)
    seq[rng.random((docs, steps)) < 0.3] = 0
    msn = rng.integers(0, 30, (docs, steps)).astype(np.int32)
    mr = None
    if with_runs:
        mr = np.zeros((4, lanes, tm, run_k), np.int32)
        mr[0] = rng.integers(0, 3, (lanes, tm, run_k)) * \
            (rng.random((lanes, tm, run_k)) < 0.6)
        mr[0, :lanes // 2] = 0  # lanes with no run member: never voided
        mr[1] = rng.integers(0, 99, (lanes, tm, run_k))
        mr[2] = rng.integers(-docs, docs + 1, (lanes, tm, run_k))
        mr[3] = rng.integers(-steps, steps + 1, (lanes, tm, run_k))
    return seq, msn, mc, mr


def _jax_gather(plane, d, t):
    """JAX's gather rule on an index pair: from the end, then clamped."""
    return np.asarray(jnp.asarray(plane)[jnp.asarray(d), jnp.asarray(t)])


def _in_range(x, n):
    return np.clip(np.where(x < 0, x + n, x), 0, n - 1).astype(np.int32)


@pytest.mark.parametrize("with_runs", [False, True])
def test_emulated_admission_equals_plain(emulated, with_runs):
    """Every column of the kernel's admission equals the plain version's
    on the same window once the indices are brought into range as JAX
    brings them; lanes of a partly empty block, T past one warp."""
    rng = np.random.default_rng(7 + with_runs)
    seq, msn, mc, mr = _admission_inputs(rng, with_runs)
    docs, steps = seq.shape
    # The kernel's gathers are JAX's.
    assert (_jax_gather(seq, mc[10], mc[11]) ==
            seq[_in_range(mc[10], docs), _in_range(mc[11], steps)]).all()
    t = [torch.from_numpy(x) for x in (seq, msn, mc)]
    t.append(None if mr is None else torch.from_numpy(mr))
    got = tss.admit_merge_ops(*t)
    assert emulated["window_admit"].launches == 1
    mc_in, mr_in = mc.copy(), None if mr is None else mr.copy()
    mc_in[10], mc_in[11] = _in_range(mc[10], docs), _in_range(mc[11], steps)
    if mr is not None:
        mr_in[2], mr_in[3] = _in_range(mr[2], docs), _in_range(mr[3], steps)
    want = tss.admit_merge_ops_plain(
        torch.from_numpy(seq), torch.from_numpy(msn),
        torch.from_numpy(mc_in),
        None if mr_in is None else torch.from_numpy(mr_in))
    assert_tree_equal(to_np(got[0]), to_np(want[0]), "ops")
    assert_tree_equal(to_np(got[1]), to_np(want[1]), "runs")
    assert_tree_equal(to_np(got[2]), to_np(want[2]), "over_extra")
    if with_runs:
        assert want[2].any() and not want[2].all()
    assert (want[0].kind.numpy() != 0).any()


def test_emulated_kernels_refuse_what_they_do_not_take(emu_lib):
    """The admission refuses an empty window, the pack more than 32 groups
    and buckets; nothing is written."""
    import ctypes
    buf = np.zeros(256, np.int16)
    p = buf.ctypes.data
    ptrs = (ctypes.c_void_p * 9)(*([p] * 3 + [None] + [p] * 3 + [None] * 2))
    for lanes, steps, rows, cols in ((0, 4, 2, 2), (3, 0, 2, 2),
                                     (3, 4, 0, 2)):
        assert emu_lib.fluid_window_admit(ptrs, lanes, steps, 0, rows, cols,
                                          None) == 1
    many = (ctypes.c_void_p * (8 + 7 * 33))(*([p] * (8 + 7 * 33)))
    ints = (ctypes.c_int * (6 * 33))()
    assert emu_lib.fluid_window_pack(many, ints, 2, 2, 33, 0, -1, 0,
                                     None) == 1
    assert emu_lib.fluid_window_pack(many, ints, 0, 2, 0, 0, -1, 0,
                                     None) == 1
    assert (buf == 0).all()
