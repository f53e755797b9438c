"""The port's serving programs (fluidframework_tpu_torch/server/serve_step.py)
against the JAX package's, bit for bit, on the CPU.

Rings come from the port's seeded generator (testing/serving.py) at small
size: a few documents in page groups of 16-row pages, K=2 windows, with
INSERT_RUN slots, LWW lanes, nacks, duplicates and a mispredicted run; and
one ring captured from a real JAX sequencer drive. The JAX side runs
serve_megakernel_keep with the scan op-phase (fused=False) and, once, with
the Pallas program in interpret mode. Tolerance: exact equality (every
output is int32, int16 or bool).
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
from fluidframework_tpu_torch.mergetree import pallas_apply as tpa
from fluidframework_tpu_torch.mergetree.paging import PagedMergeStore
from fluidframework_tpu_torch.mergetree.state import DocState, make_state
from fluidframework_tpu_torch.server import lww_kernel as tlk
from fluidframework_tpu_torch.server import serve_step as tss
from fluidframework_tpu_torch.server import ticket_kernel as ttk
from fluidframework_tpu_torch.server.serve_step import RingArgs
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.oppack import PackedOps
from fluidframework_tpu_torch.testing.serving import (
    SMALL_HOT_RING, SMALL_RING, TICKET_CLIENTS, ServingFleet, adopt_ring)

PAGE_ROWS_SMALL = 16
_NAMES = ("tstate", "pool", "lww", "flat16_k", "msn_k", "pre")


def to_np(x):
    """Any output tree (NamedTuples, tuples, tensors, jax arrays) ->
    the same tree of numpy arrays."""
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return type(x)._make(to_np(v) for v in x)
    if isinstance(x, (tuple, list)):
        return tuple(to_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def assert_tree_equal(got, want, name="out"):
    if want is None:
        assert got is None, name
        return
    if hasattr(want, "_fields"):
        assert tuple(got._fields) == tuple(want._fields), name
        for f in want._fields:
            assert_tree_equal(getattr(got, f), getattr(want, f),
                              f"{name}.{f}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{name}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, \
        (name, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=name)


def _jax_tree(np_tup, cls):
    return cls(**{f: jnp.asarray(v) for f, v in zip(np_tup._fields,
                                                    np_tup)})


def jax_megakernel(tstate, pool, lww, ring: RingArgs, fused=False,
                   stats=False):
    """JAX serve_megakernel_keep on numpy inputs -> numpy outputs (pool
    and pre views as port DocStates, LWW as port LwwStates)."""
    j = jss.serve_megakernel_keep(
        _jax_tree(tstate, jtk.TicketState), _jax_tree(pool, JaxDocState),
        tuple(_jax_tree(s, jlk.LwwState) for s in lww),
        jnp.asarray(ring.ticket_xs),
        *(tuple(None if x is None else jnp.asarray(x) for x in field)
          for field in ring[1:5]),
        tuple(jnp.asarray(x) for x in ring.merge_xs),
        tuple(jnp.asarray(x) for x in ring.lww_xs),
        tuple(None if x is None else jnp.asarray(x) for x in ring.runs_xs),
        fused, stats)
    ts, pool2, lww2, flat, msn, pre = to_np(j)
    return (ttk.TicketState(*ts), DocState(*pool2),
            tuple(tlk.LwwState(*s) for s in lww2), flat, msn,
            tuple(DocState(*p) for p in pre))


def port_megakernel(tstate, pool, lww, ring: RingArgs, stats=False,
                    keep=True, stage=None):
    fn = tss.serve_megakernel_keep if keep else tss.serve_megakernel
    out = fn(interop.ticket_state_from_numpy(tstate._asdict(), "cpu"),
             interop.page_pool_from_numpy(pool._asdict(), "cpu"),
             [interop.lww_state_from_numpy(s._asdict(), "cpu") for s in lww],
             *interop.ring_args_from_numpy(ring, "cpu"), stats=stats,
             stage=stage)
    return to_np(out)


class Fleet:
    """A SMALL_RING fleet with its store and the states between rings,
    carried through the JAX package (the reference)."""

    def __init__(self, seed, spec=SMALL_RING, page_rows=PAGE_ROWS_SMALL,
                 k_slots=3, a_slots=4):
        self.spec = spec
        self.fleet = ServingFleet(spec, seed=seed)
        self.store = PagedMergeStore(page_rows=page_rows, pages=8,
                                     anno_slots=a_slots,
                                     overlap_slots=k_slots, device="cpu")
        self.tstate = to_np(ttk.make_ticket_state(
            TICKET_CLIENTS, spec.docs, device="cpu"))
        self.lww = (to_np(tlk.make_lww_state(
            spec.lww_capacity, self.fleet.lww_lanes, device="cpu")),)

    @property
    def pool(self):
        return to_np(self.store.pool)

    def stage(self):
        return self.fleet.stage_ring(self.store)

    def advance(self, ring, out):
        """Adopt a ring's (JAX) outputs as the next ring's inputs."""
        self.tstate, pool, self.lww, flat = out[0], out[1], out[2], out[3]
        self.store.adopt_pool(interop.page_pool_from_numpy(
            pool._asdict(), "cpu"))
        adopt_ring(self.store, ring, flat[-1])


def test_megakernel_rings_match_jax():
    """Two rings back to back (the first grows the documents from empty,
    stats on; the second stats off), the port's keep and in-place twins
    against JAX."""
    f = Fleet(0)
    seen = {"runs": 0, "mispredicted": 0, "nacked": 0, "lww": 0,
            "groups": set()}
    for stats in (True, False):
        ring = f.stage()
        want = jax_megakernel(f.tstate, f.pool, f.lww, ring.args,
                              stats=stats)
        for keep in (True, False):
            got = port_megakernel(f.tstate, f.pool, f.lww, ring.args,
                                  stats=stats, keep=keep)
            for name, g, w in zip(_NAMES, got, want):
                assert_tree_equal(g, w, f"{name} (keep={keep})")
        layout = tss.flat16_layout(f.spec.docs, f.spec.steps,
                                   ring.merge_lanes, ring.lww_lanes,
                                   paged_scalars=True, stats=stats)
        flat = got[3]
        assert layout["total"][1] == flat.shape[1]
        lo, hi = layout["overflow"]
        merge_over = flat[-1, lo:lo + sum(ring.merge_lanes)]
        np.testing.assert_array_equal(
            merge_over, np.concatenate(ring.expected_overflow))
        lo, hi = layout["flags"]
        seen["nacked"] += int((flat[:, lo:hi] & 1).sum())
        seen["runs"] += ring.counts["run_slots"]
        seen["mispredicted"] += ring.counts["mispredicted_docs"]
        seen["lww"] += ring.counts["lww_ops"]
        seen["groups"].add(len(ring.merge_lanes))
        f.advance(ring, want)
    assert seen["runs"] and seen["mispredicted"] and seen["nacked"] \
        and seen["lww"], seen
    assert max(seen["groups"]) >= 2, seen


def test_megakernel_matches_interpret_kernel():
    """Once against the Pallas program itself (interpret mode), fused
    apply + in-kernel extract + INSERT_RUN on every group."""
    f = Fleet(2)
    ring = f.stage()
    want = jax_megakernel(f.tstate, f.pool, f.lww, ring.args,
                          fused="interpret", stats=True)
    got = port_megakernel(f.tstate, f.pool, f.lww, ring.args, stats=True)
    for name, g, w in zip(_NAMES, got, want):
        assert_tree_equal(g, w, name)
    assert any(r is not None for r in ring.args.runs_xs)


def test_keep_leaves_inputs_unchanged_and_inplace_updates_pool():
    f = Fleet(3)
    ring = f.stage()
    ts = interop.ticket_state_from_numpy(f.tstate._asdict(), "cpu")
    pool = interop.page_pool_from_numpy(f.pool._asdict(), "cpu")
    lww = [interop.lww_state_from_numpy(s._asdict(), "cpu") for s in f.lww]
    args = interop.ring_args_from_numpy(ring.args, "cpu")
    before = to_np((ts, pool, lww, args))
    out = tss.serve_megakernel_keep(ts, pool, lww, *args, stats=True)
    assert_tree_equal(to_np((ts, pool, lww, args)), before, "inputs")
    assert out[1].length.data_ptr() != pool.length.data_ptr()
    out2 = tss.serve_megakernel(ts, pool, lww, *args, stats=True)
    assert out2[1].length.data_ptr() == pool.length.data_ptr()
    assert_tree_equal(to_np(pool), to_np(out[1]), "in-place pool")
    assert not np.array_equal(to_np(pool).length, before[1].length)


def test_view_capacity_above_fused_limit_raises():
    """64 pages of 64 rows = 4096 > max_fused_capacity(3, 4) = 3410: the
    fused apply refuses the view, so the megakernel routes it to the scan
    apply, and the ring equals JAX's (whose fused program routes it to
    its scan the same way)."""
    limit = tpa.max_fused_capacity(3, 4)
    assert limit == 3410
    n_pages = 66
    pool = make_state(64, 4, batch=n_pages, device="cpu")
    ts = ttk.make_ticket_state(8, 1, device="cpu")
    pids = torch.arange(1, 65, dtype=torch.int32)[None]
    zero = torch.zeros(1, dtype=torch.int32)
    args = RingArgs(
        ticket_xs=torch.zeros((1, 4, 1, 1), dtype=torch.int32),
        page_ids=(pids,), counts=(zero,), min_seqs=(zero,), seqs=(zero,),
        merge_xs=(torch.zeros((1, 12, 1, 1), dtype=torch.int32),),
        lww_xs=(), runs_xs=(None,))
    view = tkernel.gather_pages(pool, pids, zero, zero, zero)
    ops = PackedOps(*(torch.zeros((1, 1), dtype=torch.int32)
                      for _ in PackedOps._fields))
    with pytest.raises(ValueError, match=str(limit)):
        tpa.apply_ops_fused(view, ops)
    marks = []
    got = to_np(tss.serve_megakernel_keep(ts, pool, [], *args,
                                          stage=marks.append))
    assert "apply_scan_plain" in marks
    want = jax_megakernel(to_np(ts), to_np(pool), (), to_np(args),
                          fused="interpret")
    for name, g, w in zip(_NAMES, got, want):
        assert_tree_equal(g, w, name)


HOT_SHAPES = [
    # (spec, page rows, K overlap slots, A annotate slots): one hot group
    # above max_fused_capacity(K, A) beside the SMALL_RING groups.
    pytest.param(SMALL_HOT_RING, 64, 8, 16, id="K8-A16-C2048"),
    pytest.param(SMALL_HOT_RING._replace(classes=SMALL_HOT_RING.classes[
        :-1] + (SMALL_HOT_RING.classes[-1]._replace(rows=3800),)),
        64, 3, 4, id="K3-A4-C4096"),
]


@pytest.mark.parametrize("spec,page_rows,k_slots,a_slots", HOT_SHAPES)
def test_megakernel_hot_group_above_fused_capacity_matches_jax(
        spec, page_rows, k_slots, a_slots):
    """A hot document pre-seeded past max_fused_capacity(K, A) lands in a
    page group of its own (K8-A16: 32 pages of 64 rows, C = 2,048 > 1,705
    slots; K3-A4: 64 pages, C = 4,096 > 3,410): the ring takes the scan
    apply there and the fused apply elsewhere, and equals JAX's
    serve_megakernel_keep (Pallas in interpret mode on the small groups,
    its scan above the limit) bit for bit, stats on."""
    f = Fleet(5, spec=spec, page_rows=page_rows, k_slots=k_slots,
              a_slots=a_slots)
    ring = f.stage()
    limit = tpa.max_fused_capacity(k_slots, a_slots)
    caps = [p.shape[1] * page_rows for p in ring.args.page_ids]
    assert max(caps) > limit >= min(caps), (caps, limit)
    marks = []
    got = port_megakernel(f.tstate, f.pool, f.lww, ring.args, stats=True,
                          stage=marks.append)
    assert "apply_scan_runs" in marks or "apply_scan_plain" in marks
    assert any(m.startswith("apply_runs_extract") or m == "apply_extract"
               for m in marks)
    want = jax_megakernel(f.tstate, f.pool, f.lww, ring.args,
                          fused="interpret", stats=True)
    for name, g, w in zip(_NAMES, got, want):
        assert_tree_equal(g, w, name)
    layout = tss.flat16_layout(spec.docs, spec.steps, ring.merge_lanes,
                               ring.lww_lanes, paged_scalars=True,
                               stats=True)
    lo, _hi = layout["overflow"]
    np.testing.assert_array_equal(
        got[3][-1, lo:lo + sum(ring.merge_lanes)],
        np.concatenate(ring.expected_overflow))


def _jax_admission(seq_bt, msn_bt, mc, mr):
    """The admission block of the JAX _serve_window_impl
    (fluidframework_tpu/server/serve_step.py) on numpy columns."""
    seq_bt, msn_bt, mc = (jnp.asarray(x) for x in (seq_bt, msn_bt, mc))
    seq_g, msn_g = seq_bt[mc[10], mc[11]], msn_bt[mc[10], mc[11]]
    kind = mc[0]
    ok = (kind != 0) & (seq_g > 0)
    runs = over = None
    if mr is not None:
        mr = jnp.asarray(mr)
        sub_seq = seq_bt[mr[2], mr[3]]
        expected = mr[0] > 0
        mispredict = (kind == 6) & jnp.any(expected & (sub_seq <= 0),
                                           axis=-1)
        ok = ok & ~mispredict
        runs = (mr[0], jnp.where(expected, sub_seq, 0), mr[1])
        over = jnp.any(mispredict, axis=-1)
    ops = (jnp.where(ok, kind, 0), jnp.where(ok, seq_g, 0),
           jnp.where(ok, msn_g, 0))
    return to_np(ops), to_np(runs), to_np(over)


@pytest.mark.parametrize("with_runs", [False, True])
def test_admission_plain_matches_jax(with_runs):
    """admit_merge_ops_plain's admitted columns, run seqs and mispredict
    flags against the JAX window's admission block: unsequenced (0) and
    nacked (-1) steps, INSERT_RUN slots with voided members."""
    rng = np.random.default_rng(21 + with_runs)
    lanes, tm, docs, steps, run_k = 9, 20, 6, 11, 8
    mc = rng.integers(0, 40, (12, lanes, tm)).astype(np.int32)
    mc[0] = rng.choice([0, 1, 2, 3, 4, 5, 6, 6], (lanes, tm))
    mc[10] = rng.integers(0, docs, (lanes, tm))
    mc[11] = rng.integers(0, steps, (lanes, tm))
    seq = rng.integers(-1, 50, (docs, steps)).astype(np.int32)
    seq[rng.random((docs, steps)) < 0.2] = 0
    msn = rng.integers(0, 40, (docs, steps)).astype(np.int32)
    mr = None
    if with_runs:
        mr = np.zeros((4, lanes, tm, run_k), np.int32)
        mr[0] = rng.integers(1, 3, (lanes, tm, run_k)) * \
            (rng.random((lanes, tm, run_k)) < 0.5)
        mr[0, :lanes // 2] = 0
        mr[1] = rng.integers(0, 99, (lanes, tm, run_k))
        mr[2] = rng.integers(0, docs, (lanes, tm, run_k))
        mr[3] = rng.integers(0, steps, (lanes, tm, run_k))
    ops, runs, over = tss.admit_merge_ops_plain(
        torch.from_numpy(seq), torch.from_numpy(msn), torch.from_numpy(mc),
        None if mr is None else torch.from_numpy(mr))
    (w_kind, w_seq, w_msn), w_runs, w_over = _jax_admission(seq, msn, mc, mr)
    for name, g, w in (("kind", ops.kind, w_kind), ("seq", ops.seq, w_seq),
                       ("msn", ops.msn, w_msn)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for i, name in ((2, "ref_seq"), (3, "client"), (4, "pos1"),
                    (6, "op_id"), (8, "local_seq")):
        np.testing.assert_array_equal(getattr(ops, name).numpy(), mc[i])
    if with_runs:
        for g, w in zip((runs.length, runs.seq, runs.op_id), w_runs):
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(over.numpy(), w_over)
        assert over.any() and not over.all()
    else:
        assert runs is None and over is None
