"""The port's paged ops (fluidframework_tpu_torch/mergetree/kernel.py
apply_ops_paged, rollback_pages, compact_pages, paged_stats_vec, and
server/serve_step.py serve_paged_burst) against the JAX package's on the
CPU, bit for bit.

Inputs are made from a seed with numpy: pools whose documents hold
fuzz_tables rows in randomly placed pages, page tables with -1 padding
(short tables and an all-padding lane with a NOOP stream, as the
sequencer pads a group), and gen_fuzz_traces op streams. The JAX side runs
its non-donating `_keep` jits (their scan apply is kernel._scan_ops); the
port runs its plain scan (CPU tensors). Then a ragged "storm" fleet staged
the way the JAX sequencer's MergeLaneStore._apply_paged groups streams
(the pattern of tests/test_paged_memory.py) must read back the port
oracle's text, and annotate-ring exhaustion in the last chunk of a burst
must give JAX's sticky over_k flags and pre-view rollback. Tolerance:
exact equality (every field is int32, int16 or bool).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel as jkernel
from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.state import DocState as JaxDocState
from fluidframework_tpu.server import serve_step as jss

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.host import (GOD_CLIENT, OpBuilder,
                                                     PayloadTable,
                                                     extract_text)
from fluidframework_tpu_torch.mergetree.oppack import (OpKind, PackedOps,
                                                       pack_ops)
from fluidframework_tpu_torch.mergetree.oracle import MergeTreeOracle
from fluidframework_tpu_torch.mergetree.paging import (PagedMergeStore,
                                                       pow2_pages)
from fluidframework_tpu_torch.mergetree.state import DocState, make_state
from fluidframework_tpu_torch.server import serve_step as tss
from fluidframework_tpu_torch.telemetry.device_stats import N_PAGED
from fluidframework_tpu_torch.testing.serving import (SMALL_HOT_RING,
                                                      adopt_paged_group,
                                                      stage_paged_groups)
from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                     gen_fuzz_traces)

from test_kernel import apply_to_oracle, random_schedule
from test_torch_serving import Fleet, jax_megakernel, port_megakernel

ROWS = 16  # page rows of the random pools


def to_np(x):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(to_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def assert_tree_equal(got, want, name="out"):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{name}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, \
        (name, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=name)


def jax_state(d):
    return JaxDocState(**{f: jnp.asarray(v) for f, v in d.items()})


def jax_ops(d):
    return JaxPackedOps(**{f: jnp.asarray(v) for f, v in d.items()})


def port_state(d):
    return interop.doc_state_from_numpy(d, "cpu")


def port_ops(d):
    return interop.packed_ops_from_numpy(d, "cpu")


def paged_case(seed, b=6, p=4, k=3, a=4):
    """A pool of fuzz_tables documents (b - 1 of them, every other one
    empty) in randomly placed pages, short tables padded with -1, and a
    last lane that is all padding. Returns (pool, page_ids, counts,
    min_seqs, seqs) as numpy arrays."""
    rng = np.random.default_rng(seed)
    docs = fuzz_tables(b, p * ROWS, k, a, seed=seed, free=2 * ROWS)
    n_pages = 1 + b * p + 5
    pool = {f: np.asarray(v).copy() for f, v in zip(
        DocState._fields, make_state(ROWS, a, k, batch=n_pages,
                                     device="cpu"))}
    perm = rng.permutation(np.arange(1, n_pages))
    pids = np.full((b, p), -1, np.int32)
    counts = np.zeros(b, np.int32)
    for d in range(b - 1):
        used = p if d % 3 else int(rng.integers(1, p))
        pids[d, :used] = perm[d * p:d * p + used]
        for j in range(used):
            for f in DocState._fields[:10]:
                pool[f][pids[d, j]] = docs[f][d, j * ROWS:(j + 1) * ROWS]
        counts[d] = min(int(docs["count"][d]), used * ROWS - 2)
    mins = np.where(counts > 0, rng.integers(0, 3, b), 0).astype(np.int32)
    seqs = np.where(counts > 0, docs["seq"], 0).astype(np.int32)
    return pool, pids, counts, mins, seqs


def fuzz_ops(seed, counts, steps):
    ops = gen_fuzz_traces(len(counts), steps, seed=seed,
                          length=np.maximum(counts, 1))
    for col in ops.values():   # the padding lane's stream is all NOOP
        col[-1] = 0
    return ops


def both_apply(case, ops, stats):
    pool, pids, counts, mins, seqs = case
    want = jkernel.apply_ops_paged_keep(
        jax_state(pool), jnp.asarray(pids), jnp.asarray(counts),
        jnp.asarray(mins), jnp.asarray(seqs), jax_ops(ops), stats=stats)
    got = tkernel.apply_ops_paged_keep(
        port_state(pool), torch.from_numpy(pids), torch.from_numpy(counts),
        torch.from_numpy(mins), torch.from_numpy(seqs), port_ops(ops),
        stats=stats)
    return to_np(got), to_np(want)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_ops_paged_matches_jax(seed, stats):
    case = paged_case(seed)
    ops = fuzz_ops(seed, case[2], 24)
    got, want = both_apply(case, ops, stats)
    assert len(got) == (8 if stats else 7)
    assert_tree_equal(got, want)
    if stats:
        assert got[7].shape == (N_PAGED,) and got[7].dtype == np.int32
    # The in-place form writes the same pool into its argument.
    pool = port_state(case[0])
    out = tkernel.apply_ops_paged(
        pool, *(torch.from_numpy(x) for x in case[1:]), port_ops(ops))
    assert out[0] is pool
    assert_tree_equal(to_np(pool), want[0], "in-place pool")


def test_paged_stats_vec_counts_the_staged_ops():
    case = paged_case(3)
    ops = fuzz_ops(3, case[2], 16)
    got, _want = both_apply(case, ops, True)
    kinds = ops["kind"]
    expect = [int((kinds == k).sum()) for k in (
        OpKind.INSERT, OpKind.REMOVE, OpKind.ANNOTATE, OpKind.ACK_INSERT,
        OpKind.ACK_REMOVE, OpKind.INSERT_RUN)]
    expect += [int(got[5].sum()), int(got[2].sum())]
    assert got[7].tolist() == expect


@pytest.mark.parametrize("seed", [4, 5])
def test_rollback_and_compact_pages_match_jax(seed):
    case = paged_case(seed)
    ops = fuzz_ops(seed, case[2], 24)
    got, want = both_apply(case, ops, False)
    flagged = np.flatnonzero(got[5])
    sub = flagged if len(flagged) else np.asarray([0, 2])
    pids = case[1][sub]
    pre = [v[sub] for v in want[6]]
    j = jkernel.rollback_pages_keep(
        jax_state(dict(zip(DocState._fields, want[0]))), jnp.asarray(pids),
        jax_state(dict(zip(DocState._fields, pre))))
    t = tkernel.rollback_pages_keep(
        DocState(*(torch.from_numpy(v) for v in got[0])),
        torch.from_numpy(pids), DocState(*(torch.from_numpy(v)
                                           for v in pre)))
    assert_tree_equal(to_np(t), to_np(j), "rollback")

    post = dict(zip(DocState._fields, got[0]))
    counts, mins, seqs = got[2], got[3] + 1, got[4]
    j = jkernel.compact_pages_keep(
        jax_state(post), jnp.asarray(case[1]), jnp.asarray(counts),
        jnp.asarray(mins), jnp.asarray(seqs))
    t = tkernel.compact_pages_keep(
        port_state(post), torch.from_numpy(case[1]),
        torch.from_numpy(counts), torch.from_numpy(mins),
        torch.from_numpy(seqs))
    assert_tree_equal(to_np(t), to_np(j), "compact")
    assert (to_np(t)[2] <= counts).all()


def stack_chunks(chunks):
    return {f: np.stack([c[f] for c in chunks]) for f in chunks[0]}


@pytest.mark.parametrize("k_chunks", [1, 2, 4])
@pytest.mark.parametrize("stats", [False, True])
def test_serve_paged_burst_matches_jax(k_chunks, stats):
    """K stacked [B, T] chunks; at K = 4 the last chunk is all NOOP (the
    sequencer pads K to a power of two)."""
    seed = 10 + k_chunks
    case = paged_case(seed)
    real = 3 if k_chunks == 4 else k_chunks
    chunks = [fuzz_ops(seed + c, case[2] + 8 * c, 12) for c in range(real)]
    chunks += [{f: np.zeros_like(v) for f, v in chunks[0].items()}
               for _ in range(k_chunks - real)]
    xs = stack_chunks(chunks)
    pool, pids, counts, mins, seqs = case
    want = to_np(jss.serve_paged_burst_keep(
        jax_state(pool), jnp.asarray(pids), jnp.asarray(counts),
        jnp.asarray(mins), jnp.asarray(seqs), jax_ops(xs), stats))
    got = to_np(tss.serve_paged_burst_keep(
        port_state(pool), torch.from_numpy(pids), torch.from_numpy(counts),
        torch.from_numpy(mins), torch.from_numpy(seqs), port_ops(xs),
        stats=stats))
    assert len(got) == (9 if stats else 8)
    assert_tree_equal(got, want)
    assert got[6].shape == (k_chunks, len(counts))
    if stats:
        assert got[8].shape == (k_chunks, N_PAGED)
    if k_chunks == 4:   # the NOOP chunk changes nothing
        np.testing.assert_array_equal(got[6][3], got[6][2])
        if stats:
            assert got[8][3][:6].tolist() == [0] * 6
    # The in-place form: the pool argument holds the result.
    t_pool = port_state(pool)
    out = tss.serve_paged_burst(
        t_pool, *(torch.from_numpy(x) for x in case[1:]), port_ops(xs))
    assert out[0] is t_pool
    assert_tree_equal(to_np(t_pool), want[0], "in-place pool")


# ---------------------------------------------------------------------------
# the storm fleet, staged the way MergeLaneStore._apply_paged groups it
# ---------------------------------------------------------------------------

def host_ops(builder, schedule):
    out = []
    for op in schedule:
        kind = op[0]
        if kind == "insert":
            _, pos, text, ref_seq, client, seq = op
            out.append(builder.insert_text(pos, text, ref_seq, client, seq))
        elif kind == "remove":
            _, start, end, ref_seq, client, seq = op
            out.append(builder.remove(start, end, ref_seq, client, seq))
        else:
            _, start, end, props, ref_seq, client, seq = op
            out.append(builder.annotate(start, end, props, ref_seq, client,
                                        seq))
    return out


def apply_paged_groups(store, streams):
    """Stage the streams as the JAX sequencer's MergeLaneStore._apply_paged
    does (testing/serving.stage_paged_groups) and run each group through
    apply_ops_paged (one T bucket) or serve_paged_burst (K chunks), in
    place on the store's pool, then adopt the post scalars. The same
    dispatches run through the JAX package from the same staged pool, and
    every output must be equal. Returns the dispatches as (burst, B, C,
    K)."""
    log = []
    groups = stage_paged_groups(store, streams)
    jax_pool = dict(zip(DocState._fields, to_np(store.pool)))
    for g in groups:
        sc = (g.counts, g.min_seqs, g.seqs)
        args = (torch.from_numpy(g.page_ids),) + tuple(
            torch.from_numpy(x) for x in sc)
        jargs = (jax_state(jax_pool), jnp.asarray(g.page_ids)) + tuple(
            jnp.asarray(x) for x in sc) + (jax_ops(g.ops),)
        if g.burst:
            out = tss.serve_paged_burst(store.pool, *args, port_ops(g.ops))
            want = to_np(jss.serve_paged_burst_keep(*jargs, False))
        else:
            out = tkernel.apply_ops_paged(store.pool, *args,
                                          port_ops(g.ops))
            want = to_np(jkernel.apply_ops_paged_keep(*jargs))
        assert_tree_equal(to_np(out), want, f"group {g.page_ids.shape}")
        jax_pool = dict(zip(DocState._fields, want[0]))
        assert not bool(out[5][:len(g.keys)].any())
        adopt_paged_group(store, g, out[2].numpy(), out[3].numpy(),
                          out[4].numpy())
        log.append((g.burst,) + g.page_ids.shape[:1] + (
            g.page_ids.shape[1] * store.page_rows,
            g.ops["kind"].shape[0] if g.burst else 1))
    return log


@pytest.mark.parametrize("seed,storm_ops,anno_slots",
                         [(1, 120, 4), (7, 120, 4), (23, 300, 64)])
def test_storm_fleet_paged_text_matches_oracle(seed, storm_ops, anno_slots):
    """120 storm ops fit one T = 256 apply at the serving default of 4
    annotate slots; 300 take a two-chunk burst, with a ring deep enough
    for the storm's ~60 annotates (at 4 slots the ring exhausts there:
    that class is test_mid_burst_ring_exhaustion_matches_jax's)."""
    rng = random.Random(seed)
    schedules = {("storm",): random_schedule(rng, 3, storm_ops)}
    for i in range(24):
        schedules[(f"k{i}",)] = random_schedule(rng, 2, 4)
    payloads = PayloadTable()
    builder = OpBuilder(payloads)
    streams = {k: host_ops(builder, s) for k, s in schedules.items()}
    store = PagedMergeStore(page_rows=16, pages=8, anno_slots=anno_slots,
                            device="cpu")
    log = apply_paged_groups(store, streams)
    assert any(burst for burst, *_ in log) == (storm_ops > 256)
    assert len({c for _burst, _b, c, _k in log}) >= 2, log
    for key, schedule in schedules.items():
        oracle = MergeTreeOracle(local_client=GOD_CLIENT)
        apply_to_oracle(oracle, schedule)
        top = max(op[-1] for op in schedule)
        text = extract_text(store.row(key), payloads, ref_seq=top)
        assert text == oracle.get_text(ref_seq=top, client=GOD_CLIENT), key
    assert 0 < store.page_fill_frac() <= 1


def test_mid_burst_ring_exhaustion_matches_jax():
    """Annotate-ring exhaustion in the last chunk of a burst: the overflow
    flag is sticky across the carry (over_k false, then true), and the
    pre-view rollback equals JAX's."""
    payloads = PayloadTable()
    b = OpBuilder(payloads)
    ops, seq = [], 0
    for _ in range(300):   # > 256: two scanned chunks
        seq += 1
        ops.append(b.insert_text(0, "y", seq - 1, GOD_CLIENT, seq))
    for i in range(6):     # DEFAULT_ANNO_SLOTS = 4: the ring exhausts
        seq += 1
        ops.append(b.annotate(0, 4, {f"k{i}": i}, seq - 1, GOD_CLIENT,
                              seq))
    other = [b.insert_text(0, "z", 0, GOD_CLIENT, 1)]
    store = PagedMergeStore(page_rows=64, pages=8, device="cpu")
    keys = [("burst-anno",), ("quiet",)]
    for key, n in zip(keys, (len(ops), 1)):
        store.ensure_rows(key, 2 * n)
    p2 = pow2_pages(max(len(store.tables[k]) for k in keys))
    pids = store.page_ids_array(keys, p2)
    sc = store.scalars_arrays(keys)
    xs = stack_chunks([pack_ops([ops[:256], other], steps=256),
                       pack_ops([ops[256:], []], steps=256)])
    pool0 = to_np(store.pool)
    want = to_np(jss.serve_paged_burst_keep(
        jax_state(dict(zip(DocState._fields, pool0))), jnp.asarray(pids),
        *(jnp.asarray(x) for x in sc), jax_ops(xs), True))
    got = to_np(tss.serve_paged_burst(
        store.pool, torch.from_numpy(pids),
        *(torch.from_numpy(x) for x in sc), port_ops(xs), stats=True))
    assert_tree_equal(got, want)
    assert got[6].tolist() == [[False, False], [True, False]]
    assert got[8][:, 6].tolist() == [0, 1]
    flagged = np.flatnonzero(got[5])
    assert flagged.tolist() == [0]
    pre = [v[flagged] for v in want[7]]
    j = jkernel.rollback_pages_keep(
        jax_state(dict(zip(DocState._fields, want[0]))),
        jnp.asarray(pids[flagged]),
        jax_state(dict(zip(DocState._fields, pre))))
    t = tkernel.rollback_pages(
        store.pool, torch.from_numpy(pids[flagged]),
        DocState(*(torch.from_numpy(v) for v in pre)))
    assert_tree_equal(to_np(t), to_np(j), "rollback")
    # The flagged document's pages hold its pre-burst rows again; the
    # clean one keeps its applied insert.
    back = to_np(store.row(keys[0]))
    assert (back[0][:4] == pool0[0][pids[0, 0]][:4]).all()


def test_hot_fleet_ring_then_backlog_matches_jax():
    """The slice at CPU size (chip_smoke.py phase 12 runs it at full
    size): a SMALL_HOT_RING ring through the megakernel, then a backlog
    staged as MergeLaneStore._apply_paged stages it (one apply per small
    group, a four-chunk burst for the hot document's 700 ops at C =
    4,096), then compact_pages over the hot group: every output equal to
    the JAX package's."""
    f = Fleet(7, spec=SMALL_HOT_RING, page_rows=64)
    ring = f.stage()
    got = port_megakernel(f.tstate, f.pool, f.lww, ring.args)
    want = jax_megakernel(f.tstate, f.pool, f.lww, ring.args)
    for name, g, w in zip(("tstate", "pool", "lww", "flat16_k", "msn_k",
                           "pre"), got, want):
        assert_tree_equal(g, w, name)
    f.advance(ring, want)
    streams = f.fleet.backlog(lambda cls: 700 if cls.rows else cls.ops)
    log = apply_paged_groups(f.store, streams)
    assert log[-1] == (True, 1, 4096, 4), log
    assert all(not burst for burst, *_ in log[:-1])
    hot = [k for k, ops in streams.items() if len(ops) == 700]
    pids = f.store.page_ids_array(hot, pow2_pages(len(f.store.tables[
        hot[0]])))
    sc = f.store.scalars_arrays(hot)
    pool = dict(zip(DocState._fields, to_np(f.store.pool)))
    j = jkernel.compact_pages_keep(jax_state(pool), jnp.asarray(pids),
                                   *(jnp.asarray(x) for x in sc))
    t = tkernel.compact_pages(f.store.pool, torch.from_numpy(pids),
                              *(torch.from_numpy(x) for x in sc))
    assert_tree_equal(to_np(t), to_np(j), "compact")
    assert int(t[2][0]) < int(sc[0][0])   # tombstones were freed


def test_row_and_put_row_round_trip():
    store = PagedMergeStore(page_rows=8, pages=4, device="cpu")
    st = fuzz_tables(2, 24, 3, 4, seed=9)
    row = interop.doc_state_from_numpy({f: v[1] for f, v in st.items()},
                                       "cpu")
    n = int(row.count)
    store.put_row(("d",), row, n)
    assert len(store.tables[("d",)]) == -(-n // 8)
    back = store.row(("d",))
    for f in DocState._fields[:10]:
        np.testing.assert_array_equal(
            getattr(back, f).numpy()[:n], getattr(row, f).numpy()[:n], f)
    assert int(back.count) == n and int(back.seq) == int(row.seq)
    assert store.page_fill_frac() == n / (len(store.tables[("d",)]) * 8)


@pytest.mark.parametrize("batch,capacity,path,blocks", [
    (1, 4096, "global", 1),      # the catch-up's chunk: unchanged
    (8, 8192, "cluster", 8),     # B < 16: the 8-block rule, unchanged
    (16, 4096, "cluster", 2),    # the paged band 16 <= B < 132: the
    (64, 4096, "cluster", 2),    # smallest cluster that holds the
    (131, 4096, "cluster", 2),   # table, up to two waves of 132 SMs
    (132, 4096, "global", 1),    # B >= 132: unchanged
    (32, 8192, "cluster", 4),
    (64, 8192, "cluster", 4),
    (67, 8192, "global", 1),     # 268 blocks > two waves
    (1024, 8192, "global", 1),   # full_step above the fused capacity
    (64, 1024, "smem", 1),       # one block's shared memory holds it
])
def test_scan_rule_at_paged_shapes(batch, capacity, path, blocks):
    """kernel.scan_geometry at K=3, A=4 (the serving defaults) in and
    around the paged band (PERF.md §6, `calibrate_fused_apply.py --scan
    --paged`, chip_smoke.py phase 12)."""
    geo = tkernel.scan_geometry(batch, capacity, 3, 4)
    assert (geo.path, geo.blocks) == (path, blocks)
    assert batch * geo.blocks <= 2 * tkernel.SM_COUNT or geo.blocks == 1
