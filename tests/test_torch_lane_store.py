"""The port's merge lane stores (fluidframework_tpu_torch/server/
tpu_sequencer.py: MergeLaneStore bucketed and paged, _MergeBucket and its
helpers) against the JAX package's on the CPU.

Identical seeded schedules go through the JAX store and the port's store
(device="cpu"), each through its own OpBuilder, so both assign the same op
ids; the tests require bit-equal results with no tolerance (all state is
int32/bool): placements, every bucket's state planes or the page pool and
tables, texts, entries, extract_all, change generations, the payload
table, the recovery counters and the counter deltas. The cases mirror
tests/test_paged_memory.py::TestPagedConformance, tests/test_tpu_serving.py
::TestHostFold and ::TestOverflowRecovery (at the store, where the JAX
tests drive a TpuLocalServer), tests/test_narrow_wire.py::
TestDirtyEpochNeverStale and the store cases of tests/test_device_stats.py;
then the port's own: a kernel refusal inside a rescue propagates, and
testing/serving.stage_paged_groups stages what the store stages.
"""

import random

import numpy as np
import pytest
import torch

from test_kernel import GOD, apply_to_oracle, random_schedule

from fluidframework_tpu.mergetree import MergeTreeOracle
from fluidframework_tpu.mergetree.host import GOD_CLIENT
from fluidframework_tpu.server import tpu_sequencer as jseq
from fluidframework_tpu.telemetry import counters as jcounters
from fluidframework_tpu.telemetry import device_stats as jds
from fluidframework_tpu.telemetry.compile_ledger import ledger as jledger

from fluidframework_tpu_torch.core.errors import CapacityExceeded
from fluidframework_tpu_torch.mergetree import catchup as tcatchup
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.oppack import pack_ops
from fluidframework_tpu_torch.server import tpu_sequencer as tseq
from fluidframework_tpu_torch.telemetry import counters as tcounters
from fluidframework_tpu_torch.telemetry import device_stats as tds
from fluidframework_tpu_torch.telemetry.compile_ledger import \
    ledger as tledger
from fluidframework_tpu_torch.testing import golden, serving

RECOVERY = ("folds", "fold_rows_reclaimed", "overflow_drops",
            "fold_rescue_dispatches", "paged_rescues", "page_compactions",
            "payload_compactions", "blocks_aged")


@pytest.fixture(autouse=True)
def _fresh_counters():
    for c in (jcounters, tcounters):
        c.reset()
    yield
    for ds, c in ((jds, jcounters), (tds, tcounters)):
        c.reset()
        ds.set_enabled(True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def make(pkg, **kw):
    """A MergeLaneStore of `pkg` (jseq or tseq); the port's on the CPU."""
    if pkg is tseq:
        kw.setdefault("device", "cpu")
    return pkg.MergeLaneStore(**kw)


def pair(**kw):
    return make(jseq, **kw), make(tseq, **kw)


def stream(builder, schedule):
    """test_kernel op tuples -> HostOps through the store's builder."""
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
            out.append(builder.annotate(start, end, props, ref_seq,
                                        client, seq))
    return out


def apply_both(stores, make_streams):
    """make_streams(builder) -> {key: HostOps}, built and applied per
    store (one builder call sequence each, so the op ids agree)."""
    for s in stores:
        s.apply(make_streams(s.builder))


def state_np(state):
    """Either package's NamedTuple as {field: numpy}."""
    return {f: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).copy()
            for f, v in zip(state._fields, state)}


def assert_states_equal(a, b, what=""):
    na, nb = state_np(a), state_np(b)
    for f in na:
        assert na[f].dtype == nb[f].dtype and na[f].shape == nb[f].shape, \
            (what, f, na[f].dtype, nb[f].dtype, na[f].shape, nb[f].shape)
        assert np.array_equal(na[f], nb[f]), (what, f)


def assert_stores_equal(js, ts, texts=True):
    """Every observable of two merge lane stores, bit for bit."""
    assert js.where == ts.where
    assert js.opaque == ts.opaque
    assert js.change_gen == ts.change_gen
    for name in RECOVERY:
        assert getattr(js, name) == getattr(ts, name), name
    assert js._fold_payloads == ts._fold_payloads
    assert js._fold_skip == ts._fold_skip
    assert js.catchup_unsafe == ts.catchup_unsafe
    assert encode_table(js.payloads) == encode_table(ts.payloads)
    assert js.payloads.free_ids == ts.payloads.free_ids
    if js.paged:
        jp, tp = js.pages, ts.pages
        assert_states_equal(jp.pool, tp.pool, "pool")
        for name in ("tables", "counts", "min_seqs", "seqs",
                     "ops_since_compact", "pool_grows"):
            assert getattr(jp, name) == getattr(tp, name), name
        assert np.array_equal(jp.allocator.refcount, tp.allocator.refcount)
        assert js.paged_stats() == ts.paged_stats()
    else:
        assert len(js.buckets) == len(ts.buckets)
        for i, (jb, tb) in enumerate(zip(js.buckets, ts.buckets)):
            assert (jb.capacity, jb.lanes, jb.used, jb._free, jb._next) == \
                (tb.capacity, tb.lanes, tb.used, tb._free, tb._next), i
            assert np.array_equal(jb.count_hint, tb.count_hint), i
            assert_states_equal(jb.state, tb.state, f"bucket {i}")
    if texts:
        for key in js.where:
            assert js.text(key) == ts.text(key), key
            assert js.entries(key) == ts.entries(key), key


def encode_table(table) -> list:
    """golden.encode_payloads, with arena-block slots resolved (tagged)."""
    out = []
    for i, e in enumerate(table.entries):
        if type(e).__name__ == "MergeArenaBlock":
            p = e.resolve(i)
            out.append(("block", e.base, p.kind, p.text, p.props))
        else:
            out.append(golden.encode_payloads(type(table)(entries=[e]))[0])
    return out


def ragged_fleet(seed, storm_ops=120, fleet=24, fleet_ops=4):
    """One storm doc + a fleet of keystroke docs (test_paged_memory's)."""
    rng = random.Random(seed)
    docs = {("doc", "s", "storm"): random_schedule(rng, 3, storm_ops)}
    for i in range(fleet):
        docs[("doc", "s", f"k{i}")] = random_schedule(rng, 2, fleet_ops)
    return docs


def text_of(snap):
    return "".join(e.get("text") or "" for c in snap["chunks"]
                   for e in c if e.get("removedSeq") is None)


def typing(builder, seq, n, txt, pos=0, client=0):
    """n acked keystroke inserts at `pos`, msn trailing by one."""
    ops = []
    for _ in range(n):
        seq += 1
        ops.append(builder.insert_text(pos, txt, seq - 1, client, seq,
                                       msn=seq - 1))
    return ops, seq


# ---------------------------------------------------------------------------
# the bucket and its helpers
# ---------------------------------------------------------------------------

class TestBucket:
    def test_grow_alloc_free_put_match_jax(self):
        import jax.numpy as jnp

        from fluidframework_tpu.mergetree.state import (
            state_from_numpy as j_from_np)
        from fluidframework_tpu_torch.mergetree.state import (
            state_from_numpy as t_from_np)
        jb = jseq._MergeBucket(16, 2)
        tb = tseq._MergeBucket(16, 2, torch.device("cpu"))
        cols = {"length": np.arange(1, 6, dtype=np.int32),
                "ins_seq": np.arange(5, dtype=np.int32),
                "origin_op": np.arange(5, dtype=np.int32)}
        jrow = j_from_np(cols, 16)._replace(seq=jnp.asarray(9, jnp.int32))
        trow = t_from_np(cols, 16, device="cpu")._replace(
            seq=torch.tensor(9, dtype=torch.int32))
        for b, row in ((jb, jrow), (tb, trow)):
            lanes = b.alloc_many([("k", i) for i in range(5)])  # grows 2x
            b.put_row(lanes[1], row, count_hint=5)
            b.put_rows(lanes[2:4],
                       type(b.state)(*(x[np.asarray([1, 1])]
                                       for x in b.state)),
                       count_hints=[5, 5])
            b.free_many([lanes[2], lanes[0]])
            b.alloc(("k", "again"))
            b.put_row(lanes[4], row)
        assert (jb.lanes, jb.used, jb._free, jb._next) == \
            (tb.lanes, tb.used, tb._free, tb._next)
        assert np.array_equal(jb.count_hint, tb.count_hint)
        assert np.array_equal(jb.hint_pending, tb.hint_pending)
        assert_states_equal(jb.state, tb.state)
        assert_states_equal(jb.row(3), tb.row(3))

    def test_row_is_unchanged_by_later_updates(self):
        """A row taken from a bucket is JAX's immutable value: a later
        put, free or grow of the bucket does not reach it."""
        from fluidframework_tpu_torch.mergetree.state import make_state
        b = tseq._MergeBucket(8, 1, torch.device("cpu"))
        lane = b.alloc(("a",))
        full = make_state(8, device="cpu")
        b.put_row(lane, full._replace(length=full.length + 3))
        row = b.row(lane)
        before = state_np(row)
        b.free(lane)
        b.alloc(("b",))
        b.alloc(("c",))   # grows
        assert_states_equal(row, type(row)(**{
            f: torch.from_numpy(v) for f, v in before.items()}))

    def test_stack_seed_rows_and_repad_match_jax(self):
        from fluidframework_tpu.mergetree.catchup import \
            seed_host_cols as j_seed_cols
        entries = [{"text": "abc", "seq": 3, "client": 1},
                   {"text": "de", "removedSeq": 4, "removedClient": 2,
                    "removedOverlapClients": [1]},
                   {"text": "f", "localSeq": 2,
                    "pendingAnnotates": [{"localSeq": 3,
                                          "props": {"b": 1}}]}]
        items = []
        from fluidframework_tpu.mergetree.host import PayloadTable
        table = PayloadTable()
        for j in range(3):
            items.append((("k", j), j_seed_cols(entries[j:], table,
                                                anno_slots=4), j, 7 + j))
        jrows = jseq._stack_seed_rows(items, 8, 4, 3)
        trows = tseq._stack_seed_rows(items, 8, 4, 3, "cpu")
        assert_states_equal(jrows, trows)
        assert_states_equal(jseq._repad_batch(jrows, 32),
                            tseq._repad_batch(trows, 32))

    def test_bucket_helper_and_probe_names(self):
        assert tseq._bucket(5, (1, 4, 16)) == jseq._bucket(5, (1, 4, 16))
        with pytest.raises(ValueError, match="exceeds max bucket 16"):
            tseq._bucket(17, (1, 4, 16))
        assert tseq._apply_keep_batched.name == \
            jseq._apply_keep_batched.name == "kernel.merge_apply_batched"
        assert tseq._apply_paged_probe.name == \
            jseq._apply_paged_probe.name == "kernel.paged_apply"


# ---------------------------------------------------------------------------
# tests/test_paged_memory.py::TestPagedConformance
# ---------------------------------------------------------------------------

class TestPagedConformance:
    @pytest.mark.parametrize("seed", [1, 7, 23])
    def test_storm_fleet_matches_jax_oracle_and_bucketed(self, seed):
        schedules = ragged_fleet(seed)
        stores = {}
        for paged in (True, False):
            kw = {"paged": True, "page_rows": 16} if paged else {}
            js, ts = pair(**kw)
            apply_both((js, ts), lambda b: {k: stream(b, s)
                                            for k, s in schedules.items()})
            assert_stores_equal(js, ts)
            assert js.extract_all() == ts.extract_all()
            stores[paged] = ts
        paged, bucketed = stores[True], stores[False]
        for key, schedule in schedules.items():
            oracle = MergeTreeOracle(local_client=GOD)
            apply_to_oracle(oracle, schedule)
            top_seq = max(op[-1] for op in schedule)
            assert paged.text(key) == bucketed.text(key) == \
                oracle.get_text(ref_seq=top_seq, client=GOD)
            assert paged.entries(key) == bucketed.entries(key)
        assert paged.extract_all() == bucketed.extract_all()
        assert paged.folds == 0 and paged.overflow_drops == 0
        assert paged.fold_rescue_dispatches <= \
            bucketed.fold_rescue_dispatches

    def test_chunked_stream_rides_one_scanned_burst(self):
        key = ("doc", "s", "bulk")
        n = 700  # > max_t = 256 -> K = 3 chunks, padded to 4

        def ops(b):
            out = [b.insert_text(0, "seed ", 0, GOD_CLIENT, 1)]
            for i in range(n):
                out.append(b.insert_text(min(i, 3), "ab", i + 1,
                                         GOD_CLIENT, i + 2))
            return {key: out}

        tledger.reset()
        jp, tp = pair(paged=True)
        jb, tb = pair()
        apply_both((jp, tp, jb, tb), ops)
        assert_stores_equal(jp, tp)
        assert_stores_equal(jb, tb)
        assert tp.text(key) == tb.text(key)
        assert len(tp.text(key)) == 5 + 2 * n
        burst = tledger.snapshot()["symbols"]["serve.paged_burst"]
        assert burst["coldCalls"] + burst["warmCalls"] == 1

    def test_annotate_ring_exhaustion_takes_host_rescue(self):
        key = ("doc", "s", "anno")

        def ops(b):
            out = [b.insert_text(0, "abcdef", 0, GOD_CLIENT, 1)]
            for i in range(6):  # DEFAULT_ANNO_SLOTS = 4: the ring fills
                out.append(b.annotate(0, 6, {f"k{i}": i}, 1, GOD_CLIENT,
                                      2 + i))
            return {key: out}

        jp, tp = pair(paged=True)
        jb, tb = pair()
        apply_both((jp, tp, jb, tb), ops)
        assert_stores_equal(jp, tp)
        assert_stores_equal(jb, tb)
        assert tp.paged_rescues >= 1
        assert tp.text(key) == tb.text(key) == "abcdef"
        assert tp.extract_all() == tb.extract_all() == jp.extract_all()
        assert tcounters.get("serving.paged_rescues") == \
            jcounters.get("serving.paged_rescues") >= 1
        assert tcounters.latency_snapshot()["serving.paged_rescue"][
            "count"] >= 1

    def test_mid_burst_ring_overflow_rolls_back_and_rescues(self):
        from fluidframework_tpu_torch.mergetree.host import (
            flatten_snapshot_content)

        def ops(b):
            out, seq = [], 0
            for _ in range(300):  # > max_t -> K = 2 scanned chunks
                seq += 1
                out.append(b.insert_text(0, "y", seq - 1, GOD_CLIENT, seq))
            for i in range(6):  # the ring fills in chunk 2
                seq += 1
                out.append(b.annotate(0, 4, {f"k{i}": i}, seq - 1,
                                      GOD_CLIENT, seq))
            return {("d", "s", "burst-anno"): out}

        jp, tp = pair(paged=True)
        tb = make(tseq)
        apply_both((jp, tp, tb), ops)
        assert_stores_equal(jp, tp)
        key = ("d", "s", "burst-anno")
        assert tp.paged_rescues >= 1
        assert tp.text(key) == tb.text(key)
        assert flatten_snapshot_content(tp.extract_all()[key]) \
            == flatten_snapshot_content(tb.extract_all()[key])

    def test_seed_then_apply_matches_bucketed(self):
        entries = [{"text": "hello paged world", "props": {"x": 1}}]
        key = ("doc", "s", "seeded")
        stores = pair(paged=True) + pair()
        for s in stores:
            assert s.seed(key, entries, 0, 4)
        apply_both(stores, lambda b: {
            key: [b.remove(0, 6, 4, GOD_CLIENT, 5)]})
        assert_stores_equal(stores[0], stores[1])
        assert_stores_equal(stores[2], stores[3])
        assert stores[1].text(key) == stores[3].text(key) == "paged world"

    def test_fragmentation_then_compact_releases_pages(self):
        key = ("doc", "s", "frag")
        stores = pair(paged=True, page_rows=16)
        for s in stores:
            b = s.builder
            ops = [b.insert_text(i, "x", i, GOD_CLIENT, i + 1)
                   for i in range(80)]
            s.apply({key: ops})
            before = len(s.pages.tables[key])
            assert before >= 5
            s.apply({key: [b.remove(0, 76, 80, GOD_CLIENT, 81, msn=81)]})
            s._compact_tick_paged()
            assert s.text(key) == "xxxx"
            assert len(s.pages.tables[key]) < before
            assert s.pages.counts[key] <= 16
            assert s.page_compactions >= 1
        assert_stores_equal(*stores)
        assert tcounters.get("zamboni.rows_reclaimed") == \
            jcounters.get("zamboni.rows_reclaimed") > 0

    def test_warm_paged_apply_does_not_retrace(self):
        stores = pair(paged=True)
        seq = 0

        def wave(b):
            out = {}
            for d in range(3):
                ops = []
                for i in range(2):
                    s = seq + 2 * d + i + 1
                    ops.append(b.insert_text(0, "a", s - 1, GOD_CLIENT, s))
                out[("doc", "s", f"w{d}")] = ops
            return out

        apply_both(stores, wave)  # the first signature
        for c in (jcounters, tcounters):
            c.reset()
        tledger.reset()
        jledger.reset()
        for _ in range(4):
            seq += 6
            apply_both(stores, wave)
        assert tcounters.get("kernel.paged_apply.retraces") == \
            jcounters.get("kernel.paged_apply.retraces") == 0
        t_sym = tledger.snapshot()["symbols"]["kernel.paged_apply"]
        j_sym = jledger.snapshot()["symbols"]["kernel.paged_apply"]
        assert t_sym["coldCalls"] + t_sym["warmCalls"] == \
            j_sym["coldCalls"] + j_sym["warmCalls"] == 4
        assert_stores_equal(*stores)


# ---------------------------------------------------------------------------
# tests/test_tpu_serving.py::TestHostFold, at the store
# ---------------------------------------------------------------------------

class TestHostFold:
    def _typing_session(self, s, rng, n, txt, batch=4):
        """n single-client inserts at random positions, `batch` a window,
        msn trailing by one (the TpuLocalServer session's shape)."""
        key = ("doc", "default", "text")
        b = s.builder
        length, seq = 0, 0
        for start in range(0, n, batch):
            ops = []
            for i in range(start, min(n, start + batch)):
                seq += 1
                pos = rng.randrange(length + 1)
                t = txt(i)
                ops.append(b.insert_text(pos, t, seq - 1, 0, seq,
                                         msn=seq - 1))
                length += len(t)
            s.apply({key: ops})
        return key

    def test_sustained_typing_stays_in_small_bucket(self):
        stores = pair()
        for s in stores:
            key = self._typing_session(s, random.Random(11), 400,
                                       lambda i: f"x{i % 10}")
            b, _ = s.where[key]
            assert s.folds > 0, "fold never fired"
            assert b <= s.capacities.index(s.fold_min_capacity)
        assert_stores_equal(*stores)
        assert len(stores[1].text(key)) == 800

    def test_fold_preserves_props_and_segmentation_boundaries(self):
        key = ("doc", "default", "text")
        oracle = MergeTreeOracle(local_client=GOD)
        rng = random.Random(13)
        schedule, length, seq = [], 0, 0
        for i in range(260):
            seq += 1
            schedule.append(("insert", length, f"w{i % 10}", seq - 1, 0,
                             seq))
            length += 2
            if i % 7 == 0 and length > 8:
                seq += 1
                start = rng.randrange(length - 6)
                schedule.append(("annotate", start, start + 4,
                                 {"b": i % 3}, seq - 1, 0, seq))
        apply_to_oracle(oracle, schedule)
        stores = pair()
        for s in stores:
            for at in range(0, len(schedule), 8):
                ops = stream(s.builder, schedule[at:at + 8])
                ops = [op._replace(msn=op.seq - 1) for op in ops]
                s.apply({key: ops})
            assert s.folds > 0
        assert_stores_equal(*stores)
        snap = stores[1].extract_all()[key]
        assert snap == stores[0].extract_all()[key]
        server = [(e.get("text", ""), e.get("props"))
                  for chunk in snap["chunks"] for e in chunk
                  if e.get("removedSeq") is None]
        client = [(e.get("text", ""), e.get("props"))
                  for e in oracle.snapshot_segments()
                  if e.get("removedSeq") is None]

        def flat(runs):
            return [(ch, tuple(sorted(p.items())) if p else None)
                    for t, p in runs for ch in t]

        assert flat(server) == flat(client)

    def test_fold_frees_superseded_payload_generation(self):
        key = ("d", "s", "t")
        stores = pair(capacities=(8, 64), lanes_per_bucket=1)
        gens = []
        for s in stores:
            s.fold_min_capacity = 64
            seq = 0
            for _ in range(12):
                ops, seq = typing(s.builder, seq, 6, "ab")
                s.apply({key: ops})
            assert s.folds >= 1 and s.fold_rows_reclaimed > 0
            gen1 = list(s._fold_payloads[key])
            freed = []
            orig_free = s.payloads.free
            s.payloads.free = lambda i, f=orig_free: (freed.append(i), f(i))
            for _ in range(12):
                ops, seq = typing(s.builder, seq, 6, "cd")
                s.apply({key: ops})
            assert s.folds >= 2
            gen2 = set(s._fold_payloads[key])
            assert gen2 != set(gen1)
            assert set(gen1) <= set(freed) | gen2
            assert s.text(key) == "cd" * 72 + "ab" * 72
            gens.append((gen1, freed))
        assert gens[0] == gens[1]
        assert_stores_equal(*stores)

    @pytest.mark.parametrize("payload", ["ascii", "héllo·wörld"])
    def test_inline_fold_equivalence_and_non_ascii_arena(self, payload):
        from fluidframework_tpu.mergetree import catchup as jcatchup
        stores = pair()
        rows = []
        for s, cu in zip(stores, (jcatchup, tcatchup)):
            rng = random.Random(37)
            key = ("doc", "default", "text")
            b, length, seq = s.builder, 0, 0
            for i in range(120):
                seq += 1
                pos = rng.randrange(length + 1)
                ops = [b.insert_text(pos, payload[i % len(payload)],
                                     seq - 1, 0, seq, msn=seq - 1)]
                length += 1
                if i % 9 == 0 and length > 6:
                    seq += 1
                    start = rng.randrange(length - 4)
                    ops.append(b.annotate(start, start + 3, {"k": i % 2},
                                          seq - 1, 0, seq, msn=seq - 1))
                s.apply({key: ops})
            bi, lane = s.where[key]
            row = s.buckets[bi].row(lane)
            mseq = int(np.asarray(row.min_seq))
            folded = cu.extract_entries(row, s.payloads, mseq, fold=True)
            perrow = cu.coalesce_entries(cu.extract_entries(row, s.payloads,
                                                            mseq))
            assert cu.coalesce_entries(folded) == perrow
            rows.append(perrow)
        assert rows[0] == rows[1]
        assert_stores_equal(*stores)

    def test_payload_id_compaction_renumbers_and_shrinks(self):
        stores = pair()
        key = None
        for s in stores:
            key = self._typing_session(s, random.Random(41), 500,
                                       lambda i: f"p{i % 10}")
            before = len(s.payloads.entries)
            assert s.compact_payload_ids()
            assert len(s.payloads.entries) < before // 3
            assert not s._blocks and not s._lane_blocks
            gen = s._fold_payloads.get(key)
            assert gen is None or all(i < len(s.payloads.entries)
                                      for i in gen)
        assert_stores_equal(*stores)
        # Editing continues exactly after the renumbering.
        for s in stores:
            rng = random.Random(5)
            b = s.builder
            seq = 500
            length = len(s.text(key))
            for _ in range(40):
                ops = []
                for _ in range(5):
                    seq += 1
                    if length > 10 and rng.random() < 0.3:
                        start = rng.randrange(length - 4)
                        ops.append(b.remove(start, start + 2, seq - 1, 0,
                                            seq, msn=seq - 1))
                        length -= 2
                    else:
                        ops.append(b.insert_text(rng.randrange(length + 1),
                                                 "Z", seq - 1, 0, seq,
                                                 msn=seq - 1))
                        length += 1
                s.apply({key: ops})
            s.payload_compact_every = 1
            s.payload_compact_min_entries = 0
            s.compact_all()
        assert_stores_equal(*stores)
        assert stores[1].payload_compactions >= 2

    def test_fold_preserves_overlap_removers(self):
        key = ("d", "s", "t")
        stores = pair(capacities=(64,), lanes_per_bucket=1)
        for s in stores:
            s.fold_min_capacity = 64
            b = s.builder
            ops = [b.insert_text(0, "ABCDEFGH", 0, 0, 1, msn=0)]
            for q in range(2, 51):
                ops.append(b.insert_text(6 + q, "z", q - 1, 0, q,
                                         msn=q - 1))
            ops.append(b.remove(2, 5, 50, 1, 51, msn=50))
            ops.append(b.remove(2, 5, 50, 2, 52, msn=50))
            s.apply({key: ops})
            removed = [e for e in s.entries(key) if "removedSeq" in e]
            assert removed[0].get("removedOverlapClients") == [2]
            seq, vlen = 52, 8 + 49
            while s.folds == 0:
                chunk = []
                for _ in range(6):
                    seq += 1
                    chunk.append(b.insert_text(vlen, "z", 50, 0, seq,
                                               msn=50))
                    vlen += 1
                s.apply({key: chunk})
                assert seq < 600, "fold never fired"
            seq += 1
            s.apply({key: [b.insert_text(3, "!", 50, 2, seq, msn=50)]})
            assert s.text(key).startswith("ABF!")
        assert_stores_equal(*stores)

    def test_collection_defers_during_chunked_apply(self):
        key = ("d", "s", "t")
        stores = pair(capacities=(8, 64, 1024), lanes_per_bucket=1,
                      t_buckets=(1, 4, 16, 64))
        for s in stores:
            s.fold_min_capacity = 64
            s.compact_every = 1
            s.payload_compact_every = 1
            s.payload_compact_min_entries = 0
            s.apply({key: [s.builder.insert_text(0, "xy", q, 0, q + 1,
                                                 msn=q)
                           for q in range(300)]})
            assert s.text(key) == "xy" * 300
            assert s.compact_payload_ids() is True
            assert s.text(key) == "xy" * 300
        assert_stores_equal(*stores)

    def test_extract_guard_defers_frees_and_collection(self):
        key = ("d", "s", "t")
        stores = pair(capacities=(8, 64), lanes_per_bucket=1)
        deferred = []
        for s in stores:
            s.fold_min_capacity = 64
            seq = 0
            for _ in range(12):
                ops, seq = typing(s.builder, seq, 6, "ab")
                s.apply({key: ops})
            assert s.folds >= 1
            s.extract_guard_acquire()
            assert s.text(key) == "ab" * 72
            assert s.compact_payload_ids() is False
            for _ in range(12):
                ops, seq = typing(s.builder, seq, 6, "ab")
                s.apply({key: ops})
            assert s._deferred_frees
            deferred.append(list(s._deferred_frees))
            assert s.text(key) == "ab" * 144
            s.extract_guard_release()
            assert s.compact_payload_ids() is True
            assert not s._deferred_frees
            for _ in range(2):
                ops, seq = typing(s.builder, seq, 6, "ab")
                s.apply({key: ops})
            assert s.text(key) == "ab" * 156
        assert deferred[0] == deferred[1]
        assert_stores_equal(*stores)

    def test_arena_blocks_age_out(self):
        """note_block registers a fast-path arena block; folds release a
        lane's refs and aging materializes the rest, identically."""
        from fluidframework_tpu.mergetree.host import \
            MergeArenaBlock as JBlock
        from fluidframework_tpu_torch.mergetree.host import \
            MergeArenaBlock as TBlock

        def block(cls, texts):
            arena = "".join(texts).encode()
            off = np.cumsum([0] + [len(t) for t in texts[:-1]])
            n = len(texts)
            return cls(np.zeros(n, np.int32), off.astype(np.int32),
                       np.asarray([len(t) for t in texts], np.int32),
                       arena, [b""], np.zeros(n, np.int32),
                       np.full(n, -1, np.int32), np.full(n, -1, np.int32))

        keys = [("d", "s", f"t{i}") for i in range(3)]
        stores = pair(capacities=(8, 64), lanes_per_bucket=2)
        for s, cls, hostop in zip(stores, (JBlock, TBlock),
                                  (jseq.HostOp, tseq.HostOp)):
            s.fold_min_capacity = 64
            s.block_age_ticks = 2
            s.compact_every = 2
            seq = {k: 0 for k in keys}
            for w in range(6):
                texts = [f"{w}{k[2]}{i}" for k in keys for i in range(3)]
                blk = block(cls, texts)
                base = s.payloads.add_block(blk)
                lane_ids, streams = {}, {}
                for j, k in enumerate(keys):
                    if j == 2 and w > 1:
                        continue   # an idle lane: only aging frees it
                    ids = [base + 3 * j + i for i in range(3)]
                    lane_ids[k] = ids
                    ops = []
                    for op_id in ids:
                        seq[k] += 1
                        ops.append(hostop(
                            1, seq[k], seq[k] - 1, 0, 0, 0, op_id,
                            len(texts[op_id - base]), 0, seq[k] - 1))
                    streams[k] = ops
                s.note_block(blk, lane_ids)
                s.apply(streams)
            assert s.blocks_aged > 0
            assert len(s._blocks) <= s.block_age_ticks * s.compact_every + 4
        assert_stores_equal(*stores, texts=False)
        for k in keys:
            assert stores[0].text(k) == stores[1].text(k)
        assert stores[0].extract_all() == stores[1].extract_all()


# ---------------------------------------------------------------------------
# tests/test_tpu_serving.py::TestOverflowRecovery, at the store
# ---------------------------------------------------------------------------

class TestOverflowRecovery:
    def test_lane_promotes_through_buckets(self):
        stores = pair()
        key = ("doc", "default", "text")
        for s in stores:
            s.FOLD_NUM = 10 ** 9
            s.fold_min_capacity = 10 ** 9
            rng = random.Random(3)
            b, length, seq = s.builder, 0, 0
            for i in range(300):
                seq += 1
                s.apply({key: [b.insert_text(rng.randrange(length + 1),
                                             f"x{i % 10}", seq - 1, 0,
                                             seq, msn=seq - 1)]})
                length += 2
            bi, lane = s.where[key]
            assert bi > 0, "the lane never promoted"
            assert not bool(np.asarray(s.buckets[bi].state.overflow)[lane])
        assert_stores_equal(*stores)

    def test_freed_merge_lane_zeroed_before_reuse(self):
        a, b = ("d", "s", "a"), ("d", "s", "b")
        stores = pair(capacities=(8,), lanes_per_bucket=1)
        for s in stores:
            s.apply({a: [s.builder.insert_text(0, "SECRET", 0, 0, 1)]})
            assert s.text(a) == "SECRET"
            s.drop(a)
            s.apply({b: [s.builder.insert_text(0, "clean", 0, 0, 2)]})
            assert s.where[b] == (0, 0)
            assert s.text(b) == "clean"
            assert text_of(s.extract_all()[b]) == "clean"
        assert_stores_equal(*stores)

    def test_compaction_avoids_promotion_for_transient_growth(self):
        key = ("doc", "default", "text")
        stores = pair()
        for s in stores:
            b, seq = s.builder, 0
            for _ in range(40):
                seq += 2
                s.apply({key: [b.insert_text(0, "abcdefgh", seq - 2, 0,
                                             seq - 1, msn=seq - 2),
                               b.remove(0, 8, seq - 1, 0, seq,
                                        msn=seq - 1)]})
            s.compact_all()
            bi, lane = s.where[key]
            assert int(np.asarray(s.buckets[bi].state.count)[lane]) <= 4
            assert s.text(key) == ""
        assert_stores_equal(*stores)

    def test_exhausted_lane_degrades_to_opaque(self):
        """A window the widest bucket cannot hold and the host rescue
        cannot fit: the lane goes opaque and counts an overflow drop."""
        key = ("d", "s", "big")
        stores = pair(capacities=(8, 16), lanes_per_bucket=1,
                      t_buckets=(1, 4, 16, 64))
        for s in stores:
            s.fold_min_capacity = 16
            ops = [s.builder.insert_text(0, "ab", q, q % 3, q + 1)
                   for q in range(40)]
            s.apply({key: ops})
            assert key in s.opaque and key not in s.where
            assert s.overflow_drops == 1
        assert_stores_equal(*stores)


# ---------------------------------------------------------------------------
# tests/test_narrow_wire.py::TestDirtyEpochNeverStale
# ---------------------------------------------------------------------------

class TestDirtyEpochNeverStale:
    def test_clean_lane_rides_cache_dirty_lane_reassembles(self):
        a, b = ("d", "s", "a"), ("d", "s", "b")
        out = []
        for s, c in zip(pair(capacities=(64,)), (jcounters, tcounters)):
            s.apply({a: [s.builder.insert_text(0, "alpha ", 0, 0, 1)],
                     b: [s.builder.insert_text(0, "beta ", 0, 0, 1)]})
            first = s.extract_all()
            assert s.dirty_keys() == set()
            h0 = c.get("summarize.blob_cache.hits")
            second = s.extract_all()
            assert second == first
            assert c.get("summarize.blob_cache.hits") - h0 == 2
            s.apply({a: [s.builder.insert_text(0, "X", 1, 0, 2)]})
            assert s.dirty_keys() == {a}
            third = s.extract_all()
            assert text_of(third[a]) == "Xalpha "
            assert third[b] == first[b]
            assert s.cached_blob_count() == 2
            out.append((first, third, c.get("summarize.blob_cache.hits"),
                        c.get("summarize.blob_cache.misses"),
                        c.get("summarize.dirty_docs")))
        assert out[0] == out[1]

    def test_fold_crowded_marks_dirty(self):
        key = ("d", "s", "t")
        stores = pair(capacities=(64, 256))
        for s in stores:
            seq = 0
            for _ in range(120):
                seq += 1
                s.apply({key: [s.builder.insert_text(0, "x", seq - 1, 0,
                                                     seq)]})
            expect = s.text(key)
            assert text_of(s.extract_all()[key]) == expect
            seq += 1
            s.apply({key: [s.builder.insert_text(len(expect), "!", seq - 1,
                                                 0, seq, msn=seq - 1)]})
            expect = s.text(key)
            s.flushes_since_compact = s.compact_every
            s.compact_all()
            if s.folds:
                # The fold advanced the change generation.
                assert s.change_gen.get(key, 0) > \
                    s.last_summarized_gen.get(key, 0)
            assert text_of(s.extract_all()[key]) == expect
        assert_stores_equal(*stores)

    def test_rescue_lane_marks_dirty(self):
        key = ("d", "s", "t")
        stores = pair(capacities=(16,), lanes_per_bucket=1)
        for s in stores:
            seq = 0
            for _ in range(4):
                seq += 1
                s.apply({key: [s.builder.insert_text(0, "ab", seq - 1, 0,
                                                     seq)]})
            s.extract_all()
            gen_before = s.change_gen.get(key, 0)
            row = s.buckets[0].row(s.where[key][1])
            s.buckets[0].free(s.where[key][1])
            s.where.pop(key)
            seq += 1
            ops = [s.builder.insert_text(0, "Z", seq - 1, 0, seq)]
            assert s._rescue_lane(key, row, ops)
            assert s.change_gen.get(key, 0) > gen_before
            assert text_of(s.extract_all()[key]).startswith("Z")
        assert_stores_equal(*stores)

    def test_dropped_lane_evicts_cache(self):
        key = ("d", "s", "t")
        for s in pair():
            s.apply({key: [s.builder.insert_text(0, "gone", 0, 0, 1)]})
            s.extract_all()
            assert key in s._snap_cache
            s.drop(key)
            assert key not in s._snap_cache
            assert key not in s.last_summarized_gen
            assert s.extract_all() == {}


# ---------------------------------------------------------------------------
# the store cases of tests/test_device_stats.py
# ---------------------------------------------------------------------------

def _dev_counters(c):
    return {k: v for k, v in c.snapshot().items()
            if k.startswith(("device.", "host.", "zamboni."))}


class TestPagedPlane:
    def test_paged_apply_reconciles_and_stays_bit_identical(self):
        rng = random.Random(5)
        schedules = {("doc", "s", "storm"): random_schedule(rng, 3, 90)}
        for i in range(6):
            schedules[("doc", "s", f"k{i}")] = random_schedule(rng, 2, 5)

        def run(pkg, ds, c, on):
            c.reset()
            ds.set_enabled(on)
            s = make(pkg, paged=True, page_rows=16)
            s.apply({k: stream(s.builder, v) for k, v in schedules.items()})
            return s, _dev_counters(c)

        for on in (False, True):
            js, j_snap = run(jseq, jds, jcounters, on)
            ts, t_snap = run(tseq, tds, tcounters, on)
            assert_stores_equal(js, ts)
            assert t_snap == j_snap
        assert sum(t_snap.get(f"device.paged.{s}", 0)
                   for s in tds.PAGED_SLOTS[:6]) > 0
        for slot in tds.PAGED_SLOTS[:7]:
            assert t_snap.get(f"device.paged.{slot}", 0) == \
                t_snap.get(f"host.paged.{slot}", 0), slot
        assert t_snap.get("device.paged.reconcile_mismatch", 0) == 0


class TestExtractPlane:
    def _ops(self, b):
        return {("doc", "s", "gc"): [
            b.insert_text(0, "aaaa", 0, GOD_CLIENT, 1, msn=0),
            b.insert_text(4, "bbbb", 1, GOD_CLIENT, 2, msn=0),
            b.insert_text(8, "cccc", 2, GOD_CLIENT, 3, msn=0),
            b.remove(4, 8, 3, GOD_CLIENT, 4, msn=4)]}

    @pytest.mark.parametrize("paged", [False, True])
    def test_reclaimed_rows_reported_exactly(self, paged):
        stores = pair(paged=paged)
        apply_both(stores, self._ops)
        snaps = []
        for s, c in zip(stores, (jcounters, tcounters)):
            c.reset()
            out = s.extract_all()
            assert text_of(out[("doc", "s", "gc")]) == "aaaacccc"
            snaps.append((out, _dev_counters(c)))
        assert snaps[0] == snaps[1]
        assert snaps[1][1]["device.extract.rows_reclaimed"] == 1
        assert "zamboni.rows_reclaimed" not in snaps[1][1]
        assert_stores_equal(*stores)

    def test_extract_plane_absent_when_disabled(self):
        for ds in (jds, tds):
            ds.set_enabled(False)
        stores = pair()
        apply_both(stores, self._ops)
        for s, c in zip(stores, (jcounters, tcounters)):
            c.reset()
            s.extract_all()
            assert not any(k.startswith("device.extract")
                           for k in c.snapshot())


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def _refuse(*_a, **_k):
    raise ValueError("scan_apply: refused shape")


def _ring_storm(b, key):
    ops = [b.insert_text(0, "abcdef", 0, GOD_CLIENT, 1)]
    for i in range(6):
        ops.append(b.annotate(0, 6, {f"k{i}": i}, 1, GOD_CLIENT, 2 + i))
    return {key: ops}


class TestRescueHandlers:
    """The rescue handlers degrade a lane for unmodelable content and for a
    table too small for its rows, never for a kernel's refusal."""

    @pytest.mark.parametrize("paged", [False, True])
    def test_kernel_refusal_inside_rescue_propagates(self, monkeypatch,
                                                     paged):
        key = ("d", "s", "anno")
        s = make(tseq, paged=paged)
        monkeypatch.setattr(tkernel, "apply_ops_keep", _refuse)
        with pytest.raises(ValueError, match="scan_apply: refused"):
            s.apply(_ring_storm(s.builder, key))
        assert key not in s.opaque and s.overflow_drops == 0

    def test_kernel_refusal_in_direct_rescue_call_propagates(
            self, monkeypatch):
        key = ("d", "s", "t")
        s = make(tseq, capacities=(16,), lanes_per_bucket=1)
        s.apply({key: [s.builder.insert_text(0, "ab", 0, 0, 1)]})
        row = s.buckets[0].row(0)
        monkeypatch.setattr(tkernel, "apply_ops_keep", _refuse)
        with pytest.raises(ValueError, match="scan_apply: refused"):
            s._rescue_lane(key, row, [s.builder.insert_text(0, "Z", 1, 0,
                                                            2)])

    @pytest.mark.parametrize("exc", [
        tcatchup.Unmodelable("ring"), CapacityExceeded("9 > 8")])
    @pytest.mark.parametrize("paged", [False, True])
    def test_degrade_errors_make_the_lane_opaque(self, monkeypatch, paged,
                                                 exc):
        key = ("d", "s", "anno")
        s = make(tseq, paged=paged)

        def fail(*_a, **_k):
            raise exc

        monkeypatch.setattr(tcatchup, "apply_host_ops", fail)
        s.apply(_ring_storm(s.builder, key))
        assert key in s.opaque and key not in s.where
        assert s.overflow_drops == 1
        assert isinstance(CapacityExceeded("x"), ValueError)

    def test_batched_apply_refusal_propagates(self, monkeypatch):
        s = make(tseq)
        monkeypatch.setattr(tkernel, "_scan_ops", _refuse)
        with pytest.raises(ValueError, match="scan_apply: refused"):
            s.apply({("d", "s", "t"): [s.builder.insert_text(0, "a", 0, 0,
                                                             1)]})


def test_stage_paged_groups_matches_store_staging():
    """testing/serving.stage_paged_groups stages what the store's own
    _stage_paged_group + pack_ops stage for the same streams (one group
    of one chunk, one group of a K-chunk burst)."""
    store = make(tseq, paged=True, page_rows=16)
    b = store.builder
    streams = {("d", "s", f"k{i}"): [b.insert_text(0, "ab", q, 0, q + 1)
                                     for q in range(3 + i)]
               for i in range(3)}
    streams[("d", "s", "long")] = [b.insert_text(0, "x", q, 0, q + 1)
                                   for q in range(600)]
    pg = store.pages
    for key in streams:
        store.lane_for(key)
    groups = serving.stage_paged_groups(pg, streams)
    assert len(groups) == 2
    for g in groups:
        n_pad, pids, counts, mins, seqs = store._stage_paged_group(g.keys)
        assert np.array_equal(g.page_ids, pids)
        for got, want in ((g.counts, counts), (g.min_seqs, mins),
                          (g.seqs, seqs)):
            assert np.array_equal(got, want)
        pad = [streams[k] for k in g.keys] + \
            [[] for _ in range(n_pad - len(g.keys))]
        longest = max(len(x) for x in pad)
        t = tseq._bucket(min(longest, store.t_buckets[-1]),
                         store.t_buckets)
        k = -(-longest // t)
        if k == 1:
            want_ops = pack_ops(pad, steps=t)
        else:
            chunks = [pack_ops([x[c * t:(c + 1) * t] for x in pad], steps=t)
                      for c in range(k)]
            chunks += [pack_ops([[] for _ in pad], steps=t)
                       for _ in range(tseq.pow2_pages(k) - k)]
            want_ops = {f: np.stack([c[f] for c in chunks])
                        for f in chunks[0]}
        assert g.burst == (k > 1)
        assert sorted(g.ops) == sorted(want_ops)
        for f in want_ops:
            assert np.array_equal(g.ops[f], want_ops[f]), f


def test_counter_deltas_match_jax():
    """A ragged fleet through each store of both packages: the probes'
    call counts, the ledger's burst and extraction calls, the blob-cache
    and rescue counters agree."""
    schedules = ragged_fleet(2)
    snaps = []
    for pkg, c, led in ((jseq, jcounters, jledger),
                        (tseq, tcounters, tledger)):
        c.reset()
        led.reset()
        for paged in (False, True):
            s = make(pkg, paged=paged)
            s.apply({k: stream(s.builder, v) for k, v in schedules.items()})
            s.extract_all()
            s.apply({("doc", "s", "k0"): [s.builder.insert_text(
                0, "q", 50, GOD_CLIENT, 51)]})
            s.extract_all()
        syms = led.snapshot()["symbols"]
        calls = {name: syms[name]["coldCalls"] + syms[name]["warmCalls"]
                 for name in ("kernel.merge_apply_batched",
                              "kernel.paged_apply", "kernel.compact_extract",
                              "kernel.compact_extract_paged")
                 if name in syms}
        snap = c.snapshot()
        keep = {k: snap[k] for k in snap if k.startswith((
            "summarize.blob_cache", "summarize.dirty_docs",
            "serving.paged_rescues", "device.", "host.", "zamboni."))}
        snaps.append((calls, keep))
    assert snaps[0] == snaps[1]
    calls, keep = snaps[1]
    assert calls["kernel.merge_apply_batched"] > 0
    assert calls["kernel.paged_apply"] > 0
    assert keep["summarize.blob_cache.hits"] > 0
