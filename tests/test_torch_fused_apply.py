"""The port's fused apply (fluidframework_tpu_torch/mergetree/pallas_apply.py)
against the JAX package, bit for bit.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs apply_ops_fused_ref, the scan x vmap kernel, and (at one small shape)
the Pallas kernel in interpret mode. Inputs mirror tests/test_pallas_apply.py:
gen_traces batches, the random sequenced schedules of tests/test_kernel.py,
client-mode schedules with pending ops and acks, and overflow cases.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel, pallas_apply
from fluidframework_tpu.mergetree.constants import (DEV_UNASSIGNED,
                                                    UNASSIGNED_SEQ)
from fluidframework_tpu.mergetree.host import OpBuilder
from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.oppack import pack_ops as jax_pack_ops
from fluidframework_tpu.mergetree.oracle import MergeTreeOracle
from fluidframework_tpu.mergetree.state import make_state as jax_make_state

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import pallas_apply as tpa
from fluidframework_tpu_torch.mergetree.oppack import pack_ops
from fluidframework_tpu_torch.mergetree.state import DocState, make_state
from fluidframework_tpu_torch.testing.traces import gen_traces

from test_kernel import build_kernel_ops, random_schedule


def jax_to_np(tup):
    return {f: np.asarray(getattr(tup, f)) for f in tup._fields}


def assert_fields_equal(got: dict, want: dict, fields=DocState._fields):
    for name in fields:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def jax_packed(cols: dict) -> JaxPackedOps:
    return JaxPackedOps(**{f: jnp.asarray(cols[f])
                           for f in JaxPackedOps._fields})


def fresh_state_np(capacity, anno_slots, batch, overlap_slots=3):
    return jax_to_np(jax_make_state(capacity, anno_slots, overlap_slots,
                                    batch=batch))


def port_apply(state_np: dict, ops_np: dict) -> dict:
    state = interop.doc_state_from_numpy(state_np, device="cpu")
    ops = interop.packed_ops_from_numpy(ops_np, device="cpu")
    return interop.to_numpy(tpa.apply_ops_fused(state, ops))


def jax_refs(state_np: dict, ops_np: dict):
    """(apply_ops_fused_ref, apply_ops_batched_keep) outputs as numpy."""
    from fluidframework_tpu.mergetree.state import DocState as JaxDocState
    st = JaxDocState(**{f: jnp.asarray(v) for f, v in state_np.items()})
    ops = jax_packed(ops_np)
    return (jax_to_np(pallas_apply.apply_ops_fused_ref(st, ops)),
            jax_to_np(kernel.apply_ops_batched_keep(st, ops)))


def client_mode_streams(rng: random.Random, n_ops: int):
    """A local client's replica (client 1) with pending local inserts,
    removes and annotates, remote ops from client 2 sequenced between them,
    and acks of the oldest pending op: positions valid at each op's own
    perspective (tracked with the scalar oracle)."""
    tree = MergeTreeOracle(local_client=1)
    builder = OpBuilder()
    ops, pending = [], []
    for _ in range(n_ops):
        cur = tree.current_seq
        length = tree.get_length()
        choice = rng.random()
        if pending and choice < 0.25:
            seq = cur + 1
            kind, local = pending.pop(0)
            tree.ack(seq)
            if kind == "insert":
                ops.append(builder.ack_insert(local, seq, msn=cur))
            elif kind == "remove":
                ops.append(builder.ack_remove(local, seq, msn=cur))
            else:
                ops.append(builder.ack_annotate(local, seq, msn=cur))
        elif choice < 0.6:
            # local pending op at the local perspective
            if length == 0 or rng.random() < 0.5:
                pos = rng.randint(0, length)
                text = "".join(rng.choice("xyz")
                               for _ in range(rng.randint(1, 4)))
                tree.insert_text(pos, text, cur, 1, UNASSIGNED_SEQ)
                op = builder.insert_text(pos, text, cur, 1, DEV_UNASSIGNED)
                pending.append(("insert", op.local_seq))
            elif rng.random() < 0.7:
                start = rng.randint(0, length - 1)
                end = rng.randint(start + 1, min(length, start + 4))
                tree.remove_range(start, end, cur, 1, UNASSIGNED_SEQ)
                op = builder.remove(start, end, cur, 1, DEV_UNASSIGNED)
                pending.append(("remove", op.local_seq))
            else:
                start = rng.randint(0, length - 1)
                end = rng.randint(start + 1, min(length, start + 4))
                props = {"k": rng.randint(0, 3)}
                tree.annotate_range(start, end, props, cur, 1,
                                    UNASSIGNED_SEQ)
                op = builder.annotate(start, end, props, cur, 1,
                                      DEV_UNASSIGNED)
                pending.append(("annotate", op.op_id))
            ops.append(op)
        else:
            # remote op from client 2, sequenced now
            seq = cur + 1
            ref = rng.randint(max(0, cur - 3), cur)
            rlen = tree.get_length(ref_seq=ref, client=2)
            if rlen == 0 or rng.random() < 0.5:
                pos = rng.randint(0, rlen)
                text = "".join(rng.choice("abc")
                               for _ in range(rng.randint(1, 4)))
                tree.insert_text(pos, text, ref, 2, seq)
                ops.append(builder.insert_text(pos, text, ref, 2, seq,
                                               msn=ref))
            else:
                start = rng.randint(0, rlen - 1)
                end = rng.randint(start + 1, min(rlen, start + 5))
                tree.remove_range(start, end, ref, 2, seq)
                ops.append(builder.remove(start, end, ref, 2, seq, msn=ref))
            tree.update_seq(seq)
    return ops


def rich_inputs(seed: int, capacity: int = 256, anno_slots: int = 8):
    rng = random.Random(seed + 500)
    tuples = random_schedule(rng, n_clients=4, n_ops=40)
    host_ops = build_kernel_ops(OpBuilder(), tuples)
    cols = pack_ops([host_ops, host_ops[: len(host_ops) // 2]])
    return fresh_state_np(capacity, anno_slots, 2), cols


class TestPackOps:
    def test_matches_jax_pack_ops(self):
        rng = random.Random(3)
        streams = [client_mode_streams(rng, 30), client_mode_streams(rng, 12)]
        want = jax_to_np(jax_pack_ops(streams))
        assert_fields_equal(pack_ops(streams), want, JaxPackedOps._fields)

    def test_too_many_ops_raises(self):
        rng = random.Random(4)
        with pytest.raises(ValueError):
            pack_ops([client_mode_streams(rng, 10)], steps=5)


class TestFusedPlainConformance:
    @pytest.mark.parametrize("seed,b,t,cap", [(0, 16, 32, 64),
                                              (1, 8, 64, 128),
                                              (2, 32, 16, 64)])
    def test_trace_batches(self, seed, b, t, cap):
        state, cols = fresh_state_np(cap, 2, b), gen_traces(b, t, seed=seed)
        got = port_apply(state, cols)
        ref, scan = jax_refs(state, cols)
        assert_fields_equal(got, ref)
        assert_fields_equal(got, scan)

    @pytest.mark.parametrize("seed", range(6))
    def test_rich_schedules(self, seed):
        """Annotates (ring + LWW), overlapping removes, concurrent
        inserts: the random sequenced schedules of tests/test_kernel.py."""
        state, cols = rich_inputs(seed)
        got = port_apply(state, cols)
        ref, scan = jax_refs(state, cols)
        assert_fields_equal(got, ref)
        assert_fields_equal(got, scan)

    @pytest.mark.parametrize("seed", range(4))
    def test_client_mode_pending_and_acks(self, seed):
        rng = random.Random(seed + 900)
        streams = [client_mode_streams(rng, 48) for _ in range(3)]
        state, cols = fresh_state_np(128, 2, 3), pack_ops(streams)
        got = port_apply(state, cols)
        ref, scan = jax_refs(state, cols)
        assert_fields_equal(got, ref)
        assert_fields_equal(got, scan)
        assert (cols["seq"] == DEV_UNASSIGNED).any()

    def test_overflow_flag(self):
        state, cols = fresh_state_np(16, 2, 4), gen_traces(4, 40, seed=3)
        got = port_apply(state, cols)
        ref, scan = jax_refs(state, cols)
        assert_fields_equal(got, ref)
        assert_fields_equal(got, scan)
        assert got["overflow"].any()

    def test_annotate_ring_overflow(self):
        """Ring depth 1 under an annotate-heavy schedule."""
        rng = random.Random(77)
        tuples = random_schedule(rng, n_clients=3, n_ops=60)
        cols = pack_ops([build_kernel_ops(OpBuilder(), tuples)])
        state = fresh_state_np(256, 1, 1)
        got = port_apply(state, cols)
        ref, scan = jax_refs(state, cols)
        assert_fields_equal(got, ref)
        assert_fields_equal(got, scan)


class TestFusedPallasInterpret:
    def test_interpret_kernel_matches(self):
        from fluidframework_tpu.mergetree.state import DocState as JaxDoc
        state, cols = fresh_state_np(64, 2, 8), gen_traces(8, 20, seed=0)
        want = jax_to_np(pallas_apply.apply_ops_fused_pallas(
            JaxDoc(**{f: jnp.asarray(v) for f, v in state.items()}),
            jax_packed(cols), interpret=True))
        assert_fields_equal(port_apply(state, cols), want)


class TestWrapper:
    def test_cpu_wrapper_is_plain_and_pure(self):
        state = make_state(64, 2, batch=4, device="cpu")
        ops = interop.packed_ops_from_numpy(gen_traces(4, 12, seed=9), "cpu")
        before = interop.to_numpy(state)
        a = interop.to_numpy(tpa.apply_ops_fused(state, ops))
        b = interop.to_numpy(tpa.apply_ops_fused_plain(state, ops))
        assert_fields_equal(a, b)
        assert_fields_equal(interop.to_numpy(state), before)  # not mutated

    def test_capacity_limit(self):
        limit = tpa.max_fused_capacity(3, 1)
        # (8 + 3 + 1 + 2) planes x 4 B per slot inside 227 KB
        assert limit == (232_448 - 512) // 56
        assert tpa.max_fused_capacity(3, 8) < limit
        state = make_state(limit + 1, 1, batch=1, device="cpu")
        ops = interop.packed_ops_from_numpy(gen_traces(1, 2), "cpu")
        with pytest.raises(ValueError, match=str(limit)):
            tpa.apply_ops_fused(state, ops)
        with pytest.raises(ValueError):
            tpa.max_fused_capacity(9, 1)

    def test_output_dtypes(self):
        state = make_state(32, 1, batch=2, device="cpu")
        ops = interop.packed_ops_from_numpy(gen_traces(2, 5), "cpu")
        out = tpa.apply_ops_fused(state, ops)
        for name, t in zip(DocState._fields, out):
            assert t.dtype == (torch.bool if name == "overflow"
                               else torch.int32), name
            assert t.is_contiguous(), name


# ---------------------------------------------------------------------------
# the runs= (INSERT_RUN) and extract=True variants
# ---------------------------------------------------------------------------

def _slot_key(s):
    """A RunSlot or HostOp of either package as plain tuples."""
    return (tuple(map(tuple, s.ops)) if type(s).__name__ == "RunSlot"
            else tuple(s))


def keystroke_runs(n_docs, n_ops, seed):
    """Per-document keystroke traces of the JAX package (typing bursts,
    pastes, deletes, format sweeps; 1 or 2 clients), run-packed by both
    packages: ((port, JAX) slots per doc, port numpy columns, port run
    columns)."""
    from fluidframework_tpu.mergetree.catchup import wire_to_host_ops
    from fluidframework_tpu.mergetree.host import PayloadTable
    from fluidframework_tpu.mergetree.oppack import (
        pack_run_slots as jax_pack_run_slots)
    from fluidframework_tpu.testing.traces import keystroke_trace

    from fluidframework_tpu_torch.mergetree.oppack import (pack_run_slots,
                                                            pack_slots)
    docs = []
    for d in range(n_docs):
        builder = OpBuilder(PayloadTable())
        ops = []
        for op, s, r, c, m in keystroke_trace(n_ops, seed=seed + d,
                                              n_clients=1 + d % 2):
            ops.extend(wire_to_host_ops(builder, op, s, r, c, m))
        ours, theirs = pack_run_slots(ops, base_seq=0), \
            jax_pack_run_slots(ops, base_seq=0)
        assert [_slot_key(s) for s in ours] == \
            [_slot_key(s) for s in theirs]
        docs.append((ours, theirs))
    t = max(len(s) for s, _ in docs)
    packed = [pack_slots(s, steps=t) for s, _ in docs]
    cols = {f: np.stack([p[f] for p, _ in packed]) for f in packed[0][0]}
    runs = {f: np.stack([r[f] for _, r in packed]) for f in packed[0][1]}
    return docs, cols, runs


def _jax_runs(runs):
    from fluidframework_tpu.mergetree.oppack import RunCols as JaxRunCols
    return JaxRunCols(*(jnp.asarray(runs[f]) for f in JaxRunCols._fields))


def _port_runs(runs):
    from fluidframework_tpu_torch.mergetree.oppack import RunCols
    return RunCols(*(torch.from_numpy(runs[f]) for f in RunCols._fields))


class TestFusedInsertRun:
    def test_pack_slots_matches_jax(self):
        from fluidframework_tpu.mergetree.oppack import (
            pack_slots as jax_pack_slots)
        from fluidframework_tpu_torch.mergetree.oppack import (RUN_MIN,
                                                                pack_slots)
        docs, _, _ = keystroke_runs(3, 40, seed=40)
        assert RUN_MIN == 5
        for slots, jax_slots in docs:
            cols, runs = pack_slots(slots, steps=len(slots) + 2)
            want_cols, want_runs = jax_pack_slots(jax_slots,
                                                  steps=len(slots) + 2)
            assert_fields_equal(cols, jax_to_np(want_cols),
                                JaxPackedOps._fields)
            assert_fields_equal(runs, jax_to_np(want_runs),
                                ("length", "seq", "op_id"))

    @pytest.mark.parametrize("source,seed,capacity", [
        ("keystroke", 300, 256), ("keystroke", 310, 64),
        ("gen_run_traces", 3, 256)])
    def test_runs_plain_matches_scan_kernel(self, source, seed, capacity):
        """The plain INSERT_RUN apply against kernel._scan_ops(runs=), on
        run-packed keystroke traces and on the run traces chip_smoke.py
        feeds the kernel: at C=64 the count + RUN_K + 1 capacity gate
        trips."""
        from fluidframework_tpu_torch.testing.traces import gen_run_traces
        if source == "keystroke":
            _, cols, runs = keystroke_runs(4, 60, seed)
        else:
            cols, runs = gen_run_traces(8, 40, seed=seed)
        assert (cols["kind"] == 6).any()
        state = fresh_state_np(capacity, 4, cols["kind"].shape[0])
        from fluidframework_tpu.mergetree.state import DocState as JaxDoc
        want = jax_to_np(kernel._scan_ops(
            JaxDoc(**{f: jnp.asarray(v) for f, v in state.items()}),
            jax_packed(cols), batched=True, runs=_jax_runs(runs)))
        got = interop.to_numpy(tpa.apply_ops_fused(
            interop.doc_state_from_numpy(state, "cpu"),
            interop.packed_ops_from_numpy(cols, "cpu"),
            runs=_port_runs(runs)))
        assert_fields_equal(got, want)
        if capacity == 64:
            assert got["overflow"].any()

    @pytest.mark.parametrize("with_runs", [False, True])
    def test_extract_matches_interpret_kernel(self, with_runs):
        """runs= and extract=True against the Pallas kernel itself
        (interpret mode), narrow outputs included."""
        from fluidframework_tpu.mergetree.state import DocState as JaxDoc
        if with_runs:
            _, cols, runs = keystroke_runs(3, 24, seed=320)
        else:
            cols, runs = gen_traces(4, 12, seed=5), None
        b = cols["kind"].shape[0]
        state = fresh_state_np(64, 4, b)
        want_state, want_narrow = pallas_apply.apply_ops_fused_pallas(
            JaxDoc(**{f: jnp.asarray(v) for f, v in state.items()}),
            jax_packed(cols), interpret=True,
            runs=None if runs is None else _jax_runs(runs), extract=True)
        got_state, got_narrow = tpa.apply_ops_fused(
            interop.doc_state_from_numpy(state, "cpu"),
            interop.packed_ops_from_numpy(cols, "cpu"),
            runs=None if runs is None else _port_runs(runs), extract=True)
        assert_fields_equal(interop.to_numpy(got_state),
                            jax_to_np(want_state))
        for g, w in zip(got_narrow, want_narrow):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_run_slot_not_found_flags_overflow(self):
        """An INSERT_RUN whose position lies past the document: no
        tie-break slot, state unchanged, overflow set (as JAX)."""
        from fluidframework_tpu.mergetree.state import DocState as JaxDoc
        from fluidframework_tpu_torch.mergetree.oppack import RUN_K
        t = 2
        cols = {f: np.zeros((1, t), np.int32) for f in JaxPackedOps._fields}
        cols.update(kind=np.array([[1, 6]], np.int32),
                    seq=np.array([[1, 9]], np.int32),
                    ref_seq=np.array([[0, 1]], np.int32),
                    new_len=np.array([[3, 5]], np.int32),
                    pos1=np.array([[0, 7]], np.int32),
                    op_id=np.array([[0, -1]], np.int32))
        runs = {"length": np.zeros((1, t, RUN_K), np.int32),
                "seq": np.zeros((1, t, RUN_K), np.int32),
                "op_id": np.full((1, t, RUN_K), -1, np.int32)}
        runs["length"][0, 1, :5] = 1
        runs["seq"][0, 1, :5] = np.arange(5, 10)
        state = fresh_state_np(32, 1, 1)
        want = jax_to_np(kernel._scan_ops(
            JaxDoc(**{f: jnp.asarray(v) for f, v in state.items()}),
            jax_packed(cols), batched=True, runs=_jax_runs(runs)))
        got = interop.to_numpy(tpa.apply_ops_fused(
            interop.doc_state_from_numpy(state, "cpu"),
            interop.packed_ops_from_numpy(cols, "cpu"),
            runs=_port_runs(runs)))
        assert_fields_equal(got, want)
        assert got["overflow"][0] and got["count"][0] == 1

    def test_variant_names_and_cpu_counts(self):
        ops = interop.packed_ops_from_numpy(gen_traces(2, 3), "cpu")
        state = make_state(32, 1, batch=2, device="cpu")
        tpa.reset_launches()
        out, narrow = tpa.apply_ops_fused(state, ops, extract=True)
        assert tpa.apply_ops_fused.launches == 0  # no kernel on the CPU
        assert narrow[0].dtype == torch.int16
        assert [n.dtype for n in narrow[1:]] == [torch.int32] * 3
        assert tpa.variant_name(None, False) == "plain"
        assert tpa.variant_name(object(), True) == "runs_extract"
        assert set(tpa.apply_ops_fused.variant_launches) == {
            "plain", "runs", "extract", "runs_extract"}


# ---------------------------------------------------------------------------
# the fuzzed tables and op streams that chip_smoke.py holds both kernel
# paths to, through the plain version against JAX
# ---------------------------------------------------------------------------

class TestFuzzConformance:
    """fuzz_tables (empty and near-full documents) under gen_fuzz_traces
    (every op kind, four clients, pending local ops and their acks, stale
    perspectives, positions past the end, INSERT_RUN steps with dead
    members): the port's plain version equals the JAX references."""

    @pytest.mark.parametrize("capacity,k,a,seed", [
        (1, 3, 1, 0), (33, 3, 1, 1), (64, 3, 4, 2), (100, 3, 4, 3)])
    def test_fuzz_matches_refs(self, capacity, k, a, seed):
        from fluidframework_tpu_torch.testing.traces import (
            fuzz_tables, gen_fuzz_traces)
        state = fuzz_tables(6, capacity, k, a, seed=seed)
        cols = gen_fuzz_traces(6, 24, seed=seed, length=state["count"] * 2)
        assert (cols["seq"] == DEV_UNASSIGNED).any()
        assert np.isin([1, 2, 3, 4, 5], cols["kind"]).all()
        got = port_apply(state, cols)
        ref, scan = jax_refs(state, cols)
        assert_fields_equal(got, ref)
        assert_fields_equal(got, scan)

    @pytest.mark.parametrize("capacity,a,seed", [(33, 1, 5), (64, 4, 6),
                                                 (100, 4, 7)])
    def test_fuzz_runs_match_scan_kernel(self, capacity, a, seed):
        from fluidframework_tpu.mergetree.state import DocState as JaxDoc
        from fluidframework_tpu_torch.testing.traces import (
            fuzz_tables, gen_fuzz_traces)
        state = fuzz_tables(6, capacity, 3, a, seed=seed)
        cols, runs = gen_fuzz_traces(6, 24, seed=seed, runs=True,
                                     length=state["count"] * 2)
        assert (cols["kind"] == 6).any() and (runs["length"] == 0).any()
        want = jax_to_np(kernel._scan_ops(
            JaxDoc(**{f: jnp.asarray(v) for f, v in state.items()}),
            jax_packed(cols), batched=True, runs=_jax_runs(runs)))
        got = interop.to_numpy(tpa.apply_ops_fused(
            interop.doc_state_from_numpy(state, "cpu"),
            interop.packed_ops_from_numpy(cols, "cpu"),
            runs=_port_runs(runs)))
        assert_fields_equal(got, want)
        assert got["overflow"].any()


def test_chip_smoke_live_slots_steps_the_plain_body():
    """chip_smoke.live_slots replays the plain body (with its whole-axis
    lane context) to count each op's slots for the fused apply's bound:
    the rows in use plus the two an op may add, capped at C."""
    import chip_smoke
    cols = gen_traces(4, 6, seed=3)
    state = interop.doc_state_from_numpy(fresh_state_np(64, 1, 4), "cpu")
    ops = interop.packed_ops_from_numpy(cols, "cpu")
    slots = chip_smoke.live_slots(state, ops)
    assert slots.shape == (4, 6)
    assert (slots[:, 0] == 2).all() and (slots <= 64).all()
