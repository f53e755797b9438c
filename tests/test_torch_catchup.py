"""The port's bulk catch-up (fluidframework_tpu_torch/mergetree/catchup.py)
against the JAX package's mergetree/catchup.py on the CPU: the same tail
through both device_apply_tail (and apply_host_ops) must give the same
snapshot entries, dict for dict, and their visible text must equal the JAX
package's scalar MergeTreeClient replay.

The cases mirror tests/test_bulk_catchup.py's engine cases that need no
loader (contended metadata, props resolution, pending local inserts,
removes and annotates, item payloads, the refusals) and its INSERT_RUN
packing cases (run heads, a rival insert at a run boundary, run overflow
escalating to a wider bucket), on keystroke traces of 1-2k ops from one
and three clients. On the CPU the port's chunks run its plain scan; on the
card the same code runs kernels/csrc/scan_apply.cu (chip_smoke.py phase
11).
"""

import copy
import random

import pytest

from fluidframework_tpu.mergetree import catchup as jcatchup
from fluidframework_tpu.mergetree.client import (MergeTreeClient,
                                                 items_seg, make_insert_op,
                                                 make_remove_op, text_seg)
from fluidframework_tpu.mergetree.host import OpBuilder as JaxOpBuilder
from fluidframework_tpu.mergetree.host import PayloadTable as JaxPayloads
from fluidframework_tpu.mergetree.runs import \
    encode_entry_payloads as jax_encode
from fluidframework_tpu.testing.traces import \
    keystroke_trace as jax_keystroke_trace

from fluidframework_tpu_torch.core.errors import BulkApplyUnsupported
from fluidframework_tpu_torch.mergetree import catchup
from fluidframework_tpu_torch.mergetree.constants import SEG_MARKER
from fluidframework_tpu_torch.mergetree.host import OpBuilder, PayloadTable
from fluidframework_tpu_torch.mergetree.oppack import (HostOp, OpKind,
                                                       RunSlot,
                                                       pack_run_slots)
from fluidframework_tpu_torch.mergetree.runs import encode_entry_payloads
from fluidframework_tpu_torch.testing.traces import keystroke_trace

from test_bulk_catchup import sequenced_schedule


def both(entries, tail, min_seq=0, current_seq=0):
    """(port entries, JAX entries) for one tail; the port's stats too."""
    stats = {}
    got = catchup.device_apply_tail(copy.deepcopy(entries), tail, min_seq,
                                    current_seq, device="cpu", stats=stats)
    want = jcatchup.device_apply_tail(copy.deepcopy(entries), tail,
                                      min_seq, current_seq)
    return got, want, stats


def visible_text(entries) -> str:
    """The local view's text: pending local inserts are visible, removed
    (acked or pending) rows are not."""
    return "".join("￼" if e.get("kind") == SEG_MARKER else e["text"]
                   for e in entries if e.get("removedSeq") is None
                   and e.get("removedLocalSeq") is None)


def scalar_replay(tail, client=None):
    client = client or MergeTreeClient(client_id=99)
    for op, s, r, c, m in tail:
        client.apply_msg(op, s, r, c, min_seq=m)
    return client


def replica_pair(client_id, setup):
    """Two JAX scalar replicas in the same state (setup(client) applied to
    each): one to take its entries from, one to replay the tail on."""
    a, b = MergeTreeClient(client_id=client_id), \
        MergeTreeClient(client_id=client_id)
    for c in (a, b):
        setup(c)
    return a, b


@pytest.mark.parametrize("n_clients", [1, 3])
@pytest.mark.parametrize("seed,n_ops", [(0, 1000), (1, 1500), (2, 2000)])
def test_keystroke_trace_matches_jax_and_scalar(seed, n_ops, n_clients):
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    assert tail == jax_keystroke_trace(n_ops, seed=seed,
                                       n_clients=n_clients)
    got, want, stats = both([], tail)
    assert got == want
    assert visible_text(got) == scalar_replay(tail).get_text()
    assert sum(stats["chunks"].values()) >= 1


def test_apply_host_ops_matches_jax():
    """The rescue path's entry point: prebuilt HostOps over a payload
    table, seeded from non-empty entries with an acked removal in the
    collab window."""
    tail = keystroke_trace(700, seed=4, n_clients=2)
    head, rest = tail[:300], tail[300:]
    entries = scalar_replay(head).tree.snapshot_segments()
    outs = []
    for mod, builder_cls, payload_cls in (
            (catchup, OpBuilder, PayloadTable),
            (jcatchup, JaxOpBuilder, JaxPayloads)):
        payloads = payload_cls()
        builder = builder_cls(payloads)
        ops = [o for op, s, r, c, m in rest
               for o in mod.wire_to_host_ops(builder, op, s, r, c, m)]
        kwargs = {"device": "cpu"} if mod is catchup else {}
        outs.append(mod.apply_host_ops(copy.deepcopy(entries), ops,
                                       payloads, head[-1][4], head[-1][1],
                                       **kwargs))
    assert outs[0] == outs[1]
    assert visible_text(outs[0]) == scalar_replay(tail).get_text()


class TestEngine:
    def test_bulk_preserves_contended_metadata(self):
        _, tail = sequenced_schedule(200, window=50)
        got, want, _stats = both([], tail)
        assert got == want
        assert any("seq" in e for e in got)
        assert any("removedSeq" in e for e in got)

    def test_props_resolution_matches_scalar(self):
        _, tail = sequenced_schedule(800, seed=5)
        got, want, _stats = both([], tail)
        assert got == want
        scalar = scalar_replay(tail, MergeTreeClient(client_id=99))

        def flat(entries):
            return [(ch, e.get("props")) for e in entries
                    if e.get("removedSeq") is None
                    for ch in (e.get("text") or "￼")]

        assert flat(got) == flat(scalar.tree.snapshot_segments())
        assert any(e.get("props") for e in got)

    def test_pending_local_state_rides_bulk(self):
        _, tail = sequenced_schedule(300, seed=7)
        head, rest = tail[:40], tail[40:]

        def setup(c):
            scalar_replay(head, c)
            c.insert_text_local(2, "PEND")
            c.remove_range_local(0, 2)

        source, scalar = replica_pair(99, setup)
        entries = source.tree.collab_segments()
        assert any("localSeq" in e for e in entries)
        assert any("removedLocalSeq" in e for e in entries)
        got, want, _stats = both(entries, rest, source.tree.min_seq,
                                 source.tree.current_seq)
        assert got == want
        assert visible_text(got) == scalar_replay(rest, scalar).get_text()

    def test_remote_won_remove_overwrites_pending(self):
        seed_op = make_insert_op(0, text_seg("abcdefghij"))

        def setup(c):
            c.apply_msg(seed_op, 1, 0, 1, min_seq=0)
            c.remove_range_local(2, 5)
            c.insert_text_local(0, "Z")

        source, scalar = replica_pair(9, setup)
        tail = [(make_remove_op(1, 7), 2, 1, 2, 0)]
        tail += [(make_insert_op(0, text_seg(f"[{i}]")), 3 + i, 2 + i, 2, 0)
                 for i in range(20)]
        got, want, _stats = both(source.tree.collab_segments(), tail,
                                 source.tree.min_seq,
                                 source.tree.current_seq)
        assert got == want
        assert visible_text(got) == scalar_replay(tail, scalar).get_text()

    def test_pending_annotates_ride_bulk(self):
        from fluidframework_tpu.mergetree.client import make_annotate_op

        def setup(c):
            c.apply_msg(make_insert_op(0, text_seg("hello world")), 1, 0,
                        0, min_seq=0)
            c.annotate_range_local(0, 5, {"bold": True})
            c.annotate_range_local(3, 8, {"size": 12})

        source, scalar = replica_pair(1, setup)
        tail = [(make_insert_op(i % 10, text_seg("x")), i + 2, 1, 7, 0)
                for i in range(20)]
        tail.insert(10, (make_annotate_op(0, 6, {"bold": False,
                                                 "other": 1}), 12, 1, 7, 0))
        tail = [(op, i + 2, 1, 7, 0)
                for i, (op, _, _, _, _) in enumerate(tail)]
        entries = source.tree.collab_segments()
        assert any("pendingAnnotates" in e for e in entries)
        got, want, _stats = both(entries, tail, source.tree.min_seq,
                                 source.tree.current_seq)
        assert got == want
        assert any("pendingAnnotates" in e for e in got)
        assert visible_text(got) == scalar_replay(tail, scalar).get_text()

    def test_items_payloads_ride_bulk(self):
        rng = random.Random(3)
        tail, count = [], 0
        for i in range(200):
            seq = i + 1
            if count > 4 and rng.random() < 0.3:
                a = rng.randrange(count - 2)
                b = a + 1 + rng.randrange(2)
                op = make_remove_op(a, b)
                count -= b - a
            else:
                vals = [i * 10 + j for j in range(rng.randrange(1, 4))]
                op = make_insert_op(rng.randrange(count + 1),
                                    items_seg(vals))
                count += len(vals)
            tail.append((op, seq, seq - 1, 1 + i % 2, max(0, seq - 8)))
        got, want, _stats = both([], tail)
        assert encode_entry_payloads(got) == jax_encode(want)
        scalar = scalar_replay(tail)

        def flat_items(entries):
            return [v for e in entries if e.get("removedSeq") is None
                    for v in e["text"]]

        assert flat_items(got) == \
            flat_items(scalar.tree.snapshot_segments())

    def test_unmodelable_tails_refuse(self):
        """What the device cannot represent raises Unmodelable (a
        BulkApplyUnsupported) in both packages, before any state is
        built: an op without a client ordinal, an unknown op type, a
        stable-id run payload on a text channel. (An own op sequenced into
        the tail is refused by MergeTreeClient.apply_bulk, which is not
        ported yet.)"""
        ok = (make_insert_op(0, text_seg("x")), 1, 0, 1, 0)
        bad_tails = [
            [ok, (make_insert_op(0, text_seg("y")), 2, 1, -1, 0)],
            [ok, ({"type": 7, "pos1": 0}, 2, 1, 1, 0)],
            [ok, (make_insert_op(0, {"run": [1, 2, 0, 3]}), 2, 1, 1, 0)],
        ]
        assert issubclass(catchup.Unmodelable, BulkApplyUnsupported)
        for tail in bad_tails:
            with pytest.raises(catchup.Unmodelable):
                catchup.device_apply_tail([], tail, 0, 0, device="cpu")
            with pytest.raises(jcatchup.Unmodelable):
                jcatchup.device_apply_tail([], tail, 0, 0)
        assert catchup.looks_like_merge_op(ok[0])
        assert not catchup.looks_like_merge_op({"type": 0})


class TestInsertRunPacking:
    @staticmethod
    def host_ops(tail):
        builder = OpBuilder(PayloadTable())
        return [o for op, s, r, c, m in tail
                for o in catchup.wire_to_host_ops(builder, op, s, r, c, m,
                                                  allow_items=True)]

    def test_typing_burst_packs_and_matches(self):
        tail = keystroke_trace(600, seed=21)
        slots = pack_run_slots(self.host_ops(tail), base_seq=0)
        assert any(isinstance(s, RunSlot) for s in slots)
        got, want, _stats = both([], tail)
        assert got == want
        assert visible_text(got) == scalar_replay(tail).get_text()

    def test_foreign_op_blocks_run_head(self):
        def mk(seq, ref, pos):
            return HostOp(kind=OpKind.INSERT, seq=seq, ref_seq=ref,
                          client=1, pos1=pos, op_id=seq, new_len=1)

        stream = [HostOp(kind=OpKind.REMOVE, seq=10, ref_seq=9, client=2,
                         pos1=0, pos2=1)]
        stream += [mk(11 + i, 5, i) for i in range(8)]
        assert not any(isinstance(s, RunSlot)
                       for s in pack_run_slots(stream, base_seq=4))
        stream2 = [stream[0]] + [mk(11 + i, 10 + i, i) for i in range(8)]
        assert any(isinstance(s, RunSlot)
                   for s in pack_run_slots(stream2, base_seq=4))

    def test_concurrent_insert_at_run_boundary_matches(self):
        base = [(make_insert_op(0, text_seg("0123456789")), 1, 0, 1, 0)]
        burst = [(make_insert_op(3 + i, text_seg(chr(97 + i))), 2 + i,
                  1 + i, 1, 0) for i in range(8)]
        rival = [(make_insert_op(3, text_seg("RIVAL")), 10, 1, 2, 0)]
        tail = base + burst + rival
        got, want, _stats = both([], tail)
        assert got == want
        assert visible_text(got) == scalar_replay(tail).get_text()

    def test_run_overflow_escalates_cleanly(self):
        """A run needs RUN_K + 1 rows of headroom: long bursts of runs stay
        exact through the capacity discipline (the overflow retry itself
        runs in tests/test_torch_golden.py's catch-up trace)."""
        tail, pos = [], 0
        for i in range(400):
            tail.append((make_insert_op(pos, text_seg("ab")), i + 1, i, 1,
                         max(0, i - 60)))
            pos += 2
        got, want, stats = both([], tail)
        assert got == want
        assert visible_text(got) == scalar_replay(tail).get_text()
        assert len(visible_text(got)) == 800
        assert sum(stats["chunks"].values()) >= 1


def test_host_extraction_matches_jax():
    """host.extract_text / extract_segments over a kernel-applied state
    (annotated, with a pending local insert) equal the JAX package's."""
    from fluidframework_tpu.mergetree import host as jhost
    from fluidframework_tpu.mergetree import kernel as jkernel
    from fluidframework_tpu.mergetree.oppack import pack_single as jpack
    from fluidframework_tpu.mergetree.state import make_state as jmake

    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import host, kernel
    from fluidframework_tpu_torch.mergetree.constants import DEV_UNASSIGNED
    from fluidframework_tpu_torch.mergetree.oppack import pack_single
    from fluidframework_tpu_torch.mergetree.state import make_state

    def build(builder):
        return [builder.insert_text(0, "hello world", 0, 1, 1),
                builder.insert_marker(5, 1, 2, 2, props={"m": 1}),
                builder.annotate(0, 4, {"b": True}, 2, 1, 3),
                builder.remove(7, 9, 3, 2, 4),
                builder.insert_text(2, "PEND", 4, 9, DEV_UNASSIGNED)]

    jb, tb = JaxOpBuilder(JaxPayloads()), OpBuilder(PayloadTable())
    jstate = jkernel.apply_ops_keep(jmake(32), jpack(build(jb), steps=8))
    tstate = kernel.apply_ops_keep(
        make_state(32, device="cpu"),
        interop.packed_ops_from_numpy(pack_single(build(tb), steps=8),
                                      "cpu"))
    for ref, client in ((None, host.GOD_CLIENT), (2, 1), (4, 9)):
        assert host.extract_text(tstate, tb.payloads, ref, client) == \
            jhost.extract_text(jstate, jb.payloads, ref, client)
        assert host.extract_segments(tstate, tb.payloads, ref, client) == \
            jhost.extract_segments(jstate, jb.payloads, ref, client)
    assert "PEND" in host.extract_text(tstate, tb.payloads, 4, 9)
