"""The port's MergeTreeClient (fluidframework_tpu_torch/mergetree/client.py)
and cost model (mergetree/costmodel.py) against the JAX package's, on the
CPU.

- tests/test_client.py's cases (wire ops, ack pairing, snapshot load,
  reconnect resubmission, the reconnect farm) run twice from one seed,
  once on the port's clients and once on the JAX package's: the wire ops
  submitted, the texts and the pending state must be equal, and the
  original assertions hold.
- tests/test_bulk_catchup.py::TestEngine's client-level cases run
  `apply_bulk` on the port (device="cpu": the plain scan) and on the JAX
  package: text, snapshot entries, regenerated ops and later acks equal.
- TestCostModel: the CPU rule and the override carry over as they are.
  The JAX assertions at backend="tpu" do not: the port's crossover is
  written from its own fitted formula (the H100 figures in costmodel.py),
  not from the TPU's 70 ms dispatch floor.
Tolerance: exact equality (host dicts, strings and ints).
"""

import copy
import random

import pytest

from fluidframework_tpu.mergetree.client import MergeTreeClient as JaxClient
from fluidframework_tpu.mergetree.runs import \
    encode_entry_payloads as jax_encode

from fluidframework_tpu_torch.mergetree import catchup, costmodel
from fluidframework_tpu_torch.mergetree.client import (
    MergeTreeClient, items_seg, make_annotate_op, make_insert_op,
    make_remove_op, text_seg)
from fluidframework_tpu_torch.mergetree.runs import encode_entry_payloads

from test_bulk_catchup import sequenced_schedule


def port_client(cid):
    return MergeTreeClient(cid, device="cpu")


MAKERS = {"port": port_client, "jax": JaxClient}


class Sequencer:
    """tests/test_client.py's mini ordering service (per-client FIFO
    queues, random interleave, disconnect drops in-flight ops), which
    also logs every wire op it sequences."""

    def __init__(self, clients):
        self.clients = {c.client_id: c for c in clients}
        self.queues = {c.client_id: [] for c in clients}
        self.connected = {c.client_id: True for c in clients}
        self.buffered = {c.client_id: [] for c in clients}
        self.seq = 0
        self.log = []

    def submit(self, client_id, op, ref_seq):
        if self.connected[client_id]:
            self.queues[client_id].append((op, ref_seq))

    def disconnect(self, client_id):
        self.connected[client_id] = False
        self.queues[client_id].clear()

    def reconnect(self, client_id):
        self.connected[client_id] = True
        client = self.clients[client_id]
        for args in self.buffered[client_id]:
            client.apply_msg(*args)
        self.buffered[client_id].clear()
        for op in client.regenerate_pending_ops():
            self.submit(client_id, op, client.current_seq)

    def sequence_all(self, rng):
        while True:
            live = [cid for cid, q in self.queues.items() if q]
            if not live:
                break
            cid = rng.choice(live)
            op, ref_seq = self.queues[cid].pop(0)
            self.seq += 1
            self.log.append((op, self.seq, ref_seq, cid))
            for target_id, client in self.clients.items():
                args = (op, self.seq, ref_seq, cid)
                if self.connected[target_id]:
                    client.apply_msg(*args)
                elif target_id != cid:
                    self.buffered[target_id].append(args)


def both(scenario):
    """Run scenario(make_client) on the port's and the JAX package's
    clients; the two results must be equal. Returns the port's."""
    got = scenario(MAKERS["port"])
    assert got == scenario(MAKERS["jax"])
    return got


class TestClientBasics:
    def test_submit_ack_roundtrip(self):
        def scenario(make):
            a, b = make(0), make(1)
            seqr = Sequencer([a, b])
            op = a.insert_text_local(0, "hello")
            seqr.submit(0, op, a.current_seq)
            seqr.sequence_all(random.Random(0))
            return a.get_text(), b.get_text(), bool(a.tree.pending_groups), \
                seqr.log
        a_text, b_text, pending, _log = both(scenario)
        assert a_text == b_text == "hello" and not pending

    def test_delta_events(self):
        def scenario(make):
            a, b = make(0), make(1)
            events = []
            b.on("delta", lambda args, local: events.append(
                (args["op"], local)))
            seqr = Sequencer([a, b])
            seqr.submit(0, a.insert_text_local(0, "hi"), a.current_seq)
            seqr.sequence_all(random.Random(0))
            return events
        assert ("insert", False) in both(scenario)

    def test_snapshot_load(self):
        def scenario(make):
            a, b = make(0), make(1)
            seqr = Sequencer([a, b])
            seqr.submit(0, a.insert_text_local(0, "abcdef"), a.current_seq)
            seqr.submit(1, b.insert_text_local(0, "x"), b.current_seq)
            seqr.sequence_all(random.Random(1))
            snap = a.snapshot()
            c = type(a).load(snap, client_id=2)
            return c.get_text(), a.get_text(), snap
        loaded, text, _snap = both(scenario)
        assert loaded == text


class TestReconnect:
    def test_simple_resubmit(self):
        def scenario(make):
            a, b = make(0), make(1)
            seqr = Sequencer([a, b])
            rng = random.Random(0)
            a.insert_text_local(0, "lost?")
            seqr.disconnect(0)
            seqr.submit(1, b.insert_text_local(0, "BBB"), b.current_seq)
            seqr.sequence_all(rng)
            seqr.reconnect(0)
            seqr.sequence_all(rng)
            return a.get_text(), b.get_text(), seqr.log
        a_text, b_text, _log = both(scenario)
        assert a_text == b_text
        assert "lost?" in a_text and "BBB" in a_text

    def test_offline_edits_then_resubmit(self):
        def scenario(make):
            a, b = make(0), make(1)
            seqr = Sequencer([a, b])
            rng = random.Random(1)
            seqr.submit(0, a.insert_text_local(0, "base text"),
                        a.current_seq)
            seqr.sequence_all(rng)
            seqr.disconnect(0)
            a.remove_range_local(0, 5)
            a.insert_text_local(0, "my ")
            seqr.submit(1, b.insert_text_local(9, "!"), b.current_seq)
            seqr.submit(1, b.remove_range_local(0, 4), b.current_seq)
            seqr.sequence_all(rng)
            seqr.reconnect(0)
            seqr.sequence_all(rng)
            return a.get_text(), b.get_text(), seqr.log
        a_text, b_text, _log = both(scenario)
        assert a_text == b_text

    @pytest.mark.parametrize("seed", range(10))
    def test_reconnect_farm(self, seed):
        def scenario(make):
            rng = random.Random(seed)
            clients = [make(i) for i in range(4)]
            seqr = Sequencer(clients)
            for _rnd in range(6):
                for c in clients:
                    for _ in range(rng.randint(0, 2)):
                        length = c.get_length()
                        if length == 0 or rng.random() < 0.6:
                            pos = rng.randint(0, length)
                            text = "".join(rng.choice("abcdef") for _ in
                                           range(rng.randint(1, 3)))
                            op = c.insert_text_local(pos, text)
                        elif rng.random() < 0.8:
                            start = rng.randint(0, length - 1)
                            end = rng.randint(start + 1,
                                              min(length, start + 4))
                            op = c.remove_range_local(start, end)
                        else:
                            start = rng.randint(0, length - 1)
                            end = rng.randint(start + 1,
                                              min(length, start + 4))
                            op = c.annotate_range_local(
                                start, end, {"k": rng.randint(0, 3)})
                        seqr.submit(c.client_id, op, c.current_seq)
                for c in clients:
                    if seqr.connected[c.client_id]:
                        if rng.random() < 0.25:
                            seqr.disconnect(c.client_id)
                    elif rng.random() < 0.6:
                        seqr.reconnect(c.client_id)
                seqr.sequence_all(rng)
            for c in clients:
                if not seqr.connected[c.client_id]:
                    seqr.reconnect(c.client_id)
            seqr.sequence_all(rng)
            return [c.get_text() for c in clients], \
                [bool(c.tree.pending_groups) for c in clients], seqr.log
        texts, pending, _log = both(scenario)
        assert all(t == texts[0] for t in texts), f"seed {seed}: {texts}"
        assert not any(pending)


# ---------------------------------------------------------------------------
# apply_bulk: the port's (device="cpu") against the JAX package's
# ---------------------------------------------------------------------------

def replay(client, tail):
    for op, s, r, c, m in tail:
        client.apply_msg(op, s, r, c, min_seq=m)


def snapshot(client):
    entries = client.tree.snapshot_segments()
    enc = encode_entry_payloads if isinstance(client, MergeTreeClient) \
        else jax_encode
    return enc(entries)


def bulk_pair(setup, tail, with_scalar=True):
    """(port client, JAX client, JAX scalar client or None): each set up
    by setup(client); the two bulk clients apply the tail with
    apply_bulk, the scalar one op by op."""
    port, jax_bulk = port_client(99), JaxClient(99)
    scalar = JaxClient(99) if with_scalar else None
    for c in (port, jax_bulk, scalar):
        if c is not None:
            setup(c)
    port.apply_bulk(tail)
    jax_bulk.apply_bulk(tail)
    assert snapshot(port) == snapshot(jax_bulk)
    assert port.get_text() == jax_bulk.get_text()
    assert port.current_seq == jax_bulk.current_seq
    if scalar is not None:
        replay(scalar, tail)
        assert port.get_text() == scalar.get_text()
    return port, jax_bulk, scalar


def no_setup(_client):
    pass


class TestEngine:
    def test_bulk_matches_scalar_10k_ops(self):
        authority, tail = sequenced_schedule(10_000)
        port, _jax, _scalar = bulk_pair(no_setup, tail, with_scalar=False)
        assert port.get_text() == authority.get_text()
        assert port.current_seq == 10_000

    def test_bulk_preserves_contended_metadata(self):
        authority, tail = sequenced_schedule(200, window=50)
        port, jax_bulk, _scalar = bulk_pair(no_setup, tail)
        for i in range(60):
            op = make_insert_op(0, text_seg(f"<{i}>"))
            seq = 200 + i + 1
            for c in (authority, port, jax_bulk):
                c.apply_msg(op, seq, seq - 1, 1, min_seq=seq - 5)
        assert port.get_text() == authority.get_text()
        assert snapshot(port) == snapshot(jax_bulk)

    def test_props_resolution_matches_scalar(self):
        _authority, tail = sequenced_schedule(800, seed=5)
        port, _jax, scalar = bulk_pair(no_setup, tail)

        def flat(client):
            out = []
            for e in client.tree.snapshot_segments():
                if e.get("removedSeq") is not None:
                    continue
                props = e.get("props")
                out.extend((ch, props) for ch in (e.get("text") or "￼"))
            return out

        assert flat(port) == flat(scalar)

    def test_pending_local_state_rides_bulk(self):
        _authority, tail = sequenced_schedule(300, seed=7)
        head, rest = tail[:40], tail[40:]

        def setup(c):
            replay(c, head)
            c.insert_text_local(2, "PEND")
            c.remove_range_local(0, 2)

        port, jax_bulk, scalar = bulk_pair(setup, rest)
        assert port.regenerate_pending_ops() == \
            jax_bulk.regenerate_pending_ops() == \
            scalar.regenerate_pending_ops()
        assert port.get_text() == scalar.get_text()

    def test_remote_won_remove_keeps_group_slot(self):
        seed_op = make_insert_op(0, text_seg("abcdefghij"))

        def setup(c):
            c.update_client_id(9)
            c.apply_msg(seed_op, 1, 0, 1, min_seq=0)
            c.remove_range_local(2, 5)
            c.insert_text_local(0, "Z")

        tail = [(make_remove_op(1, 7), 2, 1, 2, 0)]
        tail += [(make_insert_op(0, text_seg(f"[{i}]")), 3 + i, 2 + i, 2,
                  0) for i in range(20)]
        port, jax_bulk, scalar = bulk_pair(setup, tail)
        last = tail[-1][1]
        for c in (port, jax_bulk, scalar):
            c.apply_msg(make_remove_op(2, 5), last + 1, 1, 9, min_seq=0)
            c.apply_msg(make_insert_op(0, text_seg("Z")), last + 2, 1, 9,
                        min_seq=0)
        assert port.get_text() == scalar.get_text() == jax_bulk.get_text()
        assert not port.tree.pending_groups
        assert snapshot(port) == snapshot(jax_bulk)

    def test_own_sequenced_ops_refuse_bulk(self):
        client = port_client(1)
        client.insert_text_local(0, "pending")
        tail = [(make_insert_op(0, text_seg("x")), 1, 0, 1, 0)]
        with pytest.raises(catchup.Unmodelable):
            client.apply_bulk(tail)

    def test_pending_annotates_ride_bulk(self):
        def setup(c):
            c.update_client_id(1)
            c.apply_msg(make_insert_op(0, text_seg("hello world")), 1, 0,
                        0, min_seq=0)
            c.annotate_range_local(0, 5, {"bold": True})
            c.annotate_range_local(3, 8, {"size": 12})

        tail = [(make_insert_op(i % 10, text_seg("x")), i + 2, 1, 7, 0)
                for i in range(20)]
        tail.insert(10, (make_annotate_op(0, 6, {"bold": False,
                                                 "other": 1}), 12, 1, 7, 0))
        tail = [(op, i + 2, 1, 7, 0)
                for i, (op, _, _, _, _) in enumerate(tail)]
        port, jax_bulk, scalar = bulk_pair(setup, tail)
        assert port.tree.snapshot_segments() == \
            scalar.tree.snapshot_segments()
        assert copy.deepcopy(port).regenerate_pending_ops() == \
            copy.deepcopy(jax_bulk).regenerate_pending_ops() == \
            copy.deepcopy(scalar).regenerate_pending_ops()
        last = tail[-1][1]
        for c in (port, jax_bulk, scalar):
            c.apply_msg(make_annotate_op(0, 5, {"bold": True}), last + 1,
                        1, 1, min_seq=0)
            c.apply_msg(make_annotate_op(3, 8, {"size": 12}), last + 2,
                        1, 1, min_seq=0)
        assert port.tree.snapshot_segments() == \
            scalar.tree.snapshot_segments()
        assert snapshot(port) == snapshot(jax_bulk)
        assert not port.tree.pending_groups

    def test_items_payloads_ride_bulk(self):
        rng = random.Random(3)
        tail = []
        count = 0
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
        port, jax_bulk = port_client(99), JaxClient(99)
        scalar = port_client(99)
        port.apply_bulk(tail)
        jax_bulk.apply_bulk(tail)
        replay(scalar, tail)
        assert snapshot(port) == snapshot(jax_bulk)

        def flat_items(client):
            out = []
            for e in client.tree.snapshot_segments():
                if e.get("removedSeq") is not None:
                    continue
                t = e.get("text")
                out.extend(t.values if hasattr(t, "values") else t)
            return out

        assert flat_items(port) == flat_items(scalar) == \
            flat_items(jax_bulk)
        assert port.get_length() == scalar.get_length()

    def test_bulk_runs_on_the_clients_device(self, monkeypatch):
        """apply_bulk hands the client's device to device_apply_tail; a
        client built without one asks for the card."""
        seen = []
        real = catchup.device_apply_tail

        def spy(*args, **kwargs):
            seen.append(kwargs.get("device"))
            return real(*args, **kwargs)

        monkeypatch.setattr(catchup, "device_apply_tail", spy)
        tail = [(make_insert_op(0, text_seg("x")), 1, 0, 1, 0)]
        port_client(5).apply_bulk(tail)
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MergeTreeClient(5).apply_bulk(tail)
        assert seen == ["cpu", None]


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def formula(tail_len, live):
    """The port's model, written out from its constants."""
    scalar_s = tail_len * (costmodel.SCALAR_BASE_S
                           + costmodel.SCALAR_PER_SEG_S * live)
    device_s = (-(-tail_len // catchup.CHUNK_T) * costmodel.DEVICE_CHUNK_S
                + tail_len * costmodel.DEVICE_PER_OP_S)
    return scalar_s > device_s * costmodel.HYSTERESIS


class TestCostModel:
    def test_cpu_never_routes_device(self, monkeypatch):
        monkeypatch.delenv("FLUID_TPU_FORCE_BULK", raising=False)
        for tail in (64, 1024, 100_000):
            for segs in (10, 3000):
                assert not costmodel.device_bulk_wins(tail, segs,
                                                      backend="cpu")

    def test_force_override(self, monkeypatch):
        monkeypatch.setenv("FLUID_TPU_FORCE_BULK", "1")
        assert costmodel.device_bulk_wins(1, 1, backend="cpu")
        monkeypatch.setenv("FLUID_TPU_FORCE_BULK", "0")
        assert not costmodel.device_bulk_wins(10**6, 10**5,
                                              backend="cuda")

    def test_crossover_follows_the_fitted_formula(self, monkeypatch):
        """The port's crossover, from its own constants (the JAX test's
        backend="tpu" figures do not carry over): the model equals the
        formula on a grid, None means the card, a tail routes to the
        device only past a live-segment crossover that falls as the tail
        grows, and past it every longer tail routes there too."""
        monkeypatch.delenv("FLUID_TPU_FORCE_BULK", raising=False)
        tails = (1, 64, 511, 512, 513, 4096, 100_000)
        for tail in tails:
            prev = False
            for live in (0, 10, 100, 1_000, 10_000, 100_000):
                got = costmodel.device_bulk_wins(tail, live, backend="cuda")
                assert got == formula(tail, live)
                assert got == costmodel.device_bulk_wins(tail, live)
                assert got or not prev   # monotone in live segments
                prev = got
        # Long tails over big documents route to the device; one op over
        # an empty document never does (it pays a whole chunk's floor).
        assert costmodel.device_bulk_wins(100_000, 100_000)
        assert not costmodel.device_bulk_wins(1, 0)
        # The live-segment crossover of a full chunk is no higher than
        # that of a single op.
        def crossover(tail):
            live = 0
            while not formula(tail, live):
                live = live * 2 + 1
            return live
        assert crossover(catchup.CHUNK_T) <= crossover(1)
