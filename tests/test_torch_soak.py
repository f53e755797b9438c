"""The port's soaks: a mirror of tests/test_soak.py.

The fixed-seed chaos scenarios run in tier-1, through both packages:
TestReconnectAvalancheChaos and TestHotDocumentChaos (the scalar
LocalServer behind a FaultyMessageLog and a virtual-clocked admission
controller), TestReconnectAvalancheReadChaos (catch-up artifacts under
reader avalanches on TpuLocalServer) and TestHotDocumentReadChaos (a
parked broadcaster shard that must shed, and gap-fill recovery). Each
scenario runs twice on the port and must reproduce bit for bit; the fault
fingerprints and the sequenced streams (or texts) must also equal the JAX
package's.

TestHotDocumentReadChaos leaves less to the shard's worker than the
reference does (ROADMAP Queue 3 item 7 lists the JAX test as
load-sensitive): the reference's worker races the writer for the
stalled burst's first message, and on a loaded host falls behind the
writer on an unstalled round, so its shed counts differ between runs.
Here a stalled round holds the shard's lock while its burst sequences
(the queue fills while the worker is parked, the scenario's stated
intent), and an unstalled round waits for each op's fan-out before the
next op; each stalled round then sheds its burst's overflow exactly and
no other round sheds. The shed counts are compared between the port's
runs only.

The randomized soaks stay opt-in behind the reference's gate (SOAK=1;
SOAK_TRIALS scales them), on the port: the bulk catch-up against the
scalar replay, the sequencer lambda's raw path against its object path,
the matrix, directory, items and interval sessions on TpuLocalServer,
the wire fuzz, the maintenance knobs, and TestMeshPlacementSoak (a paged
TpuLocalServer on a mesh of eight CPU entries, testing/shardcheck.py
checking every plane mid-traffic); TestServingSoak runs its pipelined
lambda's merge store under testing/lockcheck.py, with the guard map the
port's static analysis infers.

TestAsyncSummaryLockDiscipline is tier-1, as the reference's is: async
summaries in flight while the sequencing thread keeps flushing
(testing/lambda_runs.summary_overlap_run on the port's lambda), the
MergeLaneStore instrumented with the locksets the port's fluidlint
infers; the texts equal those of the same run uninstrumented.
"""

from __future__ import annotations

import json
import os
import random
import threading
from importlib import import_module
from types import SimpleNamespace

import pytest
import torch

from fluidframework_tpu_torch.mergetree.client import (
    OP_ANNOTATE, OP_INSERT, OP_REMOVE, MergeTreeClient, items_seg,
    make_annotate_op, make_insert_op, make_remove_op, text_seg)
from fluidframework_tpu_torch.protocol.messages import (Boxcar,
                                                        DocumentMessage,
                                                        MessageType)
from fluidframework_tpu_torch.telemetry import counters as port_counters
from fluidframework_tpu_torch.testing.server_runs import _Cfg

soak = pytest.mark.skipif(
    os.environ.get("SOAK") != "1",
    reason="randomized soak; set SOAK=1 (SOAK_TRIALS to scale)")

TRIALS = int(os.environ.get("SOAK_TRIALS", "10"))

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global: the flushes
    these tests drive must not reach another file's /health verdict on
    the same worker (tests/conftest.py resets only the JAX package's)."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


def package(name: str) -> SimpleNamespace:
    port = name == "fluidframework_tpu_torch"
    return SimpleNamespace(
        port=port, dev={"device": "cpu"} if port else {},
        messages=import_module(f"{name}.protocol.messages"),
        local_server=import_module(f"{name}.server.local_server"),
        admission=import_module(f"{name}.server.admission"),
        faultinject=import_module(f"{name}.testing.faultinject"),
        counters=import_module(f"{name}.telemetry.counters"),
        broadcaster=import_module(f"{name}.server.lambdas.broadcaster"),
        sequence=import_module(f"{name}.dds.sequence"),
        container=import_module(f"{name}.loader.container"),
        local_driver=import_module(f"{name}.loader.drivers.local"))


PORT = package("fluidframework_tpu_torch")
JAX = package("fluidframework_tpu")


# ---------------------------------------------------------------------------
# Fixed-seed chaos scenarios, tier-1.
# ---------------------------------------------------------------------------

def _chaos_server(pkg, plan, queue_limit=512):
    """LocalServer with the fault injector on the raw ingest topic and a
    virtual-clocked admission controller at the front door."""
    vclock = {"t": 0.0}
    adm = pkg.admission.AdmissionController(
        queue_limit=queue_limit, recover_after_s=0.1, interval_s=0.005,
        clock=lambda: vclock["t"])
    srv = pkg.local_server.LocalServer(auto_pump=False, admission=adm)
    srv.log = pkg.faultinject.FaultyMessageLog(srv.log, plan)
    return srv, adm, vclock


def _partial_pump(srv, limit):
    srv._deli_mgr.pumps[0].pump(limit=limit)
    for mgr in (srv._broadcaster_mgr, srv._scriptorium_mgr,
                srv._copier_mgr, srv._scribe_mgr):
        mgr.pump_all()


def _stable_cid(client_id):
    """client ids are `client-<counter>-<uuid8>`; the counter part is
    deterministic per run, the uuid suffix is not."""
    return client_id.rsplit("-", 1)[0] if client_id else None


class TestReconnectAvalancheChaos:
    """N clients on one document; the fault plan resets connections and
    drops, delays and duplicates raw deliveries. Every reset client
    reconnects in the same round (the avalanche) and resubmits what an
    observer has not yet seen sequenced. Every payload lands exactly
    once, both observers agree on the stream, queues stay bounded, and
    two same-seed runs are bit-identical, on both packages."""

    N_CLIENTS = 6
    ROUNDS = 25

    def _run(self, pkg, seed):
        M = pkg.messages
        plan = pkg.faultinject.FaultPlan(seed, drop=0.12, dup=0.12,
                                         delay=0.15, reset=0.12,
                                         max_delay_sends=4)
        srv, adm, vclock = _chaos_server(pkg, plan)
        obs_a = srv.connect("doc", {"mode": "read"})
        obs_b = srv.connect("doc", {"mode": "read"})
        seen_a, seen_b = [], []
        seen_payloads = set()

        def on_a(m):
            if m.type != M.MessageType.OPERATION:
                return
            seen_a.append((m.sequence_number, _stable_cid(m.client_id),
                           m.client_sequence_number))
            if isinstance(m.contents, dict) and "u" in m.contents:
                seen_payloads.add(m.contents["u"])

        obs_a.on("op", on_a)
        obs_b.on("op", lambda m: m.type == M.MessageType.OPERATION
                 and seen_b.append(
                     (m.sequence_number, _stable_cid(m.client_id),
                      m.client_sequence_number)))
        conns, csns, pending = {}, {}, {}
        for c in range(self.N_CLIENTS):
            conns[c] = srv.connect("doc")
            csns[c] = 0
            pending[c] = []
        srv.pump()

        def submit(c, uid):
            csns[c] += 1
            conns[c].submit([M.DocumentMessage(
                client_sequence_number=csns[c],
                reference_sequence_number=0,
                type=M.MessageType.OPERATION, contents={"u": uid})])

        uid = 0
        peak_backlog = 0
        for _ in range(self.ROUNDS):
            vclock["t"] += 0.02
            dropped = []
            for c in range(self.N_CLIENTS):
                uid += 1
                pending[c].append(uid)
                submit(c, uid)
                if plan.should_reset():
                    conns[c].disconnect()
                    dropped.append(c)
            peak_backlog = max(peak_backlog, srv.raw_backlog())
            _partial_pump(srv, limit=self.N_CLIENTS * 2)
            for c in dropped:
                conns[c] = srv.connect("doc")
                csns[c] = 0
            srv.pump()
            for c in range(self.N_CLIENTS):
                pending[c] = [u for u in pending[c]
                              if u not in seen_payloads]
                if c in dropped:
                    for u in list(pending[c]):
                        submit(c, u)
            srv.pump()
        # Release delayed deliveries first, then resubmit the remainder
        # in bounded retry rounds, each cooling the ladder one window.
        srv.log.flush_delayed()
        srv.pump()
        for _ in range(20):
            vclock["t"] += 0.2
            adm.observe(force=True)
            unacked = {c: [u for u in pending[c] if u not in seen_payloads]
                       for c in range(self.N_CLIENTS)}
            if not any(unacked.values()):
                break
            for c in range(self.N_CLIENTS):
                for u in unacked[c]:
                    submit(c, u)
            srv.log.flush_delayed()
            srv.pump()
        vclock["t"] += 1.0
        adm.observe(force=True)
        return {"fingerprint": plan.fingerprint(), "stream_a": seen_a,
                "stream_b": seen_b, "payloads": sorted(seen_payloads),
                "uid": uid, "peak_backlog": peak_backlog,
                "adm_state": adm.state}

    def test_converges_and_reproduces_bit_identically(self):
        a = self._run(PORT, 20260803)
        b = self._run(PORT, 20260803)
        assert a == b
        assert a == self._run(JAX, 20260803)
        assert a["stream_a"] == a["stream_b"]
        assert a["payloads"] == list(range(1, a["uid"] + 1))
        counts = {}
        for _, cid, csn in a["stream_a"]:
            counts[(cid, csn)] = counts.get((cid, csn), 0) + 1
        assert all(v == 1 for v in counts.values())
        seqs = [s for s, _, _ in a["stream_a"]]
        assert seqs == sorted(set(seqs))
        assert a["peak_backlog"] <= 512
        assert a["adm_state"] == PORT.admission.ACCEPT

    def test_different_seeds_diverge(self):
        assert self._run(PORT, 1)["fingerprint"] != \
            self._run(PORT, 2)["fingerprint"]


class TestHotDocumentChaos:
    """Every client hammers one document in plan-sized bursts while the
    injector delays and duplicates deliveries and stalls the drain: the
    backlog stays under the admission limit (shedding, not queueing),
    admitted ops sequence exactly once, and the run reproduces from its
    seed, equal to the JAX package's; the stalls go to a recording
    sleep."""

    N_CLIENTS = 4
    ROUNDS = 30
    QUEUE_LIMIT = 96

    def _run(self, pkg, seed):
        M, fi = pkg.messages, pkg.faultinject
        plan = fi.FaultPlan(seed, dup=0.15, delay=0.15, stall=0.3,
                            max_delay_sends=3)
        srv, adm, vclock = _chaos_server(pkg, plan,
                                         queue_limit=self.QUEUE_LIMIT)
        conns = [srv.connect("hot") for _ in range(self.N_CLIENTS)]
        srv.pump()
        sequenced, admitted, stalls, shed = [], set(), [], [0]
        conns[0].on("op", lambda m: m.type == M.MessageType.OPERATION
                    and sequenced.append(
                        (m.sequence_number, _stable_cid(m.client_id),
                         m.client_sequence_number)))
        csns = [0] * self.N_CLIENTS
        peak_backlog = 0
        for c in conns:
            c.on("nack", lambda n: shed.__setitem__(0, shed[0] + 1))
        for _ in range(self.ROUNDS):
            vclock["t"] += 0.02
            for ci in range(self.N_CLIENTS):
                for _ in range(1 + plan.pick(8, site="burst")):
                    csns[ci] += 1
                    before = shed[0]
                    conns[ci].submit([M.DocumentMessage(
                        client_sequence_number=csns[ci],
                        reference_sequence_number=0,
                        type=M.MessageType.OPERATION,
                        contents={"c": ci, "n": csns[ci]})])
                    if shed[0] == before:
                        admitted.add((ci, csns[ci]))
            peak_backlog = max(peak_backlog, srv.raw_backlog())
            if fi.stall(plan, sleep=stalls.append) > 0:
                _partial_pump(srv, limit=2)
            else:
                _partial_pump(srv, limit=self.N_CLIENTS * 6)
        srv.log.flush_delayed()
        srv.pump()
        return {"fingerprint": plan.fingerprint(), "sequenced": sequenced,
                "admitted": sorted(admitted), "peak_backlog": peak_backlog,
                "shed": shed[0], "stalls": stalls}

    def test_bounded_and_exactly_once_and_deterministic(self):
        a = self._run(PORT, 424242)
        assert a == self._run(PORT, 424242)
        assert a == self._run(JAX, 424242)
        assert a["shed"] > 0
        assert 0 < a["peak_backlog"] <= self.QUEUE_LIMIT
        got = {}
        for _, cid, csn in a["sequenced"]:
            got[(cid, csn)] = got.get((cid, csn), 0) + 1
        assert all(v == 1 for v in got.values())
        assert len({cid for _, cid, _ in a["sequenced"]}) == self.N_CLIENTS
        assert a["stalls"] and all(0.0005 <= s <= 0.004 for s in a["stalls"])


def _read_chaos_fleet(pkg, server, doc_id="doc", seed_text="base"):
    loader = pkg.container.Loader(
        pkg.local_driver.LocalDocumentServiceFactory(server), **pkg.dev)
    c = loader.create_detached(doc_id)
    ds = c.runtime.create_datastore("default")
    t = ds.create_channel("text", pkg.sequence.SharedString.TYPE)
    t.insert_text(0, seed_text)
    c.attach()
    return loader, c, t


class TestReconnectAvalancheReadChaos:
    """Reader containers on one document served through the catch-up
    artifact; every round the plan picks a burst of writer edits and a set
    of readers to drop, and the dropped set reloads at once against a
    refreshed artifact. Every reader ends on the writer's text, the
    avalanche rides the delta path, the refresh stays batched, and two
    same-seed runs are bit-identical, equal to the JAX package's."""

    N_READERS = 6
    ROUNDS = 8

    def _run(self, pkg, seed):
        plan = pkg.faultinject.FaultPlan(seed)
        server = pkg.local_server.TpuLocalServer(**pkg.dev)
        loader, writer, text = _read_chaos_fleet(pkg, server)
        readers = {r: loader.resolve("doc",
                                     client_details={"mode": "read"})
                   for r in range(self.N_READERS)}
        trace = []
        counters = pkg.counters
        adopted0 = counters.get("catchup.client.adopted")
        disp0 = counters.get("catchup.refresh_dispatches")
        for rnd in range(self.ROUNDS):
            burst = 4 + plan.pick(24, site="burst")
            for i in range(burst):
                text.insert_text(plan.pick(text.get_length() + 1,
                                           site="pos"), f"r{rnd}.{i} ")
            server.pump()
            st = server.refresh_catchup()
            dropped = [r for r in readers if plan.pick(3, site="drop") == 0]
            for r in dropped:
                readers[r].close()
            server.pump()
            for r in dropped:
                readers[r] = loader.resolve(
                    "doc", client_details={"mode": "read"})
            trace.append((burst, tuple(dropped), st["published"]))
        server.pump()
        texts = {r: c.runtime.get_datastore("default")
                 .get_channel("text").get_text()
                 for r, c in readers.items()}
        return {"fingerprint": plan.fingerprint(), "trace": trace,
                "final": text.get_text(), "texts": texts,
                "adoptions": counters.get("catchup.client.adopted")
                - adopted0,
                "dispatches": counters.get("catchup.refresh_dispatches")
                - disp0}

    def test_converges_and_reproduces_bit_identically(self):
        a = self._run(PORT, 20260804)
        assert a == self._run(PORT, 20260804)
        assert a == self._run(JAX, 20260804)
        assert all(t == a["final"] for t in a["texts"].values())
        assert a["adoptions"] > 0
        assert a["dispatches"] <= self.ROUNDS

    def test_different_seeds_diverge(self):
        assert self._run(PORT, 31)["fingerprint"] != \
            self._run(PORT, 32)["fingerprint"]


class TestHotDocumentReadChaos:
    """One hot document fanned out through the sharded broadcaster to a
    crowd of read-only containers; plan-chosen rounds run against a parked
    shard (its lock held while the round's burst sequences, module
    docstring), so the bounded queue sheds the burst's overflow. Readers that missed shed
    broadcasts recover through the delta manager's gap fetch and everyone
    converges; two same-seed runs reproduce bit for bit, and the plan and
    the texts equal the JAX package's."""

    N_READERS = 5
    ROUNDS = 6
    QUEUE_LIMIT = 8

    def _run(self, pkg, seed, park=True):
        plan = pkg.faultinject.FaultPlan(seed)
        server = pkg.local_server.TpuLocalServer(config=_Cfg({
            "broadcaster.shards": 2,
            "broadcaster.queueLimit": self.QUEUE_LIMIT}), **pkg.dev)
        loader, writer, text = _read_chaos_fleet(pkg, server, doc_id="hot")
        server.pump()
        server.drain_broadcast(20.0)
        readers = [loader.resolve("hot", client_details={"mode": "read"})
                   for _ in range(self.N_READERS)]
        lam = server.broadcasters[0]
        hot_shard = lam.shards[pkg.broadcaster.shard_for(
            "hot", len(lam.shards))]
        trace = []
        for rnd in range(self.ROUNDS):
            burst = 6 + plan.pick(18, site="burst")
            stall = plan.pick(2, site="stall") == 0
            gate = threading.Event()
            if stall:
                lam.join_room("hot", lambda m: gate.wait(30.0))
            shed0 = lam.shed_count()
            if stall and park:
                # The shard's worker cannot take a message while the
                # round's inserts sequence and fan out (auto_pump).
                with hot_shard.cond:
                    for i in range(burst):
                        text.insert_text(text.get_length(), f"h{rnd}.{i} ")
                    server.pump()
            else:
                for i in range(burst):
                    text.insert_text(text.get_length(), f"h{rnd}.{i} ")
                    if park:
                        # An unparked shard keeps up: each op is
                        # delivered before the next one sequences.
                        server.drain_broadcast(30.0)
                server.pump()
            if stall:
                gate.set()
                lam.leave_room("hot", list(lam.rooms["hot"])[-1])
            server.drain_broadcast(30.0)
            trace.append((burst, stall, lam.shed_count() - shed0))
            assert hot_shard.depth() <= self.QUEUE_LIMIT
        text.insert_text(text.get_length(), "END")
        server.pump()
        server.drain_broadcast(30.0)
        return {"fingerprint": plan.fingerprint(), "trace": trace,
                "final": text.get_text(),
                "reader_texts": [c.runtime.get_datastore("default")
                                 .get_channel("text").get_text()
                                 for c in readers],
                "shed": lam.shed_count()}

    def test_sheds_recovers_and_reproduces(self):
        a = self._run(PORT, 777)
        b = self._run(PORT, 777)
        assert a == b
        assert a["shed"] > 0
        assert all(t == a["final"] for t in a["reader_texts"])
        ref = self._run(JAX, 777, park=False)
        assert (ref["fingerprint"], ref["final"], ref["reader_texts"]) == \
            (a["fingerprint"], a["final"], a["reader_texts"])
        assert [r[:2] for r in ref["trace"]] == [r[:2] for r in a["trace"]]
        # A parked round sheds what the queue cannot hold of its burst;
        # a round on a live shard sheds nothing.
        assert [shed for _, _, shed in a["trace"]] == [
            max(0, burst - self.QUEUE_LIMIT) if stall else 0
            for burst, stall, _ in a["trace"]]
        assert any(stall for _, stall, _ in a["trace"])


# ---------------------------------------------------------------------------
# Randomized soaks, opt-in (SOAK=1).
# ---------------------------------------------------------------------------

def _flat(cl):
    out = []
    tree = cl.tree
    for seg in tree.segments:
        if tree.visible_length(seg, tree.current_seq, cl.client_id) > 0:
            payload = seg.text
            vals = (payload.values if hasattr(payload, "values")
                    else payload)
            props = dict(seg.props) if seg.props else None
            out.extend((v, props) for v in vals)
    return out


def _burst_schedule(rng, n_ops, n_clients=3):
    auth = MergeTreeClient(client_id=-1, device="cpu")
    tail = []
    seq = 0
    cursors = {c: 0 for c in range(1, n_clients + 1)}
    while len(tail) < n_ops:
        c = rng.randrange(1, n_clients + 1)
        if rng.random() < 0.6:  # typing burst, frozen ref
            ref = seq
            cur = min(cursors[c], auth.get_length())
            for _ in range(rng.randrange(2, 14)):
                seq += 1
                op = make_insert_op(cur,
                                    text_seg(chr(97 + rng.randrange(26))))
                auth.apply_msg(op, seq, ref, c, min_seq=max(0, seq - 40))
                tail.append((op, seq, ref, c, max(0, seq - 40)))
                cur += 1
            cursors[c] = cur
            continue
        n = auth.get_length()
        seq += 1
        roll = rng.random()
        if n > 6 and roll < 0.4:
            a = rng.randrange(n - 1)
            op = make_remove_op(a, min(n, a + rng.randrange(1, 6)))
        elif n > 3 and roll < 0.6:
            a = rng.randrange(n - 1)
            op = make_annotate_op(a, a + 1, {"k": seq % 5})
        elif roll < 0.8 and n > 0:
            op = make_insert_op(rng.randrange(n + 1),
                                items_seg([seq, seq + 1]))
        else:
            op = make_insert_op(rng.randrange(n + 1) if n else 0,
                                text_seg(f"[{seq}]"))
        auth.apply_msg(op, seq, seq - 1, c, min_seq=max(0, seq - 40))
        tail.append((op, seq, seq - 1, c, max(0, seq - 40)))
    return tail


@soak
class TestBulkCatchupSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_random_burst_schedules_match_scalar(self, trial):
        from fluidframework_tpu_torch.mergetree.catchup import Unmodelable

        rng = random.Random(10_000 + trial)
        tail = _burst_schedule(rng, rng.randrange(100, 500))
        split = rng.randrange(0, len(tail) // 2) if rng.random() < 0.5 \
            else 0
        head, rest = tail[:split], tail[split:]
        bulk = MergeTreeClient(client_id=99, device="cpu")
        scalar = MergeTreeClient(client_id=99, device="cpu")
        for op, s, r, c, m in head:
            bulk.apply_msg(op, s, r, c, min_seq=m)
            scalar.apply_msg(op, s, r, c, min_seq=m)
        if split and rng.random() < 0.7:
            n = bulk.get_length()
            pos = rng.randrange(n + 1) if n else 0
            for cl in (bulk, scalar):
                cl.insert_text_local(pos, "PEND")
            if rng.random() < 0.5 and bulk.get_length() > 6:
                for cl in (bulk, scalar):
                    cl.remove_range_local(1, 4)
        try:
            bulk.apply_bulk(rest)
        except Unmodelable:
            for op, s, r, c, m in rest:
                bulk.apply_msg(op, s, r, c, min_seq=m)
        for op, s, r, c, m in rest:
            scalar.apply_msg(op, s, r, c, min_seq=m)
        assert _flat(bulk) == _flat(scalar)
        if bulk.tree.pending_groups:
            assert bulk.regenerate_pending_ops() == \
                scalar.regenerate_pending_ops()


def _join(cid):
    return DocumentMessage(0, -1, MessageType.CLIENT_JOIN,
                           data=json.dumps({"clientId": cid,
                                            "detail": {}}))


def _serving_traffic(rng, docs=3):
    boxes = []
    for d in range(docs):
        doc = f"d{d}"
        csn = {}
        lens = 0
        for bx in range(rng.randrange(1, 4)):
            cid = f"c{d}.{bx % 2}"
            msgs = []
            if cid not in csn:
                msgs.append(_join(cid))
                csn[cid] = 0
            ref = rng.randrange(0, 30)
            pos = rng.randrange(lens + 1) if lens else 0
            prepend = rng.random() < 0.4
            for i in range(rng.randrange(3, 20)):
                csn[cid] += 1
                roll = rng.random()
                if roll < 0.75:
                    text = chr(97 + rng.randrange(26)) * rng.randrange(1, 3)
                    op = {"type": OP_INSERT, "pos1": pos,
                          "seg": {"text": text}}
                    if not prepend:
                        pos += len(text)
                    lens += len(text)
                elif roll < 0.88 and lens > 4:
                    a = rng.randrange(lens - 2)
                    b = min(lens, a + rng.randrange(1, 4))
                    op = {"type": OP_REMOVE, "pos1": a, "pos2": b}
                    lens -= b - a
                    pos = min(pos, lens)
                else:
                    if lens < 2:
                        continue
                    a = rng.randrange(lens - 1)
                    op = {"type": OP_ANNOTATE, "pos1": a, "pos2": a + 1,
                          "props": {"w": i}}
                msgs.append(DocumentMessage(
                    client_sequence_number=csn[cid],
                    reference_sequence_number=ref,
                    type=MessageType.OPERATION,
                    contents={"address": "s", "contents": {
                        "address": "t", "contents": op}}))
            boxes.append((doc, Boxcar("t", doc, cid, msgs)))
    return boxes


class _Ctx:
    def checkpoint(self, *_):
        pass

    def error(self, err, restart=False):
        raise err


def _lambda(emit, nack):
    from fluidframework_tpu_torch.server.tpu_sequencer import (
        TpuSequencerLambda)
    return TpuSequencerLambda(_Ctx(), emit=emit, nack=nack,
                              client_timeout_s=0.0, device="cpu")


@soak
class TestServingSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_random_boxcars_fast_matches_object(self, trial):
        from fluidframework_tpu_torch.server.log import QueuedMessage
        from fluidframework_tpu_torch.server.wire import boxcar_to_wire

        def key(doc_id, m):
            return (doc_id, m.sequence_number, m.minimum_sequence_number,
                    m.type, m.client_id, m.client_sequence_number,
                    m.reference_sequence_number,
                    json.dumps(m.contents, sort_keys=True), m.data)

        rng = random.Random(55_000 + trial)
        ea, eb, na, nb = [], [], [], []
        A = _lambda(lambda d, m: ea.append(key(d, m)),
                    lambda d, c, n: na.append((d, c, n.content.code)))
        B = _lambda(lambda d, m: eb.append(key(d, m)),
                    lambda d, c, n: nb.append((d, c, n.content.code)))
        B.pipelined = trial % 2 == 1
        if B.pipelined and rng.random() < 0.25:
            B.defer_risky_windows = True
        # The runtime lockset check: the pipelined store runs the soak with
        # the statically inferred summarize-guard discipline asserted on
        # every access.
        from fluidframework_tpu_torch.testing.lockcheck import (
            instrument, static_guards)
        guards = static_guards(type(B.merge))
        guards["_deferred_frees"] = "_guard_lock"
        lockcheck = instrument(B.merge, guards)
        try:
            tr = _serving_traffic(rng)
            for i, (doc, box) in enumerate(tr):
                A.handler(QueuedMessage("rawdeltas", 0, i, doc, box))
                B.handler_raw(QueuedMessage("rawdeltas", 0, i, doc,
                                            boxcar_to_wire(box)))
                if rng.random() < 0.3:
                    A.flush()
                    B.flush()
            A.flush()
            B.flush()
            A.drain()
            B.drain()
            lockcheck.assert_clean()
        finally:
            lockcheck.uninstrument()
        assert sorted(ea) == sorted(eb)
        assert sorted(na) == sorted(nb)
        for d in {t[0] for t in tr}:
            assert A.channel_text(d, "s", "t") == \
                B.channel_text(d, "s", "t"), d


class TestAsyncSummaryLockDiscipline:
    """Fixed-seed serving traffic with async summaries in flight while the
    sequencing thread keeps flushing: the overlap the MergeLaneStore
    summarize guard exists for. The store runs instrumented with the
    locksets the port's fluidlint statically infers
    (testing/lockcheck.static_guards), so the model and the code cannot
    drift apart. Deterministic (fixed seed, joined workers): tier-1."""

    def test_inferred_locksets_hold_under_async_summaries(self):
        from fluidframework_tpu_torch.server.tpu_sequencer import (
            MergeLaneStore)
        from fluidframework_tpu_torch.testing import lambda_runs
        from fluidframework_tpu_torch.testing.lockcheck import (
            instrument, static_guards)

        guards = static_guards(MergeLaneStore)
        # The inferred map must cover the summarize epoch state: if the
        # model stops seeing the discipline, this catches the drift.
        assert guards.get("_snap_cache") == "_guard_lock"
        assert guards.get("_extract_guards") == "_guard_lock"
        assert guards.get("last_summarized_gen") == "_guard_lock"
        guards["_deferred_frees"] = "_guard_lock"
        checks = []

        def check(store):
            checks.append(instrument(store, guards))
            return checks[-1]

        pkg = lambda_runs.port_package("cpu")
        got = lambda_runs.summary_overlap_run(pkg, check=check)
        assert len(checks) == 1 and checks[0].violations == []
        assert got["workers"] == 6 and len(got["summaries"]) == 6
        assert got["overlapped_flushes"] > 0
        assert got["texts"]["chars"] == 72
        plain = lambda_runs.summary_overlap_run(pkg)
        assert plain["texts"] == got["texts"]

    def test_an_unguarded_access_fails_the_run(self, monkeypatch):
        """The wrap is live during the run: a seeded unguarded read of the
        blob cache from the summary worker fails assert_clean."""
        from fluidframework_tpu_torch.server.tpu_sequencer import (
            MergeLaneStore)
        from fluidframework_tpu_torch.testing import lambda_runs
        from fluidframework_tpu_torch.testing.lockcheck import (
            LockDisciplineError, instrument, static_guards)

        assemble = MergeLaneStore.extract_assemble

        def seeded(self, *args, **kwargs):
            len(self._snap_cache)  # unguarded, on the worker thread
            return assemble(self, *args, **kwargs)

        monkeypatch.setattr(MergeLaneStore, "extract_assemble", seeded)
        with pytest.raises(LockDisciplineError, match="_snap_cache"):
            lambda_runs.summary_overlap_run(
                lambda_runs.port_package("cpu"), waves=2,
                check=lambda store: instrument(
                    store, static_guards(MergeLaneStore)))


def _soak_session(channel_type, server_cls=None, n_clients=2):
    """One session for every soak class: server, loader and N channel
    replicas, on the CPU."""
    from fluidframework_tpu_torch.loader.container import Loader
    from fluidframework_tpu_torch.loader.drivers.local import (
        LocalDocumentServiceFactory)
    from fluidframework_tpu_torch.server.local_server import TpuLocalServer

    server = (server_cls or (lambda: TpuLocalServer(device="cpu")))()
    loader = Loader(LocalDocumentServiceFactory(server), device="cpu")
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    channels = [ds.create_channel("ch", channel_type)]
    c1.attach()
    for _ in range(n_clients - 1):
        c = loader.resolve("doc")
        channels.append(c.runtime.get_datastore("default")
                        .get_channel("ch"))
    return server, loader, channels


@soak
class TestMeshPlacementSoak:
    """The runtime shardcheck on the real serving path: random sessions
    against a paged sequencer on a dp mesh, every device plane held to
    the partition-rule table mid-traffic."""

    @pytest.mark.parametrize("trial", range(max(1, TRIALS // 5)))
    def test_paged_mesh_placements_hold_under_traffic(self, trial):
        from fluidframework_tpu_torch.dds.sequence import SharedString
        from fluidframework_tpu_torch.parallel.mesh import make_mesh
        from fluidframework_tpu_torch.server.local_server import \
            TpuLocalServer
        from fluidframework_tpu_torch.testing import shardcheck

        rng = random.Random(91_000 + trial)
        mesh = make_mesh(sp=1, devices=["cpu"] * 8)
        server, _, chans = _soak_session(
            SharedString.TYPE,
            server_cls=lambda: TpuLocalServer(device="cpu", mesh=mesh,
                                              paged_lanes=True))
        checked = 0
        for _ in range(20):
            ch = rng.choice(chans)
            pos = rng.randrange(ch.get_length() + 1)
            ch.insert_text(pos, rng.choice("abcdef") * rng.randint(1, 3))
            if rng.random() < 0.3:
                checked += shardcheck.verify_store(
                    server.sequencer().merge, mesh)
        checked += shardcheck.verify_store(server.sequencer().merge, mesh)
        assert checked > 0
        assert len({c.get_text() for c in chans}) == 1


@soak
class TestMatrixServingSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_random_matrix_sessions_match(self, trial):
        from fluidframework_tpu_torch.dds.matrix import SharedMatrix

        rng = random.Random(91_000 + trial)
        server, _, (m1, m2) = _soak_session(SharedMatrix.TYPE)
        for step in range(rng.randrange(40, 120)):
            m = rng.choice([m1, m2])
            r, c = m.row_count, m.col_count
            act = rng.random()
            if act < 0.25 or r == 0:
                m.insert_rows(rng.randint(0, r), rng.randint(1, 3))
            elif act < 0.5 or c == 0:
                m.insert_cols(rng.randint(0, c), rng.randint(1, 2))
            elif act < 0.6 and r > 1:
                m.remove_rows(rng.randrange(r - 1), 1)
            elif act < 0.65 and c > 1:
                m.remove_cols(rng.randrange(c - 1), 1)
            else:
                m.set_cell(rng.randrange(r), rng.randrange(c), step)
            if rng.random() < 0.02:
                server._deli_mgr.restart()
        assert m1.extract() == m2.extract()
        grid = server.sequencer().channel_matrix("doc", "default", "ch")
        assert grid == m1.extract()


@soak
class TestDirectoryServingSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_random_directory_sessions_match(self, trial):
        from fluidframework_tpu_torch.dds.directory import SharedDirectory

        rng = random.Random(93_000 + trial)
        server, _, (d1, d2) = _soak_session(SharedDirectory.TYPE)
        names = ["a", "b", "c"]
        for step in range(rng.randrange(60, 160)):
            d = rng.choice([d1, d2])
            paths = ["/"]
            for n1 in names:
                if d.get_working_directory("/" + n1) is not None:
                    paths.append("/" + n1)
                    for n2 in names:
                        if d.get_working_directory(
                                f"/{n1}/{n2}") is not None:
                            paths.append(f"/{n1}/{n2}")
            path = rng.choice(paths)
            wd = d.root if path == "/" else d.get_working_directory(path)
            act = rng.random()
            if act < 0.15 and path.count("/") < 3:
                wd.create_sub_directory(rng.choice(names))
            elif act < 0.22 and path != "/":
                parent, _, name = path.rpartition("/")
                pd = d.root if not parent else \
                    d.get_working_directory(parent)
                if pd is not None:
                    pd.delete_sub_directory(name)
            elif act < 0.28:
                wd.clear()
            elif act < 0.4:
                wd.delete(f"k{rng.randrange(4)}")
            else:
                wd.set(f"k{rng.randrange(4)}", step)
            if rng.random() < 0.02:
                server._deli_mgr.restart()
        assert d1.root.to_dict() == d2.root.to_dict()
        tree = server.sequencer().channel_directory("doc", "default", "ch")
        assert tree == d1.root.to_dict()


@soak
class TestIntervalCatchupSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_random_interval_histories_catch_up(self, trial):
        from fluidframework_tpu_torch.dds.sequence import SharedString
        from fluidframework_tpu_torch.server.local_server import LocalServer

        rng = random.Random(95_000 + trial)
        server, loader, (text,) = _soak_session(
            SharedString.TYPE, server_cls=LocalServer, n_clients=1)
        ic = text.get_interval_collection("marks")
        ids = []
        for i in range(rng.randrange(80, 200)):
            n = text.get_length()
            act = rng.random()
            if act < 0.6 or n < 8:
                text.insert_text(rng.randrange(n + 1) if n else 0,
                                 f"[{i % 10}]")
            elif act < 0.8:
                a = rng.randrange(n - 2)
                text.remove_text(a, min(n, a + rng.randrange(1, 4)))
            elif act < 0.9 and n > 4:
                iv = ic.add(rng.randrange(n - 2), rng.randrange(2, n),
                            {"i": i})
                ids.append(iv.interval_id)
            elif ids:
                iid = rng.choice(ids)
                if rng.random() < 0.5 and text.get_length() > 4:
                    ic.change(iid, 1, text.get_length() - 1)
                else:
                    ic.remove_interval_by_id(iid)
                    ids.remove(iid)
        late = loader.resolve("doc")
        t2 = late.runtime.get_datastore("default").get_channel("ch")
        assert t2.get_text() == text.get_text()
        lc = t2.get_interval_collection("marks")
        assert len(lc) == len(ic)
        src = {iv.interval_id: ic.endpoints(iv) for iv in ic}
        got = {iv.interval_id: lc.endpoints(iv) for iv in lc}
        assert got == src


@soak
class TestItemsServingSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_random_items_sessions_match(self, trial):
        from fluidframework_tpu_torch.dds.sequence import (
            SharedNumberSequence)

        rng = random.Random(97_000 + trial)
        server, _, (s1, s2) = _soak_session(SharedNumberSequence.TYPE)
        for step in range(rng.randrange(50, 140)):
            s = rng.choice([s1, s2])
            n = s.get_item_count()
            r = rng.random()
            if r < 0.65 or n < 6:
                s.insert_range(rng.randrange(n + 1), [step, step + 0.5])
            elif r < 0.9:
                a = rng.randrange(n - 2)
                s.remove_range(a, min(n, a + rng.randrange(1, 4)))
            else:
                a = rng.randrange(n - 2)
                s.annotate_range(a, a + 2, {"fmt": step % 3})
            if rng.random() < 0.02:
                server._deli_mgr.restart()
        assert s1.get_items() == s2.get_items()
        items = server.sequencer().channel_items("doc", "default", "ch")
        assert items == s1.get_items()


@soak
class TestWireFuzzSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_corrupted_frames_never_crash_the_pump(self, trial):
        from fluidframework_tpu_torch.server.log import QueuedMessage
        from fluidframework_tpu_torch.server.wire import boxcar_to_wire

        rng = random.Random(99_000 + trial)
        nonce = (1 << 44) + trial
        lam = _lambda(lambda *a: None, lambda *a: None)

        def boxcar(doc, msgs, cid):
            return boxcar_to_wire(Boxcar("t", doc, cid, msgs))

        ops = [
            {"target": "rows", "op": {"type": 0, "pos1": 0,
                                      "seg": {"run": [nonce, 1, 0, 3]}}},
            {"target": "cell", "key": f"{nonce}.1.0|{nonce}.1.1",
             "value": {"v": trial}},
            {"type": "storage", "path": "/", "op": {
                "type": "set", "key": "k", "value": 1, "pid": 1}},
            {"type": "createSubDirectory", "path": "/", "name": "s"},
            {"type": 0, "pos1": 0, "seg": {"items": [trial, "v", None]}},
        ]
        join = _join("c")
        for i in range(40):
            op = rng.choice(ops)
            chan = ("g" if "target" in op
                    else "nums" if "seg" in op else "dir")
            msg = DocumentMessage(
                i + 1, i, MessageType.OPERATION,
                contents={"address": "s", "contents": {
                    "address": chan, "contents": op}})
            raw = boxcar("doc", [join, msg] if i == 0 else [msg], "c")
            if rng.random() < 0.5:  # corrupt: flip, truncate or insert
                b = bytearray(raw)
                mode = rng.random()
                if mode < 0.4 and b:
                    for _ in range(rng.randrange(1, 4)):
                        b[rng.randrange(len(b))] = rng.randrange(256)
                elif mode < 0.7:
                    b = b[:rng.randrange(len(b))]
                else:
                    at = rng.randrange(len(b))
                    b[at:at] = bytes(rng.randrange(256) for _ in range(3))
                raw = bytes(b)
            try:
                lam.handler_raw(QueuedMessage("rawdeltas", 0, i, "doc",
                                              raw))
                if rng.random() < 0.3:
                    lam.flush()
            except Exception as err:  # noqa: BLE001
                assert not isinstance(err, (SystemError, MemoryError)), err
        lam.flush()
        lam.drain()
        ok = DocumentMessage(
            100, 99, MessageType.OPERATION,
            contents={"address": "s", "contents": {
                "address": "g", "contents": {
                    "target": "cell", "key": "a|b", "value": 1}}})
        lam.handler_raw(QueuedMessage("rawdeltas", 0, 999, "doc",
                                      boxcar("doc", [ok], "c")))
        lam.flush()
        lam.drain()


@soak
class TestMaintenanceSoak:
    @pytest.mark.parametrize("trial", range(TRIALS))
    def test_aggressive_maintenance_converges(self, trial):
        from fluidframework_tpu_torch.dds.sequence import SharedString

        rng = random.Random(77_000 + trial)
        server, loader, chans = _soak_session(SharedString.TYPE,
                                              n_clients=2)

        def tune():
            st = server.sequencer().merge
            st.compact_every = 1
            st.block_age_ticks = 1
            st.payload_compact_every = rng.choice((1, 2))
            st.payload_compact_min_entries = 0
            st.fold_budget_per_tick = rng.choice((1, 4))
            return st

        store = tune()
        activity = 0
        threads = []
        for i in range(rng.randrange(250, 400)):
            ch = rng.choice(chans)
            n = ch.get_length()
            if n > 8 and rng.random() < 0.3:
                start = rng.randrange(n - 4)
                ch.remove_text(start, start + rng.randrange(1, 4))
            elif n > 4 and rng.random() < 0.15:
                start = rng.randrange(n - 2)
                ch.annotate_range(start, start + 2, {"b": i % 3})
            else:
                ch.insert_text(rng.randrange(n + 1), f"m{i % 10}")
            if rng.random() < 0.05:
                threads.append(server.sequencer().summarize_documents_async(
                    lambda out: None))
            if rng.random() < 0.02:
                activity += store.folds + store.payload_compactions \
                    + store.blocks_aged
                server._deli_mgr.restart()
                store = tune()
        for th in threads:
            th.join(timeout=30)
        assert chans[0].get_text() == chans[1].get_text()
        assert server.sequencer().channel_text(
            "doc", "default", "ch") == chans[0].get_text()
        activity += store.folds + store.payload_compactions \
            + store.blocks_aged
        assert activity > 0
