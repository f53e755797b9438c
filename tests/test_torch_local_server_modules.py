"""The local server's host modules, port against the JAX package, with
zero tolerance: the same seeded inputs (numpy and random, seeded) go
through each JAX module and its copy in fluidframework_tpu_torch, and
what comes out must be equal.

Covered: the quorum and the protocol op handler, summary trees (the dict
form and blob_sha), the git store (blob, tree and commit shas on one
commit clock, read_summary), the LRU/TTL cache and the watermark table on
one fake clock, the md5 document routing, the admission controller on one
fake clock over an overload ramp, the scalar DeliLambda on seeded
boxcars, the copier and the foreman; and the objects that cross between
the JAX client stack and the port's server (summary trees both ways,
messages, Nacks).
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu.protocol import protocol_handler as jph
from fluidframework_tpu.protocol import summary as jsum
from fluidframework_tpu.server import admission as jadm
from fluidframework_tpu.server import cache as jcache
from fluidframework_tpu.server import routing as jroute
from fluidframework_tpu.server import storage as jstore
from fluidframework_tpu.server.database import Collection as JCollection
from fluidframework_tpu.server.lambdas import copier as jcopier
from fluidframework_tpu.server.lambdas import deli as jdeli
from fluidframework_tpu.server.lambdas import foreman as jforeman
from fluidframework_tpu.server.log import QueuedMessage as JQM
from fluidframework_tpu.telemetry import counters as jcounters
from fluidframework_tpu.telemetry import watermarks as jwm

from fluidframework_tpu_torch.protocol import messages as tmsg
from fluidframework_tpu_torch.protocol import protocol_handler as tph
from fluidframework_tpu_torch.protocol import summary as tsum
from fluidframework_tpu_torch.server import admission as tadm
from fluidframework_tpu_torch.server import cache as tcache
from fluidframework_tpu_torch.server import routing as troute
from fluidframework_tpu_torch.server import storage as tstore
from fluidframework_tpu_torch.server.database import Collection as TCollection
from fluidframework_tpu_torch.server.database import DatabaseManager
from fluidframework_tpu_torch.server.lambdas import copier as tcopier
from fluidframework_tpu_torch.server.lambdas import deli as tdeli
from fluidframework_tpu_torch.server.lambdas import foreman as tforeman
from fluidframework_tpu_torch.server.log import QueuedMessage as TQM
from fluidframework_tpu_torch.telemetry import counters as tcounters
from fluidframework_tpu_torch.telemetry import watermarks as twm

JAX = SimpleNamespace(msg=jmsg, ph=jph, sum=jsum, adm=jadm, cache=jcache,
                      route=jroute, store=jstore, Collection=JCollection,
                      copier=jcopier, deli=jdeli, foreman=jforeman, QM=JQM,
                      counters=jcounters, wm=jwm)
PORT = SimpleNamespace(msg=tmsg, ph=tph, sum=tsum, adm=tadm, cache=tcache,
                       route=troute, store=tstore, Collection=TCollection,
                       copier=tcopier, deli=tdeli, foreman=tforeman, QM=TQM,
                       counters=tcounters, wm=twm)
BOTH = (JAX, PORT)


class FakeClock:
    """One clock for a module of either package: time(), monotonic() and
    the call form all read `now`."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        return self.now

    def perf_counter(self) -> float:
        return self.now


@pytest.fixture(autouse=True)
def _fresh_counters():
    for pkg in BOTH:
        pkg.counters.reset()
        pkg.wm.reset()
    yield
    for pkg in BOTH:
        pkg.counters.reset()
        pkg.wm.reset()


def both(fn):
    """fn(package) on each package; asserts the two results are equal
    and returns the port's."""
    a, b = fn(JAX), fn(PORT)
    assert a == b
    return b


# -- protocol: quorum and the op handler ----------------------------------

def protocol_stream(seed: int, n: int = 80):
    """A seeded sequenced stream: joins, leaves, proposals, rejects and
    ops, with the MSN trailing the sequence number."""
    rng = random.Random(seed)
    out, members, seq, msn = [], [], 0, 0
    for i in range(n):
        seq += 1
        msn = min(seq - 1, msn + rng.randrange(0, 3))
        roll = rng.random()
        if roll < 0.2 or not members:
            cid = f"c{i}"
            members.append(cid)
            out.append(dict(type="join", seq=seq, msn=msn, data=json.dumps(
                {"clientId": cid, "detail": {"mode": "write", "i": i}})))
        elif roll < 0.3:
            cid = members.pop(rng.randrange(len(members)))
            out.append(dict(type="leave", seq=seq, msn=msn,
                            data=json.dumps({"clientId": cid})))
        elif roll < 0.5:
            out.append(dict(type="propose", seq=seq, msn=msn,
                            client=rng.choice(members), contents={
                                "key": f"k{rng.randrange(4)}",
                                "value": rng.randrange(100)}))
        elif roll < 0.55 and seq > 2:
            out.append(dict(type="reject", seq=seq, msn=msn,
                            client=rng.choice(members),
                            contents=str(rng.randrange(1, seq))))
        else:
            out.append(dict(type="op", seq=seq, msn=msn,
                            client=rng.choice(members), contents={"n": i}))
    return out


def sequenced(pkg, e):
    M = pkg.msg.MessageType
    kind = {"join": M.CLIENT_JOIN, "leave": M.CLIENT_LEAVE,
            "propose": M.PROPOSE, "reject": M.REJECT,
            "op": M.OPERATION}[e["type"]]
    return pkg.msg.SequencedDocumentMessage(
        client_id=e.get("client"), sequence_number=e["seq"],
        minimum_sequence_number=e["msn"], client_sequence_number=0,
        reference_sequence_number=e["msn"], type=kind,
        contents=e.get("contents"), data=e.get("data"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quorum_and_protocol_handler_match(seed):
    stream = protocol_stream(seed)

    def run(pkg):
        h = pkg.ph.ProtocolOpHandler()
        events = []
        h.quorum.on("approveProposal", lambda *a: events.append(
            ["approve", *map(repr, a)]))
        h.quorum.on("addMember", lambda *a: events.append(
            ["add", *map(repr, a[:1])]))
        h.quorum.on("removeMember", lambda *a: events.append(
            ["remove", *map(repr, a)]))
        states = []
        for i, e in enumerate(stream):
            h.process_message(sequenced(pkg, e))
            h.process_message(sequenced(pkg, e))      # replay: no-op
            if i % 10 == 9:
                s = h.snapshot()
                states.append(asdict(s))
                h = pkg.ph.ProtocolOpHandler.load(s)
        snap = h.snapshot()
        approved = {k: h.quorum.get(k) for k in ("k0", "k1", "k2", "k3")
                    if h.quorum.has(k)}
        return json.dumps([states, asdict(snap), approved, events],
                          sort_keys=True, default=repr)

    both(run)

    def gap(pkg):
        h = pkg.ph.ProtocolOpHandler()
        with pytest.raises(pkg.ph.ProtocolError, match="gap"):
            h.process_message(sequenced(pkg, dict(type="op", seq=2, msn=0,
                                                  client="c")))
        with pytest.raises(pkg.ph.ProtocolError, match="invalid msn"):
            h.process_message(sequenced(pkg, dict(type="op", seq=1, msn=1,
                                                  client="c")))
        return h.sequence_number

    both(gap)


# -- summary trees and the git store ---------------------------------------

def random_tree(pkg, rng: random.Random, depth: int = 0):
    S = pkg.sum
    tree = S.SummaryTree(unreferenced=rng.random() < 0.1)
    for i in range(rng.randrange(1, 5)):
        roll = rng.random()
        if depth < 3 and roll < 0.35:
            tree.entries[f"t{i}"] = random_tree(pkg, rng, depth + 1)
        elif roll < 0.6:
            tree.add_blob(f"b{i}", "".join(
                rng.choice("abé中") for _ in range(rng.randrange(9))))
        elif roll < 0.8:
            tree.add_blob(f"x{i}", bytes(rng.randrange(256)
                                         for _ in range(rng.randrange(9))))
        elif roll < 0.9:
            tree.entries[f"a{i}"] = S.SummaryAttachment(f"att{i}")
        else:
            tree.add_handle(f"h{i}", f"/t{i}")
    return tree


@pytest.mark.parametrize("seed", range(4))
def test_summary_dict_round_trip_and_blob_sha(seed):
    def run(pkg):
        tree = random_tree(pkg, random.Random(seed))
        d = pkg.sum.summary_tree_to_dict(tree)
        back = pkg.sum.summary_tree_from_dict(d)
        assert pkg.sum.summary_tree_to_dict(back) == d
        shas = [pkg.sum.blob_sha(x) for x in
                ("", "abc", b"\x00\xff", "中" * 3)]
        return json.dumps(d, sort_keys=True), shas

    both(run)
    # The dict form crosses packages: a JAX tree becomes the port's.
    d = jsum.summary_tree_to_dict(random_tree(JAX, random.Random(seed)))
    assert tsum.summary_tree_to_dict(tsum.summary_tree_from_dict(d)) == d


def _read(node):
    """A read summary as plain data (lazy blobs resolved)."""
    if hasattr(node, "entries"):
        return {k: _read(v) for k, v in sorted(node.entries.items())}
    if hasattr(node, "handle"):
        return ["handle", node.handle]
    if hasattr(node, "id"):
        return ["attachment", node.id]
    c = node.content
    return ["bytes", c.hex()] if isinstance(c, bytes) else c


@pytest.mark.parametrize("seed", range(3))
def test_git_store_shas_and_read_summary(seed, monkeypatch):
    rng_seed = seed

    def run(pkg):
        clock = FakeClock(5.0)
        monkeypatch.setattr(pkg.store, "time", clock)
        rng = random.Random(rng_seed)
        hist = pkg.store.Historian()
        store = hist.store("tenant", "doc")
        out = []
        base = None
        for step in range(4):
            clock.now += 1
            tree = pkg.sum.SummaryTree()
            tree.add_blob("meta", f"step {step}")
            if base is not None and step % 2:
                # An incremental summary: the unchanged subtree rides as a
                # handle into the base commit's tree at the same position.
                tree.add_handle("body", "/")
            else:
                body = tree.add_tree("body")
                for i in range(3):
                    body.add_blob(f"c{i}", f"{step}:{i}:{rng.randrange(9)}")
            sha = store.write_summary(tree, base_commit=base,
                                      advance_ref=step % 2 == 0)
            commit = store.get(sha)
            out.append([sha, commit.tree_sha, commit.parents,
                        store.get_ref("main")])
            for lazy in (False, True):
                out.append(_read(store.read_summary(sha, lazy=lazy)))
                out.append(_read(hist.read_summary("tenant", "doc", sha,
                                                   lazy=lazy)))
            base = sha
        out.append([c.sha for c in store.list_commits()])
        return out

    both(run)


def test_lru_ttl_cache_on_a_fake_clock(monkeypatch):
    def run(pkg):
        clock = FakeClock()
        monkeypatch.setattr(pkg.cache, "time", clock)
        rng = np.random.default_rng(7)
        c = pkg.cache.LruTtlCache(max_entries=12, max_bytes=300, ttl_s=5.0)
        trail = []
        for step in range(400):
            clock.now += float(rng.random())
            key = int(rng.integers(0, 20))
            roll = rng.random()
            if roll < 0.4:
                trail.append(c.get(key))
            elif roll < 0.7:
                c.put(key, f"v{step}", nbytes=int(rng.integers(0, 60)),
                      ttl_s=None if rng.random() < 0.5
                      else float(rng.random() * 3))
            elif roll < 0.8:
                trail.append(c.put_if_newer(key, f"n{step}",
                                            int(rng.integers(0, 9))))
                trail.append(c.peek_version(key))
            elif roll < 0.9:
                trail.append(c.invalidate(key))
            else:
                trail.append(c.contains(key))
        trail.append(c.stats())
        trail.append(c.clear())
        return trail

    both(run)


def test_routing_homes_and_doc_shard():
    docs = [f"doc-{i}" for i in range(300)] + ["", "été", "a/b"]

    def run(pkg):
        shards = [[pkg.route.doc_shard(d, n) for d in docs]
                  for n in (1, 2, 3, 7, 16)]
        r = pkg.route.PartitionRouter(4)
        homes = [r.partition_for(d) for d in docs]
        epochs = [r.install_override(d, (r.base_partition_for(d) + 1) % 4)
                  for d in docs[:9]]
        moved = [r.partition_for(d) for d in docs[:12]]
        snap = r.snapshot()
        r2 = pkg.route.PartitionRouter(4)
        r2.restore(snap)
        return [shards, homes, epochs, moved, snap,
                r2.assignment(docs[:20]), r.overrides_targeting(1)]

    both(run)


def test_admission_decisions_on_a_fake_clock():
    """A seeded overload ramp: arrivals outrun a drain that slows, then
    stop; every decision and the state after every step agree."""
    def run(pkg):
        clock = FakeClock(0.0)
        adm = pkg.adm.AdmissionController(queue_limit=400, clock=clock,
                                          interval_s=0.02)
        backlog = {"raw": 0, "p0": 0, "p1": 0}
        staged = {"n": 0}
        adm.add_source("core", queue_depth=lambda: backlog["raw"])
        adm.add_source("ring", hints=lambda: {
            "staged_ops": staged["n"], "ring_occupancy": 2,
            "ring_depth": 4})
        for p in (0, 1):
            adm.add_partition_source(p, queue_depth=lambda p=p:
                                     backlog[f"p{p}"])
        hooks = []
        adm.add_degrade_hooks(lambda: hooks.append("enter"),
                              lambda: hooks.append("exit"))
        rng = random.Random(11)
        trail = []
        for step in range(600):
            clock.now += 0.01
            arrivals = rng.randrange(0, 12) if step < 420 else 0
            for _ in range(arrivals):
                tenant = f"t{rng.randrange(3)}"
                part = rng.randrange(2)
                kind = rng.choice([pkg.adm.CLASS_OP] * 6
                                  + [pkg.adm.CLASS_SIGNAL])
                n = rng.randrange(1, 9)
                d = adm.admit(tenant, kind=kind, count=n, records=1,
                              partition=part)
                trail.append([d.admitted, d.state, round(d.retry_after_s, 9),
                              d.reason])
                if d.admitted and kind == pkg.adm.CLASS_OP:
                    if rng.random() < 0.05:
                        adm.retract(n, records=1, partition=part,
                                    tenant=tenant)
                    else:
                        backlog["raw"] += 1
                        backlog[f"p{part}"] += 1
            drain = 5 if step < 150 else 1
            for p in ("p0", "p1"):
                took = min(backlog[p], drain)
                backlog[p] -= took
                backlog["raw"] -= took
            staged["n"] = rng.randrange(0, 30)
            trail.append(adm.state)
        status = adm.status()
        return [trail, hooks, adm.queue_depth(), status]

    got = both(run)
    states = set(got[0][i] for i in range(len(got[0]))
                 if isinstance(got[0][i], str))
    assert {"accept", "throttle"} <= states, states
    assert any(isinstance(d, list) and not d[0] for d in got[0])


def test_watermarks_on_a_fake_clock():
    def run(pkg):
        clock = FakeClock(10.0)
        t = pkg.wm.WatermarkTable(clock=clock)
        rng = random.Random(3)
        tiers = list(pkg.wm.TIERS)
        for step in range(300):
            clock.now += rng.random()
            tier = rng.choice(tiers)
            part = rng.randrange(3)
            if tier in (pkg.wm.RAW_END, pkg.wm.RAW_INGESTED):
                t.advance(tier, part, rng.randrange(step + 1),
                          tenant=rng.choice(["a", "b"]))
            else:
                t.advance_doc(tier, part, f"d{rng.randrange(6)}",
                              rng.randrange(step + 2),
                              tenant=rng.choice(["a", "b"]))
        return [t.snapshot(), t.lags(),
                [t.total_lag(edge[0]) for edge in pkg.wm.LAG_EDGES],
                t.ages(clock.now + 1.0)]

    both(run)


# -- the scalar deli, the copier, the foreman ---------------------------------

def deli_stream(pkg, seed: int, n: int = 120):
    """Seeded boxcars for DeliLambda: joins, leaves, ops with refSeqs
    that wander and sometimes fall behind, duplicates, writers that never
    joined, summary acks from the server."""
    rng = random.Random(seed)
    M = pkg.msg.MessageType
    docs = ["alpha", "beta", "gamma"]
    members = {d: [] for d in docs}
    csn = {}
    out = []
    for i in range(n):
        d = rng.choice(docs)
        roll = rng.random()
        if roll < 0.12 or not members[d]:
            cid = f"c{i}"
            members[d].append(cid)
            csn[(d, cid)] = 0
            msgs, client = [pkg.msg.DocumentMessage(
                client_sequence_number=0, reference_sequence_number=-1,
                type=M.CLIENT_JOIN, data=json.dumps(
                    {"clientId": cid, "detail": {}}))], None
        elif roll < 0.18:
            cid = members[d].pop(rng.randrange(len(members[d])))
            msgs, client = [pkg.msg.DocumentMessage(
                client_sequence_number=0, reference_sequence_number=-1,
                type=M.CLIENT_LEAVE,
                data=json.dumps({"clientId": cid}))], None
        elif roll < 0.22:
            msgs, client = [pkg.msg.DocumentMessage(
                client_sequence_number=1, reference_sequence_number=0,
                type=M.OPERATION, contents={"ghost": i})], "ghost"
        else:
            client = rng.choice(members[d])
            msgs = []
            for _ in range(rng.randrange(1, 5)):
                if rng.random() > 0.08:       # else a duplicate clientSeq
                    csn[(d, client)] += 1
                ref = 0 if rng.random() < 0.1 else rng.randrange(max(1, i))
                msgs.append(pkg.msg.DocumentMessage(
                    client_sequence_number=csn[(d, client)],
                    reference_sequence_number=ref, type=M.OPERATION,
                    contents={"n": i, "text": "x" * rng.randrange(4)}))
        out.append(pkg.QM(topic="rawdeltas", partition=0, offset=i, key=d,
                          value=pkg.msg.Boxcar(tenant_id="t", document_id=d,
                                               client_id=client,
                                               contents=msgs)))
    return out


class _Ctx:
    def __init__(self):
        self.offsets = []

    def checkpoint(self, offset):
        self.offsets.append(offset)

    def error(self, err, restart=False):
        raise err


@pytest.mark.parametrize("seed,restart_at", [(0, None), (1, 60), (2, 30)])
def test_deli_lambda_on_seeded_boxcars(seed, restart_at, monkeypatch):
    def run(pkg):
        monkeypatch.setattr(pkg.deli, "time", FakeClock(50.0))
        emits, nacks = [], []
        checkpoints = pkg.Collection()
        ctx = _Ctx()

        def make():
            return pkg.deli.DeliLambda(
                ctx, emit=lambda d, m: emits.append(
                    [d, m.sequence_number, m.minimum_sequence_number,
                     m.type, m.client_id, m.client_sequence_number,
                     m.reference_sequence_number,
                     json.dumps(m.contents, sort_keys=True), m.data]),
                nack=lambda d, c, n: nacks.append(
                    [d, c, n.sequence_number, n.content.code,
                     n.content.message,
                     n.operation.client_sequence_number]),
                checkpoints=checkpoints, config={
                    "deli.clientTimeoutMsec": 0})

        lam = make()
        for i, qm in enumerate(deli_stream(pkg, seed)):
            if i == restart_at:
                lam.close()
                lam = make()
            lam.handler(qm)
        lam.flush()
        rows = sorted(checkpoints.find(lambda r: True),
                      key=lambda r: r["documentId"])
        return [emits, nacks, rows, ctx.offsets]

    both(run)


def test_copier_and_foreman(monkeypatch):
    def run(pkg):
        raw = pkg.Collection()
        ctx = _Ctx()
        cop = pkg.copier.CopierLambda(ctx, raw)
        for qm in deli_stream(pkg, 4, n=30):
            cop.handler(qm)
        copied = json.dumps(raw.find(lambda r: True), sort_keys=True,
                            default=repr)
        clock = FakeClock(0.0)
        monkeypatch.setattr(pkg.foreman, "time", clock)
        f = pkg.foreman.ForemanLambda(_Ctx(), heartbeat_timeout_s=5.0)
        got = []
        f.register_worker("w1", lambda task: got.append(["w1", task]))
        f.register_worker("w2", lambda task: got.append(["w2", task]))
        f.heartbeat("w1")
        f.heartbeat("w2")
        M = pkg.msg.MessageType
        for i in range(12):
            clock.now += 1.0
            if i % 4 == 0:
                f.heartbeat("w1")
            if i == 6:
                got.append(["reaped", f.reap_dead_workers()])
            f.handler(pkg.QM(
                topic="deltas", partition=0, offset=i, key="d",
                value=("d", pkg.msg.SequencedDocumentMessage(
                    client_id="c", sequence_number=i + 1,
                    minimum_sequence_number=0, client_sequence_number=i,
                    reference_sequence_number=0,
                    type=M.SUMMARIZE if i % 3 == 0 else M.OPERATION,
                    contents={"i": i}))))
            if got and got[-1][0] in ("w1", "w2") and i % 2:
                f.complete_task(got[-1][0], got[-1][1])
        return [copied, json.dumps(got, sort_keys=True, default=repr)]

    both(run)


def test_database_manager_shares_named_collections():
    db = DatabaseManager()
    a = db.collection("deltas", unique_key=lambda r: r["k"])
    assert db.collection("deltas") is a
    assert a.insert_one({"k": 1}) and not a.insert_one({"k": 1})
    assert db.collection("other") is not a


# -- objects that cross between the JAX client stack and the port's server ---

def test_client_stack_objects_cross():
    """The JAX container uploads a summary into the port's server (through
    the storage wrapper), a second JAX loader reads it back from the
    port's historian as LazySummaryBlobs, and a port Nack reaches a JAX
    DocumentMessage's sender with its fields intact."""
    from fluidframework_tpu.dds.sequence import SharedString
    from fluidframework_tpu.loader.container import Loader
    from fluidframework_tpu.loader.drivers.local import \
        LocalDocumentServiceFactory

    from test_torch_local_server_serving import TpuLocalServer

    server = TpuLocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    text = ds.create_channel("text", SharedString.TYPE)
    c1.attach()
    text.insert_text(0, "crossing")
    acked = []
    c1.summarize(lambda handle, ack, contents: acked.append(ack))
    server.pump()
    assert acked == [True]
    tree = server.historian.read_summary("local", "doc", lazy=True)
    assert isinstance(tree, tsum.SummaryTree)
    lazy = [n for n in _walk(tree) if isinstance(n, tsum.LazySummaryBlob)]
    assert lazy
    c2 = Loader(LocalDocumentServiceFactory(server)).resolve("doc")
    t2 = c2.runtime.get_datastore("default").get_channel("text")
    assert t2.get_text() == "crossing"

    reader = server.connect("doc", {"mode": "read"})
    got = []
    reader.on("nack", got.append)
    op = jmsg.DocumentMessage(client_sequence_number=7,
                              reference_sequence_number=1,
                              type=jmsg.MessageType.OPERATION,
                              contents={"x": 1})
    reader.submit([op])
    assert isinstance(got[0], tmsg.Nack)
    assert got[0].operation is op
    assert (got[0].content.code, got[0].operation.client_sequence_number) \
        == (tmsg.NACK_NOT_WRITER, 7)


def _walk(node):
    yield node
    for child in getattr(node, "entries", {}).values():
        yield from _walk(child)
