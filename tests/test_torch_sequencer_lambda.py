"""The port's sequencer lambda against the JAX package's, on the object
path (`handler`: decoded boxcars, one ticket window at a time).

Both lambdas take the same traffic, generated from a seed: the JAX one on
the CPU as its own tests run it, the port's with device="cpu". Everything
compared is int32, int16, bool or host data, so the tolerance is zero:
each document's emitted stream (doc, seq, msn, client id, client seq, ref,
type, contents, data), the nacks, the channel views, summarize_documents,
catchup_snapshot, the checkpoint row and the recovery counters.

The helpers here (`Pair`, `feed`, `outcome`) are shared with
tests/test_torch_sequencer_fast.py, the raw-wire path; the traffic comes
from fluidframework_tpu_torch/testing/ingest.py.
"""

from __future__ import annotations

import json
import random
import time
from collections import defaultdict

import pytest

from fluidframework_tpu.server import tpu_sequencer as jseq
from fluidframework_tpu.server import wire as jwire
from fluidframework_tpu.server.database import Collection as JCollection
from fluidframework_tpu.server.log import QueuedMessage as JQueued
from fluidframework_tpu.server.lambdas.scriptorium import \
    delta_key as jdelta_key
from fluidframework_tpu.telemetry import counters as jcounters

from fluidframework_tpu_torch.server import tpu_sequencer as tseq
from fluidframework_tpu_torch.server import wire as twire
from fluidframework_tpu_torch.server.database import Collection
from fluidframework_tpu_torch.server.lambdas.scriptorium import delta_key
from fluidframework_tpu_torch.server.log import QueuedMessage as TQueued
from fluidframework_tpu_torch.telemetry import counters as tcounters
from fluidframework_tpu_torch.testing import ingest, lambda_runs
from fluidframework_tpu_torch.testing.lambda_runs import plain

# Counters that record recovery and dispatch; their deltas over a run
# must agree between the packages.
COUNTERS = (
    "serving.recovery_dispatches", "serving.ring_fixups",
    "sequencer.donated_overflow", "serving.paged_rescues",
    "zamboni.rows_reclaimed", "serving.bursts", "serving.burst_windows",
    "serving.megakernel_rings", "serving.megakernel_windows",
    "serving.window_dispatches", "serving.ring_windows_deferred",
    "serving.ring_donated_windows", "serving.ring_kept_windows",
    "serving.burst_dispatch_total", "serving.burst_breaks",
)

CHANNELS = ("t", "m", "c", "n", "x", "dir")


class _Ctx:
    def __init__(self):
        self.offsets = []

    def checkpoint(self, offset):
        self.offsets.append(offset)

    def error(self, err, restart=False):
        raise err


def emit_key(doc_id, m):
    return tuple(lambda_runs.emit_key(doc_id, m))


class Side:
    """One package's lambda with its collected output."""

    def __init__(self, package: str, **kw):
        self.package = package
        self.emits, self.nacks = [], []
        self.ctx = _Ctx()
        kw.setdefault("client_timeout_s", 0.0)
        mod = jseq if package == "jax" else tseq
        if package == "torch":
            kw.setdefault("device", "cpu")
            store = kw.get("merge_store")
            if isinstance(store, dict):
                kw["merge_store"] = tseq.MergeLaneStore(device="cpu",
                                                        **store)
        elif isinstance(kw.get("merge_store"), dict):
            kw["merge_store"] = jseq.MergeLaneStore(**kw["merge_store"])
        self.counters = jcounters if package == "jax" else tcounters
        self.before = {n: self.counters.get(n) for n in COUNTERS}
        self.lam = mod.TpuSequencerLambda(
            self.ctx, emit=lambda d, m: self.emits.append(emit_key(d, m)),
            nack=lambda d, c, n: self.nacks.append(
                tuple(lambda_runs.nack_key(d, c, n))),
            **kw)
        self.QM = JQueued if package == "jax" else TQueued
        self.from_wire = jwire.boxcar_from_wire if package == "jax" \
            else twire.boxcar_from_wire

    def counter_deltas(self):
        return {n: self.counters.get(n) - self.before[n] for n in COUNTERS}


class Pair:
    """The JAX lambda and the port's, built with the same arguments."""

    def __init__(self, **kw):
        self.jax = Side("jax", **kw)
        self.torch = Side("torch", **kw)

    def sides(self):
        return (self.jax, self.torch)

    def set(self, **attrs):
        for s in self.sides():
            for k, v in attrs.items():
                setattr(s.lam, k, v)


def feed(side: Side, frames, raw: bool) -> None:
    """Frames (offset, doc, bytes) into one lambda: handler_raw, or
    handler with the package's own decoded boxcar (an undecodable frame
    goes in as bytes, which handler routes to handler_raw)."""
    for offset, doc, data in frames:
        if raw:
            side.lam.handler_raw(side.QM(topic="rawdeltas", partition=0,
                                         offset=offset, key=doc,
                                         value=data))
            continue
        try:
            value = side.from_wire(data)
        except ValueError:
            value = data
        side.lam.handler(side.QM(topic="rawdeltas", partition=0,
                                 offset=offset, key=doc, value=value))


def drive(pair: Pair, waves, raw: bool, drain_each: bool = False) -> None:
    for frames in waves:
        for s in pair.sides():
            feed(s, frames, raw)
            s.lam.flush()
            if drain_each:
                s.lam.drain()
    for s in pair.sides():
        s.lam.drain()


def per_doc(emits):
    out = defaultdict(list)
    for e in emits:
        out[e[0]].append(e)
    return dict(out)


def views(lam, docs):
    out = {}
    for d in sorted(docs):
        for c in CHANNELS:
            out[(d, c)] = plain([
                lam.channel_text(d, "s", c),
                lam.channel_snapshot(d, "s", c),
                lam.channel_matrix(d, "s", c),
                lam.channel_directory(d, "s", c),
                lam.channel_items(d, "s", c)])
    return out


def lane_facts(lam):
    """Where each channel lives (bucket index: promotions), what went
    opaque, and the stores' recovery tallies."""
    m, l = lam.merge, lam.lww
    return {"merge_where": {repr(k): v[0] for k, v in m.where.items()},
            "lww_where": {repr(k): v[0] for k, v in l.where.items()},
            "merge_opaque": sorted(map(repr, m.opaque)),
            "lww_opaque": sorted(map(repr, l.opaque)),
            "folds": m.folds, "merge_drops": m.overflow_drops,
            "lww_drops": l.overflow_drops,
            "paged_rescues": m.paged_rescues,
            "poison": lam.poison_frames}


def outcome(side: Side, docs, summaries: bool = True) -> dict:
    lam = side.lam
    out = {"streams": per_doc(side.emits),
           "nacks": sorted(side.nacks),
           "views": views(lam, docs),
           "lanes": lane_facts(lam),
           "seqs": lam.doc_sequence_numbers(),
           "counters": side.counter_deltas()}
    if summaries:
        out["summary"] = plain(lam.summarize_documents())
        out["catchup"] = plain(lam.catchup_snapshot())
    return out


def assert_same(pair: Pair, docs, summaries: bool = True,
                counters: bool = True) -> dict:
    a = outcome(pair.jax, docs, summaries)
    b = outcome(pair.torch, docs, summaries)
    if not counters:
        a.pop("counters")
        b.pop("counters")
    for key in a:
        assert a[key] == b[key], key
    return a


def doc_names(waves):
    return sorted({doc for frames in waves for _o, doc, _b in frames})


# ---------------------------------------------------------------------------
# The object-path differential against the JAX lambda (the scalar deli's
# shape of tests/test_tpu_serving.py::TestDeviceTicketingVsScalarDeli)
# ---------------------------------------------------------------------------

def _deli_streams(seed: int):
    rng = random.Random(seed)
    docs = ["alpha", "beta"]
    clients = {d: [] for d in docs}
    cseq = {}
    streams = []
    for i in range(60):
        d = rng.choice(docs)
        roll = rng.random()
        if roll < 0.15 or not clients[d]:
            cid = f"c{seed}-{i}"
            clients[d].append(cid)
            cseq[(d, cid)] = 0
            streams.append((d, None, ingest.join(cid)))
        elif roll < 0.25:
            cid = clients[d].pop(rng.randrange(len(clients[d])))
            streams.append((d, None, ingest.leave(cid)))
        else:
            cid = rng.choice(clients[d])
            cseq[(d, cid)] += 1
            ref = 0 if rng.random() < 0.15 else rng.randrange(max(1, i))
            streams.append((d, cid, ingest.channel_op(
                cseq[(d, cid)], ref, "t", {
                    "type": 0, "pos1": 0, "seg": {"text": f"{i}"}})))
    return docs, streams


class TestObjectPathDifferential:
    @pytest.mark.parametrize("materialize", [False, True])
    @pytest.mark.parametrize("seed,flush_every", [(0, 1), (1, 3), (2, 7),
                                                  (3, 100)])
    def test_deli_differential(self, seed, flush_every, materialize):
        docs, streams = _deli_streams(seed)
        pair = Pair(materialize=materialize)
        for offset, (doc, cid, msg) in enumerate(streams):
            data = ingest.boxcar("t", doc, cid, [msg])
            for s in pair.sides():
                feed(s, [(offset, doc, data)], raw=False)
                if (offset + 1) % flush_every == 0:
                    s.lam.flush()
        for s in pair.sides():
            s.lam.flush()
        got = assert_same(pair, docs)
        assert got["nacks"], "the stream must exercise stale-ref nacks"

    def test_mixed_families(self):
        waves = ingest.mixed_waves(12, 4, seed=5)
        pair = Pair()
        drive(pair, waves, raw=False)
        got = assert_same(pair, doc_names(waves))
        assert got["nacks"]
        assert any(v[1] is not None for v in got["views"].values())

    def test_markers_and_annotates(self):
        J = ingest.join("c0")
        ops = [ingest.channel_op(i + 1, i + 1, "t", op) for i, op in
               enumerate([
                   {"type": 0, "pos1": 0, "seg": {"text": "hello"}},
                   {"type": 0, "pos1": 2, "seg": {
                       "marker": True, "props": {"tag": "h1"}}},
                   {"type": 2, "pos1": 0, "pos2": 4,
                    "props": {"bold": True, "size": 12}},
                   {"type": 1, "pos1": 1, "pos2": 2},
                   {"type": 2, "pos1": 1, "pos2": 3,
                    "props": {"bold": None}}])]
        waves = [[(0, "d0", ingest.boxcar("t", "d0", "c0", [J] + ops))]]
        pair = Pair()
        drive(pair, waves, raw=False)
        assert_same(pair, ["d0"])

    def test_promotion_and_opaque_degrade(self):
        """Tiny buckets (4, 16, 64), and both clients keep refSeq 2, so
        the collaboration window never moves and no row can fold: channel
        "t" (20 inserts) promotes twice, channel "a" (80 inserts) outgrows
        the last bucket and degrades to opaque, and channel "u" gets a run
        payload, which only a matrix axis can hold, and goes opaque at
        once."""
        csn = {"c0": 0, "c1": 0}
        off, waves = 0, []

        def frame(cid, msg):
            nonlocal off
            off += 1
            return (off, "pp", ingest.boxcar("t", "pp", cid, [msg]))

        def op(cid, chan, body):
            csn[cid] += 1
            return frame(cid, ingest.channel_op(csn[cid], 2, chan, body))

        text = {"type": 0, "pos1": 0, "seg": {"text": "ab"}}
        for w in range(4):
            frames = [frame(None, ingest.join(c)) for c in ("c0", "c1")] \
                if w == 0 else []
            for _ in range(10):
                frames += [op("c0", "a", text), op("c1", "a", text)]
            frames += [op("c0", "t", text) for _ in range(5)]
            if w == 2:
                frames.append(op("c0", "u", {"type": 0, "pos1": 0, "seg": {
                    "run": [1, 1, 0, 2]}}))
            waves.append(frames)
        pair = Pair(merge_store={"capacities": (4, 16, 64)})
        drive(pair, waves, raw=False)
        got = assert_same(pair, ["pp"])
        assert not got["nacks"]
        lanes = got["lanes"]
        assert lanes["merge_where"][repr(("pp", "s", "t"))] == 2
        assert repr(("pp", "s", "a")) in lanes["merge_opaque"]
        assert lanes["merge_drops"] > 0
        assert repr(("pp", "s", "u")) in lanes["merge_opaque"]

    def test_lww_clear_and_key_growth(self):
        msgs = [ingest.join("c0")]
        csn = 0
        for k in range(150):
            csn += 1
            msgs.append(ingest.channel_op(csn, csn, "m", {
                "type": "set", "key": f"k{k}", "value": k, "pid": "p"}))
        csn += 1
        msgs.append(ingest.channel_op(csn, csn, "m", {"type": "clear",
                                                      "pid": "p"}))
        for k in range(5):
            csn += 1
            msgs.append(ingest.channel_op(csn, csn, "m", {
                "type": "set", "key": f"z{k}", "value": [k], "pid": "p"}))
        waves = [[(0, "lw", ingest.boxcar("t", "lw", "c0", msgs))]]
        pair = Pair()
        drive(pair, waves, raw=False)
        got = assert_same(pair, ["lw"])
        # 150 keys outgrow the first key-capacity bucket (64).
        assert got["lanes"]["lww_where"][repr(("lw", "s", "m"))] == 1


# ---------------------------------------------------------------------------
# Snapshot seeding, crash restart, and a JAX checkpoint carried across
# ---------------------------------------------------------------------------

class _Blob:
    def __init__(self, content):
        self.content = content


class _Tree:
    def __init__(self, entries):
        self.entries = entries


def _summary(seq: int, text_entries, map_header):
    """A container summary in the shape the storage callable returns:
    .protocol + .app/.dataStores/<store>/.channels/<channel>."""
    text = _Tree({
        ".attributes": _Blob(json.dumps({"type": "sharedString"})),
        "header": _Blob(json.dumps({"seq": seq, "minSeq": 0,
                                    "chunkCount": 1})),
        "body_0": _Blob(json.dumps(text_entries))})
    mp = _Tree({
        ".attributes": _Blob(json.dumps(
            {"type": "https://graph.microsoft.com/types/map"})),
        "header": _Blob(json.dumps(map_header))})
    store = _Tree({".channels": _Tree({"t": text, "m": mp})})
    return _Tree({
        ".protocol": _Blob(json.dumps({"sequenceNumber": seq})),
        ".app": _Tree({".dataStores": _Tree({"s": store})})})


class TestSeedAndRestart:
    def test_snapshot_seeded_lanes(self):
        tree = _summary(3, [{"text": "base-"}],
                        {"k": {"type": "Plain", "value": 1}})
        msgs = [ingest.join("c0")] + [
            ingest.channel_op(i + 1, 4, "t", {
                "type": 0, "pos1": 0, "seg": {"text": f"{i}"}})
            for i in range(3)] + [
            ingest.channel_op(4, 4, "m", {"type": "set", "key": "j",
                                          "value": 2, "pid": "p"})]
        waves = [[(0, "sd", ingest.boxcar("t", "sd", "c0", msgs))]]
        pair = Pair(storage=lambda doc: tree if doc == "sd" else None)
        drive(pair, waves, raw=False)
        got = assert_same(pair, ["sd"])
        assert "base" in got["views"][("sd", "t")][0]

    @pytest.mark.parametrize("raw", [False, True])
    def test_crash_restart_from_checkpoint_and_deltas(self, raw):
        waves = ingest.mixed_waves(8, 6, seed=11)
        half = 3
        first = {}
        for pkg in ("jax", "torch"):
            coll = (JCollection if pkg == "jax" else Collection)
            first[pkg] = (coll(), coll(unique_key=jdelta_key if pkg == "jax"
                                       else delta_key))
        pair = Pair()
        for s in pair.sides():
            ck, deltas = first[s.package]
            s.lam.checkpoints, s.lam.deltas = ck, deltas
            s.lam.emit = _persisting(s, deltas)
        drive(pair, waves[:half], raw)
        for s in pair.sides():
            s.lam.close()
        # Crash: fresh lambdas restore from the checkpoint row and replay
        # the delta store into their lanes, then take the rest.
        pair2 = Pair.__new__(Pair)
        pair2.jax = Side("jax", checkpoints=first["jax"][0],
                         deltas=first["jax"][1])
        pair2.torch = Side("torch", checkpoints=first["torch"][0],
                           deltas=first["torch"][1])
        for s, old in zip(pair2.sides(), pair.sides()):
            s.emits = list(old.emits)
            s.nacks = list(old.nacks)
        drive(pair2, waves[half:], raw)
        assert_same(pair2, doc_names(waves), counters=False)
        assert pair2.torch.lam.docs and pair2.torch.ctx.offsets

    def test_jax_checkpoint_restores_into_the_port(self):
        """A JAX lambda runs half the stream and checkpoints; the port's
        lambda restores that row and delta store and runs the rest. The
        result equals the JAX lambda running the whole stream."""
        waves = ingest.mixed_waves(10, 6, seed=23)
        half = 3
        whole = Side("jax")
        drive_one(whole, waves, raw=True)

        ck, deltas = JCollection(), JCollection(unique_key=jdelta_key)
        first = Side("jax", checkpoints=ck, deltas=deltas)
        first.lam.emit = _persisting(first, deltas)
        drive_one(first, waves[:half], raw=True)
        first.lam.close()

        # The JAX rows are plain lists and dicts: the port's collections
        # take them as they are.
        port_ck, port_deltas = Collection(), Collection(
            unique_key=delta_key)
        port_ck.insert_many(ck.find(lambda d: True))
        port_deltas.insert_many(deltas.find(lambda d: True))
        second = Side("torch", checkpoints=port_ck, deltas=port_deltas)
        second.emits = list(first.emits)
        second.nacks = list(first.nacks)
        drive_one(second, waves[half:], raw=True)
        a = outcome(whole, doc_names(waves))
        b = outcome(second, doc_names(waves))
        for key in ("streams", "nacks", "views", "seqs", "summary"):
            assert a[key] == b[key], key
        # A catch-up artifact's "gen" counts change generations since
        # the process started, so a restarted lambda's differ.
        assert _without_gen(a["catchup"]) == _without_gen(b["catchup"])


def _without_gen(catchup: dict) -> dict:
    return {doc: {k: v for k, v in art.items() if k != "gen"}
            for doc, art in catchup.items()}


def drive_one(side: Side, waves, raw: bool) -> None:
    for frames in waves:
        feed(side, frames, raw)
        side.lam.flush()
    side.lam.drain()


def _persisting(side: Side, deltas):
    """An emit that also persists each sequenced message the way the
    scriptorium does (traces stripped, documentId added)."""
    from dataclasses import asdict

    def emit(doc_id, msg):
        side.emits.append(emit_key(doc_id, msg))
        record = asdict(msg)
        record["traces"] = []
        record["documentId"] = doc_id
        deltas.insert_one(record)
    return emit


# ---------------------------------------------------------------------------
# Ghost eviction (client_timeout_s > 0) on one clock that both packages read
# (the shape of tests/test_client_eviction.py on the device path)
# ---------------------------------------------------------------------------

class _Clock:
    """`time` as both sequencer modules see it: time() is the test's
    clock, every other name the real module's."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def clock(monkeypatch):
    clk = _Clock()
    monkeypatch.setattr(jseq, "time", clk)
    monkeypatch.setattr(tseq, "time", clk)
    return clk


TIMEOUT_S = 10.0
# (seconds from the start, [(doc, client, messages)]). Doc "ev": c0 writes
# every wave until it leaves, c1 joins and falls silent (evicted at 20 s);
# c0's leave then empties the table (NoClient) before c2 joins. Doc
# "lone": g writes once and falls silent; h's join at 20 s makes the doc
# active, so g is evicted; k's join at 50 s evicts the silent h.
EVICTION_WAVES = [
    (0.0, [("ev", None, [ingest.join("c0"), ingest.join("c1")]),
           ("ev", "c0", [ingest.channel_op(1, 2, "t", {
               "type": 0, "pos1": 0, "seg": {"text": "a"}})]),
           ("lone", None, [ingest.join("g")]),
           ("lone", "g", [ingest.channel_op(1, 1, "t", {
               "type": 0, "pos1": 0, "seg": {"text": "g"}})])]),
    (5.0, [("ev", "c0", [ingest.channel_op(2, 3, "t", {
        "type": 0, "pos1": 0, "seg": {"text": "b"}})])]),
    (20.0, [("ev", "c0", [ingest.channel_op(3, 4, "t", {
        "type": 0, "pos1": 0, "seg": {"text": "c"}})]),
            ("lone", None, [ingest.join("h")])]),
    (22.0, [("ev", "c0", [ingest.channel_op(4, 5, "t", {
        "type": 0, "pos1": 1, "seg": {"text": "d"}})]),
            ("ev", None, [ingest.leave("c0"), ingest.join("c2")])]),
    (50.0, [("ev", "c2", [ingest.channel_op(1, 9, "t", {
        "type": 1, "pos1": 0, "pos2": 1})]),
            ("lone", None, [ingest.join("k")])]),
]


class _EvictionFeed:
    """Feeds EVICTION_WAVES to a pair on the shared clock, with fresh
    offsets; with send_system, the leaves each lambda synthesizes are
    collected and fed back to it in the next wave, as the raw log would."""

    def __init__(self, pair: Pair, clock: _Clock, raw: bool,
                 send_system: bool):
        self.pair, self.clock, self.raw = pair, clock, raw
        self.offset = 0
        self.sent = {s.package: [] for s in pair.sides()}
        if send_system:
            for s in pair.sides():
                s.lam.send_system = \
                    lambda doc, msg, out=self.sent[s.package]: \
                    out.append((doc, msg.type, msg.data))

    def run(self, waves) -> None:
        for at, items in waves:
            self.clock.now = 1000.0 + at
            # The leaves sent at the last flush precede this wave's
            # traffic in the log.
            back = {pkg: self._fed_back(sent)
                    for pkg, sent in self.sent.items()}
            assert back["jax"] == back["torch"]
            for s in self.pair.sides():
                self.sent[s.package].clear()
            frames = []
            for doc, data in back["jax"] + [
                    (doc, ingest.boxcar("t", doc, cid, msgs))
                    for doc, cid, msgs in items]:
                frames.append((self.offset, doc, data))
                self.offset += 1
            for s in self.pair.sides():
                feed(s, frames, self.raw)
                s.lam.flush()
                s.lam.drain()

    @staticmethod
    def _fed_back(sent):
        return [(doc, ingest.boxcar("t", doc, None, [ingest.message(
            0, -1, type_, data=data)])) for doc, type_, data in sent]


def _evicted(streams) -> list:
    return [(e[0], json.loads(e[8])["clientId"]) for s in streams.values()
            for e in s if e[3] == "leave" and e[8]
            and json.loads(e[8]).get("evicted")]


class TestGhostEviction:
    @pytest.mark.parametrize("send_system", [False, True])
    @pytest.mark.parametrize("raw", [False, True])
    def test_silent_writers_evicted(self, clock, raw, send_system):
        pair = Pair(client_timeout_s=TIMEOUT_S)
        feeder = _EvictionFeed(pair, clock, raw, send_system)
        feeder.run(EVICTION_WAVES)
        # The last wave's synthesized leaves (send_system) ride the log.
        feeder.run([(60.0, [])])
        got = assert_same(pair, ["ev", "lone"])
        assert sorted(_evicted(got["streams"])) == [
            ("ev", "c1"), ("lone", "g"), ("lone", "h")]
        ev = got["streams"]["ev"]
        assert any(e[3] == "noClient" for e in ev)
        # With the ghost gone the MSN tracks c0 alone.
        last_c0 = [e for e in ev if e[4] == "c0" and e[3] == "op"][-1]
        assert last_c0[2] == last_c0[6]

    @pytest.mark.parametrize("fresh_log", [False, True])
    @pytest.mark.parametrize("raw", [False, True])
    def test_eviction_survives_restart(self, clock, raw, fresh_log):
        """A ghost present at the crash still ages out after the restart
        (last_seen restamped from the restored client table); the
        timeout comes from the deli.clientTimeoutMsec config; with
        fresh_log the restarted lambdas take a new log from offset 0."""
        colls = {pkg: ((JCollection(), JCollection(unique_key=jdelta_key))
                       if pkg == "jax" else
                       (Collection(), Collection(unique_key=delta_key)))
                 for pkg in ("jax", "torch")}
        config = {"deli.clientTimeoutMsec": TIMEOUT_S * 1000}
        pair = Pair(config=config)
        for s in pair.sides():
            s.lam.checkpoints, s.lam.deltas = colls[s.package]
            s.lam.emit = _persisting(s, colls[s.package][1])
        feeder = _EvictionFeed(pair, clock, raw, send_system=False)
        feeder.run(EVICTION_WAVES[:2])
        for s in pair.sides():
            s.lam.close()
        clock.now = 1000.0 + 6.0
        pair2 = Pair.__new__(Pair)
        for pkg in ("jax", "torch"):
            side = Side(pkg, config=config, fresh_log=fresh_log,
                        checkpoints=colls[pkg][0], deltas=colls[pkg][1])
            old = getattr(pair, pkg)
            side.emits, side.nacks = list(old.emits), list(old.nacks)
            setattr(pair2, pkg, side)
        assert pair2.torch.lam.client_timeout_s == TIMEOUT_S
        feeder2 = _EvictionFeed(pair2, clock, raw, send_system=False)
        feeder2.offset = 0 if fresh_log else feeder.offset
        feeder2.run(EVICTION_WAVES[2:])
        got = assert_same(pair2, ["ev", "lone"], counters=False)
        assert sorted(_evicted(got["streams"])) == [
            ("ev", "c1"), ("lone", "g"), ("lone", "h")]


class TestReadSide:
    def test_async_summary_and_catchup_watermarks(self):
        """summarize_documents_async equals the synchronous summary; a
        published catch-up artifact is not refreshed again until its
        document changes; both packages agree on every step."""
        import threading
        waves = ingest.mixed_waves(8, 3, seed=9)
        pair = Pair()
        drive(pair, waves, raw=True)
        results = []
        for s in pair.sides():
            lam = s.lam
            done, got = threading.Event(), {}

            def on_done(out, got=got, done=done):
                got["out"] = out
                done.set()
            lam.summarize_documents_async(on_done).join()
            assert done.is_set()
            sync = plain(lam.summarize_documents())
            assert plain(got["out"]) == sync
            first = lam.catchup_snapshot()
            for doc, art in first.items():
                lam.catchup_mark_published(doc, art["gen"])
            again = lam.catchup_snapshot()
            only = lam.catchup_snapshot(only_docs={"x0"})
            results.append((sync, plain(first), plain(again), plain(only),
                            {d: lam.document_seq(d) for d in ("x0", "x1",
                                                              "nope")},
                            lam.occupancy_hints()))
        assert results[0] == results[1]
        assert results[1][1] and not results[1][2]
