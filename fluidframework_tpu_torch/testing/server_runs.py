"""The local server's scenario, run the same way on either package.

`run` drives a seeded fleet through a package's `TpuLocalServer` (or its
`LocalServer`, the scalar deli) the way a user drives it: `connect`,
`Connection.submit` of boxcars of DocumentMessages, `pump`, the
broadcaster's `drain_broadcast`, then summaries through the scribe, a
restart of the ingest tier, `refresh_catchup` / `get_catchup` and
`write_materialized_snapshots`. It returns digests (sha256 of a canonical
JSON, as testing/lambda_runs.py does) of everything a client or the
storage tier can observe, so two runs compare by equality:

- each reader's received stream, in order;
- each writer's nacks (and the admission nacks among them, which must be
  none), and the fan-outs the broadcaster's shards shed (none either);
- the delta store per document, the channel texts, the scribe's
  checkpoints;
- the summary commits' trees and the materialized snapshots' trees;
- the catch-up artifacts.

The scenario takes a `ServerPackage`: the local_server, storage,
protocol.messages and protocol.summary modules of one package, plus
keyword arguments for TpuLocalServer (device="cuda" or "cpu" for the
port). chip_smoke.py phase 17 runs it on the card and, in a child
process, on the CPU; tests/test_torch_server_golden.py runs it through
the JAX package to build testing/golden/server_golden.json. Apart from
`port_package`, which loads the port's modules, this module needs
neither torch nor JAX.

Two things a server takes from outside are pinned for the run, in the
package's own modules, and restored afterwards: the client ids that
`connect` mints (`uuid.uuid4` in local_server, a seeded sequence here)
and the commit clock of the git store (`time.time` in storage, a
counter), so commit shas, which summaryAck messages and catch-up
artifacts carry, are equal across runs. The configuration turns off the
two controls that read the wall clock: ghost-client eviction
(`deli.clientTimeoutMsec` 0) and admission's latency term (its SLO stage
names a histogram nothing records), so that admission decides by queue
depth alone, which the scenario sets.
"""

from __future__ import annotations

import json
import random
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from .lambda_runs import digest, emit_key

STORE, TEXT, KV, COUNTER = "s", "t", "kv", "n"
# The server variants: run(pkg, spec, **VARIANTS[name]).
VARIANTS = {"bucketed": {}, "paged": {"paged": True},
            "overlapped": {"overlapped": True}, "scalar": {"tpu": False}}
ADMISSION_CODES = (429, 503)


class ServerPackage(NamedTuple):
    local_server: Any      # server/local_server module
    storage: Any           # server/storage module
    messages: Any          # protocol/messages module
    summary: Any           # protocol/summary module
    kwargs: dict           # extra TpuLocalServer arguments (device=...)


def port_package(device) -> ServerPackage:
    """The port's ServerPackage on `device` (its modules import torch, so
    they load here, on the first call)."""
    from ..protocol import messages, summary
    from ..server import local_server, storage
    return ServerPackage(local_server, storage, messages, summary,
                         {"device": device})


class Spec(NamedTuple):
    """One fleet. Document d has one writer; every `lww_every`-th also
    sends map sets and a counter increment, every `storm_every`-th types
    `storm_ops` a wave, every `reader_every`-th has a read connection,
    every `summary_every`-th uploads a summary, every `catchup_every`-th
    is read through get_catchup, and every `touch_every`-th is touched
    between the full and the incremental materialized write."""
    docs: int
    ops: int = 32               # inserts a writer a wave
    boxcar: int = 8             # inserts a boxcar
    warm: int = 10
    measured: int = 3
    extra: int = 1              # waves after the ingest restart
    lww_every: int = 8
    lww_sets: int = 4
    storm_every: int = 512
    storm_ops: int = 128
    reader_every: int = 64
    summary_every: int = 64
    catchup_every: int = 64
    touch_every: int = 100
    partitions: int = 2
    seed: int = 17


def config(spec: Spec) -> dict:
    """The server's configuration: the whole-pipeline soak's layout
    (bench.py:3668-3672: 2 broadcaster shards, catch-up on), admission
    and broadcaster queues above one wave's records and messages (a full
    shard queue sheds its oldest fan-outs, which readers then miss by
    timing), and the two wall-clock controls off (module docstring)."""
    return {"broadcaster.shards": 2, "catchup.enabled": True,
            "broadcaster.queueLimit": 65536,
            "admission.queueLimit": 65536,
            "admission.sloStage": "server_runs.unrecorded",
            "deli.clientTimeoutMsec": 0}


class _Cfg(dict):
    def get(self, key, default=None):
        return dict.get(self, key, default)


class _SeededUuid:
    """Stands in for the uuid module in local_server: uuid4() draws from
    one seeded sequence."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def uuid4(self):
        return _Hex(f"{self._rng.getrandbits(128):032x}")


class _Hex(NamedTuple):
    hex: str


class _CommitClock:
    """Stands in for the time module in storage: time() counts commits."""

    def __init__(self):
        self._n = 0

    def time(self) -> float:
        self._n += 1
        return float(self._n)


class _Writer:
    def __init__(self, conn):
        self.conn = conn
        self.csn = 0
        self.seen = 0          # the last sequence number delivered to it
        self.nacks: List[list] = []
        conn.on("op", self._op)
        conn.on("nack", self._nack)

    def _op(self, m) -> None:
        self.seen = max(self.seen, m.sequence_number)

    def _nack(self, n) -> None:
        op = n.operation
        self.nacks.append([self.conn.document_id, self.conn.client_id,
                           n.sequence_number, n.content.code,
                           n.content.message,
                           None if op is None
                           else op.client_sequence_number])


def _insert(text: str) -> dict:
    return {"type": 0, "pos1": 0, "seg": {"text": text}}


def _channel(channel: str, op) -> dict:
    return {"address": STORE, "contents": {"address": channel,
                                           "contents": op}}


class _Fleet:
    """The scenario's state on one server."""

    def __init__(self, pkg: ServerPackage, spec: Spec, server):
        self.pkg, self.spec, self.server = pkg, spec, server
        self.docs = [f"d{d}" for d in range(spec.docs)]
        self.writers: Dict[str, _Writer] = {}
        self.readers: Dict[str, list] = {}
        self.wave_no = 0

    def connect(self) -> None:
        for d, doc in enumerate(self.docs):
            self.writers[doc] = _Writer(self.server.connect(doc))
            if d % self.spec.reader_every == 0:
                got = self.readers[doc] = []
                conn = self.server.connect(doc, {"mode": "read"})
                conn.on("op", lambda m, doc=doc, got=got:
                        got.append(emit_key(doc, m)))
        self.settle()

    def settle(self) -> None:
        self.server.pump()
        self.server.drain_broadcast()

    def _message(self, w: _Writer, contents, type_=None):
        M = self.pkg.messages
        w.csn += 1
        return M.DocumentMessage(
            client_sequence_number=w.csn, reference_sequence_number=w.seen,
            type=M.MessageType.OPERATION if type_ is None else type_,
            contents=contents)

    def submit_wave(self, only: Optional[List[int]] = None) -> int:
        """One wave's boxcars from every writer (or the writers of the
        documents `only` names); returns the ops submitted."""
        spec, wave = self.spec, self.wave_no
        self.wave_no += 1
        rng = random.Random(spec.seed * 1000 + wave)
        n_ops = 0
        for d in (range(spec.docs) if only is None else only):
            w = self.writers[self.docs[d]]
            ops = spec.storm_ops if d % spec.storm_every == 0 else spec.ops
            msgs = []
            for i in range(ops):
                n = rng.randrange(1, 4)
                letter = chr(ord("a") + (wave + i) % 26)
                msgs.append(self._message(w, _channel(
                    TEXT, _insert(letter * n))))
            for i in range(0, ops, spec.boxcar):
                w.conn.submit(msgs[i:i + spec.boxcar])
            n_ops += ops
            if d % spec.lww_every == 0:
                msgs = [self._message(w, _channel(KV, {
                    "type": "set", "key": f"k{(wave + j) % 6}",
                    "value": {"type": "Plain",
                              "value": rng.randrange(1000)},
                    "pid": w.csn + 1}))
                    for j in range(spec.lww_sets)]
                msgs.append(self._message(w, _channel(COUNTER, {
                    "type": "increment", "delta": 1 + wave % 3})))
                w.conn.submit(msgs)
                n_ops += len(msgs)
        return n_ops

    def wave(self, only: Optional[List[int]] = None) -> int:
        n = self.submit_wave(only)
        self.settle()
        return n

    def summarize(self) -> List[str]:
        """Each summary document's writer uploads a summary (a proposal:
        the ref does not move) and sends the SUMMARIZE op; the scribe
        acks it and advances the ref."""
        M, S = self.pkg.messages, self.pkg.summary
        out = []
        for d in range(0, self.spec.docs, self.spec.summary_every):
            doc = self.docs[d]
            w = self.writers[doc]
            tree = S.SummaryTree()
            tree.add_blob(".protocol", json.dumps(
                {"sequenceNumber": w.seen}))
            tree.add_tree(".app").add_blob(
                "note", json.dumps({"doc": doc, "seen": w.seen}))
            sha = self.server.storage(doc).write_summary(tree)
            w.conn.submit([self._message(
                w, {"handle": sha, "head": None, "message": "summary",
                    "parents": []}, type_=M.MessageType.SUMMARIZE)])
            out.append(doc)
        self.settle()
        return out


def _texts(server, docs) -> Optional[dict]:
    if not hasattr(server, "sequencer_for"):
        return None
    return {doc: server.sequencer_for(doc).channel_text(doc, STORE, TEXT)
            for doc in docs}


def _deltas(server, docs) -> dict:
    """get_deltas of every document, from one read of the delta store."""
    out: Dict[str, list] = {doc: [] for doc in docs}
    for r in server.deltas.find(lambda r: r["documentId"] in out):
        out[r["documentId"]].append(
            {k: v for k, v in r.items() if k not in ("timestamp", "traces")})
    for rows in out.values():
        rows.sort(key=lambda r: r["sequence_number"])
    return out


def _tree_of(server, doc: str, commit_sha: Optional[str]):
    if commit_sha is None:
        return None
    return server.storage(doc).get(commit_sha).tree_sha


def _promoted(server) -> int:
    """Merge lanes above the first capacity bucket (bucketed layout)."""
    n = 0
    for seq in server.ingest.sequencers():
        merge = getattr(seq, "merge", None)
        if merge is not None and not merge.paged:
            n += sum(1 for b, _lane in merge.where.values() if b > 0)
    return n


def run(pkg: ServerPackage, spec: Spec, tpu: bool = True,
        paged: bool = False, overlapped: bool = False,
        native_log: bool = False,
        hooks: Optional[Dict[str, Callable]] = None) -> dict:
    """The scenario on one package's server (TpuLocalServer when `tpu`,
    else LocalServer), over the C++ message log when `native_log` (the
    pure-Python log otherwise). hooks["measured"](server, run_waves) runs the
    measured waves (run_waves(on_wave) submits and settles them, calling
    on_wave(i, n_ops, submit_s, pump_s, drain_s) after each), so a
    caller can time, trace and count them."""
    hooks = hooks or {}
    saved = (pkg.local_server.uuid, pkg.storage.time)
    pkg.local_server.uuid = _SeededUuid(spec.seed)
    pkg.storage.time = _CommitClock()
    try:
        return _run(pkg, spec, tpu, paged, overlapped, native_log, hooks)
    finally:
        pkg.local_server.uuid, pkg.storage.time = saved


def _run(pkg, spec, tpu, paged, overlapped, native_log, hooks) -> dict:
    L = pkg.local_server
    kw = dict(auto_pump=False, partitions=spec.partitions,
              overlapped=overlapped, native_log=native_log,
              config=_Cfg(config(spec)))
    if tpu:
        server = L.TpuLocalServer(paged_lanes=paged, **kw, **pkg.kwargs)
    else:
        server = L.LocalServer(**kw)
    fleet = _Fleet(pkg, spec, server)
    fleet.connect()
    n_ops = 0
    for _ in range(spec.warm):
        n_ops += fleet.wave()

    def run_waves(on_wave=None) -> int:
        total = 0
        for i in range(spec.measured):
            t0 = time.perf_counter()
            n = fleet.submit_wave()
            t1 = time.perf_counter()
            server.pump()
            t2 = time.perf_counter()
            server.drain_broadcast()
            t3 = time.perf_counter()
            total += n
            if on_wave is not None:
                on_wave(i, n, t1 - t0, t2 - t1, t3 - t2)
        return total

    if "measured" in hooks:
        n_ops += hooks["measured"](server, run_waves)
    else:
        n_ops += run_waves()
    summarized = fleet.summarize()
    server.ingest.restart_all()
    for _ in range(spec.extra):
        n_ops += fleet.wave()

    out: Dict[str, Any] = {"docs": spec.docs, "ops": n_ops,
                           "waves": fleet.wave_no}
    catchup_docs = fleet.docs[1::spec.catchup_every]
    touched = list(range(0, spec.docs, spec.touch_every))
    if tpu:
        tail = hooks.get("tail", lambda name, fn: fn())
        refreshed = tail("refresh_catchup", server.refresh_catchup)
        artifacts = tail("get_catchup", lambda: {
            doc: server.get_catchup(doc) for doc in catchup_docs})
        full = tail("materialize_full",
                    server.write_materialized_snapshots)
        fleet.wave(only=touched)
        incremental = tail("materialize_incremental",
                           server.write_materialized_snapshots)
        out.update(
            refreshed=refreshed,
            catchup=digest(artifacts),
            catchup_docs=sum(a is not None for a in artifacts.values()),
            materialized_full=digest({d: _tree_of(server, d, s)
                                      for d, s in full.items()}),
            materialized_incremental=digest(
                {d: _tree_of(server, d, s)
                 for d, s in incremental.items()}),
            materialized_docs=len(full),
            promoted=_promoted(server))
    else:
        fleet.wave(only=touched)
    server.drain_broadcast()

    nacks = {doc: w.nacks for doc, w in fleet.writers.items() if w.nacks}
    texts = _texts(server, fleet.docs)
    checkpoints = sorted(server.scribe_checkpoints.find(
        lambda d: "documentId" in d), key=lambda r: r["documentId"])
    out.update(
        readers=len(fleet.readers),
        reader_messages=sum(len(v) for v in fleet.readers.values()),
        streams=digest(fleet.readers),
        nacks=digest(nacks),
        nack_count=sum(len(v) for v in nacks.values()),
        admission_nacks=sum(1 for v in nacks.values() for n in v
                            if n[3] in ADMISSION_CODES),
        shed=sum(b.shed_count() for b in server.broadcasters),
        deltas=digest(_deltas(server, fleet.docs)),
        texts=None if texts is None else digest(texts),
        chars=None if texts is None
        else sum(len(t or "") for t in texts.values()),
        checkpoints=digest(checkpoints),
        summaries=digest({doc: _tree_of(server, doc, server.storage(
            doc).get_ref("main")) for doc in summarized}),
        summaries_acked=sum(
            1 for doc in summarized
            if server.storage(doc).get_ref("main") is not None))
    return out
