"""LocalServer: the full ordering service in one process.

A copy of fluidframework_tpu's server/local_server.py, host code that the
port keeps as its own.

Capability parity with reference local-server's LocalDeltaConnectionServer
(localDeltaConnectionServer.ts:59) + memory-orderer's LocalOrderer
(localOrderer.ts:87-260): the *real* Deli/Scriptorium/Scribe/Broadcaster/
Copier lambdas run over the in-memory MessageLog ("LocalKafka"), fronted by
an Alfred-shaped connection API — the contract point for the local driver
and the test backbone (SURVEY.md §4.4).

Message flow (reference docker-compose pipeline):
  Connection.submit -> boxcar -> 'rawdeltas' topic
  DeliLambda: ticket -> 'deltas' topic (+ nacks straight to the socket)
  ScriptoriumLambda -> deltas collection (catch-up queries)
  ScribeLambda -> summary commits + summaryAck/Nack back through 'rawdeltas'
  BroadcasterLambda -> connected Connection listeners
"""

from __future__ import annotations

import itertools
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.device import resolve_device
from ..core.events import TypedEventEmitter
from ..telemetry import tracing
from ..telemetry.counters import record_swallow
from ..protocol.messages import (
    Boxcar,
    DocumentMessage,
    MessageType,
    Nack,
    NackContent,
    NACK_NOT_WRITER,
    NACK_SERVICE_UNAVAILABLE,
    NACK_THROTTLED,
    NACK_TOO_LARGE,
    SequencedDocumentMessage,
    SignalMessage,
    op_size,
)
from ..telemetry.counters import increment
from . import admission as admission_mod
from .admission import AdmissionController, admission_from_config
from .database import DatabaseManager
from .lambdas import (
    BroadcasterLambda,
    CopierLambda,
    DeliLambda,
    ScribeLambda,
    ScriptoriumLambda,
)
from .lambdas.scriptorium import delta_key, query_deltas
from .log import MessageLog, make_message_log
from .partition import (LambdaRunner, OverlappedLambdaRunner,
                        PartitionManager)
from .sharding import SequencerShardSet
from .storage import Historian

RAW_TOPIC = "rawdeltas"
DELTAS_TOPIC = "deltas"


class _TokenBucket:
    """Per-connection op-rate limiter (reference alfred throttler):
    refills at `rate` ops/s up to `burst`; take() returns 0.0 when
    admitted or the seconds to wait (the 429 retryAfter)."""

    def __init__(self, rate: float, burst: float):
        import time as _time
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self._now = _time.monotonic
        self.last = self._now()

    def take(self, n: int = 1) -> float:
        """Debt model: admitted whenever at least one token is available,
        going negative for n > balance — a boxcar'd resubmit batch larger
        than the burst must still be admittable EVENTUALLY (batches are
        atomic and cannot split), it just pays the debt in future waits.
        Classic take-n-or-nack would livelock such a batch forever."""
        now = self._now()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= n
            return 0.0
        return (1.0 - self.tokens) / self.rate


class Connection(TypedEventEmitter):
    """A client's delta connection (the "websocket"). Events: "op"
    (SequencedDocumentMessage), "nack" (Nack), "signal" (SignalMessage),
    "disconnect"."""

    def __init__(self, server: "LocalServer", tenant_id: str,
                 document_id: str, client_id: str, details: Optional[dict]):
        super().__init__()
        self.server = server
        self.tenant_id = tenant_id
        self.document_id = document_id
        self.client_id = client_id
        self.details = details or {}
        # "read" connections observe the room (ops + signals) without ever
        # entering the quorum or the MSN calculation (reference read/write
        # connection modes: only writers order a join op).
        self.mode = self.details.get("mode", "write")
        # Throttle bucket is per DOCUMENT and lives on the server (the
        # reference alfred throttler keys tenant+document): a client
        # cannot mint a fresh budget by reconnecting.
        self.bucket = server._throttle_bucket(document_id)
        self.connected = True

    def submit(self, messages: List[DocumentMessage]) -> None:
        if not self.connected:
            raise ConnectionError("connection closed")
        if self.mode == "read":
            self.emit("nack", Nack(
                messages[0] if messages else None, -1,
                NackContent(NACK_NOT_WRITER,
                            "read connections cannot submit ops")))
            return
        # Op-size ceiling at the front door (reference alfred
        # maxMessageSize): oversized content nacks 413 before entering the
        # pipeline — the ONE choke point both sequencer paths sit behind,
        # off the partition-lambda hot path. Clients chunk far below it.
        limit = self.server.max_op_bytes
        if limit:
            for msg in messages:
                if op_size(msg) > limit:
                    self.emit("nack", Nack(
                        msg, -1, NackContent(
                            NACK_TOO_LARGE,
                            f"op exceeds {limit} bytes")))
                    return
        # Overload admission (server/admission.py): the GLOBAL gate —
        # occupancy-driven throttle/shed/degrade with a server-computed
        # retry_after — sits before the per-document token bucket (a
        # local rate nit is pointless to evaluate on traffic the process
        # cannot absorb at all).
        adm = self.server.admission
        # The document's home partition (sharded ingest tier): admission
        # applies its per-partition fairness bound on top of the global
        # ladder, so one hot partition throttles without starving
        # siblings. None on a single-partition core (no gate to apply).
        part = self.server.ingest_partition(self.document_id)
        if adm is not None and messages:
            ctx = tracing.first_message_context(messages)
            # The whole batch rides ONE boxcar record — the unit
            # raw_backlog() polls — so it enters the controller's queue
            # accounting as records=1 while credits/counters see the op
            # count.
            decision = adm.admit(
                self.tenant_id, kind=admission_mod.CLASS_OP,
                count=len(messages), records=1,
                partition=part,
                trace_id=getattr(ctx, "trace_id", None))
            if not decision.admitted:
                code = NACK_SERVICE_UNAVAILABLE \
                    if decision.state == admission_mod.DEGRADE \
                    else NACK_THROTTLED
                self.emit("nack", Nack(
                    messages[0] if messages else None, -1,
                    NackContent(code,
                                f"admission {decision.state}: "
                                f"{decision.reason}",
                                retry_after_s=decision.retry_after_s)))
                return
        if self.bucket is not None:
            wait = self.bucket.take(len(messages))
            if wait > 0:
                # Reference alfred throttler: nack 429 with retryAfter;
                # the client backs off and resubmits. The admitted batch
                # never reaches the queue — retract it so the phantom
                # record doesn't read as drained at the next observe.
                if adm is not None and messages:
                    adm.retract(len(messages), records=1, partition=part,
                                tenant=self.tenant_id)
                self.emit("nack", Nack(
                    messages[0] if messages else None, -1,
                    NackContent(NACK_THROTTLED, "op rate limit",
                                retry_after_s=wait)))
                return
        # The ingest span parents on the first stamped op in the batch;
        # with auto_pump the whole pipeline pump (deli ticket, serving
        # flush, fan-out) nests under it on this thread.
        with tracing.span("server.ingest",
                          parent=tracing.first_message_context(messages),
                          document=self.document_id):
            # The home partition computed for the admission gate above
            # rides through so the produce path never hashes twice.
            self.server._submit_boxcar(Boxcar(
                tenant_id=self.tenant_id, document_id=self.document_id,
                client_id=self.client_id, contents=list(messages)),
                partition=part)

    def submit_signal(self, content: Any) -> None:
        """Transient broadcast: the signal fans out to every connection in
        the document's room (submitter included) WITHOUT touching the
        sequencer or the log — client-relative ordering only (reference
        alfred submitSignal, lambdas/src/alfred/index.ts:305-328)."""
        if not self.connected:
            raise ConnectionError("connection closed")
        adm = self.server.admission
        if adm is not None:
            # Signals are the FIRST class shed under pressure (transient
            # presence traffic, cheap to regenerate): dropped silently —
            # a fire-and-forget channel has no retry contract.
            decision = adm.admit(self.tenant_id,
                                 kind=admission_mod.CLASS_SIGNAL)
            if not decision.admitted:
                return
        self.server._broadcast_signal(self.document_id, SignalMessage(
            client_id=self.client_id, content=content))

    def disconnect(self) -> None:
        if not self.connected:
            return
        self.connected = False
        self.server._client_leave(self)
        self.emit("disconnect")


class LocalServer:
    """One in-process ordering + storage service (single tenant scope per
    instance is fine; tenant_id still namespaces storage)."""

    def __init__(self, tenant_id: str = "local", partitions: int = 1,
                 auto_pump: bool = True,
                 native_log: Optional[bool] = False,
                 db: Optional[DatabaseManager] = None,
                 historian: Optional[Historian] = None,
                 config=None, overlapped: bool = False,
                 admission: Optional[AdmissionController] = None):
        """native_log: False = pure-Python broker (default, the LocalKafka
        role); True or None = the C++ engine (native/oplog.py), built at
        first use; a failed build raises.

        admission: an overload controller to share (alfred passes ONE
        across every tenant core so credits fair-share between tenants);
        None constructs a per-core controller unless config disables it
        (admission.enabled=false).

        db/historian: pass shared instances to make this core one node of a
        cluster over common durable services (the reference's Mongo + git);
        deli/scribe then resume from any checkpoints already present —
        the multi-node takeover path (server/nodes.py).

        overlapped: pump the lambda stages concurrently (OverlappedLambda
        Runner — sequencing batch N+1 while batch N's persistence flushes);
        the serial runner stays the deterministic default."""
        self.tenant_id = tenant_id
        self.auto_pump = auto_pump
        self.overlapped = overlapped
        # Front-door op-size ceiling (alfred.maxMessageSize; 0 disables).
        self.max_op_bytes = 1024 * 1024
        # Per-connection op-rate throttling (reference alfred throttler):
        # disabled unless configured — in-process tests and benches hammer
        # ops by design.
        self.throttle_ops_per_s = 0.0
        self.throttle_burst = 0.0
        self._throttle_buckets: Dict[str, _TokenBucket] = {}
        if config is not None:
            self.max_op_bytes = int(config.get(
                "alfred.maxMessageSize", self.max_op_bytes))
            self.throttle_ops_per_s = float(config.get(
                "alfred.throttling.opsPerSecond", 0))
            self.throttle_burst = float(config.get(
                "alfred.throttling.burst", 0))
            if self.throttle_ops_per_s and self.throttle_burst <= 0:
                # An explicit burst of 0 with a live rate would nack every
                # op forever (empty bucket can never refill past 0):
                # treat non-positive as "derive a sane default".
                self.throttle_burst = max(self.throttle_ops_per_s * 2, 10)
        self.log = make_message_log(default_partitions=partitions,
                                    native=native_log)
        self.db = db if db is not None else DatabaseManager()
        self.historian = historian if historian is not None else Historian()
        self.deltas = self.db.collection("deltas", unique_key=delta_key)
        self.raw_deltas = self.db.collection("rawdeltas")
        self.deli_checkpoints = self.db.collection("deliCheckpoints")
        self.scribe_checkpoints = self.db.collection("scribeCheckpoints")
        self._connections: Dict[str, List[Connection]] = {}
        # Fired after scribe validates + commits a summary (advancing the
        # ref): (document_id, commit_sha). The historian cache tier hooks
        # in here for write-through invalidation + warm prefetch
        # (server/historian.py; alfred registers the notifier).
        self.summary_commit_listeners: List[Callable[[str, str], None]] = []
        # Broadcaster room membership lives here (not in the lambda) so it
        # survives lambda crash-restarts; the lambda reads it by reference.
        self._rooms: Dict[str, List] = {}
        # Sharded broadcast fan-out (docs/read_path.md): 0 = inline
        # (deterministic, the pump delivers synchronously — the default
        # every in-process test relies on); N > 0 = doc-hash-sharded
        # worker threads with bounded per-shard queues, so a reconnect
        # avalanche or one hot document cannot serialize every
        # subscriber through a single pump thread.
        self.broadcaster_shards = 0
        self.broadcaster_queue_limit = 1024
        if config is not None:
            self.broadcaster_shards = int(config.get(
                "broadcaster.shards", 0))
            self.broadcaster_queue_limit = int(config.get(
                "broadcaster.queueLimit", self.broadcaster_queue_limit))
        self.broadcasters: List[BroadcasterLambda] = []
        # Read-path catch-up artifacts (server/readpath.py): populated by
        # TpuLocalServer (artifacts are materialized from device lanes);
        # the scalar pipeline serves None and clients tail-replay.
        self.catchup = None
        # Fired on every artifact publish: (tenant_id, document_id,
        # artifact) — an external historian tier hooks in here the same
        # way summary_commit_listeners feeds cache invalidation.
        self.catchup_listeners: List[Callable[[str, str, dict], None]] = []
        # Signal fan-out rooms: transient messages never enter the log, so
        # they get their own listener lists (reference: socket.io room emit
        # straight from alfred, no Kafka hop).
        self._signal_rooms: Dict[str, List] = {}
        self._client_counter = itertools.count(1)
        self._pump_lock = threading.RLock()
        # Optional pre-pump gate (multi-node fencing): called before the
        # lambdas run; returning False aborts the pump — the node lost its
        # reservation and must not sequence another op (server/nodes.py).
        self.pump_gate: Optional[Callable[[], bool]] = None

        # Ensure topics exist before wiring consumers.
        self.log.topic(RAW_TOPIC)
        self.log.topic(DELTAS_TOPIC)

        self.runner = (OverlappedLambdaRunner() if overlapped
                       else LambdaRunner())
        # Per-service config (the reference's nconf slice per lambda,
        # services-core/src/lambdas.ts:56). Batched deli checkpointing
        # requires the pump's eager offset commit OFF so the replay window
        # matches the saved state.
        self.config = config
        # The sequencing stage lives in the sharded ingest tier
        # (server/sharding.py): one sequencer lambda per raw-topic
        # partition, restart-stable md5 document routing, per-partition
        # checkpoint scoping, batched cross-partition acks, and the
        # per-partition pump accounting the monitor and the ingest bench
        # read. Partition state is the TIER's, not this class's — the
        # decoupling refactor the ROADMAP's million-ops item counts.
        self.ingest = self._build_ingest_tier()
        self._deli_mgr = self.runner.add(self.ingest.manager)
        self._copier_mgr = self.runner.add(PartitionManager(
            self.log, "copier", RAW_TOPIC,
            lambda ctx: CopierLambda(ctx, self.raw_deltas), offload=True))
        self._scriptorium_mgr = self.runner.add(PartitionManager(
            self.log, "scriptorium", DELTAS_TOPIC,
            lambda ctx: ScriptoriumLambda(ctx, self.deltas), offload=True))
        self._scribe_mgr = self.runner.add(PartitionManager(
            self.log, "scribe", DELTAS_TOPIC,
            lambda ctx: ScribeLambda(ctx, self.historian, tenant_id,
                                     send_system=self._send_system,
                                     checkpoints=self.scribe_checkpoints,
                                     fresh_log=True,
                                     on_commit=self._on_summary_commit),
            offload=True))
        self._broadcaster_mgr = self.runner.add(PartitionManager(
            self.log, "broadcaster", DELTAS_TOPIC,
            self._build_broadcaster))

        # Overload admission (server/admission.py): the occupancy-driven
        # front door every Connection.submit/submit_signal passes. A
        # shared controller (alfred) or a per-core one from config;
        # admission.enabled=false opts a core out entirely.
        self.admission = admission if admission is not None \
            else admission_from_config(config)
        if self.admission is not None:
            self._wire_admission()

    # -- internal wiring ---------------------------------------------------
    def _build_broadcaster(self, ctx) -> BroadcasterLambda:
        # A crash-restart (PartitionPump.restart closes the old lambda,
        # then re-invokes this factory) must not leave the superseded
        # instance in the registry: the occupancy feed, drain_broadcast,
        # and the monitor probe would sum dead shards forever.
        self.broadcasters = [b for b in self.broadcasters if not b.closed]
        lam = BroadcasterLambda(ctx, rooms=self._rooms,
                                shards=self.broadcaster_shards,
                                queue_limit=self.broadcaster_queue_limit)
        self.broadcasters.append(lam)
        return lam

    def broadcast_queue_depth(self) -> int:
        """Total fan-out backlog across every broadcaster shard (0 in
        inline mode) — the read tier's occupancy feed for admission."""
        return sum(lam.queue_depth() for lam in self.broadcasters)

    def drain_broadcast(self, timeout: float = 10.0) -> bool:
        """Block until every sharded fan-out queue is empty (inline mode
        returns immediately). Tests and benches that need delivered-after-
        pump semantics under sharding call this where they used to rely
        on the pump's synchronous fan-out."""
        ok = True
        for lam in self.broadcasters:
            ok = lam.drain(timeout) and ok
        return ok

    def raw_backlog(self) -> int:
        """Raw-topic ingest backlog: messages appended but not yet
        consumed by the sequencing stage (per partition: end offset minus
        the deli group's committed offset). Counts broker records
        (boxcars), the unit the partition pumps drain in — the admission
        controller's primary occupancy feed. Multi-partition audit
        (docs/ingest_sharding.md): a submit batch is ONE boxcar on ONE
        partition, so `admit(count=N, records=1)` stays calibrated
        against this sum for any partition count — per-partition feeds
        go through the controller's SEPARATE partition channel and are
        never added into the global depth (that double-count would
        re-introduce the PR 6 phantom-drain inflation, N-fold)."""
        return self.ingest.raw_backlog()

    def raw_backlog_by_partition(self) -> Dict[int, int]:
        """Per-partition record backlog (monitor watch_partitions)."""
        return self.ingest.raw_backlog_by_partition()

    def ingest_partition(self, document_id: str) -> Optional[int]:
        """A document's home partition, or None on a single-partition
        core (admission then skips the per-partition fairness gate)."""
        if self.ingest.partitions <= 1:
            return None
        return self.ingest.partition_for(document_id)

    def rebalance_document(self, document_id: str, target: int) -> int:
        """Live-rebalance one document's sequencing to ``target`` with
        no fleet drain (server/sharding.py rebalance_doc): routing-epoch
        bump + handoff marker on the raw topic itself. Returns the new
        routing epoch. Per-doc emit order is provably identical across
        the move (docs/ingest_sharding.md)."""
        epoch = self.ingest.rebalance_doc(document_id, target)
        if self.auto_pump:
            self.pump()
        return epoch

    def _wire_admission(self) -> None:
        adm = self.admission
        adm.add_source(f"core:{self.tenant_id}",
                       queue_depth=self.raw_backlog)
        if self.ingest.partitions > 1:
            # Per-partition occupancy feeds the fairness gate only (see
            # raw_backlog docstring for why they must not join the
            # global sum).
            self.ingest.register_admission(adm, self.tenant_id)
        if self.broadcaster_shards:
            # The read tier's occupancy feed: a fan-out backlog (reconnect
            # avalanche, hot-document room) pressures the same admission
            # ladder the write side does, so ingest throttles before the
            # shard queues have to shed.
            adm.add_source(f"broadcast:{self.tenant_id}",
                           queue_depth=self.broadcast_queue_depth)
        # DEGRADE survival mode: pause the archival pumps (copier raw
        # persistence, scribe summaries) so every cycle goes to draining
        # the sequencer. Their consumer offsets hold their place in the
        # log; on de-escalation they resume and replay the gap — work is
        # deferred, never lost. Deli/broadcaster stay live (they ARE the
        # drain) and scriptorium keeps catch-up queries truthful.
        def pause() -> None:
            for mgr in (self._copier_mgr, self._scribe_mgr):
                for pump in mgr.pumps.values():
                    pump.pause()

        def resume() -> None:
            for mgr in (self._copier_mgr, self._scribe_mgr):
                for pump in mgr.pumps.values():
                    pump.resume()

        adm.add_degrade_hooks(pause, resume)

    def _build_ingest_tier(self) -> SequencerShardSet:
        """The sequencing stage as a sharded tier (server/sharding.py):
        one lambda per raw-topic partition via _sequencer_factory
        (scalar DeliLambda here; TpuLocalServer overrides with the
        device-batched TpuSequencerLambda)."""
        return SequencerShardSet(
            self.log, RAW_TOPIC, "deli", self._sequencer_factory,
            checkpoints=self.deli_checkpoints,
            auto_commit=self._sequencer_auto_commit())

    def _sequencer_factory(self, ctx, checkpoints):
        return DeliLambda(ctx, emit=self._emit_sequenced,
                          nack=self._emit_nack,
                          checkpoints=checkpoints,
                          fresh_log=True,
                          config=self.config,
                          send_system=self._send_system)

    def _sequencer_auto_commit(self) -> bool:
        deli_batched = bool(self.config is not None and int(
            self.config.get("deli.checkpointBatchSize", 1)) > 1)
        return not deli_batched

    def _emit_sequenced(self, doc_id: str,
                        sequenced: SequencedDocumentMessage) -> None:
        # Explicit-partition produce through the shared md5 router: the
        # deltas topic mirrors the raw topic's partitioning, so every
        # downstream per-partition consumer (scriptorium/scribe/
        # broadcaster pumps) inherits the ingest tier's document homes
        # instead of the broker's own key hash. BASE routing on purpose:
        # a live rebalance re-homes only the RAW (sequencing-input)
        # side; the document's output stream never changes partitions,
        # so per-doc delivery order stays total across a handoff.
        self.log.send_to(DELTAS_TOPIC,
                         self.ingest.delta_partition_for(doc_id),
                         doc_id, (doc_id, sequenced))

    def _emit_nack(self, doc_id: str, client_id: str, nack: Nack) -> None:
        for conn in self._connections.get(doc_id, []):
            if conn.client_id == client_id and conn.connected:
                conn.emit("nack", nack)

    def _on_summary_commit(self, doc_id: str, commit_sha: str) -> None:
        for listener in list(self.summary_commit_listeners):
            try:
                listener(doc_id, commit_sha)
            except Exception:  # noqa: BLE001 — observers never break scribe
                # Swallowed by design (a historian invalidation hook must
                # not fail the commit) but counted: a climbing rate means
                # the cache tier is no longer invalidating.
                record_swallow("server.summary_commit_listener")

    def _send_system(self, doc_id: str, message: DocumentMessage) -> None:
        self.log.send_to(RAW_TOPIC, self.ingest.partition_for(doc_id),
                         doc_id, Boxcar(
            tenant_id=self.tenant_id, document_id=doc_id, client_id=None,
            contents=[message]))

    def _submit_boxcar(self, boxcar: Boxcar,
                       partition: Optional[int] = None) -> None:
        # Explicit md5-routed produce (server/routing.py): the document's
        # home partition is the tier's decision, never the broker's key
        # hash — restart-stable and shared with the broadcaster shards.
        # Callers that already routed (the admission gate) pass the home
        # through; None recomputes (free on a single-partition core).
        if partition is None:
            partition = self.ingest.partition_for(boxcar.document_id)
        self.log.send_to(RAW_TOPIC, partition,
                         boxcar.document_id, boxcar)
        if self.auto_pump:
            self.pump()

    def _broadcast_signal(self, document_id: str,
                          signal: SignalMessage) -> None:
        for listener in list(self._signal_rooms.get(document_id, [])):
            listener(signal)

    def _throttle_bucket(self, document_id: str) -> Optional[_TokenBucket]:
        if not self.throttle_ops_per_s:
            return None
        bucket = self._throttle_buckets.get(document_id)
        if bucket is None:
            bucket = _TokenBucket(self.throttle_ops_per_s,
                                  self.throttle_burst)
            self._throttle_buckets[document_id] = bucket
        return bucket

    # -- the Alfred surface (connect/disconnect, catch-up, storage) --------
    def connect(self, document_id: str,
                details: Optional[dict] = None) -> Connection:
        # Globally unique id, not a per-core counter: after a multi-node
        # takeover a new core must never reissue an id that appears in the
        # document's history (a late loader would mistake those historical
        # ops for its own and corrupt pending-state/merge-tree visibility).
        client_id = (f"client-{next(self._client_counter)}-"
                     f"{uuid.uuid4().hex[:8]}")
        conn = Connection(self, self.tenant_id, document_id, client_id,
                          details)
        self._connections.setdefault(document_id, []).append(conn)
        # Broadcaster room subscription (removed again at disconnect).
        conn._room_listener = \
            lambda msg, c=conn: c.connected and c.emit("op", msg)
        self._rooms.setdefault(document_id, []).append(conn._room_listener)
        conn._signal_listener = \
            lambda sig, c=conn: c.connected and c.emit("signal", sig)
        self._signal_rooms.setdefault(document_id, []).append(
            conn._signal_listener)
        # Join op through the sequencer (alfred connect_document) — for
        # WRITERS only: readers never enter the quorum or the MSN window.
        if conn.mode != "read":
            import json
            self._send_system(document_id, DocumentMessage(
                client_sequence_number=0, reference_sequence_number=-1,
                type=MessageType.CLIENT_JOIN,
                data=json.dumps({"clientId": client_id,
                                 "detail": conn.details})))
        if self.auto_pump:
            self.pump()
        return conn

    def _client_leave(self, conn: Connection) -> None:
        import json
        room = self._connections.get(conn.document_id, [])
        if conn in room:
            room.remove(conn)
        listeners = self._rooms.get(conn.document_id, [])
        if conn._room_listener in listeners:
            listeners.remove(conn._room_listener)
        sig_listeners = self._signal_rooms.get(conn.document_id, [])
        if conn._signal_listener in sig_listeners:
            sig_listeners.remove(conn._signal_listener)
        if conn.mode == "read":
            return  # never joined; nothing to sequence
        self._send_system(conn.document_id, DocumentMessage(
            client_sequence_number=0, reference_sequence_number=-1,
            type=MessageType.CLIENT_LEAVE,
            data=json.dumps({"clientId": conn.client_id})))
        if self.auto_pump:
            self.pump()

    def get_deltas(self, document_id: str, from_seq: int = 0,
                   to_seq: Optional[int] = None) -> List[dict]:
        """Catch-up range query (alfred delta REST API over the scriptorium
        collection): ops with from_seq < seq <= to_seq, ordered."""
        return query_deltas(self.deltas, document_id, from_seq, to_seq)

    def storage(self, document_id: str):
        return self.historian.store(self.tenant_id, document_id)

    def get_catchup(self, document_id: str) -> Optional[dict]:
        """Read-path catch-up artifact for a document, or None (the
        scalar pipeline materializes no device lanes — clients take the
        tail-replay fallback; TpuLocalServer overrides)."""
        return None

    def pump(self) -> int:
        """Drive every lambda stage to quiescence (synchronous pipeline)."""
        if self.overlapped:
            # Stage workers can re-enter pump (a broadcaster listener
            # submitting an op -> auto_pump): never block on the active
            # pump — its round loop runs until quiescence, so the newly
            # queued message is drained by the pump already in flight.
            if not self._pump_lock.acquire(blocking=False):
                return 0
            try:
                if self.pump_gate is not None and not self.pump_gate():
                    return 0
                return self.runner.pump()
            finally:
                self._pump_lock.release()
        with self._pump_lock:
            if self.pump_gate is not None and not self.pump_gate():
                return 0
            return self.runner.pump()

    # -- introspection ----------------------------------------------------
    def sequence_number(self, document_id: str) -> int:
        # "state" in d: skip handed-off tombstones (a live-rebalanced
        # document leaves one on its old partition's scoped view).
        row = self.deli_checkpoints.find_one(
            lambda d: d.get("documentId") == document_id and "state" in d)
        return row["state"]["sequenceNumber"] if row else 0


class TpuLocalServer(LocalServer):
    """LocalServer whose sequencing stage is the DEVICE pipeline: boxcars
    drain into [B, T] tensors and sequence through the ticket scan
    (kernels/csrc/ticket_scan.cu on the card), with admitted merge-tree
    ops applied to device-resident segment tables (server/tpu_sequencer.py)
    — the batched partition lambda of the north star on the real serving
    path. Scriptorium/Scribe/Broadcaster/Copier are unchanged (host I/O).

    device: where every partition's sequencer keeps its ticket table and
    lanes. None is the card and raises without CUDA; the tests pass "cpu".

    mesh: not ported. The JAX package shards the sequencer's lanes over a
    device mesh; here any mesh other than None raises NotImplementedError
    (ROADMAP Queue 1 item 5, multi-device).

    paged_lanes: store merge segment rows in the refcounted page pool
    (per-doc page tables, gather-by-page-id applies) instead of the
    capacity-bucket grid — document growth appends pages, no
    promote/fold/rescue (docs/paged_memory.md).
    """

    def __init__(self, *args, mesh=None, paged_lanes=False,
                 device: str | torch.device | None = None, **kwargs):
        if mesh is not None:
            raise NotImplementedError(
                "TpuLocalServer(mesh=...): the sequencer's lanes have no "
                "mesh placement in the port (ROADMAP Queue 1 item 5)")
        self.device = resolve_device(device)
        self.paged_lanes = paged_lanes
        super().__init__(*args, **kwargs)
        # Read-path catch-up artifacts (server/readpath.py): ON by
        # default — the cache is empty until a refresh or a read-miss
        # triggers one, so pure write workloads never pay for it.
        from .readpath import CatchupCache
        enabled = True
        if self.config is not None:
            enabled = bool(self.config.get("catchup.enabled", True))
        # partition_of routes the catchup/adopted watermark stamps to the
        # document's ingest home (telemetry/watermarks.py).
        self.catchup = CatchupCache(
            partition_of=lambda doc: self.ingest.partition_for(doc)) \
            if enabled else None

    def _build_ingest_tier(self) -> SequencerShardSet:
        self.tpu_sequencers = []
        return super()._build_ingest_tier()

    def _sequencer_factory(self, ctx, checkpoints):
        from .tpu_sequencer import TpuSequencerLambda

        lam = TpuSequencerLambda(
            ctx, emit=self._emit_sequenced, nack=self._emit_nack,
            checkpoints=checkpoints, deltas=self.deltas,
            fresh_log=True, device=self.device,
            # Snapshot seeding: lanes for channels whose base content
            # shipped in the attach/client summary bootstrap from the
            # historian instead of overflowing on their first op.
            storage=lambda doc_id: self.historian.read_summary(
                self.tenant_id, doc_id),
            config=self.config,
            send_system=self._send_system,
            paged_lanes=getattr(self, "paged_lanes", False))
        self.tpu_sequencers.append(lam)
        return lam

    def _sequencer_auto_commit(self) -> bool:
        # Off: offsets commit only at the lambda's flush checkpoint, so
        # a crash replays the whole unflushed window.
        return False

    def sequencer(self):
        """The live TpuSequencerLambda of partition 0 — THE sequencer on
        a single-partition core (the default every in-process test
        drives). On a sharded core, document-scoped paths must route via
        sequencer_for()/the tier instead; this accessor stays for
        whole-process introspection that treats partition 0 as
        representative."""
        return self.ingest.live(0)

    def sequencer_for(self, document_id: str):
        """The live sequencer lambda owning a document's home partition
        (== sequencer() on a single-partition core)."""
        return self.ingest.sequencer_for(document_id)

    def _wire_admission(self) -> None:
        super()._wire_admission()
        # The device pipeline's occupancy hints: staged ops count toward
        # queue depth; the in-flight ring's fill feeds the (damped)
        # utilization term. Resolved through the tier's live() so a
        # crash-restarted lambda keeps feeding the controller; one
        # source per partition so a sharded core's staged work counts
        # exactly once.
        for p in range(self.ingest.partitions):
            name = f"ring:{self.tenant_id}" if self.ingest.partitions == 1 \
                else f"ring:{self.tenant_id}:p{p}"
            self.admission.add_source(
                name,
                hints=lambda p=p: self.ingest.live(p).occupancy_hints())

    def sequence_number(self, document_id: str) -> int:
        return self.sequencer_for(document_id).document_seq(document_id)

    # -- read-path catch-up artifacts (server/readpath.py) -----------------
    def refresh_catchup(self, only_docs: Optional[set] = None) -> dict:
        """One read-tier refresh epoch: join the sequencer's batched
        channel extraction (ONE device dispatch per bucket for every
        dirty document together) with the scribe's protocol checkpoints
        and publish per-doc artifacts. A document whose scribe replica
        has not caught up to the sequencer (DEGRADE pauses scribe) skips
        this epoch — its previous artifact stays served (stale-but-
        correct: adoption + residue replay) and the publish retries next
        refresh. Serialized against the pump (artifact consistency needs
        the lanes at a flush boundary)."""
        from .readpath import build_artifact

        if self.catchup is None:
            return {"published": 0, "skipped": 0, "refreshed": 0}
        with self._pump_lock:
            # One epoch spans every partition's sequencer: documents are
            # partition-disjoint (md5 homes), so the per-partition bodies
            # merge without collision; each publish advances the OWNING
            # lambda's watermark.
            bodies: Dict[str, dict] = {}
            owner: Dict[str, Any] = {}
            for seq_lambda in self.ingest.sequencers():
                for doc_id, body in seq_lambda.catchup_snapshot(
                        only_docs).items():
                    bodies[doc_id] = body
                    owner[doc_id] = seq_lambda
            if not bodies:
                return {"published": 0, "skipped": 0, "refreshed": 0}
            # One scan of the checkpoint collection for the whole epoch
            # (a per-doc find_one would make the epoch O(dirty x docs)).
            by_doc = {row["documentId"]: row
                      for row in self.scribe_checkpoints.find(
                          lambda d: d.get("documentId") in bodies)}
            published = skipped = 0
            for doc_id, body in bodies.items():
                row = by_doc.get(doc_id)
                if row is None \
                        or int(row["sequenceNumber"]) != body["seq"]:
                    skipped += 1
                    increment("catchup.publish_skipped")
                    continue
                sha = self.historian.store(
                    self.tenant_id, doc_id).get_ref("main")
                artifact = build_artifact(
                    body, row["minimumSequenceNumber"], row["quorum"], sha)
                if self.catchup.publish(self.tenant_id, doc_id, artifact):
                    published += 1
                    owner[doc_id].catchup_mark_published(doc_id,
                                                         body["gen"])
                    for listener in list(self.catchup_listeners):
                        try:
                            listener(self.tenant_id, doc_id, artifact)
                        except Exception:  # noqa: BLE001 — observers never break the refresh
                            record_swallow("server.catchup_listener")
            return {"published": published, "skipped": skipped,
                    "refreshed": len(bodies)}

    def get_catchup(self, document_id: str) -> Optional[dict]:
        """The serving side of `summary + delta in one round trip`: the
        freshest catch-up artifact for a document, refreshing it first
        when it is absent or trails the head (cost: one single-doc
        refresh per document per epoch, amortized over every client that
        connects before the next flush dirties it)."""
        if self.catchup is None:
            return None
        with self._pump_lock:
            head = self.sequencer_for(document_id).document_seq(
                document_id)
            art_seq = self.catchup.peek_seq(self.tenant_id, document_id)
            if art_seq is None or art_seq < head:
                self.refresh_catchup(only_docs={document_id})
            return self.catchup.get(self.tenant_id, document_id,
                                    head_seq=head)

    def write_materialized_snapshots(self, ref: str = "materialized",
                                     incremental: bool = True
                                     ) -> Dict[str, str]:
        """Commit the server-materialized chunked snapshots to git storage
        under their own ref (per doc): the server-side summarization path —
        no client summarizer involved (reference Scribe writes CLIENT
        summaries, scribe/lambda.ts:162; this writes the sequencer's own
        device state). Returns {document_id: commit_sha}.

        incremental=True (the default): only channels DIRTY since the last
        write extract + upload; clean channels serialize as SummaryHandles
        into the doc's previous materialized commit, and documents with no
        dirty channels skip the write entirely — extraction compute, D2H
        traffic, and blob uploads all scale with the changed set
        (reference trackState/SummaryTracker, server-side)."""
        out: Dict[str, str] = {}
        # Per-partition sequencers hold disjoint document sets (md5
        # homes), so the per-sequencer maps merge without collision.
        for seq in self.ingest.sequencers():
            out.update(self._write_materialized_for(seq, ref, incremental))
        return out

    def _write_materialized_for(self, seq, ref: str,
                                incremental: bool) -> Dict[str, str]:
        import json as _json

        from ..protocol.summary import SummaryHandle, SummaryTree

        from .tpu_sequencer import lane_base_key

        seq.drain()
        merge_keys = set(seq.merge.where)
        lww_keys = set(seq.lww.where)
        all_keys = merge_keys | lww_keys
        # Matrix sub-lanes (axis merge lanes + cell store) version and
        # persist ATOMICALLY under their base channel key: a dirty row
        # axis must re-extract the cols/cells too, or the composed
        # snapshot would silently drop the unextracted parts.
        base_of = {k: (lane_base_key(k) or k) for k in all_keys}
        display_keys = set(base_of.values())

        prev_sha: Dict[str, Optional[str]] = {}
        for doc_id in {k[0] for k in all_keys}:
            prev_sha[doc_id] = self.historian.store(
                self.tenant_id, doc_id).get_ref(ref) if incremental \
                else None

        # Dirty = change generation advanced past what THIS ref last
        # wrote (per-ref: writes to another ref must not mark channels
        # clean here).
        gen_now: Dict[tuple, int] = dict(seq.merge.change_gen)
        gen_now.update(seq.lww.change_gen)
        # The watermark map lives ON the sequencer lambda: a crash-restart
        # replaces the lambda (fresh generation counters starting at 0),
        # and comparing new counters against a previous instance's high
        # watermarks would silently treat every post-restart edit as
        # clean.
        seen_by_ref = getattr(seq, "_materialized_gen", None)
        if seen_by_ref is None:
            seen_by_ref = seq._materialized_gen = {}
        ref_seen: Dict[tuple, int] = seen_by_ref.setdefault(ref, {})
        gen_display: Dict[tuple, int] = {}
        for k in all_keys:
            gen_display[base_of[k]] = max(gen_display.get(base_of[k], 0),
                                          gen_now.get(k, 0))
        if incremental:
            dirty = {dk for dk in display_keys
                     if gen_display.get(dk, 0) > ref_seen.get(dk, 0)}
            # Docs without a previous commit have nothing to point handles
            # at: extract them fully.
            full_docs = {d for d, sha in prev_sha.items() if sha is None}
            want_display = {dk for dk in display_keys
                            if dk in dirty or dk[0] in full_docs}
        else:
            want_display = display_keys
        want = {k for k in all_keys if base_of[k] in want_display}
        write_docs = {k[0] for k in want}

        snaps = seq.summarize_documents(only=want)

        by_doc: Dict[str, SummaryTree] = {}
        for (doc_id, store_id, channel_id), snap in snaps.items():
            root = by_doc.setdefault(doc_id, SummaryTree())
            store_node = root.entries.get(store_id)
            if store_node is None:
                store_node = root.add_tree(store_id)
            node = store_node.add_tree(channel_id)
            if snap["header"].get("kind") == "directory":
                # Composed directory channel in the EXACT summarize_core
                # layout (dds/directory.py load_core reads the nested
                # tree from the "header" blob — a different blob name
                # would load as an empty directory).
                node.add_blob("header", _json.dumps(snap["directory"],
                                                    sort_keys=True))
                continue
            node.add_blob("header", _json.dumps(snap["header"]))
            if "chunks" in snap:  # merge-tree channel: chunked body
                for i, chunk in enumerate(snap["chunks"]):
                    node.add_blob(f"chunk_{i}", _json.dumps(chunk))
            elif snap["header"].get("kind") == "matrix":
                # Composed matrix channel: axis snapshots + cell map in
                # the dds/matrix.py load_core blob layout.
                node.add_blob("rows", _json.dumps(snap["rows"]))
                node.add_blob("cols", _json.dumps(snap["cols"]))
                node.add_blob("cells", _json.dumps(snap["cells"],
                                                   sort_keys=True))
            else:  # LWW channel: entries + counter in one blob
                node.add_blob("lww", _json.dumps(
                    {"entries": snap["entries"],
                     "counter": snap["counter"]}, sort_keys=True))
        # Clean channels of written docs ride as handles into the doc's
        # previous materialized commit (same tree position).
        for (doc_id, store_id, channel_id) in display_keys - want_display:
            if doc_id not in write_docs:
                continue
            root = by_doc.setdefault(doc_id, SummaryTree())
            store_node = root.entries.get(store_id)
            if store_node is None:
                store_node = root.add_tree(store_id)
            store_node.entries[channel_id] = SummaryHandle("/")

        out: Dict[str, str] = {}
        for doc_id, tree in by_doc.items():
            gstore = self.historian.store(self.tenant_id, doc_id)
            # The sequencer's own state is authoritative (no client-proposal
            # validation cycle to wait for): advance the ref directly.
            out[doc_id] = gstore.write_summary(
                tree, ref=ref, message="server-materialized snapshot",
                base_commit=prev_sha.get(doc_id), advance_ref=True)
        # Unchanged docs keep their previous commit in the returned map.
        for doc_id, sha in prev_sha.items():
            if doc_id not in out and sha is not None:
                out[doc_id] = sha
        # Only the channels actually persisted become clean FOR THIS REF,
        # at the generation captured before extraction.
        for dk in want_display:
            ref_seen[dk] = gen_display.get(dk, 0)
        return out
