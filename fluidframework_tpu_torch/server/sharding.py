"""Sharded multi-partition ingest tier: per-partition sequencer workers.

A copy of fluidframework_tpu's server/sharding.py, host code that the port
keeps as its own.

The serving ring sustains a measured per-process ingest rate (BENCH
r06+: ~24.5k ops/s on the pipelined CPU shape), but alfred -> deli was
effectively ONE logical partition, so that figure never composed — the
million-ops/s story (ROADMAP; the Pulsar benchmarking bar in PAPERS.md)
needs N partitions, each owned by its own deli/sequencer worker, whose
per-partition service rates ADD.

This module owns everything per-partition that used to live implicitly
in ``LocalServer`` (the decoupling refactor the ROADMAP counts):

  * ``SequencerShardSet`` — the tier. One ``PartitionManager`` over the
    raw-op topic whose factory builds ONE sequencer lambda per
    partition (scalar ``DeliLambda`` or the device-batched
    ``TpuSequencerLambda`` — the host is agnostic), a restart-stable
    md5 document router (server/routing.py — the SAME scheme the
    broadcaster's fan-out shards use, so the two tiers can never
    disagree on a document's home), per-partition checkpoint/offset
    state, per-partition pump/busy accounting (the composition figure
    `bench.py ingest-smoke` grades), and optional per-partition worker
    threads.

  * ``PartitionCheckpoints`` — a partition-scoped view over the shared
    deli checkpoint collection. Without it, N ``TpuSequencerLambda``
    instances would clobber one another's single ``kind ==
    "tpu-sequencer"`` row (the scalar deli's per-document rows collide
    more subtly: every partition's restart would adopt every OTHER
    partition's documents). Rows carry an ``ingestPartition`` field;
    missing means partition 0, so pre-sharding checkpoints restore
    unchanged.

  * ``AckBatcher`` — batched cross-partition acks. Sequencer lambdas
    checkpoint through their ``LambdaContext``; with a batcher
    installed, a pump round's per-partition offset commits coalesce
    into ONE ``MessageLog.commit_many`` (one lock acquisition
    in-process; one gRPC round trip against the remote broker).
    Deferring an ack within a round only WIDENS the crash-replay
    window, so at-least-once semantics are untouched.

Admission interplay (server/admission.py): the tier registers one
occupancy source per partition (raw-record backlog + the sequencer's
occupancy hints), and ``AdmissionController.admit(partition=...)``
enforces a per-partition soft bound on top of the global ladder — one
hot partition throttles ITS documents without starving siblings, and
without the global ladder ever leaving ACCEPT (docs/ingest_sharding.md,
docs/overload.md).

Thread model: by default nothing here spawns threads — the tier pumps
on the caller's thread exactly like the pre-sharding pipeline, which is
what every deterministic in-process test relies on. ``start_workers``
opts into one daemon worker per partition (the deployment shape: one
worker per core); while workers run, a partition is only ever pumped by
its one owner: ``pump_round`` refuses outright, and runner rounds
(``LocalServer.pump`` / auto_pump drive every registered manager,
including this tier's) skip the ingest stage while still pumping the
downstream stages on the caller's thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..telemetry import watermarks
from ..telemetry.counters import increment, record_swallow
from .lambdas.base import IPartitionLambda, LambdaContext
from .partition import PartitionManager
from .routing import PartitionRouter

REBALANCE_KEY = "__rebalance__"
_ROUTING_ROW_KIND = "routingEpochs"


class AckBatcher:
    """Collects per-partition checkpoint offsets and flushes them as one
    batched cross-partition commit (``MessageLog.commit_many``).

    note() keeps only the max offset per partition (commits are
    monotonic); flush() is idempotent and cheap when empty. The batch
    is swapped out under AckBatcher._lock but committed OUTSIDE it, so
    the lock is never held across broker I/O — no ordering against the
    log's own locks exists at all."""

    def __init__(self, log, group: str, topic: str):
        self.log = log
        self.group = group
        self.topic = topic
        self._pending: Dict[int, int] = {}
        self._lock = threading.Lock()

    def note(self, partition: int, offset: int) -> None:
        with self._lock:
            held = self._pending.get(partition)
            if held is None or offset > held:
                self._pending[partition] = offset

    def flush(self) -> int:
        """Commit every noted offset in one batch; returns the number of
        partitions acked."""
        with self._lock:
            if not self._pending:
                return 0
            pending, self._pending = self._pending, {}
        # Commit OUTSIDE the lock: on the durable engine commit_many is
        # an fsync'd offsets-file rewrite, and holding _lock across it
        # would stall every other partition worker's note(). Safe
        # because commit_many is never-regress per partition on every
        # engine, so a racing higher-offset flush cannot be regressed
        # by this batch landing late.
        self.log.commit_many(self.group, self.topic, pending)
        increment("ingest.ack_batches")
        increment("ingest.acked_partitions", len(pending))
        return len(pending)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)


class PartitionCheckpoints:
    """Partition-scoped view over a shared checkpoint Collection: every
    row this view writes carries ``ingestPartition``, and every read
    filters on it (missing == partition 0, so checkpoints written before
    sharding restore into partition 0 unchanged). Presents exactly the
    find/find_one/upsert surface the sequencer lambdas use."""

    def __init__(self, inner, partition: int):
        self.inner = inner
        self.partition = int(partition)

    def _scope(self, predicate: Callable[[dict], bool]):
        p = self.partition
        return lambda d: (int(d.get("ingestPartition", 0)) == p
                          and predicate(d))

    def find(self, predicate: Callable[[dict], bool]) -> List[dict]:
        return self.inner.find(self._scope(predicate))

    def find_one(self, predicate: Callable[[dict], bool]) -> Optional[dict]:
        return self.inner.find_one(self._scope(predicate))

    def upsert(self, match: Callable[[dict], bool], doc: dict) -> None:
        doc = dict(doc)
        doc["ingestPartition"] = self.partition
        self.inner.upsert(self._scope(match), doc)

    def __len__(self) -> int:
        return len(self.find(lambda d: True))


class _PartitionStats:
    """Per-partition pump accounting (mutated only under the tier's
    stats lock): broker records drained, pump calls that made progress,
    and the busy wall-clock the partition's worker spent inside its
    pump — the denominator of the per-partition service rate the
    ingest-smoke composition figure sums."""

    __slots__ = ("records", "pump_calls", "busy_s", "restarts")

    def __init__(self):
        self.records = 0
        self.pump_calls = 0
        self.busy_s = 0.0
        self.restarts = 0

    def as_dict(self) -> dict:
        return {"records": self.records, "pumpCalls": self.pump_calls,
                "busyS": round(self.busy_s, 6), "restarts": self.restarts}


class _ShardedPartitionManager(PartitionManager):
    """PartitionManager whose pump round ends with a batched ack flush:
    every driver that pumps through the manager surface (LambdaRunner
    rounds, direct pump_all) keeps the committed offsets current at
    round granularity without N per-partition broker commits.

    ``workers_owned`` tells the manager the tier's per-partition worker
    threads currently own the pumps: runner rounds (``LocalServer.pump``
    drives every registered manager, this one included) SKIP the ingest
    stage instead of becoming a second concurrent driver of the same
    non-thread-safe pumps, while downstream stages keep pumping on the
    caller's thread."""

    def __init__(self, *args, acks: Optional[AckBatcher] = None,
                 workers_owned: Optional[Callable[[], bool]] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.acks = acks
        self.workers_owned = workers_owned

    def pump_all(self) -> int:
        if self.workers_owned is not None and self.workers_owned():
            return 0
        n = super().pump_all()
        if self.acks is not None:
            self.acks.flush()
        return n

    def restart(self) -> None:
        # Flush first: the rebuilt lambdas' pumps reset their cursor to
        # the committed offset, and a pending (noted, unflushed) ack
        # would needlessly widen the replay window.
        if self.acks is not None:
            self.acks.flush()
        super().restart()


class _RebalancingSequencer(IPartitionLambda):
    """Per-partition handoff shim around the real sequencer lambda: it
    intercepts the two rebalance control records riding the raw topic
    and buffers a re-homed document's traffic until its state arrives.

      handoff marker (on the SOURCE partition): export the document's
        live state through the inner lambda's ``export_doc``, durably
        produce the adopt record onto the TARGET partition, then
        ``drop_doc`` (tombstoned checkpoint row). Replay-idempotent:
        once dropped, export returns None and the marker is a no-op.

      adopt record (on the TARGET partition): ``adopt_doc`` installs the
        state (dup adopts ignored), then the shim drains every record it
        buffered for the document IN ARRIVAL ORDER — so the document's
        op stream is processed exactly as: everything before the marker
        by the old owner, everything after the adopt by the new one,
        with nothing lost, duplicated, or reordered in between.

    The awaiting set re-derives on (re)build from the router's override
    table minus the documents the inner lambda restored — a crashed
    target partition comes back buffering for exactly the adoptions its
    checkpoint has not absorbed yet. Buffered records survive the crash
    too: the shim durably notes the FIRST buffered offset per document
    (one upsert per handoff, not per record) and on rebuild re-reads
    [fromOffset, committed) from the log (``MessageLog.read_from`` —
    offset-indexed on the durable engine), because the pump has already
    committed past those records and will never replay them. Everything
    else (occupancy hints, doc_sequence_numbers, ``docs``...) delegates
    to the inner lambda."""

    def __init__(self, inner: IPartitionLambda, tier: "SequencerShardSet",
                 partition: int, checkpoints=None):
        self.inner = inner
        self.tier = tier
        self.partition = int(partition)
        self.checkpoints = checkpoints
        self.buffered: Dict[str, List] = {}
        owned = getattr(inner, "docs", {})
        self.awaiting = {
            doc for doc in tier.router.overrides_targeting(self.partition)
            if doc not in owned}
        self._recover_buffered()

    def _recover_buffered(self) -> None:
        """Re-read pre-crash buffered records from the log: their offsets
        were committed when they were buffered (the pump's cursor must
        advance), so replay will never re-deliver them — the durable
        fromOffset note is what makes buffering crash-safe."""
        if self.checkpoints is None or not self.awaiting:
            return
        committed = self.tier.log.committed(
            self.tier.group, self.tier.topic, self.partition)
        for row in self.checkpoints.find(
                lambda d: d.get("kind") == "rebalanceBuffer"):
            doc = row.get("documentId")
            start = int(row.get("fromOffset", -1))
            if doc not in self.awaiting or start < 0 or committed <= start:
                continue
            for msg in self.tier.log.read_from(
                    self.tier.topic, self.partition, start,
                    committed - start):
                if msg.key == doc and not (
                        isinstance(msg.value, dict)
                        and REBALANCE_KEY in msg.value):
                    self.buffered.setdefault(doc, []).append(msg)
                    increment("ingest.rebalance_buffer_recovered")

    def _note_buffering(self, doc_id: str, offset: int) -> None:
        if self.checkpoints is None:
            return
        self.checkpoints.upsert(
            lambda d, _id=doc_id: (d.get("kind") == "rebalanceBuffer"
                                   and d.get("documentId") == _id),
            {"kind": "rebalanceBuffer", "documentId": doc_id,
             "fromOffset": int(offset)})

    # -- control-plane ------------------------------------------------------
    def expect(self, doc_id: str) -> None:
        """Arm buffering for a document whose adoption is in flight (the
        tier calls this BEFORE installing the routing override, so no
        post-bump record can reach the inner lambda unowned)."""
        self.awaiting.add(doc_id)

    def _mark_offset(self, message) -> None:
        # Control records must advance the inner lambda's checkpoint
        # cursor like any other handled record, or a marker at the head
        # of a quiet partition would replay forever under batched acks.
        if hasattr(self.inner, "_pending_offset"):
            self.inner._pending_offset = message.offset

    def _handoff(self, message, record: dict) -> None:
        doc_id = record["doc"]
        target = int(record["target"])
        epoch = int(record.get("epoch", 0))
        dump = self.inner.export_doc(doc_id)
        if dump is None:
            # Replayed marker after the drop, or a document this
            # partition never sequenced: the adopt record is already
            # durably on the target (or there is no state to move).
            record_swallow("ingest.rebalance_marker_noop")
            return
        # Durably publish the state BEFORE dropping it: a crash between
        # the two replays this marker and re-exports; the target dedups
        # duplicate adopts. The reverse order could lose the document.
        self.tier.log.send_to(
            self.tier.topic, target, doc_id,
            {REBALANCE_KEY: "adopt", "doc": doc_id, "state": dump,
             "epoch": epoch, "source": self.partition})
        self.inner.drop_doc(doc_id, epoch)
        increment("ingest.rebalance_handoffs")

    def _adopt(self, message, record: dict) -> None:
        doc_id = record["doc"]
        if self.inner.adopt_doc(doc_id, record["state"]):
            increment("ingest.rebalance_adoptions")
        else:
            record_swallow("ingest.rebalance_adopt_dup")
        self.awaiting.discard(doc_id)
        self._note_buffering(doc_id, -1)  # retire the recovery note
        for held in self.buffered.pop(doc_id, []):
            self.inner.handler(held)

    # -- IPartitionLambda ---------------------------------------------------
    def handler(self, message) -> None:
        value = message.value
        if isinstance(value, dict) and REBALANCE_KEY in value:
            if value[REBALANCE_KEY] == "handoff":
                self._handoff(message, value)
            else:
                self._adopt(message, value)
            self._mark_offset(message)
            return
        if message.key in self.awaiting:
            # The document's state is still in flight from its old
            # owner: hold the record and replay it after adoption — per-
            # doc order across the handoff is arrival order, bit-for-bit.
            if message.key not in self.buffered:
                # Durable note BEFORE the pump can commit this offset:
                # a crash while awaiting re-reads from here.
                self._note_buffering(message.key, message.offset)
            self.buffered.setdefault(message.key, []).append(message)
            self._mark_offset(message)
            increment("ingest.rebalance_buffered")
            return
        self.inner.handler(message)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, item):
        return getattr(self.inner, item)

    # The shim's OWN state is this fixed set; everything else — reads
    # above, and writes here — belongs to the wrapped sequencer. Without
    # write-through, `tier.live(p).client_timeout_s = ...` (and every
    # other knob callers poke on "the sequencer") would silently land on
    # the shim and never reach the lambda that reads it.
    _OWN_ATTRS = frozenset(
        {"inner", "tier", "partition", "checkpoints", "buffered",
         "awaiting"})

    def __setattr__(self, name, value):
        if name in _RebalancingSequencer._OWN_ATTRS:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)


class SequencerShardSet:
    """The horizontally-sharded ingest tier (module docstring).

    ``lambda_factory(ctx, checkpoints)`` builds one sequencer lambda for
    a partition; ``checkpoints`` is that partition's scoped view (or
    None when the tier has no checkpoint store).

    ``partitions_owned`` (default: all of the topic's partitions) is the
    cross-host placement config: a worker process that owns a subset
    pumps ONLY those partitions against the shared remote broker, so
    scaling out is deploy/RUNBOOK.md config — two hosts owning [0..7]
    and [8..15] ARE the 16-partition tier. Routing (partition_for) still
    spans the full partition count on every host."""

    def __init__(self, log, topic: str, group: str,
                 lambda_factory: Callable[..., IPartitionLambda],
                 checkpoints=None, auto_commit: bool = True,
                 batch_acks: Optional[bool] = None,
                 partitions_owned: Optional[List[int]] = None):
        self.log = log
        self.topic = topic
        self.group = group
        self.checkpoints = checkpoints
        topic_obj = log.topic(topic)
        self.partitions = len(topic_obj.partitions)
        self.router = PartitionRouter(self.partitions)
        self._load_routing()
        # Batched acks engage for self-checkpointing lambdas on a truly
        # sharded topic; the single-partition pipeline keeps today's
        # eager per-checkpoint commit timing bit-for-bit.
        if batch_acks is None:
            batch_acks = (not auto_commit) and self.partitions > 1
        self.acks = AckBatcher(log, group, topic) if batch_acks else None

        def build(ctx: LambdaContext) -> IPartitionLambda:
            scoped = None if checkpoints is None else \
                PartitionCheckpoints(checkpoints, ctx.partition)
            lam = lambda_factory(ctx, scoped)
            if self.acks is not None:
                ctx.ack_batcher = self.acks
            return _RebalancingSequencer(lam, self, ctx.partition,
                                         checkpoints=scoped)

        self.manager = _ShardedPartitionManager(
            log, group, topic, build, auto_commit=auto_commit,
            acks=self.acks,
            workers_owned=lambda: self.workers_running,
            partitions=partitions_owned)
        # Guards the per-partition stats against concurrent workers; the
        # worker-lifecycle flags below are only written under it too.
        self._stats_lock = threading.Lock()
        self.stats: Dict[int, _PartitionStats] = {
            p: _PartitionStats() for p in self.manager.pumps}
        self._workers: List[threading.Thread] = []
        self._workers_run = False

    # -- partition access ---------------------------------------------------
    def live(self, partition: int) -> IPartitionLambda:
        """The LIVE lambda owning a partition (post-crash-restart this
        is the rebuilt instance — never cache it across restarts)."""
        return self.manager.pumps[partition].lambda_

    def partition_for(self, document_id: str) -> int:
        return self.router.partition_for(document_id)

    def delta_partition_for(self, document_id: str) -> int:
        """EMIT-side (deltas/broadcast) routing anchor: always the base
        md5 home, never a rebalance override — a document's output
        stream stays on one partition forever, which is what makes
        per-doc delivery order across a live rebalance total within one
        partition by construction (no consumer-side reordering gate)."""
        return self.router.base_partition_for(document_id)

    def sequencer_for(self, document_id: str) -> IPartitionLambda:
        """The live sequencer lambda owning a document's home partition."""
        return self.live(self.partition_for(document_id))

    def sequencers(self) -> List[IPartitionLambda]:
        return [self.live(p) for p in sorted(self.manager.pumps)]

    # -- live rebalancing ----------------------------------------------------
    def rebalance_doc(self, document_id: str, target: int) -> int:
        """Re-home one document's raw-topic sequencing to ``target``
        with NO fleet drain — returns the new routing epoch.

        Protocol (every step crash-replayable, docs/ingest_sharding.md):

          1. arm the target partition's buffering (``expect``) so a
             post-bump submit can never reach its sequencer unowned;
          2. persist the override (epoch bump) — submits now route to
             the target, where they buffer behind the in-flight state;
          3. append the handoff marker on the SOURCE partition; when the
             old owner pumps it, it exports the document's state,
             durably produces the adopt record onto the target, and
             drops the document (tombstoned checkpoint row).

        Because the marker rides the raw topic itself, everything the
        old owner sequenced BEFORE the override keeps its order, and
        everything after drains on the target after adoption — per-doc
        emit order is identical to the no-rebalance run."""
        document_id = str(document_id)
        source = self.router.partition_for(document_id)
        target = int(target)
        if target == source:
            return self.router.epoch
        if not 0 <= target < self.partitions:
            raise ValueError(
                f"rebalance target {target} out of range "
                f"[0, {self.partitions})")
        # Hook validation up front: the TPU-batched sequencer checkpoints
        # whole-lane state (one kind=="tpu-sequencer" row) and has no
        # per-document export surface — fail BEFORE any state changes.
        for p, role in ((source, "source"), (target, "target")):
            if p not in self.manager.pumps:
                raise RuntimeError(
                    f"rebalance_doc: {role} partition {p} is not owned "
                    "by this process (partitions_owned subset) — invoke "
                    "the rebalance on a host owning both partitions")
            lam = self.live(p)
            for hook in ("export_doc", "adopt_doc", "drop_doc"):
                if not callable(getattr(lam, hook, None)):
                    raise RuntimeError(
                        f"rebalance_doc: {role} partition {p} lambda "
                        f"({type(getattr(lam, 'inner', lam)).__name__}) "
                        f"has no {hook}() — live per-document handoff "
                        "requires the scalar DeliLambda sequencer")
        wrapper = self.manager.pumps[target].lambda_
        if isinstance(wrapper, _RebalancingSequencer):
            wrapper.expect(document_id)
        epoch = self.router.install_override(document_id, target)
        self._persist_routing()
        self.log.send_to(
            self.topic, source, document_id,
            {REBALANCE_KEY: "handoff", "doc": document_id,
             "target": target, "epoch": epoch})
        increment("ingest.rebalance_requests")
        return epoch

    def _persist_routing(self) -> None:
        """Durably record the override table in the shared checkpoint
        collection (ingestPartition=-1 keeps the row out of every
        partition's scoped view) — a restarted tier re-derives the same
        routes, so restart stability now includes live-rebalance moves."""
        if self.checkpoints is None:
            return
        row = {"kind": _ROUTING_ROW_KIND, "ingestPartition": -1}
        row.update(self.router.snapshot())
        self.checkpoints.upsert(
            lambda d: d.get("kind") == _ROUTING_ROW_KIND, row)

    def _load_routing(self) -> None:
        if self.checkpoints is None:
            return
        row = self.checkpoints.find_one(
            lambda d: d.get("kind") == _ROUTING_ROW_KIND)
        if row is not None:
            self.router.restore(row)

    # -- pumping ------------------------------------------------------------
    def pump_partition(self, partition: int, limit: int = 10 ** 9) -> int:
        """Drain one partition (busy-time accounted). Does NOT flush
        batched acks — round drivers flush once per round; workers flush
        after each call (their rounds are per-partition)."""
        pump = self.manager.pumps[partition]
        t0 = time.perf_counter()
        n = pump.pump(limit=limit)
        dt = time.perf_counter() - t0
        if n:
            with self._stats_lock:
                st = self.stats[partition]
                st.records += n
                st.pump_calls += 1
                st.busy_s += dt
        return n

    def pump_round(self, limit_per_partition: int = 10 ** 9) -> int:
        """One round-robin pass over every partition + one batched ack
        flush — the single-threaded drive loop (benches, tests). Refuses
        to run while workers own the partitions."""
        with self._stats_lock:
            workers_running = self._workers_run
        if workers_running:
            raise RuntimeError(
                "pump_round while partition workers are running: a "
                "partition must only ever be pumped by its one owner")
        total = 0
        for p in sorted(self.manager.pumps):
            total += self.pump_partition(p, limit_per_partition)
        self.flush_acks()
        return total

    def flush_acks(self) -> int:
        return self.acks.flush() if self.acks is not None else 0

    # -- per-partition worker threads ----------------------------------------
    def start_workers(self, idle_sleep_s: float = 0.0005) -> None:
        """One daemon worker per partition — the deployment shape (one
        worker per core). The hosting server must stop driving the deli
        stage itself (auto_pump off / round pumps refused) while workers
        run; downstream stages (scriptorium/scribe/broadcaster) still
        pump wherever they always did."""
        with self._stats_lock:
            if self._workers_run:
                return
            self._workers_run = True
        self._workers = [
            threading.Thread(target=self._worker, args=(p, idle_sleep_s),
                             name=f"ingest-partition-{p}", daemon=True)
            for p in sorted(self.manager.pumps)]
        for t in self._workers:
            t.start()

    def stop_workers(self, timeout: float = 5.0) -> None:
        with self._stats_lock:
            self._workers_run = False
        stuck = []
        for t in self._workers:
            t.join(timeout=timeout)
            if t.is_alive():
                stuck.append(t.name)
        if stuck:
            # A worker wedged inside its pump (device compile, stalled
            # lambda) still OWNS its partition: silently returning would
            # let the caller's pump_round become a second concurrent
            # driver of the same non-thread-safe sequencer. Re-flag and
            # refuse.
            with self._stats_lock:
                self._workers_run = True
            raise RuntimeError(
                f"partition workers still alive after {timeout}s: "
                f"{stuck} — the partitions stay worker-owned; retry "
                "stop_workers with a longer timeout")
        self._workers = []
        self.flush_acks()

    @property
    def workers_running(self) -> bool:
        with self._stats_lock:
            return self._workers_run

    def _worker(self, partition: int, idle_sleep_s: float) -> None:
        while True:
            with self._stats_lock:
                if not self._workers_run:
                    return
            n = self.pump_partition(partition)
            if n:
                self.flush_acks()
            else:
                time.sleep(idle_sleep_s)

    # -- occupancy / introspection -------------------------------------------
    def raw_backlog_partition(self, partition: int) -> int:
        """One partition's un-pumped broker-record backlog (end offset
        minus the group's committed offset) — the unit admission's queue
        accounting polls (one submit batch == one boxcar record; see the
        PR 6 phantom-drain fix)."""
        part = self.log.topic(self.topic).partitions[partition]
        return max(0, part.end_offset
                   - self.log.committed(self.group, self.topic, partition))

    def raw_backlog_by_partition(self) -> Dict[int, int]:
        return {p: self.raw_backlog_partition(p)
                for p in sorted(self.manager.pumps)}

    def raw_backlog(self) -> int:
        return sum(self.raw_backlog_by_partition().values())

    def occupancy_partition(self, partition: int) -> dict:
        """Raw backlog + the owning sequencer's occupancy hints for one
        partition (hints absent for lambdas that publish none)."""
        out = {"partition": partition,
               "backlog": self.raw_backlog_partition(partition)}
        lam = self.live(partition)
        hints = getattr(lam, "occupancy_hints", None)
        if hints is not None:
            out["hints"] = hints()
        return out

    def partition_stats(self) -> List[dict]:
        """Per-partition health/metrics block (monitor watch_partitions):
        offsets, lag, staged work, and the pump accounting."""
        topic_obj = self.log.topic(self.topic)
        out = []
        with self._stats_lock:
            pump_stats = {p: st.as_dict() for p, st in self.stats.items()}
        for p in sorted(self.manager.pumps):
            end = topic_obj.partitions[p].end_offset
            committed = self.log.committed(self.group, self.topic, p)
            row = {"partition": p, "endOffset": end,
                   "committedOffset": committed,
                   "lag": max(0, end - committed)}
            lam = self.live(p)
            hints = getattr(lam, "occupancy_hints", None)
            if hints is not None:
                h = hints()
                row["stagedOps"] = int(h.get("staged_ops", 0))
                row["ringOccupancy"] = int(h.get("ring_occupancy", 0))
            row.update(pump_stats.get(p, {}))
            out.append(row)
        return out

    def refresh_watermarks(self, tenant: str = "local") -> None:
        """Stamp the ingest tier's watermarks (telemetry/watermarks.py)
        from live state: raw_end/raw_ingested from the partition
        offsets, ticketed from each sequencer's per-doc head sequence
        numbers. Pull model — called at scrape/probe/soak-tick time, so
        the op path pays nothing; replayed offsets and sequence numbers
        fold to zero inside the monotonic table."""
        topic_obj = self.log.topic(self.topic)
        for p in sorted(self.manager.pumps):
            watermarks.advance(watermarks.RAW_END, p,
                               topic_obj.partitions[p].end_offset,
                               tenant=tenant)
            committed = self.log.committed(self.group, self.topic, p)
            watermarks.advance(watermarks.RAW_INGESTED, p,
                               max(0, committed or 0), tenant=tenant)
            seqs = getattr(self.live(p), "doc_sequence_numbers", None)
            if seqs is not None:
                for doc, seq in seqs().items():
                    watermarks.advance_doc(watermarks.TICKETED, p,
                                           doc, seq, tenant=tenant)

    # -- admission wiring ----------------------------------------------------
    def register_admission(self, controller, tenant_id: str) -> None:
        """Register one occupancy source per partition with the
        admission controller's PARTITION channel (fairness gate). These
        feeds do NOT add into the controller's global queue depth — the
        hosting server's aggregate ``core:<tenant>`` source already
        counts every partition's backlog, and summing both would
        re-introduce exactly the phantom-depth inflation the PR 6
        record accounting removed (regression-tested in
        tests/test_sharded_ingest.py)."""
        for p in sorted(self.manager.pumps):
            lam = self.live(p)
            has_hints = getattr(lam, "occupancy_hints", None) is not None
            controller.add_partition_source(
                p,
                queue_depth=lambda p=p: self.raw_backlog_partition(p),
                # Resolve the lambda at poll time: a crash-restart swaps
                # the instance and a captured handle would go stale.
                hints=(lambda p=p: self.live(p).occupancy_hints())
                if has_hints else None,
                # Tenant-scoped: alfred shares ONE controller across
                # tenant cores, and each core's feeds must coexist.
                scope=tenant_id)

    # -- crash / restart ------------------------------------------------------
    def restart_partition(self, partition: int) -> None:
        """Crash-restart one partition's lambda (rebuilt from its scoped
        checkpoints; the pump replays from the last committed offset)."""
        self.flush_acks()
        self.manager.pumps[partition].restart()
        with self._stats_lock:
            self.stats[partition].restarts += 1

    def restart_all(self) -> None:
        self.manager.restart()
        with self._stats_lock:
            for st in self.stats.values():
                st.restarts += 1
