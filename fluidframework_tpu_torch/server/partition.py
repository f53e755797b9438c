"""The lambda host: runner + partition manager + checkpointing.

A copy of fluidframework_tpu's server/partition.py, host code that the
port keeps as its own.

Capability parity with reference lambdas-driver/src/kafka-service/
(runner.ts:13, partitionManager.ts:22, partition.ts:24, checkpointManager
.ts:10): a runner consumes a topic, spawns one Partition pump per log
partition (queue + pause/resume backpressure), dispatches to the lambda,
and commits offsets so a crashed lambda replays idempotently from its last
checkpoint. The document-router's per-document sub-partitioning is folded
into the lambdas themselves here (they key state by document id).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .lambdas.base import IPartitionLambda, LambdaContext
from .log import MessageLog, QueuedMessage


class PartitionPump:
    """One partition's dispatch loop (reference partition.ts): delivers
    queued messages to the lambda in order; on error, signals the manager
    to restart from the last checkpoint."""

    def __init__(self, log: MessageLog, group: str, topic: str,
                 partition: int,
                 lambda_factory: Callable[[LambdaContext], IPartitionLambda],
                 on_error: Optional[Callable[[Exception, bool], None]] = None,
                 auto_commit: bool = True):
        self.log = log
        self.group = group
        self.topic = topic
        self.partition = partition
        self.context = LambdaContext(log, group, topic, partition, on_error)
        self.lambda_factory = lambda_factory
        self.lambda_ = lambda_factory(self.context)
        self.paused = False
        # auto_commit=False when the lambda owns its replay window (the
        # document router consolidates per-document checkpoints; an eager
        # batch commit here would shrink what a crash replays).
        self.auto_commit = auto_commit
        self._cursor = 0  # next offset to dispatch (>= committed offset)
        self._lock = threading.Lock()

    def pump(self, limit: int = 10**9) -> int:
        """Drain available messages (synchronous dispatch)."""
        if self.paused:
            return 0
        processed = 0
        partition = self.log.topic(self.topic).partitions[self.partition]
        while processed < limit:
            start = max(self._cursor,
                        self.log.committed(self.group, self.topic,
                                           self.partition))
            batch = partition.read(start, min(256, limit - processed))
            if not batch:
                break
            for msg in batch:
                try:
                    self.lambda_.handler(msg)
                except Exception as err:  # noqa: BLE001 — lambda crash path
                    self.restart()
                    self.context.error(err, restart=True)
                    return processed
                processed += 1
                self._cursor = msg.offset + 1
            if self.auto_commit:
                # Lambdas checkpoint themselves; ensure forward progress even
                # if a lambda checkpoints lazily.
                self.log.commit(self.group, self.topic, self.partition,
                                batch[-1].offset)
        if processed:
            try:
                self.lambda_.flush()
            except Exception as err:  # noqa: BLE001 — lambda crash path
                self.restart()
                self.context.error(err, restart=True)
        return processed

    def restart(self) -> None:
        """Crash recovery: rebuild the lambda; the next pump replays from
        the last committed offset (idempotent handlers absorb the replay)."""
        self.lambda_.close()
        # With batched acks (server/sharding.py) the lambda's checkpoint
        # STATE may be ahead of the committed offset (the ack is noted,
        # not yet flushed). The rebuilt lambda restores that state with
        # its per-doc replay guards reset (fresh_log), so an unflushed
        # ack would make the replay window overlap the restored state —
        # already-sequenced joins would re-sequence. Flush AFTER close()
        # (close's own checkpoint notes one more ack) so state and
        # offset agree again, exactly like the eager-commit pipeline.
        batcher = getattr(self.context, "ack_batcher", None)
        if batcher is not None:
            batcher.flush()
        self.lambda_ = self.lambda_factory(self.context)
        self._cursor = self.log.committed(self.group, self.topic,
                                          self.partition)

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False


class PartitionManager:
    """Spawns a pump per partition of a topic (partitionManager.ts:22)."""

    def __init__(self, log: MessageLog, group: str, topic: str,
                 lambda_factory: Callable[[LambdaContext], IPartitionLambda],
                 auto_commit: bool = True, offload: bool = False,
                 partitions: Optional[List[int]] = None):
        self.log = log
        # offload=True marks a pure-persistence stage (scriptorium/scribe/
        # copier): safe to pump on a worker thread because it never calls
        # back into client connections. Interactive stages (deli nacks,
        # broadcaster delivery) re-enter client locks and MUST pump on the
        # submitting thread (same-thread RLock reentrancy).
        self.offload = offload
        self.pumps: Dict[int, PartitionPump] = {}
        topic_obj = log.topic(topic)
        # partitions=None owns the whole topic (the single-host shape);
        # an explicit subset is the cross-host placement config — each
        # worker process pumps only ITS partitions against the shared
        # remote broker (deploy/RUNBOOK.md multi-host recipe).
        owned = range(len(topic_obj.partitions)) if partitions is None \
            else sorted({int(p) for p in partitions})
        for p in owned:
            if not 0 <= p < len(topic_obj.partitions):
                raise ValueError(
                    f"owned partition {p} out of range for topic "
                    f"{topic!r} with {len(topic_obj.partitions)} "
                    "partitions")
            self.pumps[p] = PartitionPump(log, group, topic, p,
                                          lambda_factory,
                                          auto_commit=auto_commit)

    def pump_all(self) -> int:
        return sum(p.pump() for p in self.pumps.values())

    def restart(self) -> None:
        """Crash-restart every partition's lambda (fresh instances rebuilt
        from their checkpoint stores; consumer offsets are preserved)."""
        for pump in self.pumps.values():
            pump.restart()

    def lambdas(self) -> List[IPartitionLambda]:
        return [p.lambda_ for p in self.pumps.values()]


class LambdaRunner:
    """Hosts several PartitionManagers and pumps them round-robin — the
    single-process stand-in for the reference's one-service-per-lambda
    deployment (docker-compose.yml), preserving the pipeline-parallel shape:
    each stage drains independently against its own consumer group."""

    def __init__(self):
        self.managers: List[PartitionManager] = []
        # Epoch-cadence side work that rides the pump loop without being
        # a consumer-group stage (the read-tier artifact push-through):
        # each ticker is a callable returning work done; tickers run at
        # quiescence so they see flush-boundary state, and they rate-
        # limit themselves (a ticker firing every pump would turn the
        # idle poll loop busy).
        self.tickers: List[Callable[[], int]] = []

    def add(self, manager: PartitionManager) -> PartitionManager:
        self.managers.append(manager)
        return manager

    def add_ticker(self, ticker: Callable[[], int]) -> None:
        self.tickers.append(ticker)

    def _tick(self) -> int:
        return sum(t() for t in self.tickers)

    def pump(self) -> int:
        total = 0
        while True:
            n = sum(m.pump_all() for m in self.managers)
            total += n
            if n == 0:
                return total + self._tick()

    def close(self) -> None:
        pass


class OverlappedLambdaRunner(LambdaRunner):
    """Pipeline-stage overlap (reference kafka-service/README.md:58-60:
    "process batch N+1 while batch N's DB writes are in flight"): each
    round pumps the offload-marked persistence stages on worker threads
    concurrently with the interactive stages inline, so the sequencer
    drains batch N+1 while scriptorium/scribe flush batch N. pump() stays
    synchronous (returns at quiescence), keeping the serial runner's
    crash/replay semantics; within a round the stage wall-clock is
    max(inline, slowest-offloaded), not the sum.

    Only managers with offload=True move off-thread: stages that call back
    into client connections (broadcaster delivery, deli nacks) re-enter
    client-side locks held by the submitting thread and would deadlock on
    a worker."""

    def __init__(self):
        super().__init__()
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=max(len(self.managers), 1),
                thread_name_prefix="lambda-stage")
        return self._pool

    def pump(self) -> int:
        pool = self._ensure_pool()
        total = 0
        while True:
            futures = [pool.submit(m.pump_all)
                       for m in self.managers if m.offload]
            n = sum(m.pump_all() for m in self.managers if not m.offload)
            n += sum(f.result() for f in futures)
            total += n
            if n == 0:
                return total + self._tick()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
