"""Broadcaster: fans sequenced ops out to connected clients per document
room (reference broadcaster/lambda.ts — socket.io rooms batched per
tenantId/documentId), with optional doc-hash-sharded fan-out workers.

A copy of fluidframework_tpu's server/lambdas/broadcaster.py, host code
that the port keeps as its own.

Inline mode (shards=0, the default) delivers on the pump thread —
synchronous and deterministic, what every in-process test relies on.
Sharded mode (docs/read_path.md) is the million-reader shape: one hot
document, or a reconnect avalanche resubscribing thousands of listeners,
must not serialize EVERY room's delivery through one pump thread. Each
document hashes to a fixed shard (per-doc delivery order is preserved —
one FIFO queue per shard), shard queues are bounded, and an overloaded
shard sheds its OLDEST entries: dropped fan-outs are safe by the read
path's own contract — a client that misses a broadcast sees the gap on
the next delivered op and refetches from delta storage (DeltaManager gap
detection), and the shed count feeds admission/monitoring so the
condition is visible instead of silent.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ...protocol.messages import SequencedDocumentMessage
from ...telemetry import tracing
from ...telemetry import watermarks
from ...telemetry.counters import gauge, increment
from ..log import QueuedMessage
from ..routing import doc_shard
from .base import IPartitionLambda, LambdaContext


def shard_for(document_id: str, shards: int) -> int:
    """Stable doc -> shard routing: the SHARED md5 scheme
    (server/routing.py doc_shard) the ingest partition router also uses,
    so the broadcast shard and the sequencing partition of a document
    can never disagree. md5, not hash(): per-process seed randomization
    would re-shard every restart and break run-twice determinism in the
    soak suite."""
    return doc_shard(document_id, shards)


class _Shard:
    """One fan-out worker: a bounded FIFO of (doc_id, message) + the
    thread draining it. Bounded-queue policy: shed from the HEAD (oldest
    first) — the freshest ops are the ones that close a reader's gap."""

    def __init__(self, index: int, queue_limit: int,
                 deliver: Callable[[str, SequencedDocumentMessage], None]):
        self.index = index
        self.queue_limit = queue_limit
        self.deliver = deliver
        self.queue: deque = deque()
        self.cond = threading.Condition()
        self.shed = 0
        self.delivered = 0
        self.busy = False  # worker inside deliver() (drain() waits on it)
        self.closed = False
        self.thread = threading.Thread(
            target=self._run, name=f"broadcaster-shard-{index}",
            daemon=True)
        self.thread.start()

    def put(self, doc_id: str, message: SequencedDocumentMessage) -> None:
        with self.cond:
            if self.closed:
                return
            while len(self.queue) >= self.queue_limit:
                self.queue.popleft()
                self.shed += 1
                increment("broadcaster.shed")
            self.queue.append((doc_id, message, time.perf_counter()))
            self.cond.notify()

    def _run(self) -> None:
        while True:
            with self.cond:
                while not self.queue and not self.closed:
                    self.cond.wait(timeout=0.5)
                if self.closed and not self.queue:
                    return
                doc_id, message, t_enq = self.queue.popleft()
                self.busy = True
            try:
                self.deliver(doc_id, message)
            except Exception:  # noqa: BLE001 — a listener bug must not kill the shard
                from ...telemetry.counters import record_swallow
                record_swallow("broadcaster.shard_deliver")
            finally:
                # Shard-worker span (docs/observability.md): enqueue →
                # delivered, so the span measures queue DWELL + fan-out —
                # the figure a backed-up shard actually adds to reader
                # latency. Pre-measured record_span joined to the op's
                # wire context (same pattern as _fan_out); the histogram
                # fills even with tracing off.
                tracing.record_span(
                    "broadcaster.shard", tracing.message_context(message),
                    t_enq, time.perf_counter(),
                    hist="broadcaster.shard_dwell", shard=self.index,
                    document=doc_id)
                with self.cond:
                    self.busy = False
                    self.delivered += 1
                    if not self.queue:
                        self.cond.notify_all()  # wake drain() waiters

    def depth(self) -> int:
        with self.cond:
            return len(self.queue)

    def drain(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.queue or self.busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.cond.wait(timeout=min(remaining, 0.05))
        return True

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()


class BroadcasterLambda(IPartitionLambda):
    def __init__(self, context: LambdaContext,
                 rooms: Dict[str, List[Callable]] = None,
                 shards: int = 0, queue_limit: int = 1024):
        self.context = context
        # document id -> list of listener callbacks (the "room"). The dict
        # may be owned by the hosting server so membership survives a
        # crash-restart of this lambda (connection state is not log-derived).
        self.rooms: Dict[str, List[Callable[[SequencedDocumentMessage], None]]] \
            = rooms if rooms is not None else {}
        self.queue_limit = queue_limit
        self.closed = False  # crash-restart superseded (see close())
        self.shards: List[_Shard] = [
            _Shard(i, queue_limit, self._fan_out)
            for i in range(max(0, int(shards)))]

    def join_room(self, document_id: str,
                  listener: Callable[[SequencedDocumentMessage], None]) -> None:
        self.rooms.setdefault(document_id, []).append(listener)

    def leave_room(self, document_id: str, listener) -> None:
        room = self.rooms.get(document_id)
        if room and listener in room:
            room.remove(listener)

    def handler(self, message: QueuedMessage) -> None:
        value = message.value
        if hasattr(value, "messages"):
            # SequencedWindow: one record per flush; fan out per room.
            for doc_id, sequenced in value.messages():
                self._route(doc_id, sequenced)
            self.context.checkpoint(message.offset)
            return
        doc_id, sequenced = value
        self._route(doc_id, sequenced)
        # Sharded mode checkpoints at ENQUEUE: fan-out is at-most-once
        # past this offset (a crash loses queued deliveries, exactly
        # like a shed — readers recover via the catch-up fetch), which
        # keeps a slow room from stalling the whole partition's pump.
        self.context.checkpoint(message.offset)

    def _route(self, doc_id: str,
               sequenced: SequencedDocumentMessage) -> None:
        if not self.shards:
            self._fan_out(doc_id, sequenced)
            return
        self.shards[shard_for(doc_id, len(self.shards))].put(doc_id,
                                                             sequenced)

    def _fan_out(self, doc_id: str,
                 sequenced: SequencedDocumentMessage) -> None:
        # Traced ops record the fan-out hop (metadata survived ticketing
        # via from_document_message, so the span joins the op's trace);
        # untraced ops take the bare loop. Pre-measured record_span (not
        # a context-manager Span) keeps the per-op cost off the fan-out
        # hot path's <2% tracing-overhead budget.
        ctx = tracing.message_context(sequenced)
        if ctx is None:
            self._deliver_room(doc_id, sequenced)
            self._mark_delivered(doc_id, sequenced)
            return
        t0 = time.perf_counter()
        self._deliver_room(doc_id, sequenced)
        tracing.record_span("broadcaster.fanout", ctx, t0,
                            time.perf_counter(), document=doc_id,
                            seq=sequenced.sequence_number,
                            shard=(shard_for(doc_id, len(self.shards))
                                   if self.shards else -1))
        self._mark_delivered(doc_id, sequenced)

    def _mark_delivered(self, doc_id: str,
                        sequenced: SequencedDocumentMessage) -> None:
        # `broadcast` watermark (telemetry/watermarks.py): per-doc seq
        # high-water, so replays and shed-then-covered gaps fold to the
        # honest delivered frontier. One guarded dict update per op —
        # inside the fan-out path's existing per-op budget.
        # Embedder/test contexts are single-partition and carry no
        # partition id; fold their marks to p0.
        watermarks.advance_doc(watermarks.BROADCAST,
                               getattr(self.context, "partition", 0),
                               doc_id, sequenced.sequence_number)

    def _deliver_room(self, doc_id: str,
                      sequenced: SequencedDocumentMessage) -> None:
        if not self.shards:
            # Inline mode: exceptions propagate to the pump exactly as
            # they always did (in-process listeners are trusted).
            for listener in list(self.rooms.get(doc_id, [])):
                listener(sequenced)
            return
        # Sharded mode: per-LISTENER isolation — one subscriber's bug
        # must not starve the rest of the room (there is no pump-level
        # caller left to surface it to; the swallow counter is the
        # visibility).
        for listener in list(self.rooms.get(doc_id, [])):
            try:
                listener(sequenced)
            except Exception:  # noqa: BLE001 — counted, see above
                from ...telemetry.counters import record_swallow
                record_swallow("broadcaster.listener")

    # -- read-tier introspection (monitor.watch_readpath) ------------------
    def queue_depth(self) -> int:
        return sum(s.depth() for s in self.shards)

    def queue_depths(self) -> List[int]:
        """Per-shard backlog; also refreshes the per-shard depth gauges
        every time a probe reads it (broadcaster.queue_depth.shard<i>)."""
        depths = [s.depth() for s in self.shards]
        for i, d in enumerate(depths):
            gauge(f"broadcaster.queue_depth.shard{i}", d)
        return depths

    def shed_count(self) -> int:
        return sum(s.shed for s in self.shards)

    def stats(self) -> dict:
        return {
            "shards": len(self.shards),
            "queueLimit": self.queue_limit,
            "queueDepths": self.queue_depths(),
            "shed": self.shed_count(),
            "delivered": sum(s.delivered for s in self.shards),
            "rooms": len(self.rooms),
        }

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every shard queue is empty (inline mode: no-op)."""
        ok = True
        for s in self.shards:
            ok = s.drain(timeout) and ok
        return ok

    def close(self) -> None:
        """Crash-restart/shutdown: shard workers DRAIN their queues and
        exit — enqueued messages are already past the checkpoint, so the
        replacement lambda never replays them; dropping them here would
        lose the at-least-once leg. The hosting server prunes closed
        instances from its registry (LocalServer._build_broadcaster)."""
        self.closed = True
        for s in self.shards:
            s.close()
