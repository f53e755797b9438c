"""DeltaManager: the op pump between the wire and the container.

Capability parity with reference container-loader/src/deltaManager.ts:108 —
inbound queue with strict ordering, gap detection + catch-up fetch from
delta storage (:1380 fetchMissingDeltas), outbound submission with
clientSequenceNumber stamping, nack handling, and reconnect (new delta
connection, refetch, hand the container a fresh client id to resubmit on).

A port of fluidframework_tpu's loader/delta_manager.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..core.events import TypedEventEmitter
from ..protocol.messages import (DocumentMessage, MessageType,
                                 SequencedDocumentMessage)
from ..telemetry import ChildLogger, OpRoundTripTelemetry, TelemetryLogger
from .delta_scheduler import DeltaScheduler
from .drivers.base import IDocumentService


class DeltaManager(TypedEventEmitter):
    """Events: "op" (each sequenced message, in order), "connect"
    (client_id), "disconnect", "nack", "signal" (SignalMessage — transient,
    NOT sequenced: no gap detection, no catch-up, no seq bookkeeping)."""

    def __init__(self, service: IDocumentService,
                 client_details: Optional[dict] = None,
                 logger: Optional[TelemetryLogger] = None,
                 scheduler: Optional[DeltaScheduler] = None):
        super().__init__()
        self.service = service
        self.client_details = client_details or {}
        self.scheduler = scheduler or DeltaScheduler()
        self.delta_storage = service.connect_to_delta_storage()
        self.connection = None
        self.client_id: Optional[str] = None
        self.last_sequence_number = 0
        self.client_sequence_number = 0
        self.minimum_sequence_number = 0
        self.logger = ChildLogger.create(logger, "DeltaManager")
        self._op_perf = OpRoundTripTelemetry(lambda: self.client_id,
                                             self.logger)
        self._handler: Optional[Callable[[SequencedDocumentMessage], None]] = None
        # Optional batch handler for the catch-up tail (device bulk path,
        # mergetree/catchup.py): receives the WHOLE contiguous fetched tail
        # at once when it is at least bulk_catchup_threshold long.
        self._bulk_handler: Optional[
            Callable[[List[SequencedDocumentMessage]], None]] = None
        self.bulk_catchup_threshold = 64
        # Optional artifact catch-up hook (docs/read_path.md): called at
        # the top of every catch-up with our position; when it adopts a
        # server catch-up artifact it advances last_sequence_number
        # itself (under self.lock) and returns the adopted seq — the
        # fetch loop below then covers only the residue past it.
        self._catchup_fetch: Optional[Callable[[int], Optional[int]]] = None
        self._inbound: List[SequencedDocumentMessage] = []
        self._processing = False
        # Inside an open inbound batch ({"batch": true} seen, closing
        # marker not yet): scheduler yields are held so the batch applies
        # atomically within one slice (reference DeltaScheduler batch
        # handling).
        self._in_batch = False
        # Noop heartbeat (reference deltaManager updateSequenceNumber): a
        # connected writer that only READS never tells the server its
        # refSeq advanced, pinning the MSN at its last submission. Send a
        # NO_OP carrying the fresh refSeq after noop_threshold remote ops
        # OR noop_idle_s of outbound silence (checked at delivery time) —
        # the time bound keeps live-but-idle writers well inside the
        # server's eviction window at any remote op rate. 0 disables each.
        self.noop_threshold = 25
        self.noop_idle_s = 2.25
        self._ops_since_submit = 0
        self._last_submit_time = time.monotonic()
        self._catching_up = False
        # The "event loop" of this container. In-process drivers deliver ops
        # synchronously on the caller's thread; network drivers deliver on a
        # websocket reader thread. Inbound processing and outbound submission
        # both serialize on this lock, and application code doing multi-
        # threaded DDS mutation takes it too (Container.op_lock).
        self.lock = threading.RLock()

    # -- lifecycle ---------------------------------------------------------
    def attach_op_handler(self, sequence_number: int,
                          handler: Callable[[SequencedDocumentMessage], None]
                          ) -> None:
        """Start pumping at sequence_number (the loaded summary's seq)."""
        self.last_sequence_number = sequence_number
        self._handler = handler

    def attach_bulk_handler(self, bulk_handler: Callable[
            [List[SequencedDocumentMessage]], None]) -> None:
        self._bulk_handler = bulk_handler

    def attach_catchup_fetch(self, fn: Callable[[int], Optional[int]]
                             ) -> None:
        self._catchup_fetch = fn

    def connect(self) -> str:
        self.connection = self.service.connect_to_delta_stream(
            self.client_details)
        self.client_id = self.connection.client_id
        self.client_sequence_number = 0
        # A batch left open by a mid-batch disconnect closes via the
        # refetched tail (batch members are durable contiguously), but the
        # flag must not leak across connections — and the bulk catch-up
        # path bypasses per-op metadata tracking entirely.
        self._in_batch = False
        self._ops_since_submit = 0
        self._last_submit_time = time.monotonic()
        self.connection.on("op", self._enqueue)
        self.connection.on("nack", lambda nack: self.emit("nack", nack))
        self.connection.on("signal", self._on_signal)
        self.connection.on("disconnect", lambda: self.emit("disconnect"))
        # Identity must be known to listeners BEFORE the op pump runs: the
        # catch-up tail contains our own join op, and the container runtime
        # goes "connected" by recognizing its client id in it.
        self.emit("connect", self.client_id)
        self.catch_up()
        return self.client_id

    def disconnect(self) -> None:
        if self.connection is not None:
            conn, self.connection = self.connection, None
            conn.close()

    def reconnect(self) -> str:
        """Drop the connection and establish a new identity; the container
        resubmits pending ops against it (deltaManager.ts:1119)."""
        self.disconnect()
        return self.connect()

    # -- outbound ----------------------------------------------------------
    def submit(self, mtype: str, contents, data: Optional[str] = None,
               before_send: Optional[Callable[[int], None]] = None) -> int:
        """Stamp and send one op. `before_send(csn)` runs after the
        clientSequenceNumber is assigned but before the wire push — callers
        record pending state there, because over an in-process service the
        sequenced ack can arrive synchronously inside the send."""
        with self.lock:
            if self.connection is None:
                raise ConnectionError("not connected")
            self.client_sequence_number += 1
            csn = self.client_sequence_number
            msg = DocumentMessage(
                client_sequence_number=csn,
                reference_sequence_number=self.last_sequence_number,
                type=mtype, contents=contents, data=data)
            if before_send is not None:
                before_send(csn)
            self._op_perf.on_submit(csn)
            self._ops_since_submit = 0
            self._last_submit_time = time.monotonic()
            self.connection.submit([msg])
            return csn

    def submit_batch(self, items, before_send=None) -> List[int]:
        """Send several ops as ONE wire submission (reference DeltaManager
        flush, deltaManager.ts:656-664): the whole list rides one boxcar,
        so the sequencer tickets it atomically — contiguous sequence
        numbers, no foreign op interleaved. Batch boundaries are marked in
        metadata ({"batch": true} on the first, {"batch": false} on the
        last) so receivers hold scheduler yields until the batch closes.
        `before_send(csn, contents)` runs per op before the wire push."""
        with self.lock:
            if self.connection is None:
                raise ConnectionError("not connected")
            msgs: List[DocumentMessage] = []
            csns: List[int] = []
            n = len(items)
            for i, (mtype, contents) in enumerate(items):
                self.client_sequence_number += 1
                csn = self.client_sequence_number
                metadata = None
                if n > 1:
                    if i == 0:
                        metadata = {"batch": True}
                    elif i == n - 1:
                        metadata = {"batch": False}
                msg = DocumentMessage(
                    client_sequence_number=csn,
                    reference_sequence_number=self.last_sequence_number,
                    type=mtype, contents=contents, metadata=metadata)
                if before_send is not None:
                    before_send(csn, contents)
                self._op_perf.on_submit(csn)
                msgs.append(msg)
                csns.append(csn)
            self._ops_since_submit = 0
            self._last_submit_time = time.monotonic()
            self.connection.submit(msgs)
            return csns

    def _on_signal(self, sig) -> None:
        # Same serialization contract as inbound ops: handlers run under
        # the container lock, so a signal handler reading DDS state never
        # races an application thread mutating it (op_lock docstring).
        with self.lock:
            self.emit("signal", sig)

    def submit_signal(self, content) -> None:
        """Send a transient signal (no clientSequenceNumber, no refSeq —
        signals live outside the sequenced stream entirely; reference
        deltaManager submitSignal passthrough)."""
        with self.lock:
            if self.connection is None:
                raise ConnectionError("not connected")
            self.connection.submit_signal(content)

    # -- inbound -----------------------------------------------------------
    def _enqueue(self, message: SequencedDocumentMessage) -> None:
        with self.lock:
            self._inbound.append(message)
        self._process_inbound()

    def _process_inbound(self) -> None:
        """Drain the inbound queue in sequence order. Deliveries happen
        under self.lock; gap-fill fetches (network I/O over remote drivers)
        happen with the lock RELEASED so application threads aren't stalled
        behind a slow/timed-out catch-up request."""
        while True:
            with self.lock:
                if self._processing:
                    return  # re-entrant deliveries drain in the outer loop
                self._processing = True
            gap: Optional[tuple] = None
            yielding = False
            try:
                with self.lock:
                    while self._inbound:
                        self._inbound.sort(key=lambda m: m.sequence_number)
                        msg = self._inbound[0]
                        if msg.sequence_number <= self.last_sequence_number:
                            self._inbound.pop(0)  # duplicate
                            continue
                        if msg.sequence_number > self.last_sequence_number + 1:
                            gap = (self.last_sequence_number,
                                   msg.sequence_number - 1)
                            # The fetch is network I/O, not processing time:
                            # close the slice so it isn't billed against the
                            # quantum (a spurious yield per gap otherwise).
                            self.scheduler.drain_done()
                            break
                        self._inbound.pop(0)
                        self.scheduler.op_started()
                        self._deliver(msg)
                        self.scheduler.op_processed()
                        meta = msg.metadata
                        if isinstance(meta, dict) and "batch" in meta:
                            self._in_batch = bool(meta["batch"])
                        if self.scheduler.should_yield() \
                                and not self._in_batch:
                            yielding = True
                            break
                    else:
                        self.scheduler.drain_done()
                if yielding:
                    self.scheduler.on_yield()  # lock released
                if gap is not None:
                    fetched = self.delta_storage.get(*gap)  # lock released
                    with self.lock:
                        self._inbound = fetched + self._inbound
            finally:
                self._processing = False
            with self.lock:
                # Another thread may have enqueued while we were fetching /
                # finishing the drain (its _process_inbound no-oped on the
                # _processing flag). Go around again only if the queue now
                # has something deliverable; an unfillable gap waits for the
                # next arrival instead of spinning.
                if not self._inbound:
                    return
                head = min(m.sequence_number for m in self._inbound)
                if head > self.last_sequence_number + 1:
                    return

    def _deliver(self, msg: SequencedDocumentMessage) -> None:
        self.last_sequence_number = msg.sequence_number
        self.minimum_sequence_number = msg.minimum_sequence_number
        self._op_perf.on_sequenced(msg)
        # Count remote non-noop activity only: counting noops would make
        # two idle clients answer each other's heartbeats forever.
        if msg.client_id is not None and msg.client_id != self.client_id \
                and msg.type != MessageType.NO_OP:
            self._ops_since_submit += 1
        if self._handler is not None:
            self._handler(msg)
        self.emit("op", msg)
        self._maybe_send_noop()

    def _maybe_send_noop(self) -> None:
        if self._ops_since_submit == 0:
            return  # nothing remote since our last submission
        count_due = (self.noop_threshold
                     and self._ops_since_submit >= self.noop_threshold)
        idle_due = (self.noop_idle_s and
                    time.monotonic() - self._last_submit_time
                    >= self.noop_idle_s)
        if not (count_due or idle_due):
            return
        if self._inbound or self._catching_up:
            # Mid-catch-up/drain: our refSeq is still behind the head and
            # deli would nack it (refSeq < MSN). Defer; the counter keeps
            # its value, so the heartbeat fires at the head.
            return
        if self.connection is None or \
                self.client_details.get("mode") == "read":
            self._ops_since_submit = 0  # readers cannot submit
            return
        try:
            self.submit(MessageType.NO_OP, None)
        except ConnectionError:
            # A concurrent disconnect raced the check above (close() nulls
            # the connection without the lock): a heartbeat is always safe
            # to drop, and it must never crash the delivery thread.
            pass

    def catch_up(self) -> None:
        """Fetch + process everything durable past our position
        (deltaManager.ts:1401). A long contiguous tail is handed to the
        bulk handler in one call — the device catch-up path — instead of
        per-op enqueueing; anything irregular falls back per-message."""
        self._catching_up = True
        try:
            self._catch_up()
        finally:
            self._catching_up = False
            self._maybe_send_noop()  # deferred heartbeat fires at the head

    def _catch_up(self) -> None:
        tail: List[SequencedDocumentMessage] = []
        tried_artifact = False
        while True:
            from_seq = (tail[-1].sequence_number if tail
                        else self.last_sequence_number)
            fetched = self.delta_storage.get(from_seq)
            if not fetched:
                break
            tail.extend(fetched)
            if self._catchup_fetch is not None and not tried_artifact \
                    and len(tail) >= self.bulk_catchup_threshold:
                # The read-tier fast path (docs/read_path.md), engaged
                # only once the tail is provably long — short gaps never
                # pay an artifact round trip. The hook owns its locking
                # and preconditions; on adoption it advances
                # last_sequence_number itself and returns the adopted
                # seq, and everything the artifact covers drops from the
                # fetched tail (the residue keeps replaying below).
                tried_artifact = True
                adopted = self._catchup_fetch(self.last_sequence_number)
                if adopted:
                    tail = [m for m in tail
                            if m.sequence_number > adopted]
        if not tail:
            return
        if (self._bulk_handler is not None
                and len(tail) >= self.bulk_catchup_threshold):
            with self.lock:
                # Revalidate under the lock: the connection's reader thread
                # may have delivered (and processed) a prefix of this tail
                # concurrently — drop what is already applied and require
                # gapless continuation from our position.
                live = [m for m in tail
                        if m.sequence_number > self.last_sequence_number]
                contiguous = all(
                    m.sequence_number == self.last_sequence_number + 1 + i
                    for i, m in enumerate(live))
                if contiguous and \
                        len(live) >= self.bulk_catchup_threshold:
                    self._bulk_handler(live)
                    self.last_sequence_number = live[-1].sequence_number
                    self.minimum_sequence_number = \
                        live[-1].minimum_sequence_number
                    # The bulk path applied any batch markers wholesale.
                    self._in_batch = False
                    return
        for msg in tail:
            self._enqueue(msg)
