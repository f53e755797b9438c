"""Container + Loader: document lifecycle against a real service (a port
of fluidframework_tpu's loader/container.py).

Capability parity with reference container-loader/src/{loader.ts,
container.ts:186,543}: create-detached -> attach (upload initial summary,
connect), load (fetch summary, init protocol + runtime, connect, process op
tail), reconnect with pending resubmission, quorum/audience tracking, and
the client summarize path (upload summary -> summarize op -> scribe ack,
reference summaryCollection.ts:244 waitSummaryAck).

The loader runs its containers on `device` (None means "cuda" and raises
without CUDA; tests pass "cpu"), handed down to every channel: a
sequence's bulk catch-up, at load or at a reconnect, runs the scan-apply
kernel there (kernels/csrc/scan_apply.cu).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

from ..core.device import resolve_device
from ..core.events import TypedEventEmitter
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..protocol.protocol_handler import ProtocolOpHandler, ProtocolState
from ..protocol.summary import SummaryTree
from ..runtime.container_runtime import ContainerRuntime
from ..runtime.datastore_runtime import ChannelRegistry
from .delta_manager import DeltaManager
from .drivers.base import IDocumentService, IDocumentServiceFactory


class Audience(TypedEventEmitter):
    """Connected-client roster (reference container-loader/src/audience.ts)."""

    def __init__(self):
        super().__init__()
        self.members: Dict[str, dict] = {}

    def add_member(self, client_id: str, details: dict) -> None:
        self.members[client_id] = details
        self.emit("addMember", client_id, details)

    def remove_member(self, client_id: str) -> None:
        if client_id in self.members:
            del self.members[client_id]
            self.emit("removeMember", client_id)


class Container(TypedEventEmitter):
    """Events: "connected", "disconnected", "op", "summaryAck",
    "summaryNack", "signal" (SignalMessage, local) — transient messages
    outside the sequenced stream — and "closed"."""

    def __init__(self, document_id: str, service: IDocumentService,
                 registry: Optional[ChannelRegistry] = None,
                 code_loader=None,
                 client_details: Optional[dict] = None,
                 device=None):
        super().__init__()
        self.document_id = document_id
        self.service = service
        self.client_details = dict(client_details or {})
        self.read_only = self.client_details.get("mode") == "read"
        self.storage = service.connect_to_storage()
        self.delta_manager = DeltaManager(service, self.client_details)
        self.protocol = ProtocolOpHandler()
        self.audience = Audience()
        self.runtime = ContainerRuntime(registry=registry, device=device)
        self.runtime.audience = self.audience
        self.attached = False
        self.connected = False
        self.closed = False
        self.code_loader = code_loader
        self.runtime_factory = None  # set when code details resolve
        self._code_details: Optional[dict] = None
        self._last_summary_handle: Optional[str] = None
        self._summary_waiters: List[Callable[[str, bool, Any], None]] = []
        import threading as _threading
        self._nack_gate = _threading.Lock()
        self._nack_recovery_live = False
        self._nack_rearm = False  # throttle nack landed mid-recovery
        self._nack_rearm_after = None

    @property
    def op_lock(self):
        """The container's serialization lock (the JS-event-loop analog).
        Network drivers deliver inbound ops on a reader thread under this
        lock; application code mutating DDSes from its own threads wraps the
        mutation in `with container.op_lock:` to serialize against them."""
        return self.delta_manager.lock

    # -- creation / loading ------------------------------------------------
    @staticmethod
    def create_detached(document_id: str, service: IDocumentService,
                        registry: Optional[ChannelRegistry] = None,
                        code_loader=None,
                        code_details: Optional[dict] = None,
                        device=None) -> "Container":
        container = Container(document_id, service, registry, code_loader,
                              device=device)
        if code_details is not None:
            container.set_code_details(code_details)
        return container

    @staticmethod
    def load(document_id: str, service: IDocumentService,
             registry: Optional[ChannelRegistry] = None,
             code_loader=None,
             client_details: Optional[dict] = None,
             device=None) -> "Container":
        """Reference Container.load (container.ts:186): summary + op tail
        — with the read tier's fast path layered on top
        (docs/read_path.md): the storage round trip returns `summary +
        catch-up delta` together, the delta adopts the summary-to-head
        gap as a state swap, and connect() then replays only the residue
        past the artifact's seq instead of the whole tail. An absent,
        stale, or unadoptable artifact degrades to exactly the old
        summary + tail-replay behavior.

        client_details={"mode": "read"} loads a READ-ONLY observer: it
        follows the live op/signal streams but never joins the quorum,
        never holds back the MSN, and never submits."""
        container = Container(document_id, service, registry, code_loader,
                              client_details, device=device)
        try:
            summary, artifact = container.storage.get_catchup()
        except Exception:  # noqa: BLE001 — a dead read tier must not fail loads
            from ..telemetry.counters import record_swallow
            record_swallow("container.get_catchup")
            summary, artifact = container.storage.get_summary(), None
        if summary is None:
            raise FileNotFoundError(f"document {document_id!r} has no summary")
        container._load_from_summary(summary)
        versions = container.storage.get_versions(1)
        container._last_summary_handle = versions[0] if versions else None
        if artifact is not None:
            container._try_adopt_catchup(artifact)
        container.attached = True
        container._instantiate_code(existing=True)
        container.connect()
        return container

    # -- code loading (web-code-loader + quorum "code" proposal) -----------
    def set_code_details(self, details: dict) -> None:
        """Select the code package for a detached container. The accepted
        proposal is folded into the quorum pre-attach (the reference
        serializes protocol state with the code proposal approved for
        detached containers) and the runtime factory runs first-time
        initialization."""
        if self.attached:
            raise RuntimeError("use propose_code_details on live containers")
        self._code_details = details
        self.protocol.quorum.add_proposal("code", details, 0)
        self.protocol.quorum.update_minimum_sequence_number(0)
        self._instantiate_code(existing=False)

    def _instantiate_code(self, existing: bool) -> None:
        if self.code_loader is None:
            return
        details = self.protocol.quorum.get("code") or self._code_details
        if details is None:
            return
        module = self.code_loader.load(details)
        self.runtime_factory = module.fluid_export
        self.runtime_factory.initialize(self, existing)

    def propose_code_details(self, details: dict) -> None:
        """Live code upgrade: a quorum "code" proposal (container.ts code
        upgrade path). When the MSN passes it unrejected, "codeChanged"
        fires; hosts reload the container against the new module (the
        reference closes + reloads the context the same way)."""
        self.delta_manager.submit(
            MessageType.PROPOSE, {"key": "code", "value": details})

    def request(self, url: str = "/"):
        """Route a request through the code-loaded runtime factory
        (reference request handler chain / base-host requestFluidObject)."""
        if self.runtime_factory is None:
            raise RuntimeError("container has no code-loaded runtime factory")
        return self.runtime_factory.request(self, url)

    def _load_from_summary(self, summary: SummaryTree) -> None:
        protocol_blob = summary.entries.get(".protocol")
        if protocol_blob is not None:
            state = json.loads(protocol_blob.content)
            self.protocol = ProtocolOpHandler.load(ProtocolState(
                sequence_number=state["sequenceNumber"],
                minimum_sequence_number=state["minimumSequenceNumber"],
                quorum_snapshot=state["quorum"]))
        self.runtime.load(summary.entries[".app"])

    # -- read-path catch-up adoption (docs/read_path.md) -------------------
    def _plan_catchup_adoption(self, artifact: dict):
        """Validate an artifact against the container's current state and
        return the fully-decoded adoption plan, or None with the fallback
        counter bumped. NOTHING mutates here — adoption is all-or-nothing
        (a partial adoption would desync channels against the shared
        per-doc sequence bookkeeping)."""
        from ..server.readpath import (quorum_ordinals,
                                       translate_entry_clients,
                                       unpack_entries_narrow)
        from ..telemetry.counters import increment

        seq = int(artifact["seq"])
        if seq <= self.protocol.sequence_number:
            # The summary we loaded already covers the artifact's state
            # (a client summary landed after the last refresh).
            increment("catchup.client.stale_artifact")
            return None
        # wire client id -> quorum ordinal (its join seq), from the SAME
        # quorum snapshot the adoption installs — protocol state and
        # perspective math cannot disagree.
        members = quorum_ordinals(artifact["quorum"])
        idx_to_ordinal = {}
        for i, cid in enumerate(artifact.get("clients", [])):
            if cid in members:
                idx_to_ordinal[i] = members[cid]
            else:
                # A DEPARTED client: its identity is semantically inert —
                # no op of its can ever arrive again (client ids are
                # never reused), so contended rows it left behind only
                # need an ordinal that collides with no live client
                # (join seqs are >= 1) and no future one. Unique
                # negatives below -1 satisfy both; the scalar replay
                # path keeps the real historical join seq here, a
                # divergence confined to metadata that can never affect
                # visibility again (docs/read_path.md).
                idx_to_ordinal[i] = -(i + 2)
        plan = []
        try:
            for store_id, channel_id, header, blob in artifact["channels"]:
                store = self.runtime.datastores.get(store_id)
                channel = store.channels.get(channel_id) \
                    if store is not None else None
                if channel is None \
                        or not hasattr(channel, "adopt_catchup_core") \
                        or not channel.can_adopt_catchup():
                    increment("catchup.client.unadoptable")
                    return None
                entries = unpack_entries_narrow(blob)
                # KeyError here = a contended row references a client the
                # quorum no longer knows: untranslatable, fall back.
                entries = translate_entry_clients(entries, idx_to_ordinal)
                plan.append((channel, entries, header))
        except (KeyError, ValueError, TypeError):
            increment("catchup.client.undecodable")
            return None
        return seq, members, plan

    def _try_adopt_catchup(self, artifact: dict) -> bool:
        """Adopt a catch-up artifact: protocol state + every channel swap
        to the artifact's seq, so the tail replay that follows covers
        only the residue past it. Returns False (state untouched) on any
        validation failure — the tail replay fallback is always
        correct, just O(tail)."""
        from ..telemetry.counters import increment

        planned = self._plan_catchup_adoption(artifact)
        if planned is None:
            return False
        seq, members, plan = planned
        msn = int(artifact.get("msn", 0))
        self.protocol = ProtocolOpHandler.load(ProtocolState(
            sequence_number=seq, minimum_sequence_number=msn,
            quorum_snapshot=artifact["quorum"]))
        self.runtime.sequence_number = seq
        self.runtime.minimum_sequence_number = msn
        # Ordinal table + audience come from the quorum snapshot — the
        # tail's join/leave ops we skipped are folded into it.
        self.runtime._ordinals = dict(members)
        details = {cid: (m.get("details") or {})
                   for cid, m in artifact["quorum"].get("members", [])}
        for cid in members:
            if cid not in self.audience.members:
                self.audience.add_member(cid, details.get(cid, {}))
        for channel, entries, header in plan:
            channel.adopt_catchup_core(
                entries,
                seq=int(header.get("sequenceNumber", seq)),
                min_seq=int(header.get("minimumSequenceNumber", 0)),
                total_length=int(header.get("totalLength", 0)))
        increment("catchup.client.adopted")
        self.emit("catchUpAdopted", seq)
        return True

    def _reconnect_catchup(self, last_seq: int):
        """DeltaManager catch-up hook: on (re)connect with a long gap, a
        clean container (no pending local state) fetches the artifact
        and adopts instead of replaying the gap. Returns the adopted seq
        (the delta manager resumes the residue there) or None."""
        from ..telemetry.counters import increment

        dm = self.delta_manager
        if self.runtime.pending.count:
            return None  # unacked local ops need scalar ack pairing
        if last_seq < self.protocol.sequence_number:
            return None  # mid-load inconsistency: let the replay settle it
        try:
            artifact = self.storage.get_catchup_artifact()
        except Exception:  # noqa: BLE001 — dead read tier: replay instead
            increment("catchup.client.fetch_failed")
            return None
        if artifact is None:
            return None
        gap = int(artifact.get("seq", 0)) - last_seq
        if gap < dm.bulk_catchup_threshold:
            return None  # short residue: the ordinary replay is cheaper
        with dm.lock:
            # Revalidate under the lock: the reader thread may have
            # delivered ops (or the runtime submitted) since the probe.
            if self.runtime.pending.count \
                    or dm.last_sequence_number != last_seq:
                return None
            if not self._try_adopt_catchup(artifact):
                return None
            dm.last_sequence_number = self.protocol.sequence_number
            dm.minimum_sequence_number = \
                self.protocol.minimum_sequence_number
            increment("catchup.client.reconnect_adopted")
            return self.protocol.sequence_number

    # -- attach (detached -> live) ----------------------------------------
    def attach(self) -> None:
        """Upload the initial summary and go live (container.ts:543)."""
        if self.attached:
            return
        for store in self.runtime.datastores.values():
            store.connect()
        handle = self.storage.upload_summary(self._assemble_summary(),
                                             initial=True)
        # The attach summary IS the ref head and exactly this state: it is
        # the incremental baseline from the very first client summary.
        self._last_summary_handle = handle
        self.runtime.baseline_epochs()
        self.attached = True
        self.connect()

    # -- connection --------------------------------------------------------
    def connect(self) -> None:
        self.protocol.quorum.on("approveProposal", self._on_approve_proposal)
        self.delta_manager.attach_op_handler(
            self.protocol.sequence_number, self._process)
        self.delta_manager.attach_bulk_handler(self._process_bulk)
        self.delta_manager.attach_catchup_fetch(self._reconnect_catchup)
        self.delta_manager.on("disconnect", self._on_disconnect)
        self.delta_manager.on("nack", self._on_nack)
        self.delta_manager.on("connect", self._on_connect_identity)
        self.delta_manager.on("signal", self._process_signal)
        self.delta_manager.connect()

    def _on_connect_identity(self, client_id: str) -> None:
        """Runs before the op pump: the runtime must know its wire identity
        when its own join op arrives (that is what flips it connected)."""
        self.runtime.set_local_client(client_id)
        if not self.runtime.attached:
            self.runtime.attach(self.delta_manager.submit)
        else:
            self.runtime._submit_fn = self.delta_manager.submit
        self.runtime._submit_signal_fn = self.delta_manager.submit_signal
        self.runtime._submit_batch_fn = self.delta_manager.submit_batch
        self.runtime.signals_live = True
        if self.read_only:
            # No join op will ever arrive for us, so the runtime never
            # goes connected; local edits RAISE at the runtime boundary
            # (an optimistic edit that can never ack would shadow remote
            # state forever), while ops and signals flow in. The container
            # itself reports connected immediately.
            self.runtime.read_only = True
            self.connected = True
            self.emit("connected")

    def _on_approve_proposal(self, seq, key, value, msn) -> None:
        if key == "code":
            self.emit("codeChanged", value)

    def _on_disconnect(self) -> None:
        self.connected = False
        self.runtime.set_connected(False)
        self.emit("disconnected")

    def _on_nack(self, nack) -> None:
        """Nack dispatch (reference deltaManager: retryable -> resubmit,
        non-retryable -> close):
        - 413 (too large): resubmitting the identical op can never
          succeed — close the container with an "error" event instead of
          reconnect-looping forever.
        - 429 (throttled): honor retryAfter on a WORKER thread — the nack
          can arrive synchronously inside submit with the container lock
          held, and sleeping there would stall every other thread.
        - anything else: immediate reconnect + resubmit."""
        from ..protocol.messages import (NACK_SERVICE_UNAVAILABLE,
                                         NACK_THROTTLED, NACK_TOO_LARGE)
        content = getattr(nack, "content", None)
        code = getattr(content, "code", None)
        if code == NACK_TOO_LARGE:
            self.emit("error", nack)
            self.close()
            return
        if code in (NACK_THROTTLED, NACK_SERVICE_UNAVAILABLE):
            # 503 is the admission controller's DEGRADE refusal
            # (server/admission.py): same contract as 429 — honor the
            # server-computed retry_after; an immediate reconnect storm
            # is exactly what a degraded server cannot absorb.
            #
            # Quiesce SYNCHRONOUSLY before the backoff sleep: the nacked
            # op is still at the head of the pending queue, and leaving
            # the connection up while the worker waits lets later edits
            # submit — a later op admitted past the refilled bucket acks
            # out of order against that pending head (DataCorruption).
            # Dropping the connection here archives in-flight ops and
            # parks new edits locally until the recovery reconnects.
            # (delta_manager.disconnect takes no lock, and the nack can
            # arrive on this thread inside submit under the RLock.)
            self._on_disconnect()
            self.delta_manager.disconnect()
            with self._nack_gate:
                if self._nack_recovery_live:
                    # One recovery in flight absorbs the storm — but the
                    # resubmission itself may be what got nacked, so
                    # re-arm: the recovery loop runs another round after
                    # its reconnect instead of losing the wakeup.
                    self._nack_rearm = True
                    self._nack_rearm_after = getattr(
                        content, "retry_after_s", None)
                    return
                self._nack_recovery_live = True
            import threading as _threading
            _threading.Thread(
                target=self._throttle_recover,
                args=(getattr(content, "retry_after_s", None),),
                daemon=True).start()
            return
        self.reconnect()

    def _throttle_recover(self, retry_after) -> None:
        import time as _time
        while True:
            try:
                if retry_after:
                    _time.sleep(min(float(retry_after), 5.0))
                if not self.closed:
                    self.reconnect()
            except BaseException:
                # The recovery thread is dying: release the gate so a
                # future nack can start a fresh recovery (a stuck True
                # would silence throttle recovery forever).
                with self._nack_gate:
                    self._nack_recovery_live = False
                    self._nack_rearm = False
                    self._nack_rearm_after = None
                raise
            with self._nack_gate:
                rearmed = self._nack_rearm and not self.closed
                # Server gave no retryAfter: floor the re-arm backoff at
                # 1s — a 429 path must never tight-loop the server.
                retry_after = self._nack_rearm_after or 1.0
                self._nack_rearm = False
                self._nack_rearm_after = None
                if not rearmed:
                    self._nack_recovery_live = False
                    return

    def reconnect(self) -> None:
        self._on_disconnect()
        self.delta_manager.reconnect()

    def close(self) -> None:
        self.closed = True
        self.delta_manager.disconnect()
        self.emit("closed")

    # -- inbound sequenced stream -----------------------------------------
    def _process(self, message: SequencedDocumentMessage) -> None:
        self.protocol.process_message(message)
        mtype = message.type
        if mtype == MessageType.CLIENT_JOIN:
            detail = json.loads(message.data) if message.data else {}
            joined = detail.get("clientId")
            self.audience.add_member(joined, detail.get("detail", {}))
            if joined == self.delta_manager.client_id:
                self.connected = True
                self.emit("connected")
        elif mtype == MessageType.CLIENT_LEAVE:
            detail = json.loads(message.data) if message.data else {}
            self.audience.remove_member(detail.get("clientId"))
        elif mtype == MessageType.SUMMARIZE:
            # Our own summarize op sequencing: its sequence number is the
            # summarySequenceNumber acks correlate on (summaryCollection.ts).
            if message.client_id == self.delta_manager.client_id:
                for waiter in self._summary_waiters:
                    if waiter["csn"] == message.client_sequence_number:
                        waiter["summary_seq"] = message.sequence_number
        elif mtype == MessageType.SUMMARY_ACK:
            self._last_summary_handle = message.contents["handle"]
            # The acked upload's epochs become the incremental baseline.
            self.runtime.on_summary_ack(message.contents["handle"])
            self._notify_summary(True, message.contents)
            self.emit("summaryAck", message.contents)
        elif mtype == MessageType.SUMMARY_NACK:
            self._notify_summary(False, message.contents)
            self.emit("summaryNack", message.contents)
        self.runtime.process(message)
        self.emit("op", message)

    # -- signals (transient stream) ----------------------------------------
    def submit_signal(self, signal_type: str, content: Any) -> None:
        """Broadcast a container-scope transient signal (reference
        container.ts submitSignal). Delivery is best-effort: unsequenced,
        undurable, client-relative order only."""
        self.runtime.submit_signal(signal_type, content)

    def _process_signal(self, signal) -> None:
        local = signal.client_id is not None and \
            signal.client_id == self.delta_manager.client_id
        self.runtime.process_signal(signal, local)
        self.emit("signal", signal, local)

    def _process_bulk(self, tail) -> None:
        """Catch-up tail processing with the device fast path.

        Ops on DIFFERENT channels commute (channel isolation), so the tail
        partitions into per-channel buffers that accumulate across
        interleavings — a document whose history alternates between two
        channels still reaches the bulk threshold on each (a contiguity
        requirement never would: real docs interleave every channel).
        Protocol bookkeeping stays strictly in tail order (buffered ops
        process protocol-side at buffer time). Any scalar-processed
        message except a heartbeat is a runtime-visible boundary
        (self-join ordinal adoption, client_left hooks, own-op acks on a
        buffered channel): all buffers flush before it so runtime-level
        ordering is preserved. Per-op events coalesce into one
        "bulkCatchUp" delta per channel, the reference's deferred-ops
        load behavior (sequence.ts:664)."""
        from ..core.errors import BulkApplyUnsupported

        buffers: dict = {}  # key -> [msgs]; insertion order = first seen
        hi_seq = [0, 0]  # highest (seq, msn) applied via a bulk buffer

        def flush() -> None:
            threshold = self.delta_manager.bulk_catchup_threshold
            # Messages the walk already applied scalar (joins, noops) may
            # sit PAST the buffered seqs: never let the restore below
            # regress what runtime.process already advanced to.
            hi_seq[0] = max(hi_seq[0], self.runtime.sequence_number)
            hi_seq[1] = max(hi_seq[1],
                            self.runtime.minimum_sequence_number)
            scalar_msgs = []
            for msgs in buffers.values():
                done = False
                if len(msgs) >= threshold:
                    try:
                        self.runtime.process_channel_bulk(msgs)
                        done = True
                    except (BulkApplyUnsupported, ValueError):
                        # Prevalidation refusals only, state untouched:
                        # scalar fallback. A kernel's refusal reaches here
                        # as a RuntimeError (MergeTreeClient.apply_bulk)
                        # and propagates.
                        done = False
                if not done:
                    scalar_msgs.extend(msgs)
                hi_seq[0] = max(hi_seq[0], msgs[-1].sequence_number)
                hi_seq[1] = max(hi_seq[1],
                                msgs[-1].minimum_sequence_number)
            buffers.clear()
            # Fallback buffers replay in GLOBAL sequence order (channel
            # isolation makes any order state-safe, but "op" listeners —
            # last_edited, summarizer — expect monotonic seqs). Protocol
            # side already ran at buffer time: runtime half only.
            scalar_msgs.sort(key=lambda m: m.sequence_number)
            for m in scalar_msgs:
                self.runtime.process(m)
                self.emit("op", m)
            # Bulk bypasses runtime.process (and scalar replay may end on
            # an earlier-seq buffer): pin the post-flush bookkeeping to
            # the true high-water mark — a summarize right after catch-up
            # stamps these into .metadata.
            if hi_seq[0] > self.runtime.sequence_number:
                self.runtime.sequence_number = hi_seq[0]
            if hi_seq[1] > self.runtime.minimum_sequence_number:
                self.runtime.minimum_sequence_number = hi_seq[1]

        dm = self.delta_manager
        for msg in tail:
            key = self._bulk_key(msg)
            if key is not None:
                self.protocol.process_message(msg)
                buffers.setdefault(key, []).append(msg)
                continue
            if msg.type != MessageType.NO_OP and buffers:
                flush()
            # Keep the delta manager's position current at every scalar
            # boundary: a resubmission triggered INSIDE this message
            # (self-join -> _resubmit_all) stamps refSeq from
            # last_sequence_number, and the bulk path otherwise only
            # advances it after the WHOLE tail — a pre-gap refSeq below
            # the server's MSN gets nacked, and the nack's reconnect
            # re-enters this very path: an unbounded synchronous
            # recursion (surfaced by the read-tier reconnect tests).
            if msg.sequence_number > dm.last_sequence_number:
                dm.last_sequence_number = msg.sequence_number
            if msg.minimum_sequence_number > dm.minimum_sequence_number:
                dm.minimum_sequence_number = msg.minimum_sequence_number
            self._process(msg)
        flush()

    def _bulk_key(self, message) -> tuple | None:
        """(store, channel) when the message can join a device bulk run."""
        if message.type != MessageType.OPERATION:
            return None
        if message.client_id == self.delta_manager.client_id:
            return None  # local acks need pending-state pairing
        if self.runtime.pending.has_prior(message.client_id):
            return None  # ours under a previous connection id: same
        contents = message.contents
        if not isinstance(contents, dict) or "attachStore" in contents:
            return None
        envelope = contents.get("contents")
        if not isinstance(envelope, dict):
            return None
        return self.runtime.bulk_route(contents.get("address"),
                                       envelope.get("address"),
                                       message.client_id)

    # -- summaries ---------------------------------------------------------
    def _assemble_summary(self, incremental: bool = False) -> SummaryTree:
        root = SummaryTree()
        snap = self.protocol.snapshot()
        root.add_blob(".protocol", json.dumps({
            "sequenceNumber": snap.sequence_number,
            "minimumSequenceNumber": snap.minimum_sequence_number,
            "quorum": snap.quorum_snapshot,
        }))
        root.entries[".app"] = self.runtime.summarize(
            incremental=incremental)
        return root

    def summarize(self, on_result: Optional[Callable[[str, bool, Any], None]]
                  = None) -> str:
        """Client summarize: upload -> summarize op -> scribe ack
        (SURVEY.md §3.5). Returns the uploaded commit handle.

        Incremental when a parent summary exists: channels (and whole
        datastores) unchanged since the last ACKED summary serialize as
        SummaryHandles the storage layer resolves against the parent
        commit — only deltas upload (reference trackState/SummaryTracker,
        sharedObject.ts:210-244, containerRuntime.ts:1317-1383)."""
        # Capture epochs BEFORE assembly: ops racing the (possibly slow,
        # network) upload bump past this snapshot and re-upload next time.
        epochs = self.runtime.all_channel_epochs()
        handle = self.storage.upload_summary(
            self._assemble_summary(
                incremental=self._last_summary_handle is not None),
            parent=self._last_summary_handle)
        self.runtime.record_upload(handle, epochs)
        # Register the waiter inside before_send: over an in-process service
        # the sequenced SUMMARIZE op AND its ack can both arrive synchronously
        # within submit(), and the waiter must exist (with its csn) by then.
        waiter = ({"csn": None, "summary_seq": None, "fn": on_result}
                  if on_result is not None else None)

        def _register(csn: int) -> None:
            if waiter is not None:
                waiter["csn"] = csn
                self._summary_waiters.append(waiter)

        self.delta_manager.submit(MessageType.SUMMARIZE, {
            "handle": handle,
            "head": self._last_summary_handle,
            "message": f"summary@{self.protocol.sequence_number}",
        }, before_send=_register)
        return handle

    def _notify_summary(self, ack: bool, contents: Any) -> None:
        proposal = (contents or {}).get("summaryProposal", {})
        target = proposal.get("summarySequenceNumber")
        remaining = []
        for waiter in self._summary_waiters:
            if waiter["summary_seq"] == target and target is not None:
                waiter["fn"](contents.get("handle"), ack, contents)
            else:
                remaining.append(waiter)
        self._summary_waiters = remaining


class Loader:
    """Resolves document ids to Containers (reference loader.ts), each on
    `device` (None means "cuda", which raises without CUDA)."""

    def __init__(self, factory: IDocumentServiceFactory,
                 registry: Optional[ChannelRegistry] = None,
                 code_loader=None,
                 code_details: Optional[dict] = None,
                 device=None):
        self.device = resolve_device(device)
        self.factory = factory
        self.registry = registry
        self.code_loader = code_loader
        self.code_details = code_details

    def create_detached(self, document_id: str,
                        code_details: Optional[dict] = None) -> Container:
        service = self.factory.create_document_service(document_id)
        return Container.create_detached(
            document_id, service, self.registry, self.code_loader,
            code_details or self.code_details, device=self.device)

    def resolve(self, document_id: str,
                client_details: Optional[dict] = None) -> Container:
        service = self.factory.create_document_service(document_id)
        return Container.load(document_id, service, self.registry,
                              self.code_loader,
                              client_details=client_details,
                              device=self.device)
