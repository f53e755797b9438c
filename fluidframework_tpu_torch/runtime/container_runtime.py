"""ContainerRuntime: the per-container op router + lifecycle (a port of
fluidframework_tpu's runtime/container_runtime.py).

Capability parity with reference packages/runtime/container-runtime/src/
containerRuntime.ts:440 (process :1002, submit :1506, reSubmit :1627,
createSummary :1317) — with the reference's two-level routing
(ContainerRuntime -> FluidDataStoreContext -> FluidDataStoreRuntime)
collapsed to one explicit level (SURVEY.md §7.4: one level of routing is
enough in a new design).

Responsibilities here: datastore registry + envelope routing, op batching,
pending-state tracking with in-order ack enforcement, client-ordinal
interning from quorum join order, reconnect resubmission, summary tree
assembly, and GC data collection.

The runtime talks *down* to a delta submission function (driver/sequencer)
and receives *up* sequenced messages via process(); the loader Container
owns the protocol handler and connection state.

`device` (None means "cuda", which raises without CUDA; tests pass "cpu")
is the device its data stores' channels run on: a sequence's bulk
catch-up runs the scan-apply kernel there.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

from ..core.device import resolve_device
from ..core.events import TypedEventEmitter
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..protocol.summary import SummaryTree
from .blob_manager import BlobManager
from .datastore_runtime import ChannelRegistry, DataStoreRuntime
from .pending_state import PendingStateManager
from .summarizer import GCResult, run_garbage_collection


class ContainerRuntime(TypedEventEmitter):
    # Ops whose serialized contents exceed this split into CHUNKED_OP
    # messages (reference containerRuntime.ts:1444 submitChunkedMessage /
    # :1557 processRemoteChunkedMessage; IContainerRuntimeOptions
    # maxOpSizeInBytes). Overridable via options={"maxOpSize": n}.
    DEFAULT_MAX_OP_SIZE = 768 * 1024

    def __init__(self, submit_fn: Optional[Callable[[str, Any], int]] = None,
                 registry: Optional[ChannelRegistry] = None,
                 options: Optional[Dict[str, Any]] = None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self._submit_fn = submit_fn  # (type, contents) -> client_seq_number
        self._submit_signal_fn: Optional[Callable[[Any], None]] = None
        # Batch submission (DeltaManager.submit_batch): one boxcar for a
        # whole order_sequentially batch => contiguous sequencing. None
        # under mock runtimes -> falls back to per-op sends.
        self._submit_batch_fn: Optional[Callable] = None
        # Connected-client roster, set by the owning Container (reference
        # IFluidDataStoreRuntime.getAudience()); None under mock runtimes.
        self.audience = None
        # Signals flow on any live delta connection — including read-only
        # containers, which never go op-connected (no join op) but still
        # broadcast presence (reference: readers submit signals).
        self.signals_live = False
        # Read-only containers REJECT local mutations outright: an
        # optimistic local edit that can never submit would pend forever
        # and shadow all future remote updates on this replica.
        self.read_only = False
        self.registry = registry
        self.options = dict(options or {})
        self.max_op_size = int(self.options.get(
            "maxOpSize", self.DEFAULT_MAX_OP_SIZE))
        # Partial chunked-op reassembly per sending client id
        # (reference chunkMap, containerRuntime.ts:1557).
        self._chunk_buffers: Dict[str, List[str]] = {}
        # Datastores created while live whose attach op is unacked.
        self._pending_store_attach: Dict[str, dict] = {}
        # Incremental-summary bookkeeping: channel epochs as of the last
        # ACKED summary (only against that baseline may a new summary emit
        # subtree handles), and epochs captured per in-flight upload.
        self._acked_epochs: Dict[str, int] = {}
        self._upload_epochs: Dict[str, Dict[str, int]] = {}
        self.datastores: Dict[str, DataStoreRuntime] = {}
        self.pending = PendingStateManager()
        self.attached = submit_fn is not None
        self.connected = submit_fn is not None
        # client id (string) -> ordinal (join seq) interning; consistent
        # across replicas because join ops are totally ordered.
        self._ordinals: Dict[str, int] = {}
        self.client_id: Optional[str] = None  # our wire client id
        self.client_ordinal: int = -1
        self.sequence_number = 0
        self.minimum_sequence_number = 0
        self._batch: Optional[List] = None
        self.blob_manager = BlobManager()
        # Datastores created as GC roots (aliased/default stores); non-root
        # stores stay alive only while a handle route reaches them.
        self._gc_roots: List[str] = []

    # -- wiring ------------------------------------------------------------
    def attach(self, submit_fn: Callable[[str, Any], int]) -> None:
        """Attach to a delta stream. `connected` stays False until our own
        join op is sequenced — edits made before that are recorded as channel
        pendings and resubmitted at connect, carrying the real ordinal (a
        pre-join submit must never ship ordinal-derived identity)."""
        self._submit_fn = submit_fn
        self.attached = True
        for store in self.datastores.values():
            store.connect()

    def set_local_client(self, client_id: str) -> None:
        self.client_id = client_id

    def set_connected(self, connected: bool, client_id: Optional[str] = None
                      ) -> None:
        """Connection state change (reference setConnectionState). On
        reconnect: drop in-flight records and resubmit regenerated ops."""
        if client_id is not None:
            self.client_id = client_id
        was = self.connected
        self.connected = connected
        if not connected:
            self.signals_live = False
        if connected and not was:
            self._resubmit_all()
        elif was and not connected:
            # In-flight ops may still be sequenced under the old client id;
            # remember it so process() can recognize them as ours.
            self.pending.on_connection_change(self.client_id)
        self.emit("connected" if connected else "disconnected")

    # -- datastores --------------------------------------------------------
    def create_datastore(self, store_id: str,
                         root: bool = True) -> DataStoreRuntime:
        """root=True pins the store as a GC root (the reference's
        root/aliased data stores); root=False stores survive only while
        some channel value holds a handle to them."""
        if store_id in self.datastores:
            raise ValueError(f"duplicate datastore id {store_id!r}")
        store = DataStoreRuntime(store_id, self, self.registry)
        self.datastores[store_id] = store
        if root:
            self._gc_roots.append(f"/{store_id}")
        if self.attached:
            # Live creation: replicate the (empty) store; its channels each
            # ship their own attach op as they are created.
            info = {"id": store_id, "root": root}
            self._pending_store_attach[store_id] = info
            if self.connected:
                self._send({"attachStore": info})
        return store

    def get_datastore(self, store_id: str) -> DataStoreRuntime:
        return self.datastores[store_id]

    # -- submission --------------------------------------------------------
    def submit_datastore_op(self, store_id: str, envelope: dict) -> None:
        if self.read_only:
            raise PermissionError(
                "read-only container: local edits cannot be submitted "
                "(and would permanently shadow remote state if applied)")
        if not (self.attached and self.connected):
            return
        contents = {"address": store_id, "contents": envelope}
        if self._batch is not None:
            self._batch.append(contents)
            return
        self._send(contents)

    # -- signals (transient, unsequenced) ----------------------------------
    def submit_signal(self, signal_type: str, content: Any,
                      address: Optional[str] = None) -> None:
        """Broadcast a transient runtime signal (reference
        containerRuntime.submitSignal). `address` targets a datastore's
        signal listeners; None stays at container-runtime scope. Dropped
        silently while disconnected — signals carry no delivery guarantee."""
        if self._submit_signal_fn is None or \
                not (self.connected or self.signals_live):
            return
        try:
            self._submit_signal_fn({"address": address, "type": signal_type,
                                    "content": content})
        except (ConnectionError, OSError):
            # The socket died before the disconnect event landed: honor the
            # no-delivery-guarantee contract (drop, don't raise into app
            # code); the connection's own teardown drives reconnect.
            pass

    def process_signal(self, signal, local: bool) -> None:
        """Route an inbound SignalMessage (reference processSignal): an
        addressed envelope goes to the datastore; unaddressed signals emit
        at runtime scope as ("signal", type, content, local, client_id)."""
        envelope = signal.content
        if not isinstance(envelope, dict):
            return  # malformed/foreign signal: ignore, never crash the pump
        address = envelope.get("address")
        if address is not None:
            store = self.datastores.get(address)
            if store is not None:
                store.process_signal(envelope, local, signal.client_id)
            return
        self.emit("signal", envelope.get("type"), envelope.get("content"),
                  local, signal.client_id)

    def order_sequentially(self, callback: Callable[[], None]) -> None:
        """Batch ops submitted inside callback into one turn (reference
        orderSequentially/batching, containerRuntime.ts:1506)."""
        if self._batch is not None:
            callback()
            return
        self._batch = []
        try:
            callback()
            batch = self._batch
        finally:
            self._batch = None
        if len(batch) > 1 and self._submit_batch_fn is not None and \
                not any(len(json.dumps(c)) > self.max_op_size
                        for c in batch):
            # One wire submission -> one boxcar -> the sequencer tickets
            # the whole batch atomically (contiguous seqs, batch-marked).
            # Oversized members fall back to per-op sends (chunked ops
            # cannot ride a batch).
            self._submit_batch_fn(
                [(MessageType.OPERATION, c) for c in batch],
                before_send=lambda csn, c: self.pending.on_submit(csn, c))
            return
        for contents in batch:
            self._send(contents)

    def _send(self, contents) -> None:
        serialized = json.dumps(contents)
        if len(serialized) > self.max_op_size:
            self._send_chunked(serialized)
            return
        # Record pending BEFORE the wire push: over an in-process service
        # the sequenced ack can arrive synchronously inside the send.
        self._submit_fn(
            MessageType.OPERATION, contents,
            before_send=lambda csn: self.pending.on_submit(csn, contents))

    # Per-chunk envelope + framing headroom: each CHUNKED_OP message
    # (payload + chunkId/totalChunks + message fields) must itself fit
    # under the service's op-size limit.
    CHUNK_ENVELOPE_HEADROOM = 512

    def _send_chunked(self, serialized: str) -> None:
        """Split one oversized op into CHUNKED_OP messages; receivers
        reassemble per client and apply on the final chunk."""
        size = max(1, self.max_op_size - self.CHUNK_ENVELOPE_HEADROOM)
        pieces = [serialized[i:i + size]
                  for i in range(0, len(serialized), size)]
        total = len(pieces)
        for index, piece in enumerate(pieces, start=1):
            chunk = {"chunkId": index, "totalChunks": total,
                     "contents": piece}
            self._submit_fn(
                MessageType.CHUNKED_OP, chunk,
                before_send=lambda csn, c=chunk: self.pending.on_submit(csn, c))

    def _resubmit_all(self) -> None:
        self.pending.drain()
        for info in list(self._pending_store_attach.values()):
            self._send({"attachStore": info})

        def replay() -> None:
            for store_id, store in self.datastores.items():
                for envelope in store.resubmit_pending():
                    self.submit_datastore_op(store_id, envelope)
        # Channels regenerate pending ops without their original batch
        # grouping, so resubmit the WHOLE replay as one batch: at least as
        # atomic as the original groups (no foreign op interleaves, no
        # receiver yields mid-replay).
        self.order_sequentially(replay)

    # -- inbound -----------------------------------------------------------
    def process(self, message: SequencedDocumentMessage) -> None:
        """Apply one sequenced message (containerRuntime.ts:1002)."""
        self.sequence_number = message.sequence_number
        self.minimum_sequence_number = message.minimum_sequence_number
        mtype = message.type
        if mtype == MessageType.CLIENT_JOIN:
            data = message.data
            detail = json.loads(data) if isinstance(data, str) else \
                (message.contents or {})
            joined = detail.get("clientId")
            self._ordinals[joined] = message.sequence_number
            if joined == self.client_id:
                self.client_ordinal = message.sequence_number
                self._on_self_join()
            return
        if mtype == MessageType.CLIENT_LEAVE:
            data = message.data
            detail = json.loads(data) if isinstance(data, str) else \
                (message.contents or {})
            left = detail if isinstance(detail, str) else detail.get("clientId")
            self._chunk_buffers.pop(left, None)  # abandon partial chunks
            ordinal = self._ordinals.pop(left, None)
            if ordinal is not None:
                # Crash-safe lease release etc. (ConsensusQueue.client_left).
                for store in self.datastores.values():
                    for channel in store.channels.values():
                        hook = getattr(channel, "client_left", None)
                        if hook:
                            hook(ordinal)
            return
        if mtype not in (MessageType.OPERATION, MessageType.CHUNKED_OP):
            return
        local = (message.client_id == self.client_id
                 and self.client_id is not None)
        if local:
            self.pending.on_local_ack(message.client_sequence_number)
        elif message.client_id is not None:
            # An op of ours sequenced under a previous connection's id:
            # ack it instead of double-applying (remote now + resubmit later).
            if self.pending.try_prior_ack(
                    message.client_id, message.client_sequence_number):
                local = True
        contents = message.contents
        if mtype == MessageType.CHUNKED_OP:
            # Reassemble per sending client; only the final chunk applies
            # (reference processRemoteChunkedMessage).
            buf = self._chunk_buffers.setdefault(message.client_id, [])
            buf.append(contents["contents"])
            if contents["chunkId"] < contents["totalChunks"]:
                return
            del self._chunk_buffers[message.client_id]
            contents = json.loads("".join(buf))
        if "attachStore" in contents:
            info = contents["attachStore"]
            if local:
                self._pending_store_attach.pop(info["id"], None)
            elif info["id"] not in self.datastores:
                store = DataStoreRuntime(info["id"], self, self.registry)
                self.datastores[info["id"]] = store
                if info.get("root"):
                    self._gc_roots.append(f"/{info['id']}")
            return
        store = self.datastores[contents["address"]]
        ordinal = self._ordinals.get(message.client_id, -1)
        store.process(contents["contents"], local, message.sequence_number,
                      message.reference_sequence_number, ordinal,
                      message.minimum_sequence_number)
        self.emit("op", message, local)

    # -- device bulk catch-up routing (mergetree/catchup.py) ---------------
    def bulk_route(self, store_id, channel_id, client_id):
        """(store, channel) key when this message can ride a device bulk
        run: the channel exists, supports bulk apply, and the sender's
        quorum ordinal is known (merge-tree perspectives are ordinals)."""
        store = self.datastores.get(store_id)
        if store is None:
            return None
        channel = store.channels.get(channel_id)
        if channel is None or not hasattr(channel, "process_bulk_core"):
            return None
        if self._ordinals.get(client_id, -1) < 0:
            return None
        return (store_id, channel_id)

    def process_channel_bulk(self, messages) -> None:
        """Apply a run of remote OPERATION messages for one channel in one
        device pass. Raises mergetree.catchup.Unmodelable or ValueError
        (channel state untouched) to request the scalar fallback; a
        kernel's refusal, build or launch failure is a RuntimeError and
        propagates."""
        first = messages[0].contents
        store = self.datastores[first["address"]]
        channel = store.channels[first["contents"]["address"]]
        batch = []
        for m in messages:
            batch.append((m.contents["contents"]["contents"],
                          m.sequence_number, m.reference_sequence_number,
                          self._ordinals[m.client_id],
                          m.minimum_sequence_number))
        channel.process_bulk_core(batch)
        # The bulk path bypasses SharedObject.process, which is where
        # change_epoch normally bumps — an incremental summary after
        # catch-up must NOT emit a handle for this channel (that would
        # durably persist the pre-catch-up content).
        channel.change_epoch += 1

    def _on_self_join(self) -> None:
        """Adopt our quorum-assigned ordinal in every channel's perspective
        math (merge-tree clients track ints, not wire ids), then go
        connected — which resubmits any pre-join pendings."""
        for store in self.datastores.values():
            for channel in store.channels.values():
                adopt = getattr(channel, "adopt_client_ordinal", None)
                if adopt:
                    adopt(self.client_ordinal)
        self.set_connected(True)

    # -- summary / load ----------------------------------------------------
    def all_channel_epochs(self) -> Dict[str, int]:
        epochs: Dict[str, int] = {}
        for store in self.datastores.values():
            epochs.update(store.channel_epochs())
        return epochs

    def record_upload(self, handle: str,
                      epochs: Optional[Dict[str, int]] = None) -> None:
        """Remember the epochs a just-uploaded summary serialized; they
        become the acked baseline if/when that summary is acked. Callers
        pass epochs captured BEFORE assembly: an op applied mid-upload
        bumps past the captured value, so that channel re-uploads next
        time (the safe direction) instead of being wrongly marked
        durable."""
        self._upload_epochs[handle] = (
            epochs if epochs is not None else self.all_channel_epochs())

    def on_summary_ack(self, handle: Optional[str]) -> None:
        if handle in self._upload_epochs:
            self._acked_epochs = self._upload_epochs.pop(handle)
            self._upload_epochs.clear()  # older proposals are dead
        else:
            # ANOTHER client's summary became the parent: our epoch
            # baseline does not describe its tree, so the next summary
            # must be full — emitting handles against epochs we never
            # uploaded could alias stale content.
            self._acked_epochs = {}
            self._upload_epochs.clear()

    def baseline_epochs(self) -> None:
        """The current state IS durable (attach upload or fresh load):
        everything may summarize incrementally until it changes."""
        self._acked_epochs = self.all_channel_epochs()

    def summarize(self, incremental: bool = False) -> SummaryTree:
        from ..protocol.summary import SummaryHandle
        gc = self.run_gc()
        tree = SummaryTree()
        stores = tree.add_tree(".dataStores")
        for store_id, store in sorted(self.datastores.items()):
            eps = store.channel_epochs()
            acked_keys = {k for k in self._acked_epochs
                          if k.startswith(f"{store_id}/")}
            if incremental and eps and set(eps) == acked_keys and all(
                    self._acked_epochs.get(k) == v for k, v in eps.items()):
                # Whole datastore unchanged since the acked baseline: ONE
                # handle for its entire subtree (containerRuntime.ts
                # trackState at datastore granularity).
                stores.entries[store_id] = SummaryHandle("/")
            else:
                stores.entries[store_id] = store.summarize(
                    incremental=incremental,
                    acked_epochs=self._acked_epochs)
        if len(self.blob_manager):
            tree.entries[".blobs"] = self.blob_manager.summarize()
        tree.add_blob(".metadata", json.dumps({
            "sequenceNumber": self.sequence_number,
            "ordinals": self._ordinals,
            "gcRoots": self._gc_roots,
            # Mark pass result rides the summary (reference: GC runs inside
            # summarize and stamps unreferenced nodes, garbageCollector.ts).
            "unreferenced": gc.unreferenced,
        }))
        return tree

    def load(self, tree: SummaryTree) -> None:
        meta = json.loads(tree.entries[".metadata"].content)
        self.sequence_number = meta.get("sequenceNumber", 0)
        self._ordinals = {k: int(v) for k, v in
                          meta.get("ordinals", {}).items()}
        self._gc_roots = list(meta.get("gcRoots", []))
        for store_id, sub in tree.entries[".dataStores"].entries.items():
            store = DataStoreRuntime(store_id, self, self.registry)
            self.datastores[store_id] = store
            store.load(sub)
        if ".blobs" in tree.entries:
            self.blob_manager.load(tree.entries[".blobs"])

    # -- GC ----------------------------------------------------------------
    def get_gc_data(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for store in self.datastores.values():
            out.update(store.get_gc_data())
        for blob_id in self.blob_manager.node_ids():
            out[blob_id] = []  # blobs are leaves
        return out

    def run_gc(self) -> GCResult:
        return run_garbage_collection(self.get_gc_data(), self._gc_roots)
