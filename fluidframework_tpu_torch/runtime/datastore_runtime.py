"""DataStoreRuntime: per-data-store channel registry + op routing (a port
of fluidframework_tpu's runtime/datastore_runtime.py).

Capability parity with reference packages/runtime/datastore/src/
dataStoreRuntime.ts:89 (createChannel :340, bindChannel :375, process :472,
submitMessage :698): owns the DDS channels of one data store, routes channel
ops by address, aggregates summaries, and fans reconnect resubmission out to
channels. Its channels run on its container runtime's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, TYPE_CHECKING

from ..core.events import TypedEventEmitter
from ..dds.shared_object import SharedObject
from ..protocol.summary import SummaryTree

if TYPE_CHECKING:
    from .container_runtime import ContainerRuntime


class ChannelRegistry:
    """IChannelFactory registry (reference datastore-definitions channel.ts:134):
    maps DDS type names to constructors."""

    def __init__(self):
        self._factories: Dict[str, Any] = {}

    def register(self, cls) -> None:
        self._factories[cls.TYPE] = cls

    def create(self, type_name: str, object_id: str) -> SharedObject:
        if type_name not in self._factories:
            raise KeyError(f"no channel factory for {type_name!r}")
        return self._factories[type_name](object_id)

    def types(self) -> List[str]:
        return list(self._factories)


def default_registry() -> ChannelRegistry:
    from ..dds.map import SharedMap
    from ..dds.sequence import (SharedString, SharedSegmentSequence,
                                SharedNumberSequence, SharedObjectSequence)
    from ..dds.counter import SharedCounter
    from ..dds.cell import SharedCell
    from ..dds.directory import SharedDirectory
    from ..dds.register_collection import ConsensusRegisterCollection
    from ..dds.ordered_collection import ConsensusQueue
    from ..dds.matrix import SharedMatrix
    from ..dds.ink import Ink
    from ..dds.summary_block import SharedSummaryBlock
    from ..dds.sparse_matrix import SparseMatrix
    reg = ChannelRegistry()
    for cls in (SharedMap, SharedString, SharedSegmentSequence, SharedCounter,
                SharedCell, SharedDirectory, ConsensusRegisterCollection,
                ConsensusQueue, SharedMatrix, Ink, SharedSummaryBlock,
                SparseMatrix, SharedNumberSequence, SharedObjectSequence):
        reg.register(cls)
    return reg


class DataStoreRuntime(TypedEventEmitter):
    def __init__(self, store_id: str, container: "ContainerRuntime",
                 registry: Optional[ChannelRegistry] = None):
        super().__init__()
        self.id = store_id
        self.container = container
        self.registry = registry or default_registry()
        self.channels: Dict[str, SharedObject] = {}
        # Channels created while live whose attach op is unacked; maps id ->
        # the attach summary captured AT CREATION (resubmits reuse it — a
        # re-captured summary would double-count data ops that are also
        # resubmitted as pendings). Reference: LocalChannelContext attach.
        self._pending_attach: Dict[str, dict] = {}

    @property
    def client_ordinal(self) -> int:
        return self.container.client_ordinal

    @property
    def device(self):
        """The container runtime's device, which this store's channels
        run on."""
        return self.container.device

    @property
    def attached(self) -> bool:
        return self.container.attached

    @property
    def audience(self):
        """The container's connected-client roster (reference
        IFluidDataStoreRuntime.getAudience()); None when unattached."""
        return self.container.audience

    # -- channels ----------------------------------------------------------
    def create_channel(self, object_id: str, type_name: str) -> SharedObject:
        channel = self.registry.create(type_name, object_id)
        channel.bind_to_runtime(self)
        if self.attached:
            channel.connect()
            # Live creation: ship an attach op so remote replicas build a
            # remote channel context (reference dataStoreRuntime.ts:340
            # createChannel -> bindChannel attach path).
            from ..protocol.summary import summary_tree_to_dict
            attach = {"id": object_id, "type": type_name,
                      "summary": summary_tree_to_dict(channel.summarize())}
            self._pending_attach[object_id] = attach
            self.container.submit_datastore_op(self.id, {"attach": attach})
        return channel

    def bind_channel(self, channel: SharedObject) -> None:
        if channel.id in self.channels:
            raise ValueError(f"duplicate channel id {channel.id!r}")
        self.channels[channel.id] = channel
        channel.runtime = self

    def get_channel(self, object_id: str) -> SharedObject:
        return self.channels[object_id]

    # -- op plumbing -------------------------------------------------------
    def submit_channel_op(self, channel_id: str, contents: Any) -> None:
        self.container.submit_datastore_op(
            self.id, {"address": channel_id, "contents": contents})

    # -- signals (reference dataStoreRuntime submitSignal/processSignal) ---
    def submit_signal(self, signal_type: str, content: Any) -> None:
        """Broadcast a transient signal scoped to this datastore; peers
        receive it as a ("signal", type, content, local, client_id) event
        on their DataStoreRuntime instance."""
        self.container.submit_signal(signal_type, content, address=self.id)

    def process_signal(self, envelope: dict, local: bool,
                       client_id) -> None:
        self.emit("signal", envelope.get("type"), envelope.get("content"),
                  local, client_id)

    def process(self, envelope: dict, local: bool, seq: int, ref_seq: int,
                client_ordinal: int, min_seq: int) -> None:
        if "attach" in envelope:
            self._process_attach(envelope["attach"], local)
            return
        channel = self.channels[envelope["address"]]
        channel.process(envelope["contents"], local, seq, ref_seq,
                        client_ordinal, min_seq)

    def _process_attach(self, info: dict, local: bool) -> None:
        """Build a remote channel context from a live attach op (reference
        remoteChannelContext.ts:34). Duplicate ids (concurrent same-id
        creation) keep the first; later data ops still converge because both
        replicas apply the same sequenced stream."""
        if local:
            self._pending_attach.pop(info["id"], None)
            return
        if info["id"] in self.channels:
            return
        from ..protocol.summary import summary_tree_from_dict
        channel = self.registry.create(info["type"], info["id"])
        channel.runtime = self
        self.channels[info["id"]] = channel
        channel.load_core(summary_tree_from_dict(info["summary"]))
        adopt = getattr(channel, "adopt_client_ordinal", None)
        if adopt:
            adopt(self.client_ordinal)
        channel.connect()

    def resubmit_pending(self) -> List[dict]:
        # Unacked attach ops go first: the channels' data ops land on
        # replicas that must already have the channel.
        ops: List[dict] = [{"attach": attach}
                           for attach in self._pending_attach.values()]
        for channel_id, channel in self.channels.items():
            for contents in channel.resubmit_pending():
                ops.append({"address": channel_id, "contents": contents})
        return ops

    # -- attach / summary --------------------------------------------------
    def connect(self) -> None:
        for channel in self.channels.values():
            channel.connect()

    def summarize(self, incremental: bool = False,
                  acked_epochs: Optional[Dict[str, int]] = None
                  ) -> SummaryTree:
        """incremental=True: channels unchanged since the last ACKED summary
        serialize as a handle to the previous summary's same-position
        subtree (reference trackState/SummaryTracker; the storage layer
        resolves handles against the parent commit)."""
        from ..protocol.summary import SummaryHandle
        acked_epochs = acked_epochs or {}
        tree = SummaryTree()
        channels = tree.add_tree(".channels")
        for channel_id, channel in sorted(self.channels.items()):
            key = f"{self.id}/{channel_id}"
            if incremental and acked_epochs.get(key) == channel.change_epoch:
                channels.entries[channel_id] = SummaryHandle("/")
            else:
                channels.entries[channel_id] = channel.summarize()
        return tree

    def channel_epochs(self) -> Dict[str, int]:
        return {f"{self.id}/{cid}": ch.change_epoch
                for cid, ch in self.channels.items()}

    def load(self, tree: SummaryTree) -> None:
        import json
        channels = tree.entries[".channels"]
        for channel_id, sub in channels.entries.items():
            attrs = json.loads(sub.entries[".attributes"].content)
            channel = self.registry.create(attrs["type"], channel_id)
            channel.runtime = self
            self.channels[channel_id] = channel
            channel.load_core(sub)
            if self.attached:
                channel.connect()

    def get_gc_data(self) -> Dict[str, List[str]]:
        return {f"/{self.id}/{cid}": ch.get_gc_data()
                for cid, ch in self.channels.items()}
