"""SharedObject: the base class every DDS extends (a port of
fluidframework_tpu's dds/shared_object.py).

Capability parity with reference
packages/dds/shared-object-base/src/sharedObject.ts:28 — attach lifecycle,
summarize, op submit/process plumbing, GC data, handles — collapsed to the
surface a TPU-backed runtime needs. The channel boundary (IChannelFactory,
datastore-definitions/src/channel.ts:134) is preserved in *shape* so DDS
consumers are unchanged per the north star (BASELINE.json).

A channel runs on its data store's device (`SharedObject.device`): the
loader's, handed down Loader -> Container -> ContainerRuntime ->
DataStoreRuntime. Only a sequence's bulk catch-up uses it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, TYPE_CHECKING

import torch

from ..core.device import resolve_device
from ..core.events import TypedEventEmitter
from ..protocol.summary import SummaryTree

if TYPE_CHECKING:
    from ..runtime.datastore_runtime import DataStoreRuntime


class FluidHandle:
    """An addressable reference to a shared object (reference FluidHandle).

    Serialized as {"type": "__fluid_handle__", "url": absolute_path}; the
    GC reference graph is built from handles encountered in summaries.
    """

    MARKER = "__fluid_handle__"

    def __init__(self, absolute_path: str, target: Any = None):
        self.absolute_path = absolute_path
        self._target = target

    def get(self) -> Any:
        return self._target

    def encode(self) -> dict:
        return {"type": self.MARKER, "url": self.absolute_path}

    @staticmethod
    def is_handle(value: Any) -> bool:
        return isinstance(value, dict) and value.get("type") == FluidHandle.MARKER


class SharedObject(TypedEventEmitter):
    """Base DDS. Subclasses implement process_core / summarize_core /
    load_core / resubmit_pending (+ their public mutation API).

    Lifecycle: created detached -> bind_to_runtime -> (container attach)
    connected. While detached, submits are dropped; state only ships via the
    attach summary (reference sharedObject.ts:156 load, :195 connect).
    """

    # Subclasses set: TYPE (channel factory type name).
    TYPE = "https://graph.microsoft.com/types/base"

    def __init__(self, object_id: str, runtime: Optional["DataStoreRuntime"] = None):
        super().__init__()
        self.id = object_id
        self.runtime = runtime
        self.attached = False
        self._handle: Optional[FluidHandle] = None
        # Bumped on every state change; incremental summaries emit a handle
        # to the previous summary's subtree when the epoch matches the last
        # ACKED summary (reference SummaryTracker / ISummarizeInternal
        # trackState, sharedObject.ts:210).
        self.change_epoch = 0

    # -- identity ----------------------------------------------------------
    @property
    def handle(self) -> FluidHandle:
        if self._handle is None:
            path = self.id
            if self.runtime is not None:
                path = f"/{self.runtime.id}/{self.id}"
            self._handle = FluidHandle(path, self)
        return self._handle

    @property
    def local_client_id(self) -> int:
        return self.runtime.client_ordinal if self.runtime else -1

    @property
    def device(self) -> torch.device:
        """The device of the data store this channel is bound to; while
        unbound, the port's default (core.device.resolve_device)."""
        if self.runtime is not None:
            return self.runtime.device
        return resolve_device(None)

    # -- lifecycle ---------------------------------------------------------
    def bind_to_runtime(self, runtime: "DataStoreRuntime") -> None:
        self.runtime = runtime
        runtime.bind_channel(self)

    def connect(self) -> None:
        self.attached = True

    # -- op plumbing -------------------------------------------------------
    def submit_local_message(self, contents: Any) -> None:
        """Send a channel op into the runtime (no-op while detached —
        detached state ships via the attach summary instead)."""
        self.change_epoch += 1
        if self.attached and self.runtime is not None:
            self.runtime.submit_channel_op(self.id, contents)

    def process(self, contents: Any, local: bool, seq: int, ref_seq: int,
                client_ordinal: int, min_seq: int) -> None:
        self.change_epoch += 1  # any sequenced op dirties the channel
        self.process_core(contents, local, seq, ref_seq, client_ordinal,
                          min_seq)

    # -- overridables ------------------------------------------------------
    def process_core(self, contents: Any, local: bool, seq: int, ref_seq: int,
                     client_ordinal: int, min_seq: int) -> None:
        raise NotImplementedError

    def summarize_core(self) -> SummaryTree:
        raise NotImplementedError

    def load_core(self, tree: SummaryTree) -> None:
        raise NotImplementedError

    def resubmit_pending(self) -> List[Any]:
        """Return the channel op contents to resubmit after reconnect, in
        order; replaces every previously in-flight op of this channel
        (reference reSubmitCore, sharedObject.ts:376)."""
        return []

    def get_gc_data(self) -> List[str]:
        """Outbound routes (handle paths) referenced by this object
        (reference getGCData, sharedObject.ts:244)."""
        return []

    # -- summary helpers ---------------------------------------------------
    def summarize(self) -> SummaryTree:
        tree = self.summarize_core()
        tree.add_blob(".attributes", _attributes_blob(self.TYPE))
        return tree


def _attributes_blob(type_name: str) -> str:
    import json
    return json.dumps({"type": type_name, "snapshotFormatVersion": "0.1"})


def collect_handles(value: Any, out: List[str]) -> None:
    """Recursively gather handle routes from a value (the SummarySerializer
    role: handle-tracking serialization). Matches both live FluidHandle
    objects (as stored by local set()) and their serialized dict form (as
    loaded from a summary)."""
    if isinstance(value, FluidHandle):
        out.append(value.absolute_path)
    elif FluidHandle.is_handle(value):
        out.append(value["url"])
    elif isinstance(value, dict):
        for v in value.values():
            collect_handles(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            collect_handles(v, out)


def encode_handles(value: Any) -> Any:
    """Serialize live FluidHandle objects into their wire dict form. Op
    contents must be plain data: they cross process boundaries (pickled by
    the native broker, deep-copied by copier's raw-op persistence)."""
    if isinstance(value, FluidHandle):
        return value.encode()
    if isinstance(value, dict):
        return {k: encode_handles(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode_handles(v) for v in value]
    return value


def decode_handles(value: Any) -> Any:
    """Rehydrate serialized handle dicts into FluidHandle objects after a
    summary load (inverse of the encode in each DDS's to_blob)."""
    if FluidHandle.is_handle(value):
        return FluidHandle(value["url"])
    if isinstance(value, dict):
        return {k: decode_handles(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_handles(v) for v in value]
    return value
