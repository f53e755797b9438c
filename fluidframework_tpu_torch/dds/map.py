"""SharedMap: last-write-wins key-value DDS with pending-local shadowing.

Capability parity with reference packages/dds/map/src/{map.ts:103,
mapKernel.ts:139}: set/delete/clear ops; a remote op for a key with pending
local writes is ignored (the local value shadows it until ack,
mapKernel.ts:160,619); acks pair by pending message id. Values round-trip
through the handle-aware serializer (handles stay addressable for GC).

The per-key state machine is intentionally tiny host-side code — the TPU
analog (batched LWW across thousands of maps) rides the same sequenced op
stream and is exercised by the server-side summarizer, not this class.

A port of fluidframework_tpu's dds/map.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..protocol.summary import SummaryTree
from .shared_object import (
    SharedObject,
    collect_handles,
    decode_handles,
    encode_handles,
)


def wait_for(emitter, event: str, check, timeout: Optional[float]):
    """Shared wait machinery for SharedMap.wait / SubDirectory.wait:
    `check()` returns (present, value). Check, subscribe, RE-check (the
    value may land on a reader thread between the first check and the
    listener registration), then block on a Deferred the listener
    resolves; the listener is always removed afterwards."""
    from ..core.events import Deferred
    present, value = check()
    if present:
        return value
    deferred = Deferred()

    def on_event(*args):
        p, v = check()
        if p:
            deferred.resolve(v)
    listener = emitter.on(event, on_event)
    try:
        present, value = check()
        if present:
            return value
        return deferred.result(timeout)
    finally:
        emitter.off(event, listener)


class _Missing:
    """Sentinel for 'key absent' in valueChanged previous-value payloads
    (distinguishes delete-on-undo from set-None-on-undo)."""

    def __repr__(self):
        return "<missing>"


MISSING = _Missing()


class MapKernel:
    """Op/state kernel shared by SharedMap and each Directory subdirectory.

    valueChanged events carry (key, local, previous) where previous is the
    pre-op value or MISSING — the undo-redo handlers revert from it."""

    def __init__(self, emit=None):
        self.data: Dict[str, Any] = {}
        # key -> list of pending local message ids (newest last)
        self.pending_keys: Dict[str, List[int]] = {}
        self.pending_clear_count = 0
        self.next_pending_id = 0
        self.emit = emit or (lambda *a: None)

    # -- local ops (return op contents + record pending) -------------------
    def set(self, key: str, value: Any) -> dict:
        previous = self.data.get(key, MISSING)
        self.data[key] = value
        pid = self._track(key)
        self.emit("valueChanged", key, True, previous)
        return {"type": "set", "key": key, "value": encode_handles(value),
                "pid": pid}

    def delete(self, key: str) -> Optional[dict]:
        existed = key in self.data
        previous = self.data.get(key, MISSING)
        self.data.pop(key, None)
        pid = self._track(key)
        if existed:
            self.emit("valueChanged", key, True, previous)
        return {"type": "delete", "key": key, "pid": pid}

    def clear(self) -> dict:
        self.data.clear()
        self.pending_clear_count += 1
        self.next_pending_id += 1
        self.emit("clear", True)
        return {"type": "clear", "pid": self.next_pending_id}

    def _track(self, key: str) -> int:
        self.next_pending_id += 1
        self.pending_keys.setdefault(key, []).append(self.next_pending_id)
        return self.next_pending_id

    # -- sequenced processing ---------------------------------------------
    def process(self, op: dict, local: bool) -> None:
        t = op["type"]
        if local:
            # Ack: retire the pending record; state already applied.
            if t == "clear":
                if self.pending_clear_count > 0:
                    self.pending_clear_count -= 1
                    return
            else:
                pending = self.pending_keys.get(op["key"])
                if pending and op.get("pid") in pending:
                    pending.remove(op["pid"])
                    if not pending:
                        del self.pending_keys[op["key"]]
                    return
            # No pending record: the optimistic local state was destroyed
            # out from under this op (the containing subdirectory was
            # deleted and recreated while it was in flight). Every other
            # replica applies the sequenced op — fall through and apply it
            # here too, or the submitter permanently diverges.
            local = False
        if t == "clear":
            # Remote clear wipes acked state; pending local keys survive
            # (their values re-assert on ack; mapKernel clear semantics).
            survivors = {k: self.data[k] for k in self.pending_keys
                         if k in self.data}
            self.data = survivors
            self.emit("clear", False)
            return
        key = op["key"]
        if key in self.pending_keys or self.pending_clear_count > 0:
            return  # shadowed by pending local write / pending local clear
        if t == "set":
            previous = self.data.get(key, MISSING)
            self.data[key] = decode_handles(op["value"])
            self.emit("valueChanged", key, False, previous)
        elif t == "delete":
            if key in self.data:
                previous = self.data[key]
                del self.data[key]
                self.emit("valueChanged", key, False, previous)

    # -- resubmit (reconnect) ---------------------------------------------
    def pending_ops(self) -> List[dict]:
        ops: List[dict] = []
        for _ in range(self.pending_clear_count):
            ops.append({"type": "clear", "pid": 0})
        for key, pids in self.pending_keys.items():
            for pid in pids:
                if key in self.data:
                    ops.append({"type": "set", "key": key,
                                "value": encode_handles(self.data[key]),
                                "pid": pid})
                else:
                    ops.append({"type": "delete", "key": key, "pid": pid})
        return ops

    # -- snapshot ----------------------------------------------------------
    def to_blob(self) -> str:
        return json.dumps(self.data, sort_keys=True, default=_encode_value)

    def load_blob(self, blob: str) -> None:
        from .shared_object import decode_handles
        self.data = decode_handles(json.loads(blob))


def _encode_value(value: Any):
    from .shared_object import FluidHandle
    if isinstance(value, FluidHandle):
        return value.encode()
    raise TypeError(f"not serializable: {type(value)!r}")


class SharedMap(SharedObject):
    """Reference map/src/map.ts:103 API surface."""

    TYPE = "https://graph.microsoft.com/types/map"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.kernel = MapKernel(self._emit_kernel)

    def _emit_kernel(self, event: str, *args) -> None:
        self.emit(event, *args)

    # -- public API --------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self.kernel.data.get(key, default)

    def set(self, key: str, value: Any) -> "SharedMap":
        self.submit_local_message(self.kernel.set(key, value))
        return self

    def delete(self, key: str) -> None:
        self.submit_local_message(self.kernel.delete(key))

    def clear(self) -> None:
        self.submit_local_message(self.kernel.clear())

    def has(self, key: str) -> bool:
        return key in self.kernel.data

    def wait(self, key: str, timeout: Optional[float] = None) -> Any:
        """Block until `key` exists and return its value (reference
        ISharedMap.wait, map.ts). Returns immediately if present. Over
        in-process drivers a peer's set lands synchronously, so by the time
        the peer's call returns this resolves without blocking; over
        network drivers the resolver runs on the reader thread."""
        return wait_for(
            self, "valueChanged",
            lambda: (key in self.kernel.data, self.kernel.data.get(key)),
            timeout)

    def keys(self) -> Iterator[str]:
        return iter(list(self.kernel.data.keys()))

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(list(self.kernel.data.items()))

    def entries(self) -> Iterator[Tuple[str, Any]]:
        """Alias of items() (reference map.ts:173 entries)."""
        return self.items()

    def values(self) -> Iterator[Any]:
        return iter(list(self.kernel.data.values()))

    def for_each(self, fn) -> None:
        """fn(value, key, map) per entry (reference map.ts:202 forEach)."""
        for k, v in list(self.kernel.data.items()):
            fn(v, k, self)

    @property
    def size(self) -> int:
        return len(self.kernel.data)

    def __len__(self) -> int:
        return len(self.kernel.data)

    # -- channel plumbing --------------------------------------------------
    def connect(self) -> None:
        if not self.attached:
            # Detached edits ship via the attach summary; forget pendings.
            self.kernel.pending_keys.clear()
            self.kernel.pending_clear_count = 0
        super().connect()

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        self.kernel.process(contents, local)

    def resubmit_pending(self) -> List[Any]:
        return self.kernel.pending_ops()

    def summarize_core(self) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", self.kernel.to_blob())
        return tree

    def load_core(self, tree: SummaryTree) -> None:
        self.kernel.load_blob(tree.entries["header"].content)

    def get_gc_data(self) -> List[str]:
        routes: List[str] = []
        collect_handles(self.kernel.data, routes)
        return routes
