"""SharedCell: a single LWW value (reference packages/dds/cell/src/cell.ts).

Same pending-local-shadow discipline as the map kernel, for one slot.

A port of fluidframework_tpu's dds/cell.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
from typing import Any, List

from ..protocol.summary import SummaryTree
from .shared_object import SharedObject, collect_handles


class SharedCell(SharedObject):
    TYPE = "https://graph.microsoft.com/types/cell"

    _EMPTY = object()

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.value: Any = None
        self._has_value = False
        self._pending_count = 0

    def get(self) -> Any:
        return self.value

    def set(self, value: Any) -> None:
        self.value = value
        self._has_value = True
        self._pending_count += 1
        self.emit("valueChanged", value, True)
        from .shared_object import encode_handles
        self.submit_local_message({"type": "setCell",
                                   "value": encode_handles(value)})

    def delete(self) -> None:
        self.value = None
        self._has_value = False
        self._pending_count += 1
        self.emit("delete", True)
        self.submit_local_message({"type": "deleteCell"})

    def empty(self) -> bool:
        return not self._has_value

    def connect(self) -> None:
        if not self.attached:
            self._pending_count = 0
        super().connect()

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        if local:
            if self._pending_count > 0:
                self._pending_count -= 1
            return
        if self._pending_count > 0:
            return  # pending local write shadows remote
        if contents["type"] == "setCell":
            from .shared_object import decode_handles
            self.value = decode_handles(contents["value"])
            self._has_value = True
            self.emit("valueChanged", self.value, False)
        else:
            self.value = None
            self._has_value = False
            self.emit("delete", False)

    def resubmit_pending(self) -> List[Any]:
        if self._pending_count == 0:
            return []
        # Collapse to the latest local intent.
        self._pending_count = 1
        if self._has_value:
            return [{"type": "setCell", "value": self.value}]
        return [{"type": "deleteCell"}]

    def summarize_core(self) -> SummaryTree:
        blob = json.dumps({"value": self.value, "hasValue": self._has_value})
        return SummaryTree().add_blob("header", blob)

    def load_core(self, tree: SummaryTree) -> None:
        data = json.loads(tree.entries["header"].content)
        self.value = data["value"]
        self._has_value = data["hasValue"]

    def get_gc_data(self) -> List[str]:
        routes: List[str] = []
        collect_handles(self.value, routes)
        return routes
