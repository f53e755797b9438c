"""SharedCounter: commutative increment DDS.

Capability parity with reference packages/dds/counter/src/counter.ts —
increments commute, so remote and pending-local deltas just add; acks retire
pending records (value already applied).

A port of fluidframework_tpu's dds/counter.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
from typing import Any, List

from ..protocol.summary import SummaryTree
from .shared_object import SharedObject


class SharedCounter(SharedObject):
    TYPE = "https://graph.microsoft.com/types/counter"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.value = 0
        self._pending: List[int] = []

    def increment(self, delta: int = 1) -> None:
        if not isinstance(delta, int):
            raise TypeError("SharedCounter increments must be integers")
        self.value += delta
        self._pending.append(delta)
        self.emit("incremented", delta, self.value)
        self.submit_local_message({"type": "increment", "delta": delta})

    def connect(self) -> None:
        if not self.attached:
            self._pending.clear()
        super().connect()

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        if local:
            self._pending.pop(0)
            return
        self.value += contents["delta"]
        self.emit("incremented", contents["delta"], self.value)

    def resubmit_pending(self) -> List[Any]:
        return [{"type": "increment", "delta": d} for d in self._pending]

    def summarize_core(self) -> SummaryTree:
        # Snapshot the *acked* value: pending deltas re-apply via ops.
        acked = self.value - sum(self._pending)
        return SummaryTree().add_blob("header", json.dumps({"value": acked}))

    def load_core(self, tree: SummaryTree) -> None:
        self.value = json.loads(tree.entries["header"].content)["value"]
