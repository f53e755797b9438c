"""SharedSummaryBlock: summary-only data, no ops.

Capability parity with reference packages/dds/shared-summary-block: values
set locally are NEVER sent as ops — they persist exclusively through the
summary tree. Used for data that only the summarizer writes (e.g. search
indexes), avoiding op-stream traffic entirely.

A port of fluidframework_tpu's dds/summary_block.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from ..protocol.summary import SummaryTree
from .shared_object import SharedObject


class SharedSummaryBlock(SharedObject):
    TYPE = "https://graph.microsoft.com/types/shared-summary-block"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.data: Dict[str, Any] = {}

    def get(self, key: str, default: Any = None) -> Any:
        return self.data.get(key, default)

    def set(self, key: str, value: Any) -> Any:
        """Local-only write; becomes durable at the next summary. Values
        must be JSON-serializable (they go straight into the blob)."""
        json.dumps(value)  # fail fast on non-serializable input
        self.data[key] = value
        self.change_epoch += 1  # no ops flow: dirty explicitly
        return value

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        raise RuntimeError(
            "SharedSummaryBlock does not process ops (summary-only DDS)")

    def resubmit_pending(self) -> List[Any]:
        return []

    def summarize_core(self) -> SummaryTree:
        return SummaryTree().add_blob(
            "header", json.dumps(self.data, sort_keys=True))

    def load_core(self, tree: SummaryTree) -> None:
        self.data = json.loads(tree.entries["header"].content)
