"""Ink: freehand stroke DDS.

Capability parity with reference packages/dds/ink/src/ink.ts: strokes are
created with a pen (color/thickness), points append monotonically per
stroke, clear wipes the canvas. Ink ops are commutative per stroke (points
append in sequenced order), so there is no pending/shadow machinery —
matching the reference's straightforward op application.

A port of fluidframework_tpu's dds/ink.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, List, Optional

from ..protocol.summary import SummaryTree
from .shared_object import SharedObject

_stroke_uid = itertools.count(1)


class Ink(SharedObject):
    TYPE = "https://graph.microsoft.com/types/ink"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        # stroke id -> {"pen": {...}, "points": [{x, y, time, pressure}]}
        self.strokes: Dict[str, dict] = {}
        self._order: List[str] = []

    # -- api (ink.ts createStroke/appendPointToStroke/clear) ---------------
    def create_stroke(self, pen: Optional[dict] = None) -> str:
        stroke_id = f"stroke-{self.local_client_id}-{next(_stroke_uid)}"
        op = {"type": "createStroke", "id": stroke_id, "pen": pen or {}}
        self._apply(op)
        self.submit_local_message(op)
        return stroke_id

    def append_point_to_stroke(self, stroke_id: str, point: dict) -> None:
        op = {"type": "stylus", "id": stroke_id, "point": point}
        self._apply(op)
        self.submit_local_message(op)

    def clear(self) -> None:
        op = {"type": "clear"}
        self._apply(op)
        self.submit_local_message(op)

    def get_stroke(self, stroke_id: str) -> Optional[dict]:
        return self.strokes.get(stroke_id)

    def get_strokes(self) -> List[dict]:
        return [self.strokes[sid] for sid in self._order]

    # -- op application ----------------------------------------------------
    def _apply(self, op: dict) -> None:
        t = op["type"]
        if t == "createStroke":
            if op["id"] not in self.strokes:
                self.strokes[op["id"]] = {"id": op["id"], "pen": op["pen"],
                                          "points": []}
                self._order.append(op["id"])
        elif t == "stylus":
            stroke = self.strokes.get(op["id"])
            if stroke is not None:
                stroke["points"].append(op["point"])
        elif t == "clear":
            self.strokes = {}
            self._order = []

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        if local:
            return  # applied eagerly at submit; append order already fixed
        self._apply(contents)
        self.emit("ink", contents, False)

    def resubmit_pending(self) -> List[Any]:
        # Ink ops are idempotent-enough for the canvas use case; the
        # reference resubmits verbatim as well (no position rewrite needed).
        return []

    # -- snapshot ----------------------------------------------------------
    def summarize_core(self) -> SummaryTree:
        return SummaryTree().add_blob("header", json.dumps(
            {"order": self._order, "strokes": self.strokes},
            sort_keys=True))

    def load_core(self, tree: SummaryTree) -> None:
        data = json.loads(tree.entries["header"].content)
        self.strokes = data["strokes"]
        self._order = data["order"]
