"""SharedMatrix: 2-D cells addressed through two permutation vectors.

Capability parity with reference packages/dds/matrix/src/{matrix.ts:75,
permutationvector.ts:126}: rows and columns are each a merge-tree sequence
of *runs* of stable ids (the reference's handle allocation becomes run
payloads carrying (client, counter, offset) ids — the same origin-lineage
trick the device kernel uses for text). Cells live in a sparse dict keyed by
stable (row_id, col_id), so cell writes never conflict with row/col
insertion or removal; set-vs-set conflicts resolve LWW with pending-local
shadowing (reference conflict-resolution + handle recycling via zamboni).

A port of fluidframework_tpu's dds/matrix.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional, Tuple

from ..mergetree.client import MergeTreeClient, OP_INSERT, OP_REMOVE
from ..mergetree.constants import SEG_TEXT, UNASSIGNED_SEQ
from ..mergetree.runs import Run, id_key as _id_key
from ..protocol.summary import SummaryTree
from .shared_object import SharedObject, collect_handles


class PermutationVector:
    """A merge-tree client whose payloads are Runs (reference
    permutationvector.ts: PermutationVector extends Client).

    Run id bases use a per-session random nonce, not the client ordinal:
    the base ships inside the insert op, so replica consistency never
    depends on join timing (a pre-join insert must not collide)."""

    def __init__(self, client_id: int = -1):
        self.client = MergeTreeClient(client_id)
        self.run_counter = 0
        self.nonce = random.getrandbits(48)

    @property
    def tree(self):
        return self.client.tree

    def count(self) -> int:
        return self.client.get_length()

    def insert_local(self, pos: int, count: int) -> dict:
        self.run_counter += 1
        run = Run((self.nonce, self.run_counter), 0, count)
        tree = self.client.tree
        from ..mergetree.oracle import Segment
        seg = Segment(kind=SEG_TEXT, text=run)
        tree.insert(pos, seg, tree.current_seq, self.client.client_id,
                    UNASSIGNED_SEQ)
        return {"type": OP_INSERT, "pos1": pos,
                "seg": {"run": run.encode()}}

    def remove_local(self, pos: int, count: int) -> dict:
        return self.client.remove_range_local(pos, pos + count)

    def apply_remote(self, op: dict, seq: int, ref_seq: int, client: int):
        if op["type"] == OP_INSERT:
            run = Run.decode(op["seg"]["run"])
            tree = self.client.tree
            from ..mergetree.oracle import Segment
            seg = Segment(kind=SEG_TEXT, text=run)
            tree.insert(op["pos1"], seg, ref_seq, client, seq)
            tree.update_seq(seq)
        else:
            self.client.apply_msg(op, seq, ref_seq, client)

    def ack(self, seq: int) -> None:
        self.client.tree.ack(seq)
        self.client.tree.update_seq(seq)

    def ids_in_order(self) -> List[Tuple[int, int, int]]:
        tree = self.client.tree
        out: List[Tuple[int, int, int]] = []
        for seg in tree.segments:
            if tree.visible_length(seg, tree.current_seq,
                                   self.client.client_id) > 0:
                out.extend(seg.text.ids())
        return out

    def id_at(self, index: int) -> Tuple[int, int, int]:
        tree = self.client.tree
        acc = 0
        for seg in tree.segments:
            vlen = tree.visible_length(seg, tree.current_seq,
                                       self.client.client_id)
            if acc + vlen > index:
                return seg.text[index - acc]
            acc += vlen
        raise IndexError(index)

    def changes_for_seq(self, seq: int) -> List[Tuple[int, int]]:
        """Visible-position deltas applied by the op sequenced at `seq`:
        [(pos, +count)] for inserts, [(pos, -count)] for removes, in
        ascending position order. This is how remote axis ops resolve to
        consumer notifications (reference permutationvector.ts onDelta →
        rows/colsChanged positions) — the flat segment walk replaces the
        reference's tracked-segment-group machinery."""
        tree = self.client.tree
        out: List[Tuple[int, int]] = []
        acc = 0
        for seg in tree.segments:
            if seg.rem_seq == seq:
                # Removed by this op. If our own pending remove was
                # overwritten by it (rem_overlap carries our client id),
                # the segment was already hidden locally — no view change.
                if self.client.client_id in seg.rem_overlap:
                    continue
                # Position (for the notification) is where it used to sit.
                if out and out[-1][1] < 0 and out[-1][0] == acc:
                    out[-1] = (acc, out[-1][1] - seg.length)
                else:
                    out.append((acc, -seg.length))
                continue
            vlen = tree.visible_length(seg, tree.current_seq,
                                       self.client.client_id)
            if seg.ins_seq == seq and vlen > 0:
                if out and out[-1][1] > 0 and out[-1][0] + out[-1][1] == acc:
                    out[-1] = (out[-1][0], out[-1][1] + vlen)
                else:
                    out.append((acc, vlen))
            acc += vlen
        return out

    def index_of_id(self, key: str) -> Optional[int]:
        """Current visible index of a stable id (None if removed).
        O(#segments): runs carry contiguous id spans, so one range check
        per segment replaces materializing every id."""
        a, b, c = (int(x) for x in key.split("."))
        tree = self.client.tree
        acc = 0
        for seg in tree.segments:
            vlen = tree.visible_length(seg, tree.current_seq,
                                       self.client.client_id)
            if vlen == 0:
                continue
            run = seg.text
            if run.base == (a, b) and run.start <= c < run.start + vlen:
                return acc + (c - run.start)
            acc += vlen
        return None

    def snapshot(self) -> dict:
        snap = self.client.snapshot()
        for entry in snap["segments"]:
            if isinstance(entry.get("text"), Run):
                entry["text"] = {"run": entry["text"].encode()}
        return snap

    def load(self, snap: dict, client_id: int) -> None:
        for entry in snap["segments"]:
            if isinstance(entry.get("text"), dict) and "run" in entry["text"]:
                entry["text"] = Run.decode(entry["text"]["run"])
        self.client = MergeTreeClient.load(snap, client_id=client_id)
        self.run_counter = 0


class SharedMatrix(SharedObject):
    """The matrix DDS + the IMatrixProducer surface: views register via
    open_matrix(consumer) and receive rows_changed / cols_changed /
    cells_changed callbacks for local AND remote changes with resolved
    visible positions (reference matrix.ts IMatrixProducer/IMatrixConsumer
    from @tiny-calc/nano; handle recycling is unnecessary here — stable
    (nonce, counter, offset) ids never get reused, so there is no free
    list to manage)."""

    TYPE = "https://graph.microsoft.com/types/sharedmatrix"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.rows = PermutationVector(self.local_client_id)
        self.cols = PermutationVector(self.local_client_id)
        # cell key "(rowid,colid)" -> value; pending LWW shadow counts
        self.cells: Dict[str, Any] = {}
        self._pending_cells: Dict[str, int] = {}
        self._consumers: List[Any] = []

    # -- IMatrixProducer ----------------------------------------------------
    def open_matrix(self, consumer: Any) -> "SharedMatrix":
        """Register a change consumer (reference IMatrixProducer.
        openMatrix). Consumers implement any of rows_changed(pos, delta),
        cols_changed(pos, delta), cells_changed(row, col, value)."""
        if consumer not in self._consumers:
            self._consumers.append(consumer)
        return self

    def close_matrix(self, consumer: Any) -> None:
        if consumer in self._consumers:
            self._consumers.remove(consumer)

    def _notify(self, method: str, *args) -> None:
        for consumer in list(self._consumers):
            fn = getattr(consumer, method, None)
            if fn is not None:
                fn(*args)

    # -- lifecycle ---------------------------------------------------------
    def adopt_client_ordinal(self, ordinal: int) -> None:
        self.rows.client.update_client_id(ordinal)
        self.cols.client.update_client_id(ordinal)

    def connect(self) -> None:
        if not self.attached:
            self.rows.client.commit_detached()
            self.cols.client.commit_detached()
            self._pending_cells.clear()
        super().connect()

    # -- dimensions --------------------------------------------------------
    @property
    def row_count(self) -> int:
        return self.rows.count()

    @property
    def col_count(self) -> int:
        return self.cols.count()

    def insert_rows(self, pos: int, count: int) -> None:
        op = self.rows.insert_local(pos, count)
        self.submit_local_message({"target": "rows", "op": op})
        self.emit("rowsChanged", pos, count, True, None)
        self._notify("rows_changed", pos, count)

    def insert_cols(self, pos: int, count: int) -> None:
        op = self.cols.insert_local(pos, count)
        self.submit_local_message({"target": "cols", "op": op})
        self.emit("colsChanged", pos, count, True, None)
        self._notify("cols_changed", pos, count)

    def _capture_axis(self, axis: str, pos: int, count: int) -> dict:
        """Cell contents of the rows/cols about to be removed, keyed by the
        OTHER axis's stable ids — the undo provider reinserts fresh
        rows/cols and restores by surviving-axis identity (reference
        matrix undoprovider.ts revert via tracked segments)."""
        if axis == "rows":
            gone = [_id_key(r) for r in self.rows.ids_in_order()[
                pos:pos + count]]
            other = [_id_key(c) for c in self.cols.ids_in_order()]
            cells = [{c: self.cells[g + "|" + c] for c in other
                      if g + "|" + c in self.cells} for g in gone]
        else:
            gone = [_id_key(c) for c in self.cols.ids_in_order()[
                pos:pos + count]]
            other = [_id_key(r) for r in self.rows.ids_in_order()]
            cells = [{r: self.cells[r + "|" + g] for r in other
                      if r + "|" + g in self.cells} for g in gone]
        return {"cells": cells}

    def remove_rows(self, pos: int, count: int) -> None:
        captured = self._capture_axis("rows", pos, count)
        op = self.rows.remove_local(pos, count)
        self.submit_local_message({"target": "rows", "op": op})
        self.emit("rowsChanged", pos, -count, True, captured)
        self._notify("rows_changed", pos, -count)

    def remove_cols(self, pos: int, count: int) -> None:
        captured = self._capture_axis("cols", pos, count)
        op = self.cols.remove_local(pos, count)
        self.submit_local_message({"target": "cols", "op": op})
        self.emit("colsChanged", pos, -count, True, captured)
        self._notify("cols_changed", pos, -count)

    # -- undo support -------------------------------------------------------
    def restore_rows(self, pos: int, captured: dict) -> None:
        """Reinsert removed rows and restore their cells against columns
        that still exist (by stable column id)."""
        cells = captured["cells"]
        self.insert_rows(pos, len(cells))
        col_ids = {_id_key(c): i
                   for i, c in enumerate(self.cols.ids_in_order())}
        for i, row_cells in enumerate(cells):
            for col_id, value in row_cells.items():
                if col_id in col_ids:
                    self.set_cell(pos + i, col_ids[col_id], value)

    def restore_cols(self, pos: int, captured: dict) -> None:
        cells = captured["cells"]
        self.insert_cols(pos, len(cells))
        row_ids = {_id_key(r): i
                   for i, r in enumerate(self.rows.ids_in_order())}
        for i, col_cells in enumerate(cells):
            for row_id, value in col_cells.items():
                if row_id in row_ids:
                    self.set_cell(row_ids[row_id], pos + i, value)

    # -- cells ---------------------------------------------------------------
    def _cell_key(self, row: int, col: int) -> str:
        return _id_key(self.rows.id_at(row)) + "|" + \
            _id_key(self.cols.id_at(col))

    def set_cell(self, row: int, col: int, value: Any) -> None:
        key = self._cell_key(row, col)
        previous = self.cells.get(key)
        self.cells[key] = value
        self._pending_cells[key] = self._pending_cells.get(key, 0) + 1
        self.submit_local_message(
            {"target": "cell", "key": key, "value": value})
        self.emit("cellChanged", row, col, value, True, previous)
        self._notify("cells_changed", row, col, value)

    def set_cells(self, row_start: int, col_start: int, col_count: int,
                  values) -> None:
        """Write a rectangular run row-major (reference matrix.ts:189
        setCells: col_count wide, wrapping to the next row)."""
        values = list(values)
        if col_count <= 0:
            raise ValueError("col_count must be positive")
        for i, value in enumerate(values):
            self.set_cell(row_start + i // col_count,
                          col_start + i % col_count, value)

    def get_cell(self, row: int, col: int) -> Any:
        return self.cells.get(self._cell_key(row, col))

    def extract(self) -> List[List[Any]]:
        row_ids = [_id_key(r) for r in self.rows.ids_in_order()]
        col_ids = [_id_key(c) for c in self.cols.ids_in_order()]
        return [[self.cells.get(r + "|" + c) for c in col_ids]
                for r in row_ids]

    # -- processing ----------------------------------------------------------
    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        target = contents["target"]
        if target == "cell":
            key = contents["key"]
            if local:
                n = self._pending_cells.get(key, 0)
                if n > 1:
                    self._pending_cells[key] = n - 1
                else:
                    self._pending_cells.pop(key, None)
                return
            if key in self._pending_cells:
                return  # pending local write shadows (reference set-vs-set)
            previous = self.cells.get(key)
            self.cells[key] = contents["value"]
            if not self._consumers and \
                    self.listener_count("cellChanged") == 0:
                return  # nobody to notify: skip index resolution entirely
            # Resolve the stable cell id to current visible indices (None
            # when the row/col has since been removed — the write still
            # lands by identity and reappears if the axis is restored).
            row_key, _, col_key = key.partition("|")
            row = self.rows.index_of_id(row_key)
            col = self.cols.index_of_id(col_key)
            self.emit("cellChanged", row, col, contents["value"], False,
                      previous)
            if row is not None and col is not None:
                self._notify("cells_changed", row, col, contents["value"])
            return
        vector = self.rows if target == "rows" else self.cols
        if local:
            vector.ack(seq)
        else:
            vector.apply_remote(contents["op"], seq, ref_seq, client_ordinal)
            event = "rowsChanged" if target == "rows" else "colsChanged"
            method = "rows_changed" if target == "rows" else "cols_changed"
            if not self._consumers and self.listener_count(event) == 0:
                return  # nobody to notify: skip the position walk
            for pos, delta in vector.changes_for_seq(seq):
                self.emit(event, pos, delta, False, None)
                self._notify(method, pos, delta)

    def resubmit_pending(self) -> List[Any]:
        ops = []
        for op in self.rows.client.regenerate_pending_ops():
            if "seg" in op and isinstance(op["seg"].get("text"), Run):
                op["seg"] = {"run": op["seg"]["text"].encode()}
            ops.append({"target": "rows", "op": op})
        for op in self.cols.client.regenerate_pending_ops():
            if "seg" in op and isinstance(op["seg"].get("text"), Run):
                op["seg"] = {"run": op["seg"]["text"].encode()}
            ops.append({"target": "cols", "op": op})
        for key in self._pending_cells:
            self._pending_cells[key] = 1
            ops.append({"target": "cell", "key": key,
                        "value": self.cells.get(key)})
        return ops

    # -- summary -------------------------------------------------------------
    def summarize_core(self) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("rows", json.dumps(self.rows.snapshot()))
        tree.add_blob("cols", json.dumps(self.cols.snapshot()))
        tree.add_blob("cells", json.dumps(self.cells, sort_keys=True))
        return tree

    def load_core(self, tree: SummaryTree) -> None:
        self.rows.load(json.loads(tree.entries["rows"].content),
                       self.local_client_id)
        self.cols.load(json.loads(tree.entries["cols"].content),
                       self.local_client_id)
        self.cells = json.loads(tree.entries["cells"].content)

    def get_gc_data(self) -> List[str]:
        routes: List[str] = []
        collect_handles(self.cells, routes)
        return routes
