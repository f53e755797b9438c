"""Undo-redo: stack-of-stacks revertible manager + DDS handlers.

Capability parity with reference packages/framework/undo-redo (README:1-13):
- UndoRedoStackManager groups local changes into operations (open/close);
  undo pops an operation and reverts it, with the reverts themselves
  captured onto the redo stack (and vice versa).
- SharedMapUndoRedoHandler / SharedSegmentSequenceUndoRedoHandler subscribe
  to local DDS events and push revertibles.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class UndoRedoStackManager:
    MODE_NONE, MODE_UNDO, MODE_REDO = 0, 1, 2

    def __init__(self):
        self.undo_stack: List[List[Callable[[], None]]] = []
        self.redo_stack: List[List[Callable[[], None]]] = []
        self._open = False
        self._mode = self.MODE_NONE

    # -- operation grouping ------------------------------------------------
    def open_current_operation(self) -> None:
        """Group subsequent pushes into one undoable operation until
        close_current_operation (reference openCurrentOperation)."""
        self._current_stack().append([])
        self._open = True

    def close_current_operation(self) -> None:
        self._open = False

    def push(self, revert: Callable[[], None]) -> None:
        """Record a revertible for the most recent local change."""
        stack = self._current_stack()
        if self._mode == self.MODE_NONE and not self._open:
            stack.append([revert])
        else:
            if not stack:
                stack.append([])
            stack[-1].append(revert)
        if self._mode == self.MODE_NONE:
            # A fresh local change invalidates the redo future.
            self.redo_stack.clear()

    # -- undo / redo -------------------------------------------------------
    def undo_operation(self) -> bool:
        if not self.undo_stack:
            return False
        operation = self.undo_stack.pop()
        self._mode = self.MODE_UNDO
        self.redo_stack.append([])
        try:
            for revert in reversed(operation):
                revert()
        finally:
            self._mode = self.MODE_NONE
        return True

    def redo_operation(self) -> bool:
        if not self.redo_stack:
            return False
        operation = self.redo_stack.pop()
        self._mode = self.MODE_REDO
        self.undo_stack.append([])
        try:
            for revert in reversed(operation):
                revert()
        finally:
            self._mode = self.MODE_NONE
        return True

    # -- internals ---------------------------------------------------------
    def _current_stack(self) -> List[List[Callable[[], None]]]:
        if self._mode == self.MODE_UNDO:
            return self.redo_stack
        return self.undo_stack


class SharedMapUndoRedoHandler:
    """Pushes a revertible per local SharedMap change (reference
    sharedMapUndoRedoHandler). previous==MISSING reverts to delete."""

    def __init__(self, manager: UndoRedoStackManager):
        self.manager = manager

    def attach(self, shared_map) -> None:
        from ..dds.map import MISSING

        def on_value_changed(key, local, previous=MISSING):
            if not local:
                return

            def revert():
                if previous is MISSING:
                    shared_map.delete(key)
                else:
                    shared_map.set(key, previous)

            self.manager.push(revert)

        shared_map.on("valueChanged", on_value_changed)


class SharedSegmentSequenceUndoRedoHandler:
    """Pushes revertibles for local sequence deltas: insert -> remove,
    remove -> reinsert captured text, annotate -> restore propertyDeltas
    (reference sequenceHandler)."""

    def __init__(self, manager: UndoRedoStackManager):
        self.manager = manager

    def attach(self, sequence) -> None:
        def on_delta(args, local):
            if not local:
                return
            op = args.get("op")
            if op == "insert":
                pos, text = args["pos"], args["text"]

                def revert_insert():
                    sequence.remove_text(pos, pos + len(text))

                self.manager.push(revert_insert)
            elif op == "remove" and "text" in args:
                start, text = args["start"], args["text"]

                def revert_remove():
                    sequence.insert_text(start, text)

                self.manager.push(revert_remove)
            elif op == "annotate" and args.get("propertyDeltas") is not None:
                deltas = args["propertyDeltas"]

                def revert_annotate():
                    for s, e, old in deltas:
                        sequence.annotate_range(s, e, dict(old))

                self.manager.push(revert_annotate)

        sequence.on("sequenceDelta", on_delta)


class SharedMatrixUndoRedoHandler:
    """Pushes revertibles for local SharedMatrix changes (reference
    matrix/src/undoprovider.ts): cell set -> restore previous value;
    row/col insert -> remove them; row/col remove -> reinsert + restore the
    captured cells by surviving-axis stable ids."""

    def __init__(self, manager: UndoRedoStackManager):
        self.manager = manager

    def attach(self, matrix) -> None:
        def on_cell(row, col, value, local, previous=None):
            if not local or row is None:
                return

            def revert_cell():
                matrix.set_cell(row, col, previous)

            self.manager.push(revert_cell)

        def on_axis(pos, count, local, captured=None, *, axis):
            if not local:
                return
            if count > 0:
                def revert_insert():
                    if axis == "rows":
                        matrix.remove_rows(pos, count)
                    else:
                        matrix.remove_cols(pos, count)
                self.manager.push(revert_insert)
            elif captured is not None:
                def revert_remove():
                    if axis == "rows":
                        matrix.restore_rows(pos, captured)
                    else:
                        matrix.restore_cols(pos, captured)
                self.manager.push(revert_remove)

        matrix.on("cellChanged", on_cell)
        matrix.on("rowsChanged",
                  lambda pos, count, local, captured=None:
                  on_axis(pos, count, local, captured, axis="rows"))
        matrix.on("colsChanged",
                  lambda pos, count, local, captured=None:
                  on_axis(pos, count, local, captured, axis="cols"))
