"""SparseMatrix: the legacy row-major matrix from the sequence package.

Capability parity with reference packages/dds/sequence SparseMatrix (legacy,
superseded by SharedMatrix exactly as here): a fixed ~2^31 virtual column
space with sparse rows; insertRows/removeRows shift row identity, setItems
writes runs of cells. Implemented as a facade over the SharedMatrix engine
(permutation-vector rows + sparse cell store) — the legacy API surface with
the modern conflict resolution underneath.

A port of fluidframework_tpu's dds/sparse_matrix.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

from typing import Any, List

from .matrix import SharedMatrix

# The reference exposes a huge fixed column space (maxCols = 2^31); columns
# are never inserted/removed, only rows.
MAX_COLS = 1 << 31


class SparseMatrix(SharedMatrix):
    TYPE = "https://graph.microsoft.com/types/mergeTree/sparse-matrix"

    @property
    def num_rows(self) -> int:
        return self.row_count

    @property
    def num_cols(self) -> int:
        return MAX_COLS

    def _ensure_cols(self, through: int) -> None:
        """Columns materialize lazily as they are touched (the virtual
        2^31-wide space would never be allocated)."""
        if self.col_count <= through:
            self.insert_cols(self.col_count, through + 1 - self.col_count)

    def insert_rows(self, row: int, count: int) -> None:  # noqa: D102
        super().insert_rows(row, count)

    def remove_rows(self, row: int, count: int) -> None:  # noqa: D102
        super().remove_rows(row, count)

    def set_items(self, row: int, col: int, values: List[Any]) -> None:
        """Write a horizontal run of cells starting at (row, col)."""
        self._ensure_cols(col + len(values) - 1)
        for i, value in enumerate(values):
            self.set_cell(row, col + i, value)

    def get_item(self, row: int, col: int) -> Any:
        if col >= self.col_count:
            return None
        return self.get_cell(row, col)
