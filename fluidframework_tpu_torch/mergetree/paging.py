"""Paged lane memory: fixed-size segment pages + per-document page tables.

Counterpart of fluidframework_tpu's mergetree/paging.py. Segment rows
live in a device pool of [n_pages, PAGE_ROWS] pages (a DocState whose
batch axis is pages; its per-page scalar fields are unused padding), each
document owns a host-side table of int32 page ids, and a refcounted free
list hands pages out. A document grows by appending a page; its rows
never move, because the apply-time view is gathered from its own pages
(kernel.gather_pages).

Invariants:
- page 0 is the reserved BLANK page: never allocated, always blank, so a
  page-table padding id (-1) gathers canonical make_state rows;
- a page is owned by exactly one document (refcount 1) or free; releasing
  a free page raises (double free), and a page released to zero is blanked
  before the free list hands it out again;
- `counts[key] <= len(tables[key]) * page_rows`: callers pre-grow with
  `ensure_rows` (each applied op adds at most 2 rows), so an apply never
  spills rows into gather padding.

JAX donates the pool to its jitted page writes; here they update the pool
tensors in place.

On a mesh (`PagedMergeStore(mesh=...)`) the page axis shards over 'dp' by
the partition-rule table (partition_rules.POOL_PARTITION_RULES), so the
pool's capacity scales with the mesh; the page count rounds up to a dp
multiple, and doubling keeps it one. A window's pages may sit on several
shards: kernel.gather_pages copies each from its owning shard to the
dispatching device and kernel.scatter_pages writes each back, bit for bit,
and both count the pages they move. JAX turns donation off on a mesh; the
`donate` flag says so here too (the paged dispatches keep their pre views).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..parallel.mesh import Sharded, gather_tree, take_rows, write_rows
from .constants import MAX_OVERLAP_CLIENTS, PAGE_ROWS
from .partition_rules import (POOL_PARTITION_RULES, ensure_placement,
                              place_with_rules, resolved_spec_table)
from .state import DEFAULT_ANNO_SLOTS, DocState, make_state

BLANK_PAGE = 0  # reserved, never allocated, always blank

#: The in-place page writes: function -> the argument positions whose
#: tensors it writes in place (JAX's donate_argnums). fluidlint's lifecycle
#: rules read this table; nothing reads it at run time.
IN_PLACE_ARGS = {"_zero_pool_pages": (0,), "_put_pool_pages": (0,)}


def _zero_pool_pages(pool: DocState, idx: torch.Tensor,
                     blank: DocState) -> DocState:
    """Blank the pages at `idx` in place (every row plane of the pool;
    the per-page scalar fields are unused) and return the pool. A repeated
    id writes the same blank twice, which is harmless."""
    for col, b in zip(pool, blank):
        if col.dim() <= 1:
            continue
        if isinstance(col, Sharded):
            rows = idx.cpu().numpy()
            write_rows(col, rows, b.expand((len(rows),) + tuple(b.shape)))
        else:
            col[idx] = b
    return pool


def _put_pool_pages(pool: DocState, idx: torch.Tensor,
                    row: DocState) -> DocState:
    """Write one document's page-reshaped row planes ([k, R, ...]) into
    pages `idx` in place and return the pool. (JAX pads `idx` to a power
    of two with ids past the pool, which its scatter drops, to bound its
    compiled shapes; nothing here compiles per shape, so `idx` holds the
    document's pages only.)"""
    for col, v in zip(pool, row):
        if col.dim() <= 1:
            continue
        if isinstance(col, Sharded):
            write_rows(col, idx.cpu().numpy(), v)
        else:
            col[idx] = v
    return pool


class PageAllocator:
    """Host-side refcounted free-list allocator over the page pool: O(1)
    alloc and release; a double free and a foreign id (the blank page or
    one outside the pool) raise."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("page pool needs the blank page + 1")
        self.capacity = n_pages
        self.refcount = np.zeros(n_pages, np.int32)
        self.refcount[BLANK_PAGE] = 1  # pinned forever
        self._free: List[int] = list(range(n_pages - 1, BLANK_PAGE, -1))

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free) - 1  # minus the blank page

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """One free page, refcount 0 -> 1. Raises IndexError when the pool
        is exhausted (callers grow it first)."""
        pid = self._free.pop()
        assert self.refcount[pid] == 0, \
            f"free-list page {pid} has refcount {self.refcount[pid]}"
        self.refcount[pid] = 1
        return pid

    def alloc_many(self, n: int) -> List[int]:
        return [self.alloc() for _ in range(n)]

    def retain(self, pid: int) -> None:
        """Share a page (refcount + 1); the blank page and free pages
        refuse."""
        self._check(pid)
        if self.refcount[pid] <= 0:
            raise ValueError(f"retain of free page {pid}")
        self.refcount[pid] += 1

    def release(self, pid: int) -> bool:
        """Drop one reference; True when the page freed (the caller blanks
        it). Releasing an already-free page is a double free and raises."""
        self._check(pid)
        if self.refcount[pid] <= 0:
            raise ValueError(f"double free of page {pid}")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)
            return True
        return False

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            return
        grown = np.zeros(new_capacity, np.int32)
        grown[:self.capacity] = self.refcount
        self.refcount = grown
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self.capacity = new_capacity

    def _check(self, pid: int) -> None:
        if not (0 < pid < self.capacity):
            raise ValueError(f"page id {pid} outside pool "
                             f"(1..{self.capacity - 1})")


def pages_for(rows: int, page_rows: int = PAGE_ROWS) -> int:
    """Pages needed to hold `rows` segment rows (minimum one)."""
    return max(1, -(-rows // page_rows))


def pow2_pages(n: int) -> int:
    """The page-count bucket: page-table widths pad to powers of two, so
    documents group by it and a group's view pads to the group's depth."""
    return 1 << max(n - 1, 0).bit_length()


class PagedMergeStore:
    """The device page pool + per-document page tables + host scalar
    mirrors. Per-document count, min_seq and seq are authoritative on the
    host; every serving ring returns their exact post values."""

    def __init__(self, page_rows: int = PAGE_ROWS, pages: int = 64,
                 anno_slots: int = DEFAULT_ANNO_SLOTS,
                 overlap_slots: int = MAX_OVERLAP_CLIENTS,
                 device: str | torch.device | None = None, mesh=None):
        """device: where a dispatch gathers its pages (the mesh's home
        device on a mesh). mesh: a parallel.mesh.Mesh whose 'dp' axis the
        page axis shards over (None: one device)."""
        self.page_rows = page_rows
        self.anno_slots = anno_slots
        self.overlap_slots = overlap_slots
        self.device = resolve_device(device)
        self.mesh = mesh
        # The paged dispatches keep their inputs on a mesh (JAX gates
        # donation off there); the page writes themselves stay in place.
        self.donate = mesh is None
        if mesh is not None:
            dp = mesh.shape["dp"]
            pages = -(-pages // dp) * dp
        self.pool: DocState = self._placed(make_state(
            page_rows, anno_slots, overlap_slots, batch=pages,
            device=self.device))
        self.pool_replacements = 0  # leaves re-placed after spec drift
        self.allocator = PageAllocator(pages)
        self.tables: Dict[tuple, List[int]] = {}
        self.counts: Dict[tuple, int] = {}
        self.min_seqs: Dict[tuple, int] = {}
        self.seqs: Dict[tuple, int] = {}
        # Ops applied since the document's last defrag pass: the
        # fragmentation pressure the lane store's budgeted compact tick
        # ranks documents by (an upper bound on new tombstones, known
        # without a device read).
        self.ops_since_compact: Dict[tuple, int] = {}
        self._blank_row: DocState | None = None
        self.pool_grows = 0

    # -- pool growth / zeroing --------------------------------------------
    def _blank(self) -> DocState:
        if self._blank_row is None:
            self._blank_row = make_state(self.page_rows, self.anno_slots,
                                         self.overlap_slots,
                                         device=self.device)
        return self._blank_row

    def grow_pool(self, need_pages: int = 1) -> None:
        """Double the pool until `need_pages` pages are free; the old pages
        keep their ids and rows."""
        new_cap = self.allocator.capacity
        while new_cap - 1 - self.allocator.pages_in_use < need_pages:
            new_cap *= 2
        if new_cap == self.allocator.capacity:
            return
        old = self.allocator.capacity
        grown = make_state(self.page_rows, self.anno_slots,
                           self.overlap_slots, batch=new_cap,
                           device=self.device)
        for g, s in zip(grown, gather_tree(self.pool)):
            g[:old] = s
        self.adopt_pool(self._placed(grown))
        self.allocator.grow(new_cap)
        self.pool_grows += 1

    def _placed(self, pool: DocState) -> DocState:
        if self.mesh is None:
            return pool
        return place_with_rules(self.mesh, pool, POOL_PARTITION_RULES)

    def adopt_pool(self, new_pool: DocState) -> None:
        """Adopt a pool returned by a serving call. On a mesh, every leaf
        is checked against its rule-table placement and a drifted leaf is
        placed again (counted in `pool_replacements`)."""
        if self.mesh is not None:
            new_pool, replaced = ensure_placement(
                self.mesh, new_pool, POOL_PARTITION_RULES)
            self.pool_replacements += replaced
        self.pool = new_pool

    def zero_pages(self, pids: List[int]) -> None:
        """Blank freed pages in place, so a reallocated page (and gather
        padding through the blank page) reads canonical make_state rows."""
        if not pids:
            return
        # fluidlint: disable=PAGE_ID_DTYPE — the transient index of the
        # blanking write (torch's indexing takes int64); tables stay int32
        idx = torch.as_tensor(pids, dtype=torch.int64, device=self.device)
        _zero_pool_pages(self.pool, idx, self._blank())

    # -- per-doc tables ----------------------------------------------------
    def ensure(self, key: tuple) -> None:
        if key in self.tables:
            return
        if self.allocator.pages_free < 1:
            self.grow_pool()
        self.tables[key] = [self.allocator.alloc()]
        self.counts[key] = 0
        self.min_seqs[key] = 0
        self.seqs[key] = 0

    def rows_allocated(self, key: tuple) -> int:
        return len(self.tables[key]) * self.page_rows

    def ensure_rows(self, key: tuple, need: int) -> None:
        """Append pages until the document can hold `need` rows: one
        allocator pop and one table append per page, no data movement."""
        self.ensure(key)
        table = self.tables[key]
        want = pages_for(need, self.page_rows)
        if want > len(table):
            missing = want - len(table)
            if self.allocator.pages_free < missing:
                self.grow_pool(missing)
            table.extend(self.allocator.alloc_many(missing))

    def release_trailing(self, key: tuple) -> None:
        """Free and blank the pages wholly past the live row count."""
        self.zero_pages(self._release_trailing_ids(key))

    def release_trailing_many(self, keys) -> None:
        """release_trailing over a group of documents with one blanking
        pass."""
        freed: List[int] = []
        for key in keys:
            freed.extend(self._release_trailing_ids(key))
        self.zero_pages(freed)

    def _release_trailing_ids(self, key: tuple) -> List[int]:
        table = self.tables.get(key)
        if not table:
            return []
        keep = pages_for(self.counts.get(key, 0), self.page_rows)
        if keep >= len(table):
            return []
        dead, self.tables[key] = table[keep:], table[:keep]
        return [pid for pid in dead if self.allocator.release(pid)]

    def free_all(self, key: tuple) -> None:
        table = self.tables.pop(key, None)
        for d in (self.counts, self.min_seqs, self.seqs,
                  self.ops_since_compact):
            d.pop(key, None)
        if table:
            self.zero_pages([pid for pid in table
                             if self.allocator.release(pid)])

    # -- staging -----------------------------------------------------------
    def page_ids_array(self, keys: List[tuple], width: int) -> np.ndarray:
        """[len(keys), width] int32 page-table plane, -1-padded (gathers
        the blank page; scatters leave it as it was)."""
        out = np.full((len(keys), width), -1, np.int32)
        for j, key in enumerate(keys):
            table = self.tables[key]
            assert len(table) <= width, (key, len(table), width)
            out[j, :len(table)] = table
        return out

    def scalars_arrays(self, keys: List[tuple]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        counts = np.asarray([self.counts[k] for k in keys], np.int32)
        mins = np.asarray([self.min_seqs[k] for k in keys], np.int32)
        seqs = np.asarray([self.seqs[k] for k in keys], np.int32)
        return counts, mins, seqs

    def adopt_scalars(self, keys: List[tuple], counts, min_seqs,
                      seqs) -> None:
        """Post-apply host mirror update, with the spill check (a count
        past the allocated rows means rows were lost to gather padding)."""
        for j, key in enumerate(keys):
            c = int(counts[j])
            assert c <= self.rows_allocated(key), \
                f"paged apply spilled rows for {key}: {c} > " \
                f"{self.rows_allocated(key)} allocated"
            self.counts[key] = c
            self.min_seqs[key] = int(min_seqs[j])
            self.seqs[key] = int(seqs[j])

    # -- single-document host access ----------------------------------------
    def row(self, key: tuple) -> DocState:
        """One document gathered into a single-document DocState view (the
        host read path: the text, entries or summary of one lane)."""
        table = self.tables[key]
        idx = torch.as_tensor(table, dtype=torch.int64, device=self.device)

        def g(col):
            x = take_rows(col, table, self.device) \
                if isinstance(col, Sharded) else col[idx]
            return x.reshape((len(table) * self.page_rows,)
                             + tuple(x.shape[2:]))

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return DocState(
            **{name: g(getattr(self.pool, name))
               for name in DocState._fields[:10]},
            count=scalar(self.counts[key]),
            min_seq=scalar(self.min_seqs[key]),
            seq=scalar(self.seqs[key]),
            overflow=torch.tensor(False, device=self.device))

    def put_row(self, key: tuple, row: DocState, count: int) -> None:
        """Write a single-document DocState whose capacity is a whole
        number of pages into the document's pages, in place (seeds and
        host rescues come through here), take its scalars, and free the
        pages wholly past `count` rows."""
        c = row.capacity
        self.ensure_rows(key, c)
        table = self.tables[key][:pages_for(c, self.page_rows)]
        assert c == len(table) * self.page_rows, (c, len(table))
        k, r = len(table), self.page_rows
        idx = torch.as_tensor(table, dtype=torch.int64, device=self.device)
        paged = DocState(*(
            v.reshape((k, r) + tuple(v.shape[1:])) if v.dim() else v
            for v in row))
        _put_pool_pages(self.pool, idx, paged)
        self.counts[key] = count
        self.min_seqs[key] = int(row.min_seq)
        self.seqs[key] = int(row.seq)
        self.release_trailing(key)

    # -- placement -----------------------------------------------------------
    def placement_spec_table(self) -> Dict[str, str]:
        """Leaf name -> rule-resolved PartitionSpec string for the pool
        (partition_rules.resolved_spec_table): the table that
        testing/shardcheck verifies."""
        return resolved_spec_table(self.pool, POOL_PARTITION_RULES)

    # -- stats ---------------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.allocator.pages_in_use

    def page_fill_frac(self) -> float:
        """Live rows / allocated page rows across all documents (1.0 with
        no pages allocated)."""
        rows = sum(len(t) for t in self.tables.values()) * self.page_rows
        if not rows:
            return 1.0
        return sum(self.counts.values()) / rows
