"""The serving sequencer's lane stores: device-resident per-channel state.

Counterpart of fluidframework_tpu's server/tpu_sequencer.py up to the
lambda: the merge lanes (`MergeLaneStore`, bucketed or paged), the LWW
lanes (`LwwLaneStore`) and the channel routing helpers. The lambda itself
(`TpuSequencerLambda`, `SequencedWindow`, `_DocLane` and the fast path's
run packers) is not here yet.

Merge lanes live in capacity buckets ([lanes, C] DocState batches, one
apply shape per (capacity, T-bucket) pair) or, with paged=True, in a page
pool with per-document page tables (mergetree/paging.py). A lane that
overflows its bucket during an apply is zamboni-compacted and re-run,
host-folded (acked runs coalesce) at or above `fold_min_capacity`, then
promoted to the next bucket, and rescued on the host as a last resort
before it degrades to opaque. Every apply is kernel.apply_ops_batched_keep
(scan_apply.cu for CUDA tensors, the plain scan for CPU tensors), and the
paged applies are kernel.apply_ops_paged and serve_step.serve_paged_burst.

The JAX arrays the original keeps are immutable. Here every update of a
bucket's state builds new tensors (`index_put`, not an in-place write), so
a state, a row view or an extraction job taken earlier never changes under
its holder; the page pool alone is written in place (paging.py), and the
paged applies hand back the pre-window view as a gathered copy.

Devices: both stores take `device=None` (the card, raising when CUDA is
absent) or a device the caller names; the tests pass "cpu". There is no
mesh placement: one device holds every lane.

Rescue handlers degrade a lane for content the device cannot represent
(catchup.Unmodelable) and for a table too small for its rows
(core/errors.CapacityExceeded); a kernel's refusal, build error or launch
error propagates.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import interop
from ..core.device import resolve_device
from ..core.errors import CapacityExceeded
from ..mergetree import kernel
from ..mergetree.catchup import Unmodelable, looks_like_merge_op
from ..mergetree.constants import DEFAULT_T_BUCKETS, PAGE_ROWS
from ..mergetree.host import OpBuilder, PayloadTable, extract_text
from ..mergetree.oppack import HostOp, PackedOps, pack_ops
from ..mergetree.paging import PagedMergeStore, pages_for, pow2_pages
from ..mergetree.state import DocState, make_state
from ..telemetry import device_stats, tracing
from ..telemetry.compile_ledger import ledger as compile_ledger
from ..telemetry.counters import JitRetraceProbe, increment
from . import lww_kernel, serve_step

# What a rescue or fold may turn into an opaque lane: the rest (a kernel's
# refusal among them) propagates.
_DEGRADE = (Unmodelable, CapacityExceeded)


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"window of {n} exceeds max bucket {buckets[-1]}")


def _host(x) -> np.ndarray:
    """A tensor (or numpy array) as host numpy: the device-to-host copy
    for a CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tree_map(fn, *trees):
    """fn over the fields of NamedTuples of one type, field by field."""
    return type(trees[0])(*(fn(*xs) for xs in zip(*trees)))


def _index(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64).reshape(-1),
                           device=device)


def _take(state, rows):
    """Rows `rows` (host ints) of every field of a batched tuple: a
    gathered copy."""
    idx = _index(rows, state[0].device)
    return _tree_map(lambda x: x[idx], state)


def _set_rows(state, rows, values):
    """A new batched tuple whose rows `rows` are `values` ([k, ...] per
    field): JAX's `.at[rows].set(values)`, never a write into `state`."""
    idx = _index(rows, state[0].device)
    return _tree_map(lambda col, v: col.index_put((idx,), v), state,
                     values)


def _row(state, j: int):
    """Row j of a batched tuple (a view: callers only read it, and no
    update writes into a bucket's tensors)."""
    return _tree_map(lambda x: x[j], state)


# ---------------------------------------------------------------------------
# merge lanes: device-resident per-channel segment tables, capacity-bucketed
# ---------------------------------------------------------------------------

class _MergeBucket:
    """A batch of merge lanes sharing one segment capacity (one apply
    shape per (capacity, T-bucket) pair)."""

    def __init__(self, capacity: int, lanes: int, device: torch.device):
        self.capacity = capacity
        self.lanes = lanes
        self.device = device
        self.state: DocState = make_state(capacity, batch=lanes,
                                          device=device)
        self.used: List[Optional[tuple]] = [None] * lanes  # lane key or None
        self._blank_row: Optional[DocState] = None  # built lazily, reused
        self._free: List[int] = []  # explicitly freed lanes (zeroed)
        self._next = 0              # frontier: lanes >= _next never used
        # Host-side upper bound of each lane's live row count (the
        # lambda's donation gate reads it without a device sync):
        # count_hint is the confirmed base, hint_pending the in-flight
        # windows' staged-op bound.
        self.count_hint = np.zeros(lanes, np.int64)
        self.hint_pending = np.zeros(lanes, np.int64)

    def grow(self) -> None:
        old = self.lanes
        grown = make_state(self.capacity, anno_slots=self.state.anno_slots,
                           overlap_slots=self.state.overlap_slots,
                           batch=old * 2, device=self.device)
        for g, s in zip(grown, self.state):
            g[:old] = s
        self.state = grown
        self.used.extend([None] * old)
        self.lanes = old * 2
        self.count_hint = np.concatenate(
            [self.count_hint, np.zeros(old, np.int64)])
        self.hint_pending = np.concatenate(
            [self.hint_pending, np.zeros(old, np.int64)])

    def alloc(self, key: tuple) -> int:
        # Free list + frontier: O(1) per alloc.
        if self._free:
            i = self._free.pop()
        else:
            if self._next >= self.lanes:
                self.grow()
            i = self._next
            self._next += 1
        self.used[i] = key
        self.count_hint[i] = 0  # freed/frontier lanes are blank rows
        return i

    def free(self, lane: int) -> None:
        self.free_many([lane])

    def free_many(self, lanes: List[int]) -> None:
        # Zero the rows too: alloc() hands freed lanes to new channels,
        # and stale segments would leak into the next channel's
        # materialization. One batched scatter for the whole list.
        if not lanes:
            return
        for i in lanes:
            self.used[i] = None
        self._free.extend(lanes)
        self.count_hint[np.asarray(lanes, np.int64)] = 0
        self.hint_pending[np.asarray(lanes, np.int64)] = 0
        if self._blank_row is None:
            self._blank_row = make_state(
                self.capacity, anno_slots=self.state.anno_slots,
                overlap_slots=self.state.overlap_slots, device=self.device)
        k = len(lanes)
        self.state = _set_rows(self.state, lanes, _tree_map(
            lambda blank: blank.expand((k,) + tuple(blank.shape)),
            self._blank_row))

    def alloc_many(self, keys: List[tuple]) -> List[int]:
        return [self.alloc(key) for key in keys]

    def row(self, lane: int) -> DocState:
        """One lane as a single-document DocState."""
        return _row(self.state, lane)

    def put_row(self, lane: int, row: DocState,
                count_hint: Optional[int] = None) -> None:
        self.state = _set_rows(self.state, [lane],
                               _tree_map(lambda r: r[None], row))
        self.count_hint[lane] = self.capacity if count_hint is None \
            else count_hint

    def put_rows(self, lanes: List[int], rows: DocState,
                 count_hints=None) -> None:
        """Scatter a [k, ...] sub-batch into k lanes in one pass;
        `count_hints` (aligned to `lanes`) keeps the occupancy bound
        tight, omitted = pessimistic until the next compact tick."""
        self.state = _set_rows(self.state, lanes, rows)
        self.count_hint[np.asarray(lanes, np.int64)] = \
            self.capacity if count_hints is None \
            else np.asarray(count_hints, np.int64)


def _stack_seed_rows(items: List[tuple], capacity: int, anno_slots: int,
                     overlap_slots: int, device=None) -> DocState:
    """[(key, seed_host_cols dict, min_seq, seq)] -> one [k, ...] DocState
    built in host numpy and placed as one transfer per field (the batched
    half of catchup.seed_host_cols)."""
    from ..mergetree.constants import DEV_NO_REMOVE, DEV_UNASSIGNED
    k = len(items)

    def full(val, *dims):
        return np.full((k, *dims), val, np.int32)

    out = {
        "length": full(0, capacity),
        "ins_seq": full(DEV_UNASSIGNED, capacity),
        "ins_client": full(-1, capacity),
        "local_seq": full(0, capacity),
        "rem_seq": full(DEV_NO_REMOVE, capacity),
        "rem_local_seq": full(0, capacity),
        "origin_op": full(-1, capacity),
        "origin_off": full(0, capacity),
    }
    rem_clients = full(-1, capacity, overlap_slots)
    anno = full(-1, capacity, anno_slots)
    count = np.zeros(k, np.int32)
    mins = np.zeros(k, np.int32)
    seqs = np.zeros(k, np.int32)
    for j, (_, cols, mseq, cseq) in enumerate(items):
        n = len(cols["length"])
        for name, arr in out.items():
            arr[j, :n] = cols[name]
        rem_clients[j, :n, 0] = cols["rem_client"]
        if "rem_overlap" in cols:
            ov = cols["rem_overlap"]
            w = min(ov.shape[1], overlap_slots - 1)
            rem_clients[j, :n, 1:1 + w] = ov[:, :w]
        if "anno" in cols:
            anno[j, :n] = cols["anno"]
        count[j], mins[j], seqs[j] = n, mseq, cseq
    return interop.doc_state_from_numpy(dict(
        out, rem_clients=rem_clients, anno=anno, count=count, min_seq=mins,
        seq=seqs, overflow=np.zeros(k, np.bool_)), device)


def _repad_batch(rows: DocState, capacity: int) -> DocState:
    """Re-pad a [n, ...] sub-batch to a larger capacity (group promotion)."""
    n = rows.length.shape[0]
    base = make_state(capacity, anno_slots=rows.anno_slots,
                      overlap_slots=rows.overlap_slots, batch=n,
                      device=rows.length.device)
    c = rows.capacity

    def widen(dst, src):
        if src.dim() <= 1:
            return src
        dst[:, :c] = src
        return dst

    return _tree_map(widen, base, rows)


# The batched apply, wrapped in the retrace probe: serving windows bucket
# to a fixed (lanes, capacity, T) grid, so a new input signature after
# warm-up is an unplanned shape, counted as kernel.retrace_count.
_apply_keep_batched = JitRetraceProbe(kernel.apply_ops_batched_keep,
                                      name="kernel.merge_apply_batched")

# The paged apply (kernel.apply_ops_paged: gather by page id, the batched
# scan apply, scatter by page id into the pool in place). Shapes bucket to
# (pow2 docs, pow2 pages, T grid), the same contract as the bucketed probe.
_apply_paged_probe = JitRetraceProbe(kernel.apply_ops_paged,
                                     name="kernel.paged_apply")


class _PagedFlushGroup:
    """One paged fast flush's virtual merge bucket: every channel whose
    page table rounds to the same pow2 page-count class this flush.
    `lanes` pow2-pads the member count, the plane width every window of
    the flush stages against. Rebuilt per flush by
    MergeLaneStore.begin_flush_groups."""

    __slots__ = ("p2", "keys", "lane_of")

    def __init__(self, p2: int):
        self.p2 = p2
        self.keys: List[tuple] = []
        self.lane_of: Dict[tuple, int] = {}

    def admit(self, key: tuple) -> int:
        lane = self.lane_of.get(key)
        if lane is None:
            lane = len(self.keys)
            self.lane_of[key] = lane
            self.keys.append(key)
        return lane

    @property
    def lanes(self) -> int:
        return pow2_pages(max(1, len(self.keys)))


class MergeLaneStore:
    """All merge lanes across capacity buckets + the shared payload table."""

    def __init__(self, capacities: Tuple[int, ...] = (64, 256, 1024),
                 lanes_per_bucket: int = 8,
                 t_buckets: Tuple[int, ...] = DEFAULT_T_BUCKETS,
                 paged: bool = False,
                 page_rows: Optional[int] = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.capacities = tuple(capacities)
        self.t_buckets = tuple(t_buckets)
        # Paged lane memory: rows live in a page pool with per-document
        # page tables instead of the capacity-bucket grid, so growth is
        # "append a page" and the promote/fold/rescue ceremony leaves the
        # apply path. The bucket list stays empty in paged mode.
        self.paged = bool(paged)
        self.pages: Optional[PagedMergeStore] = None
        if self.paged:
            self.pages = PagedMergeStore(page_rows=page_rows or PAGE_ROWS,
                                         device=self.device)
        self.buckets = [] if self.paged else [
            _MergeBucket(c, lanes_per_bucket, self.device)
            for c in self.capacities]
        # Paged-mode telemetry: host rescues (annotate-ring / overlap-slot
        # exhaustion, the one fold/rescue-class event left) and budgeted
        # defrag passes.
        self.paged_rescues = 0
        self.page_compactions = 0
        self.fold_rescue_dispatches = 0  # device recovery dispatches
        self.flush_groups: List[_PagedFlushGroup] = []
        self._flush_group_of: Dict[int, int] = {}
        self.payloads = PayloadTable()
        self.builder = OpBuilder(self.payloads)
        self.where: Dict[tuple, Tuple[int, int]] = {}  # key -> (bucket, lane)
        self.opaque: set = set()  # lanes dropped (unparseable op seen)
        self.overflow_drops = 0  # lanes degraded after exhausting buckets
        self.flushes_since_compact = 0
        self.compact_every = 8
        self.folds = 0            # lanes host-folded (zamboni pack)
        self.fold_rows_reclaimed = 0
        # Overflow below this capacity promotes; at/above it folds.
        self.fold_min_capacity = min(
            (c for c in self.capacities if c >= 256),
            default=self.capacities[-1])
        # Payload ids of each lane's latest fold/rescue/seed generation,
        # freed when the next generation supersedes them.
        self._fold_payloads: Dict[tuple, List[int]] = {}
        # Async-summary safety: while an extraction worker resolves the
        # shared payload table, frees defer (a recycled id would
        # materialize the wrong text); they drain at the next free once
        # the last guard releases.
        self._extract_guards = 0
        self._deferred_frees: List[int] = []
        self._guard_lock = threading.Lock()
        # Fast-path arena blocks pin a flush's raw wire buffers until
        # every referencing lane moves off them; blocks older than
        # block_age_ticks compact ticks materialize their payloads.
        self._lane_blocks: Dict[tuple, set] = {}   # key -> blocks
        self._blocks: List[list] = []              # [ticks, block]
        self.block_age_ticks = 8                   # x compact_every flushes
        self.blocks_aged = 0
        # Demotion-fold memo: (count, min_seq) at the last fold attempt
        # that could not demote; retried only when it changes.
        self._fold_skip: Dict[tuple, tuple] = {}
        # Host fold work cap per compact tick.
        self.fold_budget_per_tick = 64
        # Major payload-id collection: every N compact ticks, if the
        # table grew past double its post-collection size.
        self.payload_compact_every = 64
        self.payload_compact_min_entries = 4096
        self._ticks_since_payload_compact = 0
        self._entries_after_last_compact = 0
        self.payload_compactions = 0
        # A chunked apply() holds HostOps numbered against the current
        # table: the collection runs only between applies.
        self._in_apply = False
        # Monotone change generations per channel (incremental
        # summarization extracts only channels past a consumer's epoch).
        self.change_gen: Dict[tuple, int] = {}
        self._gen_counter = 0
        # Summarize epoch: key -> (gen_at_dispatch, chunk_chars, snapshot)
        # of each lane's last assembly; a clean lane skips extraction.
        # Returned snapshots are shared: callers treat them as immutable.
        self._snap_cache: Dict[tuple, tuple] = {}
        self.last_summarized_gen: Dict[tuple, int] = {}
        # Lanes seeded from summaries that still carry contended client
        # metadata: the read path's artifact publisher skips them.
        self.catchup_unsafe: set = set()

    # -- lane admission ----------------------------------------------------
    def lane_for(self, key: tuple) -> Tuple[int, int]:
        if key not in self.where:
            if self.paged:
                # One blank page + a page-table entry; (-1, -1) keeps the
                # (bucket, lane) arity (placement lives in the table).
                self.pages.ensure(key)
                self.where[key] = (-1, -1)
            else:
                bucket = 0
                lane = self.buckets[bucket].alloc(key)
                self.where[key] = (bucket, lane)
        return self.where[key]

    # -- paged fast-flush group directory ----------------------------------
    def begin_flush_groups(self) -> None:
        """Reset the per-flush page-group directory (at the top of every
        paged lane resolution)."""
        self.flush_groups: List[_PagedFlushGroup] = []
        self._flush_group_of: Dict[int, int] = {}

    def flush_lane_for(self, key: tuple, n_ops: int) -> Tuple[int, int]:
        """Paged fast-flush admission: the channel's (group, lane) for
        this flush. Pre-grows the document's pages for the flush's worst
        case (2 rows per op + slack), so its pow2 page class is stable
        until the dispatch."""
        pg = self.pages
        self.lane_for(key)
        pg.ensure_rows(key, pg.counts.get(key, 0) + 2 * n_ops + 8)
        p2 = pow2_pages(len(pg.tables[key]))
        g = self._flush_group_of.get(p2)
        if g is None:
            g = len(self.flush_groups)
            self._flush_group_of[p2] = g
            self.flush_groups.append(_PagedFlushGroup(p2))
        return g, self.flush_groups[g].admit(key)

    def mark_dirty(self, key: tuple) -> None:
        self._gen_counter += 1
        self.change_gen[key] = self._gen_counter

    def dirty_keys(self) -> set:
        """Channels whose change generation advanced past the summarize
        epoch. Snapshots `where` first (monitor probes call this from
        another thread); the epoch read rides the summarize guard."""
        with self._guard_lock:
            epoch = dict(self.last_summarized_gen)
        return {k for k in list(self.where)
                if self.change_gen.get(k, 0) > epoch.get(k, 0)}

    def cached_blob_count(self) -> int:
        """Assembled snapshots held by the summarize blob cache."""
        with self._guard_lock:
            return len(self._snap_cache)

    def drop(self, key: tuple) -> None:
        """Mark a channel opaque: an op arrived the server cannot model;
        its device lane is abandoned."""
        if key in self.where:
            b, lane = self.where.pop(key)
            if self.paged:
                self.pages.free_all(key)
            else:
                self.buckets[b].free(lane)
        self._forget_lane_payloads(key)
        self.opaque.add(key)

    def _forget_lane_payloads(self, key: tuple) -> None:
        """The lane's rows are gone: free its fold generation and release
        every block ref. The blob-cache eviction rides the summarize
        guard, strictly after the caller popped `where`, so an async
        adoption can never resurrect a dropped lane's entry."""
        self.free_payloads(self._fold_payloads.pop(key, ()))
        for block in self._lane_blocks.pop(key, ()):
            self._release_block_ref(block, key)
        self._fold_skip.pop(key, None)
        self.catchup_unsafe.discard(key)
        with self._guard_lock:
            self._snap_cache.pop(key, None)
            self.last_summarized_gen.pop(key, None)

    def _free_payload(self, op_id: int) -> None:
        self.free_payloads((op_id,))

    def free_payloads(self, ids) -> None:
        """Free through the guard (one lock round per batch): deferred
        while an async summary worker may still resolve the ids; the
        backlog drains when clear. Called from the sequencing thread."""
        with self._guard_lock:
            if self._extract_guards:
                self._deferred_frees.extend(ids)
                return
            backlog, self._deferred_frees = self._deferred_frees, []
        for i in backlog:
            self.payloads.free(i)
        for i in ids:
            self.payloads.free(i)

    def extract_guard_acquire(self) -> None:
        with self._guard_lock:
            self._extract_guards += 1

    def extract_guard_release(self) -> None:
        """Worker-thread safe: only decrements; the deferred backlog
        drains on the sequencing thread at the next free."""
        with self._guard_lock:
            self._extract_guards -= 1

    def _swap_fold_payloads(self, key: tuple, new_ids: set,
                            keep_ops=()) -> None:
        """Adopt a fold/rescue generation's payload ids for `key`, freeing
        the superseded generation, and release the lane's block refs
        (except blocks holding ids of `keep_ops`, a window the overflow
        fold re-ran on the device)."""
        self.free_payloads([op_id
                            for op_id in self._fold_payloads.pop(key, ())
                            if op_id not in new_ids])
        self._fold_payloads[key] = sorted(new_ids)
        refs = self._lane_blocks.get(key)
        if refs:
            keep_ids = {op.op_id for op in keep_ops}
            kept = set()
            for block in list(refs):
                # Membership against the block's recorded ids for this
                # lane (freed ids recycle to unrelated ops).
                if keep_ids and not keep_ids.isdisjoint(
                        block.lane_ids.get(key, ())):
                    kept.add(block)
                else:
                    self._release_block_ref(block, key)
            if kept:
                self._lane_blocks[key] = kept
            else:
                self._lane_blocks.pop(key, None)

    def note_block(self, block, lane_ids: Dict[tuple, list]) -> None:
        """Register a fast-flush arena block (host.MergeArenaBlock) for
        aging; lane_ids maps each channel key to the block-global op ids
        admitted for it."""
        block.lane_ids = lane_ids
        self._blocks.append([0, block])
        for key in lane_ids:
            self._lane_blocks.setdefault(key, set()).add(block)

    def _release_block_ref(self, block, key: tuple) -> None:
        """A lane's rows no longer reference this block: free its ids.
        After the last lane departs, the next aging pass drops the block."""
        self.free_payloads(block.lane_ids.pop(key, ()))

    def compact_payload_ids(self) -> bool:
        """Major collection: renumber the live payload ids and rebuild the
        table (which otherwise grows one slot per ingested op). Collects
        the referenced ids from the origin_op and anno planes (rows past
        count are blank after compaction), materializes block-backed
        payloads, renumbers the planes with a searchsorted remap and
        drops every block. Skipped while an extraction guard is held.
        Returns True when it ran."""
        with self._guard_lock:
            if self._extract_guards:
                return False
            self._deferred_frees = []  # the table is rebuilt wholesale
        per_bucket: List[Optional[tuple]] = []
        referenced: set = set()
        pool_planes: Optional[tuple] = None
        if self.paged:
            # Free pages and padding rows are blank (-1 planes), so the
            # pool's unique ids are the live reference set.
            op_np = _host(self.pages.pool.origin_op)
            an_np = _host(self.pages.pool.anno)
            pool_planes = (op_np, an_np)
            referenced.update(int(v) for v in np.unique(op_np) if v >= 0)
            referenced.update(int(v) for v in np.unique(an_np) if v >= 0)
        for bucket in self.buckets:
            if not any(k is not None for k in bucket.used):
                per_bucket.append(None)
                continue
            op_np = _host(bucket.state.origin_op)
            an_np = _host(bucket.state.anno)
            per_bucket.append((op_np, an_np))
            referenced.update(int(v) for v in np.unique(op_np) if v >= 0)
            referenced.update(int(v) for v in np.unique(an_np) if v >= 0)
        order = sorted(referenced)
        sorted_old = np.asarray(order, np.int64)
        new_entries = [self.payloads.get(old) for old in order]

        def renumber(plane):
            live = plane >= 0
            idx = np.searchsorted(sorted_old, plane)
            return torch.from_numpy(
                np.where(live, idx, -1).astype(np.int32)).to(self.device)

        if pool_planes is not None:
            op_np, an_np = pool_planes
            self.pages.adopt_pool(self.pages.pool._replace(
                origin_op=renumber(op_np), anno=renumber(an_np)))
        for bucket, host in zip(self.buckets, per_bucket):
            if host is None:
                continue
            op_np, an_np = host
            bucket.state = bucket.state._replace(
                origin_op=renumber(op_np), anno=renumber(an_np))
        remap = {old: new for new, old in enumerate(order)}
        self._fold_payloads = {
            key: sorted(remap[i] for i in ids if i in remap)
            for key, ids in self._fold_payloads.items()}
        self.payloads.entries = new_entries
        self.payloads.free_ids = []
        self._blocks = []
        self._lane_blocks = {}
        self._entries_after_last_compact = len(new_entries)
        self.payload_compactions += 1
        return True

    def _age_blocks(self) -> None:
        from ..mergetree.host import _UNSET
        keep = []
        for rec in self._blocks:
            rec[0] += 1
            block = rec[1]
            if not block.lane_ids:
                continue  # every lane departed; drop the registry ref
            if rec[0] < self.block_age_ticks:
                # fast_text's decoded-arena cache serves one tick window.
                block._ascii_text = _UNSET
                keep.append(rec)
                continue
            # An old block still referenced (idle lanes never fold):
            # materialize its remaining payloads so the raw buffers free;
            # the ids join the lane's generation.
            for key in list(block.lane_ids):
                ids = block.lane_ids.pop(key)
                for op_id in ids:
                    self.payloads.entries[op_id] = block.resolve(op_id)
                self._fold_payloads.setdefault(key, []).extend(ids)
                refs = self._lane_blocks.get(key)
                if refs is not None:
                    refs.discard(block)
                    if not refs:
                        self._lane_blocks.pop(key, None)
            self.blocks_aged += 1
        self._blocks = keep

    @staticmethod
    def _seed_ids(cols: dict) -> set:
        ids = {int(i) for i in cols["origin_op"].tolist()}
        if "anno" in cols:
            ids.update(int(i) for i in np.unique(cols["anno"]) if i >= 0)
        return ids

    def _scalar(self, v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=self.device)

    def seed(self, key: tuple, entries, min_seq: int,
             current_seq: int) -> bool:
        """Bootstrap a lane from snapshot segments (a document whose
        content shipped in a summary rather than ops). Picks the smallest
        bucket with 2x headroom; unmodelable or oversized snapshots
        degrade the channel to opaque."""
        from ..mergetree.catchup import seed_host_cols
        from ..mergetree.state import state_from_numpy
        if key in self.where or key in self.opaque:
            return key in self.where
        if self.paged:
            return self._seed_paged(key, entries, min_seq, current_seq)
        allow_runs = matrix_base_key(key) is not None
        # No window to re-apply: the widest bucket may fill completely.
        b = self._seed_bucket_for(len(entries), last_slack=0)
        if b is None:
            self.opaque.add(key)
            return False
        bucket = self.buckets[b]
        try:
            cols = seed_host_cols(entries, self.payloads,
                                  anno_slots=bucket.state.anno_slots,
                                  allow_runs=allow_runs,
                                  allow_items=not allow_runs)
        except (Unmodelable, ValueError):  # host content only
            self.opaque.add(key)
            return False
        row = state_from_numpy(
            cols, bucket.capacity, anno_slots=bucket.state.anno_slots,
            device=self.device)._replace(
            min_seq=self._scalar(min_seq), seq=self._scalar(current_seq))
        lane = bucket.alloc(key)
        bucket.put_row(lane, row, count_hint=len(cols["length"]))
        self.where[key] = (b, lane)
        self.mark_dirty(key)
        self._mark_catchup_safety(key, entries)
        # The seed generation is tracked like a fold's.
        self._swap_fold_payloads(key, self._seed_ids(cols))
        return True

    def _mark_catchup_safety(self, key: tuple, entries) -> None:
        """Summary entries carrying contended client metadata mix two
        client ordinal spaces on the device: the lane is catch-up unsafe."""
        if any(e.get("client") is not None
               or e.get("removedClient") is not None
               or e.get("removedOverlapClients")
               for e in entries):
            self.catchup_unsafe.add(key)

    def _seed_paged(self, key: tuple, entries, min_seq: int,
                    current_seq: int) -> bool:
        """Paged snapshot seed: any size fits (more pages); only
        unmodelable payloads degrade the channel."""
        from ..mergetree.catchup import seed_host_cols
        from ..mergetree.state import state_from_numpy
        pg = self.pages
        allow_runs = matrix_base_key(key) is not None
        try:
            cols = seed_host_cols(entries, self.payloads,
                                  anno_slots=pg.anno_slots,
                                  allow_runs=allow_runs,
                                  allow_items=not allow_runs)
        except (Unmodelable, ValueError):  # host content only
            self.opaque.add(key)
            return False
        n = len(cols["length"])
        capacity = pages_for(n, pg.page_rows) * pg.page_rows
        row = state_from_numpy(
            cols, capacity, anno_slots=pg.anno_slots,
            device=self.device)._replace(
            min_seq=self._scalar(min_seq), seq=self._scalar(current_seq))
        self.lane_for(key)
        pg.put_row(key, row, count=n)
        self.mark_dirty(key)
        self._mark_catchup_safety(key, entries)
        self._swap_fold_payloads(key, self._seed_ids(cols))
        return True

    # -- batched apply with overflow recovery ------------------------------
    def apply(self, streams: Dict[tuple, List[HostOp]]) -> None:
        """Apply per-lane op streams; windows longer than the largest
        T-bucket chunk into successive device passes."""
        self._in_apply = True
        try:
            self._apply(streams)
        finally:
            self._in_apply = False

    def _apply(self, streams: Dict[tuple, List[HostOp]]) -> None:
        if self.paged:
            self._apply_paged(streams)
            with tracing.span("serving.gc", hist="serving.gc"):
                self.flushes_since_compact += 1
                if self.flushes_since_compact >= self.compact_every:
                    self.compact_all()
            return
        max_t = self.t_buckets[-1]
        while streams:
            window: Dict[tuple, List[HostOp]] = {}
            rest: Dict[tuple, List[HostOp]] = {}
            for key, ops in streams.items():
                if not ops:
                    continue
                window[key] = ops[:max_t]
                if len(ops) > max_t:
                    rest[key] = ops[max_t:]
            if not window:
                break
            self._apply_window(window)
            streams = rest

    def _apply_window(self, streams: Dict[tuple, List[HostOp]]) -> None:
        self._apply_streams(streams)
        with tracing.span("serving.gc", hist="serving.gc"):
            self.flushes_since_compact += 1
            if self.flushes_since_compact >= self.compact_every:
                self.compact_all()

    def _packed(self, streams: List[List[HostOp]], steps: int) -> PackedOps:
        return interop.packed_ops_from_numpy(pack_ops(streams, steps=steps),
                                             self.device)

    def _apply_streams(self, streams: Dict[tuple, List[HostOp]]) -> None:
        """One batched device pass per bucket; overflowing lanes recover
        by compact -> re-run -> promote. No GC tick here."""
        per_bucket: Dict[int, Dict[int, List[HostOp]]] = {}
        for key, ops in streams.items():
            if key in self.opaque or not ops:
                continue
            b, lane = self.lane_for(key)
            self.mark_dirty(key)
            per_bucket.setdefault(b, {})[lane] = ops

        for b, lane_ops in sorted(per_bucket.items()):
            bucket = self.buckets[b]
            with tracing.span("serving.pack", hist="serving.pack",
                              stage="merge-oppack", bucket=b):
                t = _bucket(max(len(v) for v in lane_ops.values()),
                            self.t_buckets)
                streams_list = [lane_ops.get(i, [])
                                for i in range(bucket.lanes)]
                packed = self._packed(streams_list, t)
            pre = bucket.state
            with tracing.span("serving.dispatch", hist="serving.dispatch",
                              stage="merge-apply", bucket=b):
                new_state = _apply_keep_batched(pre, packed)
            with tracing.span("serving.readback", hist="serving.readback",
                              stage="merge-overflow", bucket=b):
                over = _host(new_state.overflow)
            flagged = [i for i in range(bucket.lanes)
                       if over[i] and i in lane_ops]
            # Unconditional fold/rescue span: a clean window records the
            # stage at ~0.
            with tracing.span("serving.fold_rescue",
                              hist="serving.fold_rescue", bucket=b):
                if flagged:
                    # Adopt the clean lanes; roll flagged lanes back to
                    # their pre-window rows (one batched scatter).
                    new_state = _set_rows(new_state, flagged,
                                          _take(pre, flagged))
                bucket.state = new_state
                # Each applied op adds at most 2 rows (insert + split).
                for i, ops in lane_ops.items():
                    bucket.count_hint[i] += 2 * len(ops)
                if flagged:
                    self._recover_batch(b, {i: lane_ops[i]
                                            for i in flagged})

    # -- the paged apply path ----------------------------------------------
    def _apply_paged(self, streams: Dict[tuple, List[HostOp]]) -> None:
        """Apply per-lane op streams against the page pool. Growth is
        proven before the dispatch (each op adds at most 2 rows, so
        `ensure_rows(count + 2*ops)` appends the pages the worst case
        needs), documents group by pow2 page count, and a stream longer
        than the T grid rides one serve_paged_burst. The only overflow
        left is annotate-ring / overlap-slot exhaustion, handled by a
        rollback from the pre-view and the host rescue."""
        pg = self.pages
        groups: Dict[int, List[Tuple[tuple, List[HostOp]]]] = {}
        for key, ops in streams.items():
            if key in self.opaque or not ops:
                continue
            self.lane_for(key)
            self.mark_dirty(key)
            pg.ensure_rows(key, pg.counts.get(key, 0) + 2 * len(ops))
            p2 = pow2_pages(len(pg.tables[key]))
            groups.setdefault(p2, []).append((key, ops))
        for p2, items in sorted(groups.items()):
            self._apply_group_paged(p2, items)

    def _stage_paged_group(self, keys: List[tuple]):
        """Pow2-padded staging planes for one page-bucket group:
        (n_pad, pids [n_pad, p2], counts, mins, seqs, each [n_pad]).
        Padding rows carry page id -1 and zeroed scalars."""
        pg = self.pages
        p2 = pow2_pages(max(len(pg.tables[k]) for k in keys))
        n = len(keys)
        n_pad = pow2_pages(n)
        pids = np.full((n_pad, p2), -1, np.int32)
        pids[:n] = pg.page_ids_array(keys, p2)
        counts = np.zeros(n_pad, np.int32)
        mins = np.zeros(n_pad, np.int32)
        seqs = np.zeros(n_pad, np.int32)
        counts[:n], mins[:n], seqs[:n] = pg.scalars_arrays(keys)
        return n_pad, pids, counts, mins, seqs

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _apply_group_paged(self, p2: int,
                           items: List[Tuple[tuple, List[HostOp]]]) -> None:
        pg = self.pages
        max_t = self.t_buckets[-1]
        keys = [k for k, _ in items]
        longest = max(len(ops) for _, ops in items)
        t = _bucket(min(longest, max_t), self.t_buckets)
        k_chunks = -(-longest // t)
        n = len(keys)
        n_pad, pids, counts, mins, seqs = self._stage_paged_group(keys)
        with tracing.span("serving.pack", hist="serving.pack",
                          stage="paged-oppack", pages=p2):
            pad_streams: List[List[HostOp]] = [ops for _, ops in items]
            pad_streams += [[] for _ in range(n_pad - n)]
            if k_chunks == 1:
                staged = self._packed(pad_streams, t)
            else:
                # [K, B, T] chunks on the T grid, K padded to a power of
                # two with all-NOOP chunks (an exact identity).
                k_pad = pow2_pages(k_chunks)
                chunks = [pack_ops([s[c * t:(c + 1) * t]
                                    for s in pad_streams], steps=t)
                          for c in range(k_chunks)]
                chunks += [pack_ops([[] for _ in pad_streams], steps=t)
                           for _ in range(k_pad - k_chunks)]
                staged = interop.packed_ops_from_numpy(
                    {f: np.stack([c[f] for c in chunks])
                     for f in PackedOps._fields}, self.device)
        stats_on = device_stats.enabled()
        with tracing.span("serving.dispatch", hist="serving.dispatch",
                          stage="paged-apply", pages=p2):
            args = (pg.pool, self._put(pids), self._put(counts),
                    self._put(mins), self._put(seqs), staged)
            st_dev = None
            if k_chunks == 1:
                res = _apply_paged_probe(*args, stats=stats_on)
                (pool2, _pids2, c2, m2, s2, over, pre) = res[:7]
                if stats_on:
                    st_dev = res[7]
            else:
                with compile_ledger.track("serve.paged_burst",
                                          serve_step.serve_paged_burst):
                    res = serve_step.serve_paged_burst(*args, stats_on)
                (pool2, _pids2, c2, m2, s2, over, _over_k, pre) = res[:8]
                if stats_on:
                    st_dev = res[8]
            pg.adopt_pool(pool2)
        with tracing.span("serving.readback", hist="serving.readback",
                          stage="paged-overflow", pages=p2):
            # One device-to-host copy for the four [n_pad] planes.
            back = _host(torch.stack([over.to(torch.int32), c2, m2, s2]))
            over_np = back[0, :n] != 0
            c2n, m2n, s2n = back[1, :n], back[2, :n], back[3, :n]
            if st_dev is not None:
                # A K-chunk burst stacks per-chunk vectors: op kinds sum
                # across chunks; overflow / rows-live are the last
                # chunk's (sticky carry flags).
                st_np = _host(st_dev)
                if st_np.ndim == 2:
                    st_np = np.concatenate(
                        [st_np[:, :6].sum(0), st_np[-1, 6:]])
                host_vec = np.zeros(device_stats.N_PAGED, np.int64)
                all_kinds = np.fromiter(
                    (op.kind for _, ops in items for op in ops),
                    np.int64)
                host_vec[:6] = np.bincount(all_kinds, minlength=7)[1:7]
                host_vec[6] = int(over_np.sum())
                host_vec[7] = int(st_np[7])  # fill: device-only fact
                device_stats.fold_paged(st_np, host_vec)
        with tracing.span("serving.fold_rescue",
                          hist="serving.fold_rescue", pages=p2):
            good = np.flatnonzero(~over_np)
            if good.size:
                pg.adopt_scalars([keys[j] for j in good],
                                 c2n[good], m2n[good], s2n[good])
                for j in good.tolist():
                    key = keys[j]
                    pg.ops_since_compact[key] = \
                        pg.ops_since_compact.get(key, 0) \
                        + len(items[j][1])
                pg.release_trailing_many(keys[j] for j in good.tolist())
            flagged = np.flatnonzero(over_np).tolist()
            if flagged:
                self._recover_paged(keys, items, pids, pre, flagged)

    def _recover_paged(self, keys, items, pids: np.ndarray, pre: DocState,
                       flagged: List[int]) -> None:
        """Rare unpredicted overflow (annotate ring / overlap slots): roll
        the flagged documents' pages back from the retained pre-view (a
        gathered copy, one pow2-padded scatter), then host-rescue each
        with this stream's ops."""
        pg = self.pages
        self.fold_rescue_dispatches += 1
        k = len(flagged)
        with tracing.span("serving.paged_rescue",
                          hist="serving.paged_rescue", flagged=k) as _sp:
            k_pad = pow2_pages(k)
            sel = np.asarray(flagged + [flagged[0]] * (k_pad - k), np.int64)
            sub_pids = pids[sel].copy()
            sub_pids[k:] = -1  # padding rows scatter to no page
            sub_pre = _take(pre, sel)
            pg.adopt_pool(kernel.rollback_pages(pg.pool,
                                                self._put(sub_pids),
                                                sub_pre))
            dropped = 0
            for j in flagged:
                key = keys[j]
                row = _row(pre, j)
                self.paged_rescues += 1
                increment("serving.paged_rescues")
                if self._rescue_paged(key, row, items[j][1]):
                    continue
                self.where.pop(key, None)
                pg.free_all(key)
                self._forget_lane_payloads(key)
                self.opaque.add(key)
                self.overflow_drops += 1
                dropped += 1
            if dropped:
                _sp.set(dropped=dropped)

    def _rescue_paged(self, key: tuple, row: DocState, ops) -> bool:
        """_rescue_lane's contract, page-backed: fold the pre-window row
        on the host, re-apply this stream's ops host-side (the chunked
        applier: scan_apply.cu on the card), reseed into exactly the
        pages the folded content needs."""
        from ..mergetree.catchup import (apply_host_ops, coalesce_entries,
                                         extract_entries, seed_host_cols)
        from ..mergetree.constants import DEV_UNASSIGNED, UNASSIGNED_SEQ
        from ..mergetree.state import state_from_numpy
        pg = self.pages
        try:
            mseq = int(row.min_seq)
            cseq = int(row.seq)
            entries = coalesce_entries(
                extract_entries(row, self.payloads, mseq, fold=True))
            new_entries = coalesce_entries(
                apply_host_ops(entries, ops, self.payloads, mseq, cseq,
                               device=self.device))
        except _DEGRADE:
            return False
        mseq2 = max([mseq] + [op.msn for op in ops])
        cseq2 = max([cseq] + [op.seq for op in ops
                              if op.seq not in (DEV_UNASSIGNED,
                                                UNASSIGNED_SEQ)])
        try:
            cols = seed_host_cols(new_entries, self.payloads,
                                  anno_slots=pg.anno_slots)
        except (Unmodelable, ValueError):  # host content only
            return False
        n = len(cols["length"])
        capacity = pages_for(n, pg.page_rows) * pg.page_rows
        row2 = state_from_numpy(
            cols, capacity, anno_slots=pg.anno_slots,
            device=self.device)._replace(
            min_seq=self._scalar(mseq2), seq=self._scalar(cseq2))
        pg.put_row(key, row2, count=n)
        self.mark_dirty(key)
        self.fold_rescue_dispatches += 1  # the per-lane put_row dispatch
        self._swap_fold_payloads(key, self._seed_ids(cols))
        pg.ops_since_compact.pop(key, None)
        return True

    def _compact_tick_paged(self) -> None:
        """Page-granular zamboni tick: defrags fragmented documents,
        ranked by ops applied since their last pass, under the per-tick
        budget, releasing the pages the left-pack empties."""
        pg = self.pages
        cands = [key for key, v in pg.ops_since_compact.items()
                 if v > 0 and key in pg.tables]
        if not cands:
            return
        cands.sort(key=lambda k: -pg.ops_since_compact[k])
        cands = cands[:self.fold_budget_per_tick]
        groups: Dict[int, List[tuple]] = {}
        for key in cands:
            groups.setdefault(
                pow2_pages(len(pg.tables[key])), []).append(key)
        for _p2, keys in sorted(groups.items()):
            n = len(keys)
            _n_pad, pids, counts, mins, seqs = \
                self._stage_paged_group(keys)
            pool2, _, c2 = kernel.compact_pages(
                pg.pool, self._put(pids), self._put(counts),
                self._put(mins), self._put(seqs))
            pg.adopt_pool(pool2)
            c2n = _host(c2)[:n]
            # The defrag tick's reclamation (disjoint from the extract
            # path's device.extract.rows_reclaimed).
            if device_stats.enabled():
                increment("zamboni.rows_reclaimed",
                          int((counts[:n].astype(np.int64)
                               - c2n.astype(np.int64)).sum()))
            pg.adopt_scalars(keys, c2n, mins[:n], seqs[:n])
            pg.release_trailing_many(keys)
            for key in keys:
                pg.ops_since_compact.pop(key, None)
            self.page_compactions += n

    def paged_stats(self) -> dict:
        """The paged store's bench/monitor surface."""
        pg = self.pages
        return {
            "pages_in_use": pg.pages_in_use,
            "pool_pages": pg.allocator.capacity,
            "page_fill_frac": round(pg.page_fill_frac(), 4),
            "page_rows": pg.page_rows,
            "paged_rescues": self.paged_rescues,
            "page_compactions": self.page_compactions,
            "pool_grows": pg.pool_grows,
        }

    @staticmethod
    def _pad_pow2(sub: DocState, packed: PackedOps, n: int,
                  capacity: int):
        """Pad a recovery sub-batch to a power-of-two lane count with
        empty rows + NOOP streams: the apply shapes stay bounded at log2
        variants."""
        n_pad = 1 << max(n - 1, 0).bit_length()
        if n_pad == n:
            return sub, packed
        base = make_state(capacity, anno_slots=sub.anno_slots,
                          overlap_slots=sub.overlap_slots, batch=n_pad,
                          device=sub.length.device)

        def fill(full, s):
            full[:n] = s
            return full

        sub = _tree_map(fill, base, sub)
        packed = _tree_map(lambda x: torch.cat(
            [x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))], 0), packed)
        return sub, packed

    def _recover_batch(self, b: int,
                       lane_ops: Dict[int, List[HostOp]]) -> None:
        """Batched overflow recovery (one lane is a batch of one): stack
        the flagged lanes' pre-window rows into a sub-batch, compact and
        re-run them together, host-fold at or above fold_min_capacity,
        then group-promote the still-overflowing rest upward; rescue on
        the host at exhaustion, else opaque."""
        lanes = sorted(lane_ops)
        n = len(lanes)
        bucket = self.buckets[b]
        sub = _take(bucket.state, lanes)
        t = _bucket(max(len(v) for v in lane_ops.values()), self.t_buckets)
        packed = self._packed([lane_ops[i] for i in lanes], t)
        sub, packed = self._pad_pow2(sub, packed, n, bucket.capacity)
        # Attempt 1: compact in place and re-run at this capacity.
        self.fold_rescue_dispatches += 1
        compacted = kernel.compact_batched(sub)
        redone = _apply_keep_batched(compacted, packed)
        over = _host(redone.overflow)
        ok_j = [j for j in range(len(lanes)) if not over[j]]
        bad_j = [j for j in range(len(lanes)) if over[j]]
        if ok_j:
            # Exact counts ride the same sync as the overflow read.
            cnts = _host(redone.count)
            bucket.put_rows([lanes[j] for j in ok_j], _take(redone, ok_j),
                            count_hints=cnts[np.asarray(ok_j)])
        # Attempt 2 (at or above fold_min_capacity): host-fold acked runs
        # and re-run at the same capacity; below it, promotion is cheaper.
        if bad_j and bucket.capacity >= self.fold_min_capacity:
            bad_j = self._fold_rerun_batch(bucket, lanes, bad_j,
                                           compacted, packed, lane_ops)
        carried = [bucket.used[lanes[j]] for j in bad_j]  # keys carrying up
        # Row index into `compacted` + this window's ops per carried key,
        # for the host rescue at exhaustion.
        rescue_src = {bucket.used[lanes[j]]: (j, lane_ops[lanes[j]])
                      for j in bad_j}
        keep = bad_j                 # their row indices into src/packed
        bucket.free_many([lanes[j] for j in bad_j])
        src = compacted
        for nb in range(b + 1, len(self.buckets)):
            if not carried:
                return
            n = len(keep)
            src = _take(src, keep)
            packed = _take(packed, keep)
            target = self.buckets[nb]
            wide = _repad_batch(src, target.capacity)
            wide, packed = self._pad_pow2(wide, packed, n, target.capacity)
            self.fold_rescue_dispatches += 1
            redone = _apply_keep_batched(wide, packed)
            over = _host(redone.overflow)
            ok_k = [k for k in range(len(carried)) if not over[k]]
            if ok_k:
                new_lanes = target.alloc_many([carried[k] for k in ok_k])
                target.put_rows(new_lanes, _take(redone, ok_k),
                                count_hints=_host(redone.count)[
                                    np.asarray(ok_k)])
                for k, nl in zip(ok_k, new_lanes):
                    self.where[carried[k]] = (nb, nl)
            keep = [k for k in range(len(carried)) if over[k]]
            carried = [carried[k] for k in keep]
            src = wide
        for key in carried:
            j, ops = rescue_src[key]
            row = _row(compacted, j)
            if self._rescue_lane(key, row, ops):
                continue
            self.where.pop(key, None)
            self._forget_lane_payloads(key)
            self.opaque.add(key)
            self.overflow_drops += 1

    def _fold_rerun_batch(self, bucket, lanes: List[int], bad_j: List[int],
                          compacted: DocState, packed,
                          lane_ops: Dict[int, List[HostOp]]) -> List[int]:
        """Overflow attempt 2: fold the flagged lanes' acked runs on the
        host (coalesce_entries) and re-run this window at the same
        capacity, batched. Returns the lane indices that still overflow.
        One device-to-host slice in, one batched apply + one put_rows
        out."""
        from ..mergetree.catchup import (coalesce_entries, extract_entries,
                                         seed_host_cols)
        host_rows = _tree_map(lambda x: x.cpu(), _take(compacted, bad_j))
        folded: List[tuple] = []  # (j, key, cols, mseq, cseq)
        for k, j in enumerate(bad_j):
            key = bucket.used[lanes[j]]
            row = _row(host_rows, k)
            mseq = int(row.min_seq)
            cseq = int(row.seq)
            allow_runs = matrix_base_key(key) is not None
            try:
                entries = coalesce_entries(
                    extract_entries(row, self.payloads, mseq, fold=True))
                # Re-run headroom: each window op costs at most 2 rows.
                need = len(entries) + 2 * len(lane_ops[lanes[j]]) + 8
                if need > bucket.capacity:
                    continue
                cols = seed_host_cols(
                    entries, self.payloads,
                    anno_slots=int(row.anno.shape[-1]),
                    allow_runs=allow_runs, allow_items=not allow_runs)
            except (Unmodelable, ValueError):  # host rows: no kernel here
                continue  # ring depth, odd payloads: promotion handles it
            folded.append((j, key, cols, mseq, cseq))
        if not folded:
            return bad_j
        rows = _stack_seed_rows(
            [(key, cols, ms, cs) for _, key, cols, ms, cs in folded],
            bucket.capacity, bucket.state.anno_slots,
            bucket.state.overlap_slots, self.device)
        sub_packed = _take(packed, [j for j, *_ in folded])
        rows, sub_packed = self._pad_pow2(rows, sub_packed, len(folded),
                                          bucket.capacity)
        self.fold_rescue_dispatches += 1
        redone = _apply_keep_batched(rows, sub_packed)
        over = _host(redone.overflow)
        adopted = [k for k in range(len(folded)) if not over[k]]
        if adopted:
            bucket.put_rows([lanes[folded[k][0]] for k in adopted],
                            _take(redone, adopted),
                            count_hints=[
                                len(folded[k][2]["length"])
                                + 2 * len(lane_ops[lanes[folded[k][0]]])
                                for k in adopted])
            self.folds += len(adopted)
            for k in adopted:
                # Reseeded rows: a cached summary blob is stale.
                self.mark_dirty(folded[k][1])
        counts = _host(host_rows.count)
        bad_pos = {j: k for k, j in enumerate(bad_j)}
        for k, (j, key, cols, _, _) in enumerate(folded):
            if over[k]:
                # The re-run still overflowed: this generation's seed
                # payloads were never adopted.
                self.free_payloads(self._seed_ids(cols))
            else:
                self._swap_fold_payloads(key, self._seed_ids(cols),
                                         keep_ops=lane_ops[lanes[j]])
                self.fold_rows_reclaimed += (
                    int(counts[bad_pos[j]]) - len(cols["length"]))
        done = {folded[k][0] for k in adopted}
        return [j for j in bad_j if j not in done]

    def _rescue_lane(self, key: tuple, row: DocState, ops) -> bool:
        """Last resort before opaque: fold the lane on the host (annotate
        rings resolve into props, acked runs coalesce), re-apply this
        window's ops with the chunked escalating applier (scan_apply.cu
        on the card), and reseed into the smallest fitting bucket. A
        kernel's refusal or launch error propagates."""
        from ..mergetree.catchup import (apply_host_ops, coalesce_entries,
                                         extract_entries, seed_host_cols)
        from ..mergetree.constants import DEV_UNASSIGNED, UNASSIGNED_SEQ
        from ..mergetree.state import state_from_numpy
        try:
            mseq = int(row.min_seq)
            cseq = int(row.seq)
            entries = coalesce_entries(
                extract_entries(row, self.payloads, mseq, fold=True))
            new_entries = coalesce_entries(
                apply_host_ops(entries, ops, self.payloads, mseq, cseq,
                               device=self.device))
        except _DEGRADE:
            return False
        mseq2 = max([mseq] + [op.msn for op in ops])
        cseq2 = max([cseq] + [op.seq for op in ops
                              if op.seq not in (DEV_UNASSIGNED,
                                                UNASSIGNED_SEQ)])
        # The smallest bucket with 2x headroom; the widest accepts n + 8.
        nb = self._seed_bucket_for(len(new_entries))
        if nb is None:
            return False
        bucket = self.buckets[nb]
        try:
            cols = seed_host_cols(new_entries, self.payloads,
                                  anno_slots=bucket.state.anno_slots)
        except (Unmodelable, ValueError):  # host content only
            return False
        row2 = state_from_numpy(
            cols, bucket.capacity, anno_slots=bucket.state.anno_slots,
            device=self.device)._replace(
            min_seq=self._scalar(mseq2), seq=self._scalar(cseq2))
        lane = bucket.alloc(key)
        bucket.put_row(lane, row2, count_hint=len(new_entries))
        self.where[key] = (nb, lane)
        self.mark_dirty(key)
        self.fold_rescue_dispatches += 1
        self._swap_fold_payloads(key, self._seed_ids(cols))
        return True

    def compact_all(self) -> None:
        """Zamboni every bucket, then pack crowded lanes on the host. Paged
        mode runs the page-granular tick instead (no whole-fleet pass, no
        host folds)."""
        if self.paged:
            self._compact_tick_paged()
            self._age_blocks()
            self._ticks_since_payload_compact += 1
            self.maybe_compact_payload_ids()
            self.flushes_since_compact = 0
            return
        for bucket in self.buckets:
            if any(k is not None for k in bucket.used):
                bucket.state = kernel.compact_batched(bucket.state)
                # Exact occupancy refresh (one small read per bucket).
                bucket.count_hint = _host(
                    bucket.state.count).astype(np.int64)
        self._fold_crowded()
        self._age_blocks()
        self._ticks_since_payload_compact += 1
        self.maybe_compact_payload_ids()
        self.flushes_since_compact = 0

    def maybe_compact_payload_ids(self) -> None:
        """Cadence + size gate for the major collection; skipped while a
        chunked apply() holds un-applied HostOps."""
        if self._ticks_since_payload_compact < self.payload_compact_every \
                or self._in_apply:
            return
        # Worth the plane round trip only when the table doubled since
        # the last collection (or its initial floor).
        threshold = max(self.payload_compact_min_entries,
                        2 * self._entries_after_last_compact)
        if len(self.payloads.entries) >= threshold:
            if self.compact_payload_ids():
                self._ticks_since_payload_compact = 0
        else:
            self._ticks_since_payload_compact = 0

    # Fold when live rows pass 3/4 of capacity.
    FOLD_NUM, FOLD_DEN = 3, 4

    def _seed_bucket_for(self, n: int, last_slack: int = 8) -> \
            Optional[int]:
        """Smallest bucket with 2x headroom; the widest bucket accepts a
        fit with `last_slack` spare rows as the final fallback."""
        last = len(self.buckets) - 1
        for nb, bucket in enumerate(self.buckets):
            if n * 2 <= bucket.capacity or \
                    (nb == last and n + last_slack <= bucket.capacity):
                return nb
        return None

    def _fold_crowded(self) -> None:
        """Host-side pack (the reference's zamboni scour/pack): device
        compaction frees removed rows but cannot merge acked adjacent
        rows, so crowded lanes fold through coalesce_entries and reseed
        into the smallest fitting bucket. Candidate rows leave the device
        in one slice per bucket and return in one batched put per
        destination bucket."""
        from ..mergetree.catchup import (coalesce_entries, extract_entries,
                                         seed_host_cols)
        dest: Dict[int, List[tuple]] = {}  # nb -> [(key, cols, mseq, cseq)]
        budget = self.fold_budget_per_tick
        for b, bucket in enumerate(self.buckets):
            if not any(k is not None for k in bucket.used):
                continue
            counts = _host(bucket.state.count)
            mseqs = _host(bucket.state.min_seq)
            # Near-overflow lanes of fold-eligible buckets fold ahead of
            # time (budget-capped) instead of all at once.
            near_ok = bucket.capacity >= self.fold_min_capacity
            if b == 0 and not near_ok:
                # Neither demotion nor refold is possible here.
                continue
            cands = [i for i, key in enumerate(bucket.used)
                     if key is not None
                     and int(counts[i]) * self.FOLD_DEN
                     >= bucket.capacity * self.FOLD_NUM
                     and self._fold_skip.get(key)
                     != (int(counts[i]), int(mseqs[i]))]
            if len(cands) > budget:
                cands = sorted(cands, key=lambda i: -int(counts[i]))
                cands = cands[:budget]
            budget -= len(cands)
            if not cands:
                continue
            # One device dispatch per candidate slice.
            self.fold_rescue_dispatches += 1
            sub = _tree_map(lambda x: x.cpu(), _take(bucket.state, cands))
            freed: List[int] = []
            for j, lane in enumerate(cands):
                key = bucket.used[lane]
                row = _row(sub, j)
                mseq = int(row.min_seq)
                cseq = int(row.seq)
                allow_runs = matrix_base_key(key) is not None
                try:
                    entries = coalesce_entries(
                        extract_entries(row, self.payloads, mseq,
                                        fold=True))
                    nb = self._seed_bucket_for(len(entries))
                    # A demotion, or a near-overflow fold in place that
                    # reclaims at least half the rows.
                    near = (near_ok
                            and int(counts[lane]) * 8
                            >= bucket.capacity * 7
                            and len(entries) * 2 <= int(counts[lane]))
                    demote = nb is not None and nb < b
                    refold = nb == b and near
                    if not (demote or refold):
                        self._fold_skip[key] = (int(counts[lane]),
                                                int(mseqs[lane]))
                        continue
                    cols = seed_host_cols(
                        entries, self.payloads,
                        anno_slots=int(row.anno.shape[-1]),
                        allow_runs=allow_runs,
                        allow_items=not allow_runs)
                except (Unmodelable, ValueError):  # host rows only
                    self._fold_skip[key] = (int(counts[lane]),
                                            int(mseqs[lane]))
                    continue  # leave the lane untouched; fold is optional
                dest.setdefault(nb, []).append((key, cols, mseq, cseq))
                freed.append(lane)
                self._fold_skip.pop(key, None)
                # New segmentation + payload ids: re-assemble at the next
                # summarize.
                self.mark_dirty(key)
                self.folds += 1
                self.fold_rows_reclaimed += int(counts[lane]) \
                    - len(entries)
            if freed:
                bucket.free_many(freed)
        for nb, items in dest.items():
            target = self.buckets[nb]
            self.fold_rescue_dispatches += 1  # one batched put per dest
            lanes = target.alloc_many([key for key, *_ in items])
            target.put_rows(lanes, _stack_seed_rows(
                items, target.capacity, target.state.anno_slots,
                target.state.overlap_slots, self.device),
                count_hints=[len(cols["length"])
                             for _, cols, *_ in items])
            for (key, cols, *_), lane in zip(items, lanes):
                self.where[key] = (nb, lane)
                self._swap_fold_payloads(key, self._seed_ids(cols))

    # -- batched summary extraction ----------------------------------------
    def extract_dispatch(self, only: Optional[set] = None,
                         chunk_chars: int = 10000) -> tuple:
        """Phase 1 (device): one fused zamboni + extraction pass per
        bucket (kernel.compact_extract_batched; the bucket adopts the
        compacted state when every live lane extracts).

        Dirty-epoch extraction: a lane whose change generation still
        matches its cached assembly returns its previous blobs (the
        second element); the dirty lanes gather into a pow2-padded
        sub-batch (kernel.gather_rows_pow2), so the work and the
        device-to-host bytes scale with the dirty count. `only` further
        restricts the keys. Returns (jobs, cached_snapshots)."""
        if self.paged:
            return self._extract_dispatch_paged(only, chunk_chars)
        jobs = []
        cached: Dict[tuple, dict] = {}
        with self._guard_lock:
            snap_view = dict(self._snap_cache)
        for bucket in self.buckets:
            lanes = []
            live = 0
            for i, key in enumerate(bucket.used):
                if key is None:
                    continue
                live += 1
                if only is not None and key not in only:
                    continue
                hit = snap_view.get(key)
                if hit is not None and hit[0] == self.change_gen.get(key, 0) \
                        and hit[1] == chunk_chars:
                    cached[key] = hit[2]
                    continue
                lanes.append((i, key))
            if not lanes:
                continue
            # Generations captured at dispatch.
            gens = {key: self.change_gen.get(key, 0) for _, key in lanes}
            stats_on = device_stats.enabled()
            if len(lanes) == live:
                # Every live lane extracts: fuse over the whole bucket and
                # adopt the compacted result (this tick's zamboni).
                with compile_ledger.track("kernel.compact_extract",
                                          kernel.compact_extract_batched):
                    res = kernel.compact_extract_batched(
                        bucket.state, stats=stats_on)
                new_state, packed = res[0], res[1]
                pre_counts = res[2] if stats_on else None
                bucket.state = new_state
                jobs.append((packed, lanes, new_state.seq,
                             new_state.min_seq, gens, pre_counts))
            else:
                sub, _n = kernel.gather_rows_pow2(
                    bucket.state, [i for i, _ in lanes])
                with compile_ledger.track("kernel.compact_extract",
                                          kernel.compact_extract_batched):
                    res = kernel.compact_extract_batched(
                        sub, stats=stats_on)
                packed = res[1]
                pre_counts = res[2] if stats_on else None
                # Lane indices become sub-batch rows.
                jobs.append((packed,
                             [(j, key) for j, (_, key)
                              in enumerate(lanes)],
                             sub.seq, sub.min_seq, gens, pre_counts))
        if cached:
            increment("summarize.blob_cache.hits", len(cached))
        return jobs, cached

    def _extract_dispatch_paged(self, only: Optional[set],
                                chunk_chars: int) -> tuple:
        """Paged phase 1: dirty lanes group by pow2 page bucket and each
        group runs one fused zamboni + extraction over gathered page views
        (kernel.compact_extract_paged, pool written in place). Counts
        adopt at once, then trailing pages release."""
        pg = self.pages
        jobs = []
        cached: Dict[tuple, dict] = {}
        lanes: List[tuple] = []
        with self._guard_lock:
            snap_view = dict(self._snap_cache)
        for key in list(self.where):
            if key not in pg.tables:
                continue
            if only is not None and key not in only:
                continue
            hit = snap_view.get(key)
            if hit is not None and hit[0] == self.change_gen.get(key, 0) \
                    and hit[1] == chunk_chars:
                cached[key] = hit[2]
                continue
            lanes.append(key)
        groups: Dict[int, List[tuple]] = {}
        for key in lanes:
            groups.setdefault(
                pow2_pages(len(pg.tables[key])), []).append(key)
        for _p2, keys in sorted(groups.items()):
            gens = {key: self.change_gen.get(key, 0) for key in keys}
            n = len(keys)
            _n_pad, pids, counts, mins, seqs = \
                self._stage_paged_group(keys)
            with compile_ledger.track("kernel.compact_extract_paged",
                                      kernel.compact_extract_paged):
                pool2, _, c2, packed = kernel.compact_extract_paged(
                    pg.pool, self._put(pids), self._put(counts),
                    self._put(mins), self._put(seqs))
            pg.adopt_pool(pool2)
            c2n = _host(c2)[:n]
            if device_stats.enabled():
                # The host count mirrors are the pre counts.
                reclaimed = int((counts[:n].astype(np.int64)
                                 - c2n.astype(np.int64)).sum())
                device_stats.fold_extract(
                    [n, int(c2n.sum()), reclaimed])
            pg.adopt_scalars(keys, c2n, mins[:n], seqs[:n])
            pg.release_trailing_many(keys)
            for key in keys:
                pg.ops_since_compact.pop(key, None)
            jobs.append((packed, list(enumerate(keys)), seqs, mins, gens,
                         None))
        if cached:
            increment("summarize.blob_cache.hits", len(cached))
        return jobs, cached

    def extract_assemble(self, jobs: List[tuple],
                         chunk_chars: int = 10000,
                         cached: Optional[Dict[tuple, dict]] = None
                         ) -> Dict[tuple, dict]:
        """Phase 2 (host): the device-to-host copy + text/props assembly
        of the dirty lanes' visible rows; clean lanes ride through from
        the blob cache. Returns {lane_key: {"header", "chunks"}}. Newly
        assembled snapshots enter the cache at their dispatch generation.
        An async worker runs this under an extraction guard, which defers
        every payload free while it resolves the shared table."""
        from ..mergetree.host import assemble_snapshot

        table = self.payloads
        out: Dict[tuple, dict] = dict(cached or {})
        for packed, lanes, seq_dev, min_seq_dev, gens, *tail in jobs:
            pre_counts = tail[0] if tail else None
            t0 = time.perf_counter()
            packed = kernel.fetch_extracted(packed)
            increment("summarize.extract_ms",
                      (time.perf_counter() - t0) * 1000.0)
            seqs = _host(seq_dev)
            min_seqs = _host(min_seq_dev)
            if pre_counts is not None:
                # Reclamation from the pre-compaction counts vs the
                # fetched post counts, over the job's real lanes only.
                pre_np = _host(pre_counts).astype(np.int64)
                post_np = np.asarray(packed[-1]).astype(np.int64)
                rows = [lane for lane, _ in lanes]
                reclaimed = int((pre_np[rows] - post_np[rows]).sum())
                device_stats.fold_extract(
                    [len(lanes), int(post_np[rows].sum()), reclaimed])
            for lane, key in lanes:
                snap = assemble_snapshot(
                    packed, table, lane,
                    min_seq=int(min_seqs[lane]), seq=int(seqs[lane]),
                    chunk_chars=chunk_chars)
                out[key] = snap
                # Monotone adoption under the summarize guard: a late
                # worker never clobbers a newer entry, nor resurrects one
                # for a lane drop() evicted.
                with self._guard_lock:
                    if key not in self.where:
                        continue
                    prev = self._snap_cache.get(key)
                    if prev is None or prev[0] <= gens[key]:
                        self._snap_cache[key] = (gens[key], chunk_chars,
                                                 snap)
                    self.last_summarized_gen[key] = max(
                        self.last_summarized_gen.get(key, 0), gens[key])
            increment("summarize.dirty_docs", len(lanes))
            increment("summarize.blob_cache.misses", len(lanes))
        return out

    def extract_all(self, chunk_chars: int = 10000,
                    only: Optional[set] = None) -> Dict[tuple, dict]:
        jobs, cached = self.extract_dispatch(only, chunk_chars)
        return self.extract_assemble(jobs, chunk_chars, cached)

    # -- queries -----------------------------------------------------------
    def _lane_row(self, key: tuple) -> DocState:
        b, lane = self.where[key]
        return self.pages.row(key) if self.paged \
            else self.buckets[b].row(lane)

    def text(self, key: tuple) -> Optional[str]:
        """Materialized text for a channel: None if opaque/unknown, or
        when the lane holds non-text payloads (read those via entries())."""
        if key not in self.where:
            return None
        from ..mergetree.host import NonTextPayload
        try:
            return extract_text(self._lane_row(key), self.payloads)
        except NonTextPayload:  # items/run lane: not a text channel
            return None

    def entries(self, key: tuple) -> Optional[list]:
        """Full-fidelity snapshot entries for one lane."""
        from ..mergetree.catchup import extract_entries

        if key not in self.where:
            return None
        row = self._lane_row(key)
        return extract_entries(row, self.payloads, int(row.min_seq))

    def lane_count(self) -> int:
        return len(self.where)


# ---------------------------------------------------------------------------
# LWW lanes: map/cell/counter channels on device (server/lww_kernel.py)
# ---------------------------------------------------------------------------

_CELL_KEY = "\x00cell"  # SharedCell = a one-key LWW map

# SharedMatrix serving lanes: one matrix channel materializes as two merge
# lanes (the permutation axes) plus one LWW lane for the sparse cell store,
# keyed under suffixed channel names ("\x00" cannot appear in real ids).
MATRIX_ROWS_SUFFIX = "\x00mx:rows"
MATRIX_COLS_SUFFIX = "\x00mx:cols"
MATRIX_CELLS_SUFFIX = "\x00mx:cells"
# SparseMatrix extends SharedMatrix (same wire shapes).
_MATRIX_TYPES = {
    "https://graph.microsoft.com/types/sharedmatrix",
    "https://graph.microsoft.com/types/mergeTree/sparse-matrix",
}


_MATRIX_SUFFIXES = ((MATRIX_ROWS_SUFFIX, "rows"),
                    (MATRIX_COLS_SUFFIX, "cols"),
                    (MATRIX_CELLS_SUFFIX, "cells"))


def matrix_base_key(key: tuple) -> Optional[tuple]:
    """(doc, store, chan+suffix) -> (doc, store, chan) for matrix
    sub-lane keys; None for ordinary channel keys."""
    chan = key[2]
    if isinstance(chan, str) and "\x00mx:" in chan:
        for suffix, _ in _MATRIX_SUFFIXES:
            if chan.endswith(suffix):
                return (key[0], key[1], chan[:-len(suffix)])
    return None


def lane_base_key(key: tuple) -> Optional[tuple]:
    """Base channel key for any composite sub-lane (matrix axes/cells,
    directory); None for ordinary channels."""
    base = matrix_base_key(key)
    if base is not None:
        return base
    chan = key[2]
    if isinstance(chan, str) and chan.endswith(DIR_SUFFIX):
        return (key[0], key[1], chan[:-len(DIR_SUFFIX)])
    return None


def _compose_matrix_channels(out: Dict[tuple, dict]) -> None:
    """Recombine suffixed matrix sub-lane snapshots into one channel
    snapshot per matrix keyed by the real channel name: the two axis
    snapshots (segments with wire-encoded runs) + the sparse cell map.
    Mutates `out` in place."""
    groups: Dict[tuple, Dict[str, dict]] = {}
    for key in [k for k in out
                if isinstance(k[2], str) and "\x00mx:" in k[2]]:
        for suffix, name in _MATRIX_SUFFIXES:
            if key[2].endswith(suffix):
                base = (key[0], key[1], key[2][:-len(suffix)])
                groups.setdefault(base, {})[name] = out.pop(key)
                break
    for base, parts in groups.items():
        composed: Dict[str, Any] = {
            "header": {"kind": "matrix", "sequenceNumber": 0}}
        seq = 0
        for axis in ("rows", "cols"):
            part = parts.get(axis)
            if part is None:
                composed[axis] = {"segments": [], "seq": 0, "minSeq": 0}
                continue
            hdr = part["header"]
            composed[axis] = {
                "segments": [e for chunk in part["chunks"]
                             for e in chunk],
                "seq": hdr["sequenceNumber"],
                "minSeq": hdr["minimumSequenceNumber"],
            }
            seq = max(seq, hdr["sequenceNumber"])
        cells = parts.get("cells")
        composed["cells"] = dict(cells["entries"]) if cells else {}
        if cells:
            seq = max(seq, cells["header"]["sequenceNumber"])
        composed["header"]["sequenceNumber"] = seq
        out[base] = composed


# SharedDirectory serving lane: the whole nested tree rides one LWW lane
# with (path, key) pairs interned as composite keys (path "\x1e" key), plus
# a host-tracked set of existing paths that gates storage ops.
DIR_SUFFIX = "\x00dir"
DIR_SEP = "\x1e"
_DIRECTORY_TYPE = "https://graph.microsoft.com/types/directory"


def directory_route(op: Any) -> Optional[str]:
    """Classify a SharedDirectory wire op: 'storage' /
    'createSubDirectory' / 'deleteSubDirectory', None for anything
    else."""
    if not isinstance(op, dict):
        return None
    t = op.get("type")
    if t == "storage" and isinstance(op.get("path"), str) \
            and isinstance(op.get("op"), dict):
        return "storage"
    if t in ("createSubDirectory", "deleteSubDirectory") \
            and isinstance(op.get("path"), str) \
            and isinstance(op.get("name"), str):
        return t
    return None


def _child_path(parent: str, name: str) -> str:
    return parent.rstrip("/") + "/" + name


def _norm_path(path: str) -> str:
    """Canonical form (empty segments skipped): '/sub/', '//sub' ->
    '/sub'; '', '/' -> '/'."""
    parts = [p for p in path.strip("/").split("/") if p]
    return "/" + "/".join(parts) if parts else "/"


def _flatten_directory(data: dict):
    """root.to_dict() nested form -> ({composite_key: value}, {paths}).
    Raises ValueError on separator-bearing subdirectory names."""
    entries: Dict[str, Any] = {}
    paths = set()

    def walk(node, path):
        if not isinstance(node, dict):
            raise ValueError("malformed directory node")
        paths.add(path)
        storage = node.get("storage", {})
        if not isinstance(storage, dict):
            raise ValueError("malformed directory storage")
        for k, v in storage.items():
            entries[path + DIR_SEP + k] = v
        subs = node.get("subdirectories", {})
        if not isinstance(subs, dict):
            raise ValueError("malformed subdirectories")
        for name, sub in subs.items():
            if DIR_SEP in name:
                raise ValueError("separator in subdirectory name")
            walk(sub, _child_path(path, name))

    walk(data, "/")
    return entries, paths


def _nest_directory(entries: Dict[str, Any], paths) -> dict:
    """Inverse of _flatten_directory: lane entries + path set ->
    root.to_dict() nested form."""
    nodes = {"/": {"storage": {}, "subdirectories": {}}}
    for p in sorted(paths, key=len):
        if p == "/" or p in nodes:
            continue
        parent, _, name = p.rpartition("/")
        parent = parent or "/"
        node = {"storage": {}, "subdirectories": {}}
        if parent in nodes:
            nodes[parent]["subdirectories"][name] = node
            nodes[p] = node
    for comp, v in entries.items():
        path, sep, key = comp.partition(DIR_SEP)
        if sep and path in nodes:
            nodes[path]["storage"][key] = v
    return nodes["/"]


def matrix_route(op: Any) -> Optional[str]:
    """Classify a SharedMatrix wire op: 'rows'/'cols' for axis merge ops,
    'cell' for cell writes, None for anything else."""
    if not isinstance(op, dict):
        return None
    target = op.get("target")
    if target in ("rows", "cols") and looks_like_merge_op(op.get("op")):
        return target
    if target == "cell" and isinstance(op.get("key"), str):
        return "cell"
    return None


def looks_like_lww_op(op: Any) -> bool:
    if not isinstance(op, dict):
        return False
    t = op.get("type")
    if t in ("set", "delete"):
        # MapKernel ops always carry a pid; requiring it keeps shape-alike
        # ops from other DDSes out of the LWW lanes.
        return isinstance(op.get("key"), str) and "pid" in op
    if t == "clear":
        return "pid" in op  # ink's clear has no pid; directory's has a path
    if t == "increment":
        return "delta" in op
    return t in ("setCell", "deleteCell")


class _LwwBucket:
    """A batch of LWW lanes sharing one key-slot capacity (as
    _MergeBucket: one hot channel cannot inflate every lane)."""

    def __init__(self, lk, capacity: int, lanes: int = 8,
                 device: torch.device = None):
        self.lk = lk
        self.capacity = capacity
        self.lanes = lanes
        self.device = device
        self.state = lk.make_lww_state(capacity, lanes, device=device)
        self.used: List[Optional[tuple]] = [None] * lanes
        self._blank_row = None  # built lazily, reused across frees
        self._free: List[int] = []
        self._next = 0
        # Upper bound of each lane's occupied key slots (see
        # _MergeBucket.count_hint).
        self.count_hint = np.zeros(lanes, np.int64)
        self.hint_pending = np.zeros(lanes, np.int64)

    def grow(self) -> None:
        old = self.lanes
        grown = self.lk.make_lww_state(self.capacity, old * 2,
                                       device=self.device)
        for g, s in zip(grown, self.state):
            g[:old] = s
        self.state = grown
        self.used.extend([None] * old)
        self.lanes = old * 2
        self.count_hint = np.concatenate(
            [self.count_hint, np.zeros(old, np.int64)])
        self.hint_pending = np.concatenate(
            [self.hint_pending, np.zeros(old, np.int64)])

    def alloc(self, key: tuple) -> int:
        if self._free:
            i = self._free.pop()
        else:
            if self._next >= self.lanes:
                self.grow()
            i = self._next
            self._next += 1
        self.used[i] = key
        self.count_hint[i] = 0  # freed/frontier lanes are blank rows
        return i

    def free(self, lane: int) -> None:
        # Zero on free: a reused lane must not expose the previous
        # channel's keys/values.
        self.used[lane] = None
        self._free.append(lane)
        self.hint_pending[lane] = 0
        if self._blank_row is None:
            self._blank_row = _row(self.lk.make_lww_state(
                self.capacity, 1, device=self.device), 0)
        self.put_row(lane, self._blank_row, count_hint=0)

    def row(self, lane: int):
        return _row(self.state, lane)

    def put_row(self, lane: int, row, count_hint: Optional[int] = None) \
            -> None:
        self.state = _set_rows(self.state, [lane],
                               _tree_map(lambda r: r[None], row))
        self.count_hint[lane] = self.capacity if count_hint is None \
            else count_hint


class LwwLaneStore:
    """Device-resident LWW channel lanes + host key/value interning: the
    map/cell/counter half of server-side materialization. Lanes live in
    key-capacity buckets; a lane whose key set outgrows its bucket
    promotes to the next one and its window re-applies from the retained
    pre-state. The apply is lww_kernel.apply_lww_batched (plain PyTorch on
    either device)."""

    def __init__(self, capacities: Tuple[int, ...] = (64, 1024, 16384),
                 lanes_per_bucket: int = 8,
                 t_buckets: Tuple[int, ...] = DEFAULT_T_BUCKETS,
                 device: str | torch.device | None = None):
        lk = lww_kernel
        self.lk = lk
        self.device = resolve_device(device)
        self.capacities = tuple(capacities)
        self.t_buckets = tuple(t_buckets)
        self.buckets = [_LwwBucket(lk, c, lanes_per_bucket, self.device)
                        for c in self.capacities]
        self.where: Dict[tuple, Tuple[int, int]] = {}
        self.opaque: set = set()  # channels dropped after bucket exhaustion
        self.overflow_drops = 0
        self.change_gen: Dict[tuple, int] = {}  # see MergeLaneStore
        self._gen_counter = 0
        self.key_ids: Dict[str, int] = {}
        self.key_names: List[str] = []
        self.values: List[Any] = []  # payload refs -> raw (encoded) values
        self.windows_since_value_compact = 0
        self.value_compact_every = 64

    def intern_key(self, key: str) -> int:
        if key not in self.key_ids:
            self.key_ids[key] = len(self.key_names)
            self.key_names.append(key)
        return self.key_ids[key]

    def add_value(self, value: Any) -> int:
        self.values.append(value)
        return len(self.values) - 1

    def add_value_block(self, block: "_LwwValueBlock") -> int:
        """Register a whole flush's values at once (fast-path ingest);
        value id = base + block-local index, decoded lazily."""
        base = len(self.values)
        block.base = base
        self.values.extend(itertools.repeat(block, len(block)))
        return base

    def value(self, vid: int) -> Any:
        v = self.values[vid]
        return v.resolve(vid) if type(v) is _LwwValueBlock else v

    def lane_for(self, key: tuple) -> Tuple[int, int]:
        if key not in self.where:
            lane = self.buckets[0].alloc(key)
            self.where[key] = (0, lane)
        return self.where[key]

    def mark_dirty(self, key: tuple) -> None:
        self._gen_counter += 1
        self.change_gen[key] = self._gen_counter

    def drop(self, key: tuple) -> None:
        """Degrade a channel to opaque (unmodelable content)."""
        self.opaque.add(key)
        if key in self.where:
            b, lane = self.where.pop(key)
            self.buckets[b].free(lane)

    def seed(self, key: tuple, kind: str, header: Any) -> bool:
        """Bootstrap a lane from a summary header (map entries / cell
        value / counter accumulator) as synthetic seq-0 ops: any real op
        (seq >= 1) wins LWW over the seeded base."""
        lk = self.lk
        if key in self.where:
            return True
        if key in self.opaque:
            return False
        ops: List[tuple] = []
        try:
            if kind == "map" and isinstance(header, dict):
                for k, v in header.items():
                    ops.append((lk.LwwKind.SET, self.intern_key(k),
                                self.add_value(v), 0, 0))
            elif kind == "cell" and isinstance(header, dict):
                if header.get("hasValue"):
                    ops.append((lk.LwwKind.SET, self.intern_key(_CELL_KEY),
                                self.add_value(header.get("value")), 0, 0))
            elif kind == "counter" and isinstance(header, dict):
                delta = int(header.get("value", 0))
                if not (-2**31 <= delta < 2**31):
                    raise ValueError("counter base exceeds int32")
                if delta:
                    ops.append((lk.LwwKind.ADD, -1, -1, delta, 0))
            else:
                raise ValueError(f"unseedable header kind {kind!r}")
        except (ValueError, TypeError):
            # An unrepresentable base: live ops over an empty base would
            # serve wrong state.
            self.opaque.add(key)
            return False
        if ops:
            self.apply({key: ops})
            if key in self.opaque:
                return False  # oversized snapshot: degraded, not fatal
        else:
            self.lane_for(key)  # empty base: allocate so snapshots report
            self.mark_dirty(key)
        return True

    def wire_to_op(self, op: dict, seq: int) -> tuple:
        """(kind, key_id, val_id, delta, seq) for one sequenced wire op.
        Raises Unmodelable (never anything else) for content the lane
        cannot represent."""
        lk = self.lk
        t = op.get("type")
        try:
            if t == "set":
                return (lk.LwwKind.SET, self.intern_key(op["key"]),
                        self.add_value(op.get("value")), 0, seq)
            if t == "delete":
                return (lk.LwwKind.DELETE, self.intern_key(op["key"]), -1,
                        0, seq)
            if t == "clear":
                return (lk.LwwKind.CLEAR, -1, -1, 0, seq)
            if t == "setCell":
                return (lk.LwwKind.SET, self.intern_key(_CELL_KEY),
                        self.add_value(op.get("value")), 0, seq)
            if t == "deleteCell":
                return (lk.LwwKind.DELETE, self.intern_key(_CELL_KEY), -1,
                        0, seq)
            if t == "increment":
                delta = int(op["delta"])
                if not (-2**31 <= delta < 2**31):
                    raise Unmodelable("increment delta exceeds int32")
                return (lk.LwwKind.ADD, -1, -1, delta, seq)
        except Unmodelable:
            raise
        except Exception as err:  # noqa: BLE001 — malformed wire content
            raise Unmodelable(f"malformed lww op: {err}") from err
        raise Unmodelable(f"unknown lww op {t!r}")

    def apply(self, streams: Dict[tuple, List[tuple]]) -> None:
        """streams: lane_key -> [(kind, key_id, val_id, delta, seq)].
        Windows chunk to the largest T bucket."""
        max_t = self.t_buckets[-1]
        while streams:
            window = {k: v[:max_t] for k, v in streams.items() if v}
            streams = {k: v[max_t:] for k, v in streams.items()
                       if len(v) > max_t}
            if window:
                self._apply_window(window)
        self.windows_since_value_compact += 1
        if self.windows_since_value_compact >= self.value_compact_every:
            self.compact_values()

    def _pack(self, lanes_count: int, window_lanes: Dict[int, List[tuple]],
              t: int):
        cols = np.zeros((5, lanes_count, t), np.int32)
        for lane, ops in window_lanes.items():
            if ops:
                cols[:, lane, :len(ops)] = np.asarray(ops, np.int64).T
        return self.lk.LwwOps(*(torch.from_numpy(c.copy()).to(self.device)
                                for c in cols))

    def _apply_window(self, window: Dict[tuple, List[tuple]]) -> None:
        per_bucket: Dict[int, Dict[int, List[tuple]]] = {}
        for key, ops in window.items():
            if key in self.opaque:
                continue  # degraded channel: never re-admit
            b, lane = self.lane_for(key)
            self.mark_dirty(key)
            per_bucket.setdefault(b, {})[lane] = ops
        for b, lane_ops in sorted(per_bucket.items()):
            bucket = self.buckets[b]
            t = _bucket(max(len(v) for v in lane_ops.values()),
                        self.t_buckets)
            ops_dev = self._pack(bucket.lanes, lane_ops, t)
            pre = bucket.state
            new = self.lk.apply_lww_batched(pre, ops_dev)
            over = _host(new.overflow)
            flagged = [i for i in range(bucket.lanes)
                       if over[i] and i in lane_ops]
            if flagged:
                new = _set_rows(new, flagged, _take(pre, flagged))
            bucket.state = new
            # Each applied op can occupy at most one new key slot.
            for i, ops in lane_ops.items():
                bucket.count_hint[i] += len(ops)
            for i in flagged:
                self._promote(b, i, lane_ops[i], t)

    def _promote(self, b: int, lane: int, ops: List[tuple], t: int) -> None:
        """An overflowed lane: move to the next capacity bucket and
        re-apply its window from the retained pre-state row."""
        key = self.buckets[b].used[lane]
        row = self.buckets[b].row(lane)
        self.buckets[b].free(lane)
        for nb in range(b + 1, len(self.buckets)):
            target = self.buckets[nb]
            wide = self.lk.grow_lane_capacity(
                _tree_map(lambda x: x[None], row), target.capacity)
            ops_dev = self._pack(1, {0: ops}, t)
            redone = self.lk.apply_lww_batched(wide, ops_dev)
            if not bool(_host(redone.overflow)[0]):
                new_lane = target.alloc(key)
                target.put_row(new_lane, _row(redone, 0))
                self.where[key] = (nb, new_lane)
                return
            row = _row(wide, 0)
        # Every key-capacity bucket exhausted: degrade this one channel.
        del self.where[key]
        self.opaque.add(key)
        self.overflow_drops += 1

    def compact_values(self) -> None:
        """Reclaim unreferenced payloads: memory tracks live state, not
        total op count."""
        referenced: set = set()
        for bucket in self.buckets:
            if any(k is not None for k in bucket.used):
                vals = _host(bucket.state.val)
                referenced.update(int(v) for v in np.unique(vals) if v >= 0)
        order = sorted(referenced)
        sorted_old = np.asarray(order, np.int64)
        # Materialize through value(): block entries decode before the
        # id space is renumbered.
        self.values = [self.value(old) for old in order]
        for bucket in self.buckets:
            if not any(k is not None for k in bucket.used):
                continue
            vals = _host(bucket.state.val)
            # Exact key-slot occupancy refresh while the plane is here.
            bucket.count_hint = np.count_nonzero(
                _host(bucket.state.key) >= 0, axis=-1).astype(np.int64)
            out = np.where(vals >= 0, np.searchsorted(sorted_old, vals),
                           -1).astype(np.int32)
            bucket.state = bucket.state._replace(
                val=torch.from_numpy(out).to(self.device))
        self.windows_since_value_compact = 0

    # -- reads (tests / snapshots) -----------------------------------------
    def snapshot(self, lane_key: tuple) -> Optional[dict]:
        """Entries hold wire-encoded values (handles stay encoded):
        clients decode at load, as they do for ops."""
        if lane_key not in self.where:
            return None
        b, lane = self.where[lane_key]
        state = self.buckets[b].state
        keys = _host(state.key[lane])
        vals = _host(state.val[lane])
        entries = {}
        for kid, vid in zip(keys, vals):
            if int(kid) >= 0:
                entries[self.key_names[int(kid)]] = (
                    self.value(int(vid)) if int(vid) >= 0 else None)
        return {
            "entries": entries,
            "counter": int(_host(state.counter[lane])),
            "sequenceNumber": int(_host(state.last_seq[lane])),
        }


class _LwwValueBlock:
    """One flush's LWW values as raw JSON spans of the retained wire
    buffers, decoded lazily (and cached) at read time."""

    __slots__ = ("base", "bufs", "vbuf", "vstart", "vend", "_cache")

    def __init__(self, bufs, vbuf, vstart, vend):
        self.base = -1  # assigned by LwwLaneStore.add_value_block
        self.bufs = bufs
        self.vbuf = vbuf
        self.vstart = vstart
        self.vend = vend
        self._cache: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self.vbuf)

    def resolve(self, vid: int) -> Any:
        i = vid - self.base
        if i in self._cache:
            return self._cache[i]
        s = int(self.vstart[i])
        v = None if s < 0 else json.loads(
            self.bufs[int(self.vbuf[i])][s:int(self.vend[i])])
        self._cache[i] = v
        return v
