"""The serving sequencer: device-resident per-channel lane stores and the
partition lambda that drives them.

Counterpart of fluidframework_tpu's server/tpu_sequencer.py: the merge
lanes (`MergeLaneStore`, bucketed or paged), the LWW lanes
(`LwwLaneStore`), the channel routing helpers, and `TpuSequencerLambda`,
the batched IPartitionLambda of the north star: one lambda owns a whole
partition's documents, sequences each window of their messages in one
[B, T] ticket scan (kernels/csrc/ticket_scan.cu on the card), applies the
admitted channel ops to the lanes, emits SequencedDocumentMessages and
nacks with the DeliLambda contract, checkpoints, summarizes and serves
catch-up artifacts.

The lambda takes messages two ways. `handler` takes decoded boxcars (the
object path: one ticket window at a time, then the stores' own applies).
`handler_raw` takes raw wire bytes (the fast path): the native wire pump
(native/src/wirepump.cpp, server/pump.py) parses a flush's backlog into
int32 columns, numpy stages each window, and one serve_step call runs the
whole window on the device — serve_window per window, serve_burst for
staged windows of bucketed lanes, serve_megakernel for paged lanes. With
`pipelined`, results come back through a ring of in-flight windows, each
an asynchronous copy into pinned host memory behind a CUDA event.

Merge lanes live in capacity buckets ([lanes, C] DocState batches, one
apply shape per (capacity, T-bucket) pair) or, with paged=True, in a page
pool with per-document page tables (mergetree/paging.py). A lane that
overflows its bucket during an apply is zamboni-compacted and re-run,
host-folded (acked runs coalesce) at or above `fold_min_capacity`, then
promoted to the next bucket, and rescued on the host as a last resort
before it degrades to opaque. The stores' own applies are
kernel.apply_ops_batched_keep (scan_apply.cu for CUDA tensors, the plain
scan for CPU tensors), and the paged applies are kernel.apply_ops_paged
and serve_step.serve_paged_burst.

The JAX arrays the original keeps are immutable. Here every update of a
bucket's state builds new tensors (`index_put`, not an in-place write), so
a state, a row view or an extraction job taken earlier never changes under
its holder; the page pool alone is written in place (paging.py,
serve_step.serve_megakernel), and the paged applies hand back the
pre-window view as a gathered copy.

Devices: the stores and the lambda take `device=None` (the card, raising
when CUDA is absent) or a device the caller names; the tests pass "cpu".
With `mesh=` (parallel/mesh.py) the ticket lanes and the bucket lanes
shard over the mesh's 'dp' axis and the paged pool over it by the
partition rules: each window tickets and applies each shard's lanes on
that shard's device (a ticket scan and a scan apply per shard), the
results come back in lane order, and a paged window's pages are gathered
to the home device and scattered back. On a mesh the lambda keeps the
reference's choices: the windows take the scan apply (no fused serve),
every window keeps its pre states (`donate_lane_states` is False), and
fused bursts stay off. There is no
probe and no fallback: on CUDA tensors the kernels run and
pallas_apply.launch_geometry / kernel.scan_geometry choose their paths,
on CPU tensors the plain versions run, and a failed pump build, kernel
build or launch raises.

Rescue handlers degrade a lane for content the device cannot represent
(catchup.Unmodelable) and for a table too small for its rows
(core/errors.CapacityExceeded); a kernel's refusal, build error or launch
error propagates.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import interop
from ..core.device import resolve_device
from ..core.errors import CapacityExceeded
from ..mergetree import kernel
from ..mergetree.catchup import (
    Unmodelable,
    looks_like_merge_op,
    wire_to_host_ops,
)
from ..mergetree.constants import DEFAULT_T_BUCKETS, PAGE_ROWS
from ..mergetree.host import OpBuilder, PayloadTable, extract_text
from ..mergetree.oppack import (HostOp, OpKind, PackedOps, RUN_K, RUN_MIN,
                                pack_ops)
from ..mergetree.paging import PagedMergeStore, pages_for, pow2_pages
from ..mergetree.state import DocState, make_state
from ..parallel.mesh import (Sharded, gather, gather_tree, map_dp, row_of,
                             set_rows, shard_docs, take_rows)
from ..protocol.messages import (
    Boxcar,
    DocumentMessage,
    ITrace,
    MessageType,
    Nack,
    NackContent,
    NACK_BAD_REF_SEQ,
    SequencedDocumentMessage,
)
from ..telemetry import device_stats, tracing
from ..telemetry.compile_ledger import ledger as compile_ledger
from ..telemetry.counters import (JitRetraceProbe, gauge,
                                  get as counter_get, increment,
                                  latency_window, nearest_rank, observe,
                                  record_swallow)
from . import lww_kernel, serve_step
from . import pump as P
from . import ticket_kernel as tk
from .lambdas.base import IPartitionLambda, LambdaContext
from .log import QueuedMessage
from .wire import boxcar_from_wire, document_message_from_dict

# What a rescue or fold may turn into an opaque lane: the rest (a kernel's
# refusal among them) propagates.
_DEGRADE = (Unmodelable, CapacityExceeded)


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"window of {n} exceeds max bucket {buckets[-1]}")


def _host(x) -> np.ndarray:
    """A tensor, Sharded (gathered) or numpy array as host numpy: the
    device-to-host copy for a CUDA tensor."""
    if isinstance(x, Sharded):
        x = gather(x)
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
    gathered copy (on the mesh's home device for a state on a mesh)."""
    if isinstance(state[0], Sharded):
        return _tree_map(lambda x: take_rows(x, rows), state)
    idx = _index(rows, state[0].device)
    return _tree_map(lambda x: x[idx], state)


def _set_rows(state, rows, values):
    """A new batched tuple whose rows `rows` are `values` ([k, ...] per
    field): JAX's `.at[rows].set(values)`, never a write into `state`. On
    a mesh each row goes to its owning shard."""
    if isinstance(state[0], Sharded):
        return _tree_map(lambda col, v: set_rows(col, rows, v), state,
                         values)
    idx = _index(rows, state[0].device)
    return _tree_map(lambda col, v: col.index_put((idx,), v), state,
                     values)


def _row(state, j: int):
    """Row j of a batched tuple (a view: callers only read it, and no
    update writes into a bucket's tensors; a copy on the home device for
    a state on a mesh)."""
    if isinstance(state[0], Sharded):
        return _tree_map(lambda x: row_of(x, j), state)
    return _tree_map(lambda x: x[j], state)


def _dispatch(fn, state, *args):
    """fn(state, *args), once per dp shard when `state` is placed on a
    mesh: each shard runs its lanes' rows of the args (built on the home
    device and cut over dp here), and the results come back placed as the
    lanes are. A state on one device runs fn as it is."""
    if not isinstance(state[0], Sharded):
        return fn(state, *args)
    mesh = state[0].mesh
    return map_dp(fn, mesh, state, *(shard_docs(mesh, a) for a in args))


def _gathered(state):
    """A state on a mesh as one state on the home device (others as they
    are): the summarize path's input."""
    return gather_tree(state) if isinstance(state[0], Sharded) else state


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
        self.placer = None  # the lambda's dp-mesh placement, if any

    def grow(self) -> None:
        old = self.lanes
        grown = make_state(self.capacity, anno_slots=self.state.anno_slots,
                           overlap_slots=self.state.overlap_slots,
                           batch=old * 2, device=self.device)
        for g, s in zip(grown, _gathered(self.state)):
            g[:old] = s
        self.state = grown if self.placer is None else self.placer(grown)
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
                 device: str | torch.device | None = None,
                 mesh=None):
        """mesh: a parallel.mesh.Mesh. The paged pool is then placed by
        partition_rules.POOL_PARTITION_RULES (its page axis over 'dp');
        the bucket grids are placed by the lambda's bucket placer."""
        self.device = resolve_device(device)
        self.mesh = mesh
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
                                         device=self.device, mesh=mesh)
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
            if bucket.placer is not None:
                # The renumbered planes were built on one device: place
                # them again so the collection keeps the dp placement.
                bucket.state = bucket.placer(bucket.state)
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
                new_state = _dispatch(_apply_keep_batched, pre, packed)
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
                bucket.state = _dispatch(kernel.compact_batched,
                                         bucket.state)
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
            # On a mesh the extraction runs on the home device over the
            # gathered bucket (the summarize path, not the serving one).
            state = _gathered(bucket.state)
            if len(lanes) == live:
                # Every live lane extracts: fuse over the whole bucket and
                # adopt the compacted result (this tick's zamboni).
                with compile_ledger.track("kernel.compact_extract",
                                          kernel.compact_extract_batched):
                    res = kernel.compact_extract_batched(
                        state, stats=stats_on)
                new_state, packed = res[0], res[1]
                pre_counts = res[2] if stats_on else None
                bucket.state = new_state if bucket.placer is None \
                    else bucket.placer(new_state)
                jobs.append((packed, lanes, new_state.seq,
                             new_state.min_seq, gens, pre_counts))
            else:
                sub, _n = kernel.gather_rows_pow2(
                    state, [i for i, _ in lanes])
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

        # The worker's payload-table read rides the extract-guard protocol,
        # not a lock: while it runs, the sequencing thread defers every
        # free (free_payloads) instead of recycling an id it resolves.
        # fluidlint: disable=SHARED_STATE_NO_LOCK — worker read
        # protected by the _extract_guards deferred-free protocol
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
                    # fluidlint: disable=SHARED_STATE_NO_LOCK — a
                    # GIL-atomic membership probe: drop() evicts the cache
                    # under _guard_lock strictly after popping `where`, so
                    # a stale read only skips an adoption it would undo
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
        self.placer = None  # the lambda's dp-mesh placement, if any

    def grow(self) -> None:
        old = self.lanes
        grown = self.lk.make_lww_state(self.capacity, old * 2,
                                       device=self.device)
        for g, s in zip(grown, _gathered(self.state)):
            g[:old] = s
        self.state = grown if self.placer is None else self.placer(grown)
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
    pre-state. The apply is lww_kernel.apply_lww_batched: the lane-scan
    kernel (kernels/csrc/lww_scan.cu) on the card, its plain version on
    the CPU; it writes new tensors, so a retry starts from `pre`."""

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
            new = _dispatch(self.lk.apply_lww_batched, pre, ops_dev)
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
            if bucket.placer is not None:
                # Same rule as the merge side's payload collection.
                bucket.state = bucket.placer(bucket.state)
        self.windows_since_value_compact = 0

    # -- reads (tests / snapshots) -----------------------------------------
    def snapshot(self, lane_key: tuple) -> Optional[dict]:
        """Entries hold wire-encoded values (handles stay encoded):
        clients decode at load, as they do for ops."""
        if lane_key not in self.where:
            return None
        b, lane = self.where[lane_key]
        state = self.buckets[b].row(lane)
        keys = _host(state.key)
        vals = _host(state.val)
        entries = {}
        for kid, vid in zip(keys, vals):
            if int(kid) >= 0:
                entries[self.key_names[int(kid)]] = (
                    self.value(int(vid)) if int(vid) >= 0 else None)
        return {
            "entries": entries,
            "counter": int(_host(state.counter)),
            "sequenceNumber": int(_host(state.last_seq)),
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


def _pack_lane_runs(lanes, kind, client, ref, pos1, length, K, run_min):
    """Vectorized insert-run detection over ONE flush's merge rows
    (oppack.pack_run_slots semantics, numpy over pump columns).

    Rows arrive in stream order with lanes interleaved; runs are
    CONSECUTIVE same-lane INSERT rows by one client at ONE refSeq whose
    positions chain as append (pos_{i+1} == pos_i + len_i) or prepend
    (pos_{i+1} == pos_i) — equal refs make the packed single-perspective
    apply exact (any in-window foreign seq is > every member's ref, so
    classification is identical at all members' perspectives). Runs of
    >= run_min members chunk into INSERT_RUN slots of up to K; prepend
    slots lay their members out REVERSED (each later prepend lands
    before its predecessor, exactly the scalar tie-break order).

    Returns per-row arrays:
      slot       int  — the row's op slot within its lane
      sub        int  — layout index within the slot (-1 = plain op)
      head       bool — stream-first member of a run slot (provides the
                        slot's pos1/ref/client columns)
      tail       bool — stream-last member (provides the slot's
                        doc_lane/t_idx, i.e. its seq/msn gather source)
    Plain rows have head == tail == True and sub == -1."""
    n = len(lanes)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z - 1, np.zeros(0, bool), np.zeros(0, bool)
    idx = np.arange(n)
    order = np.lexsort((idx, lanes))  # lane-grouped, stream-ordered
    la, ki, cl, rf, p1, ln = (a[order] for a in
                              (lanes, kind, client, ref, pos1, length))
    ins = (ki == OpKind.INSERT) & (ln > 0)
    same = np.zeros(n, bool)
    same[1:] = ((la[1:] == la[:-1]) & ins[1:] & ins[:-1]
                & (cl[1:] == cl[:-1]) & (rf[1:] == rf[:-1]))
    app = np.zeros(n, bool)
    pre = np.zeros(n, bool)
    app[1:] = same[1:] & (p1[1:] == p1[:-1] + ln[:-1])
    pre[1:] = same[1:] & (p1[1:] == p1[:-1])
    link = np.where(app, 1, np.where(pre, 2, 0))
    # A link continues the run only if it matches the run's first link
    # type; since consecutive links must agree pairwise for a uniform
    # chain, "same type as previous link" suffices (the first link sets
    # the type; a type flip breaks).
    cont = link > 0
    cont[2:] &= (link[2:] == link[1:-1]) | (link[1:-1] == 0)
    start = ~cont
    run_id = np.cumsum(start) - 1
    # Member position within the run, run sizes.
    q = idx - np.maximum.accumulate(np.where(start, idx, 0))
    run_sizes = np.bincount(run_id, minlength=run_id[-1] + 1)
    size_of = run_sizes[run_id]
    # Runs below run_min (or singletons) stay plain.
    member = size_of >= run_min
    # Chunk runs into slots of K.
    slot_in_run = q // K
    sub_stream = q % K
    # Per-slot member count (last chunk may be short). A remainder
    # chunk below run_min is not worth a padded slot: demote to plain
    # (pack_run_slots does the same).
    chunk = np.minimum(size_of - slot_in_run * K, K)
    member = member & (chunk >= run_min)
    run_type = np.zeros(n, np.int64)
    # type of the run = type of its second element's link (first link).
    first_link_idx = np.maximum.accumulate(np.where(start, idx, 0)) + 1
    valid_fl = first_link_idx < n
    fl = np.where(valid_fl, np.minimum(first_link_idx, n - 1), n - 1)
    run_type = np.where(member, link[fl], 0)
    sub = np.where(run_type == 2, chunk - 1 - sub_stream, sub_stream)
    sub = np.where(member, sub, -1)
    # Slot numbering within the lane: plain rows and stream-first chunk
    # members start a slot.
    starts_slot = ~member | (sub_stream == 0)
    # cumcount of slot starts per lane (rows already lane-grouped).
    lane_start = np.zeros(n, bool)
    lane_start[0] = True
    lane_start[1:] = la[1:] != la[:-1]
    slot_cum = np.cumsum(starts_slot)
    adj = np.maximum.accumulate(
        np.where(lane_start, slot_cum - starts_slot.astype(np.int64), 0))
    slot_sorted = slot_cum - 1 - adj
    head = ~member | (sub_stream == 0)
    tail = ~member | (sub_stream == chunk - 1)
    # Map back to original row order.
    slot = np.empty(n, np.int64)
    sub_o = np.empty(n, np.int64)
    head_o = np.empty(n, bool)
    tail_o = np.empty(n, bool)
    slot[order] = slot_sorted
    sub_o[order] = sub
    head_o[order] = head
    tail_o[order] = tail
    return slot, sub_o, head_o, tail_o


def _cumcount(groups: np.ndarray) -> np.ndarray:
    """Per-row occurrence index within its group value, preserving row
    order (vectorized groupby-cumcount)."""
    n = len(groups)
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(groups, kind="stable")
    sg = groups[order]
    starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
    counts = np.diff(np.r_[starts, n])
    pos_sorted = np.arange(n) - np.repeat(starts, counts)
    out = np.empty(n, np.int64)
    out[order] = pos_sorted
    return out


class SequencedWindow:
    """One fast flush's admitted messages, materialized lazily.

    The slow path produces one SequencedDocumentMessage per op at flush
    time; the fast path hands downstream ONE window per flush (the
    reference's per-message kafka produce batched per flush window) and
    builds message objects only when a consumer iterates. Columns are
    numpy views over the flush's pump output; payload JSON stays in the
    retained wire buffers until touched."""

    def __init__(self, bufs: List[bytes], doc_ids: List[str],
                 ordinals: List[Dict[int, str]], rows: np.ndarray,
                 cols: np.ndarray, seqs: np.ndarray, msns: np.ndarray):
        self.bufs = bufs
        self.doc_ids = doc_ids          # row index -> document id
        self.ordinals = ordinals        # row index -> ordinal->client map
        self.rows = rows                # row indices into cols (in order)
        self.cols = cols
        self.seqs = seqs                # per-row assigned seq (0 = dropped)
        self.msns = msns

    def __len__(self) -> int:
        return int((self.seqs > 0).sum())

    def messages(self):
        """Yield (doc_id, SequencedDocumentMessage) for every admitted
        message, per-document order preserved."""
        c = self.cols
        for j, row in enumerate(self.rows.tolist()):
            seq = int(self.seqs[j])
            if seq <= 0:
                continue
            buf = self.bufs[int(c[P.BUF, row])]
            msg = document_message_from_dict(json.loads(
                buf[int(c[P.MSTART, row]):int(c[P.MEND, row])]))
            client_id = None
            if int(c[P.KIND, row]) == tk.MsgKind.OP:
                client_id = self.ordinals[j].get(int(c[P.CLIENT, row]))
            out = SequencedDocumentMessage.from_document_message(
                msg, client_id, seq, int(self.msns[j]))
            out.traces.append(ITrace.now("deli", "sequence"))
            yield self.doc_ids[j], out


# ---------------------------------------------------------------------------
# the lambda
# ---------------------------------------------------------------------------

class _DocLane:
    """Host bookkeeping for one document's device lane."""

    def __init__(self, lane: int):
        self.lane = lane
        self.interner: Dict[str, int] = {}   # wire client id -> ordinal
        self.ordinals: Dict[int, str] = {}
        self.log_offset = -1
        self.next_ordinal = 0
        # Host mirror of live membership + last activity, for ghost-client
        # eviction (not persisted; _restore re-stamps from the device
        # client table). `evicting` dedups in-flight synthesized leaves.
        self.last_seen: Dict[str, float] = {}
        self.evicting: set = set()

    def intern(self, client_id: str) -> int:
        if client_id not in self.interner:
            self.interner[client_id] = self.next_ordinal
            self.ordinals[self.next_ordinal] = client_id
            self.next_ordinal += 1
        return self.interner[client_id]

    def dump(self) -> dict:
        return {"lane": self.lane, "logOffset": self.log_offset,
                "interner": dict(self.interner),
                "nextOrdinal": self.next_ordinal}

    @staticmethod
    def load(d: dict) -> "_DocLane":
        dl = _DocLane(d["lane"])
        dl.log_offset = d["logOffset"]
        dl.interner = {k: int(v) for k, v in d["interner"].items()}
        dl.ordinals = {v: k for k, v in dl.interner.items()}
        dl.next_ordinal = d["nextOrdinal"]
        return dl


class _Pending:
    """One parsed, not-yet-flushed message."""

    __slots__ = ("kind", "ordinal", "client_seq", "ref_seq", "msg",
                 "client_id")

    def __init__(self, kind: int, ordinal: int, client_seq: int,
                 ref_seq: int, msg: DocumentMessage,
                 client_id: Optional[str]):
        self.kind = kind
        self.ordinal = ordinal
        self.client_seq = client_seq
        self.ref_seq = ref_seq
        self.msg = msg
        self.client_id = client_id


class _SummaryProbe:
    """Parsed channel snapshots from a document's stored summary:
    sequence_number (the summary's protocol seq) + per-(store, channel)
    merge-tree seed payloads (entries, minSeq, seq) and LWW seed payloads
    (kind, header-data).

    Summaries are read by duck typing: a tree with `.entries` and blobs
    with `.content`, as the storage callable returns them."""

    def __init__(self, sequence_number: int,
                 channels: Dict[Tuple[str, str], tuple],
                 lww_channels: Optional[Dict[Tuple[str, str],
                                             tuple]] = None,
                 dir_paths: Optional[Dict[Tuple[str, str], set]] = None):
        self.sequence_number = sequence_number
        self.channels = channels
        self.lww_channels = lww_channels or {}
        # (store, chan+DIR_SUFFIX) -> existing-path set for directory
        # channels (seeded alongside the flattened LWW entries).
        self.dir_paths = dir_paths or {}


# Channel types the LWW lanes can seed from a summary header.
_LWW_SEED_TYPES = {
    "https://graph.microsoft.com/types/map": "map",
    "https://graph.microsoft.com/types/cell": "cell",
    "https://graph.microsoft.com/types/counter": "counter",
}


def _parse_summary_probe(tree) -> Optional[_SummaryProbe]:
    """Walk a container summary (".protocol" blob + ".app" store trees)
    and extract every chunked merge-tree channel body (sequence
    summarize_core format: header {seq, minSeq, chunkCount} + body_i)."""
    import json as _json
    proto = tree.entries.get(".protocol")
    app = tree.entries.get(".app")
    if proto is None or app is None or not hasattr(app, "entries"):
        return None
    try:
        seq = int(_json.loads(proto.content).get("sequenceNumber", 0))
    except (ValueError, TypeError, AttributeError):
        # Client-authored content: malformed protocol blob => no seeding,
        # never a pump crash.
        return None
    stores = app.entries.get(".dataStores")
    if stores is None or not hasattr(stores, "entries"):
        return None
    channels: Dict[Tuple[str, str], tuple] = {}
    lww_channels: Dict[Tuple[str, str], tuple] = {}
    dir_paths: Dict[Tuple[str, str], set] = {}
    for store_id, store_tree in stores.entries.items():
        if not hasattr(store_tree, "entries"):
            continue
        channel_root = store_tree.entries.get(".channels", store_tree)
        if not hasattr(channel_root, "entries"):
            continue
        for channel_id, node in channel_root.entries.items():
            if not hasattr(node, "entries"):
                continue
            # A malformed .attributes blob must not cost a channel its
            # merge seeding — classification just falls back to "".
            ctype = ""
            attrs = node.entries.get(".attributes")
            if attrs is not None:
                try:
                    ctype = _json.loads(attrs.content).get("type", "")
                except (ValueError, TypeError, AttributeError):
                    ctype = ""
            if ctype in _MATRIX_TYPES:
                # Matrix snapshots (dds/matrix.py summarize_core): two
                # axis snapshots seed merge lanes under suffixed names,
                # the cells blob seeds the LWW cell-store lane. Parsed
                # into locals FIRST and committed atomically: a malformed
                # blob must skip the WHOLE matrix (a partially seeded
                # matrix would serve axes inconsistent with its cells).
                try:
                    axis_payloads = {}
                    for blob, suffix in (("rows", MATRIX_ROWS_SUFFIX),
                                         ("cols", MATRIX_COLS_SUFFIX)):
                        snap = _json.loads(node.entries[blob].content)
                        axis_payloads[suffix] = (
                            snap["segments"], int(snap.get("minSeq", 0)),
                            int(snap.get("seq", 0)))
                    cells = _json.loads(node.entries["cells"].content)
                    if not isinstance(cells, dict):
                        raise ValueError("cells blob is not a map")
                except (ValueError, TypeError, KeyError, AttributeError):
                    continue  # malformed client channel: skip, don't crash
                for suffix, payload in axis_payloads.items():
                    channels[(store_id, channel_id + suffix)] = payload
                lww_channels[(store_id,
                              channel_id + MATRIX_CELLS_SUFFIX)] = (
                    "map", cells)
                continue
            if ctype == _DIRECTORY_TYPE:
                # Directory snapshots (dds/directory.py summarize_core):
                # the nested tree flattens into one LWW seed + the
                # existing-path set that gates storage ops.
                lane_name = channel_id + DIR_SUFFIX
                try:
                    data = _json.loads(node.entries["header"].content)
                    entries, paths = _flatten_directory(data)
                except (ValueError, TypeError, KeyError, AttributeError):
                    # Unflattenable snapshot (separator-bearing names,
                    # malformed tree): DEGRADE the lane, don't skip —
                    # a fresh empty lane would silently serve a tree
                    # missing the snapshot content. The unknown seed
                    # kind makes lww.seed mark the channel opaque.
                    lww_channels[(store_id, lane_name)] = (
                        "unmodelable-directory", None)
                    continue
                lww_channels[(store_id, lane_name)] = ("map", entries)
                dir_paths[(store_id, lane_name)] = paths
                continue
            if "header" not in node.entries:
                continue
            try:
                header = _json.loads(node.entries["header"].content)
                lww_kind = _LWW_SEED_TYPES.get(ctype)
                if lww_kind is not None:
                    lww_channels[(store_id, channel_id)] = (lww_kind,
                                                            header)
                    continue
                count = int(header.get("chunkCount", -1))
                if count < 0:
                    continue  # not a chunked merge-tree body
                entries: List[dict] = []
                for i in range(count):
                    entries.extend(_json.loads(
                        node.entries[f"body_{i}"].content))
                payload = (entries, int(header.get("minSeq", 0)),
                           int(header.get("seq", 0)))
            except (ValueError, TypeError, KeyError, AttributeError):
                continue  # malformed client channel: skip, don't crash
            channels[(store_id, channel_id)] = payload
    return _SummaryProbe(seq, channels, lww_channels, dir_paths)


class TpuSequencerLambda(IPartitionLambda):
    """Sequences a partition's documents on the device.

    emit(document_id, SequencedDocumentMessage) and nack(document_id,
    client_id, Nack) have the exact DeliLambda contract, so this lambda is
    a drop-in for the scalar deli in any lambda host.
    """

    def __init__(self, context: LambdaContext,
                 emit: Callable[[str, SequencedDocumentMessage], None],
                 nack: Callable[[str, str, Nack], None],
                 lanes: int = 8, clients_capacity: int = 8,
                 checkpoints=None, deltas=None, fresh_log: bool = False,
                 materialize: bool = True,
                 merge_store: Optional[MergeLaneStore] = None,
                 t_buckets: Tuple[int, ...] = DEFAULT_T_BUCKETS,
                 storage=None, client_timeout_s: float = 300.0,
                 send_system=None, config=None,
                 paged_lanes: bool = False,
                 device: str | torch.device | None = None, mesh=None):
        """storage: optional callable doc_id -> summary tree or None (the
        historian's latest summary). Enables snapshot seeding: merge lanes
        for channels whose base content shipped in a summary bootstrap
        from it instead of overflowing on the first op.

        client_timeout_s: ghost-client eviction window (0 disables) —
        writers silent this long get a synthesized leave so they stop
        pinning the MSN (DeliLambda clientTimeout semantics). config (the
        same nconf slice DeliLambda takes) overrides it via
        deli.clientTimeoutMsec.

        device: where the ticket table and every lane live. None is the
        card and raises without CUDA; the tests pass "cpu". A merge_store
        given by the caller must live on the same device.

        mesh: a parallel.mesh.Mesh to serve on. The ticket lanes and the
        merge / LWW channel lanes shard over its 'dp' axis (lanes are
        independent, so each shard's window runs on its own device; the
        reference's one deli consumer per partition, partitionManager.ts:22,
        collapsed onto one mesh), the paged pool by the partition rules.
        The lambda then dispatches from the mesh's home device, which
        `device` must name (None: the home device)."""
        if mesh is not None:
            home = mesh.home
            if device is not None and \
                    resolve_device(device).type != home.type:
                raise ValueError(f"device {device} is not the mesh's home "
                                 f"device {home}")
            device = home
        self.device = resolve_device(device)
        self.mesh = mesh
        self.context = context
        self.emit = emit
        self.nack = nack
        self.checkpoints = checkpoints
        self.deltas = deltas
        self.storage = storage
        self.client_timeout_s = client_timeout_s
        if config is not None:
            configured = config.get("deli.clientTimeoutMsec", None)
            if configured is not None:
                # Override only when actually configured — an explicit
                # client_timeout_s argument survives an unrelated config.
                self.client_timeout_s = float(configured) / 1000.0
        # Eviction leaves ride the raw log when a producer is available
        # (replay-deterministic, DeliLambda semantics); fallback appends
        # to the in-memory backlog. _DocLane.evicting dedups in-flight.
        self.send_system = send_system
        # doc_id -> parsed summary probe result (None = no usable summary);
        # probed at most once per document per process.
        self._summary_probes: Dict[str, Optional["_SummaryProbe"]] = {}
        # Read-path catch-up watermarks: the max change generation each
        # document's PUBLISHED artifact covers. Advanced only on confirmed
        # publish (catchup_mark_published).
        self._catchup_gen: Dict[str, int] = {}
        # fresh_log=True: this lambda consumes a brand-new MessageLog (a
        # takeover hands over checkpointed state, not the log);
        # checkpointed offsets index the PREVIOUS log and must not gate
        # replay of the new one (DeliLambda fresh_log semantics).
        self.fresh_log = fresh_log
        self.t_buckets = tuple(t_buckets)
        if mesh is not None:
            # Lane counts must divide over dp to shard; doubling growth
            # keeps them so.
            dp = mesh.shape["dp"]
            lanes = -(-max(lanes, dp) // dp) * dp
        self.lanes = lanes
        self.k = clients_capacity
        self.tstate: tk.TicketState = self._place(tk.make_ticket_state(
            self.k, batch=lanes, device=self.device))
        self.docs: Dict[str, _DocLane] = {}
        self.pending: Dict[str, List[_Pending]] = {}
        self.materialize = materialize
        if merge_store is not None and merge_store.device != self.device:
            raise ValueError(
                f"merge_store lives on {merge_store.device}, the lambda on "
                f"{self.device}")
        self.merge = merge_store if merge_store is not None else \
            MergeLaneStore(t_buckets=t_buckets, paged=paged_lanes,
                           device=self.device, mesh=mesh)
        self.lww = LwwLaneStore(t_buckets=t_buckets, device=self.device)
        if getattr(self.merge, "paged", False) and mesh is not None \
                and getattr(self.merge.pages, "mesh", None) is None:
            # A caller's paged store must carry the mesh placement: its
            # pool's placement and dispatch choice (keep, not donate) are
            # fixed when it is built.
            raise ValueError(
                "paged merge_store was constructed without the mesh: "
                "pass mesh= to MergeLaneStore/PagedMergeStore so the "
                "pool places via partition_rules.POOL_PARTITION_RULES "
                "and dispatches through the non-donating variants "
                "(docs/serving_pipeline.md R6).")
        if mesh is not None:
            dp = mesh.shape["dp"]
            for bucket in self.merge.buckets + self.lww.buckets:
                # Grow to a dp multiple BEFORE placing (a mesh wider than
                # the default 8 lanes cannot shard them).
                while bucket.lanes % dp != 0 or bucket.lanes < dp:
                    bucket.grow()
                bucket.placer = self._place
                bucket.state = self._place(bucket.state)
        self._pending_offset: Optional[int] = None
        # Fast-path (raw wire bytes) ingest state: the native pump + its
        # ordinal mirrors. emit_window, when set, receives ONE
        # SequencedWindow per fast flush instead of per-message emits.
        self.emit_window: Optional[Callable[[SequencedWindow], None]] = None
        self._raw_backlog: List[Tuple[int, str, bytes]] = []
        self.poison_frames = 0  # undecodable raw frames dropped (logged)
        self._raw_offsets: Dict[str, int] = {}
        # Pipelined mode (opt-in): clean fast windows defer their result
        # fetch/emit into a bounded FIFO ring of dispatched-but-unread
        # windows, so window k+1's host pack/staging overlaps window k's
        # device execution and window k-1's narrow readback. The ring
        # drains in dispatch order; anything lane-state-dependent (slow
        # windows, fold/rescue, payload GC, summarize extract) forces a
        # full drain first.
        self.pipelined = False
        self.ring_depth = 4            # max dispatched-but-unread entries
        self.adaptive_window = True    # per-flush T/depth from latencies
        self._ring: "deque" = deque()
        # Fused serving bursts: windows whose occupancy-hint fit proofs
        # pass stay STAGED (packed but undispatched) and flush as ONE
        # serve_burst call per burst_depth windows, so the per-window
        # host round trip (dispatch + narrow readback) amortizes over the
        # burst. Burst lengths draw from a fixed grid; a remainder of one
        # window dispatches through plain serve_window.
        self.fused_bursts = True
        self.burst_depth = 8           # staged windows per burst cap
        self._burst_k_grid = (2, 4, 8, 16, 32)
        self._staged: List[dict] = []  # packed-not-yet-dispatched windows
        # On the CPU a dispatch computes its result before it returns; on
        # the card it is queued on the stream and the result's copy to
        # the host completes later. This picks the _device_busy signal
        # that decides when staged windows stop accumulating.
        self._dispatch_blocking = self.device.type == "cpu"
        # Overflow quarantine (mid-ring fold/rescue): channel ordinals
        # whose lanes were rolled back + host-recovered while later
        # windows were already in flight. Those windows' rows for these
        # channels re-apply host-side at their own drain; the sets clear
        # when the ring fully drains.
        self._ring_fixup: set = set()
        self._ring_fixup_lww: set = set()
        # Deferred GC cadence: compactions that came due while windows
        # were in flight (they move lanes, so they only run ring-empty).
        self._gc_due = False
        # Bumped by every fast-path fold/rescue/fixup: a flush's staged
        # lane placement is stale once this moves (re-resolve).
        self._recovery_gen = 0
        # Test/chaos hook: defer even hint-risky windows into the ring,
        # forcing the mid-ring quarantine fixup path that production
        # traffic only hits on unpredicted (overlap/anno-ring) overflow.
        # Donation still follows the gate — risky windows keep their pre
        # states, which the forced recovery then needs.
        self.defer_risky_windows = False
        # Fault-injection hook (testing/faultinject.py stall): called at
        # the top of every flush to model a slow device; None in
        # production.
        self.stall_hook: Optional[Callable[[], float]] = None
        # The native wire pump: its build or load failure raises here.
        self._pump = P.WirePump()
        self._pump_ord: Dict[str, int] = {}     # doc id -> pump ordinal
        self._pump_synced: Dict[str, int] = {}  # doc id -> synced ordinals
        self._pump_known: set = set()
        # Docs the SLOW path interned clients into since the last fast
        # flush: only these re-sync into the pump per flush.
        self._pump_sync_dirty: set = set()
        self._pump_docs: List[Optional[str]] = []   # pump ord -> doc id
        self._pump_lane = np.full(64, -1, np.int32)  # pump ord -> lane
        self._pump_chan: List[tuple] = []           # chan ord -> key tuple
        self._chan_ord: Dict[tuple, int] = {}       # key tuple -> chan ord
        self._lww_key_map = np.full(64, -1, np.int32)  # key ord -> kid
        # Directory lanes: lane key -> set of existing subdirectory paths
        # (host structure; rebuilt by replay, seeded from summaries).
        self._dir_paths: Dict[tuple, set] = {}
        self._restore()

    def _cols(self, arr: np.ndarray) -> torch.Tensor:
        """A host staging array on the lambda's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @property
    def donate_lane_states(self) -> bool:
        """Whether a window may drop its pre lane states (JAX donates
        them). A rule, not a setting: never on a mesh, where JAX keeps
        every window's states (serve_window_keep), so a recovery always
        has its rollback rows and fused bursts stay off."""
        return self.mesh is None

    @property
    def fused_serve(self) -> bool:
        """Whether the fast windows take the fused apply. The fused kernel
        serves one device's lanes: on a mesh the windows take the scan
        apply, as JAX's `_fused_serve` is off there."""
        return self.mesh is None

    def _place(self, tree):
        """A batched tree with its leading (lane) axis sharded over 'dp';
        as it is without a mesh."""
        if self.mesh is None:
            return tree
        return shard_docs(self.mesh, tree)

    # -- checkpoint/restore ------------------------------------------------
    def _restore(self) -> None:
        if self.checkpoints is None:
            return
        rows = list(self.checkpoints.find(
            lambda d: d.get("kind") == "tpu-sequencer"))
        if not rows:
            return
        dump = rows[0]["state"]
        self.docs = {doc: _DocLane.load(d)
                     for doc, d in dump["docs"].items()}
        if self.fresh_log:
            for dl in self.docs.values():
                dl.log_offset = -1
        cols = dump["tstate"]
        self.lanes = len(cols["next_seq"])
        self.k = len(cols["client_ids"][0]) if cols["client_ids"] else self.k
        self.tstate = self._place(interop.ticket_state_from_numpy(
            {name: np.asarray(cols[name],
                              np.bool_ if name == "overflow" else np.int32)
             for name in tk.TicketState._fields}, self.device))
        # Re-arm ghost eviction for members restored into the device
        # client table (last_seen is not persisted): a ghost present at
        # the crash still ages out after restart.
        now = time.time()
        ids = _host(self.tstate.client_ids)
        for dl in self.docs.values():
            for ordinal in ids[dl.lane]:
                if int(ordinal) >= 0:
                    client = dl.ordinals.get(int(ordinal))
                    if client is not None:
                        dl.last_seen[client] = now
        self._rebuild_merge()

    def _probe_summary(self, doc_id: str) -> Optional[_SummaryProbe]:
        if doc_id in self._summary_probes:
            return self._summary_probes[doc_id]
        probe = None
        if self.storage is not None:
            try:
                tree = self.storage(doc_id)
            except Exception:  # noqa: BLE001 — storage backends vary
                # Miss = no seed (correct for fresh documents), but a
                # climbing rate means summaries exist and cannot be read
                # — catch-up is silently replaying whole logs.
                record_swallow("sequencer.summary_probe_miss")
                tree = None
            if tree is not None:
                probe = _parse_summary_probe(tree)
        self._summary_probes[doc_id] = probe
        if probe is not None and probe.sequence_number == 0:
            # Attach summary: NOTHING can predate seq 0, so eagerly seed
            # every channel — summary-only channels (never touched by a
            # live op) materialize for server-side reads too.
            for (store, channel), payload in probe.channels.items():
                self.merge.seed((doc_id, store, channel), *payload)
            for (store, channel), payload in probe.lww_channels.items():
                self._seed_lww((doc_id, store, channel), payload, probe)
        return probe

    def _seed_lww(self, key: tuple, payload: tuple,
                  probe: _SummaryProbe) -> bool:
        """lww.seed + directory path-set installation: a directory lane's
        existence gate must come up with the same snapshot the entries
        seeded from."""
        ok = self.lww.seed(key, *payload)
        if ok and key[2].endswith(DIR_SUFFIX) and key not in self._dir_paths:
            self._dir_paths[key] = set(
                probe.dir_paths.get((key[1], key[2]), {"/"}))
        return ok

    def _rebuild_merge(self) -> None:
        """Crash-restart: rebuild the device merge lanes by replaying each
        known document's sequenced deltas through the kernel in bulk — the
        server-side device catch-up path (reference deltaManager.ts:1380
        fetchMissingDeltas, applied at partition scale). Channels with a
        stored summary seed from it first, then replay only the tail past
        the summary's sequence number."""
        if self.deltas is None or not self.materialize or not self.docs:
            return
        from .lambdas.scriptorium import query_deltas
        next_seq = _host(self.tstate.next_seq)
        streams: Dict[tuple, List[HostOp]] = {}
        lww_streams: Dict[tuple, List[tuple]] = {}
        for doc_id, dl in self.docs.items():
            probe = self._probe_summary(doc_id)
            seeded_before: Dict[tuple, int] = {}
            if probe is not None:
                for (store, channel), payload in probe.channels.items():
                    key = (doc_id, store, channel)
                    if self.merge.seed(key, *payload):
                        # The seeded base already reflects ops <= the
                        # summary seq for THIS channel; unseeded channels
                        # still replay from zero.
                        seeded_before[key] = probe.sequence_number
                for (store, channel), payload in \
                        probe.lww_channels.items():
                    key = (doc_id, store, channel)
                    if self._seed_lww(key, payload, probe):
                        seeded_before[key] = probe.sequence_number
            # Bound at the restored checkpoint's last seq: deltas persisted
            # by a flush that crashed before checkpointing will be
            # re-sequenced by the raw-log replay (same seqs, scriptorium
            # dedups) and applied to the merge lanes THEN — replaying them
            # here too would double-apply.
            last_seq = int(next_seq[dl.lane]) - 1
            for row in query_deltas(self.deltas, doc_id, 0, last_seq):
                if row.get("type") != MessageType.OPERATION or \
                        not row.get("client_id"):
                    continue
                p = _Pending(tk.MsgKind.OP, dl.intern(row["client_id"]),
                             row["client_sequence_number"],
                             row["reference_sequence_number"],
                             DocumentMessage(
                                 client_sequence_number=row[
                                     "client_sequence_number"],
                                 reference_sequence_number=row[
                                     "reference_sequence_number"],
                                 type=row["type"],
                                 contents=row.get("contents")),
                             row["client_id"])
                self._collect_channel_op(streams, lww_streams, doc_id, p,
                                         row["sequence_number"],
                                         row["minimum_sequence_number"],
                                         seeded_before=seeded_before)
        if streams:
            self.merge.apply(streams)
        if lww_streams:
            self.lww.apply(lww_streams)

    def _checkpoint(self) -> None:
        if self._pending_offset is None:
            return
        if self.checkpoints is not None:
            t = {name: col.tolist()
                 for name, col in interop.to_numpy(
                     _gathered(self.tstate)).items()}
            self.checkpoints.upsert(
                lambda d: d.get("kind") == "tpu-sequencer",
                {"kind": "tpu-sequencer", "state": {
                    "docs": {doc: dl.dump() for doc, dl in self.docs.items()},
                    "tstate": t,
                }})
        self.context.checkpoint(self._pending_offset)
        self._pending_offset = None

    # -- ingestion ---------------------------------------------------------
    def handler(self, message: QueuedMessage) -> None:
        if isinstance(message.value, (bytes, bytearray)):
            # Wire-serialized boxcar off the raw log: the native-pump path.
            return self.handler_raw(message)
        boxcar: Boxcar = message.value
        doc_id = boxcar.document_id
        dl = self._doc(doc_id)
        if message.offset <= dl.log_offset:
            return  # checkpointed replay (deli/lambda.ts:143)
        queue = self.pending.setdefault(doc_id, [])
        for msg in boxcar.contents:
            queue.append(self._parse(dl, boxcar.client_id, msg))
        # Slow-path parse may have interned new clients: flag the doc so
        # the next fast flush re-syncs ONLY it into the pump.
        if doc_id in self._pump_known and \
                dl.next_ordinal > self._pump_synced.get(doc_id, 0):
            self._pump_sync_dirty.add(doc_id)
        dl.log_offset = message.offset
        self._pending_offset = message.offset

    def handler_raw(self, message: QueuedMessage) -> None:
        """Raw-log ingest: message.value is a serialized wire boxcar
        (server/wire.py boxcar_to_wire), message.key the document id.
        Bytes are staged as-is; the native pump parses them at flush
        time, so per-message host cost here is a dict probe and a list
        append — the reference's thin socket->kafka producer hop
        (alfred/index.ts:305)."""
        doc_id = message.key
        last = self._raw_offsets.get(doc_id)
        if last is None:
            dl = self.docs.get(doc_id)
            last = dl.log_offset if dl is not None else -1
        if message.offset <= last:
            return  # checkpointed replay (deli/lambda.ts:143)
        if doc_id not in self._pump_known:
            self._register_pump_doc(doc_id)
        # fluidlint: disable=UNBOUNDED_QUEUE — bounded at the front
        # door: this backlog rides occupancy_hints staged_ops into the
        # admission controller's queue depth, which sheds ingest before
        # it can outgrow admission.queueLimit (docs/overload.md); a
        # broker consumer cannot reject mid-partition without wedging
        # the offset cursor.
        self._raw_backlog.append((message.offset, doc_id, message.value))
        self._raw_offsets[doc_id] = message.offset
        self._pending_offset = message.offset

    def _register_pump_doc(self, doc_id: str) -> None:
        """Sync an existing (or brand-new) document into the pump's
        intern tables so pump client ordinals continue any numbering the
        object path or a checkpoint restore already assigned."""
        ord_ = self._pump.preload_doc(doc_id)
        while len(self._pump_docs) <= ord_:
            self._pump_docs.append(None)
        self._pump_docs[ord_] = doc_id
        self._pump_ord[doc_id] = ord_
        self._pump_known.add(doc_id)
        dl = self._doc(doc_id)
        if ord_ >= len(self._pump_lane):
            grown = np.full(max(len(self._pump_lane) * 2, ord_ + 1), -1,
                            np.int32)
            grown[:len(self._pump_lane)] = self._pump_lane
            self._pump_lane = grown
        self._pump_lane[ord_] = dl.lane
        for cid, o in dl.interner.items():
            self._pump.preload_client(ord_, cid, o)
        self._pump_synced[doc_id] = dl.next_ordinal

    def _doc(self, doc_id: str) -> _DocLane:
        dl = self.docs.get(doc_id)
        if dl is None:
            lane = len(self.docs)
            if lane >= self.lanes:
                self._grow_lanes()
            dl = _DocLane(lane)
            self.docs[doc_id] = dl
        return dl

    def _grow_lanes(self) -> None:
        old = self.lanes
        grown = tk.make_ticket_state(self.k, batch=old * 2,
                                     device=self.device)
        self.tstate = self._place(_tree_map(
            lambda g, s: torch.cat([s, g[old:]]), grown,
            _gathered(self.tstate)))
        self.lanes = old * 2

    def _grow_clients(self) -> None:
        k2 = self.k * 2
        t = _gathered(self.tstate)

        def widen(col, fill):
            pad = torch.full((self.lanes, k2 - self.k), fill,
                             dtype=col.dtype, device=col.device)
            return torch.cat([col, pad], dim=1)

        self.tstate = self._place(t._replace(
            client_ids=widen(t.client_ids, -1),
            client_ref=widen(t.client_ref, tk.INT32_MAX),
            client_cseq=widen(t.client_cseq, 0),
        ))
        self.k = k2

    def _parse(self, dl: _DocLane, client_id: Optional[str],
               msg: DocumentMessage) -> _Pending:
        if msg.type == MessageType.CLIENT_JOIN:
            detail = _detail(msg)
            joining = detail.get("clientId", client_id)
            dl.last_seen[joining] = time.time()
            return _Pending(tk.MsgKind.JOIN, dl.intern(joining), 0, 0, msg,
                            None)
        if msg.type == MessageType.CLIENT_LEAVE:
            detail = _detail(msg)
            leaving = detail if isinstance(detail, str) else \
                detail.get("clientId", client_id)
            dl.last_seen.pop(leaving, None)
            dl.evicting.discard(leaving)
            return _Pending(tk.MsgKind.LEAVE, dl.intern(leaving), 0, 0, msg,
                            None)
        if client_id is None:
            return _Pending(tk.MsgKind.SYSTEM, -1, 0, 0, msg, None)
        dl.last_seen[client_id] = time.time()
        return _Pending(tk.MsgKind.OP, dl.intern(client_id),
                        msg.client_sequence_number,
                        msg.reference_sequence_number, msg, client_id)

    # -- the device flush --------------------------------------------------
    def flush(self) -> None:
        """One serving flush. Traced as the ``serving.flush`` parent span
        (continuing the first traced op's context when one is pending)
        with the named sub-spans — pack, dispatch, readback, fold/rescue,
        payload GC — recorded by the stages below; each stage also feeds
        its ``serving.*`` latency histogram unconditionally, so the
        flush-p99/p50 spread attributes to a stage even with tracing
        off (server/monitor.py `/metrics.prom` + SLO)."""
        if self.stall_hook is not None:
            self.stall_hook()
        with tracing.span("serving.flush", parent=self._flush_parent(),
                          root=True, hist="serving.flush") as _fsp:
            # Device-measured sub-facts enrich the flush span: the
            # deltas of the device.* telemetry counters across this
            # flush (windows retired during it — including deferred
            # windows from earlier flushes draining now — attribute
            # here, mirroring the deferred-readback convention).
            tok = device_stats.begin_flush() \
                if device_stats.enabled() else None
            self._flush_traced()
            if tok is not None:
                facts = device_stats.flush_facts(tok)
                if facts:
                    _fsp.set(**facts)

    def occupancy_hints(self) -> dict:
        """Live occupancy for the admission controller (server/
        admission.py): staged-but-unflushed ops (raw fast-path backlog +
        slow-path pending queues) and the in-flight WINDOW fill. Host-
        state reads only — never blocks on the device.

        Window-counted, not entry-counted: a K-window fused burst is one
        ring entry but K windows of committed in-flight work — reporting
        it as fill 1 would let the controller's latency term read a long
        scan step as calm (ring "mostly empty" zeroes the term). Staged
        (packed, not yet dispatched) burst windows count too; the
        controller clamps the resulting fill fraction at 1.0 so bursting
        by design never throttles on its own."""
        return {
            "staged_ops": len(self._raw_backlog)
            + sum(len(q) for q in self.pending.values()),
            "ring_occupancy": self._in_flight_windows(),
            "ring_depth": self.ring_depth,
        }

    def _in_flight_windows(self) -> int:
        """Dispatched-but-unread windows (burst entries count their K)
        plus staged-but-undispatched windows."""
        return sum(e.get("n_windows", 1) for e in self._ring) \
            + len(self._staged)

    def _flush_parent(self):
        """The first pending traced op's context, if any (slow/object
        path only: fast-path backlogs are raw bytes, parsed later)."""
        if not tracing.enabled():
            return None
        for q in self.pending.values():
            for p in q:
                ctx = tracing.message_context(p.msg)
                if ctx is not None:
                    return ctx
        return None

    def _flush_traced(self) -> None:
        fast_active: List[str] = []
        if self._raw_backlog:
            fast_active = self._flush_raw()
        else:
            self.drain()
        # Eviction checks only documents with activity in THIS flush —
        # the scalar deli's per-boxcar scope; a completely quiet document
        # never evicts (its idle writer had no remote ops to heartbeat
        # against either).
        self._evict_ghosts(sorted(
            {d for d, q in self.pending.items() if q} | set(fast_active)))
        if any(self.pending.values()):
            # Slow windows touch the same merge/LWW lanes a deferred fast
            # window's recovery might roll back — settle it first.
            self.drain()
        # Each window consumes at least one pending message per live doc,
        # so this loop is bounded by the backlog length.
        while any(self.pending.values()):
            self._flush_window()
        # Slow-path traffic only ever ticks the compaction cadence INSIDE
        # apply() (where the collection must defer); this is its safe
        # boundary — every window above has fully applied. In-flight ring
        # windows are the same hazard class: their recovery replays
        # op_ids and pre-window rows numbered against the CURRENT table,
        # so no renumbering while any are in flight — and STAGED burst
        # windows more so (their packed cols embed op ids and lane
        # placements that a renumber/compaction would invalidate before
        # they even dispatch).
        if not self._ring and not self._staged:
            if self._gc_due:
                self._run_fast_gc()
            with tracing.span("serving.gc", hist="serving.gc"):
                self.merge.maybe_compact_payload_ids()
            self._checkpoint()
        else:
            # Emit-bearing window drains checkpoint their own offsets.
            # Lane compactions that came due mid-ring must not starve
            # under sustained traffic: once 2x overdue, pay one full
            # drain and run them at the now-safe boundary.
            if self._gc_due and (
                    self.merge.flushes_since_compact
                    >= 2 * self.merge.compact_every
                    or self.lww.windows_since_value_compact
                    >= 2 * self.lww.value_compact_every):
                self.drain()
                self._run_fast_gc()
            gauge("serving.ring_occupancy",
                  float(self._in_flight_windows()))

    def _run_fast_gc(self) -> None:
        """The fast path's due lane compactions, at a ring-empty boundary
        (compact_all/_fold_crowded move lanes; in-flight windows staged
        against the old placement would corrupt their successors)."""
        assert not self._ring and not self._staged
        self._gc_due = False
        # compact_all's _fold_crowded reseeds channels at new (bucket,
        # lane) placements: any flush staging resolved before this point
        # is stale — bump the gen so the window loop re-resolves, exactly
        # as it does after a fold/rescue.
        self._recovery_gen += 1
        with tracing.span("serving.gc", hist="serving.gc"):
            if self.merge.flushes_since_compact >= self.merge.compact_every:
                self.merge.compact_all()
            if self.lww.windows_since_value_compact >= \
                    self.lww.value_compact_every:
                self.lww.compact_values()

    # -- the fast (native-pump) flush --------------------------------------
    def _flush_raw(self) -> List[str]:
        """Flush the raw-bytes backlog through the native pump + fused
        device windows. Documents with shapes the pump cannot model
        (leaves, group ops, items payloads, malformed frames) — or with
        older object-path messages still pending — route their WHOLE
        backlog through the object slow path this flush, preserving
        per-document ordering and exact slow-path semantics."""

        if self.merge.paged:
            # R10 one-in-flight: the previous flush's megakernel ring
            # drains before ANY of this flush's work — the slow-path
            # fallback routing below and the staging's flush_lane_for
            # both read the host page scalars that the drain adopts.
            # Lane GC that came due mid-ring runs at this now-empty
            # boundary (the _flush_traced boundary only fires when the
            # ring is ALREADY empty, which a one-in-flight tail ride
            # would otherwise starve).
            self.drain()
            if self._gc_due:
                self._run_fast_gc()

        backlog = self._raw_backlog
        self._raw_backlog = []
        bufs = [b for _, _, b in backlog]
        # Re-sync pump client interners for docs the SLOW path interned
        # into since the last flush (fallback joins, eviction, restore
        # replay): the pump must never hand out an ordinal the host side
        # already assigned to a different client. Only the dirty set —
        # the full _pump_known sweep was O(docs) per flush even when no
        # slow-path intern had happened.
        if self._pump_sync_dirty:
            for doc_id in self._pump_sync_dirty & self._pump_known:
                dl = self.docs.get(doc_id)
                if dl is None:
                    continue
                synced = self._pump_synced.get(doc_id, 0)
                if dl.next_ordinal > synced:
                    ord_ = self._pump_ord[doc_id]
                    for cid, o in dl.interner.items():
                        if o >= synced:
                            self._pump.preload_client(ord_, cid, o)
                    self._pump_synced[doc_id] = dl.next_ordinal
            self._pump_sync_dirty.clear()
        # The native parse overlaps the in-flight ring windows' device
        # execution and result transfers (pipelined mode); everything
        # lane-state-dependent drains first below.
        with tracing.span("serving.pack", hist="serving.pack",
                          stage="parse"):
            parsed = self._pump.parse(bufs)
            cols = parsed.cols
            self._mirror_pump_interns(parsed)

        # --- fallback routing (doc granularity) ---------------------------
        flags = cols[P.FLAGS]
        doc_col = cols[P.DOC]
        fb_rows = (flags & P.F_FALLBACK) != 0
        slow_ids: set = set()
        for o in np.unique(doc_col[fb_rows]).tolist():
            if o >= 0:
                slow_ids.add(self._pump_docs[o])
        for row in np.flatnonzero(fb_rows & (doc_col < 0)).tolist():
            slow_ids.add(backlog[int(cols[P.BUF, row])][1])
        # Docs with object-path messages still queued must stay ordered.
        slow_ids |= {d for d, q in self.pending.items() if q}

        doc_active: Dict[str, int] = {}
        for off, doc_id, _ in backlog:
            doc_active[doc_id] = max(doc_active.get(doc_id, -1), off)
        for off, doc_id, buf in backlog:
            if doc_id in slow_ids:
                try:
                    value = boxcar_from_wire(buf)
                except Exception as err:  # noqa: BLE001 — untrusted bytes
                    # Deterministic poison: an undecodable log record can
                    # never become valid on redelivery — drop THIS frame
                    # (logged), keep every innocent frame flowing
                    # (reference kafka-service catches extractBoxcar
                    # failures the same way).
                    self.poison_frames += 1
                    logging.getLogger(__name__).warning(
                        "dropping undecodable raw frame for %r at "
                        "offset %s: %s", doc_id, off, err)
                    continue
                self.handler(QueuedMessage(
                    topic="rawdeltas", partition=0, offset=off, key=doc_id,
                    value=value))
        for doc_id, off in doc_active.items():
            if doc_id not in slow_ids:
                self.docs[doc_id].log_offset = max(
                    self.docs[doc_id].log_offset, off)

        # --- fast row selection -------------------------------------------
        n = parsed.n
        fast = ~fb_rows & (cols[P.KIND] != tk.MsgKind.NOOP)
        if slow_ids:
            slow_ords = np.array(
                [o for o, name in enumerate(self._pump_docs)
                 if name in slow_ids], np.int32)
            fast &= ~np.isin(doc_col, slow_ords)
        rows = np.flatnonzero(fast)
        now = time.time()
        if rows.size == 0:
            return sorted(doc_active.keys() - slow_ids)

        # last-seen stamps for eviction (unique (doc, client) pairs).
        dc = (doc_col[rows].astype(np.int64) << 32) | \
            (cols[P.CLIENT, rows].astype(np.int64) & 0xFFFFFFFF)
        for pair in np.unique(dc[cols[P.CLIENT, rows] >= 0]).tolist():
            dl = self.docs[self._pump_docs[pair >> 32]]
            cid = dl.ordinals.get(pair & 0xFFFFFFFF)
            if cid is not None:
                dl.last_seen[cid] = now

        # Pre-size the client table (invariant: overflow on device means a
        # sizing bug, exactly as in the slow path).
        need_k = max((dl.next_ordinal for dl in self.docs.values()),
                     default=0)
        while self.k < need_k:
            self._grow_clients()

        # --- window assignment --------------------------------------------
        lanes_r = self._pump_lane[doc_col[rows]]
        pos = _cumcount(lanes_r)
        max_per_doc = int(pos.max()) + 1
        # Pipelining: clean fast windows defer their result fetch + emit
        # into the in-flight ring (the NEXT flush's native parse then
        # overlaps their transfers). Flushes with slow-routed docs or
        # pending object-path messages stay synchronous — their later
        # work touches the same lane state a deferred recovery might
        # roll back — and drain the ring BEFORE resolving lanes, so a
        # drain-time fold/promotion cannot stale this flush's staging.
        defer_ok = (self.pipelined and not slow_ids
                    and not any(self.pending.values()))
        if not defer_ok:
            self.drain()
        per_doc = np.bincount(lanes_r)
        T, depth = self._adaptive_shape(max_per_doc,
                                        per_doc[per_doc > 0])
        win = (pos // T).astype(np.int64)
        slot = (pos % T).astype(np.int64)
        n_windows = int(win.max()) + 1

        # Payload blocks for the whole flush (op ids + value ids).
        with tracing.span("serving.pack", hist="serving.pack",
                          stage="payload-blocks"):
            merge_all = np.flatnonzero(
                fast & (cols[P.FAMILY] == P.FAM_MERGE))
            mbase, chan_ok, chan_b, chan_l = self._merge_block_and_lanes(
                parsed, merge_all)
            lww_all = np.flatnonzero(fast & (cols[P.FAMILY] == P.FAM_LWW))
            vbase, lchan_ok, lchan_b, lchan_l = self._lww_block_and_lanes(
                parsed, lww_all)

        row_seq = np.zeros(rows.size, np.int32)
        row_msn = np.zeros(rows.size, np.int32)
        # Per-window risk (host occupancy hints): a window whose staged
        # lanes might overflow dispatches SYNCHRONOUSLY behind a full
        # drain — its fold/rescue then runs with nothing in flight (the
        # cheap sync recovery), and the expensive mid-ring quarantine
        # fixup stays reserved for genuinely unpredicted overflow
        # (overlap-slot / anno-ring exhaustion).
        win_m = win[np.searchsorted(rows, merge_all)] \
            if merge_all.size else np.zeros(0, np.int64)
        win_l = win[np.searchsorted(rows, lww_all)] \
            if lww_all.size else np.zeros(0, np.int64)
        risky, donate_ok = self._assess_windows(
            parsed, n_windows, merge_all, win_m, chan_ok, chan_b, chan_l,
            win_l, lchan_ok, lchan_b, lchan_l)
        gen_seen = self._recovery_gen
        if self.merge.paged:
            # --- paged fast flush (R10) -----------------------------------
            # Every window stages a page-group job set into the
            # megakernel ring; the whole flush leaves as ONE
            # serve_megakernel dispatch below (the next flush's
            # top-of-flush drain joins it — depth-1 pipelining). Risky
            # windows (non-insert merge traffic whose overlap/anno rings
            # may exhaust, or LWW fit risk) flush the staged ring and
            # drain immediately so their likely rescue runs with nothing
            # behind it; a rescue moves pages, so the flush re-resolves
            # its group directory before staging more windows (invariant
            # R3, paged form).
            w = 0
            while w < n_windows:
                sel = win == w
                wd = self._stage_fast_window(
                    parsed, rows[sel], lanes_r[sel], slot[sel], T,
                    mbase, chan_ok, chan_b, chan_l,
                    vbase, lchan_ok, lchan_b, lchan_l,
                    row_seq, sel, row_msn,
                    donate=self.donate_lane_states and not risky[w])
                # A risky window's ring rolls back from the pre views, so
                # it dispatches through serve_megakernel_keep.
                wd["risky"] = bool(risky[w])
                self._staged.append(wd)
                increment("serving.ring_windows_deferred")
                wd["counted_deferred"] = True
                if risky[w] or not defer_ok:
                    self._dispatch_staged_megakernel()
                    self.drain()
                    if self._recovery_gen != gen_seen:
                        gen_seen = self._recovery_gen
                        chan_ok, chan_b, chan_l = \
                            self._resolve_merge_lanes(
                                cols[P.CHAN, merge_all])
                        lchan_ok, lchan_b, lchan_l = \
                            self._resolve_lww_lanes(cols[P.CHAN, lww_all])
                        risky, donate_ok = self._assess_windows(
                            parsed, n_windows, merge_all, win_m, chan_ok,
                            chan_b, chan_l, win_l, lchan_ok, lchan_b,
                            lchan_l, start_w=w + 1)
                w += 1
            n_windows = 0  # staging done; the bucketed loop must not run
        burst_on = defer_ok and self.fused_bursts \
            and self.donate_lane_states
        w = 0
        while w < n_windows:
            burst_w = (burst_on and not risky[w]
                       and bool(donate_ok[w]))
            defer_w = defer_ok and (not risky[w]
                                    or self.defer_risky_windows)
            if burst_w or defer_w:
                if not burst_w and self._staged:
                    # A non-burstable window interrupts accumulation:
                    # dispatch the staged run first (FIFO — emits and
                    # lane mutations must land in stage order).
                    increment("serving.burst_breaks")
                    self._dispatch_staged_burst()
                # Bounded ring admission: retire the oldest entry once
                # the ring is full (for burst windows _drain_one first
                # flushes the staged run as a scan, keeping FIFO).
                while len(self._ring) >= depth:
                    self._drain_one()
                if self._ring_fixup or self._ring_fixup_lww:
                    self.drain()
            elif self._staged or self._ring:
                # Sync dispatch (risky or unpipelined): settle every
                # in-flight window first — _finish_window's quarantine
                # direction assumes ring entries are LATER windows.
                # drain() dispatches any staged burst before joining.
                if self._staged:
                    increment("serving.burst_breaks")
                self.drain()
            if self._recovery_gen != gen_seen:
                # A fold/rescue (drained window's, or the previous sync
                # window's own) may have moved channels: re-resolve this
                # flush's lane placement and re-assess the remaining
                # windows (docs/serving_pipeline.md invariant R3).
                gen_seen = self._recovery_gen
                chan_ok, chan_b, chan_l = self._resolve_merge_lanes(
                    cols[P.CHAN, merge_all])
                lchan_ok, lchan_b, lchan_l = self._resolve_lww_lanes(
                    cols[P.CHAN, lww_all])
                risky, donate_ok = self._assess_windows(
                    parsed, n_windows, merge_all, win_m, chan_ok, chan_b,
                    chan_l, win_l, lchan_ok, lchan_b, lchan_l, start_w=w)
                # Re-derive this window's routing against the fresh
                # placement before staging anything.
                continue
            sel = win == w
            wd = self._stage_fast_window(
                parsed, rows[sel], lanes_r[sel], slot[sel], T,
                mbase, chan_ok, chan_b, chan_l,
                vbase, lchan_ok, lchan_b, lchan_l,
                row_seq, sel, row_msn,
                donate=self.donate_lane_states and bool(donate_ok[w]))
            if burst_w:
                self._staged.append(wd)
                increment("serving.ring_windows_deferred")
                # Deferral counted at stage; the dispatch paths below
                # (burst chunk or solo remainder) must not re-count it.
                wd["counted_deferred"] = True
                if len(self._staged) >= self.burst_depth:
                    self._dispatch_staged_burst()
            else:
                self._dispatch_staged_window(wd, defer=defer_w)
            w += 1

        emit_args = (bufs,
                     [self._pump_docs[int(o)] for o in doc_col[rows]],
                     rows, cols, row_seq, row_msn)
        if defer_ok and (self._staged or self._ring):
            # Attached to the flush's LAST window: its drain (after every
            # earlier window filled its row_seq/row_msn slice) emits and
            # checkpoints for the whole flush. Staged windows are always
            # newer than every ring entry (dispatch preserves FIFO).
            if self._staged:
                self._staged[-1]["emit_args"] = emit_args
            else:
                tail = self._ring[-1]
                if "burst" in tail:
                    # The flush's last window already dispatched inside
                    # a burst entry: emits ride that WINDOW's retire so
                    # ordering stays per-window uniform.
                    tail["burst"][-1]["emit_args"] = emit_args
                else:
                    tail["emit_args"] = emit_args
        else:
            self._emit_fast_window(emit_args)
        # Load-adaptive burst sizing: dispatch whatever accumulated the
        # moment the DEVICE goes idle — a single staged window rides
        # plain serve_window (the burst degrades to exactly the
        # per-window ring under light load, keeping the ring's
        # pack/execute overlap), while a device running behind lets
        # staged windows pile up and leave as ONE scan (dispatch count
        # per window shrinks precisely when dispatch pressure is the
        # bottleneck). The burst_depth cap above bounds staging memory
        # and emit latency either way.
        if self._staged and self.merge.paged:
            # R10: the flush's staged windows leave as ONE megakernel
            # dispatch; the NEXT flush's top-of-flush drain joins it.
            self._dispatch_staged_megakernel()
        elif self._staged and not self._device_busy():
            self._dispatch_staged_burst()
        occ = self._in_flight_windows()
        gauge("serving.ring_occupancy", float(occ))
        peak = max(occ, int(counter_get("serving.ring_peak_occupancy")))
        gauge("serving.ring_peak_occupancy", float(peak))
        return sorted(doc_active.keys() - slow_ids)

    def _device_busy(self) -> bool:
        """Is dispatched work still in flight? On the card each ring
        entry's result copy records an event behind its work on the
        stream; an event not yet complete means the card is still working
        through the ring, so staged windows should accumulate into a
        bigger burst rather than queue behind it. On the CPU a dispatch
        has finished when it returns, so undrained ring entries are the
        only in-flight signal: results nobody has joined yet mean nobody
        is waiting, so batching costs nothing — dispatches serialize
        either way."""
        if any("event" in e and not e["event"].query() for e in self._ring):
            return True
        return self._dispatch_blocking and bool(self._ring)

    @staticmethod
    def _start_fetch(entry: dict, flat_dev: torch.Tensor) -> None:
        """Begin the copy of a dispatched result to the host. On the card:
        an asynchronous copy into pinned memory and an event recorded
        behind it, joined by _join_fetch; on the CPU the result exists
        already and is copied out at once (a CPU tensor's .numpy() would
        share its memory)."""
        if flat_dev.device.type == "cuda":
            host = torch.empty(flat_dev.shape, dtype=flat_dev.dtype,
                               pin_memory=True)
            host.copy_(flat_dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            entry["host"] = host
            entry["event"] = event
        else:
            entry["flat"] = flat_dev.numpy().copy()

    @staticmethod
    def _join_fetch(entry: dict) -> None:
        """Wait for _start_fetch's copy; entry["flat"] holds the result."""
        event = entry.pop("event", None)
        if event is not None:
            event.synchronize()
            entry["flat"] = entry.pop("host").numpy()

    def _emit_fast_window(self, emit_args) -> None:
        bufs, doc_ids_r, rows, cols, row_seq, row_msn = emit_args
        ordinals_r = [self.docs[d].ordinals for d in doc_ids_r]
        window = SequencedWindow(bufs, doc_ids_r, ordinals_r, rows, cols,
                                 row_seq, row_msn)
        if self.emit_window is not None:
            self.emit_window(window)
        else:
            for doc_id, msg in window.messages():
                self.emit(doc_id, msg)
        # Compaction cadence bookkeeping (the fast path bypasses
        # MergeLaneStore.apply / LwwLaneStore.apply which normally tick).
        # The compactions themselves ALWAYS defer to the flush-boundary
        # handler (end of flush(), or the starvation drain): this method
        # also runs from a mid-flush _drain_one, where an inline
        # compact_all fold would move lanes the CURRENT flush already
        # resolved staging against — and GC, unlike recovery, does not
        # ride the _recovery_gen staleness re-resolve alone (it bumps
        # the gen too, belt and braces; see _run_fast_gc).
        self.merge.flushes_since_compact += 1
        self.lww.windows_since_value_compact += 1
        due = (self.merge.flushes_since_compact >= self.merge.compact_every
               or self.lww.windows_since_value_compact
               >= self.lww.value_compact_every)
        if due and not self._gc_due:
            self._gc_due = True
            if self._ring:
                increment("serving.ring_gc_deferred")

    def drain(self) -> None:
        """Finish EVERY deferred fast window, oldest first: dispatch any
        staged burst, then join each result transfer, then nacks,
        overflow recovery, the flush's batched emit, and its checkpoint
        — always on the caller's thread, so lane stores are never
        touched concurrently. A completed full drain clears the overflow
        quarantine: every window that could carry a quarantined
        channel's ops has re-applied them."""
        if self._staged:
            self._dispatch_staged()
        while self._ring:
            self._drain_one()
        if self._ring_fixup or self._ring_fixup_lww:
            self._ring_fixup.clear()
            self._ring_fixup_lww.clear()

    def _drain_one(self) -> None:
        """Retire the OLDEST in-flight ring entry (FIFO: emits and lane
        mutations must land in dispatch order). Staged windows dispatch
        FIRST: retiring an entry can run a recovery that moves lanes,
        and staged windows' packed placements must reach the device
        before any move (their results then ride the same quarantine
        fixup every later in-flight window does)."""
        if self._staged:
            self._dispatch_staged()
        ctx = self._ring.popleft()
        increment("serving.ring_drains")
        _t0 = time.perf_counter()
        self._join_fetch(ctx)
        # The deferred window's D2H: attributed to the flush that
        # DISPATCHED it (ctx["trace_ctx"]), measured as the join stall
        # the draining flush actually pays.
        tracing.record_span("serving.readback", ctx.get("trace_ctx"),
                            _t0, time.perf_counter(),
                            hist="serving.readback", deferred=True)
        wins = ctx.get("burst")
        if wins is None:
            self._finish_window(ctx)
            self._retire_window(ctx)
            return
        # A burst entry: ONE stacked readback finishes its K windows in
        # stage order; windows with burst siblings still behind them
        # quarantine any recovery exactly as if the siblings were ring
        # entries. Dispatches-per-burst (1 scan + any recovery re-runs
        # its windows' finish triggers) feeds the burst histogram — the
        # figure the fused-smoke grades at <= 2.
        rec0 = counter_get("serving.recovery_dispatches")
        for k, wd in enumerate(wins):
            wd["flat"] = ctx["flat"][k]
            wd["burst_more"] = k + 1 < len(wins)
            self._finish_window(wd)
            self._retire_window(wd)
        dispatches = 1.0 + (counter_get("serving.recovery_dispatches")
                            - rec0)
        increment("serving.burst_dispatch_total", dispatches)
        observe("serving.dispatches_per_burst", dispatches)

    def _retire_window(self, ctx) -> None:
        """The emit + checkpoint tail of a finished window (only the
        flush-final window of a multi-window flush carries emit_args)."""
        if "emit_args" not in ctx:
            return  # a non-final window of a multi-window flush
        self._emit_fast_window(ctx["emit_args"])
        # Commit only the offsets this window's FLUSH covered; offsets
        # staged after the deferral belong to a flush that has not
        # sequenced yet and must survive a crash for replay.
        newer = self._pending_offset
        self._pending_offset = ctx["offset"]
        self._checkpoint()
        if newer is not None and (ctx["offset"] is None
                                  or newer > ctx["offset"]):
            self._pending_offset = newer

    def _mirror_pump_interns(self, parsed) -> None:
        for ord_, name in parsed.new_docs:
            # Normally empty (handler_raw preloads by queue key); covers
            # a boxcar whose documentId differs from its queue key.
            while len(self._pump_docs) <= ord_:
                self._pump_docs.append(None)
            self._pump_docs[ord_] = name
            dl = self._doc(name)
            if ord_ >= len(self._pump_lane):
                grown = np.full(max(len(self._pump_lane) * 2, ord_ + 1),
                                -1, np.int32)
                grown[:len(self._pump_lane)] = self._pump_lane
                self._pump_lane = grown
            self._pump_lane[ord_] = dl.lane
            self._pump_ord[name] = ord_
            self._pump_synced[name] = dl.next_ordinal
            self._pump_known.add(name)
        for doc_ord, ord_, cid in parsed.new_clients:
            name = self._pump_docs[doc_ord]
            dl = self.docs[name]
            if cid not in dl.interner:
                dl.interner[cid] = ord_
                dl.ordinals[ord_] = cid
                dl.next_ordinal = max(dl.next_ordinal, ord_ + 1)
            # Pump-assigned ordinals are by definition in sync.
            self._pump_synced[name] = max(
                self._pump_synced.get(name, 0), ord_ + 1)
        for chan_ord, doc_ord, store, chan in parsed.new_channels:
            assert chan_ord == len(self._pump_chan)
            key = (self._pump_docs[doc_ord], store, chan)
            self._pump_chan.append(key)
            self._chan_ord[key] = chan_ord
        for ord_, key in parsed.new_keys:
            kid = self.lww.intern_key(key)
            if ord_ >= len(self._lww_key_map):
                grown = np.full(max(len(self._lww_key_map) * 2, ord_ + 1),
                                -1, np.int32)
                grown[:len(self._lww_key_map)] = self._lww_key_map
                self._lww_key_map = grown
            self._lww_key_map[ord_] = kid

    def _merge_block_and_lanes(self, parsed, merge_rows: np.ndarray):
        """Register the flush's merge payload block and resolve each
        channel's (bucket, lane), seeding new channels from stored
        summaries exactly as the slow path does. Returns (op-id base,
        per-row ok mask, bucket array, lane array) aligned to
        merge_rows."""
        from ..mergetree.host import MergeArenaBlock
        cols = parsed.cols
        self._flush_merge_rows = merge_rows
        if merge_rows.size == 0:
            self._flush_merge_block = MergeArenaBlock(
                kinds=np.zeros(0, np.int8), textoff=np.zeros(0, np.int32),
                textlen=np.zeros(0, np.int32), arena=b"", bufs=[],
                pbuf=np.zeros(0, np.int32), pstart=np.zeros(0, np.int32),
                pend=np.zeros(0, np.int32))
            self._flush_merge_block.seqs = np.zeros(0, np.int32)
            return 0, np.zeros(0, bool), np.zeros(0, np.int32), \
                np.zeros(0, np.int32)
        mk = cols[P.MKIND, merge_rows]
        fl = cols[P.FLAGS, merge_rows]
        kinds = np.full(merge_rows.size, MergeArenaBlock.K_NONE, np.int8)
        kinds[(mk == 1) & ((fl & P.F_MARKER) != 0)] = MergeArenaBlock.K_MARKER
        kinds[(mk == 1) & ((fl & P.F_MARKER) == 0)] = MergeArenaBlock.K_TEXT
        kinds[(mk == 1) & ((fl & P.F_RUN) != 0)] = MergeArenaBlock.K_RUN
        kinds[(mk == 1) & ((fl & P.F_ITEMS) != 0)] = MergeArenaBlock.K_ITEMS
        kinds[mk == 3] = MergeArenaBlock.K_ANNOTATE
        block = MergeArenaBlock(
            kinds=kinds,
            textoff=cols[P.TEXTOFF, merge_rows].copy(),
            textlen=cols[P.TEXTLEN, merge_rows].copy(),
            arena=parsed.arena, bufs=parsed.bufs,
            pbuf=cols[P.BUF, merge_rows].copy(),
            pstart=cols[P.PSTART, merge_rows].copy(),
            pend=cols[P.PEND, merge_rows].copy())
        block.seqs = np.zeros(merge_rows.size, np.int32)
        mbase = self.merge.payloads.add_block(block)
        self._flush_merge_block = block
        self._flush_merge_rows = merge_rows

        chans = cols[P.CHAN, merge_rows]
        ok_rows, b_rows, l_rows = self._resolve_merge_lanes(chans)
        # Block aging bookkeeping: which lanes reference which of this
        # block's op ids. Non-admitted rows (opaque/degraded channels —
        # the host object path is authoritative for them) are freed NOW:
        # nothing will ever resolve them, and leaving the entries in
        # place would pin this flush's raw buffers forever. Vectorized
        # grouping + one batched free — this runs per fast flush on the
        # ingest hot path.
        lane_ids: Dict[tuple, list] = {}
        ok_idx = np.flatnonzero(ok_rows)
        if ok_idx.size:
            ch = chans[ok_idx]
            order = np.argsort(ch, kind="stable")  # keeps arrival order
            sorted_ch = ch[order]
            sorted_ids = (mbase + ok_idx[order]).tolist()
            bounds = np.flatnonzero(np.diff(sorted_ch)) + 1
            starts = [0, *bounds.tolist()]
            ends = [*bounds.tolist(), len(sorted_ids)]
            for s, e in zip(starts, ends):
                lane_ids[self._pump_chan[int(sorted_ch[s])]] = \
                    sorted_ids[s:e]
        bad_idx = np.flatnonzero(~ok_rows)
        if bad_idx.size:
            self.merge.free_payloads((mbase + bad_idx).tolist())
        if lane_ids:
            self.merge.note_block(block, lane_ids)
        return mbase, ok_rows, b_rows, l_rows

    def _resolve_merge_lanes(self, chans: np.ndarray):
        """Resolve each merge row's channel to its CURRENT (bucket, lane),
        seeding new channels from stored summaries exactly as the slow
        path does. Idempotent — re-run after a mid-ring recovery moved
        channels (promotion/fold/page rescue) to refresh a flush's
        staging. Paged stores resolve to per-flush (group, lane)
        coordinates in a directory rebuilt here (R10): the group is the
        channel's pow2 page-count class after pre-growing its pages for
        this flush's op count, so the megakernel's gathered views fit
        by construction."""
        uniq, inv = np.unique(chans, return_inverse=True)
        ok_u = np.zeros(uniq.size, bool)
        b_u = np.zeros(uniq.size, np.int32)
        l_u = np.zeros(uniq.size, np.int32)
        paged = self.merge.paged
        if paged:
            self.merge.begin_flush_groups()
            n_by_u = np.bincount(inv, minlength=uniq.size)
        for j, ch in enumerate(uniq.tolist()):
            key = self._pump_chan[ch]
            if key in self.merge.opaque:
                continue
            if key not in self.merge.where and self.storage is not None:
                probe = self._probe_summary(key[0])
                if probe is not None:
                    payload = probe.channels.get((key[1], key[2]))
                    if payload is not None:
                        self.merge.seed(key, *payload)
                        if key in self.merge.opaque:
                            continue
            if paged:
                bb, ll = self.merge.flush_lane_for(key, int(n_by_u[j]))
            else:
                bb, ll = self.merge.lane_for(key)
            self.merge.mark_dirty(key)
            ok_u[j] = True
            b_u[j] = bb
            l_u[j] = ll
        return ok_u[inv], b_u[inv], l_u[inv]

    def _lww_block_and_lanes(self, parsed, lww_rows: np.ndarray):
        cols = parsed.cols
        self._flush_lww_rows = lww_rows
        if lww_rows.size == 0:
            return 0, np.zeros(0, bool), np.zeros(0, np.int32), \
                np.zeros(0, np.int32)
        vstart = np.where((cols[P.FLAGS, lww_rows] & P.F_VALUE) != 0,
                          cols[P.PSTART, lww_rows], -1)
        block = _LwwValueBlock(parsed.bufs, cols[P.BUF, lww_rows].copy(),
                               vstart, cols[P.PEND, lww_rows].copy())
        vbase = self.lww.add_value_block(block)
        ok, b, lane = self._resolve_lww_lanes(cols[P.CHAN, lww_rows])
        return vbase, ok, b, lane

    def _resolve_lww_lanes(self, chans: np.ndarray):
        """LWW side of _resolve_merge_lanes (same idempotence contract)."""
        uniq, inv = np.unique(chans, return_inverse=True)
        ok_u = np.zeros(uniq.size, bool)
        b_u = np.zeros(uniq.size, np.int32)
        l_u = np.zeros(uniq.size, np.int32)
        for j, ch in enumerate(uniq.tolist()):
            key = self._pump_chan[ch]
            if key in self.lww.opaque:
                continue
            if key not in self.lww.where and self.storage is not None:
                probe = self._probe_summary(key[0])
                if probe is not None:
                    payload = probe.lww_channels.get((key[1], key[2]))
                    if payload is not None:
                        self._seed_lww(key, payload, probe)
                        if key in self.lww.opaque:
                            continue
            bb, ll = self.lww.lane_for(key)
            self.lww.mark_dirty(key)
            ok_u[j] = True
            b_u[j] = bb
            l_u[j] = ll
        return ok_u[inv], b_u[inv], l_u[inv]

    def _adaptive_shape(self, max_per_doc: int,
                        doc_depths: Optional[np.ndarray] = None
                        ) -> Tuple[int, int]:
        """Pick the window op-depth T and the per-flush ring depth from
        the backlog's per-doc depth distribution plus the rolling
        serving.pack/dispatch/readback histograms.

        The op-depth always comes from the FIXED t_buckets grid — the
        adaptive policy changes which bucket is chosen, never the shape
        vocabulary, so the set of window shapes stays bounded.

        Policy: T follows the p95 per-doc depth, not the max. A RAGGED
        backlog (one storm doc atop a fleet of keystroke docs) would
        otherwise pad EVERY lane to the deepest doc — [B, T] staging and
        the scan kernel's step count both scale with T — so the bulk of
        the fleet rides one narrow window and only the storm doc spans
        the extra ring slots. A uniform backlog keeps its exact-depth
        single window: splitting below the backlog depth only multiplies
        the per-dispatch cost since the ring already overlaps
        pack/execute/readback ACROSS windows. The rolling histograms steer the ring depth:
        host-bound traffic (keystroke bursts) shortens the ring so
        results emit sooner; device/transfer-bound traffic keeps it deep
        for overlap."""
        max_t = self.t_buckets[-1]
        need = min(max_per_doc, max_t)
        T = _bucket(need, self.t_buckets)
        depth = 1
        if self.pipelined:
            depth = self.ring_depth
            if self.adaptive_window:
                if doc_depths is not None and doc_depths.size \
                        and need > self.t_buckets[0]:
                    p95 = int(np.percentile(doc_depths, 95))
                    p95b = _bucket(max(1, min(p95, max_t)),
                                   self.t_buckets)
                    # Smallest bucket >= the p95 depth whose window
                    # count stays bounded (the storm doc alone spans
                    # the extra windows; everyone else rides one).
                    for cand in self.t_buckets:
                        if cand < p95b or cand >= T:
                            continue
                        if -(-need // cand) <= max(depth, 8):
                            T = cand
                            break

                def p50(name: str) -> float:
                    w = latency_window(name)
                    return nearest_rank(sorted(w), 0.50) if w else 0.0

                host_ms = p50("serving.pack")
                dev_ms = p50("serving.dispatch") + p50("serving.readback")
                if host_ms > 0.0 and dev_ms <= 0.25 * host_ms:
                    # Host-bound keystroke traffic: shallow ring (emit
                    # latency over overlap).
                    depth = min(depth, 2)
        gauge("serving.ring_depth", float(depth))
        gauge("serving.window_t", float(T))
        return T, depth

    def _stage_fast_window(self, parsed, rows, lanes, slot, T,
                           mbase, chan_ok, chan_b, chan_l,
                           vbase, lchan_ok, lchan_b, lchan_l,
                           row_seq, flush_sel, row_msn,
                           donate: bool = False) -> dict:
        """Pack one fast window into host staging arrays + job records —
        everything the dispatch needs EXCEPT the device call, so a
        window can sit in the staged-burst queue across flushes. The
        in-flight occupancy bound (hint_pending) is charged HERE: later
        flushes' fit proofs must see staged windows' worst-case rows
        whether or not they have dispatched yet."""
        cols = parsed.cols
        B = self.lanes

        with tracing.span("serving.pack", hist="serving.pack",
                          stage="window-staging"):
            ticket_cols = np.zeros((4, B, T), np.int32)
            ticket_cols[1] = -1
            ticket_cols[0, lanes, slot] = cols[P.KIND, rows]
            ticket_cols[1, lanes, slot] = cols[P.CLIENT, rows]
            ticket_cols[2, lanes, slot] = cols[P.CSEQ, rows]
            ticket_cols[3, lanes, slot] = cols[P.REFSEQ, rows]

            merge_jobs = self._build_merge(parsed, rows, lanes, slot,
                                           mbase, chan_ok, chan_b, chan_l)
            lww_jobs = self._build_lww(parsed, rows, lanes, slot,
                                       vbase, lchan_ok, lchan_b, lchan_l)

        # In-flight occupancy bound: each staged merge op adds at most 2
        # rows, each LWW op at most one key slot; confirmed exactly (and
        # removed from pending) when this window's occupancy plane comes
        # back at its drain. Paged merge needs no charge — flush_lane_for
        # pre-grew every member's pages for the whole flush's op count.
        if not self.merge.paged:
            for j in merge_jobs:
                np.add.at(self.merge.buckets[j["bucket"]].hint_pending,
                          j["lanes"], 2)
        for j in lww_jobs:
            np.add.at(self.lww.buckets[j["bucket"]].hint_pending,
                      j["lanes"], 1)

        return {"parsed": parsed, "B": B, "T": T, "rows": rows,
                "lanes": lanes, "slot": slot,
                "idx": np.flatnonzero(flush_sel),
                "ticket_cols": ticket_cols,
                "merge_jobs": merge_jobs, "lww_jobs": lww_jobs,
                "mbase": mbase, "block": self._flush_merge_block,
                "row_seq": row_seq, "row_msn": row_msn,
                "donated": donate,
                # Staged placements go stale the moment a recovery moves
                # lanes; the GC/drain discipline guarantees gen cannot
                # move while a window sits staged (staged bursts always
                # dispatch before any join/recovery), so stage-time gen
                # IS dispatch-time gen.
                "gen": self._recovery_gen,
                # The offsets THIS window covers: drain() must commit
                # exactly these — the live _pending_offset may already
                # include a newer, not-yet-dispatched backlog.
                "offset": self._pending_offset,
                # The flush's trace position, so the deferred readback
                # (joined by a LATER flush's drain) attributes to the
                # window that dispatched it, not the one that drained it.
                "trace_ctx": tracing.current()}

    def _pad_staged_window(self, wd: dict) -> None:
        """Re-shape a staged window's cols to CURRENT table widths: doc
        lanes and bucket lanes may have grown (new docs/channels in a
        later flush) between staging and dispatch. Growth only appends
        lanes, so zero-padding the lane axis (NOOP rows) is exact; T/Tm
        never change after staging."""
        B = self.lanes
        tc = wd["ticket_cols"]
        if tc.shape[1] < B:
            grown = np.zeros((4, B, tc.shape[2]), np.int32)
            grown[1] = -1
            grown[:, :tc.shape[1], :] = tc
            wd["ticket_cols"] = grown
        wd["B"] = B
        for j in wd["merge_jobs"]:
            if self.merge.paged:
                # R10: pad to the flush group's CURRENT pow2 width —
                # later windows of the same flush may have admitted more
                # members into the group.
                width = self.merge.flush_groups[j["bucket"]].lanes
            else:
                width = self.merge.buckets[j["bucket"]].lanes
            c = j["cols"]
            if c is not None and c.shape[1] < width:
                grown = np.zeros((12, width, c.shape[2]), np.int32)
                grown[:, :c.shape[1], :] = c
                j["cols"] = grown
                if j["runs"] is not None:
                    r = j["runs"]
                    rg = np.zeros((4, width) + r.shape[2:],
                                  np.int32)
                    rg[:, :r.shape[1]] = r
                    j["runs"] = rg
            j["lanes_n"] = width
        for j in wd["lww_jobs"]:
            bucket = self.lww.buckets[j["bucket"]]
            c = j["cols"]
            if c is not None and c.shape[1] < bucket.lanes:
                grown = np.zeros((6, bucket.lanes, c.shape[2]), np.int32)
                grown[1] = -1
                grown[2] = -1
                grown[:, :c.shape[1], :] = c
                j["cols"] = grown
            j["lanes_n"] = bucket.lanes

    def _dispatch_staged_window(self, wd: dict, defer: bool) -> None:
        """Dispatch ONE staged window: one serve_window call, then either
        an immediate result fetch (_finish_window) or — pipelined — an
        asynchronous copy joined by the next drain()."""
        self._pad_staged_window(wd)
        donate = wd["donated"]
        merge_jobs, lww_jobs = wd["merge_jobs"], wd["lww_jobs"]
        ticket_cols = wd["ticket_cols"]

        # The donation mark (decided by _assess_windows' occupancy-hint
        # fit proof): serve_window builds new tensors either way, so the
        # mark decides only what a recovery may roll back. Donated
        # windows drop their pre states (an overflow there degrades the
        # channel, as JAX's donated window must); kept windows retain
        # them for the fold/rescue rollback.
        increment("serving.ring_donated_windows" if donate
                  else "serving.ring_kept_windows")
        increment("serving.window_dispatches")

        # Device telemetry plane (telemetry/device_stats.py): static at
        # dispatch, stamped on the window so _finish_window decodes the
        # flat16 tail only when this window actually carried it.
        stats_on = device_stats.enabled()
        wd["stats"] = stats_on

        # ONE serve_window call for the whole window (ticket scan, fused
        # or scan apply per bucket, LWW apply, the narrow pack), then ONE
        # host read of the narrow int16 result (msn32_dev is fetched only
        # on the rare msn-span overflow).
        step = serve_step.serve_window
        with tracing.span("serving.dispatch", hist="serving.dispatch"):
            with compile_ledger.track("serve.window", step):
                (self.tstate, new_merge, new_lww, flat_dev,
                 msn32_dev) = step(
                    self.tstate, self._cols(ticket_cols),
                    [self.merge.buckets[j["bucket"]].state
                     for j in merge_jobs],
                    [self._cols(j["cols"]) for j in merge_jobs],
                    [self.lww.buckets[j["bucket"]].state
                     for j in lww_jobs],
                    [self._cols(j["cols"]) for j in lww_jobs],
                    [None if j["runs"] is None else self._cols(j["runs"])
                     for j in merge_jobs],
                    stats_on, fused=self.fused_serve)
        for j, post in zip(merge_jobs, new_merge):
            self.merge.buckets[j["bucket"]].state = post
            if donate:
                # A donated window keeps no pre state: a recovery of it
                # takes the explicit pre-is-None degrade.
                j["pre"] = None
        for j, post in zip(lww_jobs, new_lww):
            self.lww.buckets[j["bucket"]].state = post
            if donate:
                j["pre"] = None

        wd["msn32_dev"] = msn32_dev
        if defer:
            self._start_fetch(wd, flat_dev)
            self._ring.append(wd)
            if not wd.pop("counted_deferred", False):
                increment("serving.ring_windows_deferred")
        else:
            with tracing.span("serving.readback",
                              hist="serving.readback"):
                wd["flat"] = _host(flat_dev)  # the window's ONE sync
            self._finish_window(wd)

    def _dispatch_staged_burst(self) -> None:
        """Dispatch EVERY staged window, oldest first, as fused serving
        bursts: consecutive staged windows sharing a ticket depth T
        chunk into burst lengths from the fixed grid; a remainder of one
        dispatches through plain serve_window. Always empties the staged
        queue — callers rely on 'staged dispatched before any join' to
        keep recovery quarantine's window-ordering invariant."""
        staged, self._staged = self._staged, []
        for chunk in self._burst_chunks(staged):
            if len(chunk) >= 2:
                self._dispatch_burst_chunk(chunk)
            else:
                self._dispatch_staged_window(chunk[0], defer=True)

    def _burst_chunks(self, staged: List[dict]) -> List[List[dict]]:
        """Split the staged queue, in order, into runs of one ticket depth
        T (T is baked into the stacked ticket planes and the flat16
        layout), each cut greedily into the largest grid lengths."""
        chunks = []
        i = 0
        while i < len(staged):
            run = i + 1
            while (run < len(staged)
                   and staged[run]["T"] == staged[i]["T"]):
                run += 1
            while i < run:
                left = run - i
                k = 1
                for cand in self._burst_k_grid:
                    if cand <= left:
                        k = cand
                chunks.append(staged[i:i + k])
                i += k
        return chunks

    @staticmethod
    def _stack_jobs(wins: List[dict], job_lists, lanes_of, ncols: int,
                    fills=()):
        """Union-bucket stacking: per bucket (or page group) id one
        [K, ncols, lanes, Tm] plane (+ runs for merge); windows without
        the bucket ride all-NOOP padding, and every window's job list is
        rewritten union-aligned so _finish_window parses the shared
        flat16 layout. Returns (ids, planes, runs planes, aligned job
        lists), numpy."""
        K = len(wins)
        ids = sorted({j["bucket"] for jl in job_lists for j in jl})
        xs, rxs = [], []
        aligned: List[List[dict]] = [[] for _ in wins]
        for b in ids:
            width = lanes_of(b)
            jobs = [next((j for j in jl if j["bucket"] == b), None)
                    for jl in job_lists]
            tm = max(j["cols"].shape[2] for j in jobs if j is not None)
            arr = np.zeros((K, ncols, width, tm), np.int32)
            for plane, fill in fills:
                arr[:, plane] = fill
            has_runs = any(j is not None and j.get("runs") is not None
                           for j in jobs)
            rarr = np.zeros((K, 4, width, tm, RUN_K), np.int32) \
                if has_runs else None
            for k, j in enumerate(jobs):
                if j is None:
                    aligned[k].append(
                        TpuSequencerLambda._empty_job(b, width))
                    continue
                c = j["cols"]
                arr[k, :, :c.shape[1], :c.shape[2]] = c
                if rarr is not None and j.get("runs") is not None:
                    r = j["runs"]
                    rarr[k, :, :r.shape[1], :r.shape[2], :] = r
                aligned[k].append(j)
            xs.append(arr)
            rxs.append(rarr)
        return ids, xs, rxs, aligned

    def _ticket_stack(self, wins: List[dict]) -> np.ndarray:
        """[K, 4, B, T] ticket planes; every member passed
        _pad_staged_window, so each fills its full slice."""
        tx = np.empty((len(wins), 4, self.lanes, wins[0]["T"]), np.int32)
        for k, wd in enumerate(wins):
            tx[k] = wd["ticket_cols"]
        return tx

    def _enter_ring(self, wins: List[dict], flats_dev) -> None:
        """A burst or megakernel ring entry: its drain finishes all K
        windows off the stacked narrow result."""
        entry = {"burst": wins, "n_windows": len(wins),
                 "trace_ctx": wins[-1]["trace_ctx"]}
        self._start_fetch(entry, flats_dev)
        self._ring.append(entry)

    def _dispatch_burst_chunk(self, wins: List[dict]) -> None:
        """ONE serve_burst call for K staged windows: stack every
        window's packed op planes (NOOP-padded to the union of staged
        buckets), run the K windows back to back on the card, and enter
        the ring as a single entry."""
        K = len(wins)
        for wd in wins:
            self._pad_staged_window(wd)

        with tracing.span("serving.pack", hist="serving.pack",
                          stage="burst-stack"):
            tx = self._ticket_stack(wins)
            m_ids, merge_xs, runs_xs, m_aligned = self._stack_jobs(
                wins, [wd["merge_jobs"] for wd in wins],
                lambda b: self.merge.buckets[b].lanes, 12)
            l_ids, lww_xs, _, l_aligned = self._stack_jobs(
                wins, [wd["lww_jobs"] for wd in wins],
                lambda b: self.lww.buckets[b].lanes, 6,
                ((1, -1), (2, -1)))

        stats_on = device_stats.enabled()
        with tracing.span("serving.dispatch", hist="serving.dispatch"):
            with compile_ledger.track("serve.burst", serve_step.serve_burst):
                (self.tstate, new_merge, new_lww, flats_dev,
                 msns_dev) = serve_step.serve_burst(
                    self.tstate,
                    tuple(self.merge.buckets[b].state for b in m_ids),
                    tuple(self.lww.buckets[b].state for b in l_ids),
                    self._cols(tx),
                    tuple(self._cols(x) for x in merge_xs),
                    tuple(self._cols(x) for x in lww_xs),
                    tuple(None if r is None else self._cols(r)
                          for r in runs_xs),
                    stats_on)
        for k, wd in enumerate(wins):
            # Union-aligned job lists: each window's _finish_window
            # parses the SHARED flat16 layout (one plane set per union
            # bucket), so its jobs must cover every union bucket in
            # order — placeholders for buckets it never staged.
            wd["merge_jobs"] = m_aligned[k]
            wd["lww_jobs"] = l_aligned[k]
            wd["stats"] = stats_on
            # The burst body runs with noop_skip: the host mirror of the
            # device skip counter needs to know (solo windows never
            # count skips).
            wd["noop_skip"] = True
        for b, post in zip(m_ids, new_merge):
            self.merge.buckets[b].state = post
        for b, post in zip(l_ids, new_lww):
            self.lww.buckets[b].state = post
        for k, wd in enumerate(wins):
            for j in wd["merge_jobs"] + wd["lww_jobs"]:
                # Burst windows keep no per-window pre states (burst
                # admission proved them overflow-free; unpredicted
                # overflow takes the donated degrade + quarantine path,
                # exactly as per-window donation).
                j["pre"] = None
            wd["msn32_dev"] = msns_dev[k]
        increment("serving.ring_donated_windows", K)
        increment("serving.bursts")
        increment("serving.burst_windows", K)
        self._enter_ring(wins, flats_dev)

    @staticmethod
    def _empty_job(bucket: int, lanes_n: int) -> dict:
        """A window's placeholder for a union bucket it never staged:
        zero rows, so _finish_window's hint/recovery walks are no-ops,
        but lanes_n keeps the shared flat16 plane layout parseable."""
        z = np.zeros(0, np.int64)
        return {"bucket": bucket, "pre": None, "cols": None, "runs": None,
                "lanes_n": lanes_n, "chan": z, "rows": z, "lanes": z,
                "op_ids": z, "val_ids": z, "doc_lane": z, "slot": z}

    def _dispatch_staged(self) -> None:
        """Route the staged queue to its storage layout's dispatcher."""
        if self.merge.paged:
            self._dispatch_staged_megakernel()
        else:
            self._dispatch_staged_burst()

    def _dispatch_staged_megakernel(self) -> None:
        """Dispatch EVERY staged window, oldest first, as serving
        megakernels: consecutive windows sharing a ticket depth T chunk
        into ring lengths from the fixed burst grid. Always empties the
        staged queue — same contract as _dispatch_staged_burst.

        Each chunk after the first waits for the ring to drain: a chunk
        stages its groups' page scalars from the host at dispatch, and
        the host holds them only once the chunk before it has finished
        (its drain adopts the scalars it wrote). Dispatched back to back,
        chunk k+1 would build its views from chunk k's stale counts and
        scatter them over chunk k's rows."""
        staged, self._staged = self._staged, []
        for i, chunk in enumerate(self._burst_chunks(staged)):
            if i:
                self.drain()
            self._dispatch_megakernel_chunk(chunk)

    def _dispatch_megakernel_chunk(self, wins: List[dict]) -> None:
        """ONE serve_megakernel call for K staged paged windows: gather
        every flush group's pages into views, apply the K windows' op
        planes to them (the fused-apply kernel with its extract variant,
        or the scan apply above the fused capacity), scatter the views
        back, and enter the ring as a single entry whose drain finishes
        all K windows off the stacked narrow flat16 result. Group page
        ids and pre-ring scalars are staged HERE, at dispatch time: the
        ring is one-in-flight, so the host scalars are authoritative
        until this entry drains.

        serve_megakernel scatters into the page pool in place; a ring
        holding a risky window goes through serve_megakernel_keep, which
        leaves the pool it was given untouched. Either returns the
        gathered pre-ring views that a rescue rolls back from."""
        K = len(wins)
        for wd in wins:
            self._pad_staged_window(wd)

        with tracing.span("serving.pack", hist="serving.pack",
                          stage="megakernel-stack"):
            tx = self._ticket_stack(wins)
            m_ids, merge_xs, runs_xs, m_aligned = self._stack_jobs(
                wins, [wd["merge_jobs"] for wd in wins],
                lambda g: self.merge.flush_groups[g].lanes, 12)
            l_ids, lww_xs, _, l_aligned = self._stack_jobs(
                wins, [wd["lww_jobs"] for wd in wins],
                lambda b: self.lww.buckets[b].lanes, 6,
                ((1, -1), (2, -1)))
            # Page-id tables + pre-ring scalars per union group, staged
            # at dispatch (host-authoritative under one-in-flight).
            pg = self.merge.pages
            group_info: Dict[int, dict] = {}
            pids_l, counts_l, mins_l, seqs_l = [], [], [], []
            for g in m_ids:
                grp = self.merge.flush_groups[g]
                n_pad, pids, counts, mins, seqs = \
                    self.merge._stage_paged_group(grp.keys)
                assert n_pad == grp.lanes
                group_info[g] = {"keys": list(grp.keys), "pids": pids}
                pids_l.append(self._cols(pids))
                counts_l.append(self._cols(counts))
                mins_l.append(self._cols(mins))
                seqs_l.append(self._cols(seqs))

        stats_on = device_stats.enabled()
        keep = any(wd.get("risky") for wd in wins) \
            or not self.donate_lane_states
        fn = serve_step.serve_megakernel_keep if keep \
            else serve_step.serve_megakernel
        name = "serve.megakernel_keep" if keep else "serve.megakernel"
        with tracing.span("serving.dispatch", hist="serving.dispatch"):
            with compile_ledger.track(name, fn):
                (self.tstate, pool2, new_lww, flats_dev, msns_dev,
                 pre_views) = fn(
                    self.tstate, pg.pool,
                    tuple(self.lww.buckets[b].state for b in l_ids),
                    self._cols(tx), tuple(pids_l), tuple(counts_l),
                    tuple(mins_l), tuple(seqs_l),
                    tuple(self._cols(x) for x in merge_xs),
                    tuple(self._cols(x) for x in lww_xs),
                    tuple(None if r is None else self._cols(r)
                          for r in runs_xs),
                    stats_on, fused=self.fused_serve)

        pg.adopt_pool(pool2)
        for b, post in zip(l_ids, new_lww):
            self.lww.buckets[b].state = post
        shared = {"wins": wins, "pre": list(pre_views),
                  "groups": group_info, "order": list(m_ids)}
        for k, wd in enumerate(wins):
            wd["merge_jobs"] = m_aligned[k]
            wd["lww_jobs"] = l_aligned[k]
            wd["stats"] = stats_on
            wd["noop_skip"] = True
            wd["paged"] = True
            wd["paged_shared"] = shared
            for j in wd["merge_jobs"] + wd["lww_jobs"]:
                # Per-window bucket pre states never exist on this path:
                # the megakernel's readback carries the pre views.
                j["pre"] = None
            wd["msn32_dev"] = msns_dev[k]
        increment("serving.megakernel_rings")
        increment("serving.megakernel_windows", K)
        increment("serving.bursts")
        increment("serving.burst_windows", K)
        self._enter_ring(wins, flats_dev)

    def _assess_windows(self, parsed, n_windows: int,
                        merge_all, win_m, chan_ok, chan_b, chan_l,
                        win_l, lchan_ok, lchan_b, lchan_l,
                        start_w: int = 0):
        """Per-window (risky, donate_ok) from the host occupancy hints.

        risky[w]: some staged lane's ROW fit cannot be proven —
        `hint + 2*inserts + 8 > capacity` (merge, each op adds at most 2
        rows) or `hint + ops + 4 > capacity` key slots (LWW). Risky
        windows dispatch synchronously so their likely fold/rescue runs
        the cheap empty-ring recovery.

        donate_ok[w]: not risky AND insert-only merge traffic — removes
        touch the overlap ring and annotates the anno ring, neither
        bounded by the count hint, so those windows keep their pre
        states (their rare exhaustion overflow needs the rollback). The
        margins mirror the recovery paths' +8 re-run slack convention.

        The bound ACCUMULATES across this flush's windows (from
        `start_w`, where earlier windows' charges already live in
        hint_pending): window w's fit proof counts windows start_w..w-1
        worst-case rows on the shared lanes, because none of them will
        have confirmed occupancy before w dispatches — with fused bursts
        a whole run of windows dispatches in one scan before ANY plane
        comes back, so a per-window-only bound would under-count deep
        docs and break the donated-dispatch soundness invariant."""
        cols = parsed.cols
        risky = np.zeros(n_windows, bool)
        donate_ok = np.ones(n_windows, bool)
        acc_m: Dict[int, np.ndarray] = {}
        acc_l: Dict[int, np.ndarray] = {}
        mk = cols[P.MKIND, merge_all] if merge_all.size else None
        paged = self.merge.paged
        for w in range(start_w, n_windows):
            if mk is not None and paged:
                # R10: paged merge has no row-fit risk (flush_lane_for
                # pre-grew pages for the flush's worst case) but
                # non-insert traffic still forfeits donation — removes
                # and annotates touch the overlap/anno rings, whose
                # exhaustion needs the pre views for rollback. The
                # megakernel keeps pre views in its own readback, so
                # this only routes the window to an immediate
                # dispatch+drain (nothing stacks behind a likely
                # rescue).
                ws = chan_ok & (win_m == w)
                if ws.any() and np.any(mk[ws] != 1):
                    risky[w] = True
            elif mk is not None:
                ws = chan_ok & (win_m == w)
                if ws.any():
                    if np.any(mk[ws] != 1):
                        donate_ok[w] = False
                    for b in np.unique(chan_b[ws]).tolist():
                        bucket = self.merge.buckets[b]
                        bsel = ws & (chan_b == b)
                        ins = np.bincount(chan_l[bsel & (mk == 1)],
                                          minlength=bucket.lanes)
                        touched = np.unique(chan_l[bsel])
                        acc = acc_m.setdefault(
                            b, np.zeros(bucket.lanes, np.int64))
                        bound = bucket.count_hint[touched] \
                            + bucket.hint_pending[touched] \
                            + acc[touched]
                        if np.any(bound + 2 * ins[touched] + 8
                                  > bucket.capacity):
                            risky[w] = True
                        acc += 2 * ins
            if lchan_ok.size:
                ws = lchan_ok & (win_l == w)
                if ws.any():
                    for b in np.unique(lchan_b[ws]).tolist():
                        bucket = self.lww.buckets[b]
                        bsel = ws & (lchan_b == b)
                        per = np.bincount(lchan_l[bsel],
                                          minlength=bucket.lanes)
                        touched = np.unique(lchan_l[bsel])
                        acc = acc_l.setdefault(
                            b, np.zeros(bucket.lanes, np.int64))
                        bound = bucket.count_hint[touched] \
                            + bucket.hint_pending[touched] \
                            + acc[touched]
                        if np.any(bound + per[touched] + 4
                                  > bucket.capacity):
                            risky[w] = True
                        acc += per
        donate_ok &= ~risky
        return risky, donate_ok

    def _finish_window(self, ctx) -> None:
        """The post-fetch half of a fast window: seq/msn distribution,
        invariant checks, nack emission, (rare) overflow recovery."""
        parsed = ctx["parsed"]
        cols = parsed.cols
        B, T = ctx["B"], ctx["T"]
        rows, lanes, slot = ctx["rows"], ctx["lanes"], ctx["slot"]
        flat = ctx["flat"]
        merge_jobs, lww_jobs = ctx["merge_jobs"], ctx["lww_jobs"]

        def u32(lo, hi):
            return ((hi.astype(np.int64) << 16)
                    | (lo.astype(np.int64) & 0xFFFF)).astype(np.int64)

        # The narrow layout of serve_step.serve_window: int16 deltas,
        # int32 lane scalars as (lo, hi) halves, [msn_ok | overflow bits],
        # the per-lane overflow planes (merge jobs then LWW jobs, each
        # lanes_n wide: recovery never reads the post states), the
        # occupancy planes in the same order, the megakernel's exact page
        # group scalars and the stats plane.
        merge_lanes = [j["lanes_n"] for j in merge_jobs]
        layout = serve_step.flat16_layout(
            B, T, merge_lanes, [j["lanes_n"] for j in lww_jobs],
            paged_scalars=bool(ctx.get("paged")),
            stats=bool(ctx.get("stats")))
        assert flat.shape[0] == layout["total"][1], \
            (flat.shape, layout["total"])

        def sec(name):
            lo, hi = layout[name]
            return flat[lo:hi]

        seq_d = sec("seq_d").reshape(B, T).astype(np.int64)
        msn_d = sec("msn_d").reshape(B, T).astype(np.int64)
        fl_bt = sec("flags").reshape(B, T)
        next_seq = u32(sec("next_lo"), sec("next_hi"))
        msn_base = u32(sec("msn_base_lo"), sec("msn_base_hi"))
        bits16 = sec("bits")
        msn_ok = bits16[0]
        bits = bits16[1:]
        planes = sec("overflow")
        cnt_planes = sec("occupancy")
        if ctx.get("paged"):
            # The megakernel's scalar-adoption plane: each page group's
            # post count/min_seq/seq as exact int32 — the int16 occupancy
            # planes above can wrap for a large group, so scalar adoption
            # and the stats mirror read these.
            ctx["_paged_scalars"] = serve_step.paged_scalars_of(
                flat, layout, merge_lanes)
        # The device telemetry plane (present only when this window
        # dispatched with stats): N_SERVE int32 slots as lo/hi halves.
        stats16 = sec("stats") if ctx.get("stats") else None

        q_m = np.fromiter(self._ring_fixup, np.int64,
                          len(self._ring_fixup)) \
            if self._ring_fixup else None
        q_l = np.fromiter(self._ring_fixup_lww, np.int64,
                          len(self._ring_fixup_lww)) \
            if self._ring_fixup_lww else None

        # Exact occupancy refresh from this window's own result: the
        # confirmed base adopts the post-window counts for the lanes THIS
        # window staged (never the whole plane — lanes seeded/alloc'd by
        # later flushes while this window was in flight have newer hints)
        # and this window's staged-op bound leaves the pending set — the
        # donation/deferral gate never decays pessimistic. Runs BEFORE
        # recovery, whose put_rows re-hint any rolled-back lanes;
        # quarantined lanes keep their recovered base (this window's
        # device counts for them describe discarded state). When a
        # recovery ran since this window dispatched (gen moved), a staged
        # lane may have been freed and REALLOCATED to another channel —
        # refresh/deduct only lanes still owned by the staged key.
        gen_same = ctx.get("gen") == self._recovery_gen

        def _owned_rows(bucket, job):
            """Per-row mask: the staged channel still owns the lane (a
            recovery may have freed + reallocated it while this window
            was in flight)."""
            return np.fromiter(
                (bucket.used[int(l)] == self._pump_chan[int(c)]
                 for l, c in zip(job["lanes"], job["chan"])), bool,
                job["lanes"].size)

        cnt_off = 0
        for job in merge_jobs:
            n = job["lanes_n"]
            if ctx.get("paged"):
                # R10: no bucket hints to refresh — paged occupancy is
                # the host page scalars, adopted at the ring's LAST
                # window from the exact paged16 plane below.
                cnt_off += n
                continue
            bucket = self.merge.buckets[job["bucket"]]
            fresh = cnt_planes[cnt_off:cnt_off + n].astype(np.int64)
            cnt_off += n
            pend_lanes = job["lanes"]
            lanes_j = np.unique(pend_lanes)
            if not gen_same:
                own = _owned_rows(bucket, job)
                job["owned"] = own
                pend_lanes = pend_lanes[own]
                lanes_j = np.unique(pend_lanes)
            if q_m is not None:
                qlanes = np.unique(job["lanes"][np.isin(job["chan"], q_m)])
                lanes_j = np.setdiff1d(lanes_j, qlanes)
            bucket.count_hint[lanes_j] = fresh[lanes_j]
            np.subtract.at(bucket.hint_pending, pend_lanes, 2)
            np.maximum(bucket.hint_pending, 0,
                       out=bucket.hint_pending)
        for job in lww_jobs:
            n = job["lanes_n"]
            bucket = self.lww.buckets[job["bucket"]]
            fresh = cnt_planes[cnt_off:cnt_off + n].astype(np.int64)
            cnt_off += n
            pend_lanes = job["lanes"]
            lanes_j = np.unique(pend_lanes)
            if not gen_same:
                own = _owned_rows(bucket, job)
                job["owned"] = own
                pend_lanes = pend_lanes[own]
                lanes_j = np.unique(pend_lanes)
            if q_l is not None:
                qlanes = np.unique(job["lanes"][np.isin(job["chan"], q_l)])
                lanes_j = np.setdiff1d(lanes_j, qlanes)
            bucket.count_hint[lanes_j] = fresh[lanes_j]
            np.subtract.at(bucket.hint_pending, pend_lanes, 1)
            np.maximum(bucket.hint_pending, 0,
                       out=bucket.hint_pending)
        admitted = seq_d >= 0
        seq_bt = np.where(admitted, next_seq[:, None] - seq_d, 0)
        if msn_ok:
            msn_bt = np.where(admitted, msn_base[:, None] + msn_d, 0)
        else:
            # A catch-up msn jump exceeded the int16 delta: fetch the
            # exact int32 plane (a rare second copy to the host).
            msn_bt = _host(ctx["msn32_dev"]).astype(np.int64)
            msn_bt = np.where(admitted, msn_bt, 0)
        if ctx.get("paged"):
            # The megakernel ring's LAST window settles every page
            # group; it rebuilds flagged docs' op streams from ALL K
            # windows, so each window stashes its decoded seq/msn
            # planes here.
            ctx["_seq_bt"] = seq_bt
            ctx["_msn_bt"] = msn_bt
        if bits[0]:
            raise RuntimeError("ticket client table overflow despite "
                               "pre-flush growth — invariant violation")

        if stats16 is not None:
            s_n = device_stats.N_SERVE
            dev_vec = u32(stats16[:s_n], stats16[s_n:2 * s_n])
            host_vec = self._mirror_window_stats(
                ctx, seq_bt, fl_bt, admitted, planes,
                cnt_planes, merge_jobs, lww_jobs)
            device_stats.fold_serve(dev_vec, host_vec)

        ctx["row_seq"][ctx["idx"]] = seq_bt[lanes, slot]
        ctx["row_msn"][ctx["idx"]] = msn_bt[lanes, slot]
        # Annotate LWW ordering needs each merge op's assigned seq.
        block = ctx["block"]
        for job in merge_jobs:
            block.seqs[job["op_ids"] - ctx["mbase"]] = \
                seq_bt[job["doc_lane"], job["slot"]]

        # Nacks (rare): materialize the offending message from its span.
        row_flags = fl_bt[lanes, slot]
        for k in np.flatnonzero(row_flags != 0).tolist():
            r = int(rows[k])
            buf = parsed.bufs[int(cols[P.BUF, r])]
            msg = document_message_from_dict(json.loads(
                buf[int(cols[P.MSTART, r]):int(cols[P.MEND, r])]))
            doc_id = self._pump_docs[int(cols[P.DOC, r])]
            dl = self.docs[doc_id]
            reason = ("client not joined" if row_flags[k] & 2
                      else "refSeq below minimum sequence number")
            self.nack(doc_id,
                      dl.ordinals.get(int(cols[P.CLIENT, r]), ""),
                      Nack(msg, int(next_seq[dl.lane]) - 1,
                           NackContent(NACK_BAD_REF_SEQ, reason)))

        # Overflow recovery (rare): roll flagged lanes back to their
        # pre-window rows and reuse the batched slow-path recovery. The
        # span is unconditional — a flush with nothing to rescue records
        # a ~0 µs stage, so captures always show the stage's cost.
        # Ring-aware: lanes recovered while LATER windows are in flight
        # quarantine their channels — those windows' rows for them
        # re-apply host-side here (fixup), in dispatch order, instead of
        # trusting device results computed from pre-recovery rows.
        with tracing.span("serving.fold_rescue", parent=ctx.get("trace_ctx"),
                          hist="serving.fold_rescue") as _frsp:
            bit_i = 1  # bits[0] is the ticket-table invariant bit
            recovered = 0
            plane_off = 0
            # Quarantine direction: anything dispatched AFTER this
            # window — later ring entries, staged windows, or the rest
            # of this window's own burst (burst_more) — holds device
            # results computed from pre-recovery rows.
            ring_behind = bool(self._ring) or bool(self._staged) \
                or bool(ctx.get("burst_more"))
            fixup_merge: Dict[tuple, List[HostOp]] = {}
            fixup_lww: Dict[tuple, List[tuple]] = {}
            for gi, job in enumerate(merge_jobs):
                n = job["lanes_n"]
                over = planes[plane_off:plane_off + n] != 0
                plane_off += n
                if ctx.get("paged"):
                    # R10: overflow is sticky in the megakernel's scan
                    # carry, so the LAST window's plane is the union of
                    # every flagged doc and all settlement (scalar
                    # adoption, trailing-page release, rollback+rescue)
                    # happens there — with nothing in flight behind it
                    # (one-in-flight ring), so no quarantine direction
                    # exists on this path.
                    bit_i += 1
                    if not ctx.get("burst_more"):
                        # Named settle stage: the megakernel ring's
                        # scalar adoption + page release + rescue is
                        # the path's fourth serving sub-span (pack /
                        # dispatch / readback / settle), so ring
                        # captures attribute settlement cost instead
                        # of folding it into fold_rescue.
                        with tracing.span("serving.settle",
                                          hist="serving.settle") as _ssp:
                            got = self._finish_paged_group(
                                ctx, gi, job, over)
                            if got:
                                _ssp.set(rescued=True)
                            recovered += got
                    continue
                qsel = np.isin(job["chan"], q_m) if q_m is not None \
                    else None
                if bits[bit_i]:
                    qlanes = set(job["lanes"][qsel].tolist()) \
                        if qsel is not None else set()
                    flagged = sorted(
                        {int(i) for i in job["lanes"].tolist()
                         if over[i] and i not in qlanes})
                    if flagged:
                        self._recover_fast_merge(
                            parsed, job, seq_bt, msn_bt, flagged,
                            quarantine=ring_behind)
                        recovered += 1
                bit_i += 1
                if qsel is not None and qsel.any():
                    self._collect_merge_fixup(fixup_merge, parsed, job,
                                              seq_bt, msn_bt, qsel)
            for job in lww_jobs:
                n = job["lanes_n"]
                over = planes[plane_off:plane_off + n] != 0
                plane_off += n
                qsel = np.isin(job["chan"], q_l) if q_l is not None \
                    else None
                if bits[bit_i]:
                    qlanes = set(job["lanes"][qsel].tolist()) \
                        if qsel is not None else set()
                    flagged = sorted(
                        {int(i) for i in job["lanes"].tolist()
                         if over[i] and i not in qlanes})
                    if flagged:
                        self._recover_fast_lww(parsed, job, seq_bt,
                                               flagged,
                                               quarantine=ring_behind)
                        recovered += 1
                bit_i += 1
                if qsel is not None and qsel.any():
                    self._collect_lww_fixup(fixup_lww, parsed, job,
                                            seq_bt, qsel)
            if fixup_merge:
                increment("serving.ring_fixups", len(fixup_merge))
                self._recovery_gen += 1  # the re-apply itself may promote
                self.merge._apply_streams(fixup_merge)
            if fixup_lww:
                increment("serving.ring_fixups", len(fixup_lww))
                self._recovery_gen += 1
                self.lww._apply_window(fixup_lww)
            if recovered:
                _frsp.set(recovered_jobs=recovered)

    def _finish_paged_group(self, ctx, gi: int, job: dict,
                            over: np.ndarray) -> int:
        """Settle one page group at its megakernel ring's LAST window
        (R10): adopt the exact post scalars for clean docs (the host
        page scalars are authoritative between flushes), release their
        dead trailing pages, and roll back + host-rescue flagged docs
        with their ops from ALL K windows — overflow is sticky in the
        scan carry, so a doc flagged at window k has every later
        window's device rows voided too, and the rescue replays the
        whole ring's stream against the rolled-back pre-ring view.
        Returns the number of rescue passes run (0 or 1)."""
        shared = ctx.get("paged_shared")
        info = None if shared is None \
            else shared["groups"].get(job["bucket"])
        if info is None:
            return 0
        pg = self.merge.pages
        keys = info["keys"]
        n = len(keys)
        counts, mins, seqs = ctx["_paged_scalars"][gi]
        over_n = over[:n]
        good = np.flatnonzero(~over_n)
        if good.size:
            gkeys = [keys[j] for j in good.tolist()]
            pg.adopt_scalars(gkeys, counts[good].astype(np.int32),
                             mins[good].astype(np.int32),
                             seqs[good].astype(np.int32))
            ops_per = np.zeros(n, np.int64)
            for wd in shared["wins"]:
                jw = wd["merge_jobs"][gi]
                if jw["lanes"].size:
                    np.add.at(ops_per, jw["lanes"], 1)
            for j in good.tolist():
                key = keys[j]
                pg.ops_since_compact[key] = \
                    pg.ops_since_compact.get(key, 0) + int(ops_per[j])
            pg.release_trailing_many(gkeys)
        flagged = np.flatnonzero(over_n).tolist()
        if not flagged:
            return 0
        items = self._collect_paged_ring_ops(shared, gi, keys)
        self._recovery_gen += 1
        increment("serving.recovery_dispatches")
        self.merge._recover_paged(keys, items, info["pids"],
                                  shared["pre"][gi], flagged)
        return 1

    def _collect_paged_ring_ops(self, shared, gi: int, keys):
        """HostOp streams for one page group across its megakernel
        ring's K windows, in window order — _recover_fast_merge's
        stream rebuild, widened to the whole ring entry."""
        ops_by: Dict[int, List[HostOp]] = {}
        for wd in shared["wins"]:
            job = wd["merge_jobs"][gi]
            rows_j = job["rows"]
            if rows_j is None or not len(rows_j):
                continue
            cols = wd["parsed"].cols
            seq_bt = wd["_seq_bt"]
            msn_bt = wd["_msn_bt"]
            for k, lane in enumerate(job["lanes"].tolist()):
                r = int(rows_j[k])
                # seq/msn were assigned by the ticket pass regardless
                # of the merge overflow; reuse them for the re-run.
                seq = int(seq_bt[job["doc_lane"][k], job["slot"][k]])
                msn = int(msn_bt[job["doc_lane"][k], job["slot"][k]])
                if seq <= 0:
                    continue
                ops_by.setdefault(int(lane), []).append(HostOp(
                    kind=int(cols[P.MKIND, r]), seq=seq,
                    ref_seq=int(cols[P.REFSEQ, r]),
                    client=int(cols[P.CLIENT, r]),
                    pos1=int(cols[P.POS1, r]), pos2=int(cols[P.POS2, r]),
                    op_id=int(job["op_ids"][k]),
                    new_len=int(cols[P.CHARLEN, r]),
                    local_seq=0, msn=msn))
        return [(key, ops_by.get(j, [])) for j, key in enumerate(keys)]

    def _mirror_window_stats(self, ctx, seq_bt, fl_bt, admitted,
                             planes, cnt_planes, merge_jobs, lww_jobs):
        """The HOST-derived mirror of one window's device telemetry
        plane (telemetry/device_stats.SERVE_SLOTS order), re-deriving
        every countable slot from the staged op columns + the decoded
        ticket results with exactly the admission logic the device
        program applies (nack masking, INSERT_RUN mispredict voiding,
        burst padding skips). device-vs-host reconciliation is then an
        exact counter diff — the obs-smoke gate. Vectorized numpy over
        the window's staged columns: microseconds against the device
        program it mirrors."""
        noop_skip = bool(ctx.get("noop_skip"))
        kinds = np.zeros(6, np.int64)  # INSERT..INSERT_RUN
        skips = 0
        for job in merge_jobs:
            c = job.get("cols")
            if c is None:
                if noop_skip:
                    skips += 1  # union-bucket padding: all-NOOP plane
                continue
            kind = c[0]
            ok = (kind != OpKind.NOOP) & (seq_bt[c[10], c[11]] > 0)
            r = job.get("runs")
            if r is not None:
                expected = r[0] > 0
                sub_ok = seq_bt[r[2], r[3]] > 0
                mispredict = (kind == OpKind.INSERT_RUN) & np.any(
                    expected & ~sub_ok, axis=-1)
                ok &= ~mispredict
            kk = kind[ok]
            kinds += np.bincount(kk, minlength=7)[1:7]
            if noop_skip and kk.size == 0:
                skips += 1
        lww_n = 0
        for job in lww_jobs:
            c = job.get("cols")
            if c is None:
                if noop_skip:
                    skips += 1
                continue
            # LwwKind.NOOP == 0 (server/lww_kernel.py)
            ok = (c[0] != 0) & (seq_bt[c[4], c[5]] > 0)
            n_ok = int(ok.sum())
            lww_n += n_ok
            if noop_skip and n_ok == 0:
                skips += 1
        merge_total = sum(j["lanes_n"] for j in merge_jobs)
        if ctx.get("_paged_scalars") is not None:
            # R10: the device sums the EXACT int32 group counts; the
            # int16 count planes can wrap for a large page group, so
            # the mirror reads the decoded paged16 scalars instead.
            merge_cnt = sum(int(c.sum())
                            for c, _m, _s in ctx["_paged_scalars"])
        else:
            merge_cnt = int(cnt_planes[:merge_total].astype(np.int64)
                            .sum())
        host_vec = np.array(list(kinds) + [
            lww_n,
            int(admitted.sum()),
            int((fl_bt & 1).astype(bool).sum()),
            int(((fl_bt >> 1) & 1).astype(bool).sum()),
            int((planes[:merge_total] != 0).sum()),
            int((planes[merge_total:] != 0).sum()),
            skips,
            # Lane-fill gauges: the device sums the same count planes
            # that ride this result, so the mirror is the plane sum.
            merge_cnt,
            int(cnt_planes[merge_total:].astype(np.int64).sum()),
        ], np.int64)
        return host_vec

    def _build_merge(self, parsed, rows, lanes, slot,
                     mbase, chan_ok, chan_b, chan_l, flush_rows=None):
        """Per-bucket merge window staging ([12, lanes, Tm]: 10 PackedOps
        columns + doc_idx + t_idx, one array => one H2D); returns job
        records carrying what the (rare) recovery path needs.
        `flush_rows` overrides the live flush's merge-row universe (the
        staged-window degrade restage, which may run after a LATER flush
        overwrote self._flush_merge_rows)."""
        cols = parsed.cols
        if flush_rows is None:
            flush_rows = self._flush_merge_rows
        in_window = np.isin(flush_rows, rows)
        sel = in_window & chan_ok
        jobs = []
        if not sel.any():
            return jobs
        mrows = flush_rows[sel]
        mb = chan_b[sel]
        ml = chan_l[sel]
        op_ids = mbase + np.flatnonzero(sel)
        # Window-local position of each selected merge row (rows sorted).
        wrow = np.searchsorted(rows, mrows)
        paged = self.merge.paged
        for b in np.unique(mb).tolist():
            bsel = mb == b
            if paged:
                # R10: b is a flush-group id; the plane width is the
                # group's pow2-padded member count and there is no pre
                # state to snapshot — the megakernel returns the
                # gathered pre views in its own readback.
                group_lanes = self.merge.flush_groups[b].lanes
                pre_state = None
            else:
                bucket = self.merge.buckets[b]
                group_lanes = bucket.lanes
                pre_state = bucket.state
            rl = ml[bsel]
            rr = mrows[bsel]
            doc_lane = lanes[wrow[bsel]]
            tslot = slot[wrow[bsel]]
            b_kind = cols[P.MKIND, rr]
            b_client = cols[P.CLIENT, rr]
            b_ref = cols[P.REFSEQ, rr]
            b_pos1 = cols[P.POS1, rr]
            b_len = cols[P.CHARLEN, rr]
            runs_rc = None
            # Insert-run packing: typing bursts collapse to INSERT_RUN
            # slots; a mispredicted member admission (a dup or stale nack
            # inside a run) flags the lane, which takes the standard
            # overflow rollback and re-run.
            rp, sub, head, tail = _pack_lane_runs(
                rl, b_kind, b_client, b_ref, b_pos1, b_len, RUN_K, RUN_MIN)
            rp = rp.astype(np.int64)
            is_member = sub >= 0
            Tm = _bucket(int(rp.max()) + 1 if rr.size else 1,
                         self.t_buckets)
            mc = np.zeros((12, group_lanes, Tm), np.int32)
            # Layout matches serve_step.serve_window: kind seq ref client
            # pos1 pos2 op_id new_len local_seq msn doc_idx t_idx.
            # Run slots: the stream-FIRST member provides pos1/ref/client
            # (writes below land head-last per slot via masked ordering),
            # the stream-LAST member provides doc_idx/t_idx (seq/msn
            # gather source); kind becomes INSERT_RUN, op_id -1, new_len
            # the member total.
            hsel = head  # plain rows AND run heads define op columns
            mc[0, rl[hsel], rp[hsel]] = np.where(
                is_member[hsel], OpKind.INSERT_RUN, b_kind[hsel])
            mc[2, rl[hsel], rp[hsel]] = b_ref[hsel]
            mc[3, rl[hsel], rp[hsel]] = b_client[hsel]
            mc[4, rl[hsel], rp[hsel]] = b_pos1[hsel]
            mc[5, rl[hsel], rp[hsel]] = cols[P.POS2, rr][hsel]
            mc[6, rl[hsel], rp[hsel]] = np.where(
                is_member[hsel], -1, op_ids[bsel][hsel])
            run_total = np.zeros(rr.size, np.int64)
            if is_member.any():
                # total member length per (lane, slot), read back per row
                key = rl * Tm + rp
                sums = np.zeros(group_lanes * Tm, np.int64)
                np.add.at(sums, key[is_member], b_len[is_member])
                run_total = sums[key]
            mc[7, rl[hsel], rp[hsel]] = np.where(
                is_member[hsel], run_total[hsel], b_len[hsel])
            tsel = tail
            mc[10, rl[tsel], rp[tsel]] = doc_lane[tsel]
            mc[11, rl[tsel], rp[tsel]] = tslot[tsel]
            if is_member.any():
                rc = np.zeros((4, group_lanes, Tm, RUN_K), np.int32)
                msel = is_member
                rc[0, rl[msel], rp[msel], sub[msel]] = b_len[msel]
                rc[1, rl[msel], rp[msel], sub[msel]] = op_ids[bsel][msel]
                rc[2, rl[msel], rp[msel], sub[msel]] = doc_lane[msel]
                rc[3, rl[msel], rp[msel], sub[msel]] = tslot[msel]
                runs_rc = rc
            jobs.append({"bucket": b, "pre": pre_state, "cols": mc,
                         "runs": runs_rc, "lanes_n": group_lanes,
                         "chan": cols[P.CHAN, rr],
                         "rows": rr, "lanes": rl, "op_ids": op_ids[bsel],
                         "doc_lane": doc_lane, "slot": tslot})
        return jobs

    def _build_lww(self, parsed, rows, lanes, slot,
                   vbase, chan_ok, chan_b, chan_l):
        """Per-bucket LWW staging ([6, lanes, Tm]: kind key val delta
        doc_idx t_idx)."""
        cols = parsed.cols
        lk = self.lww.lk
        flush_rows = self._flush_lww_rows
        in_window = np.isin(flush_rows, rows)
        sel = in_window & chan_ok
        jobs = []
        if not sel.any():
            return jobs
        lrows = flush_rows[sel]
        lb = chan_b[sel]
        ll = chan_l[sel]
        cpos = _cumcount(cols[P.CHAN, lrows])
        val_ids = vbase + np.flatnonzero(sel)
        wrow = np.searchsorted(rows, lrows)
        for b in np.unique(lb).tolist():
            bsel = lb == b
            bucket = self.lww.buckets[b]
            Tm = _bucket(int(cpos[bsel].max()) + 1, self.t_buckets)
            lc = np.zeros((6, bucket.lanes, Tm), np.int32)
            lc[1] = -1
            lc[2] = -1
            rl = ll[bsel]
            rp = cpos[bsel]
            rr = lrows[bsel]
            lc[0, rl, rp] = cols[P.MKIND, rr]
            kord = cols[P.POS1, rr]
            lc[1, rl, rp] = np.where(kord >= 0, self._lww_key_map[kord],
                                     -1)
            is_set = cols[P.MKIND, rr] == lk.LwwKind.SET
            lc[2, rl, rp] = np.where(is_set, val_ids[bsel], -1)
            lc[3, rl, rp] = cols[P.POS2, rr]
            doc_lane = lanes[wrow[bsel]]
            tslot = slot[wrow[bsel]]
            lc[4, rl, rp] = doc_lane
            lc[5, rl, rp] = tslot
            jobs.append({"bucket": b, "pre": bucket.state, "cols": lc,
                         "lanes_n": bucket.lanes, "chan": cols[P.CHAN, rr],
                         "rows": rr, "lanes": rl, "val_ids": val_ids[bsel],
                         "doc_lane": doc_lane, "slot": tslot})
        return jobs

    def _recover_fast_merge(self, parsed, job, seq_bt, msn_bt,
                            flagged: List[int],
                            quarantine: bool = False) -> None:
        """A merge bucket overflowed in a fast window: rebuild HostOp
        streams for the flagged lanes from the pump columns, roll those
        lanes back to their pre-window rows, and run the slow path's
        batched recovery. `quarantine=True` (windows behind this one are
        still in flight) additionally quarantines the recovered channels:
        the later windows' device results for these lanes are void, and
        their rows re-apply host-side at each window's own drain."""
        cols = parsed.cols
        b = job["bucket"]
        bucket = self.merge.buckets[b]
        flag_set = set(flagged)
        own = job.get("owned")  # set by _finish_window when gen moved
        lane_ops: Dict[int, List[HostOp]] = {}
        for k, i in enumerate(job["lanes"].tolist()):
            if i not in flag_set:
                continue
            if own is not None and not own[k]:
                # A recovery freed + reallocated this lane while the
                # window was in flight: the plane bit describes the OLD
                # channel's discarded state — never roll back or re-run
                # over the lane's new owner.
                continue
            r = int(job["rows"][k])
            # seq/msn were assigned by the ticket pass regardless of the
            # merge overflow; reuse them for the re-run.
            seq = int(seq_bt[job["doc_lane"][k], job["slot"][k]])
            msn = int(msn_bt[job["doc_lane"][k], job["slot"][k]])
            if seq <= 0:
                continue
            lane_ops.setdefault(i, []).append(HostOp(
                kind=int(cols[P.MKIND, r]), seq=seq,
                ref_seq=int(cols[P.REFSEQ, r]),
                client=int(cols[P.CLIENT, r]),
                pos1=int(cols[P.POS1, r]), pos2=int(cols[P.POS2, r]),
                op_id=int(job["op_ids"][k]),
                new_len=int(cols[P.CHARLEN, r]),
                local_seq=0, msn=msn))
        if not lane_ops:
            return
        self._recovery_gen += 1
        increment("serving.recovery_dispatches")
        if job["pre"] is None:
            # Donated window flagged overflow: the gate's fit proof was
            # wrong (hint bug) or the overflow was structurally
            # unpredictable (bad insert position, a nacked INSERT_RUN
            # member) and the pre rows are gone. Degrade the affected
            # channels to opaque instead of materializing corrupt state
            # — loudly.
            self._degrade_donated_merge(b, sorted(lane_ops))
            return
        if quarantine:
            for i in sorted(lane_ops):
                key = bucket.used[i]
                ch = self._chan_ord.get(key)
                if ch is not None:
                    self._ring_fixup.add(int(ch))
        bucket.state = _set_rows(bucket.state, sorted(lane_ops),
                                 _take(job["pre"], sorted(lane_ops)))
        self.merge._recover_batch(b, lane_ops)

    def _degrade_donated_merge(self, b: int, lanes: List[int]) -> None:
        increment("sequencer.donated_overflow")
        bucket = self.merge.buckets[b]
        keys = [bucket.used[i] for i in lanes if bucket.used[i] is not None]
        logging.getLogger(__name__).error(
            "merge overflow on a DONATED window (occupancy-hint invariant "
            "break); degrading %d channel(s) to opaque: %r", len(keys),
            keys)
        for key in keys:
            # Quarantine BEFORE dropping: in-flight windows that staged
            # this channel must void their device results for it at
            # their drain (the opaque check then skips the re-apply),
            # not recover against a freed/reallocated lane.
            ch = self._chan_ord.get(key)
            if ch is not None:
                self._ring_fixup.add(int(ch))
            self.merge.drop(key)
            self.merge.overflow_drops += 1

    def _collect_merge_fixup(self, streams: Dict[tuple, List[HostOp]],
                             parsed, job, seq_bt, msn_bt,
                             qsel: np.ndarray) -> None:
        """Rows riding a quarantined channel: their lanes were rolled back
        and host-recovered by an EARLIER window's drain, so this window's
        device result for them is void — rebuild the ops as HostOp
        streams (arrival order) for the sync-faithful re-apply."""
        cols = parsed.cols
        for k in np.flatnonzero(qsel).tolist():
            r = int(job["rows"][k])
            seq = int(seq_bt[job["doc_lane"][k], job["slot"][k]])
            msn = int(msn_bt[job["doc_lane"][k], job["slot"][k]])
            if seq <= 0:
                continue
            key = self._pump_chan[int(job["chan"][k])]
            streams.setdefault(key, []).append(HostOp(
                kind=int(cols[P.MKIND, r]), seq=seq,
                ref_seq=int(cols[P.REFSEQ, r]),
                client=int(cols[P.CLIENT, r]),
                pos1=int(cols[P.POS1, r]), pos2=int(cols[P.POS2, r]),
                op_id=int(job["op_ids"][k]),
                new_len=int(cols[P.CHARLEN, r]),
                local_seq=0, msn=msn))

    def _recover_fast_lww(self, parsed, job, seq_bt, flagged: List[int],
                          quarantine: bool = False) -> None:
        cols = parsed.cols
        lk = self.lww.lk
        b = job["bucket"]
        bucket = self.lww.buckets[b]
        flag_set = set(flagged)
        own = job.get("owned")  # set by _finish_window when gen moved
        lane_ops: Dict[int, List[tuple]] = {}
        for k, i in enumerate(job["lanes"].tolist()):
            if i not in flag_set:
                continue
            if own is not None and not own[k]:
                # Lane freed + reallocated while in flight (see
                # _recover_fast_merge): never touch the new owner.
                continue
            r = int(job["rows"][k])
            seq = int(seq_bt[job["doc_lane"][k], job["slot"][k]])
            if seq <= 0:
                continue
            kord = int(cols[P.POS1, r])
            kid = int(self._lww_key_map[kord]) if kord >= 0 else -1
            mk = int(cols[P.MKIND, r])
            lane_ops.setdefault(i, []).append(
                (mk, kid,
                 int(job["val_ids"][k]) if mk == lk.LwwKind.SET else -1,
                 int(cols[P.POS2, r]), seq))
        if not lane_ops:
            return
        self._recovery_gen += 1
        increment("serving.recovery_dispatches")
        if job["pre"] is None:
            increment("sequencer.donated_overflow")
            keys = [bucket.used[i] for i in sorted(lane_ops)
                    if bucket.used[i] is not None]
            logging.getLogger(__name__).error(
                "LWW overflow on a DONATED window (occupancy-hint "
                "invariant break); degrading %d channel(s): %r",
                len(keys), keys)
            for key in keys:
                # Quarantine before dropping (see _degrade_donated_merge).
                ch = self._chan_ord.get(key)
                if ch is not None:
                    self._ring_fixup_lww.add(int(ch))
                self.lww.drop(key)
                self.lww.overflow_drops += 1
            return
        if quarantine:
            for i in sorted(lane_ops):
                key = bucket.used[i]
                ch = self._chan_ord.get(key)
                if ch is not None:
                    self._ring_fixup_lww.add(int(ch))
        bucket.state = _set_rows(bucket.state, sorted(lane_ops),
                                 _take(job["pre"], sorted(lane_ops)))
        for i, ops in lane_ops.items():
            t = _bucket(len(ops), self.t_buckets)
            self.lww._promote(b, i, ops, t)

    def _collect_lww_fixup(self, streams: Dict[tuple, List[tuple]],
                           parsed, job, seq_bt, qsel: np.ndarray) -> None:
        cols = parsed.cols
        lk = self.lww.lk
        for k in np.flatnonzero(qsel).tolist():
            r = int(job["rows"][k])
            seq = int(seq_bt[job["doc_lane"][k], job["slot"][k]])
            if seq <= 0:
                continue
            kord = int(cols[P.POS1, r])
            kid = int(self._lww_key_map[kord]) if kord >= 0 else -1
            mk = int(cols[P.MKIND, r])
            key = self._pump_chan[int(job["chan"][k])]
            streams.setdefault(key, []).append(
                (mk, kid,
                 int(job["val_ids"][k]) if mk == lk.LwwKind.SET else -1,
                 int(cols[P.POS2, r]), seq))

    def _evict_ghosts(self, active_docs: List[str]) -> None:
        """Synthesize leaves for writers silent past client_timeout_s
        (DeliLambda._evict_ghosts, device path). With a raw-log producer
        the leave rides the log (replay-deterministic); the fallback
        appends to the in-memory backlog so the NoClient timing and
        quorum removal stay exact either way."""
        if not self.client_timeout_s:
            return
        cutoff = time.time() - self.client_timeout_s
        for doc_id in active_docs:
            dl = self.docs.get(doc_id)
            if dl is None:
                continue
            stale = [cid for cid, ts in dl.last_seen.items()
                     if ts < cutoff and cid not in dl.evicting]
            for client_id in stale:
                leave = DocumentMessage(
                    client_sequence_number=0,
                    reference_sequence_number=-1,
                    type=MessageType.CLIENT_LEAVE,
                    data=json.dumps({"clientId": client_id,
                                     "evicted": True}))
                if self.send_system is not None:
                    dl.evicting.add(client_id)
                    self.send_system(doc_id, leave)
                else:
                    dl.last_seen.pop(client_id, None)
                    self.pending.setdefault(doc_id, []).append(_Pending(
                        tk.MsgKind.LEAVE, dl.intern(client_id), 0, 0,
                        leave, None))
                    if doc_id in self._pump_known:
                        self._pump_sync_dirty.add(doc_id)

    def _take_window(self) -> Dict[str, List[_Pending]]:
        """Carve the next per-doc message chunks off the backlog: at most
        max-T-bucket messages per doc, and cut immediately AFTER a LEAVE —
        so the host can interpose the NoClient message with the scalar
        deli's exact timing (deli.py CLIENT_LEAVE tail) before the doc's
        remaining messages sequence."""
        max_t = self.t_buckets[-1]
        live: Dict[str, List[_Pending]] = {}
        for doc_id, q in list(self.pending.items()):
            if not q:
                del self.pending[doc_id]
                continue
            cut = min(len(q), max_t)
            for idx in range(cut):
                if q[idx].kind == tk.MsgKind.LEAVE:
                    cut = idx + 1
                    break
            live[doc_id] = q[:cut]
            if len(q) > cut:
                self.pending[doc_id] = q[cut:]
            else:
                del self.pending[doc_id]
        return live

    def _flush_window(self) -> None:
        live = self._take_window()
        if not live:
            return
        # Pre-size the client table: joins this window + already-known
        # ordinals must fit K (grow BEFORE the kernel, so the in-kernel
        # overflow flag is a genuine invariant violation, not a sizing bug).
        need_k = max((dl.next_ordinal for dl in self.docs.values()),
                     default=0)
        while self.k < need_k:
            self._grow_clients()

        _tkt0 = time.perf_counter()
        with tracing.span("serving.pack", hist="serving.pack",
                          stage="ticket-staging"):
            t = _bucket(max(len(q) for q in live.values()), self.t_buckets)
            b = self.lanes
            kind = np.zeros((b, t), np.int32)
            client = np.full((b, t), -1, np.int32)
            cseq = np.zeros((b, t), np.int32)
            ref = np.zeros((b, t), np.int32)
            for doc_id, queue in live.items():
                lane = self.docs[doc_id].lane
                for i, p in enumerate(queue):
                    kind[lane, i] = p.kind
                    client[lane, i] = p.ordinal
                    cseq[lane, i] = p.client_seq
                    ref[lane, i] = p.ref_seq
            raw = tk.RawOps(client=self._cols(client),
                            client_seq=self._cols(cseq),
                            ref_seq=self._cols(ref),
                            kind=self._cols(kind))
        with tracing.span("serving.dispatch", hist="serving.dispatch",
                          stage="ticket"):
            self.tstate, ticketed = _dispatch(tk.sequence_batched_strict,
                                              self.tstate, raw)

        with tracing.span("serving.readback", hist="serving.readback",
                          stage="ticket"):
            seqs = _host(ticketed.seq)
            msns = _host(ticketed.min_seq)
            nacked = _host(ticketed.nacked)
            not_joined = _host(ticketed.not_joined)
            empty_after = _host(ticketed.empty_after)
            next_seq = _host(self.tstate.next_seq)
        _tkt1 = time.perf_counter()
        if bool(_host(self.tstate.overflow).any()):
            raise RuntimeError("ticket client table overflow despite "
                               "pre-flush growth — invariant violation")

        merge_streams: Dict[tuple, List[HostOp]] = {}
        lww_streams: Dict[tuple, List[tuple]] = {}
        for doc_id, queue in live.items():
            lane = self.docs[doc_id].lane
            for i, p in enumerate(queue):
                seq = int(seqs[lane, i])
                if seq > 0:
                    sequenced = SequencedDocumentMessage.from_document_message(
                        p.msg, p.client_id, seq, int(msns[lane, i]))
                    sequenced.traces.append(ITrace.now("deli", "sequence"))
                    _tctx = tracing.message_context(p.msg)
                    if _tctx is not None:
                        # The op's ticket hop = this window's device
                        # ticketing (batched: one interval, one span per
                        # traced op riding it).
                        tracing.record_span("deli.ticket", _tctx,
                                            _tkt0, _tkt1, document=doc_id,
                                            seq=seq)
                    self.emit(doc_id, sequenced)
                    if p.kind == tk.MsgKind.OP and self.materialize:
                        self._collect_channel_op(
                            merge_streams, lww_streams, doc_id, p, seq,
                            int(msns[lane, i]))
                elif nacked[lane, i]:
                    reason = ("client not joined" if not_joined[lane, i]
                              else "refSeq below minimum sequence number")
                    self.nack(doc_id, p.client_id or "", Nack(
                        p.msg, int(next_seq[lane]) - 1,
                        NackContent(NACK_BAD_REF_SEQ, reason)))
                # NoClient with exact deli timing: windows cut right after
                # a LEAVE (_take_window), so a leave that empties the table
                # interposes NO_CLIENT before the doc's remaining backlog.
                if p.kind == tk.MsgKind.LEAVE and seq > 0 and \
                        empty_after[lane, i]:
                    self.pending.setdefault(doc_id, []).insert(0, _Pending(
                        tk.MsgKind.SYSTEM, -1, 0, 0, DocumentMessage(
                            client_sequence_number=0,
                            reference_sequence_number=int(
                                next_seq[lane]) - 1,
                            type=MessageType.NO_CLIENT), None))

        if self.materialize and merge_streams:
            self.merge.apply(merge_streams)
        if self.materialize and lww_streams:
            self.lww.apply(lww_streams)

    def _collect_channel_op(self, merge_streams: Dict[tuple, List[HostOp]],
                            lww_streams: Dict[tuple, List[tuple]],
                            doc_id: str, p: _Pending, seq: int,
                            msn: int,
                            seeded_before: Optional[Dict[tuple, int]] = None
                            ) -> None:
        """Route an admitted channel op to its device lane family:
        merge-tree ops to the segment kernel, map/cell/counter ops to the
        LWW kernel; anything else stays host-only."""
        if p.msg.type != MessageType.OPERATION:
            return
        contents = p.msg.contents
        if not isinstance(contents, dict):
            return
        envelope = contents.get("contents")
        if not isinstance(envelope, dict):
            return
        op = envelope.get("contents")
        key = (doc_id, contents.get("address"), envelope.get("address"))
        droute = directory_route(op)
        if droute is not None:
            self._route_directory(
                lww_streams,
                (doc_id, key[1], key[2] + DIR_SUFFIX),
                droute, op, seq, seeded_before)
            return
        route = matrix_route(op)
        if route is not None:
            # SharedMatrix: axis ops ride merge lanes under suffixed
            # channel keys, cell writes ride an LWW lane — the matrix
            # decomposes into the two families the device already serves.
            store, chan = key[1], key[2]
            if route == "cell":
                self._route_lww(
                    lww_streams, (doc_id, store, chan + MATRIX_CELLS_SUFFIX),
                    {"type": "set", "key": op["key"],
                     "value": op.get("value")},
                    seq, seeded_before)
            else:
                suffix = MATRIX_ROWS_SUFFIX if route == "rows" \
                    else MATRIX_COLS_SUFFIX
                self._route_merge(
                    merge_streams, (doc_id, store, chan + suffix),
                    op["op"], p, seq, msn, seeded_before)
        elif looks_like_merge_op(op):
            self._route_merge(merge_streams, key, op, p, seq, msn,
                              seeded_before)
        elif looks_like_lww_op(op):
            self._route_lww(lww_streams, key, op, seq, seeded_before)

    def _route_merge(self, merge_streams: Dict[tuple, List[HostOp]],
                     key: tuple, op: dict, p: _Pending, seq: int, msn: int,
                     seeded_before: Optional[Dict[tuple, int]]) -> None:
        if key in self.merge.opaque:
            return
        # Run payloads are modelable ONLY on matrix axis sub-lanes (their
        # extract path emits runs back); elsewhere they stay Unmodelable.
        # Items payloads ARE modelable on ordinary sequence lanes now
        # that extraction re-encodes them (round 5) — SharedNumber/
        # ObjectSequence channels materialize instead of dropping opaque.
        allow_runs = matrix_base_key(key) is not None
        if seeded_before is not None and seq <= seeded_before.get(key, 0):
            return  # already reflected in the seeded snapshot base
        if key not in self.merge.where:
            # First op for this channel: its base content may have
            # shipped in the attach/client summary — seed the lane
            # from storage before applying ops addressed against it.
            probe = self._probe_summary(key[0])
            if probe is not None:
                payload = probe.channels.get((key[1], key[2]))
                if payload is not None and seq > probe.sequence_number:
                    self.merge.seed(key, *payload)
        try:
            ops = wire_to_host_ops(self.merge.builder, op, seq,
                                   p.ref_seq, p.ordinal, msn,
                                   allow_runs=allow_runs,
                                   allow_items=not allow_runs)
        except Unmodelable:
            self.merge.drop(key)
            return
        merge_streams.setdefault(key, []).extend(ops)

    def _route_lww(self, lww_streams: Dict[tuple, List[tuple]], key: tuple,
                   op: dict, seq: int,
                   seeded_before: Optional[Dict[tuple, int]]) -> None:
        if key in self.lww.opaque:
            return
        if seeded_before is not None and seq <= seeded_before.get(key, 0):
            return  # already reflected in the seeded snapshot base
        if key not in self.lww.where:
            probe = self._probe_summary(key[0])
            if probe is not None:
                payload = probe.lww_channels.get((key[1], key[2]))
                if payload is not None and seq > probe.sequence_number:
                    self._seed_lww(key, payload, probe)
        try:
            lww_streams.setdefault(key, []).append(
                self.lww.wire_to_op(op, seq))
        except Unmodelable:
            pass

    def _route_directory(self, lww_streams: Dict[tuple, List[tuple]],
                         key: tuple, kind: str, op: dict, seq: int,
                         seeded_before: Optional[Dict[tuple, int]]
                         ) -> None:
        """SharedDirectory op -> the channel's LWW lane: (path, key)
        pairs intern as composite keys, a pathed clear expands to
        per-key deletes, and structural ops evolve the host path set
        that gates storage ops (object-path drop semantics for
        since-deleted subdirectories). Reference
        packages/dds/map/src/directory.ts:1624."""
        if key in self.lww.opaque:
            return
        if seeded_before is not None and seq <= seeded_before.get(key, 0):
            return  # already reflected in the seeded snapshot base
        if key not in self.lww.where:
            probe = self._probe_summary(key[0])
            if probe is not None:
                payload = probe.lww_channels.get((key[1], key[2]))
                if payload is not None and seq > probe.sequence_number:
                    self._seed_lww(key, payload, probe)
                    if key in self.lww.opaque:
                        return
        paths = self._dir_paths.setdefault(key, {"/"})

        def emit(wire_op):
            try:
                lww_streams.setdefault(key, []).append(
                    self.lww.wire_to_op(wire_op, seq))
            except Unmodelable:
                pass

        def lane_keys():
            """The channel's live composite keys: lane state + anything
            emitted earlier in THIS batch (not yet applied). Bounds
            clear/subtree-delete expansion to the channel, never the
            server-wide intern table."""
            names = set()
            snap = self.lww.snapshot(key)
            if snap is not None:
                names.update(snap["entries"])
            for (k_kind, kid, *_rest) in lww_streams.get(key, []):
                if kid >= 0:
                    name = self.lww.key_names[kid]
                    if k_kind == self.lww.lk.LwwKind.SET:
                        names.add(name)
                    else:
                        names.discard(name)
            return names

        if kind == "storage":
            path, kop = _norm_path(op["path"]), op["op"]
            if path not in paths:
                return  # object semantics: target subdir no longer exists
            t = kop.get("type")
            if t == "set" and isinstance(kop.get("key"), str):
                emit({"type": "set", "key": path + DIR_SEP + kop["key"],
                      "value": kop.get("value")})
            elif t == "delete" and isinstance(kop.get("key"), str):
                emit({"type": "delete",
                      "key": path + DIR_SEP + kop["key"]})
            elif t == "clear":
                # Path-scoped clear: expand to deletes over the
                # channel's keys under this exact path.
                prefix = path + DIR_SEP
                for name in sorted(lane_keys()):
                    if name.startswith(prefix):
                        emit({"type": "delete", "key": name})
            else:
                # Unknown storage-kernel shape: the lane can no longer
                # track the object path — degrade this one channel.
                self.lww.drop(key)
                self._dir_paths.pop(key, None)
        elif kind == "createSubDirectory":
            parent, name = _norm_path(op["path"]), op["name"]
            if DIR_SEP in name or "/" in name:
                # A separator-bearing name would make composite keys
                # ambiguous; a slash-bearing name is unresolvable by
                # get_working_directory on the clients themselves.
                # Degrade: the host object path remains authoritative.
                self.lww.drop(key)
                self._dir_paths.pop(key, None)
                return
            if parent in paths:
                paths.add(_child_path(parent, name))
            self.lww.lane_for(key)
            self.lww.mark_dirty(key)
        else:  # deleteSubDirectory
            child = _child_path(_norm_path(op["path"]), op["name"])
            gone = {p for p in paths
                    if p == child or p.startswith(child + "/")}
            if not gone:
                return
            paths -= gone
            for name in sorted(lane_keys()):
                p, sep, _ = name.partition(DIR_SEP)
                if sep and p in gone:
                    emit({"type": "delete", "key": name})
            self.lww.lane_for(key)
            self.lww.mark_dirty(key)

    # -- batched server-side summarization ---------------------------------
    def summarize_documents(self, chunk_chars: int = 10000,
                            only: Optional[set] = None
                            ) -> Dict[tuple, dict]:
        """Chunked snapshots of every materialized channel — merge-tree
        lanes (one batched device extraction per capacity bucket) AND LWW
        lanes (map/cell/counter entries + counter accumulator). `only`
        restricts to the given channel keys (incremental path)."""
        self.drain()  # settle any deferred window before reading lanes
        out = self.merge.extract_all(chunk_chars, only=only)
        for key in self.lww.where:
            if only is not None and key not in only:
                continue
            snap = self.lww.snapshot(key)
            if snap is not None:
                out[key] = {
                    "header": {
                        "kind": "lww",
                        "sequenceNumber": snap["sequenceNumber"],
                    },
                    "entries": snap["entries"],
                    "counter": snap["counter"],
                }
        _compose_matrix_channels(out)
        self._compose_directory_channels(out)
        return out

    def _compose_directory_channels(self, out: Dict[tuple, dict]) -> None:
        """Recombine directory lane snapshots (flattened composite-key
        entries + the host path set) into the nested root.to_dict() form
        under the real channel key."""
        for key in [k for k in out
                    if isinstance(k[2], str) and k[2].endswith(DIR_SUFFIX)]:
            part = out.pop(key)
            base = (key[0], key[1], key[2][:-len(DIR_SUFFIX)])
            out[base] = {
                "header": {
                    "kind": "directory",
                    "sequenceNumber": part["header"]["sequenceNumber"],
                },
                "directory": _nest_directory(
                    part.get("entries", {}),
                    self._dir_paths.get(key, {"/"})),
            }

    def summarize_documents_async(self, on_done,
                                  chunk_chars: int = 10000):
        """Pipeline-stage overlap (kafka-service/README.md:58-60): the
        device extraction is dispatched NOW (async on the accelerator
        queue); the D2H transfer + host snapshot assembly run on a worker
        thread while the caller keeps sequencing the next batch. The
        extracted device arrays are immutable, so subsequent flushes
        replacing the lane states cannot corrupt an in-flight summary."""

        self.drain()  # settle any deferred window before reading lanes
        jobs, cached = self.merge.extract_dispatch(chunk_chars=chunk_chars)
        # LWW snapshots are host-cheap: capture them now so the composed
        # output matches the synchronous path (matrix cell stores).
        lww_part: Dict[tuple, dict] = {}
        for key in self.lww.where:
            snap = self.lww.snapshot(key)
            if snap is not None:
                lww_part[key] = {
                    "header": {"kind": "lww",
                               "sequenceNumber": snap["sequenceNumber"]},
                    "entries": snap["entries"],
                    "counter": snap["counter"],
                }
        # Directory composition reads the live path sets — do it now,
        # synchronously, so the worker thread never races a later flush.
        self._compose_directory_channels(lww_part)

        def work():
            try:
                out = self.merge.extract_assemble(jobs, chunk_chars, cached)
                out.update(lww_part)
                _compose_matrix_channels(out)
            finally:
                self.merge.extract_guard_release()
            on_done(out)

        # Hold fold/rescue payload frees while the worker resolves
        # through the shared table (a recycled id would materialize the
        # wrong text into this snapshot). Acquired last so a raise in
        # the synchronous staging above cannot leak the guard — and
        # released on a failed thread start (fd/thread exhaustion), or
        # every later free would defer forever.
        self.merge.extract_guard_acquire()
        try:
            th = threading.Thread(target=work, daemon=True)
            th.start()
        except BaseException:  # incl. KeyboardInterrupt: never leak the guard
            self.merge.extract_guard_release()
            raise
        return th

    # -- introspection (tests / summarization) -----------------------------
    def channel_text(self, doc_id: str, store: str,
                     channel: str) -> Optional[str]:
        """Server-materialized text for a channel (device state + host
        payload table) — the batched-summarization read path."""
        self.drain()
        return self.merge.text((doc_id, store, channel))

    def channel_snapshot(self, doc_id: str, store: str,
                         channel: str) -> Optional[dict]:
        """Server-materialized LWW channel state (map entries / cell value
        under the reserved key / counter accumulator)."""
        self.drain()
        return self.lww.snapshot((doc_id, store, channel))

    def channel_matrix(self, doc_id: str, store: str,
                       channel: str) -> Optional[list]:
        """Server-materialized matrix grid (rows-in-order × cols-in-order
        of cell values) from the two axis merge lanes + the cell-store
        LWW lane — comparable 1:1 with SharedMatrix.extract() on a caught-
        up client. None if no matrix sub-lane exists for the channel."""
        from ..mergetree.runs import Run, id_key

        self.drain()

        def axis_ids(suffix: str) -> list:
            entries = self.merge.entries((doc_id, store, channel + suffix))
            ids: list = []
            for e in entries or []:
                if e.get("removedSeq") is not None or \
                        e.get("removedLocalSeq") is not None:
                    continue
                text = e.get("text")
                if isinstance(text, Run):
                    ids.extend(text.ids())
            return ids

        rows_known = (doc_id, store,
                      channel + MATRIX_ROWS_SUFFIX) in self.merge.where
        cols_known = (doc_id, store,
                      channel + MATRIX_COLS_SUFFIX) in self.merge.where
        cells_snap = self.lww.snapshot(
            (doc_id, store, channel + MATRIX_CELLS_SUFFIX))
        if not rows_known and not cols_known and cells_snap is None:
            return None
        cells = cells_snap["entries"] if cells_snap else {}
        row_ids = axis_ids(MATRIX_ROWS_SUFFIX)
        col_ids = axis_ids(MATRIX_COLS_SUFFIX)
        return [[cells.get(id_key(r) + "|" + id_key(c))
                 for c in col_ids] for r in row_ids]

    def channel_items(self, doc_id: str, store: str,
                      channel: str) -> Optional[list]:
        """Server-materialized item-sequence values (visible Items
        payloads in order) — comparable 1:1 with get_items() on a
        caught-up client, including its behavior on non-items lanes
        (Items segments only; a pure text lane reads as []). None when
        no lane exists."""
        from ..mergetree.oracle import Items

        self.drain()
        entries = self.merge.entries((doc_id, store, channel))
        if entries is None:
            return None
        out: list = []
        for e in entries:
            if e.get("removedSeq") is not None or \
                    e.get("removedLocalSeq") is not None:
                continue
            text = e.get("text")
            if isinstance(text, Items):
                out.extend(text.values)
        return out

    def channel_directory(self, doc_id: str, store: str,
                          channel: str) -> Optional[dict]:
        """Server-materialized directory tree in root.to_dict() form
        (nested storage + subdirectories) from the channel's LWW lane +
        host path set — comparable 1:1 with SharedDirectory.root.to_dict()
        on a caught-up client. None when no directory lane exists."""
        self.drain()
        key = (doc_id, store, channel + DIR_SUFFIX)
        snap = self.lww.snapshot(key)
        if snap is None and key not in self._dir_paths:
            return None
        return _nest_directory(snap["entries"] if snap else {},
                               self._dir_paths.get(key, {"/"}))

    # -- read-path catch-up artifacts (server/readpath.py) -----------------
    def catchup_docs_supported(self) -> Tuple[Dict[str, List[tuple]], set]:
        """Partition the resident documents for the delta publisher:
        (doc -> its merge lane keys, unsupported doc ids). A document
        rides the delta path only when EVERY channel of it is a plain
        merge-tree sequence lane the publisher can translate — any LWW/
        matrix/directory lane, any opaque (unmodelable-op) channel, or
        any catchup_unsafe seed excludes the whole document: a partial
        artifact would desync the client's per-doc seq bookkeeping, so
        those documents keep the tail-replay fallback."""
        by_doc: Dict[str, List[tuple]] = {}
        unsupported: set = set()
        for key in list(self.merge.where):
            by_doc.setdefault(key[0], []).append(key)
            chan = key[2]
            if (isinstance(chan, str) and "\x00" in chan) \
                    or key in self.merge.catchup_unsafe:
                unsupported.add(key[0])
        for key in list(self.lww.where):
            unsupported.add(key[0])
        for key in list(self.merge.opaque) + list(self.lww.opaque):
            unsupported.add(key[0])
        return by_doc, unsupported

    def catchup_snapshot(self, only_docs: Optional[set] = None,
                         chunk_chars: int = 10000) -> Dict[str, dict]:
        """One read-tier refresh epoch: extract every supported document
        whose change generations advanced past its published artifact —
        ONE batched device dispatch per capacity bucket / page group for
        ALL of them together (extract_dispatch; clean lanes ride the
        summarize blob cache) — and return the per-doc artifact bodies
        {doc_id: {"seq", "gen", "clients", "channels"}}. Channel entries
        are narrow-wire packed (mergetree.catchup.pack_entries_narrow)
        with client fields translated from this lambda's interned
        ordinals to indices into the per-doc wire-client table. Server
        cost is proportional to DIRTY documents, never to connecting
        clients; the caller (TpuLocalServer.refresh_catchup / an
        external publisher) joins in the protocol half and publishes."""
        with tracing.span("catchup.refresh", root=True,
                          hist="catchup.refresh"):
            return self._catchup_snapshot_traced(only_docs, chunk_chars)

    def _catchup_snapshot_traced(self, only_docs: Optional[set],
                                 chunk_chars: int) -> Dict[str, dict]:
        from ..mergetree.catchup import (pack_entries_narrow,
                                         translate_entry_clients)

        self.drain()
        by_doc, unsupported = self.catchup_docs_supported()
        refresh: Dict[str, int] = {}  # doc -> gen this epoch covers
        for doc_id, keys in by_doc.items():
            if only_docs is not None and doc_id not in only_docs:
                continue
            if doc_id in unsupported or doc_id not in self.docs:
                continue
            doc_gen = max((self.merge.change_gen.get(k, 0) for k in keys),
                          default=0)
            if doc_gen <= self._catchup_gen.get(doc_id, -1):
                continue  # published artifact already covers this state
            refresh[doc_id] = doc_gen
        if not refresh:
            return {}
        want = {k for d in refresh for k in by_doc[d]}
        jobs, cached = self.merge.extract_dispatch(only=want,
                                                   chunk_chars=chunk_chars)
        increment("catchup.refresh_dispatches", len(jobs))
        snaps = self.merge.extract_assemble(jobs, chunk_chars, cached)
        out: Dict[str, dict] = {}
        for doc_id, doc_gen in refresh.items():
            dl = self.docs[doc_id]
            # Ordinal -> client-table index, via the wire ids this lane
            # interned; entries fail the translation (KeyError) only for
            # ordinal spaces the publisher cannot disambiguate, which
            # excludes the doc this epoch (fallback stays correct).
            clients = [dl.ordinals[o] for o in sorted(dl.ordinals)]
            mapping = {o: i for i, o in enumerate(sorted(dl.ordinals))}
            doc_seq = self.document_seq(doc_id)
            channels: List[list] = []
            ok = True
            for key in by_doc[doc_id]:
                snap = snaps.get(key)
                if snap is None:
                    ok = False
                    break
                entries = [e for chunk in snap["chunks"] for e in chunk]
                try:
                    entries = translate_entry_clients(entries, mapping)
                    blob = pack_entries_narrow(entries, base_seq=doc_seq)
                except (KeyError, ValueError):
                    ok = False
                    break
                channels.append([key[1], key[2], dict(snap["header"]),
                                 blob])
            if not ok:
                increment("catchup.refresh_unsupported")
                continue
            out[doc_id] = {"seq": doc_seq, "gen": doc_gen,
                           "clients": clients, "channels": channels}
        increment("catchup.refresh_docs", len(out))
        return out

    def catchup_mark_published(self, doc_id: str, gen: int) -> None:
        """Advance the publish watermark — called only after the joined
        artifact actually landed in a CatchupCache."""
        if gen > self._catchup_gen.get(doc_id, -1):
            self._catchup_gen[doc_id] = gen

    def document_seq(self, doc_id: str) -> int:
        dl = self.docs.get(doc_id)
        if dl is None:
            return 0
        return int(_host(self.tstate.next_seq)[dl.lane]) - 1

    def doc_sequence_numbers(self) -> Dict[str, int]:
        """Per-document head sequence number: the `ticketed` watermark
        feed (telemetry/watermarks.py), pulled at scrape time — one
        next_seq read for the whole fleet, zero per-op cost."""
        if not self.docs:
            return {}
        next_seq = _host(self.tstate.next_seq)
        return {doc: int(next_seq[dl.lane]) - 1
                for doc, dl in self.docs.items()}

    def close(self) -> None:
        # Graceful close persists progress; pending (unflushed) messages are
        # NOT emitted here — a crash-restart replays them from the last
        # committed offset, the same at-least-once window as the scalar deli.
        self.drain()
        self._checkpoint()


def _detail(msg: DocumentMessage):
    if msg.data is not None:
        return json.loads(msg.data)
    return msg.contents or {}
