"""The merge-tree kernel: the scan apply, zamboni compaction, the
visibility queries, and paged gather / scatter (a port of
fluidframework_tpu's mergetree/kernel.py).

The scan apply (`apply_ops`, `apply_ops_batched`, `apply_ops_keep`,
`apply_ops_batched_keep`) applies op columns to segment tables of any
capacity, one document ([C] planes, [T] ops) or a batch ([B, C], [B, T]),
with INSERT_RUN steps when `runs=` is given. For CUDA tensors it launches
kernels/csrc/scan_apply.cu (one launch per call, the whole op stream
inside it; `scan_apply`); for CPU tensors it runs the plain PyTorch
version, `scan_ops_plain`, a transcription of kernel.py's own phases
(visibility, _ensure_boundary, the insert / insert-run / remove / annotate
/ ack phases, apply_one, _scan_ops) over [B, C] tensors, stepping over T;
a phase that no document's op enables is skipped, since it would be an
exact identity.
None of them writes its input: JAX's apply_ops and apply_ops_batched
donate it, and the port hands back a new state in every case.

Zamboni (`compact`, `compact_batched`) and summary extraction
(`extract_visible_batched`, the fused `compact_extract_batched`) launch
kernels/csrc/zamboni.cu for CUDA tensors (one launch a call, in the
mode the function names; `zamboni`) and run their plain versions
(`compact_batched_plain`, `extract_visible_batched_plain`,
`compact_extract_batched_plain`) for CPU tensors; the narrow
device-to-host wire (`fetch_extracted`) packs through
kernels/csrc/narrow_pack.cu (`narrow_pack`, plain version
`narrow_pack_plain`) the same way. In JAX these are XLA programs of the
summarize path. `apply_if_any`, `visible_mask` and `doc_length` are
reductions with no op loop: plain PyTorch on both devices.
`gather_pages` / `scatter_pages` move documents in and out of a page pool
(mergetree/paging.py); they are XLA gathers and scatters in JAX and
torch indexing here, as are `gather_rows_pow2` and the exact-plane
refetch. The paged ops (`apply_ops_paged`, `rollback_pages`,
`compact_pages`, `compact_extract_paged`, each with a `_keep` form, and
`paged_stats_vec`) compose them with the scan apply and the zamboni
kernel: each runs its kernel on the gathered view.

The sequence-parallel formulation (`sp_shards`): the visibility prefix sum
as `sp_shards` block-local cumsums plus an exclusive scan of the block
totals (`_cumsum_sp`, the two-level recipe of parallel/seq_scan.py). It is
exact integer arithmetic, so on one device it changes nothing:
`scan_apply` takes `sp_shards` and launches scan_apply.cu as it is. A
table whose capacity axis is sharded over a mesh runs the explicit
per-shard form of mergetree/fused_sp.py instead.
"""

from __future__ import annotations

import contextlib
import ctypes
from types import MappingProxyType
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import build
from ..parallel.mesh import (Sharded, clone, note_launch, on_shard,
                             take_rows, write_rows)
from ..telemetry import counters
from .constants import DEV_NO_REMOVE, DEV_UNASSIGNED
from .oppack import RUN_K, OpKind, PackedOps, RunCols
from .paging import BLANK_PAGE
from .state import DocState

_ROW_FIELDS = ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
               "rem_local_seq", "rem_clients", "origin_op", "origin_off",
               "anno")
_I32 = torch.int32


# ---------------------------------------------------------------------------
# single document <-> a batch of one
# ---------------------------------------------------------------------------

def _lift(tup):
    """A single-document tuple as a batch of one (views, no copies)."""
    return None if tup is None else type(tup)(*(t.unsqueeze(0) for t in tup))


def _drop(tup):
    return type(tup)(*(t[0] for t in tup))


# ---------------------------------------------------------------------------
# the plain version: kernel.py's phases over [B, C] states; op scalars [B, 1]
# ---------------------------------------------------------------------------

def _lanes(s: DocState) -> torch.Tensor:
    return torch.arange(s.capacity, dtype=_I32, device=s.length.device)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1] index of the first true lane of each row, 0 where none (as
    jnp.argmax of a bool row)."""
    return mask.to(torch.uint8).argmax(dim=1, keepdim=True).to(_I32)


def _any(mask: torch.Tensor) -> torch.Tensor:
    return mask.any(dim=1, keepdim=True)


def _off(mask: torch.Tensor) -> bool:
    """True when no document enables a phase: the phase is then an exact
    identity (every write of it is masked), so it is skipped. One host
    read of a bool; the result does not change."""
    return not bool(mask.any())


def _masked_scalar(values, mask):
    """values at the masked lane as a reduce: [B, 1]."""
    return torch.where(mask, values, 0).sum(dim=1, keepdim=True, dtype=_I32)


def _cumsum_sp(vlen: torch.Tensor, sp_shards: int) -> torch.Tensor:
    """Inclusive prefix sum of [B, C] over the capacity axis in the
    sequence-parallel formulation: sp_shards block-local cumsums plus an
    exclusive scan of the block totals. With C not divisible by sp_shards
    (or sp_shards <= 1) it is the plain cumsum."""
    b, c = vlen.shape
    if sp_shards <= 1 or c % sp_shards:
        return torch.cumsum(vlen, dim=1, dtype=_I32)
    local = torch.cumsum(vlen.reshape(b, sp_shards, c // sp_shards), dim=2,
                         dtype=_I32)
    totals = local[..., -1]
    offsets = torch.cumsum(totals, dim=1, dtype=_I32) - totals
    return (local + offsets[..., None]).reshape(b, c)


def visibility(s: DocState, ref_seq, client, sp_shards: int = 1):
    """(vis, vlen, cum): visibility mask, visible lengths and the
    exclusive prefix sum of [B, C] states at perspective (ref_seq, client),
    each [B, 1] (kernel.py visibility; mergeTree.ts:1586 nodeLength), the
    prefix sum in the sp_shards formulation."""
    valid = _lanes(s) < s.count[:, None]
    inserted = (s.ins_seq <= ref_seq) | (s.ins_client == client)
    removed = (s.rem_seq <= ref_seq) | \
        (s.rem_clients == client[..., None]).any(dim=-1)
    vis = valid & inserted & ~removed
    vlen = torch.where(vis, s.length, 0)
    cum = _cumsum_sp(vlen, sp_shards) - vlen
    return vis, vlen, cum


def _shift_right_by(s: DocState, slot, do, k: int) -> DocState:
    """Rows at indices >= slot move right by the static width k where `do`
    (JAX's cyclic roll: rows [slot, slot + k) become stale copies that the
    caller overwrites); count grows by k."""
    if _off(do):
        return s
    mask = (_lanes(s) >= slot) & do

    def shift(x):
        m = mask if x.dim() == 2 else mask[..., None]
        return torch.where(m, torch.roll(x, k, dims=1), x)

    return s._replace(
        **{name: shift(getattr(s, name)) for name in _ROW_FIELDS},
        count=s.count + do[:, 0].to(_I32) * k)


def _shift_right_at(s: DocState, slot, do) -> DocState:
    """Shift rows at indices >= slot right by one where `do`."""
    return _shift_right_by(s, slot, do, 1)


def _ensure_boundary(s: DocState, pos, ref_seq, client, enabled,
                     sp_shards: int = 1) -> DocState:
    """Split the segment containing `pos` (if any) so `pos` falls on a
    segment boundary (reference ensureIntervalBoundary, mergeTree.ts:2240)."""
    if _off(enabled):
        return s
    vis, vlen, cum = visibility(s, ref_seq, client, sp_shards)
    inside = vis & (cum < pos) & (pos < cum + vlen)
    do = enabled & _any(inside)
    idx = _first(inside)
    off = pos - _masked_scalar(cum, inside)
    parent_len = _masked_scalar(s.length, inside)
    g = _shift_right_at(s, idx + 1, do)
    j = _lanes(s)
    is_left = do & (j == idx)
    is_right = do & (j == idx + 1)
    return g._replace(
        length=torch.where(is_left, off,
                           torch.where(is_right, parent_len - off, g.length)),
        origin_off=torch.where(is_right, g.origin_off + off, g.origin_off))


def _insert_phase(s: DocState, op, enabled, view) -> DocState:
    """Find the insert slot via the breakTie run-scan (mergeTree.ts:2248),
    shift, write the new segment; `view` is the visibility triple on s."""
    if _off(enabled):
        return s
    r, cl, p = op["ref_seq"], op["client"], op["pos1"]
    is_local = op["seq"] == DEV_UNASSIGNED
    vis, _vlen, cum = view
    j = _lanes(s)
    in_run = cum == p
    tomb = s.rem_seq <= r
    acked_ins = s.ins_seq != DEV_UNASSIGNED
    stop = in_run & (vis | (~tomb & (is_local | acked_ins))
                     | (j >= s.count[:, None]))
    # pos beyond the visible length leaves no stop slot: flagged.
    found = _any(stop)
    bad = enabled & ~found
    enabled = enabled & found
    slot = _first(stop)
    g = _shift_right_at(s, slot, enabled)
    here = enabled & (j == slot)
    here_k = here[..., None]
    return g._replace(
        length=torch.where(here, op["new_len"], g.length),
        ins_seq=torch.where(here, op["seq"], g.ins_seq),
        ins_client=torch.where(here, cl, g.ins_client),
        local_seq=torch.where(here, torch.where(is_local, op["local_seq"], 0),
                              g.local_seq),
        rem_seq=torch.where(here, DEV_NO_REMOVE, g.rem_seq),
        rem_local_seq=torch.where(here, 0, g.rem_local_seq),
        rem_clients=torch.where(here_k, -1, g.rem_clients),
        origin_op=torch.where(here, op["op_id"], g.origin_op),
        origin_off=torch.where(here, 0, g.origin_off),
        anno=torch.where(here_k, -1, g.anno),
        overflow=g.overflow | bad[:, 0])


def _insert_run_phase(s: DocState, op, run, enabled, view) -> DocState:
    """INSERT_RUN: up to RUN_K cursor-advance inserts by one (client,
    refSeq) land as contiguous rows at the first insert's tie-break slot:
    one shift by RUN_K and RUN_K masked fills. Padding rows (length 0) are
    born dead (rem_seq 0). `run` holds the step's [B, RUN_K] RunCols."""
    if _off(enabled):
        return s
    r, cl, p = op["ref_seq"], op["client"], op["pos1"]
    vis, _vlen, cum = view
    j = _lanes(s)
    in_run = cum == p
    tomb = s.rem_seq <= r
    acked_ins = s.ins_seq != DEV_UNASSIGNED
    stop = in_run & (vis | (~tomb & acked_ins) | (j >= s.count[:, None]))
    found = _any(stop)
    bad = enabled & ~found
    enabled = enabled & found
    slot = _first(stop)
    g = _shift_right_by(s, slot, enabled, RUN_K)
    rel = j - slot
    here = enabled & (rel >= 0) & (rel < RUN_K)

    def pick(col, pad):
        out = torch.full_like(s.length, pad)
        for k in range(RUN_K):
            out = torch.where(rel == k, col[:, k:k + 1], out)
        return out

    row_len = pick(run["length"], 0)
    row_seq = pick(run["seq"], 0)
    row_id = pick(run["op_id"], -1)
    live = here & (row_len > 0)
    dead = here & (row_len == 0)
    here_k = here[..., None]
    return g._replace(
        length=torch.where(here, row_len, g.length),
        ins_seq=torch.where(live, row_seq,
                            torch.where(dead, 0, g.ins_seq)),
        ins_client=torch.where(live, cl, torch.where(dead, -1, g.ins_client)),
        local_seq=torch.where(here, 0, g.local_seq),
        rem_seq=torch.where(live, DEV_NO_REMOVE,
                            torch.where(dead, 0, g.rem_seq)),
        rem_local_seq=torch.where(here, 0, g.rem_local_seq),
        rem_clients=torch.where(here_k, -1, g.rem_clients),
        origin_op=torch.where(here, row_id, g.origin_op),
        origin_off=torch.where(here, 0, g.origin_off),
        anno=torch.where(here_k, -1, g.anno),
        overflow=g.overflow | bad[:, 0])


def _range_targets(op, view):
    """Visible segments fully inside [pos1, pos2) (boundaries pre-split)."""
    vis, vlen, cum = view
    return vis & (vlen > 0) & (cum >= op["pos1"]) & \
        (cum + vlen <= op["pos2"])


def _append_overlap(rc, need, client):
    """Per row: place client[b, c] into the first free (-1) overlap slot
    (>= 1) of rc [B, C, K] where need."""
    k = rc.shape[-1]
    free = rc == -1
    free[..., 0] = False  # slot 0 is the primary remover
    first_free = free.to(torch.uint8).argmax(dim=-1)
    can = need & free.any(dim=-1)
    onehot = torch.arange(k, device=rc.device) == first_free[..., None]
    return torch.where(can[..., None] & onehot, client[..., None], rc)


def _remove_phase(s: DocState, op, enabled, view) -> DocState:
    """markRangeRemoved semantics (mergeTree.ts:2607): first acked remove
    wins; a pending local remove is overwritten by an acked one (the prior
    remover becomes an overlap client); later removers are overlap
    clients."""
    if _off(enabled):
        return s
    target = _range_targets(op, view) & enabled
    cl, seq = op["client"], op["seq"]
    is_local = seq == DEV_UNASSIGNED
    fresh = target & (s.rem_seq == DEV_NO_REMOVE)
    pend_overwrite = target & (s.rem_seq == DEV_UNASSIGNED) & ~is_local
    already = target & (s.rem_seq != DEV_NO_REMOVE) & ~pend_overwrite

    rem_seq = torch.where(fresh, torch.where(is_local, DEV_UNASSIGNED, seq),
                          torch.where(pend_overwrite, seq, s.rem_seq))
    rem_local_seq = torch.where(fresh & is_local, op["local_seq"],
                                torch.where(pend_overwrite, 0,
                                            s.rem_local_seq))
    primary = torch.arange(s.overlap_slots, device=s.length.device) == 0
    cl_k = cl[..., None]
    rc = torch.where(fresh[..., None] & primary, cl_k, s.rem_clients)
    # pend_overwrite: the prior (pending) remover shifts into an overlap
    # slot, the acked remover takes the primary slot.
    prior = s.rem_clients[..., 0]
    rc = torch.where(pend_overwrite[..., None] & primary, cl_k, rc)
    displaced = pend_overwrite & (prior != cl)
    rc = _append_overlap(rc, displaced, prior)
    # already removed (acked): record this client as an overlapping remover.
    need = already & ~(s.rem_clients == cl_k).any(dim=-1)
    rc = _append_overlap(rc, need, torch.zeros_like(prior) + cl)
    want = torch.where(displaced, prior, cl)
    overflow = ((displaced | need) &
                ~(rc == want[..., None]).any(dim=-1)).any(dim=1)
    return s._replace(rem_seq=rem_seq, rem_local_seq=rem_local_seq,
                      rem_clients=rc, overflow=s.overflow | overflow)


def _annotate_phase(s: DocState, op, enabled, view) -> DocState:
    """Push the annotate op id into each affected segment's fixed-depth
    ring (newest first); the host resolves per-key LWW by op seq. Ring
    exhaustion (oldest slot still occupied) flags overflow."""
    if _off(enabled):
        return s
    target = _range_targets(op, view) & enabled
    b, c, _a = s.anno.shape
    newest = op["op_id"][..., None].expand(b, c, 1)
    pushed = torch.cat([newest, s.anno[..., :-1]], dim=-1)
    overflow = (target & (s.anno[..., -1] != -1)).any(dim=1)
    return s._replace(anno=torch.where(target[..., None], pushed, s.anno),
                      overflow=s.overflow | overflow)


def _ack_phase(s: DocState, op) -> DocState:
    """Assign the server seq to pending segments matching the acked local
    op (reference ackPendingSegment, mergeTree.ts:1893)."""
    kind, seq, target = op["kind"], op["seq"], op["local_seq"]
    if _off((kind == OpKind.ACK_INSERT) | (kind == OpKind.ACK_REMOVE)):
        return s
    ins_hit = (kind == OpKind.ACK_INSERT) & \
        (s.ins_seq == DEV_UNASSIGNED) & (s.local_seq == target)
    rem_hit = (kind == OpKind.ACK_REMOVE) & \
        (s.rem_seq == DEV_UNASSIGNED) & (s.rem_local_seq == target)
    return s._replace(
        ins_seq=torch.where(ins_hit, seq, s.ins_seq),
        local_seq=torch.where(ins_hit, 0, s.local_seq),
        rem_seq=torch.where(rem_hit, seq, s.rem_seq),
        rem_local_seq=torch.where(rem_hit, 0, s.rem_local_seq))


def apply_one(s: DocState, op, run=None, sp_shards: int = 1) -> DocState:
    """Apply one op per document: `op` maps each PackedOps field to its
    [B, 1] column at this step, `run` (INSERT_RUN streams only) each
    RunCols field to its [B, RUN_K] row; the prefix sums in the sp_shards
    formulation."""
    kind = op["kind"]
    is_run = (kind == OpKind.INSERT_RUN) if run is not None \
        else torch.zeros_like(kind, dtype=torch.bool)
    is_edit = (kind == OpKind.INSERT) | (kind == OpKind.REMOVE) | \
        (kind == OpKind.ANNOTATE) | is_run
    is_range = (kind == OpKind.REMOVE) | (kind == OpKind.ANNOTATE)
    # Capacity guard: an edit may create up to 2 new slots (an insert run
    # up to RUN_K + 1); overflowing ops become no-ops with the flag set.
    need = torch.where(is_run, RUN_K + 1, 2) if run is not None else 2
    fits = s.count[:, None] + need <= s.capacity
    s = s._replace(overflow=s.overflow | (is_edit & ~fits)[:, 0])
    is_edit = is_edit & fits
    is_range = is_range & fits
    is_run = is_run & fits

    r, cl = op["ref_seq"], op["client"]
    s1 = _ensure_boundary(s, op["pos1"], r, cl, is_edit, sp_shards)
    s2 = _ensure_boundary(s1, op["pos2"], r, cl, is_range, sp_shards)
    # One visibility pass on s2 serves the insert and range phases (each
    # leaves the others' state unchanged where it is consumed).
    view2 = visibility(s2, r, cl, sp_shards)
    s_ins = _insert_phase(s2, op, is_edit & (kind == OpKind.INSERT), view2)
    if run is not None:
        s_ins = _insert_run_phase(s_ins, op, run, is_run, view2)
    s_rem = _remove_phase(s_ins, op, is_range & (kind == OpKind.REMOVE),
                          view2)
    s_ann = _annotate_phase(s_rem, op, is_range & (kind == OpKind.ANNOTATE),
                            view2)
    out = _ack_phase(s_ann, op)

    # Pending local submits (seq == DEV_UNASSIGNED) must not advance the
    # acked high-water mark.
    acked = ((kind != OpKind.NOOP) & (op["seq"] != DEV_UNASSIGNED))[:, 0]
    return out._replace(
        seq=torch.where(acked, torch.maximum(out.seq, op["seq"][:, 0]),
                        out.seq),
        min_seq=torch.where(acked, torch.maximum(out.min_seq,
                                                 op["msn"][:, 0]),
                            out.min_seq))


def _scan_batched_plain(state: DocState, ops: PackedOps,
                        runs: Optional[RunCols],
                        sp_shards: int = 1) -> DocState:
    s = state
    for t in range(ops.steps):
        op = {f: col[:, t:t + 1] for f, col in zip(PackedOps._fields, ops)}
        run = None if runs is None else {
            f: col[:, t] for f, col in zip(RunCols._fields, runs)}
        s = apply_one(s, op, run, sp_shards)
    # A skipped phase hands its input back: copy what no op replaced.
    return DocState(*(o.clone() if o is i else o.contiguous()
                      for o, i in zip(s, state)))


def scan_ops_plain(state: DocState, ops: PackedOps, batched: bool,
                   runs: Optional[RunCols] = None,
                   sp_shards: int = 1) -> DocState:
    """The plain PyTorch scan apply on any device: the reference that
    scan_apply.cu is held to. [C] / [T] (batched=False) or [B, C] /
    [B, T]; runs: RunCols [T, RUN_K] / [B, T, RUN_K] or None; sp_shards:
    the prefix sums' two-level formulation (the same result)."""
    if batched:
        return _scan_batched_plain(state, ops, runs, sp_shards)
    return _drop(_scan_batched_plain(_lift(state), _lift(ops), _lift(runs),
                                     sp_shards))


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

# scan_apply.cu's limits and layouts: the shared memory a block may use on
# Hopper (kSmemLimit), threads per block at most (kScanThreads: 128
# registers a thread), the scratch ints of the global_chunked path
# (kScratchInts) and of the live paths (kLiveScratch), and the largest C
# whose two view planes fit beside the latter (kMaxSharedSlots; above it
# the device-memory paths keep them in a [B, 2, C] buffer).
SMEM_LIMIT_BYTES = 232_448
MAX_BLOCK_THREADS = 512
_CHUNKED_SCRATCH_INTS = 128
_LIVE_SCRATCH_INTS = 200
MAX_SHARED_SLOTS = (SMEM_LIMIT_BYTES - _LIVE_SCRATCH_INTS * 4) // 8
MAX_CLUSTER = 16   # 8 portable; 16 with the non-portable attribute
_MAX_OVERLAP_SLOTS = 8
# scan_apply.cu enum ScanPath. global_chunked is the first design (one
# thread per slot, every pass over all C, three view passes per range op),
# kept to be measured against; the rule never takes it. Read-only: every
# launch reads it.
_SCAN_PATHS = MappingProxyType(
    {"global_chunked": 0, "global": 1, "smem": 2, "cluster": 3})
SCAN_PATHS = tuple(_SCAN_PATHS)
# The rule (scan_geometry), measured on the H100 by
# `calibrate_fused_apply.py --scan` (PERF.md §6):
# - a table that fits one block's shared memory takes the smem path
#   (faster than every cluster and the global path at C = 1,024 for every
#   B measured);
# - else, from C = CLUSTER_MIN_CAPACITY on, while the launch has fewer
#   than CLUSTER_MAX_DOCS documents, a cluster of CLUSTER_BLOCKS blocks,
#   or the smallest larger one that holds the table (the catch-up's
#   C = 16,384 chunk: 8 blocks 18% faster than the global path and than
#   16 blocks; the grid at B = 1 and 8, C = 8,192-16,384, above 15% fill:
#   8 blocks within 2% of the fastest); at B = 132 the global path was
#   faster, and 16 is where 8-block clusters fill the 132 SMs. Below
#   CLUSTER_MIN_CAPACITY the catch-up's C = 4,096 chunk (typing at the
#   end: short shifts, the cluster barriers of each op not repaid) was
#   fastest on the global path, 8% ahead of the best cluster;
# - else, from CLUSTER_MAX_DOCS to SM_COUNT - 1 documents (the paged
#   serving groups), the smallest cluster that holds the table while the
#   launch's blocks (B x its size) fit one wave of the card's SM_COUNT
#   SMs. At the main paths' inputs it is the fastest path: the ring's
#   hot group (64 x C = 4,096, two blocks) 0.27 ms against 0.42 on the
#   global path; the lane store's burst chunk (64 x C = 8,192: four
#   blocks would take two waves) 6.2 ms on the global path against 8.3
#   on four blocks (chip_smoke.py phase 15). On `calibrate_fused_apply.py
#   --scan --paged`'s grid (B = 16-128, C = 4,096 / 8,192) a two-wave
#   cluster lost to the global path up to 35% fill (1.2-1.9x) and won
#   only at 90%. (A document whose padding past count is not canonical
#   sweeps its whole table on every path, which the global path pays
#   most for: 15.5 ms against 8.5 on four blocks with 5 of 64 such
#   documents, an overflowed window's leftovers that the sequencer rolls
#   back. PERF.md §6);
# - else the global path.
# Threads: C (or a rank's slots) rounded up to 32, at most LIVE_THREADS;
# at B >= MANY_DOCS (several blocks per SM), 128 on the smem path and 256
# on the global path up to C = MANY_DOCS_GLOBAL_C.
CLUSTER_BLOCKS = 8
CLUSTER_MIN_CAPACITY = 8192
CLUSTER_MAX_DOCS = 16
SM_COUNT = 132   # the H100 SXM's streaming multiprocessors
LIVE_THREADS = 512
MANY_DOCS = 1024
MANY_DOCS_GLOBAL_C = 8192


class ScanGeometry(NamedTuple):
    """How one scan-apply launch is laid out on the card."""
    path: str             # one of SCAN_PATHS
    blocks: int           # per document (the cluster's size; else 1)
    threads: int          # per block
    smem_bytes: int       # dynamic shared memory per block
    global_scratch: bool  # view planes in a device buffer (global paths)


def _check_scan_shape(capacity: int, k_slots: int, a_slots: int) -> None:
    if not 1 <= k_slots <= _MAX_OVERLAP_SLOTS or a_slots < 1 \
            or capacity < 1 or (8 + k_slots + a_slots) * capacity >= 2**31:
        raise ValueError(
            f"the scan apply kernel takes 1 <= K <= {_MAX_OVERLAP_SLOTS}, "
            f"A >= 1, C >= 1 and (8 + K + A) * C < 2^31 (got K={k_slots}, "
            f"A={a_slots}, C={capacity})")


def shared_table_bytes(capacity: int, k_slots: int, a_slots: int,
                       blocks: int) -> int:
    """Shared memory of one block of the smem (blocks = 1) or cluster path:
    a rank's slots of the P table planes and the two view planes, the
    shift's staging (RUN_K slots of each), the scratch
    (scan_apply.cu shared_table_bytes)."""
    cs = -(-capacity // blocks)
    return ((8 + k_slots + a_slots + 2) * (cs + RUN_K)
            + _LIVE_SCRATCH_INTS) * 4


def cluster_blocks(capacity: int, k_slots: int, a_slots: int,
                   most: int = MAX_CLUSTER) -> Optional[int]:
    """The smallest cluster (2, 4, 8, 16 blocks, at most `most`) whose
    blocks hold the table in shared memory; None if none does."""
    n = 2
    while n <= most:
        if shared_table_bytes(capacity, k_slots, a_slots, n) \
                <= SMEM_LIMIT_BYTES:
            return n
        n *= 2
    return None


def _live_threads(batch: int, path: str, capacity: int, blocks: int) -> int:
    """The rule's threads per block on a live path."""
    threads = min(-(-capacity // blocks // 32) * 32, LIVE_THREADS)
    if batch >= MANY_DOCS and path == "smem":
        return min(threads, 128)
    if batch >= MANY_DOCS and path == "global" \
            and capacity <= MANY_DOCS_GLOBAL_C:
        return min(threads, 256)
    return threads


def _forced_geometry(path: str, capacity: int, k_slots: int, a_slots: int,
                     blocks: Optional[int] = None,
                     threads: Optional[int] = None,
                     batch: int = 1) -> ScanGeometry:
    """The geometry of `path` at capacity C, whatever the rule says (the
    cluster's size defaults to the smallest that holds the table, threads
    to the rule's for `batch` documents): for tests and measurements.
    Raises ValueError where the path cannot hold the table."""
    _check_scan_shape(capacity, k_slots, a_slots)
    if path not in _SCAN_PATHS:
        raise ValueError(f"unknown scan path {path!r} (one of {SCAN_PATHS})")
    big = capacity > MAX_SHARED_SLOTS
    if path == "global_chunked":
        thr = min(-(-capacity // 32) * 32, MAX_BLOCK_THREADS)
        smem = (_CHUNKED_SCRATCH_INTS + (0 if big else 2 * capacity)) * 4
        return ScanGeometry(path, 1, thr, smem, big)
    if path == "global":
        blocks, smem = 1, (_LIVE_SCRATCH_INTS
                           + (0 if big else 2 * capacity)) * 4
    elif path == "smem":
        blocks = 1
        smem = shared_table_bytes(capacity, k_slots, a_slots, 1)
    else:
        blocks = blocks or cluster_blocks(capacity, k_slots, a_slots)
        if blocks is None or not 2 <= blocks <= MAX_CLUSTER:
            raise ValueError(f"no cluster of 2..{MAX_CLUSTER} blocks holds "
                             f"C={capacity} (K={k_slots}, A={a_slots})")
        smem = shared_table_bytes(capacity, k_slots, a_slots, blocks)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"the {path} path cannot hold C={capacity} "
                         f"(K={k_slots}, A={a_slots}, {blocks} block(s): "
                         f"{smem} bytes of shared memory)")
    if threads is None:
        threads = _live_threads(batch, path, capacity, blocks)
    return ScanGeometry(path, blocks, threads, smem,
                        path == "global" and big)


def scan_geometry(batch: int, capacity: int, k_slots: int,
                  a_slots: int) -> ScanGeometry:
    """The path, blocks per document, threads and shared memory of a
    scan-apply launch over B documents of capacity C: one fixed rule,
    measured on the H100 (PERF.md §6; scan_apply.cu checks the geometry
    against its own formulas). Raises ValueError for K outside 1..8,
    A < 1, C < 1 or (8 + K + A) x C >= 2^31."""
    _check_scan_shape(capacity, k_slots, a_slots)
    if shared_table_bytes(capacity, k_slots, a_slots, 1) <= SMEM_LIMIT_BYTES:
        return _forced_geometry("smem", capacity, k_slots, a_slots,
                                batch=batch)
    n = cluster_blocks(capacity, k_slots, a_slots)
    if n is not None and batch < CLUSTER_MAX_DOCS \
            and capacity >= CLUSTER_MIN_CAPACITY:
        return _forced_geometry("cluster", capacity, k_slots, a_slots,
                                max(n, CLUSTER_BLOCKS), batch=batch)
    if n is not None and CLUSTER_MAX_DOCS <= batch < SM_COUNT \
            and batch * n <= SM_COUNT:
        return _forced_geometry("cluster", capacity, k_slots, a_slots, n,
                                batch=batch)
    return _forced_geometry("global", capacity, k_slots, a_slots,
                            batch=batch)


def _check_launchable(state: DocState, ops: PackedOps,
                      runs: Optional[RunCols]) -> None:
    b = state.length.shape[0]
    for name, t in zip(DocState._fields, state):
        want = torch.bool if name == "overflow" else torch.int32
        if t.device.type != "cuda" or t.dtype != want \
                or not t.is_contiguous() or t.shape[0] != b:
            raise ValueError(f"scan_apply: state.{name} must be a "
                             f"contiguous {want} CUDA tensor with {b} rows")
    for name, t in zip(PackedOps._fields, ops):
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.shape != (b, ops.steps):
            raise ValueError(f"scan_apply: ops.{name} must be a "
                             f"contiguous int32 CUDA [{b}, T] tensor")
    for name, t in zip(RunCols._fields, runs or ()):
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous() \
                or t.shape != (b, ops.steps, RUN_K):
            raise ValueError(f"scan_apply: runs.{name} must be a "
                             f"contiguous int32 CUDA [{b}, T, {RUN_K}] "
                             "tensor")


def scan_apply(state: DocState, ops: PackedOps,
               runs: Optional[RunCols] = None,
               sp_shards: int = 1) -> DocState:
    """One launch of kernels/csrc/scan_apply.cu on the path scan_geometry
    names: [B, T] op streams (and [B, T, RUN_K] runs) applied to B
    documents of any capacity, into a new state; the input is left as it
    was. CUDA tensors only: a shape or device the kernel does not take, a
    build error or a launch error (a cluster that cannot be scheduled
    too) raises. Counted in scan_apply.launches (per variant and per
    kernel). sp_shards only names the prefix sums' formulation: the
    two-level form is exact integer arithmetic, the same result as the
    kernel's one-level scan, so the kernel launches as it is."""
    if sp_shards < 1:
        raise ValueError(f"scan_apply: sp_shards must be >= 1 "
                         f"(got {sp_shards})")
    b, c = state.length.shape
    return _launch(state, ops, runs, scan_geometry(
        b, c, state.overlap_slots, state.anno_slots))


def _launch(state: DocState, ops: PackedOps, runs: Optional[RunCols],
            geo: ScanGeometry) -> DocState:
    """One scan-apply launch with an explicit geometry (scan_apply takes
    the rule's; tests and measurements force others)."""
    _check_launchable(state, ops, runs)
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    dev = state.length.device
    out = DocState(*(torch.empty_like(t) for t in state))
    work = torch.empty((b, 8 + k + a, c), dtype=_I32, device=dev) \
        if geo.path in ("global", "global_chunked") else None
    scratch = torch.empty((b, 2, c), dtype=_I32, device=dev) \
        if geo.global_scratch else None
    ptrs = [t.data_ptr() for t in (*state, *out, *ops, *(runs or ()))]
    ptrs += [None if x is None else x.data_ptr() for x in (work, scratch)]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib = build.library()
    scan_apply.launches += 1
    variant = "runs" if runs is not None else "plain"
    scan_apply.variant_launches[variant] += 1
    scan_apply.kernel_launches[f"{geo.path}[{variant}]"] += 1
    note_launch("scan_apply")
    build.check(lib.fluid_scan_apply(
        arr, b, c, k, a, ops.steps, int(runs is not None),
        _SCAN_PATHS[geo.path], geo.blocks, geo.threads, geo.smem_bytes,
        ctypes.c_void_p(build.stream_handle())), "scan_apply")
    return out


def reset_launches() -> None:
    """Zero scan_apply's launch counts: in all, per variant, and per
    kernel ("path[variant]")."""
    scan_apply.launches = 0
    scan_apply.variant_launches = {"plain": 0, "runs": 0}
    scan_apply.kernel_launches = {f"{p}[{v}]": 0 for p in SCAN_PATHS
                                  for v in ("plain", "runs")}


reset_launches()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _scan_ops(state: DocState, ops: PackedOps, batched: bool,
              runs: Optional[RunCols] = None,
              sp_shards: int = 1) -> DocState:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if state.length.device.type == "cpu":
        return scan_ops_plain(state, ops, batched, runs, sp_shards)
    if batched:
        return scan_apply(state, ops, runs, sp_shards)
    return _drop(scan_apply(_lift(state), _lift(ops), _lift(runs),
                            sp_shards))


def apply_ops(state: DocState, ops: PackedOps) -> DocState:
    """Apply a [T] op stream to a single document."""
    return _scan_ops(state, ops, batched=False)


def apply_ops_batched(state: DocState, ops: PackedOps) -> DocState:
    """Apply [B, T] op streams to B documents."""
    return _scan_ops(state, ops, batched=True)


def apply_ops_keep(state: DocState, ops: PackedOps,
                   runs: Optional[RunCols] = None) -> DocState:
    """apply_ops with optional INSERT_RUN columns ([T, RUN_K]); the input
    state survives (an overflow retry re-applies from it)."""
    return _scan_ops(state, ops, batched=False, runs=runs)


def apply_ops_batched_keep(state: DocState, ops: PackedOps,
                           runs: Optional[RunCols] = None) -> DocState:
    """apply_ops_batched with optional INSERT_RUN columns
    ([B, T, RUN_K])."""
    return _scan_ops(state, ops, batched=True, runs=runs)


def apply_if_any(apply_fn, state: DocState, active) -> DocState:
    """apply_fn(state) when `active` (any real op in the block), else state
    unchanged: a NOOP stream is an exact identity on a DocState, so the
    skip is free. JAX's lax.cond stays on the device; here `active` is read
    on the host (one sync when it is a CUDA tensor)."""
    return apply_fn(state) if bool(active) else state


# ---------------------------------------------------------------------------
# zamboni: compaction and extraction (kernels/csrc/zamboni.cu)
# ---------------------------------------------------------------------------

# The kernel's modes and paths, by the codes fluid_zamboni takes.
ZAMBONI_MODES = ("compact", "compact_extract", "extract")
ZAMBONI_PATHS = ("warp", "block", "cluster")
# The rule (zamboni_geometry), measured on the H100 by
# `calibrate_fused_apply.py --zamboni` (PERF.md §6; every path's kernels
# hold 128 registers a thread, so 512 threads fill an SM's registers):
# - from C = ZAMBONI_CLUSTER_MIN_C on, a cluster of the most ranks (16, 8,
#   4 or 2 blocks a document) whose blocks fit one wave of the card's
#   SM_COUNT SMs (B x ranks <= SM_COUNT) and whose ranks hold at least
#   ZAMBONI_RANK_MIN_ROWS slots each, with ZAMBONI_CLUSTER_THREADS threads
#   a block (ZAMBONI_PAIR_THREADS in a cluster of two; fewer where a rank
#   has fewer slots). One document at C = 4,096-16,384: 16 ranks of 256
#   threads 0.0089-0.0095 ms against 0.0121-0.0430 on the block path; 61
#   at C = 8,192: 2 ranks of 512 threads 0.0232 against 0.0385; at C =
#   2,048 the block path won for every B (0.0076 against 0.0083 at best),
#   and at B = 132 every C measured;
# - else the warp path (ZAMBONI_WARP_DOCS documents a block) for tables of
#   at most ZAMBONI_WARP_MAX_C slots whose launch holds at least
#   ZAMBONI_WARP_MIN_ROWS rows (B x C): 10,000 x 256 0.0915 against 0.1689
#   on the block path, 512 x 256 0.0071 against 0.0086; at 512 x 64 and at
#   C = 1,024 for every B the block path won;
# - else the block path (the first design's geometry).
ZAMBONI_CLUSTER_MIN_C = 4096
ZAMBONI_RANK_MIN_ROWS = 256
ZAMBONI_CLUSTER_THREADS = 256
ZAMBONI_PAIR_THREADS = 512
ZAMBONI_WARP_MAX_C = 512
ZAMBONI_WARP_MIN_ROWS = 1 << 17
ZAMBONI_WARP_DOCS = 4
_ZAMBONI_BLOCK_THREADS = 256   # zamboni.cu kBlockThreads
_ZAMBONI_MAX_RANKS = 16        # 8 portable; 16 with the non-portable attribute
_ZAMBONI_MAX_THREADS = 512       # zamboni.cu kMaxThreads


class ZamboniGeometry(NamedTuple):
    """How one zamboni launch is laid out on the card."""
    path: str             # one of ZAMBONI_PATHS
    ranks: int            # blocks a document (the cluster's size; else 1)
    threads: int          # per block
    docs_per_block: int   # documents a block (the warp path; else 1)


def _check_zamboni_shape(batch: int, capacity: int, k_slots: int,
                         a_slots: int) -> None:
    if batch < 0 or capacity < 1 or k_slots < 1 or a_slots < 0:
        raise ValueError(
            f"zamboni takes B >= 0, C >= 1, K >= 1 and A >= 0 (got B={batch}, "
            f"C={capacity}, K={k_slots}, A={a_slots})")


def _forced_zamboni_geometry(path: str, capacity: int,
                             ranks: Optional[int] = None,
                             threads: Optional[int] = None,
                             docs_per_block: Optional[int] = None
                             ) -> ZamboniGeometry:
    """The geometry of `path` at capacity C whatever the rule says (the
    warp path's documents a block default to ZAMBONI_WARP_DOCS, the
    cluster's ranks to 2 and its threads to the rule's for that many
    ranks): for tests and measurements. Raises ValueError for a geometry
    zamboni.cu refuses."""
    if path not in ZAMBONI_PATHS:
        raise ValueError(f"unknown zamboni path {path!r} (one of "
                         f"{ZAMBONI_PATHS})")
    if capacity < 1:
        raise ValueError(f"zamboni takes C >= 1 (got {capacity})")
    rounded = -(-capacity // 32) * 32
    if path == "warp":
        dpb = docs_per_block or ZAMBONI_WARP_DOCS
        geo = ZamboniGeometry(path, 1, threads or 32 * dpb, dpb)
        ok = ranks in (None, 1) and 1 <= dpb <= _ZAMBONI_MAX_THREADS // 32 \
            and geo.threads == 32 * dpb
    elif path == "block":
        geo = ZamboniGeometry(path, 1, threads
                              or min(rounded, _ZAMBONI_BLOCK_THREADS), 1)
        ok = ranks in (None, 1) and docs_per_block in (None, 1) \
            and geo.threads == min(rounded, _ZAMBONI_BLOCK_THREADS)
    else:
        n = ranks or 2
        rows = -(-capacity // max(n, 1) // 32) * 32
        most = ZAMBONI_PAIR_THREADS if n == 2 else ZAMBONI_CLUSTER_THREADS
        geo = ZamboniGeometry(path, n, threads or min(rows, most), 1)
        ok = 2 <= n <= _ZAMBONI_MAX_RANKS and docs_per_block in (None, 1) \
            and geo.threads % 32 == 0 \
            and 32 <= geo.threads <= _ZAMBONI_MAX_THREADS
    if not ok:
        raise ValueError(f"zamboni.cu does not take the {path} path with "
                         f"ranks={ranks}, threads={threads}, "
                         f"docs_per_block={docs_per_block} at C={capacity}")
    return geo


def zamboni_cluster_ranks(batch: int, capacity: int) -> int:
    """The rule's cluster size at B documents of capacity C: the most ranks
    (16, 8, 4, 2) with B x ranks <= SM_COUNT and C >= ranks x
    ZAMBONI_RANK_MIN_ROWS, from C = ZAMBONI_CLUSTER_MIN_C on; 1 (no
    cluster) where none."""
    if capacity < ZAMBONI_CLUSTER_MIN_C:
        return 1
    n = _ZAMBONI_MAX_RANKS
    while n >= 2 and (batch * n > SM_COUNT
                      or capacity < n * ZAMBONI_RANK_MIN_ROWS):
        n //= 2
    return max(n, 1)


def zamboni_geometry(batch: int, capacity: int, k_slots: int,
                     a_slots: int) -> ZamboniGeometry:
    """The path, ranks, threads and documents a block of a zamboni launch
    over B documents of capacity C (K overlap and A annotate slots): one
    fixed rule, measured on the H100 (PERF.md §6; zamboni.cu checks the
    geometry against its own formulas). Pure: the same arguments give the
    same geometry. Raises ValueError for B < 0, C < 1, K < 1 or A < 0."""
    _check_zamboni_shape(batch, capacity, k_slots, a_slots)
    n = zamboni_cluster_ranks(batch, capacity)
    if n >= 2:
        return _forced_zamboni_geometry("cluster", capacity, ranks=n)
    if capacity <= ZAMBONI_WARP_MAX_C \
            and batch * capacity >= ZAMBONI_WARP_MIN_ROWS:
        return _forced_zamboni_geometry("warp", capacity)
    return _forced_zamboni_geometry("block", capacity)


def _on_card(device: torch.device) -> bool:
    """Whether the zamboni and narrow-pack kernels' tensors may lie on
    `device`: a CUDA device. (The emulator tests, which run the CUDA
    sources on the CPU, stand in for it.)"""
    return device.type == "cuda"


def _takes_plain(t: torch.Tensor) -> bool:
    """The plain version runs for a tensor on the CPU, and only there."""
    return t.device.type == "cpu" and not _on_card(t.device)


def _on_device(dev: torch.device):
    """The launch's device as the current CUDA device (a mesh shard's
    tensors need not lie on the current one)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _gather_segments(s: DocState, src: torch.Tensor) -> DocState:
    """Reindex all segment columns of a [B, C] state by src [B, C]
    (clipped gather)."""
    src = src.clamp(0, s.capacity - 1).long()

    def g(x):
        if x.dim() == 2:
            return x.gather(1, src)
        return x.gather(1, src[..., None].expand(-1, -1, x.shape[-1]))

    return s._replace(**{name: g(getattr(s, name)) for name in _ROW_FIELDS})


def _pack_src(s: DocState):
    """The keep-mask + prefix-sum + scatter-to-gather addressing of
    zamboni compaction: left-pack the rows not removed at-or-before
    min_seq. Returns (src [B, C]: the gather source of each output slot,
    n [B]: the live count)."""
    b, c = s.length.shape
    idx = _lanes(s)
    keep = (idx < s.count[:, None]) & ~(s.rem_seq <= s.min_seq[:, None])
    n = keep.sum(dim=1, dtype=_I32)
    order = torch.cumsum(keep.to(_I32), dim=1, dtype=_I32) - 1
    # Destination of each kept row; column c takes (and drops) the rest.
    src = torch.full((b, c + 1), c - 1, dtype=_I32, device=idx.device)
    dst = torch.where(keep, order, c).long()
    src.scatter_(1, dst, idx.expand(b, c))
    return src[:, :c], n


def compact_batched_plain(s: DocState) -> DocState:
    """Plain PyTorch version of compact_batched: free segments removed
    at-or-before min_seq (reference zamboni, mergeTree.ts:1422):
    stable-partition the live segments to the front and reset the rows
    past them to make_state's padding."""
    src, new_count = _pack_src(s)
    g = _gather_segments(s, src)
    pad = _lanes(s) >= new_count[:, None]
    pad_k = pad[..., None]
    return g._replace(
        length=torch.where(pad, 0, g.length),
        ins_seq=torch.where(pad, DEV_UNASSIGNED, g.ins_seq),
        ins_client=torch.where(pad, -1, g.ins_client),
        local_seq=torch.where(pad, 0, g.local_seq),
        rem_seq=torch.where(pad, DEV_NO_REMOVE, g.rem_seq),
        rem_local_seq=torch.where(pad, 0, g.rem_local_seq),
        rem_clients=torch.where(pad_k, -1, g.rem_clients),
        origin_op=torch.where(pad, -1, g.origin_op),
        origin_off=torch.where(pad, 0, g.origin_off),
        anno=torch.where(pad_k, -1, g.anno),
        count=new_count)


def _check_zamboni(state: DocState, mode: str) -> None:
    """Raise ValueError unless zamboni.cu takes this state in this mode:
    the types, contiguity and shapes first, the CUDA device last. seq and
    overflow are not read (they pass through)."""
    if mode not in ZAMBONI_MODES:
        raise ValueError(f"zamboni: unknown mode {mode!r} (one of "
                         f"{ZAMBONI_MODES})")
    if state.length.dim() != 2 or state.rem_clients.dim() != 3 \
            or state.anno.dim() != 3:
        raise ValueError("zamboni: the state is not a [B, C] batch")
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    if c < 1 or k < 1:
        raise ValueError(f"zamboni: the kernel takes C >= 1 slots and K >= "
                         f"1 overlap slots, not C={c}, K={k}")
    want = {"rem_clients": (b, c, k), "anno": (b, c, a),
            "count": (b,), "min_seq": (b,)}
    fields = (*_ROW_FIELDS, "count", "min_seq")
    for name in fields:
        x = getattr(state, name)
        shape = want.get(name, (b, c))
        if x.dtype != _I32:
            raise ValueError(f"zamboni: state.{name} is {x.dtype}, not "
                             "torch.int32")
        if tuple(x.shape) != shape:
            raise ValueError(f"zamboni: state.{name} has shape "
                             f"{tuple(x.shape)}, not {shape}")
        if not x.is_contiguous():
            raise ValueError(f"zamboni: state.{name} is not contiguous")
    for name in fields:
        x = getattr(state, name)
        if not _on_card(x.device) or x.device != state.length.device:
            raise ValueError(f"zamboni: state.{name} is on {x.device}, not "
                             "the CUDA device of the state")


def zamboni(state: DocState, mode: str, stats: bool = False) -> tuple:
    """One launch of kernels/csrc/zamboni.cu over a [B, C] batch of CUDA
    tensors in `mode` ("compact", "compact_extract" or "extract"), on the
    path zamboni_geometry names, into new tensors; the input is left as it
    was. Returns (compacted state or None, packed rows or None,
    pre-compaction counts or None): the compacted state keeps the input's
    min_seq, seq and overflow tensors, as the plain version does, and the
    fused mode's packed rows are the compacted state's planes plus a
    rem_client plane. stats=True also writes the pre-compaction counts.
    Tensors the kernel does not take raise ValueError, a launch error
    RuntimeError. A batch of zero documents launches nothing. Counted in
    zamboni.launches, zamboni.mode_launches[mode], zamboni.path_launches
    [path] and zamboni.shape_launches[(mode, path, B, C)]."""
    _check_zamboni(state, mode)
    b, c = state.length.shape
    return _zamboni_launch(state, mode, stats, zamboni_geometry(
        b, c, state.overlap_slots, state.anno_slots))


def _zamboni_launch(state: DocState, mode: str, stats: bool,
                    geo: ZamboniGeometry) -> tuple:
    """One zamboni launch with an explicit geometry (zamboni takes the
    rule's; tests and measurements force others)."""
    _check_zamboni(state, mode)
    b, c = state.length.shape
    dev = state.length.device

    def plane():
        return torch.empty((b, c), dtype=_I32, device=dev)

    comp = packed = None
    if mode != "extract":
        comp = state._replace(
            **{name: torch.empty_like(getattr(state, name))
               for name in _ROW_FIELDS},
            count=torch.empty((b,), dtype=_I32, device=dev))
    if mode == "compact_extract":
        packed = (comp.origin_op, comp.origin_off, comp.length, comp.anno,
                  comp.ins_seq, comp.ins_client, comp.rem_seq, plane(),
                  comp.count)
    elif mode == "extract":
        packed = (plane(), plane(), plane(), torch.empty_like(state.anno),
                  plane(), plane(), plane(), plane(),
                  torch.empty((b,), dtype=_I32, device=dev))
    pre = torch.empty((b,), dtype=_I32, device=dev) if stats else None
    if b == 0:  # a grid of no blocks is an invalid launch
        return comp, packed, pre
    ptrs = [getattr(state, name).data_ptr()
            for name in (*_ROW_FIELDS, "count", "min_seq")]
    ptrs += [None] * 11 if comp is None else \
        [getattr(comp, name).data_ptr() for name in (*_ROW_FIELDS, "count")]
    packed_ptrs = [None] * 9
    if mode == "extract":
        packed_ptrs = [x.data_ptr() for x in packed]
    elif mode == "compact_extract":  # the kernel writes rem_client alone
        packed_ptrs[7] = packed[7].data_ptr()
    ptrs += packed_ptrs
    ptrs.append(None if pre is None else pre.data_ptr())
    lib = build.library()
    zamboni.launches += 1
    zamboni.mode_launches[mode] += 1
    zamboni.path_launches[geo.path] += 1
    key = (mode, geo.path, b, c)
    zamboni.shape_launches[key] = zamboni.shape_launches.get(key, 0) + 1
    note_launch("zamboni")
    with _on_device(dev):
        build.check(lib.fluid_zamboni(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            ZAMBONI_MODES.index(mode), b, c, state.overlap_slots,
            state.anno_slots, ZAMBONI_PATHS.index(geo.path), geo.ranks,
            geo.threads, geo.docs_per_block,
            ctypes.c_void_p(build.stream_handle())), "zamboni")
    return comp, packed, pre


def compact_batched(state: DocState) -> DocState:
    """Zamboni compaction of a [B, C] batch: compact_batched_plain for CPU
    tensors; for CUDA tensors one launch of zamboni.cu, or ValueError for
    tensors it does not take. The input is not written."""
    if _takes_plain(state.length):
        return compact_batched_plain(state)
    return zamboni(state, "compact")[0]


def compact(state: DocState) -> DocState:
    """Zamboni compaction of one document."""
    return _drop(compact_batched(_lift(state)))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def _perspective(state: DocState, ref_seq, client):
    """(batched state, ref_seq [B, 1], client [B, 1], single?) for the
    queries: scalars or [B] tensors for a batch."""
    single = state.length.dim() == 1
    s = _lift(state) if single else state
    dev = s.length.device
    b = s.length.shape[0]

    def col(v):
        return torch.as_tensor(v, dtype=_I32, device=dev).reshape(-1, 1) \
            .expand(b, 1)

    return s, col(ref_seq), col(client), single


def visible_mask(state: DocState, ref_seq, client) -> torch.Tensor:
    """Visibility of every slot at perspective (ref_seq, client): [C] for
    one document, [B, C] for a batch."""
    s, r, cl, single = _perspective(state, ref_seq, client)
    vis, _vlen, _cum = visibility(s, r, cl)
    return vis[0] if single else vis


def doc_length(state: DocState, ref_seq, client) -> torch.Tensor:
    """Visible length at perspective (ref_seq, client): an int32 scalar for
    one document, [B] for a batch."""
    s, r, cl, single = _perspective(state, ref_seq, client)
    _vis, vlen, _cum = visibility(s, r, cl)
    total = vlen.sum(dim=1, dtype=_I32)
    return total[0] if single else total


# ---------------------------------------------------------------------------
# paged lane memory: gather / scatter by page id (mergetree/paging.py)
# ---------------------------------------------------------------------------

def gather_pages(pool: DocState, page_ids: torch.Tensor, counts: torch.Tensor,
                 min_seqs: torch.Tensor, seqs: torch.Tensor) -> DocState:
    """[B, P] int32 page tables (-1 pads a short table and gathers the
    blank page 0) -> a [B, P * PAGE_ROWS, ...] DocState view with the
    per-document scalars given and a fresh overflow plane. In JAX an XLA
    gather, so plain torch indexing is the port."""
    b, p = page_ids.shape
    r = pool.capacity
    if isinstance(pool.length, Sharded):
        # A pool on a mesh: each page comes from its owning shard to the
        # dispatching device (the counts' device), routed by host ids.
        # fluidlint: disable=HOST_SYNC — the mesh routes each page to its
        # owning shard by host row ids (parallel/mesh.take_rows), one read
        host = page_ids.reshape(-1).cpu().numpy()
        # fluidlint: disable=PAGE_ID_DTYPE — host row ids for take_rows
        ids = np.maximum(host, 0).astype(np.int64)
        gather_pages.page_copies += int((host >= 0).sum())

        def g(col):
            x = take_rows(col, ids, device=counts.device)
            return x.reshape((b, p * r) + tuple(x.shape[2:]))
    else:
        # fluidlint: disable=PAGE_ID_DTYPE — the transient index of the
        # gather (torch's indexing takes int64); the table stays int32
        gidx = torch.clamp(page_ids, min=0).to(torch.int64)

        def g(col):
            x = col[gidx]  # [B, P, R, ...]
            return x.reshape((b, p * r) + tuple(x.shape[3:]))

    return DocState(
        **{name: g(getattr(pool, name)) for name in _ROW_FIELDS},
        count=counts, min_seq=min_seqs, seq=seqs,
        overflow=torch.zeros((b,), dtype=torch.bool, device=counts.device))


def scatter_pages(pool: DocState, page_ids: torch.Tensor,
                  view: DocState) -> DocState:
    """Write a [B, P * PAGE_ROWS, ...] view back into its pages, IN PLACE
    on `pool`'s row tensors, and return `pool`.

    JAX drops the rows of padding ids (-1) with mode="drop"; torch has no
    such mode, so they are redirected to the blank page and page 0 is
    restored from a copy taken before the scatter: the result equals the
    JAX scatter whenever no real table entry is page 0, which the page
    allocator guarantees. Each real page has one owner, so the scatter is
    collision-free."""
    b, p = page_ids.shape
    r = pool.capacity
    if isinstance(pool.length, Sharded):
        # A pool on a mesh: each real page is written back into its owning
        # shard; padding ids are dropped, as JAX's mode="drop" does.
        # fluidlint: disable=HOST_SYNC — the mesh routes each page to its
        # owning shard by host row ids (parallel/mesh.write_rows), one read
        ids = page_ids.reshape(-1).cpu().numpy()
        keep = np.nonzero(ids >= 0)[0]
        scatter_pages.page_copies += len(keep)
        if len(keep):
            for name in _ROW_FIELDS:
                v = getattr(view, name)
                v = v.reshape((b * p, r) + tuple(v.shape[2:]))
                write_rows(getattr(pool, name), ids[keep],
                           v[torch.as_tensor(keep, device=v.device)])
        return pool
    dst = torch.where(page_ids >= 0, page_ids, BLANK_PAGE)
    # fluidlint: disable=PAGE_ID_DTYPE — the transient index of the
    # scatter (torch's indexing takes int64); the table stays int32
    dst = dst.to(torch.int64).reshape(-1)
    for name in _ROW_FIELDS:
        col = getattr(pool, name)
        blank = col[BLANK_PAGE].clone()
        v = getattr(view, name)
        col[dst] = v.reshape((b * p, r) + tuple(v.shape[2:]))
        col[BLANK_PAGE] = blank
    return pool


# ---------------------------------------------------------------------------
# paged ops: apply, rollback and compaction over gathered page views
# ---------------------------------------------------------------------------
#
# JAX jits these with the page pool (and page-table plane) donated, so the
# pool updates in place. Here the plain forms scatter into the given pool's
# tensors in place and return it; the `_keep` forms copy the pool first and
# leave every input as it was (JAX's non-donating twins).

#: The in-place forms: function -> the argument positions whose tensors it
#: writes in place (JAX's donate_argnums). fluidlint's lifecycle rules read
#: this table; nothing reads it at run time.
IN_PLACE_ARGS = {"apply_ops_paged": (0,), "rollback_pages": (0,),
                 "compact_pages": (0,), "compact_extract_paged": (0,)}


def _copy_pool(pool: DocState) -> DocState:
    return DocState(*(clone(t) if isinstance(t, Sharded) else t.clone()
                      for t in pool))


def reset_page_copies() -> None:
    """Zero the counts of pages gathered from a mesh pool's shards and
    scattered back (gather_pages.page_copies, scatter_pages.page_copies)."""
    gather_pages.page_copies = 0
    scatter_pages.page_copies = 0


reset_page_copies()


def paged_stats_vec(ops: PackedOps, out: DocState) -> torch.Tensor:
    """The paged apply's device telemetry plane, an int32 [N_PAGED] vector
    in telemetry/device_stats PAGED_SLOTS order: staged ops by kind,
    flagged documents, post-apply live rows. Padding rows (all-NOOP
    streams on blank views with zeroed counts) add nothing."""
    per_kind = [(ops.kind == kv).sum(dtype=_I32)
                for kv in (OpKind.INSERT, OpKind.REMOVE, OpKind.ANNOTATE,
                           OpKind.ACK_INSERT, OpKind.ACK_REMOVE,
                           OpKind.INSERT_RUN)]
    return torch.stack(per_kind + [out.overflow.sum(dtype=_I32),
                                   out.count.sum(dtype=_I32)])


def _scan_group(view: DocState, ops: PackedOps, plain: bool,
                mesh=None) -> DocState:
    """The apply inside every paged op: kernel.py's _scan_ops(batched=True)
    (scan_apply.cu for CUDA tensors, the plain scan for CPU tensors), or
    the plain scan on any device with plain=True. With the pool on a
    `mesh`, the view's documents split into dp contiguous parts, each
    applied on its shard's device (one launch per shard that has
    documents), and the results come back in document order."""
    def scan(v, o):
        if plain:
            return scan_ops_plain(v, o, batched=True)
        return _scan_ops(v, o, batched=True)

    if mesh is None:
        return scan(view, ops)
    home = view.length.device
    parts = []
    for i, rows in enumerate(np.array_split(np.arange(view.length.shape[0]),
                                            mesh.shape["dp"])):
        if not len(rows):
            continue
        dev, part = mesh.device(i), slice(int(rows[0]), int(rows[-1]) + 1)
        with on_shard(mesh, i):
            parts.append(scan(DocState(*(x[part].to(dev) for x in view)),
                              PackedOps(*(x[part].to(dev) for x in ops))))
        mesh.copies += 2
    return DocState(*(torch.cat([p[k].to(home) for p in parts])
                      for k in range(len(view))))


def pool_mesh(pool: DocState):
    """The mesh a page pool is placed on, or None."""
    return pool.length.mesh if isinstance(pool.length, Sharded) else None


def _apply_ops_paged(pool, page_ids, counts, min_seqs, seqs, ops,
                     stats, plain):
    pre = gather_pages(pool, page_ids, counts, min_seqs, seqs)
    out = _scan_group(pre, ops, plain, pool_mesh(pool))
    scatter_pages(pool, page_ids, out)
    base = (pool, page_ids, out.count, out.min_seq, out.seq, out.overflow,
            pre)
    if stats:
        return base + (paged_stats_vec(ops, out),)
    return base


def apply_ops_paged(pool: DocState, page_ids: torch.Tensor, counts,
                    min_seqs, seqs, ops: PackedOps, stats: bool = False,
                    plain: bool = False):
    """One [B, T] op window over paged documents: gather by page id, the
    batched scan apply, scatter by page id into `pool` in place. Returns
    (pool, page_ids, count, min_seq, seq, overflow, pre_view[, stats]):
    pre_view is the gathered pre-window group, which rollback_pages
    scatters back over flagged documents (annotate-ring or overlap-slot
    exhaustion); stats=True appends paged_stats_vec. plain=True runs the
    plain scan on any device (the reference the kernel is held to)."""
    return _apply_ops_paged(pool, page_ids, counts, min_seqs, seqs, ops,
                            stats, plain)


def apply_ops_paged_keep(pool: DocState, page_ids: torch.Tensor, counts,
                         min_seqs, seqs, ops: PackedOps,
                         stats: bool = False, plain: bool = False):
    """apply_ops_paged on a copy of the pool: no input changes."""
    # fluidlint: disable=MISSING_DONATE — the non-mutating twin: a mesh
    # pool and a risky window's retry keep the pre-window pool
    return _apply_ops_paged(_copy_pool(pool), page_ids, counts, min_seqs,
                            seqs, ops, stats, plain)


def rollback_pages(pool: DocState, page_ids: torch.Tensor,
                   pre: DocState) -> DocState:
    """Scatter a retained pre-window view back over flagged documents'
    pages (page_ids is the flagged sub-plane), in place on `pool`: the
    paged overflow recovery's rollback half."""
    return scatter_pages(pool, page_ids, pre)


def rollback_pages_keep(pool: DocState, page_ids: torch.Tensor,
                        pre: DocState) -> DocState:
    """rollback_pages on a copy of the pool."""
    return scatter_pages(_copy_pool(pool), page_ids, pre)


def _compact_pages(pool, page_ids, counts, min_seqs, seqs):
    view = gather_pages(pool, page_ids, counts, min_seqs, seqs)
    g = compact_batched(view)
    return scatter_pages(pool, page_ids, g), page_ids, g.count


def compact_pages(pool: DocState, page_ids: torch.Tensor, counts, min_seqs,
                  seqs):
    """Page-granular zamboni for a group of documents: gather, left-pack
    compaction, scatter into `pool` in place. Returns (pool, page_ids,
    count); the caller releases the pages wholly past the new counts
    (PagedMergeStore.release_trailing)."""
    return _compact_pages(pool, page_ids, counts, min_seqs, seqs)


def compact_pages_keep(pool: DocState, page_ids: torch.Tensor, counts,
                       min_seqs, seqs):
    """compact_pages on a copy of the pool."""
    return _compact_pages(_copy_pool(pool), page_ids, counts, min_seqs,
                          seqs)


def compact_extract_paged(pool: DocState, page_ids: torch.Tensor, counts,
                          min_seqs, seqs):
    """Fused zamboni + snapshot extraction over gathered page views (the
    paged form of compact_extract_batched): gather, one left-pack that
    serves both the compacted rows and the packed snapshot rows, scatter
    into `pool` in place. Returns (pool, page_ids, count, packed), packed
    in the extract_visible_batched layout, so host.assemble_snapshot runs
    unchanged."""
    view = gather_pages(pool, page_ids, counts, min_seqs, seqs)
    g, packed = compact_extract_batched(view)
    return scatter_pages(pool, page_ids, g), page_ids, g.count, packed


def compact_extract_paged_keep(pool: DocState, page_ids: torch.Tensor,
                               counts, min_seqs, seqs):
    """compact_extract_paged on a copy of the pool."""
    return compact_extract_paged(_copy_pool(pool), page_ids, counts,
                                 min_seqs, seqs)


# ---------------------------------------------------------------------------
# batched summary extraction
# ---------------------------------------------------------------------------

def extract_visible_batched_plain(s: DocState) -> tuple:
    """Plain PyTorch version of extract_visible_batched: left-pack the
    snapshot-relevant segment rows of a [B, C] batch, everything not yet
    zambonied (removed at-or-before min_seq), i.e. visible text plus
    contended collab-window metadata, through compaction's own keep-mask +
    prefix-sum addressing (_pack_src), so the host reads exactly the live
    rows (reference snapshotV1.ts:33). Rows past each count repeat the
    last slot, as JAX's gather does."""
    src, n = _pack_src(s)
    src = src.long()

    def g(x):
        return x.gather(1, src)

    return (g(s.origin_op), g(s.origin_off), g(s.length),
            s.anno.gather(1, src[..., None].expand(-1, -1, s.anno_slots)),
            g(s.ins_seq), g(s.ins_client), g(s.rem_seq),
            g(s.rem_clients[..., 0]), n)


def compact_extract_batched_plain(s: DocState, stats: bool = False) -> tuple:
    """Plain PyTorch version of compact_extract_batched: compaction's
    left-pack is exactly what extraction keeps, so one pass gives both the
    compacted state and the packed rows; the columns are read from the
    compacted rows, so padding slots carry clean blanks, not stale data."""
    g = compact_batched_plain(s)
    out = (g, (g.origin_op, g.origin_off, g.length, g.anno, g.ins_seq,
               g.ins_client, g.rem_seq, g.rem_clients[..., 0].contiguous(),
               g.count))
    if stats:
        return out + (s.count.to(_I32, copy=True),)
    return out


def extract_visible_batched(state: DocState) -> tuple:
    """One pass over a [B, ...] batch -> packed per-document segment rows:
    (origin_op, origin_off, length, anno, ins_seq, ins_client, rem_seq,
    rem_client) each [B, C] (anno [B, C, A]; rows >= counts[b] are
    padding) + counts [B]. Only the first overlap client of a removed row
    is extracted. extract_visible_batched_plain for CPU tensors; for CUDA
    tensors one launch of zamboni.cu, or ValueError."""
    if _takes_plain(state.length):
        return extract_visible_batched_plain(state)
    return zamboni(state, "extract")[1]


def compact_extract_batched(state: DocState, stats: bool = False) -> tuple:
    """Fused zamboni + snapshot extraction over a [B, ...] batch: returns
    (compacted_state, packed), compacted_state equal to
    compact_batched(state) and packed in the extract_visible_batched
    layout. The input is left as it was. stats=True appends the
    pre-compaction per-document live-row counts (int32 [B]) as a third
    element, from which the host derives the rows zamboni reclaimed.
    compact_extract_batched_plain for CPU tensors; for CUDA tensors one
    launch of zamboni.cu, or ValueError."""
    if _takes_plain(state.length):
        return compact_extract_batched_plain(state, stats)
    comp, packed, pre = zamboni(state, "compact_extract", stats)
    return (comp, packed, pre) if stats else (comp, packed)


def _gather_rows(state: DocState, idx: torch.Tensor) -> DocState:
    idx = idx.long()
    return type(state)(*(x[idx] if x.dim() else x for x in state))


# The dirty-lane gather must not take a new input signature per distinct
# dirty count: gather_rows_pow2 pads the index vector to a power of two so
# the signatures stay bounded at log2(B). The probe counts them as
# kernel.extract_gather.* (telemetry/counters.JitRetraceProbe).
_gather_rows_probe = counters.JitRetraceProbe(_gather_rows,
                                              name="kernel.extract_gather")


def pad_pow2_indices(rows):
    """Host ints -> (int32 index vector zero-padded to the next power of
    two, real count). An empty list pads to one index."""
    idx = np.asarray(rows, np.int32).reshape(-1)
    n = idx.size
    n_pad = 1 << max(n - 1, 0).bit_length()
    idx_p = np.zeros(n_pad, np.int32)
    idx_p[:n] = idx
    return idx_p, n


def gather_rows_pow2(state: DocState, rows):
    """Gather batch rows `rows` (host ints) of a [B, ...] state into a
    power-of-two-padded sub-batch (padding repeats row 0; callers index
    only the first len(rows) rows). Returns (sub_state, n)."""
    idx_p, n = pad_pow2_indices(rows)
    idx = torch.from_numpy(idx_p).to(state.length.device)
    return _gather_rows_probe(state, idx), n


# Narrow-wire bound: deltas and values above it fall back to the exact
# int32 plane refetch for the documents that hold them (headroom under the
# int16 maximum, as serve_step's 32000 msn-delta cutoff).
_NARROW_MAX = 32000


def narrow_pack_plain(packed: tuple, mx: int) -> tuple:
    """Plain PyTorch version of narrow_pack: narrow delta packing of an extraction result, on its device: the
    bounded columns (length, origin_off, ins_client, rem_client, annotate
    id deltas) ride int16; the seq columns delta-encode against a
    per-document base (the least live value) with sentinel codes for
    pending (-1 in d_ins, -2 in d_rem) and no-remove (-1 in d_rem); a
    per-document ok bit flags a document whose values escape the narrow
    range (the host then refetches its exact int32 planes). origin_op stays
    int32: payload ids are unbounded. Returns (stacked16 [6, B, mx],
    anno16 [B, mx, A], op32 [B, mx], meta [4, B] = base_ins, base_rem,
    base_anno, ok)."""
    (origin_op, origin_off, length, anno, ins_seq, ins_client,
     rem_seq, rem_client, counts) = packed

    def sl(x):
        return x[:, :mx]

    length, origin_off = sl(length), sl(origin_off)
    ins_seq, ins_client = sl(ins_seq), sl(ins_client)
    rem_seq, rem_client = sl(rem_seq), sl(rem_client)
    op32 = sl(origin_op)
    anno_m = anno[:, :mx, :]
    j = torch.arange(mx, dtype=_I32, device=length.device)
    live = j[None, :] < counts[:, None]
    big = 1 << 30

    def base_of(vals, mask, dims):
        m = torch.where(mask, vals, big).amin(dim=dims)
        return torch.where(m == big, 0, m)

    ins_acked = live & (ins_seq != DEV_UNASSIGNED)
    base_ins = base_of(ins_seq, ins_acked, 1)
    d_ins = torch.where(ins_acked, ins_seq - base_ins[:, None], -1)

    rem_real = live & (rem_seq != DEV_NO_REMOVE) & \
        (rem_seq != DEV_UNASSIGNED)
    base_rem = base_of(rem_seq, rem_real, 1)
    d_rem = torch.where(rem_real, rem_seq - base_rem[:, None],
                        torch.where(live & (rem_seq == DEV_UNASSIGNED),
                                    -2, -1))

    anno_live = live[:, :, None] & (anno_m >= 0)
    base_anno = base_of(anno_m, anno_live, (1, 2))
    d_anno = torch.where(anno_live, anno_m - base_anno[:, None, None], -1)

    def in_range(x, m):
        masked = torch.where(m, x, 0).flatten(1)
        return ((masked >= -2) & (masked <= _NARROW_MAX)).all(dim=1)

    ok = (in_range(length, live) & in_range(origin_off, live)
          & in_range(ins_client, live) & in_range(rem_client, live)
          & in_range(d_ins, live) & in_range(d_rem, live)
          & in_range(d_anno, anno_live))

    def n16(x):
        return x.clamp(-(1 << 15), (1 << 15) - 1).to(torch.int16)

    stacked16 = torch.stack([
        n16(torch.where(live, length, 0)),
        n16(torch.where(live, origin_off, 0)),
        n16(torch.where(live, ins_client, -1)),
        n16(torch.where(live, rem_client, -1)),
        n16(d_ins), n16(d_rem)])
    meta = torch.stack([base_ins, base_rem, base_anno, ok.to(_I32)])
    return stacked16, n16(d_anno), op32, meta


def _check_narrow(packed: tuple, mx: int) -> None:
    """Raise ValueError unless narrow_pack.cu takes these packed rows at
    this width: the types, contiguity and shapes first, the CUDA device
    last."""
    if len(packed) != 9:
        raise ValueError(f"narrow_pack: {len(packed)} packed columns, not 9")
    if packed[0].dim() != 2 or packed[3].dim() != 3:
        raise ValueError("narrow_pack: the packed rows are not [B, C] "
                         "planes with a [B, C, A] anno")
    b, c = packed[0].shape
    if not 1 <= mx <= c:
        raise ValueError(f"narrow_pack: the width {mx} is outside 1..{c}")
    for i, x in enumerate(packed):
        shape = (b,) if i == 8 else \
            (b, c, packed[3].shape[2]) if i == 3 else (b, c)
        if x.dtype != _I32:
            raise ValueError(f"narrow_pack: column {i} is {x.dtype}, not "
                             "torch.int32")
        if tuple(x.shape) != shape:
            raise ValueError(f"narrow_pack: column {i} has shape "
                             f"{tuple(x.shape)}, not {shape}")
        if not x.is_contiguous():
            raise ValueError(f"narrow_pack: column {i} is not contiguous")
    for i, x in enumerate(packed):
        if not _on_card(x.device) or x.device != packed[0].device:
            raise ValueError(f"narrow_pack: column {i} is on {x.device}, "
                             "not the CUDA device of the packed rows")


def narrow_pack(packed: tuple, mx: int) -> tuple:
    """The narrow wire of an extraction result at width mx (the layout of
    narrow_pack_plain): the plain version for CPU tensors; for CUDA
    tensors one launch of kernels/csrc/narrow_pack.cu into new tensors,
    or ValueError for tensors it does not take. A batch of zero documents
    launches nothing. Counted in narrow_pack.launches."""
    if _takes_plain(packed[0]):
        return narrow_pack_plain(packed, mx)
    _check_narrow(packed, mx)
    b, c = packed[0].shape
    a = packed[3].shape[2]
    dev = packed[0].device
    # fluidlint: disable=DTYPE_DRIFT — the narrow wire's int16 outputs
    # (the host decodes them to int32; the ok bit guards the range)
    stacked16 = torch.empty((6, b, mx), dtype=torch.int16, device=dev)
    # fluidlint: disable=DTYPE_DRIFT — the narrow wire's int16 outputs
    anno16 = torch.empty((b, mx, a), dtype=torch.int16, device=dev)
    op32 = torch.empty((b, mx), dtype=_I32, device=dev)
    meta = torch.empty((4, b), dtype=_I32, device=dev)
    if b == 0:  # a grid of no blocks is an invalid launch
        return stacked16, anno16, op32, meta
    ptrs = [x.data_ptr() for x in (*packed, stacked16, anno16, op32, meta)]
    lib = build.library()
    narrow_pack.launches += 1
    note_launch("narrow_pack")
    with _on_device(dev):
        build.check(lib.fluid_narrow_pack(
            (ctypes.c_void_p * len(ptrs))(*ptrs), b, c, mx, a,
            ctypes.c_void_p(build.stream_handle())), "narrow_pack")
    return stacked16, anno16, op32, meta


def _exact_rows(packed: tuple, idx: torch.Tensor, mx: int) -> tuple:
    """Exact int32 planes of the (rare) documents whose values escape the
    narrow range: one stacked gather per refetch (idx pow2-padded by the
    caller)."""
    (origin_op, origin_off, length, anno, ins_seq, ins_client,
     rem_seq, rem_client, _counts) = packed
    idx = idx.long()

    def take(x):
        return x[idx, :mx]

    return (torch.stack([take(origin_op), take(origin_off), take(length),
                         take(ins_seq), take(ins_client), take(rem_seq),
                         take(rem_client)]), anno[idx, :mx, :])


def _d2h(t: torch.Tensor, fresh: bool = False) -> np.ndarray:
    """A host numpy array of t that never shares storage with the caller's
    tensors: the device-to-host copy for a CUDA tensor; for a CPU tensor
    (whose .numpy() shares its memory) a copy, unless t is a fresh result
    of this module."""
    if t.device.type != "cpu" or fresh:
        return t.cpu().numpy()
    return t.numpy().copy()


def fetch_extracted(packed: tuple, narrow: bool = True) -> tuple:
    """Host fetch of an extraction result, sliced to the batch's largest
    live row count before the transfer (rows past it are padding), the
    width bucketed up to a multiple of 32 and capped at the capacity;
    same-dtype 2-D columns ride one stacked copy.

    narrow=True (default) rides the bounded columns as int16 with the seq
    columns delta-encoded per document (narrow_pack) and decodes back to
    the exact int32 arrays on the host; documents whose values escape
    int16 refetch their exact planes (counted as summarize.wire_refetch).
    Either form gives the same live rows; only the bytes differ. The bytes
    copied accumulate in summarize.bytes_d2h. Returns numpy (origin_op,
    origin_off, length, anno, ins_seq, ins_client, rem_seq, rem_client,
    counts); no array shares memory with `packed`."""
    counts = _d2h(packed[-1])
    mx = max(int(counts.max()) if counts.size else 0, 1)
    capacity = packed[0].shape[1]
    mx = min(((mx + 31) // 32) * 32, capacity)
    nbytes = counts.nbytes

    if not narrow:
        cols = packed[:-1]
        # Same (ndim, dtype) 2-D planes stack into one [n, B, mx] copy;
        # anything else (the 3-D anno) goes alone.
        by_kind: dict = {}
        for i, x in enumerate(cols):
            key = (x.dim(), str(x.dtype)) if x.dim() == 2 else ("solo", i)
            by_kind.setdefault(key, []).append(i)
        fetched: dict = {}
        for key, idxs in by_kind.items():
            if key[0] == 2 and len(idxs) > 1:
                arr = _d2h(torch.stack([cols[i][:, :mx] for i in idxs]),
                           fresh=True)
                nbytes += arr.nbytes
                for j, i in enumerate(idxs):
                    fetched[i] = arr[j]
            else:
                for i in idxs:
                    fetched[i] = _d2h(cols[i][:, :mx])
                    nbytes += fetched[i].nbytes
        counters.increment("summarize.bytes_d2h", nbytes)
        return tuple(fetched[i] for i in range(len(cols))) + (counts,)

    stacked16, anno16, op32, meta = narrow_pack(packed, mx)
    s16 = _d2h(stacked16, fresh=True)
    a16 = _d2h(anno16, fresh=True)
    op32 = _d2h(op32)
    meta = _d2h(meta, fresh=True)
    nbytes += s16.nbytes + a16.nbytes + op32.nbytes + meta.nbytes
    base_ins, base_rem, base_anno, ok = meta

    length = s16[0].astype(np.int32)
    origin_off = s16[1].astype(np.int32)
    ins_client = s16[2].astype(np.int32)
    rem_client = s16[3].astype(np.int32)
    d_ins = s16[4].astype(np.int32)
    ins_seq = np.where(d_ins < 0, np.int32(DEV_UNASSIGNED),
                       base_ins[:, None] + d_ins).astype(np.int32)
    d_rem = s16[5].astype(np.int32)
    rem_seq = np.where(
        d_rem == -1, np.int32(DEV_NO_REMOVE),
        np.where(d_rem == -2, np.int32(DEV_UNASSIGNED),
                 base_rem[:, None] + d_rem)).astype(np.int32)
    d_anno = a16.astype(np.int32)
    anno = np.where(d_anno < 0, np.int32(-1),
                    base_anno[:, None, None] + d_anno).astype(np.int32)

    bad = np.nonzero(ok == 0)[0]
    if bad.size:
        # Exact-plane refetch for the overflowing documents only.
        counters.increment("summarize.wire_refetch", int(bad.size))
        idx_p, _ = pad_pow2_indices(bad)
        planes, anno_x = _exact_rows(
            packed, torch.from_numpy(idx_p).to(packed[0].device), mx)
        planes = _d2h(planes, fresh=True)
        anno_x = _d2h(anno_x, fresh=True)
        nbytes += planes.nbytes + anno_x.nbytes
        for k, d in enumerate(bad):
            op32[d], origin_off[d], length[d] = (
                planes[0, k], planes[1, k], planes[2, k])
            ins_seq[d], ins_client[d] = planes[3, k], planes[4, k]
            rem_seq[d], rem_client[d] = planes[5, k], planes[6, k]
            anno[d] = anno_x[k]
    counters.increment("summarize.bytes_d2h", nbytes)
    return (op32, origin_off, length, anno, ins_seq, ins_client,
            rem_seq, rem_client, counts)


def reset_zamboni_launches() -> None:
    """Zero the zamboni kernel's launch counts (in all, per mode, per path
    and per (mode, path, B, C)) and narrow_pack's."""
    zamboni.launches = 0
    zamboni.mode_launches = dict.fromkeys(ZAMBONI_MODES, 0)
    zamboni.path_launches = dict.fromkeys(ZAMBONI_PATHS, 0)
    zamboni.shape_launches = {}
    narrow_pack.launches = 0


reset_zamboni_launches()
