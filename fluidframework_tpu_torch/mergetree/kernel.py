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

Compaction (`compact`, `compact_batched`), `apply_if_any`, `visible_mask`
and `doc_length` are gathers, prefix sums and reductions with no op loop:
plain PyTorch on both devices. `gather_pages` / `scatter_pages` move
documents in and out of a page pool (mergetree/paging.py). Not ported
yet: the paged apply and compaction (kernel.py:540-690 beyond gather and
scatter), extraction and the narrow wire (:697-1002), and the sequence-
parallel `sp_shards` formulation.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..kernels import build
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


def visibility(s: DocState, ref_seq, client):
    """(vis, vlen, cum): visibility mask, visible lengths and the
    exclusive prefix sum of [B, C] states at perspective (ref_seq, client),
    each [B, 1] (kernel.py visibility; mergeTree.ts:1586 nodeLength)."""
    valid = _lanes(s) < s.count[:, None]
    inserted = (s.ins_seq <= ref_seq) | (s.ins_client == client)
    removed = (s.rem_seq <= ref_seq) | \
        (s.rem_clients == client[..., None]).any(dim=-1)
    vis = valid & inserted & ~removed
    vlen = torch.where(vis, s.length, 0)
    cum = torch.cumsum(vlen, dim=1, dtype=_I32) - vlen
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


def _ensure_boundary(s: DocState, pos, ref_seq, client, enabled) -> DocState:
    """Split the segment containing `pos` (if any) so `pos` falls on a
    segment boundary (reference ensureIntervalBoundary, mergeTree.ts:2240)."""
    if _off(enabled):
        return s
    vis, vlen, cum = visibility(s, ref_seq, client)
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


def apply_one(s: DocState, op, run=None) -> DocState:
    """Apply one op per document: `op` maps each PackedOps field to its
    [B, 1] column at this step, `run` (INSERT_RUN streams only) each
    RunCols field to its [B, RUN_K] row."""
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
    s1 = _ensure_boundary(s, op["pos1"], r, cl, is_edit)
    s2 = _ensure_boundary(s1, op["pos2"], r, cl, is_range)
    # One visibility pass on s2 serves the insert and range phases (each
    # leaves the others' state unchanged where it is consumed).
    view2 = visibility(s2, r, cl)
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
                        runs: Optional[RunCols]) -> DocState:
    s = state
    for t in range(ops.steps):
        op = {f: col[:, t:t + 1] for f, col in zip(PackedOps._fields, ops)}
        run = None if runs is None else {
            f: col[:, t] for f, col in zip(RunCols._fields, runs)}
        s = apply_one(s, op, run)
    # A skipped phase hands its input back: copy what no op replaced.
    return DocState(*(o.clone() if o is i else o.contiguous()
                      for o, i in zip(s, state)))


def scan_ops_plain(state: DocState, ops: PackedOps, batched: bool,
                   runs: Optional[RunCols] = None) -> DocState:
    """The plain PyTorch scan apply on any device: the reference that
    scan_apply.cu is held to. [C] / [T] (batched=False) or [B, C] /
    [B, T]; runs: RunCols [T, RUN_K] / [B, T, RUN_K] or None."""
    if batched:
        return _scan_batched_plain(state, ops, runs)
    return _drop(_scan_batched_plain(_lift(state), _lift(ops), _lift(runs)))


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
# kept to be measured against; the rule never takes it.
_SCAN_PATHS = {"global_chunked": 0, "global": 1, "smem": 2, "cluster": 3}
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
# - else the global path.
# Threads: C (or a rank's slots) rounded up to 32, at most LIVE_THREADS;
# at B >= MANY_DOCS (several blocks per SM), 128 on the smem path and 256
# on the global path up to C = MANY_DOCS_GLOBAL_C.
CLUSTER_BLOCKS = 8
CLUSTER_MIN_CAPACITY = 8192
CLUSTER_MAX_DOCS = 16
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
               runs: Optional[RunCols] = None) -> DocState:
    """One launch of kernels/csrc/scan_apply.cu on the path scan_geometry
    names: [B, T] op streams (and [B, T, RUN_K] runs) applied to B
    documents of any capacity, into a new state; the input is left as it
    was. CUDA tensors only: a shape or device the kernel does not take, a
    build error or a launch error (a cluster that cannot be scheduled
    too) raises. Counted in scan_apply.launches (per variant and per
    kernel)."""
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
              runs: Optional[RunCols] = None) -> DocState:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if state.length.device.type == "cpu":
        return scan_ops_plain(state, ops, batched, runs)
    if batched:
        return scan_apply(state, ops, runs)
    return _drop(scan_apply(_lift(state), _lift(ops), _lift(runs)))


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
# zamboni: compaction
# ---------------------------------------------------------------------------

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


def _compact_batched(s: DocState) -> DocState:
    """Free segments removed at-or-before min_seq (reference zamboni,
    mergeTree.ts:1422): stable-partition the live segments to the front
    and reset the rows past them to make_state's padding."""
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


def compact(state: DocState) -> DocState:
    """Zamboni compaction of one document."""
    return _drop(_compact_batched(_lift(state)))


def compact_batched(state: DocState) -> DocState:
    """Zamboni compaction of a [B, C] batch."""
    return _compact_batched(state)


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
    gidx = torch.clamp(page_ids, min=0).to(torch.int64)
    b, p = page_ids.shape
    r = pool.capacity

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
    dst = torch.where(page_ids >= 0, page_ids,
                      BLANK_PAGE).to(torch.int64).reshape(-1)
    for name in _ROW_FIELDS:
        col = getattr(pool, name)
        blank = col[BLANK_PAGE].clone()
        v = getattr(view, name)
        col[dst] = v.reshape((b * p, r) + tuple(v.shape[2:]))
        col[BLANK_PAGE] = blank
    return pool
