"""The fused apply: the whole op stream applied to each document's segment
table in one pass.

Counterpart of fluidframework_tpu's mergetree/pallas_apply.py.
`apply_ops_fused` launches the CUDA kernel (kernels/csrc/fused_apply.cu)
for CUDA tensors, each document's table resident in shared memory for all
T ops, on one of two paths that `launch_geometry` chooses from the shape:
one warp per document or one block per document. `apply_ops_fused_plain` is the plain PyTorch version,
a transcription of `_apply_one_batched` and its phases over [B, C] planes
stepping over T; the wrapper uses it only for CPU tensors. Neither mutates
its input.

Both take the two variants of the TPU kernel: `runs=` (RunCols [B, T,
RUN_K]: INSERT_RUN steps land up to RUN_K rows at one tie-break slot) and
`extract=True` (also return the narrow tuple (overflow int16, count,
min_seq, seq) that the serving megakernel reads).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels import build
from .constants import DEV_NO_REMOVE, DEV_UNASSIGNED
from .oppack import RUN_K, OpKind, PackedOps, RunCols
from .state import DocState

# Shared memory a block may use on Hopper (227 KB), and the block path's
# layout: (8 + K + A) state planes plus the cum/vis planes per slot, and a
# fixed 128-int scratch for reductions (fused_apply.cu block_smem_bytes).
SMEM_LIMIT_BYTES = 232_448
_SMEM_SCRATCH_BYTES = 128 * 4
_MAX_OVERLAP_SLOTS = 8
_MAX_PLANES = 32
_MAX_BLOCK_THREADS = 1024
# The warp path (fused_apply.cu kMaxRows, kMaxDocsPerBlock): C <= 16 rows
# of 32 slots, at most 8 documents (warps) per block.
WARP_MAX_CAPACITY = 512
MAX_DOCS_PER_BLOCK = 8
# The warp path is taken when the launch has at least 512 documents, about
# four per SM. With fewer, one warp per document leaves the SMs short of
# warps to hide each op's latency, and C threads per document finish
# sooner: on the H100 the block path is faster at the serving ring's
# 128 x C=512 group (calibrate_fused_apply.py, PERF.md §6).
WARP_MIN_DOCS = 512
# Documents per block on the warp path. On the H100 one per block is within
# 3% of the fastest of 1, 2, 4 and 8 at every main-path shape, and the
# fastest at C = 512 (calibrate_fused_apply.py, PERF.md §6).
WARP_DOCS_PER_BLOCK = 1
_PATHS = {"block": 0, "warp": 1}  # fused_apply.cu enum Path

_SEG_PLANES = ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
               "rem_local_seq", "origin_op", "origin_off")


def max_fused_capacity(k_slots: int, a_slots: int) -> int:
    """Largest capacity whose table fits one block's shared memory on
    Hopper, for K overlap slots and A annotate slots."""
    if not 1 <= k_slots <= _MAX_OVERLAP_SLOTS or a_slots < 1 \
            or 8 + k_slots + a_slots > _MAX_PLANES:
        raise ValueError(
            f"the fused apply kernel takes 1 <= K <= {_MAX_OVERLAP_SLOTS}, "
            f"A >= 1 and 8 + K + A <= {_MAX_PLANES} planes "
            f"(got K={k_slots}, A={a_slots})")
    per_slot = (8 + k_slots + a_slots + 2) * 4
    return (SMEM_LIMIT_BYTES - _SMEM_SCRATCH_BYTES) // per_slot


class Geometry(NamedTuple):
    """How one fused-apply launch is laid out on the card."""
    path: str            # "warp" (one warp per document) or "block"
    docs_per_block: int
    threads: int         # per block
    smem_bytes: int      # dynamic shared memory per block


def _block_geometry(capacity: int, k_slots: int, a_slots: int) -> Geometry:
    threads = min(-(-capacity // 32) * 32, _MAX_BLOCK_THREADS)
    smem = (8 + k_slots + a_slots + 2) * capacity * 4 + _SMEM_SCRATCH_BYTES
    return Geometry("block", 1, threads, smem)


def _warp_geometry(capacity: int, k_slots: int, a_slots: int,
                   docs_per_block: int = WARP_DOCS_PER_BLOCK) -> Geometry:
    if capacity > WARP_MAX_CAPACITY:
        raise ValueError(f"the warp path takes C <= {WARP_MAX_CAPACITY} "
                         f"(got C={capacity})")
    doc = (8 + k_slots + a_slots) * -(-capacity // 32) * 32 * 4
    docs = min(docs_per_block, SMEM_LIMIT_BYTES // doc)
    return Geometry("warp", docs, 32 * docs, docs * doc)


def launch_geometry(batch: int, capacity: int, k_slots: int,
                    a_slots: int) -> Geometry:
    """The path, documents per block, threads and shared memory of a
    fused-apply launch over B documents of capacity C: one fixed rule,
    measured on the H100 (PERF.md §6): the warp path for C <= 512 at
    B >= WARP_MIN_DOCS; else the block path, which takes every C up to
    max_fused_capacity."""
    limit = max_fused_capacity(k_slots, a_slots)
    if not 1 <= capacity <= limit:
        raise ValueError(f"capacity {capacity} is outside the fused apply's "
                         f"range 1..{limit} (K={k_slots}, A={a_slots})")
    if capacity <= WARP_MAX_CAPACITY and batch >= WARP_MIN_DOCS:
        return _warp_geometry(capacity, k_slots, a_slots)
    return _block_geometry(capacity, k_slots, a_slots)


def _forced_geometry(path: str, capacity: int, k_slots: int,
                     a_slots: int) -> Geometry:
    """The geometry of `path` ("warp" or "block") whatever the rule says,
    so that a conformance run can hold both paths against the plain
    version (with _launch)."""
    if path == "warp":
        return _warp_geometry(capacity, k_slots, a_slots)
    if path == "block":
        return _block_geometry(capacity, k_slots, a_slots)
    raise ValueError(f"unknown fused apply path {path!r}")


# ---------------------------------------------------------------------------
# the plain version: _apply_one_batched over [B, C] planes
# ---------------------------------------------------------------------------

def _lanes(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], device=x.device, dtype=torch.int32)


def _any_lane(m):
    return m.any(dim=1, keepdim=True)


def _first_true(m):
    return torch.where(m, _lanes(m), m.shape[-1]).amin(dim=1, keepdim=True)


def _masked_scalar(v, m):
    return torch.where(m, v, 0).sum(dim=1, keepdim=True, dtype=torch.int32)


def _cumsum_excl(x):
    return torch.cumsum(x, dim=1, dtype=torch.int32) - x


def _visibility(st, ref, client, k_slots):
    lane = _lanes(st["length"])
    valid = lane < st["count"]
    inserted = (st["ins_seq"] <= ref) | (st["ins_client"] == client)
    removed = st["rem_seq"] <= ref
    for i in range(k_slots):
        removed = removed | (st[f"rc{i}"] == client)
    vis = valid & inserted & ~removed
    vlen = torch.where(vis, st["length"], 0)
    return vis, vlen, _cumsum_excl(vlen)


def _plane_names(k_slots, a_slots):
    return _SEG_PLANES + tuple(f"rc{i}" for i in range(k_slots)) + \
        tuple(f"an{i}" for i in range(a_slots))


def _shift_right(st, shift_mask, k_slots, a_slots, by: int = 1):
    out = dict(st)
    for name in _plane_names(k_slots, a_slots):
        out[name] = torch.where(shift_mask, torch.roll(st[name], by, dims=1),
                                st[name])
    return out


def _ensure_boundary(st, pos, ref, client, enabled, k_slots, a_slots):
    vis, vlen, cum = _visibility(st, ref, client, k_slots)
    inside = vis & (cum < pos) & (pos < cum + vlen)
    do = enabled & _any_lane(inside)
    slot = _first_true(inside)
    off = pos - _masked_scalar(cum, inside)
    parent_len = _masked_scalar(st["length"], inside)
    lane = _lanes(st["length"])
    g = _shift_right(st, (lane >= slot + 1) & do, k_slots, a_slots)
    g["count"] = st["count"] + do.to(torch.int32)
    is_left = do & (lane == slot)
    is_right = do & (lane == slot + 1)
    g["length"] = torch.where(is_left, off,
                              torch.where(is_right, parent_len - off,
                                          g["length"]))
    g["origin_off"] = torch.where(is_right, g["origin_off"] + off,
                                  g["origin_off"])
    return g


def _insert_phase(st, op, enabled, view, k_slots, a_slots):
    vis, _vlen, cum = view
    lane = _lanes(st["length"])
    is_local = op["seq"] == DEV_UNASSIGNED
    in_run = cum == op["pos1"]
    tomb = st["rem_seq"] <= op["ref_seq"]
    acked_ins = st["ins_seq"] != DEV_UNASSIGNED
    stop = in_run & (vis | (~tomb & (is_local | acked_ins))
                     | (lane >= st["count"]))
    found = _any_lane(stop)
    bad = enabled & ~found
    enabled = enabled & found
    slot = _first_true(stop)
    g = _shift_right(st, (lane >= slot) & enabled, k_slots, a_slots)
    g["count"] = st["count"] + enabled.to(torch.int32)
    here = enabled & (lane == slot)
    g["length"] = torch.where(here, op["new_len"], g["length"])
    g["ins_seq"] = torch.where(here, op["seq"], g["ins_seq"])
    g["ins_client"] = torch.where(here, op["client"], g["ins_client"])
    g["local_seq"] = torch.where(
        here, torch.where(is_local, op["local_seq"], 0), g["local_seq"])
    g["rem_seq"] = torch.where(here, DEV_NO_REMOVE, g["rem_seq"])
    g["rem_local_seq"] = torch.where(here, 0, g["rem_local_seq"])
    g["origin_op"] = torch.where(here, op["op_id"], g["origin_op"])
    g["origin_off"] = torch.where(here, 0, g["origin_off"])
    for i in range(k_slots):
        g[f"rc{i}"] = torch.where(here, -1, g[f"rc{i}"])
    for i in range(a_slots):
        g[f"an{i}"] = torch.where(here, -1, g[f"an{i}"])
    g["overflow"] = g["overflow"] | bad
    return g


def _insert_run_phase(st, op, enabled, view, k_slots, a_slots):
    """Up to RUN_K packed cursor-advance inserts land as contiguous rows at
    one tie-break slot: one shift by RUN_K and RUN_K masked fills; padding
    rows (length 0) are born dead."""
    vis, _vlen, cum = view
    lane = _lanes(st["length"])
    in_run = cum == op["pos1"]
    tomb = st["rem_seq"] <= op["ref_seq"]
    acked_ins = st["ins_seq"] != DEV_UNASSIGNED
    stop = in_run & (vis | (~tomb & acked_ins) | (lane >= st["count"]))
    found = _any_lane(stop)
    bad = enabled & ~found
    enabled = enabled & found
    slot = _first_true(stop)
    g = _shift_right(st, (lane >= slot) & enabled, k_slots, a_slots,
                     by=RUN_K)
    g["count"] = st["count"] + enabled.to(torch.int32) * RUN_K
    rel = lane - slot
    here = enabled & (rel >= 0) & (rel < RUN_K)

    def pick(prefix, pad):
        out = torch.full_like(st["length"], pad)
        for k_i in range(RUN_K):
            out = torch.where(rel == k_i, op[f"{prefix}{k_i}"], out)
        return out

    row_len = pick("rl", 0)
    row_seq = pick("rs", 0)
    row_id = pick("ri", -1)
    live = here & (row_len > 0)
    dead = here & (row_len == 0)
    g["length"] = torch.where(here, row_len, g["length"])
    g["ins_seq"] = torch.where(live, row_seq,
                               torch.where(dead, 0, g["ins_seq"]))
    g["ins_client"] = torch.where(live, op["client"],
                                  torch.where(dead, -1, g["ins_client"]))
    g["local_seq"] = torch.where(here, 0, g["local_seq"])
    g["rem_seq"] = torch.where(live, DEV_NO_REMOVE,
                               torch.where(dead, 0, g["rem_seq"]))
    g["rem_local_seq"] = torch.where(here, 0, g["rem_local_seq"])
    g["origin_op"] = torch.where(here, row_id, g["origin_op"])
    g["origin_off"] = torch.where(here, 0, g["origin_off"])
    for i in range(k_slots):
        g[f"rc{i}"] = torch.where(here, -1, g[f"rc{i}"])
    for i in range(a_slots):
        g[f"an{i}"] = torch.where(here, -1, g[f"an{i}"])
    g["overflow"] = g["overflow"] | bad
    return g


def _range_targets(op, view):
    vis, vlen, cum = view
    return vis & (vlen > 0) & (cum >= op["pos1"]) & \
        (cum + vlen <= op["pos2"])


def _append_overlap(st, need, client, k_slots):
    """Place client into the first free overlap slot (>= 1) where need."""
    taken_before = torch.zeros_like(need)
    placed = dict(st)
    for i in range(1, k_slots):
        free_i = st[f"rc{i}"] == -1
        first_free = free_i & ~taken_before
        placed[f"rc{i}"] = torch.where(need & first_free, client,
                                       st[f"rc{i}"])
        taken_before = taken_before | free_i
    return placed


def _remove_phase(st, op, enabled, view, k_slots):
    target = _range_targets(op, view) & enabled
    is_local = op["seq"] == DEV_UNASSIGNED
    fresh = target & (st["rem_seq"] == DEV_NO_REMOVE)
    pend_overwrite = target & (st["rem_seq"] == DEV_UNASSIGNED) & ~is_local
    already = target & (st["rem_seq"] != DEV_NO_REMOVE) & ~pend_overwrite

    g = dict(st)
    g["rem_seq"] = torch.where(
        fresh, torch.where(is_local, DEV_UNASSIGNED, op["seq"]),
        torch.where(pend_overwrite, op["seq"], st["rem_seq"]))
    g["rem_local_seq"] = torch.where(
        fresh & is_local, op["local_seq"],
        torch.where(pend_overwrite, 0, st["rem_local_seq"]))
    prior = st["rc0"]
    g["rc0"] = torch.where(fresh | pend_overwrite, op["client"], st["rc0"])
    displaced = pend_overwrite & (prior != op["client"])
    g2 = _append_overlap(g, displaced, prior, k_slots)
    has_client = torch.zeros_like(already)
    for i in range(k_slots):
        has_client = has_client | (g2[f"rc{i}"] == op["client"])
    need = already & ~has_client
    g3 = _append_overlap(g2, need, op["client"], k_slots)
    want = torch.where(displaced, prior, op["client"])
    landed = torch.zeros_like(already)
    for i in range(k_slots):
        landed = landed | (g3[f"rc{i}"] == want)
    over = _any_lane((displaced | need) & ~landed)
    g3["overflow"] = st["overflow"] | over
    return g3


def _annotate_phase(st, op, enabled, view, a_slots):
    target = _range_targets(op, view) & enabled
    g = dict(st)
    over = _any_lane(target & (st[f"an{a_slots - 1}"] != -1))
    for i in range(a_slots - 1, 0, -1):
        g[f"an{i}"] = torch.where(target, st[f"an{i - 1}"], st[f"an{i}"])
    g["an0"] = torch.where(target, op["op_id"], st["an0"])
    g["overflow"] = st["overflow"] | over
    return g


def _ack_phase(st, op):
    kind = op["kind"]
    ins_hit = (kind == OpKind.ACK_INSERT) & \
        (st["ins_seq"] == DEV_UNASSIGNED) & \
        (st["local_seq"] == op["local_seq"])
    rem_hit = (kind == OpKind.ACK_REMOVE) & \
        (st["rem_seq"] == DEV_UNASSIGNED) & \
        (st["rem_local_seq"] == op["local_seq"])
    g = dict(st)
    g["ins_seq"] = torch.where(ins_hit, op["seq"], st["ins_seq"])
    g["local_seq"] = torch.where(ins_hit, 0, st["local_seq"])
    g["rem_seq"] = torch.where(rem_hit, op["seq"], st["rem_seq"])
    g["rem_local_seq"] = torch.where(rem_hit, 0, st["rem_local_seq"])
    return g


def _apply_one_batched(st, op, k_slots, a_slots, with_runs=False):
    """One op per document; op fields are [B, 1]."""
    kind = op["kind"]
    is_run = (kind == OpKind.INSERT_RUN) if with_runs else False
    is_edit = (kind == OpKind.INSERT) | (kind == OpKind.REMOVE) | \
        (kind == OpKind.ANNOTATE) | is_run
    is_range = (kind == OpKind.REMOVE) | (kind == OpKind.ANNOTATE)
    need = torch.where(is_run, RUN_K + 1, 2) if with_runs else 2
    fits = st["count"] + need <= st["length"].shape[-1]
    st = dict(st)
    st["overflow"] = st["overflow"] | (is_edit & ~fits)
    is_edit = is_edit & fits
    is_range = is_range & fits
    is_run = is_run & fits

    r, cl = op["ref_seq"], op["client"]
    s1 = _ensure_boundary(st, op["pos1"], r, cl, is_edit, k_slots, a_slots)
    s2 = _ensure_boundary(s1, op["pos2"], r, cl, is_range, k_slots, a_slots)
    view2 = _visibility(s2, r, cl, k_slots)
    s_ins = _insert_phase(s2, op, is_edit & (kind == OpKind.INSERT), view2,
                          k_slots, a_slots)
    if with_runs:
        s_ins = _insert_run_phase(s_ins, op, is_run, view2, k_slots, a_slots)
    s_rem = _remove_phase(s_ins, op, is_range & (kind == OpKind.REMOVE),
                          view2, k_slots)
    s_ann = _annotate_phase(s_rem, op, is_range & (kind == OpKind.ANNOTATE),
                            view2, a_slots)
    out = _ack_phase(s_ann, op)

    acked = (kind != OpKind.NOOP) & (op["seq"] != DEV_UNASSIGNED)
    out["seq"] = torch.where(acked, torch.maximum(out["seq"], op["seq"]),
                             out["seq"])
    out["min_seq"] = torch.where(acked,
                                 torch.maximum(out["min_seq"], op["msn"]),
                                 out["min_seq"])
    return out


def op_cols(ops: PackedOps, runs: Optional[RunCols]):
    """Flatten PackedOps (+ optional RunCols) into named [B, T] columns:
    the INSERT_RUN member columns ride as rl*/rs*/ri* per-step op
    scalars."""
    fields = list(PackedOps._fields)
    cols = dict(zip(PackedOps._fields, ops))
    if runs is not None:
        for prefix, arr in (("rl", runs.length), ("rs", runs.seq),
                            ("ri", runs.op_id)):
            for i in range(RUN_K):
                fields.append(f"{prefix}{i}")
                cols[f"{prefix}{i}"] = arr[..., i]
    return fields, cols


def _to_planes(state: DocState) -> Dict[str, torch.Tensor]:
    st = {name: getattr(state, name) for name in _SEG_PLANES}
    for i in range(state.overlap_slots):
        st[f"rc{i}"] = state.rem_clients[..., i]
    for i in range(state.anno_slots):
        st[f"an{i}"] = state.anno[..., i]
    for name in ("count", "min_seq", "seq", "overflow"):
        st[name] = getattr(state, name)[:, None]
    return st


def _from_planes(st, k_slots, a_slots) -> DocState:
    return DocState(
        **{name: st[name].contiguous() for name in _SEG_PLANES},
        rem_clients=torch.stack([st[f"rc{i}"] for i in range(k_slots)], -1),
        anno=torch.stack([st[f"an{i}"] for i in range(a_slots)], -1),
        count=st["count"][:, 0].contiguous(),
        min_seq=st["min_seq"][:, 0].contiguous(),
        seq=st["seq"][:, 0].contiguous(),
        overflow=st["overflow"][:, 0].contiguous(),
    )


Narrow = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def narrow_of(state: DocState) -> Narrow:
    """The narrow tuple the extract variant writes: (overflow int16,
    count, min_seq, seq), each [B]."""
    return (state.overflow.to(torch.int16), state.count.clone(),
            state.min_seq.clone(), state.seq.clone())


def apply_ops_fused_plain(state: DocState, ops: PackedOps,
                          runs: Optional[RunCols] = None,
                          extract: bool = False):
    """Plain PyTorch version: apply [B, T] op streams to B documents.
    Returns the new DocState, or (DocState, narrow) with extract=True."""
    k, a = state.overlap_slots, state.anno_slots
    st = _to_planes(state)
    fields, cols = op_cols(ops, runs)
    for t in range(ops.steps):
        op = {f: cols[f][:, t:t + 1] for f in fields}
        st = _apply_one_batched(st, op, k, a, with_runs=runs is not None)
    out = _from_planes(st, k, a)
    return (out, narrow_of(out)) if extract else out


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def _check_launchable(state: DocState, ops: PackedOps,
                      runs: Optional[RunCols]) -> None:
    b = state.length.shape[0]
    for name, t in zip(DocState._fields, state):
        want = torch.bool if name == "overflow" else torch.int32
        if t.device.type != "cuda" or t.dtype != want \
                or not t.is_contiguous() or t.shape[0] != b:
            raise ValueError(f"apply_ops_fused: state.{name} must be a "
                             f"contiguous {want} CUDA tensor with {b} rows")
    for name, t in zip(PackedOps._fields, ops):
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.dim() != 2 \
                or t.shape != (b, ops.steps):
            raise ValueError(f"apply_ops_fused: ops.{name} must be a "
                             f"contiguous int32 CUDA [{b}, T] tensor")
    for name, t in zip(RunCols._fields, runs or ()):
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous() \
                or t.shape != (b, ops.steps, RUN_K):
            raise ValueError(f"apply_ops_fused: runs.{name} must be a "
                             f"contiguous int32 CUDA [{b}, T, {RUN_K}] "
                             "tensor")


def variant_name(runs: Optional[RunCols], extract: bool) -> str:
    """Launch-count key of a kernel variant: "plain", "runs", "extract"
    or "runs_extract"."""
    return "_".join(n for n, on in (("runs", runs is not None),
                                    ("extract", extract)) if on) or "plain"


def apply_ops_fused(state: DocState, ops: PackedOps,
                    runs: Optional[RunCols] = None, extract: bool = False):
    """Apply [B, T] op streams to B documents; returns a new DocState, or
    (DocState, narrow) with extract=True (narrow_of).

    For CUDA tensors this launches the CUDA kernel on the path
    launch_geometry chooses, and a capacity above max_fused_capacity
    raises ValueError; for CPU tensors it runs the plain version under the
    same capacity limit."""
    k, a = state.overlap_slots, state.anno_slots
    limit = max_fused_capacity(k, a)
    if state.capacity > limit:
        raise ValueError(
            f"capacity {state.capacity} exceeds the fused apply's "
            f"shared-memory limit max_fused_capacity={limit} "
            f"(K={k}, A={a})")
    if state.length.device.type == "cpu":
        return apply_ops_fused_plain(state, ops, runs, extract)
    b, c = state.length.shape
    return _launch(state, ops, runs, extract, launch_geometry(b, c, k, a))


def _launch(state: DocState, ops: PackedOps, runs: Optional[RunCols],
            extract: bool, geo: Geometry):
    """One kernel launch over CUDA tensors with the geometry `geo`, which
    the kernel refuses unless it matches its own formulas; counted as
    apply_ops_fused's launches."""
    _check_launchable(state, ops, runs)
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    dev = state.length.device
    out = DocState(*(torch.empty_like(t) for t in state))
    narrow = (torch.empty(b, dtype=torch.int16, device=dev),
              *(torch.empty(b, dtype=torch.int32, device=dev)
                for _ in range(3))) if extract else ()
    ptrs = [t.data_ptr() for t in state] + [t.data_ptr() for t in out] + \
        [t.data_ptr() for t in ops] + [t.data_ptr() for t in runs or ()] + \
        [t.data_ptr() for t in narrow]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib = build.library()
    apply_ops_fused.launches += 1
    apply_ops_fused.variant_launches[variant_name(runs, extract)] += 1
    apply_ops_fused.path_launches[geo.path] += 1
    build.check(lib.fluid_fused_apply(
        arr, b, c, k, a, ops.steps, int(runs is not None), int(extract),
        _PATHS[geo.path], geo.docs_per_block, geo.threads, geo.smem_bytes,
        ctypes.c_void_p(build.stream_handle())), "apply_ops_fused")
    return (out, narrow) if extract else out


def reset_launches() -> None:
    """Zero the wrapper's launch counts (total, per variant, per path)."""
    apply_ops_fused.launches = 0
    apply_ops_fused.variant_launches = dict.fromkeys(
        ("plain", "runs", "extract", "runs_extract"), 0)
    apply_ops_fused.path_launches = dict.fromkeys(_PATHS, 0)


reset_launches()
