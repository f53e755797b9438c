"""Batched LWW lanes: map/cell/counter ops across thousands of channels.

Counterpart of fluidframework_tpu's server/lww_kernel.py (SharedMap
set/delete/clear, SharedCell, SharedCounter increment). Each channel lane
holds a fixed-capacity key-slot table (interned key id, payload ref, writer
seq) and an additive counter. The JAX version is a `lax.scan` over T with
`vmap` over lanes, which XLA compiles into the serving window's program.
Here `apply_lww_batched` launches one hand-written CUDA kernel
(kernels/csrc/lww_scan.cu: one warp per lane, the whole T loop inside)
for CUDA tensors and runs `apply_lww_batched_plain`, a Python loop over T
whose every step is vectorized over the [B, C] tables, for CPU tensors.
`apply_lww_window` is the serving window's LWW bucket (each op's seq
gathered from the ticket plane, the admission, the apply and the
occupancy count): one launch of the same kernel in its admit mode.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..core.device import resolve_device
from ..kernels import build
from ..parallel.mesh import note_launch


class LwwKind:
    NOOP = 0
    SET = 1     # key slot <- val ref (insert or overwrite)
    DELETE = 2  # free the key's slot
    CLEAR = 3   # free every slot
    ADD = 4     # counter += delta


class LwwState(NamedTuple):
    """[B, C] slot tables + per-lane scalars."""

    key: torch.Tensor       # interned key id; -1 = free slot
    val: torch.Tensor       # payload ref of the latest write
    seq: torch.Tensor       # sequence number of the latest write
    counter: torch.Tensor   # [B] additive accumulator
    last_seq: torch.Tensor  # [B] high-water mark of applied ops
    overflow: torch.Tensor  # [B] bool: a SET found no free slot


class LwwOps(NamedTuple):
    """[B, T] int32 op columns (NOOP-padded)."""

    kind: torch.Tensor
    key: torch.Tensor
    val: torch.Tensor
    delta: torch.Tensor
    seq: torch.Tensor


def make_lww_state(capacity: int, batch: int,
                   device: str | torch.device | None = None) -> LwwState:
    """Fresh [batch, capacity] tables; device defaults to "cuda" and
    raises when CUDA is absent."""
    dev = resolve_device(device)

    def full(value, *dims):
        return torch.full((batch, *dims), value, dtype=torch.int32,
                          device=dev)

    return LwwState(key=full(-1, capacity), val=full(-1, capacity),
                    seq=full(0, capacity), counter=full(0),
                    last_seq=full(0),
                    overflow=torch.zeros(batch, dtype=torch.bool,
                                         device=dev))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none (the
    `jnp.argmax` rule), as int32 [B]."""
    c = mask.shape[-1]
    lanes = torch.arange(c, device=mask.device, dtype=torch.int32)
    first = torch.where(mask, lanes, c).amin(dim=-1)
    return torch.where(first == c, 0, first)


def _apply_one(s: LwwState, kind, key, val, delta, seq) -> LwwState:
    """One op per lane; op fields are [B]."""
    c = s.key.shape[-1]
    idx = torch.arange(c, device=s.key.device, dtype=torch.int32)
    is_set = kind == LwwKind.SET
    is_del = kind == LwwKind.DELETE
    is_clear = kind == LwwKind.CLEAR
    is_add = kind == LwwKind.ADD
    is_op = is_set | is_del | is_clear | is_add

    match = s.key == key[:, None]
    have = match.any(dim=1)
    free = s.key == -1
    any_free = free.any(dim=1)
    # SET: the existing slot wins; else the first free slot.
    target = torch.where(have, _first_true(match), _first_true(free))
    can_set = is_set & (have | any_free)
    at = (idx == target[:, None]) & can_set[:, None]
    new_key = torch.where(at, key[:, None], s.key)
    new_val = torch.where(at, val[:, None], s.val)
    new_seq = torch.where(at, seq[:, None], s.seq)
    # DELETE frees the matching slot; CLEAR frees everything.
    gone = is_del[:, None] & match
    new_key = torch.where(gone, -1, new_key)
    new_val = torch.where(gone, -1, new_val)
    new_key = torch.where(is_clear[:, None], -1, new_key)
    new_val = torch.where(is_clear[:, None], -1, new_val)
    return LwwState(
        key=new_key, val=new_val, seq=new_seq,
        counter=s.counter + torch.where(is_add, delta, 0),
        last_seq=torch.where(is_op, torch.maximum(s.last_seq, seq),
                             s.last_seq),
        overflow=s.overflow | (is_set & ~have & ~any_free),
    )


def apply_lww_batched_plain(state: LwwState, ops: LwwOps) -> LwwState:
    """Plain PyTorch version: apply [B, T] op streams, stepping over T on
    any device."""
    for t in range(ops.kind.shape[-1]):
        state = _apply_one(state, *(col[:, t] for col in ops))
    return state


def apply_lww_batched(state: LwwState, ops: LwwOps) -> LwwState:
    """Apply [B, T] LWW op streams to B channels: apply_lww_batched_plain
    for CPU tensors; for CUDA tensors one launch of
    kernels/csrc/lww_scan.cu, or ValueError for tensors it does not take.
    The input is not written (callers retry overflowing lanes from it)."""
    if state.key.device.type == "cpu":
        return apply_lww_batched_plain(state, ops)
    return _launch(state, ops)[0]


def apply_lww_window_plain(state: LwwState, cols: torch.Tensor,
                           seq_bt: torch.Tensor
                           ) -> Tuple[LwwState, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one window's LWW bucket. cols is the
    bucket's staged [6, B, T] (kind, key, val, delta, doc_idx, t_idx):
    each op takes the seq its ticket step was assigned in seq_bt, an op
    whose message was not sequenced becomes a NOOP, the ops apply, and
    each lane's occupancy is counted. Returns (state, admitted kinds
    [B, T] int32, occupancy [B] int32)."""
    seq_l = seq_bt[cols[4].long(), cols[5].long()]
    ok = (cols[0] != LwwKind.NOOP) & (seq_l > 0)
    ops = LwwOps(kind=torch.where(ok, cols[0], LwwKind.NOOP),
                 key=cols[1], val=cols[2], delta=cols[3],
                 seq=torch.where(ok, seq_l, 0))
    out = apply_lww_batched_plain(state, ops)
    return out, ops.kind, (out.key >= 0).sum(dim=-1, dtype=torch.int32)


def apply_lww_window(state: LwwState, cols: torch.Tensor,
                     seq_bt: torch.Tensor
                     ) -> Tuple[LwwState, torch.Tensor, torch.Tensor]:
    """One window's LWW bucket (apply_lww_window_plain's result):
    the plain version for CPU tensors; for CUDA tensors one launch of
    kernels/csrc/lww_scan.cu in its admit mode, or ValueError for tensors
    it does not take. An index into the ticket plane counts from its end
    when negative and clamps into range (JAX's gather rule; the plain
    version's indexing raises on an index out of range)."""
    if state.key.device.type == "cpu":
        return apply_lww_window_plain(state, cols, seq_bt)
    return _launch(state, None, cols, seq_bt)


def _on_card(device: torch.device) -> bool:
    """Whether the kernel's tensors may lie on `device`: a CUDA device.
    (The emulator tests, which run the CUDA sources on the CPU, stand in
    for it.)"""
    return device.type == "cuda"


def _check_launchable(state: LwwState, ops, cols, seq_bt) -> None:
    """Raise ValueError unless the kernel takes these tensors: the types,
    contiguity and shapes first, the CUDA device last."""
    if state.key.dim() != 2:
        raise ValueError(f"lww_scan: the slot table has shape "
                         f"{tuple(state.key.shape)}, not [B, C]")
    b, c = state.key.shape
    if b < 1 or c < 1:
        raise ValueError(f"lww_scan: the kernel takes B >= 1 lanes of "
                         f"C >= 1 slots, not [{b}, {c}]")
    want = [(f"state.{name}", x, torch.bool if name == "overflow"
             else torch.int32, (b, c) if i < 3 else (b,))
            for i, (name, x) in enumerate(zip(LwwState._fields, state))]
    if ops is not None:
        t = ops.kind.shape[-1] if ops.kind.dim() == 2 else -1
        want += [(f"ops.{name}", x, torch.int32, (b, t))
                 for name, x in zip(LwwOps._fields, ops)]
    else:
        t = cols.shape[-1] if cols.dim() == 3 else -1
        want += [("cols", cols, torch.int32, (6, b, t))]
        if seq_bt.dim() != 2 or 0 in seq_bt.shape:
            raise ValueError(f"lww_scan: the ticket plane has shape "
                             f"{tuple(seq_bt.shape)}, not a non-empty "
                             f"[B, T]")
        want += [("seq_bt", seq_bt, torch.int32, tuple(seq_bt.shape))]
    for what, x, dtype, shape in want:
        if x.dtype != dtype:
            raise ValueError(f"lww_scan: {what} is {x.dtype}, not {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"lww_scan: {what} has shape "
                             f"{tuple(x.shape)}, not {shape}")
        if not x.is_contiguous():
            raise ValueError(f"lww_scan: {what} is not contiguous")
    for what, x, _dtype, _shape in want:
        if not _on_card(x.device) or x.device != state.key.device:
            raise ValueError(f"lww_scan: {what} is on {x.device}, not the "
                             f"CUDA device of the slot table")


def _launch(state: LwwState, ops, cols=None, seq_bt=None):
    """One kernel launch over CUDA tensors, counted in
    apply_lww_batched.launches: the plain apply with `ops`, or the admit
    mode with (cols, seq_bt). Returns (state, kinds, occupancy); the last
    two are None without the admit mode."""
    _check_launchable(state, ops, cols, seq_bt)
    b, c = state.key.shape
    dev = state.key.device
    new = LwwState(*(torch.empty_like(x) for x in state))
    kinds = occ = None
    if ops is not None:
        t, rows, width = ops.kind.shape[-1], 0, 0
        op_ptrs = [x.data_ptr() for x in ops] + [None, None, None]
        out_ptrs = [None, None]
    else:
        t = cols.shape[-1]
        rows, width = seq_bt.shape
        kinds = torch.empty((b, t), dtype=torch.int32, device=dev)
        occ = torch.empty(b, dtype=torch.int32, device=dev)
        op_ptrs = [cols[i].data_ptr() for i in range(4)] + [None] + \
            [cols[4].data_ptr(), cols[5].data_ptr(), seq_bt.data_ptr()]
        out_ptrs = [kinds.data_ptr(), occ.data_ptr()]
    ptrs = [x.data_ptr() for x in state] + op_ptrs + \
        [x.data_ptr() for x in new] + out_ptrs
    lib = build.library()
    build.check(lib.fluid_lww_scan(
        (ctypes.c_void_p * len(ptrs))(*ptrs), b, c, t, rows, width,
        ctypes.c_void_p(build.stream_handle())), "lww_scan")
    apply_lww_batched.launches += 1
    note_launch("lww_scan")
    return new, kinds, occ


apply_lww_batched.launches = 0


def grow_lane_capacity(state: LwwState, capacity: int) -> LwwState:
    """Re-pad every lane's slot table (overflow recovery)."""
    b, c = state.key.shape
    if capacity <= c:
        return state

    def widen(col, fill):
        out = torch.full((b, capacity), fill, dtype=col.dtype,
                         device=col.device)
        out[:, :c] = col
        return out

    return state._replace(key=widen(state.key, -1),
                          val=widen(state.val, -1),
                          seq=widen(state.seq, 0),
                          overflow=torch.zeros(b, dtype=torch.bool,
                                               device=state.key.device))
