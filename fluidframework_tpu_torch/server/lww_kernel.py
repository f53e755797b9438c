"""Batched LWW lanes: map/cell/counter ops across thousands of channels.

Counterpart of fluidframework_tpu's server/lww_kernel.py (SharedMap
set/delete/clear, SharedCell, SharedCounter increment). Each channel lane
holds a fixed-capacity key-slot table (interned key id, payload ref, writer
seq) and an additive counter. The JAX version is a `lax.scan` over T with
`vmap` over lanes, not a Pallas kernel; here it is a Python loop over T
whose every step is vectorized over the [B, C] tables.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import resolve_device


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


def _scan(state: LwwState, ops: LwwOps) -> LwwState:
    """Apply [B, T] op streams, stepping over T."""
    for t in range(ops.kind.shape[-1]):
        state = _apply_one(state, *(col[:, t] for col in ops))
    return state


def apply_lww_batched(state: LwwState, ops: LwwOps) -> LwwState:
    """Apply [B, T] LWW op streams to B channels; the input is not
    mutated (callers retry overflowing lanes from it)."""
    return _scan(state, ops)


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
