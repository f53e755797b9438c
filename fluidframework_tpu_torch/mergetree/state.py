"""Device-side merge-tree state as structure-of-arrays int32 tensors.

Same fields, shapes and sentinels as fluidframework_tpu's
mergetree/state.py DocState, so a state converts between the two packages
field by field through numpy (interop.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import resolve_device
from .constants import DEV_NO_REMOVE, DEV_UNASSIGNED, MAX_OVERLAP_CLIENTS

DEFAULT_ANNO_SLOTS = 4


class DocState(NamedTuple):
    """One document's segment table (or a batch with a leading axis).

    Segment columns, shape [C] (capacity; slots >= count are padding):
      length      visible length contribution when the segment is visible
      ins_seq     sequence number of the insert; DEV_UNASSIGNED = pending
      ins_client  inserting client
      local_seq   local sequence number while pending, else 0
      rem_seq     DEV_NO_REMOVE = never removed; DEV_UNASSIGNED = pending
      rem_local_seq  local seq of a pending local remove, else 0
      rem_clients [C, K] removing client + overlap clients (-1 = free slot)
      origin_op   global op id whose payload this segment's text comes from
      origin_off  offset into that op's payload (splits advance this)
      anno        [C, A] ring of annotate op ids, newest first (-1 = empty)

    Scalars: count, min_seq, seq (latest applied), all int32; overflow bool.
    """

    length: torch.Tensor
    ins_seq: torch.Tensor
    ins_client: torch.Tensor
    local_seq: torch.Tensor
    rem_seq: torch.Tensor
    rem_local_seq: torch.Tensor
    rem_clients: torch.Tensor
    origin_op: torch.Tensor
    origin_off: torch.Tensor
    anno: torch.Tensor
    count: torch.Tensor
    min_seq: torch.Tensor
    seq: torch.Tensor
    overflow: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.length.shape[-1]

    @property
    def overlap_slots(self) -> int:
        return self.rem_clients.shape[-1]

    @property
    def anno_slots(self) -> int:
        return self.anno.shape[-1]


def make_state(capacity: int, anno_slots: int = DEFAULT_ANNO_SLOTS,
               overlap_slots: int = MAX_OVERLAP_CLIENTS,
               batch: int | None = None,
               device: str | torch.device | None = None) -> DocState:
    """Fresh empty state; batch=None for a single doc, int for [B, ...].

    device defaults to "cuda" and raises when CUDA is absent."""
    dev = resolve_device(device)

    def shape(*dims):
        return dims if batch is None else (batch, *dims)

    def full(value, *dims):
        return torch.full(shape(*dims), value, dtype=torch.int32, device=dev)

    a = max(anno_slots, 1)
    return DocState(
        length=full(0, capacity),
        ins_seq=full(DEV_UNASSIGNED, capacity),
        ins_client=full(-1, capacity),
        local_seq=full(0, capacity),
        rem_seq=full(DEV_NO_REMOVE, capacity),
        rem_local_seq=full(0, capacity),
        rem_clients=full(-1, capacity, overlap_slots),
        origin_op=full(-1, capacity),
        origin_off=full(0, capacity),
        anno=full(-1, capacity, a),
        count=full(0),
        min_seq=full(0),
        seq=full(0),
        overflow=torch.zeros(shape(), dtype=torch.bool, device=dev),
    )
