"""Device-side merge-tree state as structure-of-arrays int32 tensors.

Same fields, shapes and sentinels as fluidframework_tpu's
mergetree/state.py DocState, so a state converts between the two packages
field by field through numpy (interop.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import CapacityExceeded
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


def _host_state(columns: dict, capacity: int, anno_slots: int,
                overlap_slots: int) -> dict:
    """One document's full-capacity numpy fields (DocState order) from
    host columns of length n <= capacity: the rows given, make_state's
    padding after them, count n, min_seq and seq 0, no overflow."""
    n = len(columns["length"])
    if n > capacity:
        raise CapacityExceeded(f"{n} segments exceed capacity {capacity}")
    a = max(anno_slots, 1)

    def plane(name, pad):
        out = np.full(capacity, pad, np.int32)
        if name in columns:
            out[:n] = np.asarray(columns[name], np.int32)
        return out

    rem_clients = np.full((capacity, overlap_slots), -1, np.int32)
    if "rem_client" in columns:
        rem_clients[:n, 0] = np.asarray(columns["rem_client"], np.int32)
    if "rem_overlap" in columns:  # overlap removers, slots 1+
        ov = np.asarray(columns["rem_overlap"], np.int32)
        w = min(ov.shape[1], overlap_slots - 1)
        rem_clients[:n, 1:1 + w] = ov[:, :w]
    anno = np.full((capacity, a), -1, np.int32)
    if "anno" in columns:
        anno[:n] = np.asarray(columns["anno"], np.int32)
    return dict(
        length=plane("length", 0),
        ins_seq=plane("ins_seq", DEV_UNASSIGNED),
        ins_client=plane("ins_client", -1),
        local_seq=plane("local_seq", 0),
        rem_seq=plane("rem_seq", DEV_NO_REMOVE),
        rem_local_seq=plane("rem_local_seq", 0),
        rem_clients=rem_clients,
        origin_op=plane("origin_op", -1),
        origin_off=plane("origin_off", 0),
        anno=anno,
        count=np.int32(n), min_seq=np.int32(0), seq=np.int32(0),
        overflow=np.bool_(False))


def _put(fields: dict, device) -> DocState:
    dev = resolve_device(device)
    return DocState(**{name: torch.from_numpy(np.array(fields[name])).to(dev)
                       for name in DocState._fields})


def state_from_numpy(columns: dict, capacity: int,
                     anno_slots: int = DEFAULT_ANNO_SLOTS,
                     overlap_slots: int = MAX_OVERLAP_CLIENTS,
                     device: str | torch.device | None = None) -> DocState:
    """Single-document state from host numpy columns of length
    n <= capacity (fluidframework_tpu's state_from_numpy): the keys are
    the segment planes, plus optional "rem_client" (rem_clients slot 0),
    "rem_overlap" ([n, <= K-1] overlap removers) and "anno" ([n, A]).
    Count is n; min_seq, seq and overflow start at 0. device defaults to
    "cuda"."""
    return _put(_host_state(columns, capacity, anno_slots, overlap_slots),
                device)


def batched_state_from_numpy(columns: list, capacity: int,
                             anno_slots: int = DEFAULT_ANNO_SLOTS,
                             overlap_slots: int = MAX_OVERLAP_CLIENTS,
                             device: str | torch.device | None = None
                             ) -> DocState:
    """A [B, capacity] state from one column dict per document (each as
    state_from_numpy takes it), built on the host and placed in one
    transfer per field."""
    docs = [_host_state(c, capacity, anno_slots, overlap_slots)
            for c in columns]
    return _put({name: np.stack([d[name] for d in docs])
                 for name in DocState._fields}, device)
