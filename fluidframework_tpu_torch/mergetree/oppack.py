"""Packing host op streams into int32 op columns [B, T].

The hot path never iterates Python objects: ops are packed into int32
columns (documents x time), padded with NOOP rows, and the apply steps over
T applying one op per document per step. Packing is pure numpy here; the
tensors are placed on a device by interop.packed_ops_from_numpy.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class OpKind:
    NOOP = 0
    INSERT = 1
    REMOVE = 2
    ANNOTATE = 3
    ACK_INSERT = 4
    ACK_REMOVE = 5
    INSERT_RUN = 6  # up to RUN_K packed cursor-advance inserts, one step


# A same-(client, refSeq) typing burst with cursor-advancing positions
# packs into one INSERT_RUN step of up to RUN_K rows. The port's fused
# apply does not take run columns yet (see ROADMAP.md).
RUN_K = 8


class RunCols(NamedTuple):
    """Per-step sub-insert columns for INSERT_RUN ops: [B, T, K] (or
    [T, K] unbatched) int32; length 0 marks padding slots."""

    length: torch.Tensor
    seq: torch.Tensor
    op_id: torch.Tensor


class HostOp(NamedTuple):
    """One op in host form, positions relative to (ref_seq, client)."""

    kind: int
    seq: int            # DEV_UNASSIGNED for a pending local submit
    ref_seq: int
    client: int
    pos1: int = 0
    pos2: int = 0       # remove/annotate end (exclusive)
    op_id: int = -1     # global id: insert text payload / annotate pset
    new_len: int = 0    # insert payload length
    local_seq: int = 0  # local seq for pending submits; ack target
    msn: int = 0


class PackedOps(NamedTuple):
    """Int32 op columns, each [B, T] (or [T] unbatched)."""

    kind: torch.Tensor
    seq: torch.Tensor
    ref_seq: torch.Tensor
    client: torch.Tensor
    pos1: torch.Tensor
    pos2: torch.Tensor
    op_id: torch.Tensor
    new_len: torch.Tensor
    local_seq: torch.Tensor
    msn: torch.Tensor

    @property
    def steps(self) -> int:
        return self.kind.shape[-1]


FIELDS = PackedOps._fields


def pack_ops(streams: List[List[HostOp]], steps: Optional[int] = None
             ) -> Dict[str, np.ndarray]:
    """Pack per-document op lists into numpy [B, T] int32 columns keyed by
    PackedOps field, NOOP-padded (all-zero rows)."""
    b = len(streams)
    t = steps if steps is not None else max((len(s) for s in streams),
                                            default=0)
    t = max(t, 1)
    buf = np.zeros((len(FIELDS), b, t), np.int32)
    for d, stream in enumerate(streams):
        if len(stream) > t:
            raise ValueError(f"doc {d}: {len(stream)} ops > {t} steps")
        if stream:
            buf[:, d, :len(stream)] = np.asarray(stream, np.int64).T
    return {f: buf[j] for j, f in enumerate(FIELDS)}
