"""The north-star pipeline step: deli ticketing -> fused merge-tree apply ->
per-document visible length.

Counterpart of fluidframework_tpu's server/pipeline.py make_full_step with
fused_apply=True. The ticketing output feeds the apply: each admitted op's
assigned seq and msn replace the packed columns, and ops the sequencer
rejected (nack) or dropped (duplicate) become NOOPs before the merge-tree
sees them.
"""

from __future__ import annotations

import torch

from ..mergetree.oppack import OpKind, PackedOps
from ..mergetree.pallas_apply import (apply_ops_fused, apply_ops_fused_plain,
                                      max_fused_capacity)
from ..mergetree.pallas_ops import summary_lengths, summary_lengths_plain
from . import ticket_kernel as tk


def admit_ops(ops: PackedOps, ticketed: tk.Ticketed) -> PackedOps:
    """NOOP-mask unadmitted ops and stamp the ticketed seq/msn."""
    admitted = ticketed.seq > 0
    return ops._replace(
        kind=torch.where(admitted, ops.kind, OpKind.NOOP).to(torch.int32),
        seq=torch.where(admitted, ticketed.seq, ops.seq),
        msn=torch.where(admitted, ticketed.min_seq, ops.msn),
    )


def make_full_step(plain: bool = False):
    """Build full_step(tstate, mstate, raw, ops) ->
    (tstate, mstate, ticketed, total_len).

    The step runs the CUDA kernels for CUDA tensors (the plain versions for
    CPU tensors). plain=True composes the plain PyTorch versions on any
    device: the reference the kernels are held to. A capacity above
    max_fused_capacity raises ValueError either way; the scan apply that
    the JAX package routes such capacities to is not ported yet."""
    apply = apply_ops_fused_plain if plain else apply_ops_fused
    summary = summary_lengths_plain if plain else summary_lengths

    def full_step(tstate, mstate, raw, ops):
        limit = max_fused_capacity(mstate.overlap_slots, mstate.anno_slots)
        if mstate.capacity > limit:
            raise ValueError(
                f"capacity {mstate.capacity} exceeds max_fused_capacity="
                f"{limit}: the fused apply holds a document's table in one "
                "block's shared memory")
        tstate, ticketed = tk.scan_tickets(tstate, raw)
        mstate = apply(mstate, admit_ops(ops, ticketed))
        total_len = summary(mstate)
        return tstate, mstate, ticketed, total_len

    return full_step


full_step = make_full_step()
