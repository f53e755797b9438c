"""The north-star pipeline step: deli ticketing -> merge-tree apply ->
per-document visible length.

Each stage is a hand-written CUDA kernel for CUDA tensors: the ticket scan
(kernels/csrc/ticket_scan.cu), the apply, the summary length.

Counterpart of fluidframework_tpu's server/pipeline.py make_full_step with
fused_apply=True: the fused apply up to its shared-memory capacity, the
scan apply above it. The ticketing output feeds the apply: each admitted op's
assigned seq and msn replace the packed columns, and ops the sequencer
rejected (nack) or dropped (duplicate) become NOOPs before the merge-tree
sees them.
"""

from __future__ import annotations

import torch

from ..mergetree import kernel
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
    device: the reference the kernels are held to. A capacity up to
    max_fused_capacity takes the fused apply; above it, the scan apply
    (mergetree/kernel.py, kernels/csrc/scan_apply.cu), as the JAX step
    routes capacities beyond its fused kernel's budget to kernel._scan_ops."""
    fused = apply_ops_fused_plain if plain else apply_ops_fused
    summary = summary_lengths_plain if plain else summary_lengths
    ticket = tk.scan_tickets_plain if plain else tk.scan_tickets

    def scan(mstate, ops):
        if plain:
            return kernel.scan_ops_plain(mstate, ops, batched=True)
        return kernel.apply_ops_batched_keep(mstate, ops)

    def full_step(tstate, mstate, raw, ops):
        limit = max_fused_capacity(mstate.overlap_slots, mstate.anno_slots)
        apply = fused if mstate.capacity <= limit else scan
        tstate, ticketed = ticket(tstate, raw)
        mstate = apply(mstate, admit_ops(ops, ticketed))
        total_len = summary(mstate)
        return tstate, mstate, ticketed, total_len

    return full_step


full_step = make_full_step()
