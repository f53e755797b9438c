"""The north-star pipeline step: deli ticketing -> merge-tree apply ->
per-document visible length.

Each stage is a hand-written CUDA kernel for CUDA tensors: the ticket scan
(kernels/csrc/ticket_scan.cu), the apply, the summary length.

Counterpart of fluidframework_tpu's server/pipeline.py make_full_step. The
ticketing output feeds the apply: each admitted op's assigned seq and msn
replace the packed columns, and ops the sequencer rejected (nack) or
dropped (duplicate) become NOOPs before the merge-tree sees them.

On a mesh (the step's trees placed by parallel/mesh.shard_docs) each dp
shard's documents run the ticket scan, the apply and the summary length on
that shard's device, one launch of each kernel per shard. With the
capacity axis sharded over 'sp' (shard_docs(seq_sharded=True) on a mesh
with sp > 1) the apply is the fused apply over per-shard lane tiles
(mergetree/fused_sp.apply_ops_fused_shardmap: one launch of
kernels/csrc/fused_sp.cu per dp row on CUDA entries), and each tile's
summary length is summed across its row.
"""

from __future__ import annotations

import torch

from ..mergetree import kernel
from ..mergetree.fused_sp import (apply_ops_fused_shardmap,
                                  apply_ops_fused_shardmap_plain,
                                  apply_ops_fused_sp,
                                  apply_ops_fused_sp_plain)
from ..mergetree.oppack import OpKind, PackedOps
from ..mergetree.pallas_apply import (apply_ops_fused, apply_ops_fused_plain,
                                      max_fused_capacity)
from ..mergetree.pallas_ops import summary_lengths, summary_lengths_plain
from ..mergetree.state import DocState
from ..parallel.mesh import (P, Sharded, from_blocks, map_dp, on_shard,
                             row_reduce)
from . import ticket_kernel as tk


def admit_ops(ops: PackedOps, ticketed: tk.Ticketed) -> PackedOps:
    """NOOP-mask unadmitted ops and stamp the ticketed seq/msn."""
    admitted = ticketed.seq > 0
    return ops._replace(
        kind=torch.where(admitted, ops.kind, OpKind.NOOP).to(torch.int32),
        seq=torch.where(admitted, ticketed.seq, ops.seq),
        msn=torch.where(admitted, ticketed.min_seq, ops.msn),
    )


def make_full_step(sp_shards: int = 1, fused_apply: bool = True,
                   plain: bool = False):
    """Build full_step(tstate, mstate, raw, ops) ->
    (tstate, mstate, ticketed, total_len).

    The step runs the CUDA kernels for CUDA tensors (the plain versions for
    CPU tensors). plain=True composes the plain PyTorch versions on any
    device: the reference the kernels are held to. With fused_apply (the
    port's north-star path, and its default: JAX's default is the scan
    apply, the same result), a capacity up to max_fused_capacity takes the
    fused apply; above it, or without fused_apply, the scan apply
    (mergetree/kernel.py, kernels/csrc/scan_apply.cu), whose prefix sums
    take the sp_shards formulation. fused_apply with sp_shards > 1 takes
    the fused-sp form (mergetree/fused_sp.apply_ops_fused_sp, which
    launches kernels/csrc/scan_apply.cu for CUDA tensors), as the JAX
    step does. Trees placed on a
    mesh run per shard (module docstring)."""
    fused = apply_ops_fused_plain if plain else apply_ops_fused
    fused_sp = apply_ops_fused_sp_plain if plain else apply_ops_fused_sp
    fused_shardmap = apply_ops_fused_shardmap_plain if plain \
        else apply_ops_fused_shardmap
    summary = summary_lengths_plain if plain else summary_lengths
    ticket = tk.scan_tickets_plain if plain else tk.scan_tickets

    def apply(mstate: DocState, ops: PackedOps) -> DocState:
        if fused_apply and sp_shards > 1:
            return fused_sp(mstate, ops, sp_shards)
        limit = max_fused_capacity(mstate.overlap_slots, mstate.anno_slots)
        if fused_apply and mstate.capacity <= limit:
            return fused(mstate, ops)
        if plain:
            return kernel.scan_ops_plain(mstate, ops, batched=True,
                                         sp_shards=sp_shards)
        return kernel._scan_ops(mstate, ops, batched=True,
                                sp_shards=sp_shards)

    def ticket_admit(tstate, raw, ops):
        tstate, ticketed = ticket(tstate, raw)
        return tstate, ticketed, admit_ops(ops, ticketed)

    def local_step(tstate, mstate, raw, ops):
        tstate, ticketed, ops2 = ticket_admit(tstate, raw, ops)
        mstate = apply(mstate, ops2)
        return tstate, mstate, ticketed, summary(mstate)

    def tile_lengths(mstate: DocState) -> Sharded:
        """Each [B/dp, C/sp] tile's visible length (the summary length of
        the tile with its count cut to the tile), summed within each dp
        row."""
        mesh = mstate.length.mesh
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        width = mstate.capacity // sp
        blocks = []
        for i in range(dp):
            parts = []
            for j in range(sp):
                tile = DocState(*(x.block(i, j) for x in mstate))
                count = (tile.count - j * width).clamp(0, width)
                with on_shard(mesh, i, j):
                    parts.append(summary(tile._replace(
                        count=count.to(torch.int32).contiguous())))
            blocks.append(row_reduce(mesh, parts, i, torch.add))
        return from_blocks(mesh, P("dp"), blocks)

    def full_step(tstate, mstate, raw, ops):
        if not isinstance(mstate.length, Sharded):
            return local_step(tstate, mstate, raw, ops)
        mesh = mstate.length.mesh
        if "sp" not in mstate.length.spec:
            return map_dp(local_step, mesh, tstate, mstate, raw, ops)
        tstate, ticketed, ops2 = map_dp(ticket_admit, mesh, tstate, raw,
                                        ops)
        mstate = fused_shardmap(mstate, ops2, mesh)
        return tstate, mstate, ticketed, tile_lengths(mstate)

    return full_step


full_step = make_full_step()
