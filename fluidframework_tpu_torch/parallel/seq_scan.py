"""The sequence-parallel prefix sum (counterpart of fluidframework_tpu's
parallel/seq_scan.py).

For a table whose capacity axis is sharded over 'sp', position resolution
needs a prefix sum across the shards. The two-level scan: each shard
cumsums its block, the shard totals (one value per document and shard)
are all-gathered within each dp row, and each shard adds the sum of its
predecessors' totals. The all-gather is explicit copies between the row's
devices (parallel/mesh.py row_all_gather); nothing else crosses shards.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, P, Sharded, from_blocks, place, row_all_gather


def sharded_cumsum(x, mesh: Mesh, axis_name: str = "sp",
                   exclusive: bool = False) -> Sharded:
    """Cumsum along the last axis of [B, ..., C] with C sharded over
    `axis_name` and the leading axis over 'dp'. `x` is a tensor or a
    Sharded; the result is a Sharded under the same spec, in x's dtype."""
    if axis_name != "sp":
        raise ValueError(f"the scan's axis is 'sp' (got {axis_name!r})")
    spec = P(*(["dp"] + [None] * (len(x.shape) - 2) + [axis_name]))
    xs = place(x, mesh, spec)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    blocks = []
    for i in range(dp):
        parts = [xs.block(i, j) for j in range(sp)]
        incl = [torch.cumsum(p, dim=-1, dtype=p.dtype) for p in parts]
        totals = [c[..., -1:] for c in incl]
        row = []
        for j in range(sp):
            seen = row_all_gather(mesh, totals, i, j)
            out = incl[j]
            for t in seen[:j]:
                out = out + t
            row.append(out - parts[j] if exclusive else out)
        blocks.append(row)
    return from_blocks(mesh, spec, blocks)
