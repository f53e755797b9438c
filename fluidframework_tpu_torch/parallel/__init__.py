"""Device-mesh parallelism: sharded placement and the sequence-parallel
scan (counterpart of fluidframework_tpu's parallel/).

The axes map as in the JAX package: documents (lanes, pages) over 'dp',
the segment-capacity axis of long documents over 'sp' (its prefix sum
decomposed into local cumsums and the all-gathered shard totals). One
process drives every device of the mesh.
"""

from .mesh import (Mesh, P, PartitionSpec, Sharded, gather, make_mesh,
                   replicate, shard_docs)
from .seq_scan import sharded_cumsum

__all__ = ["Mesh", "P", "PartitionSpec", "Sharded", "gather", "make_mesh",
           "replicate", "shard_docs", "sharded_cumsum"]
