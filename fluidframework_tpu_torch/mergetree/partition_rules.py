"""Named partition rules: leaf-name regexes -> PartitionSpecs
(counterpart of fluidframework_tpu's mergetree/partition_rules.py).

The one source of how serving trees land on a mesh. A rule table is an
ordered list of `(leaf_name_regex, PartitionSpec)` pairs: the first match
wins, scalars (and one-element leaves) always replicate, and a non-scalar
leaf that no rule matches raises, so a placement is never guessed.

Three consumers share the tables: the lane stores' mesh placement
(`place_with_rules`: the paged pool in mergetree/paging.py, the bucket
grids through the sequencer), the runtime verifier (testing/shardcheck.py
holds each shard's device and shape against `resolved_spec_table`), and a
static analyzer that proves placements against them.

Leaf names join the tree path with '/' (dict keys, NamedTuple field names,
sequence indices), e.g. `pool/rem_clients`. The specs are the port's own
`PartitionSpec` (parallel/mesh.py), whose str() is JAX's, so the tables of
the two packages compare string for string.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..parallel.mesh import Mesh, P, PartitionSpec, Sharded, place

#: One rule: (regex over the '/'-joined leaf name, spec for matches).
PartitionRule = Tuple[str, PartitionSpec]

#: The page pool (PagedMergeStore.pool): every column is batched over the
#: page axis ([n_pages, page_rows, ...] segment planes and the [n_pages]
#: per-page padding scalars), so the page axis shards over 'dp' (the
#: pool's capacity scales with the mesh) and the row / anno / overlap-slot
#: axes replicate. A gather by page id crosses shards: the store gathers a
#: window's pages to the dispatching device and scatters them back
#: (paging.py); page ownership stays a host-side allocator concern.
POOL_PARTITION_RULES: List[PartitionRule] = [
    (r"(^|/)(length|ins_seq|ins_client|local_seq|rem_seq|rem_local_seq"
     r"|rem_clients|origin_op|origin_off|anno)$", P("dp")),
    (r"(^|/)(count|min_seq|seq|overflow)$", P("dp")),
]

#: Batched lane and bucket states (ticket state, merge / LWW bucket
#: grids): the leading lane axis over 'dp', the rest replicated; the rule
#: form of what parallel/mesh.shard_docs computes from the shapes.
LANE_PARTITION_RULES: List[PartitionRule] = [
    (r".*", P("dp")),
]


def named_leaves(tree: Any, prefix: str = "",
                 sep: str = "/") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in a fixed order. Dicts join keys, NamedTuples
    field names, lists and tuples indices; anything else is a leaf. None
    leaves are skipped."""
    out: List[Tuple[str, Any]] = []

    def walk(name: str, node: Any) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in node:
                walk(f"{name}{sep}{k}" if name else str(k), node[k])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(f"{name}{sep}{f}" if name else f, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{name}{sep}{i}" if name else str(i), v)
        else:
            out.append((name, node))

    walk(prefix, tree)
    return out


def _spec_for(rules: Sequence[PartitionRule], name: str,
              leaf: Any) -> PartitionSpec:
    shape = getattr(leaf, "shape", ())
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return P()  # scalars and singletons always replicate
    for pattern, spec in rules:
        if re.search(pattern, name) is not None:
            return spec
    raise ValueError(
        f"no partition rule matches leaf {name!r} "
        f"(shape {tuple(shape)}); add a rule to the table — an "
        f"unspecced leaf on a mesh is the UNSPECCED_POOL hazard")


def match_partition_rules(rules: Sequence[PartitionRule],
                          tree: Any) -> Dict[str, PartitionSpec]:
    """Leaf name -> PartitionSpec for every leaf of `tree`: the first
    matching rule wins, scalar leaves get P(), and a non-scalar leaf that
    no rule matches raises ValueError."""
    return {name: _spec_for(rules, name, leaf)
            for name, leaf in named_leaves(tree)}


def resolved_spec_table(tree: Any,
                        rules: Sequence[PartitionRule]) -> Dict[str, str]:
    """The JSON-friendly per-leaf spec table: leaf name ->
    str(PartitionSpec)."""
    return {name: str(spec)
            for name, spec in match_partition_rules(rules, tree).items()}


def _map_named(tree: Any, fn: Callable[[str, Any], Any],
               prefix: str = "", sep: str = "/") -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}{sep}{k}" if prefix
                              else str(k), sep)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[
            _map_named(v, fn, f"{prefix}{sep}{f}" if prefix else f, sep)
            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        mapped = [_map_named(v, fn, f"{prefix}{sep}{i}" if prefix
                             else str(i), sep)
                  for i, v in enumerate(tree)]
        return type(tree)(mapped) if isinstance(tree, list) \
            else tuple(mapped)
    return fn(prefix, tree)


def place_with_rules(mesh: Mesh, tree: Any,
                     rules: Sequence[PartitionRule]) -> Any:
    """Every leaf placed on `mesh` under its rule-resolved spec: the
    placement entry point the mesh stores build through."""
    return _map_named(
        tree, lambda name, leaf: place(leaf, mesh,
                                       _spec_for(rules, name, leaf)))


def placed_as(leaf: Any, mesh: Mesh, spec: PartitionSpec) -> bool:
    """True when `leaf` is a Sharded on `mesh` under `spec` (trailing
    Nones aside) whose every block sits on its entry's device with its
    block's shape."""
    if not isinstance(leaf, Sharded) or leaf.mesh is not mesh \
            or leaf.spec.normalized() != spec.normalized():
        return False
    want = list(leaf.shape)
    for ax, name in enumerate(spec):
        if name is not None:
            want[ax] //= mesh.shape[name]
    for i in range(mesh.shape["dp"]):
        for j in range(mesh.shape["sp"]):
            blk = leaf.block(i, j)
            if blk.device != mesh.device(i, j) \
                    or list(blk.shape) != want:
                return False
    return True


def ensure_placement(mesh: Mesh, tree: Any,
                     rules: Sequence[PartitionRule]) -> Tuple[Any, int]:
    """Re-place only the leaves whose placement drifted from the rule
    table; returns (tree, n_replaced). Leaves that are neither tensors nor
    Sharded (host scalars) are left alone."""
    replaced = 0

    def check(name: str, leaf: Any):
        nonlocal replaced
        if not isinstance(leaf, Sharded) and not hasattr(leaf, "device"):
            return leaf
        spec = _spec_for(rules, name, leaf)
        if placed_as(leaf, mesh, spec):
            return leaf
        replaced += 1
        return place(leaf, mesh, spec)

    return _map_named(tree, check), replaced
