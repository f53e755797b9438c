"""Runtime sharding verification (counterpart of fluidframework_tpu's
testing/shardcheck.py).

Asserts, while the real code runs, that every leaf of a serving tree sits
exactly where the partition-rule table (mergetree/partition_rules.py)
says: a Sharded (parallel/mesh.py) on the mesh under the rule's spec, with
each shard's block on its grid entry's device and of its block's shape. So
the rule table and the runtime cannot drift apart unseen.

Usage::

    from fluidframework_tpu_torch.testing import shardcheck

    shardcheck.assert_placement(store.pool, mesh, POOL_PARTITION_RULES,
                                where="pool")
    checked = shardcheck.verify_store(lam.merge, mesh)   # whole store

    step = shardcheck.instrument(step, mesh, POOL_PARTITION_RULES)
    step(pool, ids)          # raises ShardingMismatch before dispatch
    step.checks              # how many leaves were verified

Production code never imports this module; the mesh tests, the soak and
chip_smoke.py do.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence

from ..mergetree.partition_rules import (LANE_PARTITION_RULES,
                                         POOL_PARTITION_RULES,
                                         PartitionRule, _spec_for,
                                         named_leaves, placed_as)
from ..parallel.mesh import Sharded


class ShardingMismatch(AssertionError):
    """A leaf's placement diverged from its rule-table spec."""


def _describe(leaf: Any) -> str:
    if isinstance(leaf, Sharded):
        blocks = [f"{b.device}{tuple(b.shape)}"
                  for row in leaf.blocks for b in row]
        return f"{leaf.spec} blocks {blocks}"
    return f"one tensor on {leaf.device}"


def assert_placement(tree: Any, mesh, rules: Sequence[PartitionRule],
                     where: str = "") -> int:
    """Assert that every device leaf of `tree` is placed exactly as the
    rule table predicts on `mesh`; returns the number of leaves checked.
    Leaves that are neither tensors nor Sharded (numpy staging planes,
    host scalars) are skipped: the table governs device placement only. A
    plain tensor fails, as an unplaced array does in JAX."""
    failures: List[str] = []
    checked = 0
    for name, leaf in named_leaves(tree):
        if not isinstance(leaf, Sharded) and not hasattr(leaf, "device"):
            continue
        spec = _spec_for(rules, name, leaf)
        checked += 1
        if not placed_as(leaf, mesh, spec):
            label = f"{where}/{name}" if where else name
            failures.append(f"  {label}: actual {_describe(leaf)} != "
                            f"predicted {spec}")
    if failures:
        raise ShardingMismatch(
            "sharding drifted from the partition-rule table "
            f"({len(failures)}/{checked} leaves):\n" + "\n".join(failures))
    return checked


def verify_store(merge_store, mesh=None) -> int:
    """Verify a MergeLaneStore's device planes against the rule tables:
    the paged pool under POOL_PARTITION_RULES, every bucket grid under
    LANE_PARTITION_RULES. Returns the leaves checked (0 when the store
    carries no mesh: nothing to predict)."""
    mesh = mesh if mesh is not None else getattr(merge_store, "mesh", None)
    if mesh is None:
        return 0
    checked = 0
    pages = getattr(merge_store, "pages", None)
    if pages is not None:
        checked += assert_placement(pages.pool, mesh, POOL_PARTITION_RULES,
                                    where="pool")
    for bucket in getattr(merge_store, "buckets", []):
        checked += assert_placement(bucket.state, mesh,
                                    LANE_PARTITION_RULES,
                                    where=f"bucket{bucket.capacity}")
    return checked


def instrument(fn, mesh, rules: Sequence[PartitionRule],
               tree_args: Sequence[int] = (0,)):
    """Wrap a dispatch so the tree arguments at positions `tree_args` are
    verified against `rules` before every call; the wrapper counts the
    verified leaves in `.checks`."""

    @functools.wraps(fn)
    def checked(*args, **kwargs):
        for pos in tree_args:
            if pos < len(args):
                checked.checks += assert_placement(
                    args[pos], mesh, rules, where=f"arg{pos}")
        return fn(*args, **kwargs)

    checked.checks = 0
    return checked


def placement_report(merge_store, mesh=None) -> Dict[str, Any]:
    """The machine-readable verdict: {"ok": bool, "checked": N, "error":
    str or None}, plus the pool's resolved spec table when the store has
    a paged pool on a mesh."""
    report: Dict[str, Any] = {"ok": True, "checked": 0, "error": None}
    try:
        report["checked"] = verify_store(merge_store, mesh)
    except (ShardingMismatch, ValueError) as exc:
        report["ok"] = False
        report["error"] = str(exc).splitlines()[0]
    pages = getattr(merge_store, "pages", None)
    if pages is not None and getattr(pages, "mesh", None) is not None:
        report["pool_specs"] = pages.placement_spec_table()
    return report
