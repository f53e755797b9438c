"""PL* rules: whole-program placement & sharding dataflow
(counterpart of fluidframework_tpu's analysis/placement_rules.py).

Five rules over the placement model (placement_model.py), guarding the
mesh discipline of the port's mergetree/server/parallel tiers the way
race_rules.py guards the thread/lock discipline. The model tracks every
binding through the placement lattice (host < replicated <
mesh-sharded(PartitionSpec) < mutated-gone), indexing mesh
construction, spec literals, the placements of parallel/mesh.py and
mergetree/partition_rules.py, and the dispatch boundaries (``map_dp``,
the lane stores' ``_dispatch``, the in-place forms):

* ``MESH_DONATION_GATE``: a definitely mesh-sharded binding passed to an
  in-place form (a mesh pool keeps its pre-window views; its callers
  dispatch through the _keep twins);
* ``UNSPECCED_POOL``: a lane/page-pool tree reaching a mesh dispatch
  with no matching partition rule (silently replicated onto every
  shard);
* ``PSPEC_MISMATCH``: spec axis names absent from every mesh the
  program builds, or spec arity exceeding the target's known rank;
* ``HOST_READ_OF_SHARDED``: ``.item()``/``.cpu()``/``int()``/
  ``np.asarray`` on a mesh-sharded binding outside the sanctioned
  gather helpers (a read goes through ``gather``, ``take_rows`` or
  ``row_of``);
* ``SHARD_AXIS_DRIFT``: one tree placed under two different specs with
  no explicit reshard.

Rules fire on DEFINITE placements only (straight-line code); the
conditional single-card/mesh dual-mode paths stay quiet and are covered
dynamically by ``testing/shardcheck.py`` against the same rule table
(``mergetree/partition_rules.py``).
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from .engine import ModuleContext, Violation
from .registry import rule

#: Rule ids of this family — the engine uses this set to let placement
#: findings participate in --changed-only reach expansion.
PLACEMENT_RULE_IDS = frozenset({
    "MESH_DONATION_GATE", "UNSPECCED_POOL", "PSPEC_MISMATCH",
    "HOST_READ_OF_SHARDED", "SHARD_AXIS_DRIFT",
})


def _model_for(ctx: ModuleContext):
    """The whole-program placement model: analyze_paths attaches a
    ProgramContext spanning every analyzed module; analyze_source
    (fixtures) builds a single-module one on demand."""
    from .lifecycle_rules import _program_for
    return _program_for(ctx).placement()


def _emit(ctx: ModuleContext, rule_id: str) -> Iterator[Violation]:
    from .placement_model import in_scope
    if not in_scope(ctx.path):
        return
    model = _model_for(ctx)
    seen: Set[tuple] = set()
    for f in model.findings_for(ctx.path):
        if f.rule_id != rule_id:
            continue
        key = (getattr(f.node, "lineno", 0),
               getattr(f.node, "col_offset", 0), f.message)
        if key in seen:
            continue
        seen.add(key)
        yield _violation(ctx, f)


def _violation(ctx: ModuleContext, finding) -> Violation:
    node = finding.node
    if not isinstance(node, ast.AST):  # pragma: no cover - defensive
        node = ast.Pass()
        node.lineno, node.col_offset = 1, 0
    return ctx.violation(finding.rule_id, node, finding.message)


@rule("MESH_DONATION_GATE",
      "Mesh-sharded binding passed to an in-place form",
      family="placement",
      rationale="A pool on a mesh keeps the pre-window views its "
                "rollback scatters back, and its pages move between "
                "shards on every gather and scatter: an in-place write "
                "there races the views it keeps. Every paged entry "
                "point has a _keep twin (mergetree/kernel.py, "
                "server/serve_step.py) that mesh callers dispatch "
                "through; never the in-place form.")
def mesh_donation_gate(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "MESH_DONATION_GATE")


@rule("UNSPECCED_POOL",
      "Lane/page-pool tree reaching a mesh dispatch with no matching "
      "partition rule",
      family="placement",
      rationale="A pool that never went through place_with_rules "
                "(mergetree/partition_rules.py) is replicated onto "
                "every shard at the first mesh dispatch: page capacity "
                "stops scaling with the mesh and the copy lands on the "
                "serving path. Place the pool under the rule table "
                "before dispatching it.")
def unspecced_pool(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "UNSPECCED_POOL")


@rule("PSPEC_MISMATCH",
      "PartitionSpec naming an axis no mesh has, or exceeding the "
      "target's rank",
      family="placement",
      rationale="A spec axis absent from the mesh (or more spec entries "
                "than the tensor has dimensions) raises inside "
                "parallel/mesh.place, but only on the first mesh-shaped "
                "run, which for dual-mode code means in production, not "
                "in single-card CI. The model checks every literal spec "
                "against the union of axes any mesh in the program "
                "declares.")
def pspec_mismatch(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "PSPEC_MISMATCH")


@rule("HOST_READ_OF_SHARDED",
      "Scalar/host read of a mesh-sharded binding outside the gather "
      "helpers",
      family="placement",
      rationale=".item()/.cpu()/int()/np.asarray on a mesh-sharded "
                "binding reads every shard through a blocking transfer: "
                "a serving-path stall that grows with the mesh. Read "
                "through gather, take_rows or row_of (parallel/mesh.py), "
                "or a sanctioned gather helper (*gather*/*to_host*/"
                "*fetch* functions), or keep the reduction on-device.")
def host_read_of_sharded(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "HOST_READ_OF_SHARDED")


@rule("SHARD_AXIS_DRIFT",
      "One tree placed under two different specs with no explicit "
      "reshard",
      family="placement",
      rationale="Two consumers pinning the same tree to different specs "
                "copy every block between the shards on every call: "
                "silent transfer traffic that counts in Mesh.copies. "
                "Rebind through an explicit reshard (`x = place(x, "
                "...)`) or unify the consumers on one spec in the rule "
                "table.")
def shard_axis_drift(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "SHARD_AXIS_DRIFT")
