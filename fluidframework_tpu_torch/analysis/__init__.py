"""fluidlint for the port: AST + whole-program static analysis of
fluidframework_tpu_torch (counterpart of fluidframework_tpu's analysis/,
with its 26 rule ids; the port keeps its own copy and imports nothing of
the JAX package).

Five rule families guard the silent failure modes of the port (the
generated rule table is analysis/RULES.md):

* Torch kernel hygiene (torch_rules.py): hazards on the device path,
  the functions engine.DEVICE_PATH_ROOTS reaches: host syncs, branches
  on tensor values and boolean-mask indexing, counted Python loops of
  launches, syncs inside loops and kernel wrappers, mutable-global
  reads, dtype drift, steps that copy their state where an in-place
  form exists.
* Server concurrency/robustness (CC*, concurrency_rules.py):
  await-under-lock, blocking calls in async code, swallowed exceptions,
  listener registration without a removal path, span leaks, mutable
  default arguments, unbounded queues.
* In-place lifecycle (whole-program): a cross-module call graph
  (callgraph.py) + alias dataflow (dataflow.py) over the in-place forms
  that IN_PLACE_ARGS tables declare (the port's counterpart of JAX's
  donate_argnums): USE_AFTER_DONATE, DONATED_ESCAPE, and the
  PAGE_ID_DTYPE torch.int32 lattice (lifecycle_rules.py).
* Lockset race detection (whole-program): thread-root discovery +
  per-function held-lockset summaries over the port's server/telemetry
  tier (concurrency_model.py) back SHARED_STATE_NO_LOCK,
  ATOMICITY_CHECK_THEN_ACT, LOCK_ORDER_INVERSION, and
  SIGNAL_WITHOUT_LOCK (race_rules.py), with a runtime verifier in
  testing/lockcheck.py.
* Placement & sharding dataflow (whole-program): a per-binding
  placement lattice over the port's single-controller mesh
  (placement_model.py) backs MESH_DONATION_GATE, UNSPECCED_POOL,
  PSPEC_MISMATCH, HOST_READ_OF_SHARDED, and SHARD_AXIS_DRIFT
  (placement_rules.py), proven against the partition-rule table
  (mergetree/partition_rules.py) with a runtime verifier in
  testing/shardcheck.py.

Run it with ``python -m fluidframework_tpu_torch.analysis [paths]``
(``--changed-only`` for the git-diff-scoped pass; warm runs ride the
fingerprint cache in ``.fluidlint_torch_cache.json``). Findings are
suppressed inline with ``# fluidlint: disable=RULE — reason`` or
accepted in the committed baseline (``analysis/baseline.json``);
anything else fails the run, which tests/test_torch_analysis.py turns
into a gate.
"""

from .engine import (
    AnalysisResult, ModuleContext, ProgramContext, Violation,
    analyze_paths, analyze_source,
)
from .registry import RULES, Rule, all_rules, get_rule, rule
from .baseline import Baseline, DEFAULT_BASELINE_PATH

# Importing the rule modules registers every rule with the registry.
from . import torch_rules as _torch_rules  # noqa: F401
from . import concurrency_rules as _concurrency_rules  # noqa: F401
from . import lifecycle_rules as _lifecycle_rules  # noqa: F401
from . import race_rules as _race_rules  # noqa: F401
from . import placement_rules as _placement_rules  # noqa: F401

__all__ = [
    "AnalysisResult", "Baseline", "DEFAULT_BASELINE_PATH", "ModuleContext",
    "ProgramContext", "RULES", "Rule", "Violation", "all_rules",
    "analyze_paths", "analyze_source", "get_rule", "rule",
]
