"""RC* rules: whole-program lockset race detection (counterpart of
fluidframework_tpu's analysis/race_rules.py).

Four rule families over the concurrency model
(concurrency_model.py), guarding the thread/lock discipline of the
server tier the way lifecycle_rules.py guards the donated-buffer
discipline. The model discovers thread roots (spawned threads, executor
hand-offs, HTTP handler entry points, pump subscribe callbacks) and
lock objects, computes per-function held-lockset summaries with
transitive inheritance across the call graph, and intersects locksets
per shared instance attribute:

* ``SHARED_STATE_NO_LOCK`` — a cross-thread attribute whose lockset
  intersection over all accesses is empty (the Eraser condition);
* ``ATOMICITY_CHECK_THEN_ACT`` — read-test-write of the same shared
  attribute where the guarding lock is released between test and act
  (two distinct acquisitions of the same lock);
* ``LOCK_ORDER_INVERSION`` — two locks acquired in both orders on
  different paths, the classic deadlock shape (fires only when BOTH
  orders exist);
* ``SIGNAL_WITHOUT_LOCK`` — ``Condition.notify``/``wait`` outside the
  condition's owning lock.

Deliberate lock-free patterns are annotated, not silently tolerated:
``# fluidlint: guarded-by=<attr>`` asserts a lock the model cannot see
(verified at runtime by ``testing/lockcheck.py``), and
``# fluidlint: disable=RULE — reason`` documents the monotonic-read
patterns that are racy-by-design.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from .engine import ModuleContext, Violation
from .registry import rule

#: Rule ids of this family — the engine uses this set to let race
#: findings participate in --changed-only reach expansion.
RACE_RULE_IDS = frozenset({
    "SHARED_STATE_NO_LOCK", "ATOMICITY_CHECK_THEN_ACT",
    "LOCK_ORDER_INVERSION", "SIGNAL_WITHOUT_LOCK",
})


def _model_for(ctx: ModuleContext):
    """The whole-program concurrency model: analyze_paths attaches a
    ProgramContext spanning every analyzed module; analyze_source
    (fixtures) builds a single-module one on demand."""
    from .lifecycle_rules import _program_for
    return _program_for(ctx).concurrency()


def _emit(ctx: ModuleContext, rule_id: str) -> Iterator[Violation]:
    from .concurrency_model import in_scope
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
    # Model nodes come from this module's own tree, so the engine's
    # symbol/line machinery applies directly; synthetic nodes (lambda
    # wrappers) still carry copied locations.
    if not isinstance(node, ast.AST):  # pragma: no cover - defensive
        node = ast.Pass()
        node.lineno, node.col_offset = 1, 0
    return ctx.violation(finding.rule_id, node, finding.message)


@rule("SHARED_STATE_NO_LOCK",
      "Cross-thread attribute with an empty lockset intersection over "
      "its accesses",
      family="race",
      rationale="An attribute written from one thread root and touched "
                "from another with no common lock is a data race: torn "
                "dict/list mutation, lost counter updates, or "
                "RuntimeError('dict changed size during iteration') on "
                "the monitor's probe threads. Guard every access with "
                "one lock, or annotate the deliberate pattern "
                "(# fluidlint: guarded-by=<attr> for a lock the model "
                "cannot see, disable= for monotonic stat reads).")
def shared_state_no_lock(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "SHARED_STATE_NO_LOCK")


@rule("ATOMICITY_CHECK_THEN_ACT",
      "Read-test-write of a shared attribute with the lock released "
      "between test and act",
      family="race",
      rationale="Holding the lock for the test and re-acquiring it for "
                "the act publishes a stale decision: another thread can "
                "invalidate the test in the gap (pop from an emptied "
                "queue, double-free a lane). Widen one critical section "
                "over the whole check-then-act.")
def atomicity_check_then_act(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "ATOMICITY_CHECK_THEN_ACT")


@rule("LOCK_ORDER_INVERSION",
      "Two locks acquired in both orders on different paths",
      family="race",
      rationale="Thread A takes lock1 then lock2; thread B takes lock2 "
                "then lock1 — each holds what the other needs and the "
                "server deadlocks under exactly the load that makes "
                "both paths hot. Fires only when BOTH orders exist; "
                "pick one global order (document it on the lock decl).")
def lock_order_inversion(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "LOCK_ORDER_INVERSION")


@rule("SIGNAL_WITHOUT_LOCK",
      "Condition.notify/wait outside its owning lock",
      family="race",
      rationale="notify()/wait() on a threading.Condition whose lock "
                "is not held raises RuntimeError at runtime — or, for "
                "the test-then-wait idiom, misses the wakeup entirely "
                "and hangs the waiter. Wrap the call in `with cond:`.")
def signal_without_lock(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "SIGNAL_WITHOUT_LOCK")
