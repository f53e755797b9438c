"""Rule registry: rules self-register via the @rule decorator
(counterpart of fluidframework_tpu's analysis/registry.py).

A rule is a callable ``check(ctx) -> Iterator[Violation]`` plus metadata
(id, family, rationale) used by ``--list-rules`` and the docs. Keeping
registration declarative means the engine, the CLI, and the fixture
tests all iterate the same collection: adding a rule is one decorated
function in torch_rules.py / concurrency_rules.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .engine import ModuleContext, Violation


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    family: str  # "torch" | "concurrency" | "race" | "placement"
    rationale: str
    check: Callable[["ModuleContext"], Iterator["Violation"]] = field(
        repr=False, compare=False, default=None)  # type: ignore[assignment]


RULES: Dict[str, Rule] = {}


def rule(id: str, summary: str, family: str, rationale: str):
    """Register ``check(ctx)`` under a stable rule id."""

    def register(check):
        if id in RULES:
            raise ValueError(f"duplicate rule id {id!r}")
        RULES[id] = Rule(id=id, summary=summary, family=family,
                         rationale=rationale, check=check)
        return check

    return register


def all_rules() -> List[Rule]:
    return [RULES[k] for k in sorted(RULES)]


def get_rule(rule_id: str) -> Rule:
    return RULES[rule_id]


def rules_help_text() -> str:
    """The rule list for the CLI epilog — generated from the registry
    so ``--rule`` help can never drift from the registered rules."""
    lines = ["rule ids (pass to --rule; see analysis/RULES.md):"]
    lines.extend(f"  {r.id:24s} [{r.family}] {r.summary}"
                 for r in all_rules())
    return "\n".join(lines)


def rules_markdown_table() -> str:
    """The docs rule table: the generated block in the port's
    analysis/RULES.md (``--write-rule-docs`` rewrites it, a test pins it
    against drift)."""
    lines = ["| Rule | Family | Summary |", "| --- | --- | --- |"]
    lines.extend(f"| `{r.id}` | {r.family} | {r.summary} |"
                 for r in all_rules())
    return "\n".join(lines)


def iter_checks(only: Iterable[str] = ()) -> List[Rule]:
    wanted = set(only)
    rules = all_rules()
    if wanted:
        unknown = wanted - set(RULES)
        if unknown:
            raise KeyError(f"unknown rule ids: {sorted(unknown)}")
        rules = [r for r in rules if r.id in wanted]
    return rules
