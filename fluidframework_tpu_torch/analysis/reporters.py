"""Reporters: human-readable listing and machine-readable JSON
(counterpart of fluidframework_tpu's analysis/reporters.py).

Both end with the same one-line JSON summary
(``{"violations": N, "baselined": M}``) so a caller can read the verdict
with a tail -1.
"""

from __future__ import annotations

import json
from typing import IO

from .engine import AnalysisResult
from .registry import RULES


def render_human(result: AnalysisResult, stream: IO[str],
                 show_baselined: bool = False) -> None:
    for v in result.violations:
        stream.write(v.render() + "\n")
        if v.line_text:
            stream.write(f"    {v.line_text}\n")
        rule = RULES.get(v.rule_id)
        if rule is not None:
            stream.write(f"    hint: {rule.rationale}\n")
    if show_baselined:
        for v in result.baselined:
            stream.write(f"baselined: {v.render()}\n")
    if result.violations:
        stream.write(
            f"\n{len(result.violations)} new violation(s) across "
            f"{result.files} file(s) "
            f"({len(result.baselined)} baselined, "
            f"{result.suppressed} suppressed inline).\n"
            f"Fix them, add `# fluidlint: disable=RULE — reason`, or "
            f"accept with --write-baseline (and justify in the entry).\n")
    stream.write(json.dumps(result.summary) + "\n")


def render_json(result: AnalysisResult, stream: IO[str]) -> None:
    payload = {
        "files": result.files,
        "suppressed": result.suppressed,
        # Analyzer perf trend: wall time + cache effectiveness ride
        # every JSON report so an incremental (cached) run's speedup is
        # verifiable from the report alone.
        "wall_ms": round(result.wall_ms, 3),
        "race_rules_wall_ms": round(result.race_rules_wall_ms, 3),
        "placement_rules_wall_ms":
            round(result.placement_rules_wall_ms, 3),
        "cache": {"hits": result.cache_hits,
                  "misses": result.cache_misses},
        "summary": result.summary,
        "violations": [
            {"rule": v.rule_id, "path": v.path, "line": v.line,
             "col": v.col, "symbol": v.symbol, "message": v.message,
             "fingerprint": v.fingerprint}
            for v in result.violations],
        "baselined": [
            {"rule": v.rule_id, "path": v.path, "line": v.line,
             "fingerprint": v.fingerprint}
            for v in result.baselined],
    }
    stream.write(json.dumps(payload, indent=2) + "\n")
    stream.write(json.dumps(result.summary) + "\n")
