"""Baseline: accepted pre-existing violations, committed next to the
rules (counterpart of fluidframework_tpu's analysis/baseline.py).

Each entry pins one violation by fingerprint (rule + path + enclosing
symbol + normalized source line — line *numbers* deliberately excluded
so unrelated edits above a finding don't invalidate it) together with a
human-readable reason. The CLI fails on any violation not in the
baseline; ``--write-baseline`` regenerates the file from the current
findings, preserving reasons for fingerprints that survive.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List

from .engine import Violation

DEFAULT_BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"


class Baseline:
    def __init__(self, entries: Iterable[dict] = ()):
        self.entries: List[dict] = list(entries)
        self._by_fp: Dict[str, dict] = {e["fingerprint"]: e
                                        for e in self.entries}

    # -- io ----------------------------------------------------------------
    @classmethod
    def load(cls, path: Path = DEFAULT_BASELINE_PATH) -> "Baseline":
        if not Path(path).exists():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(data.get("entries", []))

    def save(self, path: Path = DEFAULT_BASELINE_PATH) -> None:
        payload = {
            "version": 1,
            "comment": "fluidlint accepted violations; regenerate with "
                       "python -m fluidframework_tpu_torch.analysis "
                       "--write-baseline, then fill in reasons.",
            "entries": sorted(self.entries,
                              key=lambda e: (e["path"], e["rule"],
                                             e["fingerprint"])),
        }
        Path(path).write_text(json.dumps(payload, indent=2) + "\n")

    # -- queries -----------------------------------------------------------
    def contains(self, violation: Violation) -> bool:
        return violation.fingerprint in self._by_fp

    def reason(self, violation: Violation) -> str:
        entry = self._by_fp.get(violation.fingerprint)
        return entry.get("reason", "") if entry else ""

    def __len__(self) -> int:
        return len(self.entries)

    # -- construction ------------------------------------------------------
    def updated_with(self, violations: Iterable[Violation]) -> "Baseline":
        """New baseline covering exactly ``violations``; reasons carry
        over for fingerprints already accepted."""
        entries = []
        for v in violations:
            prior = self._by_fp.get(v.fingerprint, {})
            entries.append({
                "rule": v.rule_id,
                "path": v.path,
                "symbol": v.symbol,
                "line": v.line,  # informational; matching uses fingerprint
                "text": v.line_text,
                "fingerprint": v.fingerprint,
                "reason": prior.get("reason", "TODO: justify or fix"),
            })
        return Baseline(entries)
