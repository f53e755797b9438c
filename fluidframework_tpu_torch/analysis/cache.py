"""Fingerprint-keyed per-module result cache for incremental runs
(counterpart of fluidframework_tpu's analysis/cache.py).

A full run re-analyzes every module of the port; on an incremental run
almost none of them changed. Each module's raw rule output
(pre-baseline: the baseline split is a report-time concern) is cached
under a key that folds in everything that could change it:

* the module's own source digest,
* a digest of the analyzer's OWN sources (rule edits invalidate all),
* the whole-program interface digest (in-place declarations, dataflow
  summaries, the device path, engine.ProgramContext.digest), so editing
  ``serve_step.py``'s IN_PLACE_ARGS re-analyzes ``tpu_sequencer.py``
  even though that file's bytes never changed,
* the active rule filter.

Storage slots key by module path plus the active rule filter, so a
focused run (``--rule``) and the full run share the file without
evicting each other. The cache lives in ``.fluidlint_torch_cache.json``
at the repo root (gitignored); a corrupt or version-skewed file is
silently discarded: the cache can only ever cost a re-analysis, never a
wrong answer.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .engine import REPO_ROOT, Violation

DEFAULT_CACHE_PATH = REPO_ROOT / ".fluidlint_torch_cache.json"
_CACHE_VERSION = 1

_V_FIELDS = ("rule_id", "path", "line", "col", "message", "symbol",
             "line_text")


def _digest(*parts: str) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()[:20]


def rules_digest() -> str:
    """Digest of the analyzer's own sources: editing any rule or the
    engine invalidates every cached module result."""
    here = Path(__file__).resolve().parent
    parts = []
    for f in sorted(here.glob("*.py")):
        try:
            parts.append(f.read_text())
        except OSError:
            parts.append(f.name)
    return _digest(*parts)


class ResultCache:
    def __init__(self, path: Path = DEFAULT_CACHE_PATH):
        self.path = Path(path)
        self.modules: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            data = json.loads(self.path.read_text())
            if data.get("version") == _CACHE_VERSION:
                self.modules = data.get("modules", {})
        except (OSError, ValueError):
            self.modules = {}

    def key(self, source: str, rules_dig: str, program_dig: str,
            only: Tuple[str, ...]) -> str:
        return _digest(source, rules_dig, program_dig, ",".join(only))

    def get(self, path: str, key: str
            ) -> Optional[Tuple[List[Violation], int]]:
        entry = self.modules.get(path)
        if entry is None or entry.get("key") != key:
            self.misses += 1
            return None
        self.hits += 1
        violations = [Violation(**{f: v[f] for f in _V_FIELDS})
                      for v in entry["violations"]]
        return violations, int(entry.get("suppressed", 0))

    def put(self, path: str, key: str, violations: List[Violation],
            suppressed: int) -> None:
        self.modules[path] = {
            "key": key,
            "suppressed": suppressed,
            "violations": [{f: getattr(v, f) for f in _V_FIELDS}
                           for v in violations],
        }
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        payload = {"version": _CACHE_VERSION, "modules": self.modules}
        try:
            fd, tmp = tempfile.mkstemp(
                dir=str(self.path.parent), prefix=".fluidlint_cache.")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)  # atomic: parallel runs can race
        except OSError:
            pass  # cache is best-effort; next run simply re-analyzes
