"""CLI: ``python -m fluidframework_tpu_torch.analysis [paths]``
(counterpart of fluidframework_tpu's analysis/__main__.py; the default
path is the port package).

Exit status 0 iff every finding is suppressed inline or baselined.
The last stdout line is always the one-line JSON summary.

``--changed-only`` scopes REPORTING to the files git says changed
(worktree vs HEAD, plus untracked, in the git repository of the current
directory) while the whole-program layer still spans the given paths:
the fast pre-commit mode. The fingerprint cache
(``.fluidlint_torch_cache.json``, disable with ``--no-cache``) makes warm
full runs skip unchanged modules.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .baseline import Baseline, DEFAULT_BASELINE_PATH
from .engine import REPO_ROOT, analyze_paths
from .registry import (RULES, all_rules, rules_help_text,
                       rules_markdown_table)
from .reporters import render_human, render_json

# Markers bounding the generated rule table in the port's own rule doc
# (--write-rule-docs rewrites the block; a test pins it against drift).
RULE_DOCS_PATH = Path(__file__).resolve().parent / "RULES.md"
RULE_DOCS_BEGIN = "<!-- rule-table:begin (generated; run " \
    "`python -m fluidframework_tpu_torch.analysis --write-rule-docs`) -->"
RULE_DOCS_END = "<!-- rule-table:end -->"


def rewrite_rule_docs(path: Path = RULE_DOCS_PATH) -> str:
    """Replace the marker-bounded rule table with the registry's
    current one; returns the updated document text (written in place)."""
    text = path.read_text()
    begin = text.index(RULE_DOCS_BEGIN) + len(RULE_DOCS_BEGIN)
    end = text.index(RULE_DOCS_END)
    updated = (text[:begin] + "\n" + rules_markdown_table() + "\n"
               + text[end:])
    path.write_text(updated)
    return updated


def _git_changed_paths() -> set:
    """.py paths changed vs HEAD (staged, unstaged, and untracked) in the
    git repository of the current directory, in the analyzer's path form
    (repo-root-relative, or absolute outside the repo). Raises on git
    failure: a broken diff must not silently become an empty (vacuously
    clean) scope."""
    from .engine import _rel_path

    def git(*cmd) -> str:
        proc = subprocess.run(["git", *cmd], capture_output=True,
                              text=True, timeout=30)
        if proc.returncode != 0:
            raise RuntimeError(
                f"git {' '.join(cmd)} failed: {proc.stderr.strip()}")
        return proc.stdout

    top = Path(git("rev-parse", "--show-toplevel").strip())
    out = set()
    for cmd in (("diff", "--name-only", "HEAD", "--"),
                ("ls-files", "--others", "--exclude-standard")):
        out.update(_rel_path(top / line.strip())
                   for line in git(*cmd).splitlines()
                   if line.strip().endswith(".py"))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fluidframework_tpu_torch.analysis",
        description="fluidlint for the port: torch device-path, "
                    "concurrency, lifecycle, race & placement analyzer",
        epilog=rules_help_text(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*",
                        default=[str(REPO_ROOT / "fluidframework_tpu_torch")],
                        help="files/dirs to analyze (default: the package)")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human")
    parser.add_argument("--baseline", type=Path,
                        default=DEFAULT_BASELINE_PATH,
                        help="baseline file (default: analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring the baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept all current findings into the baseline "
                             "file and exit 0")
    parser.add_argument("--show-baselined", action="store_true",
                        help="also list baselined findings (human format)")
    parser.add_argument("--rule", action="append", default=[],
                        metavar="RULE_ID",
                        help="run only these rule ids (registry-listed "
                             "below)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--write-rule-docs", action="store_true",
                        help="regenerate the rule table in "
                             "analysis/RULES.md from the registry and "
                             "exit")
    parser.add_argument("--changed-only", action="store_true",
                        help="report only on files git sees as changed "
                             "(worktree vs HEAD + untracked); the "
                             "whole-program context still spans the "
                             "given paths")
    parser.add_argument("--no-cache", action="store_true",
                        help="disable the per-module result cache")
    parser.add_argument("--cache-file", type=Path, default=None,
                        help="cache file path (default: "
                             ".fluidlint_torch_cache.json at the repo "
                             "root)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:22s} [{r.family}] {r.summary}")
        return 0

    if args.write_rule_docs:
        try:
            rewrite_rule_docs()
        except (OSError, ValueError) as exc:
            print(f"error: could not rewrite rule docs: {exc}",
                  file=sys.stderr)
            return 2
        print(f"wrote {len(RULES)} rules to {RULE_DOCS_PATH}")
        return 0

    unknown = set(args.rule) - set(RULES)
    if unknown:
        parser.error(f"unknown rule id(s): {', '.join(sorted(unknown))} "
                     f"(see --list-rules)")
    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        # A typo'd path must never turn the hard gate into a vacuous
        # pass that still prints a healthy-looking summary line.
        parser.error(f"path(s) do not exist: {', '.join(missing)}")

    restrict = None
    if args.changed_only:
        try:
            changed = _git_changed_paths()
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            print(f"error: --changed-only could not read the git diff: "
                  f"{exc}", file=sys.stderr)
            return 2
        restrict = changed
        if not changed:
            print("--changed-only: no changed .py files; nothing to "
                  "analyze")
            print(json.dumps({"violations": 0, "baselined": 0}))
            return 0

    cache = None
    if not args.no_cache and not args.write_baseline:
        from .cache import DEFAULT_CACHE_PATH, ResultCache
        cache = ResultCache(args.cache_file or DEFAULT_CACHE_PATH)

    baseline = None if args.no_baseline else Baseline.load(args.baseline)
    result = analyze_paths(args.paths, baseline=baseline, only=args.rule,
                           cache=cache, restrict=restrict)

    if args.write_baseline:
        prior = baseline if baseline is not None \
            else Baseline.load(args.baseline)
        current = result.violations + result.baselined
        merged = prior.updated_with(current)
        # Entries outside this run's scope (file not analyzed, or rule
        # filtered out by --rule) survive untouched — a scoped
        # --write-baseline must never discard curated acceptances; only
        # a full default run retires stale entries.
        from .engine import _rel_path, iter_python_files
        analyzed = {_rel_path(f) for f in iter_python_files(args.paths)}
        if restrict is not None:
            # --changed-only: only the restricted files actually
            # REPORTED, so only their entries may be retired — the
            # unchanged files' curated acceptances are out of scope.
            analyzed &= restrict
        active = set(args.rule) or set(RULES)
        merged.entries.extend(
            e for e in prior.entries
            if e["path"] not in analyzed or e["rule"] not in active)
        merged = Baseline(merged.entries)
        merged.save(args.baseline)
        print(f"wrote {len(merged)} entries to {args.baseline} "
              f"({len(current)} from this run)")
        return 0

    if result.files == 0:
        if restrict is not None:
            # Changed files exist, just none inside the analyzed paths:
            # a legitimately clean scoped run, not a vacuous pass.
            print("--changed-only: no changed files within the analyzed "
                  "paths")
            print(json.dumps({"violations": 0, "baselined": 0}))
            return 0
        print("error: no Python files matched the given paths; "
              "refusing to report a vacuous pass", file=sys.stderr)
        return 2

    if args.format == "json":
        render_json(result, sys.stdout)
    else:
        render_human(result, sys.stdout,
                     show_baselined=args.show_baselined)
    return 1 if result.violations else 0


if __name__ == "__main__":
    sys.exit(main())
