"""fluidlint for the port (fluidframework_tpu_torch/analysis): the registry,
the 26 rule ids with a firing and a quiet fixture each, the CC* family
against the JAX package's analyzer on shared fixtures, the device-path
scope, the CLI (seeded findings, baselines, the cache, --changed-only in a
repository of its own), and the gate: the port's tree is clean against its
baseline, and every baseline entry and inline suppression gives a reason.
"""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from fluidframework_tpu import analysis as jax_analysis
from fluidframework_tpu_torch import analysis
from fluidframework_tpu_torch.analysis import (Baseline, analyze_paths,
                                               analyze_source, engine)
from fluidframework_tpu_torch.analysis.__main__ import (RULE_DOCS_BEGIN,
                                                        RULE_DOCS_END,
                                                        RULE_DOCS_PATH)
from fluidframework_tpu_torch.analysis.cache import ResultCache
from fluidframework_tpu_torch.analysis.registry import rules_markdown_table
from torch_lint_fixtures import FIXTURES, harvest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "fluidframework_tpu_torch"
CC_RULES = sorted(r.id for r in analysis.all_rules()
                  if r.family == "concurrency")


def lint(src, rule=None, path="<memory>"):
    return analyze_source(textwrap.dedent(src), path=path,
                          only=[rule] if rule else ())


def rule_ids(src, rule=None):
    return [v.rule_id for v in lint(src, rule)]


@pytest.fixture(scope="module")
def port_run():
    """The whole-tree analysis, once for this file."""
    return analyze_paths([str(PORT)], baseline=Baseline.load())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_ids_are_the_jax_packages(self):
        port = {r.id for r in analysis.all_rules()}
        assert port == {r.id for r in jax_analysis.all_rules()}
        assert len(port) == 26

    def test_families(self):
        fam = {}
        for r in analysis.all_rules():
            fam.setdefault(r.family, set()).add(r.id)
        assert {k: len(v) for k, v in fam.items()} == {
            "torch": 10, "concurrency": 7, "race": 4, "placement": 5}

    def test_rule_docs_are_current(self):
        text = RULE_DOCS_PATH.read_text()
        begin = text.index(RULE_DOCS_BEGIN) + len(RULE_DOCS_BEGIN)
        assert text[begin:text.index(RULE_DOCS_END)].strip() == \
            rules_markdown_table()


# ---------------------------------------------------------------------------
# one firing and one quiet fixture per rule id
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_fixture_fires(rule_id):
    got = rule_ids(FIXTURES[rule_id][0], rule_id)
    assert got and set(got) == {rule_id}


@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_fixture_stays_quiet(rule_id):
    assert rule_ids(FIXTURES[rule_id][1], rule_id) == []


def test_every_rule_has_fixtures():
    assert set(FIXTURES) == {r.id for r in analysis.all_rules()}


# ---------------------------------------------------------------------------
# the CC* family against the JAX analyzer on shared fixtures
# ---------------------------------------------------------------------------

SHARED_CC = harvest(REPO / "tests" / "test_static_analysis.py") + [
    textwrap.dedent(src) for rid in CC_RULES for src in FIXTURES[rid]]


def _triples(analyze, src):
    return [(v.rule_id, v.line, v.symbol, v.message)
            for v in analyze(src, only=CC_RULES)]


@pytest.mark.parametrize("index", range(len(SHARED_CC)))
def test_cc_findings_equal_the_jax_analyzer(index):
    src = SHARED_CC[index]
    assert _triples(analyze_source, src) == \
        _triples(jax_analysis.analyze_source, src)


def test_cc_shared_fixtures_fire():
    fired = {v[0] for src in SHARED_CC
             for v in _triples(analyze_source, src)}
    assert fired == set(CC_RULES)


# ---------------------------------------------------------------------------
# the torch rules
# ---------------------------------------------------------------------------

class TestTorchRules:
    def test_boolean_mask_index_is_a_traced_branch(self):
        assert rule_ids("""
            import torch

            # fluidlint: device-root
            def live(state: torch.Tensor):
                keep = state.length > 0
                return state.length[keep]
        """, "TRACED_BRANCH") == ["TRACED_BRANCH"]

    def test_masked_select_by_where_is_quiet(self):
        assert rule_ids("""
            import torch

            # fluidlint: device-root
            def live(state: torch.Tensor):
                keep = state.length > 0
                return torch.where(keep, state.length, 0)
        """, "TRACED_BRANCH") == []

    def test_sync_in_a_step_loop_is_scan_host_callback(self):
        src = """
            import torch

            # fluidlint: device-root
            def scan(state: torch.Tensor, ops: torch.Tensor):
                for t in range(ops.shape[1]):
                    if bool(ops[:, t].any()):
                        state = state + ops[:, t]
                return state
        """
        assert rule_ids(src, "SCAN_HOST_CALLBACK") == ["SCAN_HOST_CALLBACK"]
        assert rule_ids(src, "HOST_SYNC") == []

    def test_nested_def_of_a_root_is_in_scope(self):
        assert rule_ids("""
            import torch

            # fluidlint: device-root
            def make_step():
                def step(state: torch.Tensor):
                    return state.sum().item()
                return step
        """, "HOST_SYNC") == ["HOST_SYNC"]

    def test_callee_of_a_root_is_in_scope_and_others_are_not(self):
        src = """
            import torch

            def helper(state: torch.Tensor):
                return state.cpu()

            def host_tool(state: torch.Tensor):
                return state.cpu()

            # fluidlint: device-root
            def step(state: torch.Tensor):
                return helper(state)
        """
        got = lint(src, "HOST_SYNC")
        assert [v.symbol for v in got] == ["helper"]

    def test_plain_reference_is_outside_the_closure(self):
        assert rule_ids("""
            import torch

            def apply_plain(state: torch.Tensor):
                return state.cpu()

            # fluidlint: device-root
            def apply(state: torch.Tensor):
                if state.device.type == "cpu":
                    return apply_plain(state)
                return state * 2
        """, "HOST_SYNC") == []

    def test_launching_callee_in_a_step_loop_is_a_retrace_hazard(self):
        assert rule_ids("""
            import torch

            def _apply_one(state: torch.Tensor, col: torch.Tensor):
                return torch.maximum(state, col)

            # fluidlint: device-root
            def _scan(state: torch.Tensor, ops: torch.Tensor):
                for t in range(ops.shape[-1]):
                    state = _apply_one(state, ops[:, t])
                return state
        """, "RETRACE_HAZARD") == ["RETRACE_HAZARD"]

    def test_keep_twin_is_suppressed_like_the_port_does(self):
        assert rule_ids("""
            IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

            def apply_ops_paged(pool, ops):
                return pool

            # fluidlint: device-root
            def apply_ops_paged_keep(pool, ops):
                # fluidlint: disable=MISSING_DONATE — the non-mutating
                # twin: a retry re-applies from the pre-window pool
                return apply_ops_paged(pool.clone(), ops)
        """, "MISSING_DONATE") == []


class TestCanonicalDtypes:
    def test_constant_names_torch_dtypes(self):
        from fluidframework_tpu_torch.mergetree.constants import \
            CANONICAL_DEVICE_DTYPES
        assert CANONICAL_DEVICE_DTYPES == ("int32", "bool", "int64")
        assert all(isinstance(getattr(torch, n), torch.dtype)
                   for n in CANONICAL_DEVICE_DTYPES)

    def test_int16_wire_is_not_canonical(self):
        assert rule_ids("""
            import torch

            # fluidlint: device-root
            def narrow(x: torch.Tensor):
                return x.to(torch.int16)
        """, "DTYPE_DRIFT") == ["DTYPE_DRIFT"]


# ---------------------------------------------------------------------------
# the device path
# ---------------------------------------------------------------------------

class TestDevicePath:
    @pytest.fixture(scope="class")
    def reached(self):
        contexts = []
        for f in engine.iter_python_files([str(PORT)]):
            src = f.read_text()
            contexts.append(engine.ModuleContext(engine._rel_path(f), src,
                                                 ast.parse(src)))
        return engine.ProgramContext(contexts).device_path()

    def test_every_root_is_a_def_of_the_port(self, reached):
        assert set(engine.DEVICE_PATH_ROOTS) <= set(reached)

    def test_closure_reaches_the_kernel_wrappers(self, reached):
        p = "fluidframework_tpu_torch."
        for q in ("mergetree.kernel:_launch", "mergetree.kernel:_scan_ops",
                  "mergetree.kernel:gather_pages",
                  "mergetree.pallas_apply:_launch",
                  "mergetree.pallas_ops:_launch",
                  "server.ticket_kernel:_launch",
                  "server.lww_kernel:_apply_one",
                  "server.serve_step:_serve_window_impl",
                  "mergetree.fused_sp:apply_ops_fused_sp"):
            assert p + q in reached, q

    def test_closure_stops_at_plain_references_and_host_modules(self,
                                                                reached):
        assert not [q for q in reached if q.endswith("_plain")]
        assert not [q for q in reached
                    if q.startswith(engine.DEVICE_PATH_STOP_MODULES)]

    def test_scope_is_stated_in_the_engine_docstring(self):
        doc = engine.__doc__
        for word in ("DEVICE_PATH_ROOTS", "_plain", "device-root"):
            assert word in doc


class TestInPlaceTables:
    @pytest.mark.parametrize("module", [
        "fluidframework_tpu_torch.mergetree.kernel",
        "fluidframework_tpu_torch.mergetree.paging",
        "fluidframework_tpu_torch.server.serve_step"])
    def test_entries_name_callables_and_real_positions(self, module):
        import importlib
        import inspect
        mod = importlib.import_module(module)
        assert mod.IN_PLACE_ARGS
        for name, positions in mod.IN_PLACE_ARGS.items():
            fn = getattr(mod, name)
            params = list(inspect.signature(fn).parameters)
            assert all(p < len(params) for p in positions), name
            keep = getattr(mod, f"{name}_keep", None)
            assert keep is None or keep.__name__ not in mod.IN_PLACE_ARGS

    def test_signatures_resolve_across_modules(self):
        from fluidframework_tpu_torch.analysis.callgraph import \
            ProgramIndex, module_name_for_path
        rels = ["fluidframework_tpu_torch/mergetree/kernel.py",
                "fluidframework_tpu_torch/server/serve_step.py"]
        index = ProgramIndex([(module_name_for_path(r),
                               ast.parse((REPO / r).read_text()), r)
                              for r in rels])
        serve = "fluidframework_tpu_torch.server.serve_step"
        kern = "fluidframework_tpu_torch.mergetree.kernel"
        assert index.lookup(serve, "serve_megakernel").donation.positions \
            == {1}
        assert index.lookup(kern, "apply_ops_paged").donation.positions \
            == {0}
        assert index.lookup(serve, "serve_megakernel_keep") is None or \
            index.lookup(serve, "serve_megakernel_keep").donation is None
        assert index.lookup(kern, "apply_ops_paged_keep").donation is None


# ---------------------------------------------------------------------------
# the gate over the port's tree
# ---------------------------------------------------------------------------

class TestPortGate:
    def test_tree_is_clean_against_the_baseline(self, port_run):
        assert port_run.violations == [], "\n".join(
            v.render() for v in port_run.violations)

    def test_every_baseline_entry_still_matches(self, port_run):
        matched = {v.fingerprint for v in port_run.baselined}
        assert {e["fingerprint"] for e in Baseline.load().entries} == \
            matched

    def test_every_baseline_entry_gives_a_reason(self):
        for e in Baseline.load().entries:
            assert len(e["reason"]) > 40 and "TODO" not in e["reason"], e

    def test_every_inline_suppression_gives_a_reason(self):
        found = 0
        for f in PORT.rglob("*.py"):
            for line in f.read_text().splitlines():
                m = engine.SUPPRESS_RE.search(line)
                if m is None or "fluidlint: disable" not in line:
                    continue
                found += 1
                assert m.group("rules") and (m.group("reason") or
                                             "").strip(), (f, line)
        assert found >= 10

    def test_suppressed_findings_are_counted(self, port_run):
        assert port_run.suppressed >= 10
        assert port_run.files >= 190


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(cwd)})


# One seeded finding per family, placed where the family's scope holds.
SEEDED = {
    "torch": "HOST_SYNC", "concurrency": "SWALLOWED_EXCEPTION",
    "lifecycle": "USE_AFTER_DONATE", "race": "SHARED_STATE_NO_LOCK",
    "placement": "PSPEC_MISMATCH",
}


def _seed_tree(root: Path, rule_id: str, which: int = 0) -> Path:
    pkg = root / "fluidframework_tpu_torch" / "server"
    pkg.mkdir(parents=True, exist_ok=True)
    f = pkg / "seeded.py"
    f.write_text(textwrap.dedent(FIXTURES[rule_id][which]))
    return f


class TestCli:
    @pytest.mark.parametrize("family", sorted(SEEDED))
    def test_seeded_finding_of_each_family_fails(self, tmp_path, family):
        rule_id = SEEDED[family]
        _seed_tree(tmp_path, rule_id)
        proc = cli(str(tmp_path), "--no-cache", "--no-baseline")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert rule_id in proc.stdout
        assert json.loads(proc.stdout.splitlines()[-1])["violations"] >= 1

    def test_quiet_tree_passes(self, tmp_path):
        _seed_tree(tmp_path, "HOST_SYNC", which=1)
        proc = cli(str(tmp_path), "--no-cache", "--no-baseline")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert json.loads(proc.stdout.splitlines()[-1]) == {
            "violations": 0, "baselined": 0}

    def test_list_rules(self):
        proc = cli("--list-rules")
        assert proc.returncode == 0
        assert len(proc.stdout.splitlines()) == 26

    def test_unknown_rule_and_missing_path_are_errors(self, tmp_path):
        assert cli("--rule", "NOPE").returncode == 2
        assert cli(str(tmp_path / "absent")).returncode == 2

    def test_rule_filter(self, tmp_path):
        _seed_tree(tmp_path, "HOST_SYNC")
        proc = cli(str(tmp_path), "--no-cache", "--rule",
                   "SWALLOWED_EXCEPTION")
        assert proc.returncode == 0, proc.stdout

    def test_write_baseline_then_clean(self, tmp_path):
        _seed_tree(tmp_path, "SWALLOWED_EXCEPTION")
        base = tmp_path / "baseline.json"
        assert cli(str(tmp_path), "--baseline", str(base),
                   "--write-baseline").returncode == 0
        entries = json.loads(base.read_text())["entries"]
        assert [e["rule"] for e in entries] == ["SWALLOWED_EXCEPTION"]
        proc = cli(str(tmp_path), "--no-cache", "--baseline", str(base))
        assert proc.returncode == 0
        assert json.loads(proc.stdout.splitlines()[-1]) == {
            "violations": 0, "baselined": 1}

    def test_changed_only_in_a_repository_of_its_own(self, tmp_path):
        def git(*args):
            subprocess.run(["git", *args], cwd=tmp_path, check=True,
                           capture_output=True, timeout=60)
        git("init", "-q")
        git("config", "user.email", "lint@example.com")
        git("config", "user.name", "lint")
        clean = _seed_tree(tmp_path, "SWALLOWED_EXCEPTION", which=1)
        git("add", "-A")
        git("commit", "-q", "-m", "clean")
        proc = cli(str(tmp_path), "--changed-only", "--no-cache",
                   "--no-baseline", cwd=tmp_path)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "no changed .py files" in proc.stdout
        (clean.parent / "fresh.py").write_text(textwrap.dedent(
            FIXTURES["SWALLOWED_EXCEPTION"][0]))
        proc = cli(str(tmp_path), "--changed-only", "--no-cache",
                   "--no-baseline", cwd=tmp_path)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "fresh.py" in proc.stdout and "seeded.py" not in proc.stdout

    def test_changed_only_outside_git_is_an_error(self, tmp_path):
        _seed_tree(tmp_path, "HOST_SYNC", which=1)
        proc = cli(str(tmp_path), "--changed-only", cwd=tmp_path)
        assert proc.returncode == 2
        assert "--changed-only could not read the git diff" in proc.stderr


class TestCache:
    def test_hits_and_misses(self, tmp_path):
        for i, rid in enumerate(("HOST_SYNC", "SWALLOWED_EXCEPTION")):
            (tmp_path / f"m{i}.py").write_text(
                textwrap.dedent(FIXTURES[rid][0]))
        cache_file = tmp_path / "cache.json"
        first = analyze_paths([str(tmp_path)],
                              cache=ResultCache(cache_file))
        second = analyze_paths([str(tmp_path)],
                               cache=ResultCache(cache_file))
        assert (first.cache_hits, first.cache_misses) == (0, 2)
        assert (second.cache_hits, second.cache_misses) == (2, 0)
        assert [v.fingerprint for v in first.violations] == \
            [v.fingerprint for v in second.violations]
        (tmp_path / "m1.py").write_text("x = 1\n")
        third = analyze_paths([str(tmp_path)],
                              cache=ResultCache(cache_file))
        assert third.cache_misses >= 1

    def test_cli_cache_file(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "m.py").write_text(textwrap.dedent(
            FIXTURES["SWALLOWED_EXCEPTION"][1]))
        cache_file = tmp_path / "c.json"
        runs = [json.loads("\n".join(cli(
            str(src), "--format", "json", "--cache-file",
            str(cache_file)).stdout.splitlines()[:-1]))["cache"]
            for _ in range(2)]
        assert runs == [{"hits": 0, "misses": 1}, {"hits": 1, "misses": 0}]

    def test_default_cache_file_is_the_ports_own(self):
        from fluidframework_tpu_torch.analysis.cache import \
            DEFAULT_CACHE_PATH
        assert DEFAULT_CACHE_PATH.name == ".fluidlint_torch_cache.json"
        assert ".fluidlint_torch_cache.json" in \
            (REPO / ".gitignore").read_text().split()
