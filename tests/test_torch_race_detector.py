"""The port's lockset race detection (analysis/concurrency_model.py,
race_rules.py) and its runtime verifier (testing/lockcheck.py).

The race family carries over from the JAX package unchanged, so the JAX
package's own fixtures go through both analyzers and must give identical
findings; the port's scope is its own server/ and telemetry/ tiers; the
guard map static_guards infers for the port's MergeLaneStore equals the
JAX package's for its own; and the runtime verifier catches a seeded
unguarded access, including one the static pass was suppressed on.
"""

import textwrap
import threading
from pathlib import Path

import pytest

from fluidframework_tpu import analysis as jax_analysis
from fluidframework_tpu_torch.analysis import analyze_paths, analyze_source
from fluidframework_tpu_torch.analysis import concurrency_model as port_model
from torch_lint_fixtures import FIXTURES, harvest

REPO = Path(__file__).resolve().parents[1]
RACE_RULES = ["ATOMICITY_CHECK_THEN_ACT", "LOCK_ORDER_INVERSION",
              "SHARED_STATE_NO_LOCK", "SIGNAL_WITHOUT_LOCK"]


SHARED = harvest(REPO / "tests" / "test_race_detector.py") + [
    textwrap.dedent(src) for rid in RACE_RULES for src in FIXTURES[rid]]


def _findings(analyze, src):
    return [(v.rule_id, v.line, v.symbol, v.message)
            for v in analyze(src, only=RACE_RULES)]


@pytest.mark.parametrize("index", range(len(SHARED)))
def test_race_findings_equal_the_jax_analyzer(index):
    src = SHARED[index]
    assert _findings(analyze_source, src) == \
        _findings(jax_analysis.analyze_source, src)


def test_shared_fixtures_fire_every_race_rule():
    fired = {f[0] for src in SHARED for f in _findings(analyze_source, src)}
    assert fired == set(RACE_RULES)


class TestScope:
    def test_prefixes_are_the_ports_tiers(self):
        assert port_model.in_scope(
            "fluidframework_tpu_torch/server/tpu_sequencer.py")
        assert port_model.in_scope(
            "fluidframework_tpu_torch/telemetry/counters.py")
        assert not port_model.in_scope(
            "fluidframework_tpu_torch/mergetree/kernel.py")

    def test_no_prefix_of_one_package_matches_the_other(self):
        from fluidframework_tpu.analysis import concurrency_model as jm
        assert not port_model.in_scope(
            "fluidframework_tpu/server/tpu_sequencer.py")
        assert not jm.in_scope(
            "fluidframework_tpu_torch/server/tpu_sequencer.py")

    def test_out_of_scope_path_is_quiet(self):
        src = textwrap.dedent(FIXTURES["SHARED_STATE_NO_LOCK"][0])
        assert analyze_source(
            src, path="fluidframework_tpu_torch/dds/map.py",
            only=RACE_RULES) == []
        assert [v.rule_id for v in analyze_source(
            src, path="fluidframework_tpu_torch/server/store.py",
            only=["SHARED_STATE_NO_LOCK"])]


class TestStaticGuards:
    def test_merge_lane_store_guard_maps_are_equal(self):
        from fluidframework_tpu.server.tpu_sequencer import \
            MergeLaneStore as JaxStore
        from fluidframework_tpu.testing.lockcheck import \
            static_guards as jax_guards
        from fluidframework_tpu_torch.server.tpu_sequencer import \
            MergeLaneStore
        from fluidframework_tpu_torch.testing.lockcheck import static_guards
        port = static_guards(MergeLaneStore)
        assert port == jax_guards(JaxStore)
        for attr in ("_snap_cache", "_extract_guards",
                     "last_summarized_gen"):
            assert port[attr] == "_guard_lock"

    def test_guards_are_memoized_copies(self):
        from fluidframework_tpu_torch.server.tpu_sequencer import \
            MergeLaneStore
        from fluidframework_tpu_torch.testing.lockcheck import static_guards
        a = static_guards(MergeLaneStore)
        a["x"] = "y"
        assert "x" not in static_guards(MergeLaneStore)


class _Store:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def good(self):
        with self._lock:
            self.items.append(1)

    def bad(self):
        self.items.append(2)


class TestRuntimeLockcheck:
    def test_records_unguarded_access_with_thread(self):
        from fluidframework_tpu_torch.testing.lockcheck import (
            LockDisciplineError, instrument)
        s = _Store()
        check = instrument(s, {"items": "_lock"})
        try:
            s.good()
            assert check.violations == []
            t = threading.Thread(target=s.bad, name="drain")
            t.start()
            t.join(10)
            assert not t.is_alive()
            assert len(check.violations) == 1
            v = check.violations[0]
            assert (v.attr, v.lock, v.thread) == ("items", "_lock",
                                                  "drain")
            assert "test_torch_race_detector.py" in v.site
            with pytest.raises(LockDisciplineError):
                check.assert_clean()
        finally:
            check.uninstrument()
        s.bad()  # uninstrumented: no further recording
        assert len(check.violations) == 1

    def test_strict_mode_raises_at_the_access(self):
        from fluidframework_tpu_torch.testing.lockcheck import (
            LockDisciplineError, instrument)
        s = _Store()
        check = instrument(s, {"items": "_lock"}, strict=True)
        try:
            with pytest.raises(LockDisciplineError):
                s.bad()
        finally:
            check.uninstrument()

    def test_catches_violation_the_static_pass_was_suppressed_on(self):
        src = """
            import threading

            class Stats:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.counts = {}

                def start(self):
                    threading.Thread(target=self._bump).start()

                def _bump(self):
                    # fluidlint: disable=SHARED_STATE_NO_LOCK — claimed
                    # monotonic; lockcheck keeps this claim honest
                    self.counts["n"] = 1

                def read(self):
                    with self._lock:
                        return dict(self.counts)
        """
        assert analyze_source(textwrap.dedent(src),
                              only=["SHARED_STATE_NO_LOCK"]) == []

        from fluidframework_tpu_torch.testing.lockcheck import instrument

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.counts = {}

            def _bump(self):
                self.counts["n"] = 1

        s = Stats()
        check = instrument(s, {"counts": "_lock"})
        try:
            t = threading.Thread(target=s._bump)
            t.start()
            t.join(10)
            assert len(check.violations) == 1
        finally:
            check.uninstrument()

    def test_seeded_unguarded_access_on_the_real_store(self):
        """A seeded unguarded read of the summarize cache on the port's
        MergeLaneStore, from a second thread, is caught under the
        statically inferred guards."""
        from fluidframework_tpu_torch.server.tpu_sequencer import (
            MergeLaneStore)
        from fluidframework_tpu_torch.testing.lockcheck import (
            instrument, static_guards)
        store = MergeLaneStore(device="cpu")
        check = instrument(store, static_guards(MergeLaneStore))
        try:
            assert store.cached_blob_count() == 0     # guarded: clean
            assert check.violations == []
            t = threading.Thread(target=lambda: len(store._snap_cache),
                                 name="seeded")
            t.start()
            t.join(10)
            assert [(v.attr, v.thread) for v in check.violations] == [
                ("_snap_cache", "seeded")]
        finally:
            check.uninstrument()

    def test_instrument_without_guards_is_an_error(self):
        from fluidframework_tpu_torch.testing.lockcheck import instrument

        class Bare:
            pass

        with pytest.raises(ValueError):
            instrument(Bare())


class TestTreeGate:
    def test_port_server_tier_has_no_race_finding(self):
        res = analyze_paths(
            [str(REPO / "fluidframework_tpu_torch" / d)
             for d in ("server", "telemetry")], only=RACE_RULES)
        assert res.violations == [], "\n".join(
            v.render() for v in res.violations)
