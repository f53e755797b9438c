"""The port's capacity soak (fluidframework_tpu_torch/capacity/): the
mirror of the 27 cases of tests/test_capacity.py, held against the JAX
package with zero tolerance, and the chaos-on capacity grade of a
TpuLocalServer(device="cpu") fleet at testing/capacity_runs.CAPACITY_SMALL
against the committed JAX golden.

Every workload trace, fault trace, soak fingerprint, final_seq,
stream_digests and grade is compared with the JAX package's for the same
seeds, on the scalar LocalServer here and on TpuLocalServer in
TestCapacityGrade (whose JAX side is the golden file, which
tests/test_torch_capacity_golden.py rebuilds from the JAX package)."""

from __future__ import annotations

import json
import random
import urllib.request
from importlib import import_module

import pytest
import torch

import fluidframework_tpu.capacity as jcap
import fluidframework_tpu_torch.capacity as tcap
from fluidframework_tpu.testing import faultinject as jfi
from fluidframework_tpu_torch.capacity import (
    BURSTY,
    CapacityGrader,
    OnOffArrivals,
    OpMix,
    PoissonArrivals,
    WorkloadModel,
    WorkloadSpec,
    ZipfPopularity,
    attribute_bottleneck,
    closed_loop_schedule,
)
from fluidframework_tpu_torch.server.monitor import ServiceMonitor
from fluidframework_tpu_torch.server.readpath import ArtifactPushThrough
from fluidframework_tpu_torch.telemetry import counters as port_counters
from fluidframework_tpu_torch.testing import capacity_runs, golden
from fluidframework_tpu_torch.testing import faultinject

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global: the flushes
    these tests drive must not reach another file's /health verdict on
    the same worker (tests/conftest.py resets only the JAX package's)."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


def _drain(model, ticks: int):
    return [model.tick() for _ in range(ticks)]


def _jax_model(**kw):
    return jcap.WorkloadModel(jcap.WorkloadSpec(**kw))


class TestWorkloadDeterminism:
    def test_same_seed_same_stream_and_fingerprint(self):
        a = WorkloadModel(WorkloadSpec(seed=7))
        b = WorkloadModel(WorkloadSpec(seed=7))
        ref = _jax_model(seed=7)
        pa, pb, pr = _drain(a, 30), _drain(b, 30), _drain(ref, 30)
        assert [(p.writes, p.reads) for p in pa] \
            == [(p.writes, p.reads) for p in pb]
        assert [[(e.offset, e.document, e.writer) for e in p.writes]
                for p in pa] == [[(e.offset, e.document, e.writer)
                                  for e in p.writes] for p in pr]
        assert a.trace == b.trace == ref.trace
        assert a.fingerprint() == b.fingerprint() == ref.fingerprint()

    def test_seed_sensitivity(self):
        a = WorkloadModel(WorkloadSpec(seed=7))
        b = WorkloadModel(WorkloadSpec(seed=8))
        _drain(a, 30), _drain(b, 30)
        assert a.fingerprint() != b.fingerprint()

    def test_bursty_model_is_deterministic_too(self):
        a = WorkloadModel(WorkloadSpec(seed=3, arrival=BURSTY))
        b = WorkloadModel(WorkloadSpec(seed=3, arrival=BURSTY))
        ref = _jax_model(seed=3, arrival=jcap.BURSTY)
        _drain(a, 40), _drain(b, 40), _drain(ref, 40)
        assert a.fingerprint() == b.fingerprint() == ref.fingerprint()

    def test_scaled_changes_rate_not_shape(self):
        spec = WorkloadSpec(seed=1, writer_rate_per_s=100.0)
        up = spec.scaled(3.0)
        assert up.writer_rate_per_s == 300.0
        assert up.reader_rate_per_s == spec.reader_rate_per_s * 3.0
        assert (up.documents, up.seed, up.tick_s) \
            == (spec.documents, spec.seed, spec.tick_s)
        ref = jcap.WorkloadSpec(seed=1, writer_rate_per_s=100.0).scaled(3.0)
        assert vars(up) == vars(ref)


class TestArrivalShapes:
    def test_poisson_mean_tracks_rate(self):
        counts = {}
        for name, cls in (("port", PoissonArrivals),
                          ("jax", jcap.PoissonArrivals)):
            rng = random.Random(11)
            arr = cls(rate_per_s=400.0)
            counts[name] = [arr.draw_count(rng, 0.02) for _ in range(2000)]
        mean = sum(counts["port"]) / 2000.0
        assert 7.0 <= mean <= 9.0  # lam = 8 per tick
        assert counts["port"] == counts["jax"]

    def test_onoff_long_run_mean_tracks_rate(self):
        counts = {}
        for name, cls in (("port", OnOffArrivals),
                          ("jax", jcap.OnOffArrivals)):
            rng = random.Random(13)
            arr = cls(rate_per_s=400.0)
            counts[name] = [arr.draw_count(rng, 0.02) for _ in range(6000)]
        mean = sum(counts["port"]) / 6000.0
        assert 6.5 <= mean <= 9.5  # duty-normalized back to lam = 8
        assert counts["port"] == counts["jax"]

    def test_onoff_actually_bursts(self):
        rng = random.Random(13)
        arr = OnOffArrivals(rate_per_s=400.0)
        counts = [arr.draw_count(rng, 0.02) for _ in range(2000)]
        assert counts.count(0) > 300         # real off periods
        assert max(counts) > 12              # on-period rate > mean rate

    def test_zipf_is_monotone_and_hot_headed(self):
        draws = {}
        for name, cls in (("port", ZipfPopularity),
                          ("jax", jcap.ZipfPopularity)):
            rng = random.Random(5)
            pop = cls(16, 1.0)
            draws[name] = [pop.draw(rng) for _ in range(20000)]
        counts = [draws["port"].count(i) for i in range(16)]
        # Rank 0 carries ~1/H(16) = ~29.6% of draws under s=1.
        assert 0.25 <= counts[0] / 20000.0 <= 0.35
        assert counts[0] > counts[4] > counts[12]
        assert draws["port"] == draws["jax"]

    def test_zipf_s0_is_uniform(self):
        rng = random.Random(5)
        pop = ZipfPopularity(8, 0.0)
        counts = [0] * 8
        for _ in range(16000):
            counts[pop.draw(rng)] += 1
        for c in counts:
            assert 1700 <= c <= 2300


class TestLoadTestFold:
    def test_opmix_matches_inline_choices_consumption(self):
        weights = (4, 3, 1, 2)
        a, b, c = random.Random(21), random.Random(21), random.Random(21)
        mix, ref = OpMix(weights), jcap.OpMix(weights)
        kinds_new = [mix.draw(a) for _ in range(200)]
        kinds_old = [b.choices(("map", "insert", "remove", "counter"),
                               weights=weights)[0] for _ in range(200)]
        assert kinds_new == kinds_old == [ref.draw(c) for _ in range(200)]

    def test_closed_loop_schedule_nesting_order(self):
        triples = list(closed_loop_schedule(2, 2, 2))
        assert triples == [
            (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
        assert triples == list(jcap.closed_loop_schedule(2, 2, 2))


SMALL_WORKLOAD = dict(documents=4, writers_per_document=2, seed=17,
                      writer_rate_per_s=300.0, reader_rate_per_s=80.0,
                      tick_s=0.02)
SMALL_FLEET = dict(partitions=2, broadcaster_shards=2,
                   subscribers_per_document=1, ticks=24, settle_ticks=6,
                   drain_budget_per_partition=16, queue_limit=256,
                   crash_every=8, avalanche_readers=6)


PORT_PKG = (tcap, faultinject)
JAX_PKG = (jcap, jfi)


def _small_soak(seed=17, reset=0.08, mult=1.0, fleet=None, chaos=True,
                pkg=PORT_PKG, pinned=False):
    """The reference's small soak on the scalar LocalServer of `pkg` (the
    port's capacity package and fault injector, or the JAX ones).
    `pinned` builds the server through testing/capacity_runs, whose
    broadcast fan-out is delivered at every downstream pump: under
    saturation the admission ladder reads the fan-out queue depth, which
    the reference's threaded shards leave to timing."""
    cap, fi = pkg
    spec = cap.WorkloadSpec(**{**SMALL_WORKLOAD, "seed": seed}).scaled(mult)
    factory = None
    if pinned:
        factory = capacity_runs.server_factory(capacity_runs.CapacityPackage(
            cap, fi, import_module(
                cap.__name__.rsplit(".", 1)[0] + ".server.local_server"),
            {}), tpu=False)
    return cap.FleetSoak(cap.WorkloadModel(spec),
                         cap.FleetSpec(**(fleet or SMALL_FLEET)),
                         plan=fi.FaultPlan(seed=31, reset=reset)
                         if chaos else None, server_factory=factory)


def _graded(r) -> dict:
    """Everything a soak grades (its as_dict without the wall time and
    the threaded broadcast-depth samples, which the reference leaves to
    the shard workers' timing)."""
    d = capacity_runs.soak_record(r)
    d.pop("peak_broadcast_depth")
    d["tier_pressures"].pop("broadcast")
    d["tier_pressures"].pop("admission")
    d.pop("peak_backlog_global")
    d["tier_lags"].pop("broadcast", None)
    return d


class TestFleetSoak:
    def test_chaos_on_run_twice_is_bit_identical(self):
        ra = _small_soak().run()
        rb = _small_soak().run()
        ref = _small_soak(pkg=JAX_PKG).run()
        assert ra.fingerprint() == rb.fingerprint() == ref.fingerprint()
        assert ra.final_seq == rb.final_seq == ref.final_seq
        assert ra.stream_digests == rb.stream_digests == ref.stream_digests
        assert _graded(ra) == _graded(ref)
        # Chaos actually ran inside the measured envelope.
        assert sum(ra.partition_restarts) >= 1
        assert ra.avalanches >= 1

    def test_workload_seed_changes_the_run(self):
        ra = _small_soak(seed=17).run()
        rb = _small_soak(seed=18).run()
        assert ra.fingerprint() != rb.fingerprint()
        assert rb.fingerprint() == _small_soak(seed=18,
                                               pkg=JAX_PKG).run().fingerprint()

    def test_soak_flushes_what_it_admits(self):
        r = _small_soak().run()
        assert r.submitted > 0
        assert r.flushed == r.admitted > 0
        # The scalar LocalServer has no catch-up artifact cache, so
        # readers are not graded here (TestCapacityGrade grades them on
        # TpuLocalServer).
        assert r.slo(grade_readers=False)["ok"]

    def test_goodput_collapses_under_saturation(self):
        r = _small_soak(mult=24.0, pinned=True).run()
        s = r.slo(grade_readers=False)
        assert s["goodput"] < 0.95
        assert not s["ok"]
        ref = _small_soak(mult=24.0, pkg=JAX_PKG, pinned=True).run()
        assert r.fingerprint() == ref.fingerprint()
        assert s == ref.slo(grade_readers=False)

    def test_single_use(self):
        soak = _small_soak()
        soak.run()
        with pytest.raises(RuntimeError):
            soak.run()

    def test_tiny_partition_limit_attributes_ingest(self):
        fleet = {**SMALL_FLEET, "partition_limit": 2, "crash_every": 0,
                 "avalanche_readers": 0}
        r = _small_soak(mult=4.0, fleet=fleet, chaos=False).run()
        pressures = r.tier_pressures()
        tier, ranking = attribute_bottleneck(pressures)
        assert ranking[0][0] == tier
        # With 2 credits per partition the gate paces (admission) or the
        # per-partition backlog binds (ingest): the binding tier is at
        # the gate side of the pipeline, not the read side.
        assert tier in ("admission", "ingest")
        assert pressures[tier] > pressures["broadcast"]
        ref = _small_soak(mult=4.0, fleet=fleet, chaos=False,
                          pkg=JAX_PKG).run()
        assert r.fingerprint() == ref.fingerprint()
        assert pressures["ingest"] == ref.tier_pressures()["ingest"]


class TestGrader:
    @staticmethod
    def _probe(true_capacity):
        def probe(mult):
            ok = mult <= true_capacity
            return {"ok": ok,
                    "pressures": {"ingest": mult / true_capacity,
                                  "serving": 0.1}}
        return probe

    @staticmethod
    def _both(true_capacity, **kw):
        got = CapacityGrader(TestGrader._probe(true_capacity), **kw).search()
        ref = jcap.CapacityGrader(TestGrader._probe(true_capacity),
                                  **kw).search()
        assert got.as_dict() == ref.as_dict()
        return got

    def test_converges_to_known_capacity(self):
        res = self._both(2.7, lo=0.5, hi=8.0, iters=8)
        assert res.saturated
        assert abs(res.capacity_mult - 2.7) < 0.1
        assert res.bottleneck == "ingest"

    def test_lo_failing_grades_zero(self):
        res = self._both(0.1, lo=0.5, hi=8.0)
        assert res.capacity_mult == 0.0
        assert res.saturated

    def test_hi_passing_reports_unsaturated(self):
        res = self._both(100.0, lo=0.5, hi=8.0)
        assert not res.saturated
        assert res.capacity_mult == 8.0

    def test_attribute_bottleneck_ranking(self):
        pressures = {"a": 0.2, "b": 0.9, "c": 0.9, "d": 0.1}
        tier, ranking = attribute_bottleneck(pressures)
        assert tier == "b"  # value tie broken by name
        assert [t for t, _ in ranking] == ["b", "c", "a", "d"]
        assert (tier, ranking) == jcap.attribute_bottleneck(pressures)


class TestWatchCapacity:
    RECORD = {
        "ok": True, "backend": "cpu",
        "grade": {"capacity_mult": 2.5},
        "capacity": {"offered_ops_per_sec": 1500.0,
                     "sustained_ops_per_sec": 1480.0,
                     "readers_per_sec": 400.0,
                     "bottleneck": "serving",
                     "pressure_ranking": [["serving", 0.9],
                                          ["ingest", 0.4]]},
        "final_run": {"tier_pressures": {"serving": 0.9, "ingest": 0.4}},
    }

    def test_surfaces_record_and_gauges(self, tmp_path):
        path = tmp_path / "capacity_record.json"
        path.write_text(json.dumps(self.RECORD))
        mon = ServiceMonitor(device="cpu").start()
        try:
            mon.watch_capacity("capacity", str(path))
            health = json.load(urllib.request.urlopen(mon.url + "/health"))
            assert health["checks"]["capacity"]["ok"]
            report = json.load(urllib.request.urlopen(mon.url + "/metrics"))
            probe = report["probes"]["capacity"]
            assert probe["available"]
            assert probe["capacityMult"] == 2.5
            assert probe["bottleneck"] == "serving"
            assert probe["tierPressures"]["serving"] == 0.9
            prom = urllib.request.urlopen(
                mon.url + "/metrics.prom").read().decode()
            assert "fluid_capacity_tier_pressure_serving 0.9" in prom
            assert "fluid_capacity_sustained_ops_per_sec 1480" in prom
        finally:
            mon.stop()

    def test_missing_record_is_not_unhealthy(self, tmp_path):
        mon = ServiceMonitor(device="cpu").start()
        try:
            mon.watch_capacity("capacity",
                               str(tmp_path / "never-written.json"))
            health = json.load(urllib.request.urlopen(mon.url + "/health"))
            assert health["ok"]
            report = json.load(urllib.request.urlopen(mon.url + "/metrics"))
            assert report["probes"]["capacity"] == {"available": False}
        finally:
            mon.stop()

    def test_callable_source(self):
        mon = ServiceMonitor(device="cpu")
        mon.watch_capacity("capacity", lambda: self.RECORD)
        probe = mon.report()["probes"]["capacity"]
        assert probe["available"] and probe["bottleneck"] == "serving"


class _StubLam:
    def __init__(self, seq=7, gen=3):
        self.bodies = {"doc-a": {"seq": seq, "gen": gen,
                                 "clients": [], "channels": []}}
        self.marked = []

    def catchup_snapshot(self, only_docs=None):
        return dict(self.bodies)

    def catchup_mark_published(self, doc_id, gen):
        self.marked.append((doc_id, gen))


class _StubCheckpoints:
    def __init__(self, rows):
        self.rows = rows

    def find(self, pred):
        return [r for r in self.rows if pred(r)]


class _StubHistorian:
    class _Store:
        def get_ref(self, ref):
            return "sha-main"

    def store(self, tenant_id, document_id):
        return self._Store()


class TestArtifactPushThrough:
    def _push(self, lam, rows, publish, clock):
        return ArtifactPushThrough(
            lambda: [lam], _StubCheckpoints(rows), _StubHistorian(),
            "local", publish, interval_s=0.25, clock=clock)

    def test_dead_historian_retries_next_epoch(self):
        lam = _StubLam()
        rows = [{"documentId": "doc-a", "sequenceNumber": 7,
                 "minimumSequenceNumber": 5, "quorum": {"members": []}}]
        alive = {"v": False}
        sent = []

        def publish(t, d, a):
            sent.append(a)
            return alive["v"]

        vt = {"t": 0.0}
        push = self._push(lam, rows, publish, lambda: vt["t"])
        assert push.pump() == 0            # dead tier: not marked
        assert lam.marked == []
        vt["t"] = 0.1
        assert push.pump() == 0            # rate-limited, no epoch
        assert push.epochs == 1
        alive["v"] = True
        vt["t"] = 0.3
        assert push.pump() == 1            # retried and confirmed
        assert lam.marked == [("doc-a", 3)]
        art = sent[-1]
        assert (art["v"], art["seq"], art["msn"], art["summarySha"]) \
            == (1, 7, 5, "sha-main")

    def test_scribe_lag_skips_stale_but_correct(self):
        lam = _StubLam(seq=9)              # checkpoint row still at 7
        rows = [{"documentId": "doc-a", "sequenceNumber": 7,
                 "minimumSequenceNumber": 5, "quorum": {"members": []}}]
        push = self._push(lam, rows, lambda t, d, a: True, lambda: 0.0)
        assert push.pump(force=True) == 0
        assert push.stats()["skipped"] == 1
        assert lam.marked == []

    def test_scalar_deli_without_snapshot_is_a_noop(self):
        class Scalar:
            pass

        push = ArtifactPushThrough(
            lambda: [Scalar()], _StubCheckpoints([]), _StubHistorian(),
            "local", lambda t, d, a: True, clock=lambda: 0.0)
        assert push.pump(force=True) == 0
        assert push.epochs == 0


def crash_draws(pkg, section) -> tuple:
    """The (tick, partition) crash-restarts and the avalanche count that
    `section`'s fault plan makes in one soak. FleetSoak draws the plan in
    a fixed order that no workload figure enters (the crash pick at every
    crash_every-th tick, a reset draw every tick, the avalanche's document
    and reader picks), so every soak of a section, at any rate, makes the
    same ones."""
    f = section.fleet
    docs = section.workload["documents"]
    plan = pkg.faultinject.FaultPlan(seed=section.plan_seed,
                                     reset=section.reset)
    restarts, avalanches = [], 0
    for t in range(f["ticks"]):
        if f["crash_every"] and (t + 1) % f["crash_every"] == 0:
            idx = plan.pick(f["partitions"] + 1, site="partition-crash")
            if idx < f["partitions"]:
                restarts.append((t, idx))
        if f["avalanche_readers"] and plan.should_reset():
            avalanches += 1
            plan.pick(docs, site="avalanche-doc")
            for _ in range(f["avalanche_readers"]):
                plan.pick(docs, site="avalanche-read")
    return tuple(restarts), avalanches


@pytest.fixture(scope="module")
def small_grade():
    return capacity_runs.grade(capacity_runs.CAPACITY_SMALL, device="cpu")


class TestCapacityGrade:
    """testing/capacity_runs at CAPACITY_SMALL: the grader's probes and
    the capacity point twice over TpuLocalServer(device="cpu"), chaos on,
    against the committed JAX golden; and over the scalar LocalServer
    against the JAX package run beside it."""

    def test_device_grade_equals_jax_golden(self, small_grade):
        want = dict(golden.load_capacity()["small"])
        want.pop("section")
        assert capacity_runs.comparable(small_grade) == want

    def test_device_grade_reproduces_with_chaos_inside(self, small_grade):
        g = small_grade
        assert g["fingerprints"][0] == g["fingerprints"][1]
        assert g["final"] == g["final_b"]
        assert g["partition_restarts"] and g["avalanches"] >= 1
        grade = g["grade"]
        assert grade["saturated"] and grade["capacity_mult"] > 0
        assert grade["probes"][0]["ok"] and not grade["probes"][1]["ok"]
        # The readers adopt catch-up artifacts on the device server.
        assert g["final"]["readers"]["adopted"] > 0
        assert len(g["wall_s"]["soaks"]) == len(grade["probes"]) + 2

    def test_scalar_grade_equals_jax(self):
        section = capacity_runs.CAPACITY_SMALL
        from test_torch_capacity_golden import jax_package
        got = capacity_runs.grade(section, device="cpu", tpu=False)
        ref = capacity_runs.grade(section, pkg=jax_package(), tpu=False)
        assert capacity_runs.comparable(got) == \
            capacity_runs.comparable(ref)
        assert got["fingerprints"][0] == got["fingerprints"][1]

    def test_card_section_scales_the_small_one(self):
        small, card = capacity_runs.CAPACITY_SMALL, \
            capacity_runs.CAPACITY_CARD
        k = card.workload["documents"] / small.workload["documents"]
        assert card.workload["documents"] == 256
        assert card.fleet["ticks"] == 32
        assert card.workload["writer_rate_per_s"] == round(600 * k)
        assert card.fleet["queue_limit"] == round(512 * k)
        assert card.fleet["drain_budget_per_partition"] == round(24 * k)
        assert card.fleet["avalanche_readers"] == round(16 * k)
        for key in ("settle_ticks", "partitions",
                    "broadcaster_shards", "subscribers_per_document",
                    "crash_every"):
            assert card.fleet[key] == small.fleet[key]
        assert (card.plan_seed, card.reset, card.lo, card.hi,
                card.iters) == (small.plan_seed, small.reset, small.lo,
                                small.hi, small.iters)

    def test_crash_draws_predict_the_soaks_chaos(self, small_grade):
        """The fault plan's crash-restarts and avalanches do not depend on
        the rate: crash_draws gives every soak's, the card section's
        included (at 512 documents seed 31 draws no crash at all)."""
        pkg = capacity_runs.port_package("cpu")
        restarts, avalanches = crash_draws(
            pkg, capacity_runs.CAPACITY_SMALL)
        assert [p for _, p in restarts] == \
            small_grade["partition_restarts"]
        assert avalanches == small_grade["avalanches"]
        card = crash_draws(pkg, capacity_runs.CAPACITY_CARD)
        assert card[0] and card[1] >= 1
        assert crash_draws(pkg, capacity_runs.scaled_section(
            capacity_runs.CAPACITY_SMALL, 512))[0] == ()

    def test_grade_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            capacity_runs.grade(capacity_runs.CAPACITY_SMALL)
