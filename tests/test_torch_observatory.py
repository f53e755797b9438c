"""The port's fleet observatory (fluidframework_tpu_torch/server/
observatory.py): a mirror of tests/test_observatory.py (scrape/merge over
stub workers, trace joining, the instance-labelled merged exposition,
fleet lag, burn-rate enforcement, the HTTP surface against a real port
ServiceMonitor worker on the CPU)."""

import json
import urllib.error
import urllib.request

import pytest

from fluidframework_tpu_torch.server.monitor import ServiceMonitor
from fluidframework_tpu_torch.server.observatory import FleetObservatory
from fluidframework_tpu_torch.telemetry import counters, tracing, watermarks
from fluidframework_tpu_torch.telemetry.slo import BurnRateEngine, Objective


@pytest.fixture(autouse=True)
def _clean():
    counters.reset()
    tracing.reset()
    watermarks.reset()
    yield
    counters.reset()
    tracing.reset()
    watermarks.reset()


def _span(name, trace_id, pid, proc, ts=0):
    return {"name": name, "ph": "X", "ts": ts, "dur": 5, "pid": pid,
            "tid": 1, "args": {"trace_id": trace_id, "proc": proc}}


def _stub_fetch(workers):
    """fetch(url, timeout) over a dict of worker dicts keyed by base
    URL: {"health": ..., "prom": ..., "trace": [...], "down": bool}.
    /trace drains (the monitor contract the observatory relies on)."""

    def fetch(url, timeout_s):
        base, _, route = url.rpartition("/")
        w = workers[base]
        if w.get("down"):
            raise OSError("connection refused")
        if route == "health":
            return json.dumps(w["health"]).encode()
        if route == "metrics.prom":
            return w["prom"].encode()
        if route == "trace":
            events, w["trace"] = w.get("trace", []), []
            return json.dumps({"traceEvents": events}).encode()
        raise AssertionError(f"unexpected route {route}")

    return fetch


def _workers():
    return {
        "http://a": {
            "health": {"ok": True, "watermarks": {
                "lags": {"ingest": {"total": 3.0},
                         "broadcast": {"total": 1.0}}}},
            "prom": ("# HELP fluid_x process counter x\n"
                     "# TYPE fluid_x gauge\n"
                     "fluid_x 1\n"
                     'fluid_stage_latency_ms_count{stage="s"} 4\n'
                     "# EOF\n"),
            "trace": [_span("alfred.ingest", "t1", 100, "alfred", ts=0),
                      _span("deli.ticket", "t1", 200, "deli", ts=10)],
        },
        "http://b": {
            "health": {"ok": True, "watermarks": {
                "lags": {"ingest": {"total": 2.0}}}},
            "prom": ("# HELP fluid_x process counter x\n"
                     "# TYPE fluid_x gauge\n"
                     "fluid_x 7\n"
                     "# EOF\n"),
            "trace": [_span("broadcast.fanout", "t1", 300,
                            "broadcaster", ts=20),
                      _span("other.op", "t2", 300, "broadcaster",
                            ts=5)],
        },
    }


def _obs(workers, **kw):
    return FleetObservatory(
        [{"name": "a", "url": "http://a"},
         {"name": "b", "url": "http://b"}],
        fetch=_stub_fetch(workers), **kw)


class TestScrapeMerge:
    def test_all_workers_healthy(self):
        obs = _obs(_workers())
        obs.scrape_once()
        health = obs.fleet_health()
        assert health["ok"] is True
        assert set(health["workers"]) == {"a", "b"}
        assert health["scrapes"] == 1

    def test_down_worker_flips_fleet_health(self):
        workers = _workers()
        workers["http://b"]["down"] = True
        obs = _obs(workers)
        obs.scrape_once()
        health = obs.fleet_health()
        assert health["ok"] is False
        assert health["workers"]["a"]["ok"] is True
        assert health["workers"]["b"]["ok"] is False
        assert "OSError" in health["workers"]["b"]["error"]

    def test_unhealthy_payload_counts_as_not_ok(self):
        workers = _workers()
        workers["http://a"]["health"]["ok"] = False
        obs = _obs(workers)
        obs.scrape_once()
        assert obs.fleet_health()["workers"]["a"]["ok"] is False

    def test_no_scrape_yet_is_not_ok(self):
        assert _obs(_workers()).fleet_health()["ok"] is False


class TestFleetLag:
    def test_per_edge_totals_sum_across_workers(self):
        obs = _obs(_workers())
        obs.scrape_once()
        lag = obs._fleet_lag_locked()
        assert lag["fleet"]["ingest"] == 5.0       # 3 + 2
        assert lag["fleet"]["broadcast"] == 1.0
        assert lag["workers"]["a"]["lags"]["ingest"]["total"] == 3.0

    def test_down_worker_contributes_nothing(self):
        workers = _workers()
        workers["http://a"]["down"] = True
        obs = _obs(workers)
        obs.scrape_once()
        lag = obs._fleet_lag_locked()
        assert lag["fleet"]["ingest"] == 2.0
        assert lag["workers"]["a"] is None


class TestPromMerge:
    def test_instance_label_injected_and_meta_deduped(self):
        obs = _obs(_workers())
        obs.scrape_once()
        text = obs.fleet_prom()
        assert 'fluid_x{instance="a"} 1' in text
        assert 'fluid_x{instance="b"} 7' in text
        # Existing labels keep their body after the instance label.
        assert ('fluid_stage_latency_ms_count{instance="a",stage="s"} 4'
                in text)
        assert text.count("# HELP fluid_x") == 1
        assert text.count("# TYPE fluid_x") == 1
        assert text.count("# EOF") == 1
        assert text.rstrip().endswith("# EOF")


class TestTraceJoin:
    def test_one_joined_cross_process_timeline(self):
        obs = _obs(_workers())
        obs.scrape_once()
        joined = obs.fleet_trace()
        names = [e["name"] for e in joined["traceEvents"]]
        # Ordered by timestamp across processes: the op's journey.
        assert names == ["alfred.ingest", "other.op", "deli.ticket",
                         "broadcast.fanout"]
        # Every span carries its process identity.
        assert all((e.get("args") or {}).get("proc")
                   for e in joined["traceEvents"])
        assert joined["joined"]["traces"] == 2
        assert joined["joined"]["crossProcess"] == 1   # t1 spans 3 procs

    def test_trace_id_filter(self):
        obs = _obs(_workers())
        obs.scrape_once()
        only = obs.fleet_trace("t1")
        assert len(only["traceEvents"]) == 3
        assert all(e["args"]["trace_id"] == "t1"
                   for e in only["traceEvents"])

    def test_span_ring_is_bounded(self):
        workers = _workers()
        obs = _obs(workers, trace_capacity=3)
        obs.scrape_once()
        workers["http://a"]["trace"] = [
            _span("more", "t9", 1, "x", ts=i) for i in range(5)]
        obs.scrape_once()
        assert obs.workers_view()["spansHeld"] == 3


class TestBurnEnforcement:
    def _burn(self, clock):
        return BurnRateEngine(
            [Objective("worker_health", 0.99),
             Objective("fleet_lag", 0.95)],
            clock=lambda: clock["t"], fast_window_s=10.0,
            slow_window_s=60.0)

    def test_sustained_worker_failures_breach(self):
        clock = {"t": 0.0}
        workers = _workers()
        workers["http://a"]["down"] = True
        workers["http://b"]["down"] = True
        obs = _obs(workers, burn=self._burn(clock))
        for i in range(30):
            clock["t"] = i * 3.0
            obs.scrape_once()
        health = obs.fleet_health()
        assert health["ok"] is False
        assert health["burnRate"]["objectives"]["worker_health"]["breach"]
        assert health["burnRate"]["attribution"] == "worker_health"

    def test_lag_over_ceiling_burns_the_lag_objective(self):
        clock = {"t": 0.0}
        workers = _workers()
        # The fleet_lag objective watches the broadcast edge (sequenced
        # ops not yet delivered — the fleet's consumer-lag headline).
        workers["http://a"]["health"]["watermarks"]["lags"]["broadcast"][
            "total"] = 1e9
        obs = _obs(workers, burn=self._burn(clock), lag_ceiling=100.0)
        for i in range(30):
            clock["t"] = i * 3.0
            obs.scrape_once()
        verdict = obs.fleet_health()["burnRate"]
        assert verdict["objectives"]["fleet_lag"]["breach"]


class TestHttpSurface:
    def test_routes_against_a_real_worker_monitor(self):
        tracing.configure(sample=1)
        tracing.set_process_name("worker-a")
        counters.increment("ops.sequenced", 3)
        watermarks.advance(watermarks.RAW_END, 0, 5)
        watermarks.advance(watermarks.RAW_INGESTED, 0, 4)
        with tracing.span("stage.a", root=True):
            pass
        mon = ServiceMonitor(device="cpu").start()
        obs = FleetObservatory(
            [{"name": "w0", "url": mon.url}], interval_s=0.05).start()
        try:
            obs.scrape_once()
            with urllib.request.urlopen(
                    obs.url + "/fleet/health") as resp:
                health = json.load(resp)
            assert health["workers"]["w0"]["ok"] is True
            assert health["lag"]["ingest"] == 1.0
            with urllib.request.urlopen(
                    obs.url + "/fleet/metrics.prom") as resp:
                prom = resp.read().decode()
                assert resp.headers["Content-Type"].startswith(
                    "application/openmetrics-text")
            assert 'fluid_ops_sequenced{instance="w0"} 3' in prom
            assert prom.rstrip().endswith("# EOF")
            with urllib.request.urlopen(
                    obs.url + "/fleet/trace") as resp:
                trace = json.load(resp)
            spans = [e for e in trace["traceEvents"]
                     if e["name"] == "stage.a"]
            assert spans and spans[0]["args"]["proc"] == "worker-a"
            with urllib.request.urlopen(
                    obs.url + "/fleet/lag") as resp:
                lag = json.load(resp)
            assert lag["fleet"]["ingest"] == 1.0
            with urllib.request.urlopen(
                    obs.url + "/fleet/workers") as resp:
                workers = json.load(resp)
            assert workers["targets"][0]["name"] == "w0"
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(obs.url + "/nope")
            assert err.value.code == 404
        finally:
            obs.stop()
            mon.stop()

    def test_fleet_health_503_before_first_scrape(self):
        obs = FleetObservatory([], fetch=lambda u, t: b"{}").start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(obs.url + "/fleet/health")
            assert err.value.code == 503
        finally:
            obs.stop()


def test_fleet_views_equal_jax(monkeypatch):
    """The JAX observatory and the port's over the same two stub workers,
    one fake burn clock and a seeded scrape schedule (worker b down in a
    wave): the merged exposition, fleet health, lag, joined trace and
    workers view are equal (scrapedAt, the wall clock of a scrape,
    compared by name only)."""
    import random

    from fluidframework_tpu.server import observatory as jobs
    from fluidframework_tpu.telemetry import slo as jslo

    from fluidframework_tpu_torch.server import observatory as tobs
    from fluidframework_tpu_torch.telemetry import slo as tslo

    views = []
    for obs_mod, slo in ((jobs, jslo), (tobs, tslo)):
        rng = random.Random(11)
        clock = {"t": 0.0}
        workers = _workers()
        burn = slo.BurnRateEngine(
            [slo.Objective("worker_health", 0.99),
             slo.Objective("fleet_lag", 0.95)],
            clock=lambda: clock["t"], fast_window_s=10.0,
            slow_window_s=60.0)
        obs = obs_mod.FleetObservatory(
            [{"name": "a", "url": "http://a"},
             {"name": "b", "url": "http://b"}],
            fetch=_stub_fetch(workers), burn=burn, lag_ceiling=2.0)
        seen = []
        for i in range(24):
            clock["t"] = i * 2.5
            workers["http://b"]["down"] = 8 <= i < 16
            workers["http://a"]["health"]["watermarks"]["lags"][
                "broadcast"]["total"] = float(rng.randrange(5))
            workers["http://a"]["trace"] = [
                _span(f"op{i}", f"t{rng.randrange(3)}", 100 + i % 2,
                      "alfred", ts=rng.randrange(100))]
            seen.append(obs.scrape_once())
            health = obs.fleet_health()
            for state in health["workers"].values():
                assert isinstance(state.pop("scrapedAt"), float)
            seen.append(health)
        seen += [obs.fleet_prom(), obs._fleet_lag_locked(),
                 obs.fleet_trace(), obs.fleet_trace("t1"),
                 obs.workers_view()]
        obs.stop()
        views.append(seen)
    assert views[1] == views[0]
    assert any(not v["ok"] for v in views[1][1::2][:24])
