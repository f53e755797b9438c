"""The port's ServiceMonitor (fluidframework_tpu_torch/server/monitor.py)
on the CPU: a mirror of tests/test_monitor.py (routing, MetricClient
percentile math, the observability surface: /trace, /metrics.prom, SLO
enforcement), with device="cpu" where the port's monitor takes a device.

The HTTP-level tests drive raw sockets where keep-alive framing matters:
a wrong Content-Length under HTTP/1.1 makes the SECOND request on a
reused connection read garbage — invisible through urllib (fresh
connection per call) but fatal for real scrapers."""

import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from fluidframework_tpu_torch.server.monitor import (MetricClient,
                                                     ServiceMonitor,
                                                     SloPolicy)
from fluidframework_tpu_torch.telemetry import counters, tracing, watermarks


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """The JAX file resets counters and tracing; this file also drives a
    server (watermarks advance), so it resets the watermark table too: a
    lag age left by one test would otherwise grow in a later test's
    exposition."""
    counters.reset()
    tracing.reset()
    watermarks.reset()
    yield
    counters.reset()
    tracing.reset()
    watermarks.reset()


class FakeClock:
    """One clock for either package: the call form reads `now`."""

    def __init__(self, now: float):
        self.now = now

    def __call__(self) -> float:
        return self.now


@pytest.fixture()
def monitor():
    mon = ServiceMonitor(device="cpu").start()
    yield mon
    mon.stop()


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return resp.status, json.load(resp)


class TestMetricClientPercentiles:
    """Exact nearest-rank values at the window sizes the old math broke:
    p50 used the upper-median index and p99 a truncation-based index
    that returned the max for any window under ~100 samples."""

    def _client(self, values):
        m = MetricClient()
        for v in values:
            m.write_latency("op", float(v))
        return m.snapshot()["latencies"]["op"]

    def test_window_1(self):
        snap = self._client([7.0])
        assert snap == {"count": 1, "p50": 7.0, "p99": 7.0, "max": 7.0}

    def test_window_2_p50_is_lower_median(self):
        snap = self._client([1.0, 2.0])
        assert snap["p50"] == 1.0
        assert snap["p99"] == 2.0

    def test_window_4(self):
        snap = self._client([4.0, 1.0, 3.0, 2.0])
        assert snap["p50"] == 2.0   # ceil(0.5*4) = 2nd smallest
        assert snap["p99"] == 4.0   # ceil(0.99*4) = 4th smallest
        assert snap["max"] == 4.0

    def test_window_100_p99_is_not_max(self):
        snap = self._client(range(1, 101))
        assert snap["p50"] == 50.0
        assert snap["p99"] == 99.0  # NOT 100 — the old truncation bug
        assert snap["max"] == 100.0


class TestRouting:
    def test_healthz_alias(self, monitor):
        status, body = _get(monitor.url + "/healthz")
        assert status == 200
        assert body["ok"] is True
        assert "slo" in body

    def test_404_payload(self, monitor):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(monitor.url + "/nope")
        assert err.value.code == 404
        assert json.load(err.value) == {"error": "no route /nope"}

    def test_503_on_raising_probe(self, monitor):
        monitor.add_probe("boom", lambda: 1 / 0)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(monitor.url + "/health")
        assert err.value.code == 503
        body = json.load(err.value)
        assert body["ok"] is False
        assert not body["checks"]["boom"]["ok"]
        assert "ZeroDivisionError" in body["checks"]["boom"]["detail"]

    def test_keep_alive_content_length_two_requests(self, monitor):
        """Two sequential requests on ONE HTTP/1.1 connection: correct
        Content-Length framing is what lets the second parse at all."""
        conn = http.client.HTTPConnection(monitor.host, monitor.port)
        try:
            for path in ("/health", "/metrics"):
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read()
                assert resp.status == 200
                assert int(resp.headers["Content-Length"]) == len(body)
                json.loads(body)  # parses cleanly = framing was exact
        finally:
            conn.close()

    def test_keep_alive_across_prom_and_trace(self, monitor):
        counters.observe("serving.flush", 1.0)
        conn = http.client.HTTPConnection(monitor.host, monitor.port)
        try:
            conn.request("GET", "/metrics.prom")
            resp = conn.getresponse()
            prom = resp.read()
            assert resp.status == 200
            assert int(resp.headers["Content-Length"]) == len(prom)
            assert resp.headers["Content-Type"].startswith(
                "application/openmetrics-text")
            assert prom.decode().rstrip().endswith("# EOF")
            conn.request("GET", "/trace")
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 200
            assert int(resp.headers["Content-Length"]) == len(body)
            assert "traceEvents" in json.loads(body)
        finally:
            conn.close()


class TestPrometheusExposition:
    def test_counters_and_histogram_buckets(self, monitor):
        counters.increment("ops.sequenced", 5)
        for ms in (0.4, 3.0, 30.0, 400.0):
            counters.observe("serving.flush", ms, trace_id="abc123")
        status, _ = _get(monitor.url + "/health")
        assert status == 200
        with urllib.request.urlopen(monitor.url + "/metrics.prom") as resp:
            text = resp.read().decode()
        assert "fluid_ops_sequenced 5" in text
        # Bucket lines parse and cumulative counts are monotone, ending
        # at the +Inf bucket == count.
        buckets = []
        for line in text.splitlines():
            if line.startswith('fluid_stage_latency_ms_bucket'
                               '{stage="serving.flush"'):
                le = line.split('le="')[1].split('"')[0]
                count = int(line.split("} ")[1].split(" #")[0])
                buckets.append((le, count))
        assert buckets, text
        counts = [c for _, c in buckets]
        assert counts == sorted(counts)
        assert buckets[-1][0] == "+Inf" and buckets[-1][1] == 4
        assert 'fluid_stage_latency_ms_count{stage="serving.flush"} 4' \
            in text
        # Exemplar carries the trace id of the last sample in the bucket.
        assert 'trace_id="abc123"' in text

    def test_slo_gauge_present(self, monitor):
        with urllib.request.urlopen(monitor.url + "/metrics.prom") as resp:
            text = resp.read().decode()
        assert 'fluid_slo_ok{stage="serving.flush"} 1' in text


class TestSlo:
    def _fill(self, spread):
        # 90 fast + 10 at `spread`x: p99 lands in the tail.
        for i in range(100):
            counters.observe("serving.flush",
                             1.0 if i < 90 else float(spread))

    def test_in_budget_health_ok(self, monitor):
        self._fill(1.5)
        status, body = _get(monitor.url + "/health")
        assert status == 200
        assert body["slo"]["evaluated"] and body["slo"]["ok"]

    def test_breach_flips_503_with_detail(self, monitor):
        self._fill(50.0)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(monitor.url + "/health")
        assert err.value.code == 503
        body = json.load(err.value)
        assert body["slo"]["ok"] is False
        assert body["slo"]["ratio"] > 2.0
        assert body["slo"]["budget"] == "p99 <= 2 * p50"

    def test_too_few_samples_not_evaluated(self, monitor):
        for _ in range(8):
            counters.observe("serving.flush", 100.0)
        counters.observe("serving.flush", 1.0)
        status, body = _get(monitor.url + "/health")
        assert status == 200
        assert body["slo"]["evaluated"] is False
        assert body["slo"]["ok"] is True

    def test_report_only_mode(self):
        self._fill(50.0)
        mon = ServiceMonitor(device="cpu", enforce_slo=False).start()
        try:
            status, body = _get(mon.url + "/health")
            assert status == 200
            assert body["slo"]["ok"] is False  # verdict still visible
        finally:
            mon.stop()

    def test_custom_policy(self):
        self._fill(3.0)
        mon = ServiceMonitor(
            device="cpu",
            slo=SloPolicy(p99_over_p50=4.0, min_samples=10)).start()
        try:
            status, body = _get(mon.url + "/health")
            assert status == 200 and body["slo"]["ok"]
        finally:
            mon.stop()


class TestProbeConcurrency:
    """The probe registry is shared state: watch_*() registration on
    the operator thread races /health's iteration on request threads.
    An unguarded dict dies with RuntimeError mid-iteration; the lock
    (snapshot-then-probe-outside-it) must keep every request whole."""

    def test_watch_registration_races_health(self, monitor):
        stop = threading.Event()
        errors = []

        def register():
            i = 0
            while not stop.is_set():
                # Both registration paths: raw add_probe and a watch_*
                # convenience (they share the guarded registry).
                monitor.add_probe(f"p{i % 20}", lambda: {"n": 1})
                monitor.watch_local_server(f"ls{i % 20}", object())
                i += 1

        def health_loop():
            try:
                for _ in range(25):
                    with urllib.request.urlopen(
                            monitor.url + "/health") as resp:
                        body = json.load(resp)
                        assert body["ok"] is True
            except Exception as exc:  # noqa: BLE001 — the assertion
                errors.append(exc)

        writer = threading.Thread(target=register, daemon=True)
        readers = [threading.Thread(target=health_loop, daemon=True)
                   for _ in range(3)]
        writer.start()
        for r in readers:
            r.start()
        for r in readers:
            r.join(timeout=30)
        stop.set()
        writer.join(timeout=5)
        assert not errors, errors

    def test_raising_probe_does_not_starve_the_others(self, monitor):
        ran = {"good": 0}

        def good():
            ran["good"] += 1
            return {"n": ran["good"]}

        monitor.add_probe("boom", lambda: 1 / 0)
        monitor.add_probe("good", good)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(monitor.url + "/health")
        assert err.value.code == 503
        body = json.load(err.value)
        # The crash is isolated to its own checks entry; every other
        # probe still ran and reported.
        assert body["checks"]["boom"]["ok"] is False
        assert body["checks"]["good"]["ok"] is True
        assert ran["good"] == 1
        # /metrics report-mode isolation too: the error is inlined,
        # never raised through the route.
        with urllib.request.urlopen(monitor.url + "/metrics") as resp:
            report = json.load(resp)
        assert "ZeroDivisionError" in report["probes"]["boom"]["error"]
        assert report["probes"]["good"] == {"n": 2}


class TestTraceEndpoint:
    def test_trace_drains_chrome_json(self, monitor):
        tracing.configure(sample=1)
        with tracing.span("stage.a", root=True):
            with tracing.span("stage.b"):
                pass
        status, body = _get(monitor.url + "/trace")
        assert status == 200
        names = [e["name"] for e in body["traceEvents"]]
        assert "stage.a" in names and "stage.b" in names
        for e in body["traceEvents"]:
            assert e["ph"] == "X"
            assert "trace_id" in e["args"]
        # Drained: a second read starts empty.
        _, body2 = _get(monitor.url + "/trace")
        assert body2["traceEvents"] == []


# ---------------------------------------------------------------------------
# The monitor cases of other JAX files whose subjects are ported: mirrors of
# tests/test_admission.py::...::test_monitor_health_and_prom_surface,
# tests/test_readpath.py::TestMonitorReadpath,
# tests/test_sharded_ingest.py::TestMonitorWatchPartitions,
# tests/test_device_stats.py::TestMonitorSurfaces and
# ::TestCardinalityGuard::test_tenant_churn_soak_bounds_exposition, and
# tests/test_narrow_wire.py::TestMonitorSummaryProbe.
# ---------------------------------------------------------------------------

class TestWatchProbes:
    def test_monitor_health_and_prom_surface(self):
        from fluidframework_tpu_torch.server.admission import (
            SHED, AdmissionController)
        ctl = AdmissionController(queue_limit=10)
        ctl.force_state(SHED)
        mon = ServiceMonitor(device="cpu").start()
        try:
            mon.watch_admission("admission", ctl)
            with urllib.request.urlopen(mon.url + "/health") as resp:
                health = json.load(resp)
            assert health["admission"]["state"] == SHED
            assert health["admission"]["level"] == 2
            with urllib.request.urlopen(mon.url + "/metrics.prom") as resp:
                prom = resp.read().decode()
            assert 'fluid_admission_level{state="shed"} 2' in prom
        finally:
            mon.stop()

    def test_watch_readpath_probe(self):
        """The JAX client stack (tests/test_readpath.py _fleet) drives the
        port's TpuLocalServer on the CPU (its summaries re-encoded into
        the port's classes, as in tests/test_torch_local_server_serving.py)."""
        from test_readpath import _fleet
        from test_torch_local_server_serving import with_foreign_storage

        from fluidframework_tpu_torch.server.local_server import \
            TpuLocalServer
        from fluidframework_tpu.telemetry import counters as jax_counters
        adopted = jax_counters.get("catchup.client.adopted")
        server = with_foreign_storage(TpuLocalServer(device="cpu"))
        loader, _conts, _chans = _fleet(server, n_ops=40, writers=1)
        server.refresh_catchup()
        loader.resolve("doc", client_details={"mode": "read"})
        mon = ServiceMonitor(device="cpu")
        try:
            mon.watch_readpath("readpath", server)
            rep = mon.report()["probes"]["readpath"]
            assert rep["catchup"]["artifacts"] >= 1
            assert rep["catchup"]["hits"] >= 1
            assert rep["broadcaster"]["shards"] == 0  # inline default
            # The adopting client is the JAX package's: it counts the
            # adoption in the JAX process counters, and the port's probe
            # reports the port's (its own server-side counters).
            assert jax_counters.get("catchup.client.adopted") >= adopted + 1
            assert rep["clientAdoptions"] == counters.get(
                "catchup.client.adopted")
            health = mon.health()
            assert health["checks"]["readpath"]["ok"]
        finally:
            mon._httpd.server_close()

    def test_health_block_and_gauges(self):
        from fluidframework_tpu_torch.protocol.messages import (
            DocumentMessage, MessageType)
        from fluidframework_tpu_torch.server.local_server import LocalServer
        from fluidframework_tpu_torch.server.routing import doc_shard
        server = LocalServer(partitions=4, auto_pump=False)
        conn = server.connect("mon-doc")
        conn.submit([DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION,
            contents={"pos": 0, "text": "x", "kind": "insert",
                      "channel": "t"})])
        monitor = ServiceMonitor(device="cpu").start()
        try:
            monitor.watch_partitions("ingest", server)
            report = monitor.report()["probes"]["ingest"]
            assert len(report["partitions"]) == 4
            assert report["router"] == {"scheme": "md5", "partitions": 4}
            home = doc_shard("mon-doc", 4)
            lag = {r["partition"]: r["lag"]
                   for r in report["partitions"]}
            assert lag[home] == 2  # join + op, unpumped
            assert report["totalLag"] == 2
            assert report["hottest"] == home
            snap = counters.snapshot()
            assert snap.get(
                f"ingest.partition_lag.p{home}") == 2.0
            server.pump()
            report = monitor.report()["probes"]["ingest"]
            assert report["totalLag"] == 0
        finally:
            monitor.stop()

    def test_tenant_churn_soak_bounds_exposition(self, monkeypatch):
        monkeypatch.setattr(counters, "FAMILY_CAP", 8)
        mon = ServiceMonitor(device="cpu").start()
        try:
            sizes = []
            for round_ in range(3):
                for i in range(200):
                    counters.increment(counters.bounded(
                        "soak.tenant", f"t{round_}_{i}"))
                sizes.append(len(mon.prometheus()))
            # The exposition stops growing once the family cap is hit.
            assert sizes[1] == sizes[2]
        finally:
            mon.stop()

    def test_watch_summaries_reports(self):
        from fluidframework_tpu_torch.server.tpu_sequencer import \
            MergeLaneStore
        store = MergeLaneStore(capacities=(64,), lanes_per_bucket=8,
                               device="cpu")
        key = ("d", "s", "t")
        store.apply({key: [store.builder.insert_text(0, "hi", 0, 0, 1)]})
        mon = ServiceMonitor(port=0, device="cpu").start()
        try:
            mon.watch_summaries("summaries", store)
            report = mon.report()["probes"]["summaries"]
            assert report["dirtyLanes"] == 1  # never summarized yet
            store.extract_all()
            report = mon.report()["probes"]["summaries"]
            assert report["dirtyLanes"] == 0
            assert report["cachedBlobs"] == 1
            assert 0.0 <= report["blobCacheHitRate"] <= 1.0
            health = mon.health()
            assert "summarize.bytes_d2h" in health["counters"]
        finally:
            mon.stop()


class TestMonitorSurfaces:
    @pytest.fixture(autouse=True)
    def _fresh_ledger(self):
        from fluidframework_tpu_torch.telemetry import compile_ledger
        compile_ledger.ledger.reset()
        yield
        compile_ledger.ledger.reset()

    def test_health_carries_ledger_and_device_stats(self):
        counters.increment("device.serving.ops_insert", 3)
        counters.increment("host.serving.ops_insert", 3)
        mon = ServiceMonitor(device="cpu").start()
        try:
            health = mon.health()
            assert "compileLedger" in health
            assert {"symbols", "totals"} <= set(health["compileLedger"])
            assert health["deviceStats"][
                "device.serving.ops_insert"] == 3
            assert health["deviceReconcile"] is None
            counters.increment("device.serving.ops_insert", 2)
            health = mon.health()
            assert health["deviceReconcile"] == {
                "ops_insert": (5, 3)}
        finally:
            mon.stop()

    def test_prometheus_carries_compile_gauges(self):
        import torch

        from fluidframework_tpu_torch.telemetry.counters import \
            JitRetraceProbe

        probed = JitRetraceProbe(lambda x: x + 7, name="test.prom_sym")
        probed(torch.ones(3))
        mon = ServiceMonitor(device="cpu").start()
        try:
            prom = mon.prometheus()
        finally:
            mon.stop()
        assert 'fluid_compile_compiles{symbol="test.prom_sym"}' in prom
        assert "fluid_compile_total_ms" in prom

    def test_profile_endpoint_captures_bounded_trace(self):
        import os

        mon = ServiceMonitor(device="cpu").start()
        try:
            with urllib.request.urlopen(
                    mon.url + "/profile?ms=40") as resp:
                payload = json.loads(resp.read())
            assert payload["ok"] is True
            assert payload["durationMs"] == 40.0
            assert os.path.isdir(payload["dir"])
            assert payload["files"] == ["trace.json"]
            with open(os.path.join(payload["dir"], "trace.json")) as f:
                assert "traceEvents" in json.load(f)
        finally:
            mon.stop()

    def test_profile_window_is_capped(self):
        mon = ServiceMonitor(device="cpu").start()
        try:
            assert mon._PROFILE_MAX_MS <= 5000.0
        finally:
            mon.stop()

    def test_profile_already_running_answers_503(self, monitor):
        """The JAX contract: a capture while another runs is an error
        reply ({"ok": false}, 503), not a second capture."""
        assert monitor._profile_lock.acquire(blocking=False)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(monitor.url + "/profile?ms=20")
            assert err.value.code == 503
            body = json.load(err.value)
            assert body["ok"] is False and "in progress" in body["error"]
        finally:
            monitor._profile_lock.release()


# ---------------------------------------------------------------------------
# Differentials: the JAX monitor and the port's on the same seeded events.
# ---------------------------------------------------------------------------

def _packages():
    from fluidframework_tpu.server import monitor as jmon
    from fluidframework_tpu.telemetry import compile_ledger as jled
    from fluidframework_tpu.telemetry import counters as jcnt
    from fluidframework_tpu.telemetry import slo as jslo
    from fluidframework_tpu.telemetry import tracing as jtr
    from fluidframework_tpu.telemetry import watermarks as jwm

    from fluidframework_tpu_torch.server import monitor as tmon
    from fluidframework_tpu_torch.telemetry import compile_ledger as tled
    from fluidframework_tpu_torch.telemetry import slo as tslo
    from fluidframework_tpu_torch.telemetry import watermarks as twm
    jax_pkg = SimpleNamespace(mon=jmon, counters=jcnt, tracing=jtr,
                              wm=jwm, ledger=jled.ledger, slo=jslo, kw={})
    port = SimpleNamespace(mon=tmon, counters=counters, tracing=tracing,
                           wm=twm, ledger=tled.ledger, slo=tslo,
                           kw={"device": "cpu"})
    return jax_pkg, port


def _reset(pkg):
    pkg.counters.reset()
    pkg.tracing.reset()
    pkg.wm.reset()
    pkg.ledger.reset()


@pytest.fixture()
def both_packages():
    pkgs = _packages()
    for pkg in pkgs:
        _reset(pkg)
    yield pkgs
    for pkg in pkgs:
        _reset(pkg)


def _seeded_events(pkg, seed: int, clock) -> None:
    """The same counters, histogram samples (with trace-id exemplars and
    an adversarial stage name), watermarks on one fake clock, compile
    ledger entries and sampled spans, for either package."""
    rng = random.Random(seed)
    pkg.wm.set_clock(clock)
    pkg.tracing.configure(sample=1)
    for i in range(60):
        pkg.counters.increment(f"ops.k{rng.randrange(6)}",
                               rng.randrange(1, 9))
        pkg.counters.observe(
            rng.choice(["serving.flush", "deli.ticket", 'we"i\\rd\nst']),
            rng.random() * 400, trace_id=f"t{seed}-{i}")
        if i % 7 == 0:
            pkg.counters.gauge(pkg.counters.bounded(
                "ingest.partition_lag", f"p{i % 3}"), rng.randrange(50))
            clock.now += 0.25
            pkg.wm.advance(pkg.wm.RAW_END, i % 2, i + 9)
            pkg.wm.advance(pkg.wm.RAW_INGESTED, i % 2, i + 4)
    pkg.counters.record_swallow("monitor.test_site")
    pkg.ledger.note_call("sym.apply", 12.5, grew=1)
    pkg.ledger.note_call("sym.apply", 0.5)
    pkg.ledger.note_call("sym.ticket", 3.25, grew=1)
    clock.now += 1.5


def _monitor(pkg, clock):
    burn = pkg.slo.BurnRateEngine(
        [pkg.slo.Objective("flush", 0.99, "flushes inside budget"),
         pkg.slo.Objective("lag", 0.9)], clock=clock,
        fast_window_s=10.0, slow_window_s=60.0)
    for t in range(40):
        burn.record("flush", good=5, bad=t % 3, now=float(t))
        burn.record("lag", good=t % 4, bad=1, now=float(t))
    mon = pkg.mon.ServiceMonitor(burn=burn, **pkg.kw)
    mon.metrics.increment("alfred.ops", 3)
    mon.metrics.write_latency("alfred.submit", 2.5)
    mon.add_probe("static", lambda: {"n": 1, "docs": ["a", "b"]})
    return mon


@pytest.mark.parametrize("seed", [0, 7])
def test_exposition_health_and_report_equal_jax(both_packages, seed):
    """/metrics.prom byte-equal, /health and /metrics JSON equal (uptimeS,
    the one wall-clock field, compared by name only) after the same seeded
    events on one fake clock."""
    out = []
    for pkg in both_packages:
        clock = FakeClock(50.0)
        _seeded_events(pkg, seed, clock)
        mon = _monitor(pkg, clock)
        try:
            with pkg.tracing.span("stage.root", root=True):
                pass
            out.append((mon.prometheus(), mon.health(), mon.report()))
        finally:
            mon._httpd.server_close()
            pkg.wm.set_clock(time.monotonic)
    (jprom, jhealth, jrep), (tprom, thealth, trep) = out
    assert tprom == jprom
    assert "# EOF" in tprom and 'trace_id="t' in tprom
    assert set(thealth) == set(jhealth)
    del thealth["uptimeS"], jhealth["uptimeS"]
    assert json.loads(json.dumps(thealth)) == json.loads(json.dumps(jhealth))
    assert trep == jrep


def test_burn_rate_verdicts_equal_jax():
    """BurnRateEngine on one fake clock: the same seeded good/bad stream
    gives the same burn rates, breaches and attribution at every step."""
    from fluidframework_tpu.telemetry import slo as jslo

    from fluidframework_tpu_torch.telemetry import slo as tslo
    verdicts = []
    for slo in (jslo, tslo):
        rng = random.Random(5)
        clock = FakeClock(0.0)
        engine = slo.BurnRateEngine(
            [slo.Objective("worker_health", 0.99, "scrapes ok"),
             slo.Objective("fleet_lag", 0.95)], clock=clock,
            fast_window_s=30.0, slow_window_s=300.0, bucket_s=5.0)
        seen = []
        for step in range(400):
            clock.now += rng.choice([0.5, 1.0, 3.0, 7.0])
            burst = step // 80 % 2 == 1     # failures come in waves
            engine.record("worker_health", good=rng.randrange(4),
                          bad=rng.randrange(3) if burst else 0)
            engine.record("fleet_lag", good=1,
                          bad=int(burst and rng.random() < 0.5))
            if step % 9 == 0:
                seen.append(engine.evaluate())
                seen.append(engine.burn_rates("fleet_lag",
                                              now=clock.now + 2.0))
        verdicts.append(seen)
    assert verdicts[0] == verdicts[1]
    assert any(not v["ok"] for v in verdicts[1] if isinstance(v, dict))
    with pytest.raises(ValueError):
        tslo.Objective("x", 1.0)
    with pytest.raises(KeyError):
        tslo.BurnRateEngine([]).record("missing", good=1)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_agents.py::TestServiceMonitor,
# tests/test_capacity.py::TestWatchCapacity (its probe reads a record file
# or a callable, no unported module) and
# tests/test_static_analysis.py::...::test_monitor_healthz_exports_counters.
# ---------------------------------------------------------------------------

class TestAgentsServiceMonitor:
    def test_metrics_and_health(self):
        metrics = MetricClient()
        metrics.increment("ops", 5)
        metrics.write_latency("ticket", 1.5)
        metrics.write_latency("ticket", 3.5)
        monitor = ServiceMonitor(metrics=metrics, device="cpu").start()
        monitor.add_probe("static", lambda: {"alive": True})
        try:
            with urllib.request.urlopen(f"{monitor.url}/metrics") as resp:
                report = json.load(resp)
            assert report["metrics"]["counters"]["ops"] == 5
            assert report["metrics"]["latencies"]["ticket"]["count"] == 2
            assert report["probes"]["static"]["alive"] is True
            with urllib.request.urlopen(f"{monitor.url}/health") as resp:
                assert json.load(resp)["ok"] is True
        finally:
            monitor.stop()

    def test_failing_probe_unhealthy(self):
        monitor = ServiceMonitor(device="cpu").start()
        monitor.add_probe("broken", lambda: 1 / 0)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{monitor.url}/health")
            assert err.value.code == 503
            assert json.load(err.value)["checks"]["broken"]["ok"] is False
        finally:
            monitor.stop()

    def test_monitor_healthz_exports_counters(self):
        counters.record_swallow("test.healthz")
        mon = ServiceMonitor(device="cpu").start()
        try:
            body = json.loads(urllib.request.urlopen(
                mon.url + "/healthz", timeout=5).read())
            assert body["counters"]["swallowed.test.healthz"] == 1.0
            report = mon.report()
            assert report["counters"]["swallowed.test.healthz"] == 1.0
        finally:
            mon.stop()


class TestWatchCapacity:
    from test_capacity import TestWatchCapacity as _Jax
    RECORD = _Jax.RECORD

    def test_surfaces_record_and_gauges(self, tmp_path):
        path = tmp_path / "BENCH_E2E_LAST.json"
        path.write_text(json.dumps(self.RECORD))
        mon = ServiceMonitor(device="cpu").start()
        try:
            mon.watch_capacity("capacity", str(path))
            health = json.load(urllib.request.urlopen(
                mon.url + "/health"))
            assert health["checks"]["capacity"]["ok"]
            report = json.load(urllib.request.urlopen(
                mon.url + "/metrics"))
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
            health = json.load(urllib.request.urlopen(
                mon.url + "/health"))
            assert health["ok"]
            report = json.load(urllib.request.urlopen(
                mon.url + "/metrics"))
            assert report["probes"]["capacity"] == {"available": False}
        finally:
            mon.stop()

    def test_callable_source(self):
        mon = ServiceMonitor(device="cpu")
        try:
            mon.watch_capacity("capacity", lambda: self.RECORD)
            probe = mon.report()["probes"]["capacity"]
            assert probe["available"] and probe["bottleneck"] == "serving"
        finally:
            mon._httpd.server_close()
