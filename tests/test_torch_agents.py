"""The port's agents (fluidframework_tpu_torch/agents/: the intelligence
runner, the headless agent runner) with the gateway and service monitor
beside them: the mirror of the 10 cases of tests/test_agents.py. Each
scenario runs through both packages on the CPU and the published insights
must be equal (the runner's client id, which carries a random suffix,
only has to name the winner in each package). The intelligence runner
also runs over the port's TpuLocalServer(device="cpu")."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from importlib import import_module
from types import SimpleNamespace

import pytest
import torch

from fluidframework_tpu_torch.agents import (key_phrases, sentiment,
                                             text_analytics)
from fluidframework_tpu_torch.loader.container import Loader
from fluidframework_tpu_torch.loader.drivers.local import (
    LocalDocumentServiceFactory)
from fluidframework_tpu_torch.server.gateway import GatewayService
from fluidframework_tpu_torch.server.local_server import LocalServer
from fluidframework_tpu_torch.server.monitor import (MetricClient,
                                                     ServiceMonitor)
from fluidframework_tpu_torch.telemetry import counters as port_counters

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global: the flushes
    these tests drive must not reach another file's /health verdict on
    the same worker (tests/conftest.py resets only the JAX package's)."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


def package(name: str) -> SimpleNamespace:
    port = name == "fluidframework_tpu_torch"
    mods = {k: import_module(f"{name}.{m}") for k, m in (
        ("agents", "agents"), ("map", "dds.map"), ("seq", "dds.sequence"),
        ("reg", "dds.register_collection"),
        ("sched", "framework.agent_scheduler"),
        ("container", "loader.container"),
        ("local", "loader.drivers.local"),
        ("server", "server.local_server"))}
    return SimpleNamespace(port=port, dev={"device": "cpu"} if port else {},
                           **mods)


PORT, JAX = package("fluidframework_tpu_torch"), package("fluidframework_tpu")


def make_doc(pkg, tpu=False):
    server = pkg.server.TpuLocalServer(**pkg.dev) if tpu \
        else pkg.server.LocalServer()
    loader = pkg.container.Loader(
        pkg.local.LocalDocumentServiceFactory(server), **pkg.dev)
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    ds.create_channel("text", pkg.seq.SharedString.TYPE)
    ds.create_channel("insights", pkg.map.SharedMap.TYPE)
    ds.create_channel("tasks",
                      pkg.reg.ConsensusRegisterCollection.TYPE)
    c1.attach()
    return server, loader, c1


def wire_runner(pkg, container, batch_size=1):
    ds = container.runtime.get_datastore("default")
    scheduler = pkg.sched.AgentScheduler(container, ds.get_channel("tasks"))
    runner = pkg.agents.IntelligenceRunner(
        scheduler, ds.get_channel("text"), ds.get_channel("insights"),
        batch_size=batch_size)
    return runner, ds


def insights_of(container, winner_id):
    """The insights map with the runner's id replaced by whether it names
    the winner."""
    m = container.runtime.get_datastore("default").get_channel("insights")
    out = {k: m.get(k) for k in sorted(m.keys())}
    out["meta"] = dict(out["meta"],
                       runner=out["meta"]["runner"] == winner_id)
    return out


class TestProviders:
    def test_text_analytics(self):
        text = "Two words. One more sentence!"
        out = text_analytics(text)
        assert out["wordCount"] == 5 and out["sentenceCount"] == 2
        assert out == JAX.agents.text_analytics(text)

    def test_sentiment_polarity(self):
        assert sentiment("this is great and wonderful")["score"] > 0
        assert sentiment("terrible awful broken")["score"] < 0
        for text in ("good bad worst", "", "nice nice wrong"):
            assert sentiment(text) == JAX.agents.sentiment(text)

    def test_key_phrases_skips_stopwords(self):
        text = "the ocean and the ocean and waves"
        out = key_phrases(text)
        assert out["phrases"][0] == "ocean"
        assert "the" not in out["phrases"]
        assert out == JAX.agents.key_phrases(text)


def _single_runner(pkg, tpu):
    server, loader, c1 = make_doc(pkg, tpu)
    c2 = loader.resolve("doc")
    r1, ds1 = wire_runner(pkg, c1)
    r2, _ = wire_runner(pkg, c2)
    r1.start()
    r2.start()
    assert r1.is_runner != r2.is_runner  # exactly one wins
    winner = r1 if r1.is_runner else r2
    ds = ds1 if winner is r1 else c2.runtime.get_datastore("default")
    ds.get_channel("text").insert_text(0, "good good excellent ocean")
    if tpu:
        server.pump()
    win_id = winner.scheduler.container.delta_manager.client_id
    views = [insights_of(c, win_id) for c in (c1, c2)]
    assert views[0] == views[1]
    assert views[0]["sentiment"]["score"] > 0
    assert views[0]["textAnalytics"]["wordCount"] == 4
    assert views[0]["meta"]["runner"]
    return views[0], winner is r1, winner.runs


class TestIntelligenceRunner:
    @pytest.mark.parametrize("tpu", [False, True])
    def test_single_runner_wins_and_publishes(self, tpu):
        """Insights are visible to both clients (they ride normal map
        ops) and equal JAX's; over TpuLocalServer the JAX side runs on
        its scalar LocalServer (the insights do not depend on the
        deli)."""
        assert _single_runner(PORT, tpu) == _single_runner(JAX, False)

    def test_batching(self):
        def run(pkg):
            server, loader, c1 = make_doc(pkg)
            runner, ds = wire_runner(pkg, c1, batch_size=3)
            runner.start()
            text = ds.get_channel("text")
            base = runner.runs
            text.insert_text(0, "a")
            text.insert_text(0, "b")
            assert runner.runs == base  # below batch threshold
            text.insert_text(0, "c")
            assert runner.runs == base + 1
            return runner.runs, insights_of(
                c1, c1.delta_manager.client_id)

        assert run(PORT) == run(JAX)


def _headless(pkg):
    server, loader, c1 = make_doc(pkg)
    runners = []

    def agent_factory(container):
        runner, _ = wire_runner(pkg, container)
        runners.append(runner)
        return runner

    headless = pkg.agents.HeadlessAgentRunner(pkg.container.Loader(
        pkg.local.LocalDocumentServiceFactory(server), **pkg.dev))
    headless.launch("doc", [agent_factory])
    assert headless.running() == ["doc"]
    # The headless client (the only volunteer) is the intelligence runner.
    ds = c1.runtime.get_datastore("default")
    ds.get_channel("text").insert_text(0, "hello ocean world")
    assert [r.is_runner for r in runners] == [True]
    insights = insights_of(
        c1, runners[0].scheduler.container.delta_manager.client_id)
    assert insights["textAnalytics"]["wordCount"] == 3
    headless.close("doc")
    assert headless.running() == []
    return insights


class TestHeadlessRunner:
    def test_launch_close_and_agent_lifecycle(self):
        assert _headless(PORT) == _headless(JAX)


class TestGateway:
    def test_serves_document_state(self):
        server, loader, c1 = make_doc(PORT)
        ds = c1.runtime.get_datastore("default")
        ds.get_channel("text").insert_text(0, "served text")
        gw = GatewayService(Loader(LocalDocumentServiceFactory(server),
                                   device="cpu")).start()
        try:
            with urllib.request.urlopen(f"{gw.url}/doc/doc") as resp:
                payload = json.load(resp)
            channels = payload["dataStores"]["default"]
            assert channels["text"]["text"] == "served text"
            with urllib.request.urlopen(f"{gw.url}/health") as resp:
                assert json.load(resp)["ok"] is True
            # Live residency: a later edit is visible on re-GET.
            ds.get_channel("text").insert_text(0, "updated ")
            with urllib.request.urlopen(f"{gw.url}/doc/doc") as resp:
                payload = json.load(resp)
            assert payload["dataStores"]["default"]["text"]["text"] \
                == "updated served text"
        finally:
            gw.stop()

    def test_unknown_document_404(self):
        server, loader, c1 = make_doc(PORT)
        gw = GatewayService(Loader(LocalDocumentServiceFactory(server),
                                   device="cpu")).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{gw.url}/doc/nope")
            assert err.value.code == 404
        finally:
            gw.stop()


class TestServiceMonitor:
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

