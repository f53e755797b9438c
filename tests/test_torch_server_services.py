"""The port's server services in the JAX package's other tests: mirrors of
tests/test_tpu_serving.py::TestTpuClusterTakeover,
tests/test_resilience.py::TestStickyDegradationWithHistorian,
tests/test_compat.py::TestPackageRegistry, tests/test_agents.py::TestGateway,
tests/test_signals.py's TestTpuServingPath, TestMultiNodeProxy and
TestNetworkSignals, and tests/test_readonly.py::TestNetworkReadMode, every
assertion run through fluidframework_tpu_torch on the CPU; the monitor's
watch_durable over each package's DurableMessageLog; and the entry points
that build a device pipeline raising without CUDA unless asked for the
CPU.

Every wait on a socket has a deadline (`wait_until`, the drivers' own
timeouts).
"""

import functools
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.register_collection import (
    ConsensusRegisterCollection,
)
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as _container
from fluidframework_tpu_torch.loader.code_loader import CodeLoader
from fluidframework_tpu_torch.loader.drivers.local import (
    LocalDocumentServiceFactory,
)
from fluidframework_tpu_torch.server import local_server
from fluidframework_tpu_torch.telemetry import counters as port_counters

torch.set_num_threads(1)

Loader = functools.partial(_container.Loader, device="cpu")
TpuLocalServer = functools.partial(local_server.TpuLocalServer, device="cpu")
LocalServer = local_server.LocalServer


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global, as the JAX
    package's are (tests/conftest.py resets those after every test): the
    monitors' /health verdicts here read serving.flush, so another file's
    flush tail on the same worker must not reach them."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


def wait_until(predicate, timeout=10.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# --- mirrors tests/test_tpu_serving.py::TestTpuClusterTakeover -------------

class TestTpuClusterTakeover:
    def test_owner_death_takeover_resumes_on_tpu_sequencer(self):
        from fluidframework_tpu_torch.loader.drivers.cluster import (
            ClusterDocumentServiceFactory,
        )
        from fluidframework_tpu_torch.server.nodes import Cluster

        cluster = Cluster(server_cls=TpuLocalServer)
        node_a = cluster.create_node("A")
        node_b = cluster.create_node("B")

        fa = ClusterDocumentServiceFactory(cluster, node_a)
        la = Loader(fa)
        c1 = la.create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        text = ds.create_channel("text", SharedString.TYPE)
        c1.attach()
        text.insert_text(0, "written-on-A")
        seq_before = c1.delta_manager.last_sequence_number
        assert seq_before > 0

        node_a.stop()
        assert not c1.connected

        fa.set_node(node_b)
        c1.reconnect()
        assert c1.connected
        assert cluster.reservations.owner("doc") == "B"
        text.insert_text(text.get_length(), "/continued-on-B")
        assert c1.delta_manager.last_sequence_number > seq_before

        c2 = Loader(ClusterDocumentServiceFactory(cluster, node_b)
                    ).resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == text.get_text() == \
            "written-on-A/continued-on-B"
        core_b = node_b.cores["doc"]
        assert core_b.sequencer().channel_text(
            "doc", "default", "text") == text.get_text()


# --- mirrors tests/test_resilience.py::TestStickyDegradationWithHistorian --

class TestStickyDegradationWithHistorian:
    class _Rest:
        def __init__(self, script, calls):
            self.script = script
            self.calls = calls

        def get(self, path):
            self.calls.append(path)
            action = self.script.pop(0) if self.script else "ok"
            if action == "ok":
                from fluidframework_tpu_torch.protocol.summary import (
                    SummaryType)
                return {"summary": {"type": SummaryType.TREE,
                                    "entries": {}}}
            raise action

    def _storage(self, historian_script):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            NetworkDocumentStorageService)
        direct_calls, tier_calls = [], []
        script = list(historian_script)
        svc = NetworkDocumentStorageService(
            lambda: self._Rest([], direct_calls), "t", "d",
            historian_factory=lambda: self._Rest(script, tier_calls))
        return svc, direct_calls, tier_calls

    def test_503_degrades_sticky_to_direct(self):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            RestError)
        svc, direct, tier = self._storage(
            [RestError(503, "tier lost upstream")] * 10)
        assert svc.get_summary() is not None
        assert len(tier) == 1 and len(direct) == 1
        svc.get_summary()
        assert len(tier) == 1 and len(direct) == 2

    def test_429_throttle_does_not_mark_tier_down(self):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            RestError)
        svc, direct, tier = self._storage(
            [RestError(429, "throttled"), "ok"])
        with pytest.raises(RestError) as exc:
            svc.get_summary()
        assert exc.value.status == 429
        assert direct == []
        assert svc.get_summary() is not None
        assert len(tier) == 2 and direct == []


# --- mirrors tests/test_compat.py::TestPackageRegistry ---------------------

class TestPackageRegistry:
    def test_publish_resolve_versions(self):
        from fluidframework_tpu_torch.server.package_registry import (
            PackageStore)
        store = PackageStore()
        store.publish("app", "1.0.0", {"entry": "v1"})
        store.publish("app", "1.4.0", {"entry": "v14"})
        store.publish("app", "2.0.0", {"entry": "v2"})
        assert store.versions("app") == ["1.0.0", "1.4.0", "2.0.0"]
        assert store.resolve("app", "^1.0.0")["version"] == "1.4.0"
        assert store.resolve("app", "2.0.0")["manifest"] == {"entry": "v2"}
        assert store.resolve("app", "^3.0.0") is None

    def test_rest_and_code_loader_install(self):
        from fluidframework_tpu_torch.server.package_registry import (
            PackageRegistryService, RegistryCodeResolver)
        registry = PackageRegistryService().start()
        try:
            req = urllib.request.Request(
                f"{registry.url}/packages/%40scope%2Fapp/1.2.0",
                data=json.dumps({"factory": "clicker"}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert resp.status == 201
            with urllib.request.urlopen(
                    f"{registry.url}/packages/%40scope%2Fapp",
                    timeout=10) as resp:
                assert json.load(resp)["versions"] == ["1.2.0"]
            built = []

            def interpreter(manifest):
                built.append(manifest)
                return f"factory:{manifest['factory']}"

            resolver = RegistryCodeResolver(registry.url, interpreter)
            cl = CodeLoader()
            version = resolver.install_into(cl, "@scope/app", "^1.0.0")
            assert version == "1.2.0"
            module = cl.load({"package": "@scope/app", "version": "^1.0.0"})
            assert module.fluid_export == "factory:clicker"
            assert built == [{"factory": "clicker"}]
        finally:
            registry.stop()

    def test_duplicate_publish_conflicts(self):
        from fluidframework_tpu_torch.server.package_registry import (
            PackageStore)
        store = PackageStore()
        store.publish("x", "1.0.0", {})
        with pytest.raises(ValueError):
            store.publish("x", "1.0.0", {})


# --- mirrors tests/test_agents.py::TestGateway -----------------------------

def make_gateway_doc():
    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    ds.create_channel("text", SharedString.TYPE)
    ds.create_channel("insights", SharedMap.TYPE)
    ds.create_channel("tasks", ConsensusRegisterCollection.TYPE)
    c1.attach()
    return server, loader, c1


class TestGateway:
    def test_serves_document_state(self):
        from fluidframework_tpu_torch.server.gateway import GatewayService
        server, loader, c1 = make_gateway_doc()
        ds = c1.runtime.get_datastore("default")
        ds.get_channel("text").insert_text(0, "served text")
        gw = GatewayService(Loader(
            LocalDocumentServiceFactory(server))).start()
        try:
            with urllib.request.urlopen(f"{gw.url}/doc/doc",
                                        timeout=10) as resp:
                payload = json.load(resp)
            channels = payload["dataStores"]["default"]
            assert channels["text"]["text"] == "served text"
            with urllib.request.urlopen(f"{gw.url}/health",
                                        timeout=10) as resp:
                assert json.load(resp)["ok"] is True
            ds.get_channel("text").insert_text(0, "updated ")
            with urllib.request.urlopen(f"{gw.url}/doc/doc",
                                        timeout=10) as resp:
                payload = json.load(resp)
            assert payload["dataStores"]["default"]["text"]["text"] \
                == "updated served text"
        finally:
            gw.stop()

    def test_unknown_document_404(self):
        from fluidframework_tpu_torch.server.gateway import GatewayService
        server, loader, c1 = make_gateway_doc()
        gw = GatewayService(Loader(
            LocalDocumentServiceFactory(server))).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{gw.url}/doc/nope", timeout=10)
            assert err.value.code == 404
        finally:
            gw.stop()


# --- mirrors tests/test_signals.py (three classes) -------------------------

def make_signal_doc(server, doc_id="sig-doc"):
    loader = Loader(LocalDocumentServiceFactory(server))
    container = loader.create_detached(doc_id)
    ds = container.runtime.create_datastore("default")
    return loader, container, ds


class TestTpuServingPath:
    def test_signals_over_tpu_sequencer_server(self):
        server = TpuLocalServer()
        loader, c1, _ = make_signal_doc(server)
        c1.attach()
        c2 = loader.resolve("sig-doc")
        got = []
        c2.runtime.on("signal", lambda t, c, local, cid: got.append((t, c)))
        seq_before = server.sequence_number("sig-doc")
        c1.submit_signal("presence", {"user": "a"})
        assert got == [("presence", {"user": "a"})]
        assert server.sequence_number("sig-doc") == seq_before


class TestMultiNodeProxy:
    def test_signal_crosses_proxy_connection(self):
        from fluidframework_tpu_torch.loader.drivers.cluster import (
            ClusterDocumentServiceFactory)
        from fluidframework_tpu_torch.server.nodes import Cluster

        cluster = Cluster()
        owner = cluster.create_node("n1")
        entry = cluster.create_node("n2")
        owner_loader = Loader(ClusterDocumentServiceFactory(cluster, owner))
        c1 = owner_loader.create_detached("prox-doc")
        c1.runtime.create_datastore("default")
        c1.attach()
        proxy_loader = Loader(ClusterDocumentServiceFactory(cluster, entry))
        c2 = proxy_loader.resolve("prox-doc")

        got_c2, got_c1 = [], []
        c2.runtime.on("signal", lambda t, c, local, cid: got_c2.append(t))
        c1.runtime.on("signal", lambda t, c, local, cid: got_c1.append(t))
        c2.submit_signal("from-proxy-client", None)
        c1.submit_signal("from-owner-client", None)
        assert got_c1 == ["from-proxy-client", "from-owner-client"]
        assert got_c2 == ["from-proxy-client", "from-owner-client"]


class TestNetworkSignals:
    @pytest.fixture(scope="class")
    def server(self):
        from fluidframework_tpu_torch.server.tinylicious import Tinylicious
        with Tinylicious() as t:
            yield t

    def test_signal_over_real_websockets(self, server):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            NetworkDocumentServiceFactory)
        from fluidframework_tpu_torch.server.tinylicious import (
            DEFAULT_TENANT)

        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT)
        loader = Loader(factory)
        c1 = loader.create_detached("net-sig")
        c1.runtime.create_datastore("default")
        with c1.op_lock:
            c1.attach()
        c2 = loader.resolve("net-sig")

        got = []
        c2.runtime.on("signal", lambda t, c, local, cid:
                      got.append((t, c, local)))
        with c1.op_lock:
            c1.submit_signal("wave", {"emoji": "hi"})
        assert wait_until(lambda: len(got) == 1)
        assert got[0] == ("wave", {"emoji": "hi"}, False)
        c1.close()
        c2.close()


# --- mirrors tests/test_readonly.py::TestNetworkReadMode -------------------

class TestNetworkReadMode:
    def test_read_mode_over_real_sockets(self):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            NetworkDocumentServiceFactory)
        from fluidframework_tpu_torch.server.tinylicious import (
            DEFAULT_TENANT, Tinylicious)
        with Tinylicious() as t:
            loader = Loader(
                NetworkDocumentServiceFactory(t.url, DEFAULT_TENANT))
            c1 = loader.create_detached("net-ro")
            ds = c1.runtime.create_datastore("default")
            text = ds.create_channel("text", SharedString.TYPE)
            with c1.op_lock:
                text.insert_text(0, "over the wire")
                c1.attach()
            ro = loader.resolve("net-ro", client_details={"mode": "read"})
            t_ro = ro.runtime.get_datastore("default").get_channel("text")
            assert t_ro.get_text() == "over the wire"
            with c1.op_lock:
                text.insert_text(0, ">> ")
            assert wait_until(lambda: t_ro.get_text() == ">> over the wire")
            assert ro.delta_manager.client_id not in c1.audience.members
            c1.close()
            ro.close()


# --- the monitor's watch_durable, both packages ----------------------------

@pytest.mark.parametrize("package", ["fluidframework_tpu",
                                     "fluidframework_tpu_torch"])
def test_watch_durable_reports_the_group_commit_engine(package, tmp_path):
    """ServiceMonitor.watch_durable over a DurableMessageLog (the
    deployment's broker with storage.log set, server/main.py run_broker):
    /metrics carries the engine's stats as the probe's entry and /health
    passes the probe; a log without durable_stats reads as
    unavailable."""
    import importlib

    durable = importlib.import_module(f"{package}.server.durable")
    monitor = importlib.import_module(f"{package}.server.monitor")
    log_mod = importlib.import_module(f"{package}.server.log")
    kwargs = {"device": "cpu"} if package.endswith("_torch") else {}
    log = durable.DurableMessageLog(str(tmp_path / "log"),
                                    default_partitions=2)
    mon = monitor.ServiceMonitor(**kwargs)
    mon.watch_durable("broker", log)
    mon.watch_durable("plain", log_mod.MessageLog())
    mon.start()
    try:
        for p in range(2):
            log.send_to_many("raw", p, [("k", {"i": i}) for i in range(3)])
        log.commit_many("deli", "raw", {0: 2, 1: 1})
        with urllib.request.urlopen(f"{mon.url}/health", timeout=10) as r:
            health = json.load(r)
        with urllib.request.urlopen(f"{mon.url}/metrics", timeout=10) as r:
            probes = json.load(r)["probes"]
        want = dict(log.durable_stats(), available=True)
    finally:
        mon.stop()
        log.close()
    assert health["ok"] is True
    assert health["checks"]["broker"] == {"ok": True, "detail": "ok"}
    assert probes["plain"] == {"available": False}
    assert probes["broker"] == want
    assert want["segments"] >= 2 and want["pendingAppends"] == 0
    assert want["tornBytesTruncated"] == 0


def test_watch_durable_equal_across_packages(tmp_path):
    """The same appends and commits give the same probe entry."""
    import importlib

    entries = []
    for package in ("fluidframework_tpu", "fluidframework_tpu_torch"):
        durable = importlib.import_module(f"{package}.server.durable")
        log = durable.DurableMessageLog(str(tmp_path / package),
                                        default_partitions=3)
        for p in range(3):
            log.send_to_many("raw", p, [("k", {"i": i})
                                        for i in range(p + 1)])
            log.send_to("deltas", p, "k", {"p": p})
        log.commit_many("deli", "raw", {p: p for p in range(3)})
        entries.append(log.durable_stats())
        log.close()
    assert entries[1] == entries[0]


# --- entry points that build a device pipeline -----------------------------

class TestEntryPointsDefaultToTheCard:
    """Without device="cpu" and without CUDA each entry point raises
    instead of handing back CPU tensors."""

    @pytest.fixture(autouse=True)
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_build_worker_with_tpu_deli(self, tmp_path):
        from fluidframework_tpu_torch.server import main
        cfg = main.load_config(None)
        cfg["storage"] = {"db": str(tmp_path / "fluid.sqlite"),
                          "git": str(tmp_path / "git")}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main.build_worker(cfg, ["tpu-deli", "scriptorium"])
        # Nothing was opened before the device was resolved.
        assert not (tmp_path / "fluid.sqlite").exists()

    def test_cluster_on_its_first_owned_document(self):
        from fluidframework_tpu_torch.loader.drivers.cluster import (
            ClusterDocumentServiceFactory)
        from fluidframework_tpu_torch.server.nodes import Cluster
        cluster = Cluster(server_cls=local_server.TpuLocalServer)
        node = cluster.create_node("A")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            node.connect("doc")
        factory = ClusterDocumentServiceFactory(cluster, node)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _container.Loader(factory)

    def test_network_and_record_corpus_loaders(self):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            NetworkDocumentServiceFactory)
        from fluidframework_tpu_torch.server.tinylicious import (
            DEFAULT_TENANT, Tinylicious)
        from fluidframework_tpu_torch.testing import record_corpus
        with Tinylicious() as t:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                _container.Loader(NetworkDocumentServiceFactory(
                    t.url, DEFAULT_TENANT))
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                record_corpus.record_text(t, "unused", n_ops=4)

    def test_worker_device_key_defaults_to_the_card(self):
        from fluidframework_tpu_torch.server import main
        assert main.load_config(None)["worker"]["device"] is None
