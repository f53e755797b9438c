"""The port's load test (fluidframework_tpu_torch/testing/load_test.py),
its headless agents over a TpuLocalServer and its historian smoke, on the
CPU: the mirror of tests/test_quality_gates.py::TestLoadRig, the keystroke
load and the agents of testing/client_load_runs held to the committed JAX
golden (testing/golden/capacity_golden.json, "load" and "agents"), and
testing/historian_smoke.main(device="cpu")."""

from __future__ import annotations

import pytest
import torch

from fluidframework_tpu.loader.container import Loader as JaxLoader
from fluidframework_tpu.loader.drivers.local import \
    LocalDocumentServiceFactory as JaxFactory
from fluidframework_tpu.server.local_server import LocalServer as JaxServer
from fluidframework_tpu.testing import load_test as jax_load_test
from fluidframework_tpu_torch.loader.container import Loader
from fluidframework_tpu_torch.loader.drivers.local import \
    LocalDocumentServiceFactory
from fluidframework_tpu_torch.server.local_server import LocalServer
from fluidframework_tpu_torch.telemetry import counters as port_counters
from fluidframework_tpu_torch.testing import (client_load_runs, golden,
                                              historian_smoke, load_test)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global: the flushes
    these tests drive must not reach another file's /health verdict on
    the same worker (tests/conftest.py resets only the JAX package's)."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


def run_rig(port: bool, **profile):
    """tests/test_quality_gates.py's load rig on one package's scalar
    LocalServer: the result and every document's final view, read by a
    fresh client."""
    if port:
        server = LocalServer()
        new_loader = lambda: Loader(  # noqa: E731
            LocalDocumentServiceFactory(server), device="cpu")
        mod = load_test
    else:
        server = JaxServer()
        new_loader = lambda: JaxLoader(JaxFactory(server))  # noqa: E731
        mod = jax_load_test
    result = mod.LoadRunner(new_loader).run(mod.LoadProfile(**profile))
    assert result.converged, result.divergences
    final = {}
    for d in range(profile["documents"]):
        doc_id = f"load-doc-{d}"
        ds = new_loader().resolve(doc_id).runtime.get_datastore("load")
        m = ds.get_channel("map")
        final[doc_id] = {"map": {k: m.get(k) for k in sorted(m.keys())},
                         "text": ds.get_channel("text").get_text(),
                         "counter": ds.get_channel("counter").value}
    return result, final


class TestLoadRig:
    def test_profile_runs_and_converges(self):
        profile = dict(documents=2, clients_per_document=3,
                       ops_per_client=30, seed=5)
        result, final = run_rig(True, **profile)
        assert result.total_ops == 2 * 3 * 30
        assert result.ops_per_second > 0
        assert final == run_rig(False, **profile)[1]

    def test_reconnect_storm_still_converges(self):
        profile = dict(documents=1, clients_per_document=2,
                       ops_per_client=40, seed=11,
                       reconnect_probability=0.05)
        assert run_rig(True, **profile)[1] == run_rig(False, **profile)[1]


def test_keystroke_load_equals_jax_golden():
    """The keystroke trace with reconnect churn over TpuLocalServer
    (device="cpu"): every replica converges, the server's channel text
    equals the clients', and the texts equal the JAX package's."""
    got = client_load_runs.keystroke_load(
        client_load_runs.port_package("cpu"), client_load_runs.LOAD_SMALL)
    assert got.pop("elapsed_s") > 0
    want = dict(golden.load_capacity()["load"]["small"])
    assert want.pop("profile") == client_load_runs.LOAD_SMALL
    assert got == want


def test_agents_equal_jax_golden():
    """Two headless runners host the intelligence agent over
    TpuLocalServer(device="cpu"): exactly one wins and the insights equal
    the JAX package's."""
    got = client_load_runs.agents_run(client_load_runs.port_package("cpu"))
    assert got == golden.load_capacity()["agents"]
    assert got["runs"].count(0) == 1


def test_historian_smoke_passes_on_the_cpu(capsys):
    assert historian_smoke.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "historian-smoke: PASS" in out
    assert "degradation to direct GitStore OK" in out

