"""The port stands alone: no module of fluidframework_tpu_torch, and not
chip_smoke.py or calibrate_fused_apply.py, imports jax, jaxlib or the JAX package; its entry points
default to the card and raise when CUDA is absent instead of returning CPU
tensors."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fluidframework_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fluidframework_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "calibrate_fused_apply.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = sorted({root for root in _imported_roots(path)
                  if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _port_modules():
    return sorted(".".join(("fluidframework_tpu_torch",) + p.relative_to(
        PORT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("module", _port_modules())
def test_every_module_imports(module):
    """Every module of the port imports (and builds no kernel on
    import: nvcc is absent here)."""
    assert importlib.import_module(module).__name__ == module


def test_walker_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\n"
                     "from fluidframework_tpu.mergetree import kernel\n"
                     "from fluidframework_tpu_torch import interop\n")
    assert sorted(set(_imported_roots(probe)) & set(FORBIDDEN)) == \
        ["fluidframework_tpu", "jax"]


def test_entry_points_raise_without_cuda(monkeypatch):
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import catchup
    from fluidframework_tpu_torch.mergetree.state import (make_state,
                                                          state_from_numpy)
    from fluidframework_tpu_torch.server.ticket_kernel import \
        make_ticket_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_state(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_ticket_state(4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.packed_ops_from_numpy({}, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"length": [1]}, 4)
    tail = [({"type": 0, "pos1": 0, "seg": {"text": "x"}}, 1, 0, 1, 0)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        catchup.device_apply_tail([], tail, 0, 0)
    state = make_state(16, batch=2, device="cpu")
    assert state.length.device.type == "cpu"
    assert catchup.device_apply_tail([], tail, 0, 0, device="cpu")[0][
        "text"] == "x"


def test_slice_six_entry_points_raise_without_cuda(monkeypatch):
    """The client's bulk catch-up and the paged store default to the
    card too."""
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.mergetree.paging import PagedMergeStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tail = [({"type": 0, "pos1": 0, "seg": {"text": "x"}}, 1, 0, 1, 0)]
    client = MergeTreeClient(5)   # the scalar path needs no device
    client.apply_msg(*tail[0][:4])
    assert client.get_text() == "x"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MergeTreeClient(5).apply_bulk(tail)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedMergeStore()
    bulk = MergeTreeClient(5, device="cpu")
    bulk.apply_bulk(tail)
    assert bulk.get_text() == "x"


SLICE_SEVEN_MODULES = (
    "fluidframework_tpu_torch.protocol",
    "fluidframework_tpu_torch.protocol.messages",
    "fluidframework_tpu_torch.server.wire",
    "fluidframework_tpu_torch.server.log",
    "fluidframework_tpu_torch.server.lambdas",
    "fluidframework_tpu_torch.server.lambdas.base",
    "fluidframework_tpu_torch.telemetry.compile_ledger",
)


def test_slice_seven_modules_are_covered():
    """The sequencer's leaf modules are walked by the checks above, and
    the summarize path's functions sit in the modules that hold them."""
    assert set(SLICE_SEVEN_MODULES) <= set(_port_modules())
    from fluidframework_tpu_torch.mergetree import catchup, host, kernel
    from fluidframework_tpu_torch.telemetry import counters, device_stats
    for mod, names in (
            (kernel, ("extract_visible_batched", "compact_extract_batched",
                      "compact_extract_paged", "compact_extract_paged_keep",
                      "gather_rows_pow2", "pad_pow2_indices",
                      "fetch_extracted")),
            (host, ("assemble_entries", "assemble_snapshot",
                    "chunk_entries", "flatten_snapshot_content")),
            (catchup, ("pack_entries_narrow", "unpack_entries_narrow",
                       "translate_entry_clients")),
            (device_stats, ("fold_serve", "fold_paged", "fold_extract",
                            "begin_flush", "flush_facts", "snapshot",
                            "reconcile", "enabled", "set_enabled")),
            (counters, ("JitRetraceProbe",))):
        for name in names:
            assert callable(getattr(mod, name)), f"{mod.__name__}.{name}"


def test_slice_eight_lane_stores_raise_without_cuda(monkeypatch):
    """The sequencer's lane stores default to the card: without CUDA they
    raise instead of building CPU lanes; device="cpu" builds them."""
    from fluidframework_tpu_torch.server import tpu_sequencer

    assert "fluidframework_tpu_torch.server.tpu_sequencer" in \
        _port_modules()
    assert "fluidframework_tpu_torch.testing.lanes" in _port_modules()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tpu_sequencer.MergeLaneStore,
                 lambda: tpu_sequencer.MergeLaneStore(paged=True),
                 tpu_sequencer.LwwLaneStore):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for store in (tpu_sequencer.MergeLaneStore(device="cpu"),
                  tpu_sequencer.MergeLaneStore(paged=True, device="cpu"),
                  tpu_sequencer.LwwLaneStore(device="cpu")):
        assert store.device.type == "cpu"
    for name in ("MergeLaneStore", "LwwLaneStore", "_MergeBucket",
                 "_LwwBucket", "_LwwValueBlock", "_PagedFlushGroup",
                 "_stack_seed_rows", "_repad_batch", "_bucket",
                 "matrix_base_key", "lane_base_key",
                 "_compose_matrix_channels", "directory_route",
                 "_child_path", "_norm_path", "_flatten_directory",
                 "_nest_directory", "matrix_route", "looks_like_lww_op"):
        assert callable(getattr(tpu_sequencer, name)), name


SLICE_TEN_MODULES = (
    "fluidframework_tpu_torch.native",
    "fluidframework_tpu_torch.native.build",
    "fluidframework_tpu_torch.server.pump",
    "fluidframework_tpu_torch.server.database",
    "fluidframework_tpu_torch.server.lambdas.scriptorium",
    "fluidframework_tpu_torch.testing.ingest",
)


def test_slice_ten_lambda_is_covered_and_defaults_to_the_card(monkeypatch):
    """The lambda's modules are walked by the checks above; the lambda
    itself defaults to the card and raises without CUDA."""
    assert set(SLICE_TEN_MODULES) <= set(_port_modules())
    from fluidframework_tpu_torch.server import tpu_sequencer

    class Ctx:
        def checkpoint(self, *_):
            pass

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpu_sequencer.TpuSequencerLambda(Ctx(), emit=print, nack=print)
    lam = tpu_sequencer.TpuSequencerLambda(Ctx(), emit=print, nack=print,
                                           device="cpu")
    assert lam.tstate.next_seq.device.type == "cpu"
    assert lam.merge.device.type == lam.lww.device.type == "cpu"
    with pytest.raises(ValueError, match="merge_store lives on"):
        tpu_sequencer.TpuSequencerLambda(
            Ctx(), emit=print, nack=print, device="meta",
            merge_store=tpu_sequencer.MergeLaneStore(device="cpu"))


SLICE_ELEVEN_MODULES = (
    "fluidframework_tpu_torch.protocol.quorum",
    "fluidframework_tpu_torch.protocol.protocol_handler",
    "fluidframework_tpu_torch.protocol.summary",
    "fluidframework_tpu_torch.telemetry.watermarks",
    "fluidframework_tpu_torch.server.routing",
    "fluidframework_tpu_torch.server.cache",
    "fluidframework_tpu_torch.server.storage",
    "fluidframework_tpu_torch.server.readpath",
    "fluidframework_tpu_torch.server.admission",
    "fluidframework_tpu_torch.server.partition",
    "fluidframework_tpu_torch.server.sharding",
    "fluidframework_tpu_torch.server.lambdas.deli",
    "fluidframework_tpu_torch.server.lambdas.scribe",
    "fluidframework_tpu_torch.server.lambdas.broadcaster",
    "fluidframework_tpu_torch.server.lambdas.copier",
    "fluidframework_tpu_torch.server.lambdas.foreman",
    "fluidframework_tpu_torch.server.local_server",
    "fluidframework_tpu_torch.testing.server_runs",
)


def test_slice_eleven_local_server_is_covered_and_defaults_to_the_card(
        monkeypatch):
    """The local server's modules are walked by the checks above.
    TpuLocalServer defaults to the card and raises without CUDA; a device
    mesh, like the device, defaults to the card (make_mesh() raises
    without CUDA) and a mesh of CPU entries builds; the native message
    log is built and used."""
    assert set(SLICE_ELEVEN_MODULES) <= set(_port_modules())
    from fluidframework_tpu_torch.server import local_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        local_server.TpuLocalServer()
    server = local_server.TpuLocalServer(device="cpu", partitions=2)
    assert [s.device.type for s in server.ingest.sequencers()] == \
        ["cpu", "cpu"]
    from fluidframework_tpu_torch.parallel.mesh import Sharded, make_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    mesh = make_mesh(dp=2, devices=["cpu", "cpu"])
    on_mesh = local_server.TpuLocalServer(device="cpu", mesh=mesh,
                                          partitions=2)
    for lam in on_mesh.ingest.sequencers():
        assert lam.mesh is mesh and isinstance(lam.tstate.next_seq,
                                               Sharded)
    from fluidframework_tpu_torch.native.oplog import NativeMessageLog
    assert isinstance(local_server.LocalServer(native_log=True).log,
                      NativeMessageLog)
    assert isinstance(local_server.TpuLocalServer(
        device="cpu", native_log=True).log, NativeMessageLog)


SLICE_TWELVE_MODULES = (
    "fluidframework_tpu_torch.telemetry.slo",
    "fluidframework_tpu_torch.server.monitor",
    "fluidframework_tpu_torch.server.observatory",
    "fluidframework_tpu_torch.native.oplog",
    "fluidframework_tpu_torch.server.decay_probe",
    "fluidframework_tpu_torch.tools",
    "fluidframework_tpu_torch.tools.microbench",
    "fluidframework_tpu_torch.tools.gpu_conformance",
    "fluidframework_tpu_torch.server.bridge",
)


def _top_level_imports(path: Path):
    """Roots imported at module level (not inside a function or class)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_slice_twelve_is_covered_and_grpc_is_lazy():
    """The operator's surface is walked by the checks above (no jax, no
    JAX package); grpc is imported only inside the functions that need it
    (the bridge's transport and the broker's, where the JAX modules
    import it), never when a module loads."""
    assert set(SLICE_TWELVE_MODULES) <= set(_port_modules())
    lazy = []
    for path in _port_files():
        roots = set(_imported_roots(path))
        assert "grpc" not in set(_top_level_imports(path)), path
        if "grpc" in roots:
            lazy.append(str(path.relative_to(REPO)))
    assert lazy == ["fluidframework_tpu_torch/server/bridge.py",
                    "fluidframework_tpu_torch/server/log_service.py"]


SLICE_FIFTEEN_MODULES = tuple(
    f"fluidframework_tpu_torch.{m}" for m in (
        "server.websocket", "server.auth", "server.document_router",
        "server.log_service", "server.durable", "server.historian",
        "server.alfred", "server.tinylicious", "server.package_registry",
        "server.gateway", "server.nodes", "server.main",
        "loader.drivers.routerlicious", "loader.drivers.mux",
        "loader.drivers.cluster", "testing.record_corpus"))


def test_slice_fifteen_is_covered():
    """The server services keep the JAX modules' names and are walked by
    the checks above, with no exception list."""
    assert len(SLICE_FIFTEEN_MODULES) == 16
    assert set(SLICE_FIFTEEN_MODULES) <= set(_port_modules())
    for module in SLICE_FIFTEEN_MODULES:
        rel = module.split(".", 1)[1].replace(".", "/") + ".py"
        assert (REPO / "fluidframework_tpu" / rel).exists(), rel


def test_slice_twelve_entry_points_raise_without_cuda(monkeypatch):
    """The monitor (its /profile device), the bridge, the decay probe, the
    microbench's kernel probe and the conformance tool take the card by
    default and raise (or, for the tool's main, exit 2) without CUDA;
    device="cpu" builds each."""
    from fluidframework_tpu_torch.server import bridge, decay_probe, monitor
    from fluidframework_tpu_torch.tools import gpu_conformance, microbench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (monitor.ServiceMonitor, bridge.OpBridge,
                 lambda: decay_probe.run(2, 1, 4),
                 lambda: microbench.probe_kernel_throughput(2, 2),
                 lambda: gpu_conformance.check(2, 2, 16, 0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert gpu_conformance.main([]) == 2
    mon = monitor.ServiceMonitor(device="cpu")
    try:
        assert mon.device.type == "cpu"
    finally:
        mon._httpd.server_close()
    assert bridge.OpBridge(device="cpu").device.type == "cpu"


SLICE_THIRTEEN_MODULES = (
    "fluidframework_tpu_torch.telemetry.logger",
    "fluidframework_tpu_torch.telemetry.mock",
    "fluidframework_tpu_torch.dds.shared_object",
    "fluidframework_tpu_torch.dds.map",
    "fluidframework_tpu_torch.dds.directory",
    "fluidframework_tpu_torch.dds.sequence",
    "fluidframework_tpu_torch.dds.matrix",
    "fluidframework_tpu_torch.dds.counter",
    "fluidframework_tpu_torch.dds.cell",
    "fluidframework_tpu_torch.dds.register_collection",
    "fluidframework_tpu_torch.dds.ordered_collection",
    "fluidframework_tpu_torch.dds.ink",
    "fluidframework_tpu_torch.dds.summary_block",
    "fluidframework_tpu_torch.dds.sparse_matrix",
    "fluidframework_tpu_torch.runtime.pending_state",
    "fluidframework_tpu_torch.runtime.blob_manager",
    "fluidframework_tpu_torch.runtime.summarizer",
    "fluidframework_tpu_torch.runtime.datastore_runtime",
    "fluidframework_tpu_torch.runtime.container_runtime",
    "fluidframework_tpu_torch.loader.drivers.base",
    "fluidframework_tpu_torch.loader.delta_scheduler",
    "fluidframework_tpu_torch.loader.delta_manager",
    "fluidframework_tpu_torch.loader.container",
    "fluidframework_tpu_torch.loader.drivers.local",
    "fluidframework_tpu_torch.testing.mocks",
    "fluidframework_tpu_torch.testing.client_runs",
    "fluidframework_tpu_torch.core.config",
)


def test_slice_thirteen_client_stack_is_covered_and_defaults_to_the_card(
        monkeypatch):
    """The client stack's modules are walked by the checks above (no jax,
    no JAX package). The Loader, a Container, a ContainerRuntime and the
    mock environment take the card by default and raise without CUDA;
    device="cpu" reaches every channel, and the route of a CPU channel
    never picks the device."""
    assert set(SLICE_THIRTEEN_MODULES) <= set(_port_modules())
    from fluidframework_tpu_torch.dds.sequence import SharedString
    from fluidframework_tpu_torch.loader.container import Loader
    from fluidframework_tpu_torch.loader.drivers.local import \
        LocalDocumentServiceFactory
    from fluidframework_tpu_torch.runtime.container_runtime import \
        ContainerRuntime
    from fluidframework_tpu_torch.server.local_server import LocalServer
    from fluidframework_tpu_torch.testing.mocks import \
        MockSequencedEnvironment

    factory = LocalDocumentServiceFactory(LocalServer())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Loader(factory), ContainerRuntime,
                 MockSequencedEnvironment):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    loader = Loader(factory, device="cpu")
    container = loader.create_detached("doc")
    text = container.runtime.create_datastore("default").create_channel(
        "text", SharedString.TYPE)
    assert loader.device.type == container.runtime.device.type == \
        text.device.type == "cpu"
    # An unbound channel takes the port's default device: the card, which
    # is not there.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SharedString("unbound").device


SLICE_SIXTEEN_MODULES = tuple(
    f"fluidframework_tpu_torch.{m}" for m in (
        "capacity", "capacity.workload", "capacity.grader", "capacity.fleet",
        "agents", "agents.headless", "agents.intelligence",
        "testing.faultinject", "testing.load_test",
        "testing.historian_smoke", "core.collections", "core.trace"))


def test_slice_sixteen_is_covered_and_defaults_to_the_card(monkeypatch):
    """The capacity soak, the agents, the fault injector, the load test,
    the historian smoke and the host collections keep the JAX modules'
    names and are walked by the checks above; testing/capacity_runs is
    the port's own scenario, and the C op packer has its source beside
    the other native ones. capacity_runs's server factory,
    the Loader that HeadlessAgentRunner loads through and
    historian_smoke.main take the card by default and raise without
    CUDA."""
    assert set(SLICE_SIXTEEN_MODULES) <= set(_port_modules())
    for module in SLICE_SIXTEEN_MODULES:
        rel = module.split(".", 1)[1].replace(".", "/")
        assert (REPO / "fluidframework_tpu" / f"{rel}.py").exists() or \
            (REPO / "fluidframework_tpu" / rel / "__init__.py").exists(), rel
    assert "fluidframework_tpu_torch.testing.capacity_runs" in \
        _port_modules()
    assert (PORT / "native" / "src" / "oppack.cpp").exists()

    from fluidframework_tpu_torch.capacity import FleetSpec
    from fluidframework_tpu_torch.loader.container import Loader
    from fluidframework_tpu_torch.loader.drivers.local import \
        LocalDocumentServiceFactory
    from fluidframework_tpu_torch.server.admission import \
        AdmissionController
    from fluidframework_tpu_torch.server.local_server import LocalServer
    from fluidframework_tpu_torch.testing import (capacity_runs,
                                                  historian_smoke)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factory = capacity_runs.server_factory(capacity_runs.port_package(None))
    for make in (lambda: factory(FleetSpec(), AdmissionController()),
                 lambda: Loader(LocalDocumentServiceFactory(LocalServer())),
                 historian_smoke.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


SLICE_SEVENTEEN_MODULES = tuple(
    f"fluidframework_tpu_torch.{m}" for m in (
        "parallel", "parallel.mesh", "parallel.seq_scan",
        "mergetree.fused_sp", "mergetree.partition_rules",
        "testing.shardcheck"))


def test_slice_seventeen_is_covered_and_defaults_to_the_card(monkeypatch):
    """The multi-device modules keep the JAX modules' names and are walked
    by the checks above. A mesh defaults to every visible CUDA device and
    raises without one; the mesh entry points take a mesh of CPU entries
    when the caller names them."""
    assert set(SLICE_SEVENTEEN_MODULES) <= set(_port_modules())
    for module in SLICE_SEVENTEEN_MODULES:
        rel = module.split(".", 1)[1].replace(".", "/")
        assert (REPO / "fluidframework_tpu" / f"{rel}.py").exists() or \
            (REPO / "fluidframework_tpu" / rel / "__init__.py").exists(), rel
    from fluidframework_tpu_torch.parallel import make_mesh
    from fluidframework_tpu_torch.server.tpu_sequencer import \
        TpuSequencerLambda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(sp=1)

    class Ctx:
        def checkpoint(self, *_):
            pass

    mesh = make_mesh(dp=2, devices=["cpu", "cpu"])
    lam = TpuSequencerLambda(Ctx(), emit=lambda *a: None,
                             nack=lambda *a: None, mesh=mesh)
    assert lam.device.type == "cpu" and lam.mesh is mesh


SLICE_EIGHTEEN_MODULES = tuple(
    f"fluidframework_tpu_torch.{m}" for m in (
        "analysis", "analysis.__main__", "analysis.baseline",
        "analysis.cache", "analysis.callgraph", "analysis.concurrency_model",
        "analysis.concurrency_rules", "analysis.dataflow", "analysis.engine",
        "analysis.lifecycle_rules", "analysis.placement_model",
        "analysis.placement_rules", "analysis.race_rules",
        "analysis.registry", "analysis.reporters", "testing.lockcheck",
        "tools.layer_check"))


def test_slice_eighteen_is_covered_and_runs_without_cuda():
    """fluidlint, the runtime lockset verifier and the layer check keep the
    JAX modules' names (torch_rules.py is jax_rules.py's counterpart) and
    are walked by the checks above. They are host tools: the analyzer and
    the layer check start and pass on the port's tree in a process that
    sees no CUDA device, and each module imports neither jax nor the JAX
    package."""
    import subprocess
    import sys
    assert set(SLICE_EIGHTEEN_MODULES) | {
        "fluidframework_tpu_torch.analysis.torch_rules"} <= \
        set(_port_modules())
    for module in SLICE_EIGHTEEN_MODULES:
        rel = module.split(".", 1)[1].replace(".", "/")
        assert (REPO / "fluidframework_tpu" / f"{rel}.py").exists() or \
            (REPO / "fluidframework_tpu" / rel / "__init__.py").exists(), rel
    assert (REPO / "fluidframework_tpu" / "analysis" / "jax_rules.py"
            ).exists()
    for path in sorted((PORT / "analysis").glob("*.py")) + [
            PORT / "testing" / "lockcheck.py",
            PORT / "tools" / "layer_check.py"]:
        assert not set(_imported_roots(path)) & set(FORBIDDEN), path
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "HOME": str(REPO)}
    for module in ("fluidframework_tpu_torch.analysis",
                   "fluidframework_tpu_torch.tools.layer_check"):
        proc = subprocess.run([sys.executable, "-m", module], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, (module, proc.stdout[-2000:],
                                      proc.stderr[-2000:])
    from fluidframework_tpu_torch.mergetree.constants import \
        CANONICAL_DEVICE_DTYPES
    assert "int32" in CANONICAL_DEVICE_DTYPES
