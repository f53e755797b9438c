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
