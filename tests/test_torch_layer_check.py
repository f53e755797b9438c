"""The port's layer check (tools/layer_check.py): its own matrix over the
port's tree, the import-time cycle check carried over as it is, and the
two checkers agreeing on synthetic trees."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from fluidframework_tpu.tools import layer_check as jax_lc
from fluidframework_tpu_torch.tools import layer_check as lc

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "fluidframework_tpu_torch"


def run(*args):
    return subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.tools.layer_check",
         *args], capture_output=True, text=True, cwd=REPO, timeout=300)


def write_tree(root: Path, files: dict) -> Path:
    pkg = root / "pkg"
    for rel, src in files.items():
        f = pkg / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    for d in [pkg] + [p for p in pkg.rglob("*") if p.is_dir()]:
        (d / "__init__.py").touch()
    return pkg


class TestPortGate:
    def test_port_tree_passes(self):
        assert lc.check(str(PORT)) == []
        assert lc.find_cycles(lc.import_graph(str(PORT))) == []

    def test_cli_exits_zero_on_the_port(self):
        proc = run()
        assert proc.returncode == 0, proc.stdout
        assert "0 violation(s), 0 import cycle(s)" in proc.stdout

    def test_matrix_covers_every_layer_of_the_port(self):
        layers = {p.name for p in PORT.iterdir() if p.is_dir()
                  and (p / "__init__.py").exists()}
        layers |= {p.stem for p in PORT.glob("*.py")
                   if p.stem != "__init__"}
        assert layers - {"client_api"} <= set(lc.ALLOWED)
        assert {"kernels", "interop", "analysis"} <= set(lc.ALLOWED)

    def test_exceptions_name_files_of_the_port(self):
        for rel in lc.EXCEPTIONS:
            assert (PORT / rel).exists(), rel
        for rel in ("testing/lockcheck.py", "testing/shardcheck.py",
                    "mergetree/oppack.py"):
            assert rel in lc.EXCEPTIONS

    def test_the_microbench_no_longer_imports_testing(self):
        """The fault the port's matrix found: tools/microbench.py's kernel
        probe imported testing/traces (testing sits above tools). Its
        trace generator now lives beside the probe."""
        src = (PORT / "tools" / "microbench.py").read_text()
        assert "testing" not in src.split('"""', 2)[2]


SEEDED_VIOLATION = {
    "core/base.py": "from ..server import app\n",
    "server/app.py": "X = 1\n",
}
SEEDED_CYCLE = {
    "mergetree/a.py": "from . import b\n",
    "mergetree/b.py": "from . import a\n",
}


class TestSeeded:
    def test_violation_exits_one(self, tmp_path):
        pkg = write_tree(tmp_path, SEEDED_VIOLATION)
        proc = run("--root", str(pkg))
        assert proc.returncode == 1
        assert "core/base.py:1: imports 'server'" in proc.stdout

    def test_cycle_exits_one(self, tmp_path):
        pkg = write_tree(tmp_path, SEEDED_CYCLE)
        proc = run("--root", str(pkg))
        assert proc.returncode == 1
        assert "import cycle: mergetree/a -> mergetree/b -> mergetree/a" \
            in proc.stdout

    def test_deferred_import_breaks_the_cycle(self, tmp_path):
        pkg = write_tree(tmp_path, {
            "mergetree/a.py": "from . import b\n",
            "mergetree/b.py": "def f():\n    from . import a\n",
        })
        assert run("--root", str(pkg)).returncode == 0


TREES = {
    "upward edge": SEEDED_VIOLATION,
    "cycle": SEEDED_CYCLE,
    "type-only import": {
        "core/base.py": """
            from typing import TYPE_CHECKING
            if TYPE_CHECKING:
                from ..server import app
        """,
        "server/app.py": "X = 1\n",
    },
    "absolute import": {
        "protocol/m.py": "import pkg.loader.drivers\n",
        "loader/drivers.py": "X = 1\n",
    },
    "file-scoped exception": {
        "mergetree/oppack.py": "from ..native import lib\n",
        "native/lib.py": "X = 1\n",
        "mergetree/other.py": "from ..native import lib\n",
    },
    "three-module cycle in a class body": {
        "server/a.py": "class A:\n    from . import b\n",
        "server/b.py": "from . import c\n",
        "server/c.py": "try:\n    from . import a\nexcept ImportError:\n"
                       "    pass\n",
    },
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_checkers_agree_on_synthetic_trees(tmp_path, name):
    pkg = write_tree(tmp_path, TREES[name])
    key = lambda v: (v.module, v.line, v.imports)  # noqa: E731
    assert sorted(map(key, lc.check(str(pkg)))) == \
        sorted(map(key, jax_lc.check(str(pkg))))
    assert lc.find_cycles(lc.import_graph(str(pkg))) == \
        jax_lc.find_cycles(jax_lc.import_graph(str(pkg)))
    assert lc.check(str(pkg)) or lc.find_cycles(lc.import_graph(str(pkg))) \
        or name == "type-only import"
