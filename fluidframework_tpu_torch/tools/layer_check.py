"""Layer check of the port: machine-enforced package layering
(counterpart of fluidframework_tpu's tools/layer_check.py, with the port's
own matrix).

Every subpackage declares which subpackages it may import; an import
outside the matrix fails the check. Imports guarded by
`if TYPE_CHECKING:` are type-only and exempt (they erase at runtime).
Top-level modules (client_api.py, interop.py) are layers of their own,
by name.

Beyond the layering matrix, the checker also builds the module-level
IMPORT-TIME graph (top-level imports only: deferred function-body
imports are the sanctioned cycle-breaking idiom here) and fails hard on
any cycle, printing the offending edges: an import cycle is a layering
violation the matrix cannot express, and Python resolves one
"successfully" just often enough to ship a partially-initialized module.

Run: `python -m fluidframework_tpu_torch.tools.layer_check` (exit 1 on a
violation or a cycle; `--root` checks another package tree).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, NamedTuple, Optional, Set

# The layering matrix, bottom-up: the JAX package's, plus the layers only
# the port has (kernels/, the CUDA sources and their build; interop.py, the
# numpy <-> torch converters the tests and the chip smoke use).
ALLOWED: Dict[str, Set[str]] = {
    "core": set(),
    "protocol": {"core"},
    "telemetry": {"core", "protocol"},
    # The mesh's kernel launches are counted per shard (note_launch), and
    # a build is recorded in the compile ledger: the kernels sit above
    # parallel and telemetry, below mergetree.
    "kernels": {"core", "parallel", "telemetry"},
    "parallel": {"core"},
    "mergetree": {"core", "protocol", "telemetry", "parallel", "kernels"},
    # native is the C++ transport under the server; it shares the server's
    # queued-message types.
    "native": {"core", "server"},
    "dds": {"core", "protocol", "mergetree"},
    "runtime": {"core", "protocol", "dds"},
    "server": {"core", "protocol", "mergetree", "native", "telemetry",
               "parallel", "kernels"},
    # loader's local/network drivers bind to the in-process server.
    "loader": {"core", "protocol", "runtime", "telemetry", "server", "dds"},
    "framework": {"core", "protocol", "dds", "runtime"},
    # capacity drives the server stack directly and sits BELOW testing.
    "capacity": {"core", "protocol", "mergetree", "telemetry", "server"},
    # testing is the port's top layer: beside the load rig and the
    # corpora it holds the seeded scenarios that drive every layer of both
    # packages and the golden JAX outputs they are held to (the JAX
    # package keeps such drivers in tests/, outside the package). Nothing
    # in the package imports it.
    "testing": {"core", "protocol", "dds", "runtime", "loader", "server",
                "telemetry", "capacity", "mergetree", "parallel", "native",
                "framework", "hosts", "agents", "kernels", "interop",
                "tools"},
    "hosts": {"core", "loader", "runtime", "framework"},
    "client_api": {"core", "dds", "loader"},
    "agents": {"core", "dds", "loader", "framework"},
    "tools": {"core", "protocol", "mergetree", "loader"},
    # fluidlint reads the canonical device dtypes from
    # mergetree/constants.py; it must not depend on anything above that.
    "analysis": {"mergetree"},
    # The numpy <-> torch converters of the tests and the chip smoke.
    "interop": {"core", "mergetree", "server", "parallel"},
}

# Per-module exceptions (module path relative to the package root).
EXCEPTIONS: Dict[str, Set[str]] = {
    # The gateway is a host service that happens to live under server/.
    "server/gateway.py": {"loader", "framework"},
    # oppack lazily binds the native C packer (native/src/oppack.cpp, the
    # ingest hot path). File-scoped, NOT a package-level edge: native also
    # imports server (oplog wire adapter), so admitting mergetree->native
    # package-wide would put a cycle in the matrix.
    "mergetree/oppack.py": {"native"},
    # The on-card conformance tool holds the fused-sp body to the scan
    # apply over a mesh (the JAX tool reaches its mesh through jax).
    "tools/gpu_conformance.py": {"parallel"},
    # The runtime lockset verifier: its static_guards() derives guard maps
    # from the analysis layer's concurrency model (deferred, function-body
    # import). File-scoped; analysis never imports testing.
    "testing/lockcheck.py": {"analysis"},
    # The runtime sharding verifier asserts actual placements against
    # mergetree/partition_rules.py's rule table. File-scoped; mergetree
    # never imports testing.
    "testing/shardcheck.py": {"mergetree"},
}


class Violation(NamedTuple):
    module: str
    line: int
    imports: str
    reason: str

    def __str__(self) -> str:
        return (f"{self.module}:{self.line}: imports {self.imports!r} — "
                f"{self.reason}")


def _runtime_imports(tree: ast.AST) -> List[ast.stmt]:
    """All import nodes NOT under an `if TYPE_CHECKING:` guard."""
    type_only: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If):
            test = node.test
            name = (test.id if isinstance(test, ast.Name) else
                    test.attr if isinstance(test, ast.Attribute) else None)
            if name == "TYPE_CHECKING":
                for child in ast.walk(node):
                    type_only.add(id(child))
    return [node for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            and id(node) not in type_only]


def _target_package(node, module_rel_parts: List[str],
                    package_name: str) -> Optional[str]:
    """Top-level subpackage an import lands in, or None if external."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            if alias.name == package_name or \
                    alias.name.startswith(package_name + "."):
                parts = alias.name.split(".")
                return parts[1] if len(parts) > 1 else None
        return None
    if node.module and node.module.startswith(package_name):
        parts = node.module.split(".")
        return parts[1] if len(parts) > 1 else None
    if node.level:  # relative import
        base = module_rel_parts[:-1]
        up = node.level - 1
        if up:
            base = base[:-up] if up <= len(base) else []
        mod_parts = (node.module or "").split(".") if node.module else []
        full = base + [p for p in mod_parts if p]
        return full[0] if full else None
    return None


def check(package_root: str, allowed: Optional[Dict[str, Set[str]]] = None,
          exceptions: Optional[Dict[str, Set[str]]] = None
          ) -> List[Violation]:
    allowed = ALLOWED if allowed is None else allowed
    exceptions = EXCEPTIONS if exceptions is None else exceptions
    package_name = os.path.basename(os.path.abspath(package_root))
    violations: List[Violation] = []
    for root, _dirs, files in os.walk(package_root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, package_root)
            parts = rel.split(os.sep)
            pkg = parts[0][:-3] if parts[0].endswith(".py") else parts[0]
            if pkg not in allowed:
                continue  # top-level modules (e.g. client_api.py) map by name
            permitted = allowed[pkg] | exceptions.get(
                rel.replace(os.sep, "/"), set())
            tree = ast.parse(open(path).read())
            for node in _runtime_imports(tree):
                target = _target_package(node, parts, package_name)
                if target and target != pkg and target not in permitted:
                    violations.append(Violation(
                        rel, node.lineno, target,
                        f"layer {pkg!r} may import only "
                        f"{sorted(permitted)}"))
    return violations


# ---------------------------------------------------------------------------
# import-time cycle detection
# ---------------------------------------------------------------------------

def _toplevel_imports(tree: ast.Module) -> List[ast.stmt]:
    """Imports that execute at module import time: module-body
    statements, descending into top-level If/Try (version guards,
    optional-dependency fallbacks) and class bodies (they execute at
    import), but NOT into function bodies — a deferred function-scope
    import is the sanctioned way to break a would-be cycle."""
    out: List[ast.stmt] = []

    def visit(stmts) -> None:
        for node in stmts:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                out.append(node)
            elif isinstance(node, ast.If):
                test = node.test
                name = (test.id if isinstance(test, ast.Name) else
                        test.attr if isinstance(test, ast.Attribute)
                        else None)
                if name != "TYPE_CHECKING":
                    visit(node.body)
                # type-only body erases at runtime; the else branch
                # (if any) still executes at import time either way
                visit(node.orelse)
            elif isinstance(node, (ast.Try, ast.ClassDef)):
                for field in ("body", "orelse", "finalbody"):
                    visit(getattr(node, field, []) or [])
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)
    visit(tree.body)
    return out


def _import_target_module(node, module_rel: str, package_name: str,
                          modules: Set[str]) -> List[str]:
    """In-package module(s) (as "server/serve_step"-style keys) that an
    import statement binds at import time."""
    def to_key(dotted: str) -> Optional[str]:
        key = dotted.replace(".", "/")
        if key in modules:
            return key
        if f"{key}/__init__" in modules:
            return f"{key}/__init__"
        return None

    targets: List[str] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            if alias.name == package_name or \
                    alias.name.startswith(package_name + "."):
                dotted = alias.name[len(package_name) + 1:]
                key = to_key(dotted) if dotted else "__init__"
                if key:
                    targets.append(key)
        return targets
    # ImportFrom: resolve the base package, then each name — a name may
    # be a submodule (edge to it) or a symbol (edge to the base).
    if node.level == 0:
        if not (node.module or "").startswith(package_name):
            return targets
        base = (node.module or "")[len(package_name):].lstrip(".")
    else:
        parts = module_rel.split("/")[:-1]
        up = node.level - 1
        if up > len(parts):
            return targets
        parts = parts[:len(parts) - up] if up else parts
        base = "/".join(parts).replace("/", ".")
        if node.module:
            base = f"{base}.{node.module}" if base else node.module
        base = base.replace("/", ".")
    base_key = base.replace(".", "/") if base else ""
    for alias in node.names:
        if alias.name == "*":
            continue
        sub = to_key(f"{base_key}/{alias.name}" if base_key
                     else alias.name)
        if sub:
            targets.append(sub)
        else:
            key = to_key(base_key) if base_key else "__init__"
            if key:
                targets.append(key)
    return list(dict.fromkeys(targets))


def import_graph(package_root: str) -> Dict[str, Set[str]]:
    """module key ("server/serve_step") -> in-package modules its
    import-time imports bind."""
    package_name = os.path.basename(os.path.abspath(package_root))
    modules: Set[str] = set()
    trees: Dict[str, ast.Module] = {}
    for root, _dirs, files in os.walk(package_root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, package_root)
            if "__pycache__" in rel.split(os.sep):
                continue
            key = rel[:-3].replace(os.sep, "/")
            modules.add(key)
            try:
                trees[key] = ast.parse(open(path).read())
            except SyntaxError:
                continue
    graph: Dict[str, Set[str]] = {m: set() for m in modules}
    for key, tree in trees.items():
        for node in _toplevel_imports(tree):
            for target in _import_target_module(node, key, package_name,
                                                modules):
                if target != key:
                    graph[key].add(target)
    return graph


def find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycles via DFS back-edges; each reported once, as the
    path of module keys with the closing edge repeated last."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: List[str] = []
    cycles: List[List[str]] = []
    seen: Set[frozenset] = set()

    def dfs(n: str) -> None:
        color[n] = GREY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color.get(m, BLACK) == GREY:
                cyc = stack[stack.index(m):] + [m]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
            elif color.get(m) == WHITE:
                dfs(m)
        stack.pop()
        color[n] = BLACK

    for n in sorted(graph):
        if color[n] == WHITE:
            dfs(n)
    return cycles


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m fluidframework_tpu_torch.tools.layer_check")
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))),
        help="package root to check (default: this package; the cycle "
             "gate's exit-1 contract is tested against seeded trees)")
    args = parser.parse_args(argv)
    root = args.root
    found = check(root)
    for violation in found:
        print(violation)
    cycles = find_cycles(import_graph(root))
    for cyc in cycles:
        edges = " -> ".join(cyc)
        print(f"import cycle: {edges} (break the "
              f"`{cyc[-2]} -> {cyc[-1]}` edge, e.g. defer it into the "
              f"function that needs it)")
    print(f"layer-check: {len(found)} violation(s), "
          f"{len(cycles)} import cycle(s)")
    return 1 if (found or cycles) else 0


if __name__ == "__main__":
    raise SystemExit(main())
