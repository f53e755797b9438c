"""Cross-module symbol/call graph for fluidlint's whole-program rules
(counterpart of fluidframework_tpu's analysis/callgraph.py).

Single-module rules see one ``ModuleContext``. The in-place lifecycle
rules (lifecycle_rules.py) need more: at a call site in
``tpu_sequencer.py`` they must know that ``serve_step.serve_megakernel``
writes its page pool (argument 1) in place, a fact declared in another
module. The torch rules need the device path, the closure of a root
table over callees. This module builds that map once per run:

* every function/method def in the analyzed tree, keyed by qualname
  (``module:func`` / ``module:Class.method``);
* each module's in-place declarations: a module-level
  ``IN_PLACE_ARGS = {"name": (positions, ...)}`` table names the
  functions (or module-level callables, such as the megakernel a factory
  builds) that mutate the tensors at those argument positions in place,
  as JAX declares ``donate_argnums`` beside its jitted functions;
* module import aliases (plain, from-import, relative) so a dotted
  callee resolves across the package;
* simple module-level aliases (``g = f``).

Resolution is intentionally name-based and conservative: an
unresolvable callee yields ``None`` and the dataflow pass simply models
no effect: whole-program soundness is traded for a near-zero false
positive rate, the same bargain every fluidlint rule makes.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import _dotted, _int_elems

#: The module-level table that declares a module's in-place forms.
IN_PLACE_TABLE = "IN_PLACE_ARGS"

_MAX_ALIAS_HOPS = 8  # alias-chain bound: cycles and pathological chains stop


@dataclass
class FunctionDecl:
    """One function/method def somewhere in the analyzed tree."""
    qualname: str                  # "module:func" / "module:Class.meth"
    module: str                    # dotted module name
    name: str
    class_name: Optional[str]
    node: ast.AST                  # FunctionDef | AsyncFunctionDef
    in_place: Set[int] = field(default_factory=set)  # mutated positions

    @property
    def param_names(self) -> List[str]:
        args = self.node.args
        return [a.arg for a in args.posonlyargs + args.args]


@dataclass
class DonationSignature:
    """What a call site needs to know about an in-place callee: which of
    ITS OWN argument positions/keywords it mutates in place."""
    callee: str                       # display name for messages
    positions: Set[int] = field(default_factory=set)
    names: Set[str] = field(default_factory=set)

    def donated_args(self, call: ast.Call,
                     bound_self: bool = False) -> List[ast.AST]:
        """The argument expressions at donated positions of ``call``.
        ``bound_self`` shifts positions down by one (method called via
        ``self.m(...)``: param 0 is the bound instance). Starred args
        make positions unmappable — the call is skipped entirely, which
        is the conservative (quiet) choice."""
        if any(isinstance(a, ast.Starred) for a in call.args):
            return []
        shift = 1 if bound_self else 0
        out: List[ast.AST] = []
        for i, arg in enumerate(call.args):
            if (i + shift) in self.positions:
                out.append(arg)
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in self.names:
                out.append(kw.value)
        return out


class ModuleSymbols:
    """Per-module symbol table: defs, aliases, imports, in-place
    declarations."""

    def __init__(self, module: str, tree: ast.Module, path: str = ""):
        self.module = module
        self.path = path
        # A package __init__ is its own package for relative imports
        # (`from . import x` inside server/__init__.py resolves against
        # fluidframework_tpu_torch.server, not its parent).
        self.is_package = path.replace("\\", "/").endswith("__init__.py")
        self.tree = tree
        self.functions: Dict[str, FunctionDecl] = {}
        self.methods: Dict[str, Dict[str, FunctionDecl]] = {}
        self.aliases: Dict[str, str] = {}          # name -> local name
        self.imports: Dict[str, str] = {}          # name -> absolute dotted
        self.in_place: Dict[str, Set[int]] = {}    # name -> positions
        self._index()

    # -- indexing ----------------------------------------------------------
    def _index(self) -> None:
        # Imports index from the WHOLE tree: this codebase routinely
        # defers imports into function bodies (`from . import
        # serve_step` inside the dispatch path) and those aliases must
        # still resolve at call sites. Collisions are rare enough that
        # a module-wide alias table is the right trade.
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._index_import(node)
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == IN_PLACE_TABLE \
                    and isinstance(stmt.value, ast.Dict):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        self.in_place[k.value] = _int_elems(v)
        for stmt in self.tree.body:
            self._index_stmt(stmt, class_name=None)

    def _index_stmt(self, stmt: ast.stmt, class_name: Optional[str]) -> None:
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            pass  # indexed tree-wide in _index
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            decl = FunctionDecl(
                qualname=(f"{self.module}:{class_name}.{stmt.name}"
                          if class_name else f"{self.module}:{stmt.name}"),
                module=self.module, name=stmt.name, class_name=class_name,
                node=stmt)
            if class_name is None:
                decl.in_place = set(self.in_place.get(stmt.name, ()))
                self.functions[stmt.name] = decl
            else:
                self.methods.setdefault(class_name, {})[stmt.name] = decl
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                self._index_stmt(sub, class_name=stmt.name)
        elif isinstance(stmt, ast.Assign) and class_name is None:
            self._index_module_assign(stmt)
        elif isinstance(stmt, (ast.If, ast.Try)):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.stmt):
                    self._index_stmt(sub, class_name)

    def _index_import(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                self.imports[local] = target
        elif isinstance(stmt, ast.ImportFrom):
            base = self._resolve_from_base(stmt)
            if base is None:
                return
            for alias in stmt.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                self.imports[local] = (f"{base}.{alias.name}"
                                       if base else alias.name)

    def _resolve_from_base(self, stmt: ast.ImportFrom) -> Optional[str]:
        if stmt.level == 0:
            return stmt.module or ""
        # Relative: peel the module's own dotted name down to its
        # package, then climb one level per extra dot.
        parts = self.module.split(".")
        if not self.is_package:
            parts = parts[:-1]
        up = stmt.level - 1
        if up > len(parts):
            return None
        base_parts = parts[:len(parts) - up] if up else parts
        if stmt.module:
            base_parts = base_parts + stmt.module.split(".")
        return ".".join(base_parts)

    def _index_module_assign(self, stmt: ast.Assign) -> None:
        if len(stmt.targets) != 1 or not isinstance(stmt.targets[0],
                                                    ast.Name):
            return
        if isinstance(stmt.value, ast.Name):
            self.aliases[stmt.targets[0].id] = stmt.value.id


@dataclass
class ResolvedCallee:
    """A call site resolved to a program symbol: the def (when found),
    its in-place signature (when it mutates arguments), and whether the
    call binds ``self`` (method form: positions shift by one)."""
    qualname: str
    decl: Optional[FunctionDecl]
    donation: Optional[DonationSignature]
    bound_self: bool = False


class ProgramIndex:
    """The whole-program symbol/call graph.

    Build it from ``(module_name, tree, path)`` triples (the engine
    hands it every parsed ``ModuleContext``); query with
    :meth:`resolve_call` from a rule/dataflow visitor positioned inside
    one module, or :meth:`call_edges` for the plain caller→callee graph
    the unit tests exercise."""

    def __init__(self, modules: Sequence[Tuple[str, ast.Module, str]]):
        self.modules: Dict[str, ModuleSymbols] = {}
        for name, tree, path in modules:
            self.modules[name] = ModuleSymbols(name, tree, path)

    # -- symbol lookup -----------------------------------------------------
    def lookup(self, module: str, name: str,
               _hops: int = 0) -> Optional[ResolvedCallee]:
        """Resolve a bare name in ``module`` to a program symbol,
        chasing aliases and from-imports. A module-level callable that
        IN_PLACE_ARGS declares but no def provides (the megakernel a
        factory builds) resolves to its declaration alone."""
        syms = self.modules.get(module)
        if syms is None or _hops > _MAX_ALIAS_HOPS:
            return None
        if name in syms.functions:
            decl = syms.functions[name]
            return ResolvedCallee(decl.qualname, decl,
                                  _decl_donation(decl))
        if name in syms.in_place and name not in syms.aliases:
            return ResolvedCallee(
                f"{module}:{name}", None, DonationSignature(
                    callee=name, positions=set(syms.in_place[name])))
        if name in syms.aliases:
            return self.lookup(module, syms.aliases[name], _hops + 1)
        if name in syms.imports:
            return self._lookup_dotted(syms.imports[name], _hops + 1)
        return None

    def _lookup_dotted(self, dotted: str,
                       _hops: int = 0) -> Optional[ResolvedCallee]:
        """Resolve an absolute dotted symbol ("pkg.mod.func" or
        "pkg.mod" + later attribute): longest module prefix wins."""
        if _hops > _MAX_ALIAS_HOPS:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.modules:
                rest = parts[cut:]
                if len(rest) == 1:
                    return self.lookup(mod, rest[0], _hops + 1)
                if len(rest) == 2:  # Class.method
                    decl = self.modules[mod].methods.get(
                        rest[0], {}).get(rest[1])
                    if decl is not None:
                        return ResolvedCallee(decl.qualname, decl,
                                              _decl_donation(decl))
                return None
        return None

    # -- call-site resolution ---------------------------------------------
    def resolve_call(self, module: str, call: ast.Call,
                     class_name: Optional[str] = None,
                     local_defs: Optional[Dict[str, ast.AST]] = None
                     ) -> Optional[ResolvedCallee]:
        """Resolve ``call``'s callee as seen from ``module`` (and, for
        ``self.x(...)`` forms, from ``class_name``). ``local_defs``
        carries the enclosing function's nested defs, which shadow
        module symbols."""
        dotted = _dotted(call.func)
        if not dotted:
            return None
        parts = dotted.split(".")
        if len(parts) == 1:
            name = parts[0]
            if local_defs and name in local_defs:
                node = local_defs[name]
                decl = FunctionDecl(
                    qualname=f"{module}:<local>.{name}", module=module,
                    name=name, class_name=class_name, node=node)
                return ResolvedCallee(decl.qualname, decl,
                                      _decl_donation(decl))
            return self.lookup(module, name)
        if parts[0] == "self" and class_name is not None:
            syms = self.modules.get(module)
            if syms is None or len(parts) != 2:
                return None
            decl = syms.methods.get(class_name, {}).get(parts[1])
            if decl is not None:
                return ResolvedCallee(decl.qualname, decl,
                                      _decl_donation(decl),
                                      bound_self=True)
            return None
        syms = self.modules.get(module)
        if syms is not None and parts[0] in syms.imports:
            dotted_abs = ".".join([syms.imports[parts[0]]] + parts[1:])
            return self._lookup_dotted(dotted_abs)
        return None

    # -- enumeration -------------------------------------------------------
    def iter_functions(self):
        for syms in self.modules.values():
            yield from syms.functions.values()
            for methods in syms.methods.values():
                yield from methods.values()

    def call_edges(self, module: str) -> Set[Tuple[str, str]]:
        """(caller qualname, callee qualname) edges for one module —
        the call-graph surface the resolution unit tests pin."""
        syms = self.modules.get(module)
        if syms is None:
            return set()
        edges: Set[Tuple[str, str]] = set()
        for decl in list(syms.functions.values()) + [
                m for ms in syms.methods.values() for m in ms.values()]:
            local_defs = {n.name: n for n in ast.walk(decl.node)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and n is not decl.node}
            for sub in ast.walk(decl.node):
                if not isinstance(sub, ast.Call):
                    continue
                res = self.resolve_call(module, sub,
                                        class_name=decl.class_name,
                                        local_defs=local_defs)
                if res is not None:
                    edges.add((decl.qualname, res.qualname))
        return edges

    def signature_digest_items(self) -> List[str]:
        """Stable serialization of every in-place declaration; the engine
        hashes this into the cache key so editing a declaration anywhere
        invalidates every module's cached result."""
        items: List[str] = []
        for mod in sorted(self.modules):
            syms = self.modules[mod]
            for name in sorted(syms.in_place):
                items.append(f"{mod}:{name}|{sorted(syms.in_place[name])}")
        return items


def _decl_donation(decl: FunctionDecl) -> Optional[DonationSignature]:
    if not decl.in_place:
        return None
    params = decl.param_names
    return DonationSignature(
        callee=decl.name, positions=set(decl.in_place),
        names={params[i] for i in decl.in_place if i < len(params)})


def module_name_for_path(path: str) -> str:
    """Dotted module name for a repo-root-relative path; fixture paths
    ("<memory>", tmp files) fall back to their stem so single-module
    analysis still resolves local symbols."""
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[:-len("/__init__")]
    if p.startswith("<") or "/" not in p:
        return p.rsplit("/", 1)[-1] or p
    return p.replace("/", ".")
