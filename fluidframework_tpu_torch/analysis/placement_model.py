"""Whole-program placement & sharding dataflow (counterpart of
fluidframework_tpu's analysis/placement_model.py).

The placement lattice, per binding::

    host  <  replicated  <  mesh-sharded(PartitionSpec)  <  mutated-gone

This layer machine-checks the MESH discipline of the port's
``mergetree/``, ``server/`` and ``parallel/`` packages over the
single-controller mesh of parallel/mesh.py: where every serving tree
lives, under which ``PartitionSpec``, and whether the dispatch
boundaries it crosses are compatible with that placement. The model
indexes, per function (module top level is its own unit):

* **mesh handles**: ``make_mesh(...)`` / ``Mesh(..., axis_names=...)``
  construction sites; axis-name literals union into the program-wide
  mesh-axes set (``{"dp", "sp"}``, the only axes a port mesh has);
* **spec literals**: ``PartitionSpec``/``P`` calls (resolved through
  the import alias table, so an unrelated local ``P`` stays invisible);
* **placements**: ``place(x, mesh, spec)``, ``shard_docs(mesh, x)``,
  ``replicate(mesh, x)``, ``place_with_rules(mesh, x, rules)`` and
  ``ensure_placement(mesh, x, rules)`` (the rule-table engine in
  ``mergetree/partition_rules.py``);
* **dispatch boundaries**: ``map_dp(fn, mesh, ...)``, the lane stores'
  per-shard ``_dispatch(fn, state, ...)``, and the in-place forms that
  IN_PLACE_ARGS declares (resolved through callgraph.ProgramIndex, so an
  in-place callee two modules away still gates);
* **host reads** of a ``Sharded``: ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``/``int()``/``np.asarray``; a read goes through
  ``gather``, ``take_rows`` or ``row_of``.

**Definite vs may.** A placement recorded under a conditional
(``if mesh is not None: ...``, loop/try bodies) is a MAY placement and
never fires a rule: the serving tier's single-card/mesh dual-mode
construction stays quiet without suppressions. Only DEFINITE placements
(straight-line code at function or module top level) participate. The
conditional half is covered dynamically by ``testing/shardcheck.py``,
which holds each shard's device and shape against the same rule table
while the mesh tests and SOAK trials run.

The rule table itself (``mergetree/partition_rules.py``) is part of the
model's digest: the ``*_RULES`` assignments fold in via ``ast.dump``
(no line numbers), so editing a spec invalidates every module's cached
result while pure line drift keeps the cache warm.
"""

from __future__ import annotations

import ast
import hashlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import REPO_ROOT, _dotted

# The mesh tier under analysis. "<memory>" keeps fixtures in scope
# (analyze_source paths).
SCOPE_PREFIXES = (
    "fluidframework_tpu_torch/mergetree", "fluidframework_tpu_torch/server",
    "fluidframework_tpu_torch/parallel", "<memory>")

#: Files whose edits can flip ANY module's placement verdict: the mesh
#: helpers and the partition-rule table (relative to the repo root).
HELPER_FILES = (
    "fluidframework_tpu_torch/parallel/mesh.py",
    "fluidframework_tpu_torch/mergetree/partition_rules.py",
)

RULE_TABLE_REL = "fluidframework_tpu_torch/mergetree/partition_rules.py"

# Lattice levels.
HOST, REPLICATED, SHARDED, DONATED = \
    "host", "replicated", "sharded", "donated"

# Placement-helper call tails (parallel/mesh.py, mergetree/
# partition_rules.py): the argument each places, and the level. Their
# callees never count as mesh DISPATCHES.
_PLACE_TARGET_ARG = {"place": 0, "shard_docs": 1, "replicate": 1,
                     "place_with_rules": 1, "ensure_placement": 1}
_PLACE_SHARDED_TAILS = {"place", "shard_docs", "place_with_rules",
                        "ensure_placement"}
_PLACE_REPLICATED_TAILS = {"replicate"}
_PLACEMENT_TAILS = (_PLACE_SHARDED_TAILS | _PLACE_REPLICATED_TAILS
                    | {"match_partition_rules", "resolved_spec_table",
                       "placed_as", "verify_store", "placement_report",
                       "named_leaves", "adopt_pool", "instrument",
                       "tree_map", "from_blocks", "gather", "gather_tree",
                       "take_rows", "row_of", "set_rows", "write_rows",
                       "clone", "doc_spec", "is_sharded"})

# Dispatch boundaries: the function runs once per dp shard on its blocks.
_DISPATCH_TAILS = {"map_dp", "_dispatch"}

_HOST_CTOR_TAILS = {"zeros", "ones", "full", "empty", "arange",
                    "zeros_like", "ones_like", "full_like", "make_state",
                    "make_ticket_state", "make_lww_state"}

# Host-read forms on a mesh-sharded binding (each one reads every shard
# through a blocking transfer).
_HOST_READ_METHOD_TAILS = {"item", "tolist", "cpu", "numpy"}
_HOST_READ_FN_NAMES = {"int", "float", "bool"}
_HOST_READ_NP_TAILS = {"asarray", "array"}
_NP_HEADS = {"np", "numpy", "onp"}

# Enclosing-function names sanctioned to host-read sharded state (the
# gather helpers; matches the serving tier's naming convention).
SANCTIONED_READ_RE = re.compile(
    r"(gather|to_host|host_read|take_rows|row_of|fetch|debug|dump)",
    re.IGNORECASE)

# Lane/page-pool pytree naming convention (UNSPECCED_POOL subjects).
POOL_NAME_RE = re.compile(r"(^|_)pools?$")

_MESH_CTOR_TAILS = {"Mesh", "make_mesh"}

DEFAULT_MESH_AXES = frozenset({"dp", "sp"})


def in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(p.startswith(s) or f"/{s}" in p for s in SCOPE_PREFIXES)


# -- facts -------------------------------------------------------------------


@dataclass(frozen=True)
class PlacementFinding:
    rule_id: str
    path: str
    node: ast.AST
    message: str
    # line-free identity for the program digest (cache correctness must
    # not depend on line numbers — see ProgramContext.digest).
    ident: str


@dataclass
class _Bind:
    """One name's point in the lattice inside one analyzed unit."""
    kind: str = "array"          # array | mesh | spec | ns
    level: str = HOST
    spec: Optional[str] = None   # canonical "P('dp', None)" when known
    rank: Optional[int] = None   # syntactically known rank, else None
    definite: bool = False       # placed on a straight-line path
    node: Optional[ast.AST] = None


# -- spec literal parsing ----------------------------------------------------


def _pspec_alias_ok(model, module: str, name: str) -> bool:
    """Is bare ``name`` a PartitionSpec binding in ``module``? True for
    the canonical names (PartitionSpec, parallel/mesh.py's ``P``);
    resolved through the module's import and alias tables so unrelated
    helpers named ``P`` stay invisible."""
    if name == "PartitionSpec":
        return True
    syms = model.index.modules.get(module)
    if syms is None:
        return name in ("P", "PS")
    if syms.aliases.get(name) == "PartitionSpec":
        return True  # parallel/mesh.py's own `P = PartitionSpec`
    target = syms.imports.get(name, "")
    return target.endswith((".PartitionSpec", "parallel.mesh.P"))


def parse_spec(call: ast.Call):
    """A PartitionSpec literal -> (canonical string, axis names,
    arity). Any non-literal argument (starred specs, names) makes the
    WHOLE spec unknown — (None, axes, None) — the conservative quiet
    choice; literal axis names still feed PSPEC_MISMATCH."""
    parts: List[str] = []
    axes: Set[str] = set()
    known = True
    if any(isinstance(a, ast.Starred) for a in call.args) or call.keywords:
        known = False
    for arg in call.args:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            axes.add(arg.value)
            parts.append(repr(arg.value))
        elif isinstance(arg, ast.Constant) and arg.value is None:
            parts.append("None")
        elif isinstance(arg, (ast.Tuple, ast.List)):
            sub = []
            for el in arg.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value,
                                                               str):
                    axes.add(el.value)
                    sub.append(repr(el.value))
                else:
                    known = False
            parts.append("(" + ", ".join(sub) + ")")
        else:
            known = False
    if not known:
        return None, axes, None
    return "P(" + ", ".join(parts) + ")", axes, len(parts)


def _tail(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


# -- rule-table digest -------------------------------------------------------


def rule_table_digest(contexts: Sequence = ()) -> str:
    """Semantic digest of the ``*_RULES`` assignments in
    mergetree/partition_rules.py: ``ast.dump`` excludes line numbers,
    so editing a spec invalidates while comment edits / line drift stay
    warm. Reads the analyzed context when present (fixture trees),
    falling back to the repo checkout."""
    source = None
    for ctx in contexts:
        if ctx.path.replace("\\", "/").endswith(
                "mergetree/partition_rules.py"):
            source = ctx.source
            break
    if source is None:
        try:
            source = (REPO_ROOT / RULE_TABLE_REL).read_text()
        except OSError:
            return "absent"
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return "unparsable"
    dumps = []
    for stmt in tree.body:
        # The port annotates its tables (`POOL_PARTITION_RULES: List[...]
        # = [...]`), so both assignment forms count.
        target = stmt.targets[0] if isinstance(stmt, ast.Assign) and \
            len(stmt.targets) == 1 else getattr(stmt, "target", None)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                and isinstance(target, ast.Name) \
                and target.id.endswith("_RULES"):
            dumps.append(ast.dump(stmt))
    return hashlib.sha1("\n".join(dumps).encode()).hexdigest()[:16]


# -- the model ---------------------------------------------------------------


class PlacementModel:
    """Build once per analyze run (engine.ProgramContext.placement)."""

    def __init__(self, index, contexts: Sequence) -> None:
        self.index = index
        self.contexts = list(contexts)
        self.modules = [c for c in self.contexts if in_scope(c.path)]
        self.mesh_axes: Set[str] = set()
        self.mesh_sites: List[Tuple[str, str]] = []  # (path, dotted form)
        self.fact_files: Set[str] = set()
        self.findings: List[PlacementFinding] = []
        self._module_names: Dict[str, str] = {
            c.path: _module_name(c.path) for c in self.modules}
        self.table_digest = rule_table_digest(self.contexts)
        # Pass 1: the program-wide mesh-axes union — spec literals in
        # any module check against EVERY mesh the program builds.
        for ctx in self.modules:
            self._scan_meshes(ctx)
        if not self.mesh_axes:
            self.mesh_axes = set(DEFAULT_MESH_AXES)
        # Pass 2: per-unit lattice walks.
        for ctx in self.modules:
            self._walk_module(ctx)
        self.findings.sort(
            key=lambda f: (f.path, getattr(f.node, "lineno", 0),
                           f.rule_id, f.message))

    # -- pass 1: mesh construction sites -----------------------------------
    def _scan_meshes(self, ctx) -> None:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail(_dotted(node.func))
            if tail == "make_mesh":
                self.mesh_axes |= set(DEFAULT_MESH_AXES)
                self.mesh_sites.append((ctx.path, "make_mesh"))
                self.fact_files.add(ctx.path)
            elif tail == "Mesh":
                axes: Set[str] = set()
                for kw in node.keywords:
                    if kw.arg == "axis_names":
                        axes |= _str_literals(kw.value)
                if len(node.args) >= 2:
                    axes |= _str_literals(node.args[1])
                if axes:
                    self.mesh_axes |= axes
                    self.mesh_sites.append((ctx.path, "Mesh"))
                    self.fact_files.add(ctx.path)

    # -- pass 2: units ------------------------------------------------------
    def _walk_module(self, ctx) -> None:
        module = self._module_names[ctx.path]
        top = [s for s in ctx.tree.body
               if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))]
        _UnitWalk(self, ctx, module, None, "<module>").run(top)

        def visit(node, class_name):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    _UnitWalk(self, ctx, module, class_name,
                              child.name).run(child.body)
                    visit(child, class_name)
                elif isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                else:
                    visit(child, class_name)

        visit(ctx.tree, None)

    # -- recording ----------------------------------------------------------
    def add_finding(self, rule_id: str, ctx, node: ast.AST, message: str,
                    subject: str) -> None:
        self.fact_files.add(ctx.path)
        self.findings.append(PlacementFinding(
            rule_id=rule_id, path=ctx.path, node=node, message=message,
            ident=f"{rule_id}|{ctx.path}|{subject}"))

    # -- engine surface ----------------------------------------------------
    def findings_for(self, path: str) -> List[PlacementFinding]:
        return [f for f in self.findings if f.path == path]

    def reach_expansion(self, changed: Set[str]) -> Set[str]:
        """Files whose placement findings a change to ``changed`` can
        alter. Placement is whole-program through two globals — the
        mesh-axes union and the partition-rule table — so the group is
        every file carrying a placement fact plus the helper/table
        files; a changed file inside the group re-reports the whole
        group, a changed file outside it expands nothing."""
        out: Set[str] = set(changed)
        known = {c.path for c in self.contexts}
        group = set(self.fact_files)
        group |= {h for h in HELPER_FILES if h in known}
        if group & changed:
            out |= group
        return out

    def digest_items(self) -> List[str]:
        """Line-number-free serialization of everything that shapes the
        placement findings, folded into the program digest: mesh-axes
        drift, rule-table edits, or any finding change invalidates
        every module's cached result; line drift stays warm."""
        items = [f"pl-axes|{','.join(sorted(self.mesh_axes))}",
                 f"pl-table|{self.table_digest}"]
        items.extend(f"pl-mesh|{p}|{form}" for p, form in self.mesh_sites)
        items.extend(f"pl-find|{f.ident}|{f.message}"
                     for f in self.findings)
        return sorted(items)


# -- the per-unit pass -------------------------------------------------------


class _UnitWalk:
    """One statement-ordered walk over one function body (or the module
    top level), tracking each local name's lattice point. ``cond``
    counts enclosing conditionals: a placement recorded at cond > 0 is
    a MAY placement and never fires."""

    def __init__(self, model: PlacementModel, ctx, module: str,
                 class_name: Optional[str], fn_name: str):
        self.model = model
        self.ctx = ctx
        self.module = module
        self.class_name = class_name
        self.fn_name = fn_name
        self.sanctioned = bool(SANCTIONED_READ_RE.search(fn_name))
        self.env: Dict[str, _Bind] = {}
        self.cond = 0

    def run(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    # -- statements --------------------------------------------------------
    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate analyzable units
        if isinstance(stmt, ast.If):
            self._calls_in(stmt.test)
            self.cond += 1
            for s in stmt.body:
                self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
            self.cond -= 1
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            self._calls_in(stmt.iter if hasattr(stmt, "iter")
                           else stmt.test)
            self.cond += 1
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            self.cond -= 1
            return
        if isinstance(stmt, ast.Try):
            self.cond += 1
            for s in (stmt.body + [h for hd in stmt.handlers
                                   for h in hd.body]
                      + stmt.orelse + stmt.finalbody):
                self._stmt(s)
            self.cond -= 1
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._calls_in(item.context_expr)
            for s in stmt.body:   # `with mesh:` does not branch
                self._stmt(s)
            return
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            self._assign(stmt.targets[0].id, stmt.value)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            self._assign(stmt.target.id, stmt.value)
            return
        if isinstance(stmt, ast.Expr):
            self._calls_in(stmt.value, discarded=True)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._calls_in(child)

    # -- assignment --------------------------------------------------------
    def _assign(self, name: str, value: ast.AST) -> None:
        self._calls_in(value, rebind=name)
        self.env[name] = self._eval(value)

    def _eval(self, value: ast.AST) -> _Bind:
        definite = self.cond == 0
        if isinstance(value, ast.Name):
            hit = self.env.get(value.id)
            if hit is not None:
                return _Bind(**{**hit.__dict__})
            return _Bind()
        if not isinstance(value, ast.Call):
            return _Bind()
        tail = _tail(_dotted(value.func))
        if tail in _MESH_CTOR_TAILS:
            return _Bind(kind="mesh", definite=definite, node=value)
        if self._is_pspec(value):
            spec, _axes, _arity = parse_spec(value)
            return _Bind(kind="spec", spec=spec, definite=definite,
                         node=value)
        placed = self._placement_of(value)
        if placed is not None:
            level, spec = placed
            return _Bind(level=level, spec=spec, definite=definite,
                         node=value)
        if tail in _HOST_CTOR_TAILS:
            return _Bind(level=HOST, rank=_ctor_rank(value),
                         definite=definite, node=value)
        if tail in ("gather", "gather_tree", "take_rows", "row_of"):
            return _Bind(level=HOST, definite=definite, node=value)
        return _Bind()

    # -- placement recognizers ---------------------------------------------
    def _placement_of(self, call: ast.Call):
        """(level, spec) when ``call`` is a placement."""
        tail = _tail(_dotted(call.func))
        if tail == "place":
            spec = self._spec_of(call.args[2]) if len(call.args) >= 3 \
                else None
            return (REPLICATED, spec) if spec == "P()" else (SHARDED, spec)
        if tail == "shard_docs":
            return SHARDED, "P('dp')"
        if tail in _PLACE_SHARDED_TAILS:
            return SHARDED, None
        if tail in _PLACE_REPLICATED_TAILS:
            return REPLICATED, "P()"
        return None

    def _spec_of(self, expr: ast.AST) -> Optional[str]:
        """A spec literal or a name bound to one -> canonical string."""
        if isinstance(expr, ast.Call) and self._is_pspec(expr):
            return parse_spec(expr)[0]
        if isinstance(expr, ast.Name):
            hit = self.env.get(expr.id)
            if hit is not None and hit.kind == "spec":
                return hit.spec
        return None

    @staticmethod
    def _place_target(call: ast.Call, tail: str) -> Optional[ast.AST]:
        i = _PLACE_TARGET_ARG.get(tail, 0)
        return call.args[i] if len(call.args) > i else None

    def _is_pspec(self, call: ast.Call) -> bool:
        dotted = _dotted(call.func)
        if _tail(dotted) == "PartitionSpec":
            return True
        return "." not in dotted and _pspec_alias_ok(
            self.model, self.module, dotted)

    # -- calls -------------------------------------------------------------
    def _calls_in(self, expr: ast.AST, discarded: bool = False,
                  rebind: Optional[str] = None,
                  skip: Optional[ast.AST] = None) -> None:
        """Process every Call in ``expr`` source order, skipping nested
        function/lambda bodies (separate units / deferred)."""
        stack = [expr]
        calls: List[ast.Call] = []
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)) or node is skip:
                continue
            if isinstance(node, ast.Call):
                calls.append(node)
            stack.extend(ast.iter_child_nodes(node))
        calls.sort(key=lambda c: (getattr(c, "lineno", 0),
                                  getattr(c, "col_offset", 0)))
        top = expr if isinstance(expr, ast.Call) else None
        for call in calls:
            self._call(call, discarded=(discarded and call is top),
                       rebind=(rebind if call is top else None))

    def _call(self, call: ast.Call, discarded: bool = False,
              rebind: Optional[str] = None) -> None:
        dotted = _dotted(call.func)
        tail = _tail(dotted)
        # PSPEC_MISMATCH: axis names vs the program-wide mesh union.
        if self._is_pspec(call):
            _spec, axes, _arity = parse_spec(call)
            bad = sorted(axes - self.model.mesh_axes)
            if bad:
                self.model.add_finding(
                    "PSPEC_MISMATCH", self.ctx, call,
                    f"PartitionSpec names ax{'es' if len(bad) > 1 else 'is'}"
                    f" {', '.join(repr(b) for b in bad)} but every mesh "
                    f"this program builds has axes "
                    f"{sorted(self.model.mesh_axes)}: parallel/mesh.place "
                    f"rejects the spec at the cut; name a real mesh axis "
                    f"or extend the mesh construction",
                    subject=f"{self.fn_name}|axes:{','.join(bad)}")
            return
        # Placements: drift + arity checks, env updates happen at the
        # enclosing assignment.
        placed = self._placement_of(call)
        if placed is not None:
            self._check_placement(call, tail, placed, discarded, rebind)
            return
        if tail in _PLACEMENT_TAILS or tail in _MESH_CTOR_TAILS:
            return
        # Host reads of definitely-sharded bindings.
        if self._check_host_read(call, dotted, tail):
            return
        # Dispatch boundary: the in-place gate + unspecced pools.
        self._check_dispatch(call, tail)

    # -- rule checks -------------------------------------------------------
    def _check_placement(self, call: ast.Call, tail: str, placed,
                         discarded: bool, rebind: Optional[str]) -> None:
        level, spec = placed
        target = self._place_target(call, tail)
        if target is None or self.cond != 0:
            return
        prior = self.env.get(target.id) if isinstance(target, ast.Name) \
            else None
        # SHARD_AXIS_DRIFT: a second conflicting placement of a binding
        # that is already definitely sharded. Rebinding the SAME name is
        # the explicit reshard idiom and stays quiet; a discarded
        # placement or a conflicting copy both fire.
        if prior is not None and prior.definite and prior.level == SHARDED \
                and prior.spec is not None and spec is not None \
                and spec != prior.spec and spec != "P()" \
                and rebind != target.id:
            how = ("the placement's result is discarded, so the binding "
                   "keeps its old placement" if discarded else
                   "no explicit reshard in between")
            self.model.add_finding(
                "SHARD_AXIS_DRIFT", self.ctx, call,
                f"`{target.id}` is already mesh-sharded as {prior.spec} "
                f"but is placed here under {spec} ({how}); reshard by "
                f"rebinding (`{target.id} = ...`) or place both "
                f"consumers under one spec",
                subject=f"{self.fn_name}|{target.id}|{prior.spec}->{spec}")
        # PSPEC_MISMATCH (arity form): spec longer than the target's
        # syntactically known rank.
        if prior is not None and prior.rank is not None \
                and tail == "place" and len(call.args) >= 3:
            arity = self._spec_arity(call.args[2])
            if arity is not None and arity > prior.rank:
                self.model.add_finding(
                    "PSPEC_MISMATCH", self.ctx, call,
                    f"PartitionSpec has {arity} entries but "
                    f"`{target.id}` has rank {prior.rank}: place raises "
                    f"at the cut; drop the extra axes",
                    subject=f"{self.fn_name}|{target.id}|arity:{arity}")

    def _spec_arity(self, expr: ast.AST) -> Optional[int]:
        if isinstance(expr, ast.Call) and self._is_pspec(expr):
            return parse_spec(expr)[2]
        if isinstance(expr, ast.Name):
            hit = self.env.get(expr.id)
            if hit is not None and hit.kind == "spec" and hit.node is not None:
                return parse_spec(hit.node)[2]
        return None

    def _check_host_read(self, call: ast.Call, dotted: str,
                         tail: str) -> bool:
        subject: Optional[str] = None
        if isinstance(call.func, ast.Attribute) \
                and tail in _HOST_READ_METHOD_TAILS \
                and isinstance(call.func.value, ast.Name):
            subject = call.func.value.id
        elif dotted in _HOST_READ_FN_NAMES and len(call.args) == 1 \
                and isinstance(call.args[0], ast.Name):
            subject = call.args[0].id
        elif "." in dotted and dotted.split(".", 1)[0] in _NP_HEADS \
                and tail in _HOST_READ_NP_TAILS and call.args \
                and isinstance(call.args[0], ast.Name):
            subject = call.args[0].id
        if subject is None:
            return False
        bind = self.env.get(subject)
        if bind is None or bind.level != SHARDED or not bind.definite \
                or self.sanctioned:
            return False
        form = f".{tail}()" if isinstance(call.func, ast.Attribute) \
            else f"{dotted}(...)"
        self.model.add_finding(
            "HOST_READ_OF_SHARDED", self.ctx, call,
            f"`{form}` on `{subject}`, which is mesh-sharded as "
            f"{bind.spec or 'an unresolved spec'}: this gathers every "
            f"shard through a blocking host transfer on the serving "
            f"path; use a sanctioned gather helper (a *gather*/"
            f"*to_host* function) or keep the reduction on-device",
            subject=f"{self.fn_name}|{subject}|{tail}")
        return True

    def _check_dispatch(self, call: ast.Call, tail: str) -> None:
        donated: List[ast.AST] = []
        callee_name = tail or "<call>"
        res = self.model.index.resolve_call(
            self.module, call, class_name=self.class_name)
        if res is not None and res.donation is not None:
            donated = res.donation.donated_args(call, res.bound_self)
            callee_name = res.donation.callee or callee_name
        # MESH_DONATION_GATE: a mesh-sharded binding passed to an
        # in-place position. The paged pool keeps its pre views on a mesh
        # (mergetree/paging.py): every paged entry point has a _keep twin
        # that mesh callers dispatch through.
        for arg in donated:
            if not isinstance(arg, ast.Name):
                continue
            bind = self.env.get(arg.id)
            if bind is not None and bind.level == SHARDED \
                    and bind.definite:
                self.model.add_finding(
                    "MESH_DONATION_GATE", self.ctx, call,
                    f"`{arg.id}` is mesh-sharded "
                    f"({bind.spec or 'spec unresolved'}) and passed to "
                    f"`{callee_name}`, which mutates it in place: a mesh "
                    f"pool keeps its pre-window views for the rollback "
                    f"(mergetree/paging.py), so dispatch through the "
                    f"_keep twin on meshes",
                    subject=f"{self.fn_name}|{arg.id}|{callee_name}")
            if bind is not None and self.cond == 0:
                bind.level = DONATED
                bind.spec = None
        # UNSPECCED_POOL: a pool-convention tree reaching a dispatch that
        # also takes definitely-mesh-sharded input (or a per-shard
        # dispatch), while the pool itself is still definitely on one
        # device: the dispatch replicates the whole pool onto every shard.
        if tail in _PLACEMENT_TAILS:
            return
        sharded_arg = any(
            isinstance(a, ast.Name)
            and (b := self.env.get(a.id)) is not None
            and b.level == SHARDED and b.definite
            for a in call.args)
        if not (sharded_arg or donated or tail in _DISPATCH_TAILS):
            return
        for arg in call.args:
            if not isinstance(arg, ast.Name) \
                    or not POOL_NAME_RE.search(arg.id):
                continue
            bind = self.env.get(arg.id)
            if bind is not None and bind.level == HOST and bind.definite:
                self.model.add_finding(
                    "UNSPECCED_POOL", self.ctx, call,
                    f"pool tree `{arg.id}` reaches this mesh dispatch "
                    f"with no matching partition rule: it will be "
                    f"replicated onto every shard instead of sharded; "
                    f"place it first via place_with_rules "
                    f"(mergetree/partition_rules.py)",
                    subject=f"{self.fn_name}|{arg.id}|{callee_name}")


# -- small helpers -----------------------------------------------------------


def _str_literals(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.add(node.value)
    elif isinstance(node, (ast.Tuple, ast.List)):
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
    return out


def _ctor_rank(call: ast.Call) -> Optional[int]:
    if not call.args:
        return None
    tail = _tail(_dotted(call.func))
    if tail == "arange":
        return 1
    shape = call.args[0]
    if isinstance(shape, (ast.Tuple, ast.List)):
        return len(shape.elts)
    if isinstance(shape, ast.Constant) and isinstance(shape.value, int):
        return 1
    return None


def _module_name(path: str) -> str:
    from .callgraph import module_name_for_path
    return module_name_for_path(path)
