"""Whole-program lockset model for the port's server concurrency tier
(counterpart of fluidframework_tpu's analysis/concurrency_model.py).

fluidlint v3: the thread/lock discipline that keeps the serving fleet
honest is, as of this layer, machine-checked the same way v2
machine-checks the donated-buffer lifecycle. The model answers, for the
``server/`` and ``telemetry/`` packages:

* **who runs where** — every thread root is discovered from the code
  itself: ``threading.Thread(target=...)`` (including lambda,
  ``functools.partial``, and bound-method targets), executor
  ``submit``/``run_in_executor`` hand-offs, HTTP handler entry points
  (``do_*`` methods of ``*HTTPRequestHandler`` subclasses — the monitor
  /alfred surfaces), and pump callbacks registered via ``subscribe``;
* **what guards what** — lock objects are ``threading.Lock/RLock/
  Condition/Semaphore`` instance attributes (plus module-level locks),
  tracked through ``with`` blocks and ``acquire``/``release`` pairs
  including the try/finally and ``if not lock.acquire(...): return``
  idioms; each function gets a held-lockset effect summary and
  transitive callees inherit the caller's held set (must-held meets by
  intersection across call contexts, Eraser-style);
* **which state is shared** — an instance attribute (or module-level
  container) written from one thread root and read or written from
  another. Per shared attribute the model intersects the locksets over
  all accesses; an empty intersection is the race the
  ``SHARED_STATE_NO_LOCK`` rule reports.

Resolution is name-based and conservative, exactly like the call graph
underneath it (callgraph.py): ``self.m()`` resolves through the class,
``self.merge.extract(...)`` resolves through the instance-attribute
type binding recorded at ``self.merge = MergeLaneStore(...)``, local
``service = self`` aliases resolve through the closure chain (the
monitor's nested HTTP handler), and anything unresolvable models no
effect. Locks passed around as plain function arguments are therefore
tracked only through attribute chains — a documented limit.

Annotations: ``# fluidlint: guarded-by=<attr>`` on an access line
asserts the named lock attribute is held there through a path the
model cannot see; the access's lockset gains that lock (trusted
statically, verified at runtime by ``testing/lockcheck.py``).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import _dotted

# The concurrency tier under analysis. "<memory>" keeps fixtures in
# scope (analyze_source paths).
SCOPE_PREFIXES = (
    "fluidframework_tpu_torch/server", "fluidframework_tpu_torch/telemetry",
    "<memory>")

GUARDED_BY_RE = re.compile(
    r"#\s*fluidlint:\s*guarded-by=(?P<attrs>[A-Za-z_][\w,\s]*)")

_LOCK_FACTORY_TAILS = {"Lock", "RLock", "Condition", "Semaphore",
                       "BoundedSemaphore"}
_LOCK_FACTORY_HEADS = {"", "threading", "_threading"}

# Container-mutating method names: a call through the attribute mutates
# the container in place — a WRITE for race purposes.
_MUTATOR_TAILS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "update",
    "setdefault", "add",
}

_CONDITION_OPS = {"wait", "wait_for", "notify", "notify_all"}

# Thread-root forms (discovery; each becomes its own root id).
_EXECUTORISH = ("executor", "pool", "worker")

MAIN_ROOT = "main"


def in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(p.startswith(s) or f"/{s}" in p for s in SCOPE_PREFIXES)


# -- facts -------------------------------------------------------------------


@dataclass(frozen=True)
class LockDecl:
    key: str      # "module:Class.attr" or "module:name"
    kind: str     # Lock | RLock | Condition | Semaphore | BoundedSemaphore
    owner: str    # Condition's owning lock key ("" = the condition itself)
    path: str
    line: int


@dataclass
class Access:
    attr: str                 # "module:Class.attr" / "module:name"
    kind: str                 # "r" | "w"
    held: Tuple[Tuple[str, int], ...]  # (lock key, acquisition tag)
    node: ast.AST
    init: bool                # inside __init__/__new__: setup, not racing
    in_test_of: Optional[int] = None   # id() of the If whose test holds it
    enclosing_ifs: Tuple[int, ...] = ()

    @property
    def locks(self) -> Set[str]:
        return {k for k, _ in self.held}

    def tag_of(self, lock: str) -> Optional[int]:
        for k, t in self.held:
            if k == lock:
                return t
        return None


@dataclass
class FuncInfo:
    qualname: str
    module: str
    path: str
    class_qual: Optional[str]          # "module:Class" of enclosing class
    node: ast.AST                      # FunctionDef/AsyncFunctionDef/Lambda
    enclosing: Tuple[ast.AST, ...] = ()  # outer function nodes, inner-last
    accesses: List[Access] = field(default_factory=list)
    calls: List[Tuple[str, Tuple[Tuple[str, int], ...], ast.AST]] = \
        field(default_factory=list)
    acquires: List[Tuple[str, Tuple[str, ...], ast.AST]] = \
        field(default_factory=list)
    cond_ops: List[Tuple["LockDecl", str, Tuple[str, ...], ast.AST]] = \
        field(default_factory=list)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


@dataclass(frozen=True)
class ThreadRoot:
    root_id: str     # "thread:<qual>" / "http:<qual>" / "pump:<qual>"
    qualname: str    # the entry function
    form: str        # thread | executor | http-handler | subscribe
    path: str
    line: int


@dataclass
class RaceFinding:
    rule_id: str
    path: str
    node: ast.AST
    message: str
    # line-free identity for the program digest (cache correctness must
    # not depend on line numbers — see ProgramContext.digest).
    ident: str


class ClassInfo:
    def __init__(self, module: str, name: str, path: str):
        self.module = module
        self.name = name
        self.path = path
        self.qualname = f"{module}:{name}"
        self.bases: List[str] = []
        self.methods: Dict[str, ast.AST] = {}
        self.locks: Dict[str, LockDecl] = {}
        self.attr_types: Dict[str, str] = {}   # attr -> class qualname


# -- the model ---------------------------------------------------------------


class ConcurrencyModel:
    """Build once per analyze run (engine.ProgramContext.concurrency)."""

    def __init__(self, index, contexts: Sequence) -> None:
        # contexts: engine.ModuleContext-like (path, source, tree)
        self.index = index
        self.modules: List = [c for c in contexts if in_scope(c.path)]
        self.classes: Dict[str, ClassInfo] = {}     # qualname -> info
        self.module_locks: Dict[str, LockDecl] = {}  # key -> decl
        self.module_globals: Dict[str, Set[str]] = {}  # module -> names
        self.functions: Dict[str, FuncInfo] = {}
        self._by_node: Dict[int, FuncInfo] = {}
        self.roots: List[ThreadRoot] = []
        self._root_ids: Set[str] = set()
        self.guarded_lines: Dict[str, Dict[int, Set[str]]] = {}
        self._ctx_by_path = {c.path: c for c in self.modules}
        self._module_names: Dict[str, str] = {}    # path -> dotted module
        self._lambda_n = 0

        for ctx in self.modules:
            self._module_names[ctx.path] = _module_name(ctx.path)
            self._scan_guarded_by(ctx)
        # Two passes: attr-type bindings (`self.merge = MergeLaneStore(…)`)
        # resolve against the COMPLETE class table — the target class may
        # live in a later-indexed module (or further down the same file).
        self._pending_types: List[Tuple[ClassInfo, str, ast.AST]] = []
        for ctx in self.modules:
            self._index_classes(ctx)
        for info, attr, value in self._pending_types:
            for call in self._constructor_calls(value):
                cq = self._resolve_class_name(info.module,
                                              _dotted(call.func))
                if cq is not None:
                    info.attr_types.setdefault(attr, cq)
                    break
        for ctx in self.modules:
            self._index_functions(ctx)
        for fn in list(self.functions.values()):
            _FunctionPass(self, fn).run()
        self._propagate()
        self.findings: List[RaceFinding] = self._compute_findings()

    # -- guarded-by annotations -------------------------------------------
    def _scan_guarded_by(self, ctx) -> None:
        per_line: Dict[int, Set[str]] = {}
        for i, line in enumerate(ctx.source.splitlines(), start=1):
            m = GUARDED_BY_RE.search(line)
            if m:
                attrs = {a.strip() for a in m.group("attrs").split(",")
                         if a.strip()}
                per_line.setdefault(i, set()).update(attrs)
        if per_line:
            self.guarded_lines[ctx.path] = per_line

    # -- class / lock indexing --------------------------------------------
    def _index_classes(self, ctx) -> None:
        module = self._module_names[ctx.path]
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = ClassInfo(module, node.name, ctx.path)
            info.bases = [_dotted(b) for b in node.bases]
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods[sub.name] = sub
            # Lock attrs + instance-attr type bindings: any
            # `self.X = ...` assignment in any method (not just
            # __init__ — lazily-built locks count too).
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    t = sub.targets[0]
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        self._index_self_assign(ctx, info, t.attr,
                                                sub.value, sub)
            self.classes[info.qualname] = info
        # Module-level locks + mutable globals.
        names: Set[str] = set()
        for stmt in ctx.tree.body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            name = stmt.targets[0].id
            kind = _lock_factory(stmt.value)
            if kind is not None:
                key = f"{module}:{name}"
                self.module_locks[key] = LockDecl(
                    key=key, kind=kind, owner="", path=ctx.path,
                    line=stmt.lineno)
            elif _mutable_container(stmt.value):
                names.add(name)
        if names:
            self.module_globals[module] = names

    def _index_self_assign(self, ctx, info: ClassInfo, attr: str,
                           value: ast.AST, stmt: ast.stmt) -> None:
        kind = _lock_factory(value)
        if kind is not None:
            owner = ""
            if kind == "Condition" and isinstance(value, ast.Call) \
                    and value.args:
                owner = self._self_attr_name(value.args[0]) or ""
                if owner:
                    owner = f"{info.qualname}.{owner}"
            self.locks_put(info, attr, kind, owner, ctx.path, stmt.lineno)
            return
        # Type binding: `self.merge = MergeLaneStore(...)`, possibly
        # behind an IfExp (`x if x is not None else MergeLaneStore(...)`)
        # — deferred until every module's classes are indexed.
        if any(True for _ in self._constructor_calls(value)):
            self._pending_types.append((info, attr, value))

    def locks_put(self, info: ClassInfo, attr: str, kind: str, owner: str,
                  path: str, line: int) -> None:
        key = f"{info.qualname}.{attr}"
        info.locks[attr] = LockDecl(key=key, kind=kind, owner=owner,
                                    path=path, line=line)

    @staticmethod
    def _constructor_calls(value: ast.AST) -> Iterable[ast.Call]:
        if isinstance(value, ast.Call):
            yield value
        elif isinstance(value, ast.IfExp):
            for side in (value.body, value.orelse):
                if isinstance(side, ast.Call):
                    yield side

    @staticmethod
    def _self_attr_name(node: ast.AST) -> Optional[str]:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _resolve_class_name(self, module: str,
                            dotted: str) -> Optional[str]:
        """'MergeLaneStore' / 'mod.Cls' as seen from ``module`` ->
        class qualname, via the import alias table."""
        if not dotted:
            return None
        parts = dotted.split(".")
        syms = self.index.modules.get(module)
        if len(parts) == 1:
            q = f"{module}:{parts[0]}"
            if q in self.classes:
                return q
            if syms is not None and parts[0] in syms.imports:
                target = syms.imports[parts[0]]
                mod, _, cls = target.rpartition(".")
                q = f"{mod}:{cls}"
                return q if q in self.classes else None
            return None
        if syms is not None and parts[0] in syms.imports:
            mod = syms.imports[parts[0]]
            q = f"{mod}:{parts[-1]}"
            return q if q in self.classes else None
        return None

    # -- function table ----------------------------------------------------
    def _index_functions(self, ctx) -> None:
        module = self._module_names[ctx.path]

        def visit(node, qual_parts, class_qual, enclosing):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{module}:{'.'.join(qual_parts + [child.name])}" \
                        if qual_parts else f"{module}:{child.name}"
                    fi = FuncInfo(qualname=qual, module=module,
                                  path=ctx.path, class_qual=class_qual,
                                  node=child, enclosing=tuple(enclosing))
                    self.functions[qual] = fi
                    self._by_node[id(child)] = fi
                    visit(child, qual_parts + [child.name], class_qual,
                          enclosing + [child])
                elif isinstance(child, ast.ClassDef):
                    cq = f"{module}:{child.name}"
                    visit(child, qual_parts + [child.name], cq, enclosing)
                else:
                    visit(child, qual_parts, class_qual, enclosing)

        visit(ctx.tree, [], None, [])
        # HTTP handler entry points: do_* methods of HTTPRequestHandler
        # subclasses run on the server's per-request threads.
        for cls in self.classes.values():
            if cls.path != ctx.path:
                continue
            if not any(b.rsplit(".", 1)[-1].endswith("HTTPRequestHandler")
                       for b in cls.bases):
                continue
            for name, meth in cls.methods.items():
                if name.startswith("do_"):
                    fi = self._by_node.get(id(meth))
                    if fi is not None:
                        self.add_root("http", fi, meth)

    def register_lambda(self, owner: FuncInfo, lam: ast.Lambda) -> FuncInfo:
        """A lambda used as a thread target becomes its own analyzable
        unit (its body runs on the spawned thread)."""
        self._lambda_n += 1
        qual = f"{owner.qualname}.<lambda#{self._lambda_n}>"
        body = ast.Expr(value=lam.body)
        ast.copy_location(body, lam)
        fn = ast.FunctionDef(
            name=f"<lambda#{self._lambda_n}>", args=lam.args, body=[body],
            decorator_list=[], returns=None, type_comment=None)
        fn.type_params = []  # py3.12 field; absent pre-3.12 is fine
        ast.copy_location(fn, lam)
        fi = FuncInfo(qualname=qual, module=owner.module, path=owner.path,
                      class_qual=owner.class_qual, node=fn,
                      enclosing=owner.enclosing + (owner.node,))
        self.functions[qual] = fi
        self._by_node[id(fn)] = fi
        _FunctionPass(self, fi).run()
        return fi

    def add_root(self, form: str, fi: FuncInfo, node: ast.AST) -> None:
        root_id = f"{form}:{fi.qualname}"
        if root_id in self._root_ids:
            return
        self._root_ids.add(root_id)
        self.roots.append(ThreadRoot(
            root_id=root_id, qualname=fi.qualname, form=form,
            path=fi.path, line=getattr(node, "lineno", 0)))

    # -- resolution helpers (used by the per-function pass) ----------------
    def lock_for_expr(self, fn: FuncInfo, expr: ast.AST,
                     local_aliases: Dict[str, str]) -> Optional[LockDecl]:
        """Resolve a context-manager / acquire-receiver expression to a
        known lock: ``self.X``, module-level ``X``, a local alias
        ``lock = self.X``, or a typed chain ``self.a.b``."""
        chain = _chain(expr)
        if chain is None:
            return None
        parts = chain.split(".")
        if parts[0] in local_aliases:
            chain = local_aliases[parts[0]] + \
                ("." + ".".join(parts[1:]) if len(parts) > 1 else "")
            parts = chain.split(".")
        root_class = self._class_of_root(fn, parts[0])
        if root_class is not None and len(parts) >= 2:
            cls = self.classes.get(root_class)
            if cls is None:
                return None
            if len(parts) == 2:
                return cls.locks.get(parts[1])
            inner = cls.attr_types.get(parts[1])
            if inner is not None and len(parts) == 3:
                icls = self.classes.get(inner)
                if icls is not None:
                    return icls.locks.get(parts[2])
            return None
        if len(parts) == 1:
            key = f"{fn.module}:{parts[0]}"
            return self.module_locks.get(key)
        return None

    def _class_of_root(self, fn: FuncInfo, name: str) -> Optional[str]:
        """'self' (or a closure alias of self) -> enclosing class."""
        if name == "self":
            return fn.class_qual
        return self._self_aliases(fn).get(name)

    def _self_aliases(self, fn: FuncInfo) -> Dict[str, str]:
        """`service = self` bindings visible to ``fn`` (its own body or
        an enclosing function's — the monitor's nested HTTP handler
        reads the service through such a closure alias). Computed once
        per function."""
        cached = getattr(fn, "_self_aliases", None)
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        for owner in (fn.node,) + tuple(reversed(fn.enclosing)):
            owner_fi = self._by_node.get(id(owner))
            owner_class = owner_fi.class_qual if owner_fi is not None \
                else fn.class_qual
            for sub in ast.walk(owner):
                if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Name)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                        and owner_class is not None):
                    out.setdefault(sub.targets[0].id, owner_class)
        fn._self_aliases = out
        return out

    def attr_key_for(self, fn: FuncInfo, expr: ast.AST) -> Optional[str]:
        """Shared-state key for a Name/Attribute chain, or None when
        the chain does not resolve to instance/module state."""
        chain = _chain(expr)
        if chain is None:
            return None
        parts = chain.split(".")
        root_class = self._class_of_root(fn, parts[0])
        if root_class is not None and len(parts) >= 2:
            cls = self.classes.get(root_class)
            if cls is None:
                return None
            attr = parts[1]
            if attr in cls.locks or attr in cls.methods:
                return None
            if len(parts) >= 3 and attr in cls.attr_types:
                inner = self.classes.get(cls.attr_types[attr])
                if inner is not None and parts[2] not in inner.locks \
                        and parts[2] not in inner.methods:
                    return f"{inner.qualname}.{parts[2]}"
                return None
            return f"{root_class}.{attr}"
        if len(parts) == 1 and parts[0] in \
                self.module_globals.get(fn.module, ()):
            return f"{fn.module}:{parts[0]}"
        return None

    def resolve_callable(self, fn: FuncInfo,
                         expr: ast.AST) -> Optional[FuncInfo]:
        """A thread-target / callee expression -> FuncInfo, covering
        bare names (local defs first), self/alias methods, typed attr
        chains, partial(f, ...), and lambdas."""
        if isinstance(expr, ast.Lambda):
            return self.register_lambda(fn, expr)
        if isinstance(expr, ast.Call):
            tail = _dotted(expr.func).rsplit(".", 1)[-1]
            if tail == "partial" and expr.args:
                return self.resolve_callable(fn, expr.args[0])
            return None
        chain = _chain(expr)
        if chain is None:
            return None
        parts = chain.split(".")
        if len(parts) == 1:
            # Nested defs of the enclosing chain shadow module symbols.
            hit = self._nested_defs(fn).get(parts[0])
            if hit is not None:
                return hit
            res = self.index.lookup(fn.module, parts[0])
            if res is not None and res.decl is not None:
                return self._by_node.get(id(res.decl.node))
            return None
        root_class = self._class_of_root(fn, parts[0])
        if root_class is not None:
            cls = self.classes.get(root_class)
            if cls is None:
                return None
            if len(parts) == 2:
                meth = self._lookup_method(cls, parts[1])
                return self._by_node.get(id(meth)) if meth is not None \
                    else None
            if len(parts) == 3 and parts[1] in cls.attr_types:
                inner = self.classes.get(cls.attr_types[parts[1]])
                if inner is not None:
                    meth = self._lookup_method(inner, parts[2])
                    return self._by_node.get(id(meth)) \
                        if meth is not None else None
            return None
        # module alias: counters.increment(...) etc.
        res = self.index.resolve_call(
            fn.module,
            ast.Call(func=expr, args=[], keywords=[]),
            class_name=None)
        if res is not None and res.decl is not None:
            return self._by_node.get(id(res.decl.node))
        return None

    def _nested_defs(self, fn: FuncInfo) -> Dict[str, FuncInfo]:
        """Name -> FuncInfo for defs nested in ``fn`` or its enclosing
        chain (closures shadow module symbols at call sites). Computed
        once per function — resolve_callable runs per call site and
        must not re-walk the body each time."""
        cached = getattr(fn, "_nested_def_map", None)
        if cached is not None:
            return cached
        out: Dict[str, FuncInfo] = {}
        for owner in tuple(fn.enclosing) + (fn.node,):
            for sub in ast.walk(owner):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) \
                        and sub is not owner:
                    hit = self._by_node.get(id(sub))
                    if hit is not None:
                        # inner-most wins: later owners are closer
                        out[sub.name] = hit
        fn._nested_def_map = out
        return out

    def _lookup_method(self, cls: ClassInfo, name: str,
                       _seen: Optional[Set[str]] = None
                       ) -> Optional[ast.AST]:
        if name in cls.methods:
            return cls.methods[name]
        seen = _seen or {cls.qualname}
        for base in cls.bases:
            bq = self._resolve_class_name(cls.module, base)
            if bq is not None and bq not in seen:
                seen.add(bq)
                hit = self._lookup_method(self.classes[bq], name, seen)
                if hit is not None:
                    return hit
        return None

    def guard_locks_at(self, fn: FuncInfo, line: int) -> Set[str]:
        """Locks a `# fluidlint: guarded-by=...` comment on this line
        asserts are held (resolved against the function's class, then
        the module)."""
        names = self.guarded_lines.get(fn.path, {}).get(line)
        if not names:
            return set()
        out: Set[str] = set()
        for name in names:
            decl = None
            if fn.class_qual is not None:
                cls = self.classes.get(fn.class_qual)
                if cls is not None:
                    decl = cls.locks.get(name)
            if decl is None:
                decl = self.module_locks.get(f"{fn.module}:{name}")
            if decl is not None:
                out.add(decl.key)
        return out

    # -- propagation -------------------------------------------------------
    def _propagate(self) -> None:
        edges: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        in_deg: Dict[str, int] = {q: 0 for q in self.functions}
        for fn in self.functions.values():
            for callee, held, _node in fn.calls:
                if callee not in self.functions:
                    continue
                edges.setdefault(fn.qualname, []).append(
                    (callee, tuple(sorted({k for k, _ in held}))))
                in_deg[callee] += 1
        root_quals = {r.qualname for r in self.roots}
        seeds = set(root_quals)
        seeds |= {q for q, d in in_deg.items()
                  if d == 0 and q not in root_quals}
        # must-held: meet (intersection) over call contexts; may-held:
        # union (for lock-order pairs, a lock held on ANY path counts).
        self.must_inherited: Dict[str, Optional[frozenset]] = \
            {q: None for q in self.functions}
        self.may_inherited: Dict[str, Set[str]] = \
            {q: set() for q in self.functions}
        # Each work item carries BOTH contexts: the must set meets
        # (intersection) at the callee, the may set unions — and both
        # flow transitively, so a lock held two call levels above an
        # acquisition still forms a lock-order pair even when a mixed
        # unlocked caller empties the must set on the way down.
        work = [(q, frozenset(), frozenset()) for q in sorted(seeds)]
        while work:
            qual, must_ctx, may_ctx = work.pop()
            cur = self.must_inherited[qual]
            new = must_ctx if cur is None else \
                frozenset(cur & must_ctx)
            changed = new != cur
            may = self.may_inherited[qual]
            if not may_ctx <= may:
                may |= may_ctx
                changed = True
            if not changed:
                continue
            self.must_inherited[qual] = new
            for callee, held in edges.get(qual, ()):
                work.append((callee, frozenset(new | set(held)),
                             frozenset(may | set(held))))
        for q, v in self.must_inherited.items():
            if v is None:
                self.must_inherited[q] = frozenset()
        # Per-root reach (plain BFS over call edges).
        plain: Dict[str, List[str]] = {}
        for src, outs in edges.items():
            plain[src] = [c for c, _ in outs]
        self.reach: Dict[str, Set[str]] = {}
        for root in self.roots:
            seen = {root.qualname}
            stack = [root.qualname]
            while stack:
                for nxt in plain.get(stack.pop(), ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append(nxt)
            self.reach[root.root_id] = seen
        # main pseudo-root: everything reachable from the non-thread
        # seeds (public surface / unreferenced functions).
        main_seen: Set[str] = set()
        stack = sorted(seeds - root_quals)
        main_seen.update(stack)
        while stack:
            for nxt in plain.get(stack.pop(), ()):
                if nxt not in main_seen:
                    main_seen.add(nxt)
                    stack.append(nxt)
        # Functions unreachable from any seed (cycles with no external
        # entry) default to main.
        for q in self.functions:
            if q not in main_seen and not any(
                    q in r for r in self.reach.values()):
                main_seen.add(q)
        self.reach[MAIN_ROOT] = main_seen

    def roots_of(self, qualname: str) -> Set[str]:
        return {rid for rid, seen in self.reach.items()
                if qualname in seen}

    def effective_locks(self, fn: FuncInfo, access: Access) -> Set[str]:
        inherited = self.must_inherited.get(fn.qualname) or frozenset()
        line = getattr(access.node, "lineno", 0)
        return access.locks | set(inherited) | \
            self.guard_locks_at(fn, line)

    # -- findings ----------------------------------------------------------
    def _compute_findings(self) -> List[RaceFinding]:
        out: List[RaceFinding] = []
        atom_nodes = self._atomicity_findings(out)
        self._shared_state_findings(out, atom_nodes)
        self._lock_order_findings(out)
        self._signal_findings(out)
        out.sort(key=lambda f: (f.path, getattr(f.node, "lineno", 0),
                                f.rule_id, f.message))
        return out

    def _grouped_accesses(self):
        """attr key -> [(FuncInfo, Access, roots, locks)] over non-init
        accesses of functions in scope. An access on a line suppressed
        for SHARED_STATE_NO_LOCK is a DECLARED-SAFE cross-thread access
        (the sanctioned racy-by-design probes): it drops out of the
        shared computation entirely, so the attr's other accessors stay
        quiet instead of inheriting an empty intersection from it."""
        groups: Dict[str, List[Tuple[FuncInfo, Access, Set[str],
                                     Set[str]]]] = {}
        for fn in self.functions.values():
            roots = self.roots_of(fn.qualname)
            suppressed = getattr(self._ctx_by_path.get(fn.path),
                                 "is_suppressed", None)
            for a in fn.accesses:
                if a.init:
                    continue
                if suppressed is not None and suppressed(
                        "SHARED_STATE_NO_LOCK",
                        getattr(a.node, "lineno", 0)):
                    continue
                groups.setdefault(a.attr, []).append(
                    (fn, a, roots, self.effective_locks(fn, a)))
        return groups

    def shared_attrs(self):
        """attr -> (accesses, lockset intersection) for attrs written
        from one root and touched from another."""
        cached = getattr(self, "_shared_cache", None)
        if cached is not None:
            return cached
        out = {}
        for attr, recs in self._grouped_accesses().items():
            write_roots: Set[str] = set()
            all_roots: Set[str] = set()
            for _fn, a, roots, _locks in recs:
                all_roots |= roots
                if a.kind == "w":
                    write_roots |= roots
            if not write_roots or len(all_roots) < 2:
                continue
            if not (all_roots - {MAIN_ROOT}):
                continue  # never touched by a spawned root
            guard = None
            for _fn, _a, _roots, locks in recs:
                guard = set(locks) if guard is None else guard & locks
            out[attr] = (recs, guard or set())
        self._shared_cache = out
        return out

    def _shared_state_findings(self, out: List[RaceFinding],
                               atom_nodes: Set[int]) -> None:
        for attr, (recs, guard) in sorted(self.shared_attrs().items()):
            if guard:
                continue  # a common lock guards every access
            roots = sorted({r for _f, _a, rs, _l in recs for r in rs})
            # The most common lock across accesses, as a fix hint.
            counts: Dict[str, int] = {}
            for _f, _a, _r, locks in recs:
                for lk in locks:
                    counts[lk] = counts.get(lk, 0) + 1
            candidate = max(sorted(counts), key=lambda k: counts[k]) \
                if counts else None
            seen_fns: Set[str] = set()
            for fn, a, _r, locks in sorted(
                    recs, key=lambda r: (r[0].path,
                                         getattr(r[1].node, "lineno", 0))):
                if fn.qualname in seen_fns:
                    continue
                if candidate is not None and candidate in locks:
                    continue
                if id(a.node) in atom_nodes:
                    continue
                seen_fns.add(fn.qualname)
                hint = (f"; other accesses hold `{_disp_lock(candidate)}`"
                        if candidate else "")
                msg = (f"`{_disp_attr(attr)}` is shared across thread "
                       f"roots ({', '.join(_disp_root(r) for r in roots)}) "
                       f"but the lockset intersection over its accesses "
                       f"is empty{hint}; guard this "
                       f"{'write' if a.kind == 'w' else 'read'} or "
                       f"annotate the deliberate pattern "
                       f"(# fluidlint: guarded-by=<attr> / disable)")
                out.append(RaceFinding(
                    "SHARED_STATE_NO_LOCK", fn.path, a.node, msg,
                    ident=f"SHARED_STATE_NO_LOCK|{fn.path}|"
                          f"{fn.qualname}|{attr}|{a.kind}"))

    def _atomicity_findings(self, out: List[RaceFinding]) -> Set[int]:
        """Read-test-write of a shared attr where the guarding lock was
        released between test and act (two distinct acquisitions)."""
        shared = self.shared_attrs()
        flagged: Set[int] = set()
        emitted: Set[Tuple[str, str, int]] = set()
        for attr, (recs, _guard) in sorted(shared.items()):
            by_fn: Dict[str, List[Tuple[FuncInfo, Access]]] = {}
            for fn, a, _r, _l in recs:
                by_fn.setdefault(fn.qualname, []).append((fn, a))
            for qual, pairs in sorted(by_fn.items()):
                tests = [(fn, a) for fn, a in pairs
                         if a.in_test_of is not None and a.kind == "r"]
                writes = [(fn, a) for fn, a in pairs if a.kind == "w"
                          and a.enclosing_ifs]
                for tfn, ta in tests:
                    for wfn, wa in writes:
                        if ta.in_test_of not in wa.enclosing_ifs:
                            continue
                        # Atomic when SOME lock spans both test and
                        # act: inherited from the caller (held across
                        # the whole body), or a shared local lock
                        # taken by the SAME acquisition.
                        inherited = self.must_inherited.get(
                            wfn.qualname) or frozenset()
                        spanning = set(inherited) | {
                            lk for lk in (wa.locks & ta.locks)
                            if wa.tag_of(lk) == ta.tag_of(lk)}
                        if spanning or not wa.locks:
                            # unguarded act is SHARED_STATE territory
                            continue
                        lock = sorted(wa.locks)[0]
                        key = (qual, attr, id(wa.node))
                        if key in emitted:
                            continue
                        emitted.add(key)
                        flagged.add(id(wa.node))
                        flagged.add(id(ta.node))
                        where = ("through two separate acquisitions"
                                 if lock in ta.locks else
                                 "only around the act, not the test")
                        out.append(RaceFinding(
                            "ATOMICITY_CHECK_THEN_ACT", wfn.path,
                            wa.node,
                            f"check-then-act on `{_disp_attr(attr)}`: "
                            f"`{_disp_lock(lock)}` is held {where} — "
                            f"the lock is released (or not yet taken) "
                            f"between test and act, so another thread "
                            f"can invalidate the test; widen one "
                            f"critical section over both",
                            ident=f"ATOMICITY_CHECK_THEN_ACT|"
                                  f"{wfn.path}|{qual}|{attr}"))
        return flagged

    def _lock_order_findings(self, out: List[RaceFinding]) -> None:
        # direction (A, B) -> first (path, node, qual) that acquired B
        # while holding A.
        pairs: Dict[Tuple[str, str], Tuple[str, ast.AST, str]] = {}
        for fn in sorted(self.functions.values(),
                         key=lambda f: (f.path,
                                        getattr(f.node, "lineno", 0))):
            may = self.may_inherited.get(fn.qualname, set())
            for lock, held_before, node in fn.acquires:
                for prior in sorted(set(held_before) | may):
                    if prior == lock:
                        continue
                    pairs.setdefault((prior, lock),
                                     (fn.path, node, fn.qualname))
        for (a, b), (path, node, qual) in sorted(pairs.items()):
            if a >= b or (b, a) not in pairs:
                continue
            rpath, rnode, rqual = pairs[(b, a)]
            for (l1, l2, p, n, q, other_q) in (
                    (a, b, path, node, qual, rqual),
                    (b, a, rpath, rnode, rqual, qual)):
                out.append(RaceFinding(
                    "LOCK_ORDER_INVERSION", p, n,
                    f"`{_disp_lock(l2)}` is acquired while holding "
                    f"`{_disp_lock(l1)}` here, but `{other_q}` acquires "
                    f"them in the opposite order — two threads taking "
                    f"one lock each deadlock; pick one global order",
                    ident=f"LOCK_ORDER_INVERSION|{p}|{q}|{l1}|{l2}"))

    def _signal_findings(self, out: List[RaceFinding]) -> None:
        for fn in self.functions.values():
            inherited = self.must_inherited.get(fn.qualname) or frozenset()
            for decl, op, held, node in fn.cond_ops:
                eff = set(held) | set(inherited) | \
                    self.guard_locks_at(fn, getattr(node, "lineno", 0))
                owner = decl.owner or decl.key
                if owner in eff or decl.key in eff:
                    continue
                out.append(RaceFinding(
                    "SIGNAL_WITHOUT_LOCK", fn.path, node,
                    f"`{_disp_lock(decl.key)}.{op}()` outside its "
                    f"owning lock `{_disp_lock(owner)}`: "
                    f"notify/wait without the lock raises "
                    f"RuntimeError or misses the wakeup entirely; "
                    f"wrap the call in `with "
                    f"{_disp_lock(owner).rsplit('.', 1)[-1]}:`",
                    ident=f"SIGNAL_WITHOUT_LOCK|{fn.path}|"
                          f"{fn.qualname}|{decl.key}|{op}"))

    # -- engine surface ----------------------------------------------------
    def findings_for(self, path: str) -> List[RaceFinding]:
        return [f for f in self.findings if f.path == path]

    def reach_expansion(self, changed: Set[str]) -> Set[str]:
        """Files whose race findings a change to ``changed`` can alter:
        the full file set of every spawned-thread root whose reach
        touches a changed file, PLUS every file accessing a shared
        attribute (or a lock-order inversion pair) that a changed file
        also touches — a main-side file can flip another file's
        lockset-intersection verdict without sharing any spawned root's
        call graph (locksets are whole-program)."""
        out: Set[str] = set(changed)
        groups: List[Set[str]] = []
        for root in self.roots:
            files = {self.functions[q].path
                     for q in self.reach.get(root.root_id, ())
                     if q in self.functions}
            files.add(root.path)
            groups.append(files)
        for recs, _guard in self.shared_attrs().values():
            groups.append({fn.path for fn, _a, _r, _l in recs})
        by_lock_pair: Dict[Tuple[str, str], Set[str]] = {}
        for fn in self.functions.values():
            for lock, held_before, _node in fn.acquires:
                for prior in held_before:
                    if prior != lock:
                        pair = tuple(sorted((prior, lock)))
                        by_lock_pair.setdefault(pair, set()).add(fn.path)
        groups.extend(by_lock_pair.values())
        for files in groups:
            if files & changed:
                out |= files
        return out

    def digest_items(self) -> List[str]:
        """Line-number-free serialization of everything that shapes the
        race findings; folded into the program digest so a concurrency-
        relevant edit anywhere invalidates every module's cached
        result, while pure line drift keeps the cache warm."""
        items = [f"cc-lock|{d.key}|{d.kind}|{d.owner}"
                 for d in self.module_locks.values()]
        for cls in self.classes.values():
            for d in cls.locks.values():
                items.append(f"cc-lock|{d.key}|{d.kind}|{d.owner}")
        items.extend(f"cc-root|{r.root_id}|{r.form}" for r in self.roots)
        items.extend(f"cc-find|{f.ident}|{f.message}"
                     for f in self.findings)
        return sorted(items)

    def inferred_guards(self, class_qual: str) -> Dict[str, str]:
        """attr name -> lock attr name for a class's shared attributes
        whose lockset intersection is a single same-class lock — the
        statically inferred discipline testing/lockcheck.py verifies at
        runtime."""
        out: Dict[str, str] = {}
        prefix = class_qual + "."
        for attr, (_recs, guard) in self.shared_attrs().items():
            if not attr.startswith(prefix):
                continue
            same_class = sorted(lk for lk in guard
                                if lk.startswith(prefix))
            if len(same_class) == 1:
                out[attr[len(prefix):]] = \
                    same_class[0][len(prefix):]
        return out


# -- the per-function pass ---------------------------------------------------


class _FunctionPass:
    """One statement-ordered walk over one function body, tracking the
    locally held lockset (with tags identifying each acquisition) and
    recording accesses, call edges, lock-order acquires, condition ops,
    and thread spawns onto the FuncInfo."""

    def __init__(self, model: ConcurrencyModel, fn: FuncInfo):
        self.model = model
        self.fn = fn
        self.is_init = fn.name in ("__init__", "__new__")
        self.aliases: Dict[str, str] = {}  # local name -> chain it aliases
        self._if_stack: List[int] = []

    def run(self) -> None:
        self._block(self.fn.node.body, [])

    # -- statements --------------------------------------------------------
    def _block(self, stmts, held: List[Tuple[str, int]]) -> None:
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt, held: List[Tuple[str, int]]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate analyzable units
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                self._expr(item.context_expr, held)
                decl = self.model.lock_for_expr(self.fn, item.context_expr,
                                                self.aliases)
                if decl is not None:
                    self._record_acquire(decl.key, held, stmt)
                    held.append((decl.key, id(stmt)))
                    pushed += 1
            self._block(stmt.body, held)
            for _ in range(pushed):
                held.pop()
            return
        if isinstance(stmt, ast.If):
            self._if_test(stmt, held)
            self._if_stack.append(id(stmt))
            body_held = list(held)
            self._block(stmt.body, body_held)
            else_held = list(held)
            self._block(stmt.orelse, else_held)
            self._if_stack.pop()
            # Continuation sees the locks held on every NON-terminating
            # outcome (an `if not lock.acquire(...): return` body
            # terminates, so the test's acquire survives through the
            # fall-through side).
            t_body = _terminates(stmt.body)
            t_else = bool(stmt.orelse) and _terminates(stmt.orelse)
            if t_body and not t_else:
                held[:] = else_held
            elif t_else and not t_body:
                held[:] = body_held
            else:
                held[:] = [h for h in body_held if h in else_held]
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body, held)
            for handler in stmt.handlers:
                h_held = list(held)
                self._block(handler.body, h_held)
            self._block(stmt.orelse, held)
            self._block(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, held)
            self._block(stmt.body, list(held))
            self._block(stmt.orelse, list(held))
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, held)
            self._block(stmt.body, list(held))
            self._block(stmt.orelse, list(held))
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, held)
            self._maybe_alias(stmt)
            for t in stmt.targets:
                self._target(t, held)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, held)
            base = stmt.target.value \
                if isinstance(stmt.target, ast.Subscript) else stmt.target
            key = self.model.attr_key_for(self.fn, base)
            if key is not None:
                self._access(key, "r", stmt.target, held)
                self._access(key, "w", stmt.target, held)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, held)
                self._target(stmt.target, held)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                key = self.model.attr_key_for(self.fn, base)
                if key is not None:
                    self._access(key, "w", t, held)
            return
        if isinstance(stmt, (ast.Return, ast.Expr, ast.Assert,
                             ast.Raise)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, held)
            return
        # default: walk child expressions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, held)

    def _if_test(self, stmt: ast.If, held) -> None:
        marker = id(stmt)
        self._expr(stmt.test, held, in_test_of=marker)

    def _maybe_alias(self, stmt: ast.Assign) -> None:
        if len(stmt.targets) != 1 or not isinstance(stmt.targets[0],
                                                    ast.Name):
            return
        chain = _chain(stmt.value)
        if chain is not None:
            self.aliases[stmt.targets[0].id] = chain
        else:
            self.aliases.pop(stmt.targets[0].id, None)

    def _target(self, target: ast.AST, held) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._target(el, held)
            return
        if isinstance(target, ast.Subscript):
            self._expr(target.slice, held)
            key = self.model.attr_key_for(self.fn, target.value)
            if key is not None:
                self._access(key, "w", target, held)
            return
        key = self.model.attr_key_for(self.fn, target)
        if key is not None:
            self._access(key, "w", target, held)

    # -- expressions -------------------------------------------------------
    def _expr(self, expr: ast.AST, held,
              in_test_of: Optional[int] = None) -> None:
        for node in self._walk_expr(expr):
            if isinstance(node, ast.Call):
                self._call(node, held)
            elif isinstance(node, (ast.Name, ast.Attribute)):
                if isinstance(getattr(node, "ctx", None), ast.Load):
                    key = self.model.attr_key_for(self.fn, node)
                    if key is not None:
                        self._access(key, "r", node, held,
                                     in_test_of=in_test_of)

    def _walk_expr(self, expr: ast.AST):
        """Pre-order walk that treats a full attr chain as ONE node
        (no per-component re-reporting) and skips deferred bodies."""
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue
            yield node
            if isinstance(node, ast.Attribute):
                # chain handled whole at the top node; only descend
                # past the chain's root expression when it is complex
                # (a call/subscript), never into Name/Attribute links.
                cur = node
                while isinstance(cur, ast.Attribute):
                    cur = cur.value
                if not isinstance(cur, ast.Name):
                    stack.append(cur)
                continue
            if isinstance(node, ast.Call):
                stack.extend(node.args)
                stack.extend(kw.value for kw in node.keywords)
                # The callee: a Name/Attribute chain is resolved whole
                # by _call (which also records the receiver access, as
                # a write for mutator tails); only a COMPLEX chain root
                # (subscript, nested call) descends here.
                if not isinstance(node.func, (ast.Name, ast.Attribute)):
                    stack.append(node.func)
                elif isinstance(node.func, ast.Attribute):
                    cur = node.func.value
                    while isinstance(cur, ast.Attribute):
                        cur = cur.value
                    if not isinstance(cur, ast.Name):
                        stack.append(cur)
                continue
            stack.extend(ast.iter_child_nodes(node))

    def _call(self, call: ast.Call, held) -> None:
        func = call.func
        dotted = _dotted(func)
        tail = dotted.rsplit(".", 1)[-1] if dotted else ""
        # 1. lock protocol
        if isinstance(func, ast.Attribute):
            decl = self.model.lock_for_expr(self.fn, func.value,
                                            self.aliases)
            if decl is not None:
                if tail == "acquire":
                    self._record_acquire(decl.key, held, call)
                    held.append((decl.key, id(call)))
                    return
                if tail == "release":
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][0] == decl.key:
                            del held[i]
                            break
                    return
                if decl.kind == "Condition" and tail in _CONDITION_OPS:
                    self.fn.cond_ops.append(
                        (decl, tail,
                         tuple(sorted({k for k, _ in held})), call))
                    return
                if tail == "locked":
                    return
        # 2. thread / callback spawns
        self._maybe_spawn(call, tail, dotted)
        # 3. receiver mutation (self.items.append(...))
        if isinstance(func, ast.Attribute):
            key = self.model.attr_key_for(self.fn, func.value)
            if key is not None:
                kind = "w" if tail in _MUTATOR_TAILS else "r"
                self._access(key, kind, call, held)
        # 4. call edge
        callee = self._resolve_call_edge(call)
        if callee is not None:
            self.fn.calls.append(
                (callee.qualname,
                 tuple((k, t) for k, t in held), call))

    def _maybe_spawn(self, call: ast.Call, tail: str,
                     dotted: str) -> None:
        target_expr = None
        form = None
        if tail == "Thread" and (dotted.rsplit(".", 1)[0]
                                 in ("threading", "_threading", "Thread")
                                 or dotted == "Thread"):
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr, form = kw.value, "thread"
        elif tail == "run_in_executor" and len(call.args) >= 2:
            target_expr, form = call.args[1], "executor"
        elif tail == "submit" and call.args:
            head = dotted.rsplit(".", 2)[-2].lower() if "." in dotted \
                else ""
            if any(tok in head for tok in _EXECUTORISH):
                target_expr, form = call.args[0], "executor"
        elif tail == "subscribe" and call.args:
            cb = call.args[-1]
            for kw in call.keywords:
                if kw.arg == "fn":
                    cb = kw.value
            target_expr, form = cb, "subscribe"
        if target_expr is None:
            return
        target = self.model.resolve_callable(self.fn, target_expr)
        if target is not None:
            self.model.add_root(form, target, call)

    def _resolve_call_edge(self, call: ast.Call) -> Optional[FuncInfo]:
        func = call.func
        if isinstance(func, (ast.Name, ast.Attribute)):
            return self.model.resolve_callable(self.fn, func)
        return None

    # -- recording ---------------------------------------------------------
    def _access(self, key: str, kind: str, node: ast.AST, held,
                in_test_of: Optional[int] = None) -> None:
        self.fn.accesses.append(Access(
            attr=key, kind=kind,
            held=tuple((k, t) for k, t in held),
            node=node, init=self.is_init, in_test_of=in_test_of,
            enclosing_ifs=tuple(self._if_stack)))

    def _record_acquire(self, key: str, held, node: ast.AST) -> None:
        self.fn.acquires.append(
            (key, tuple(sorted({k for k, _ in held})), node))


# -- small helpers -----------------------------------------------------------


def _chain(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    if len(parts) > 4:
        return None
    return ".".join(reversed(parts))


def _lock_factory(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    dotted = _dotted(value.func)
    head, _, tail = dotted.rpartition(".")
    if tail in _LOCK_FACTORY_TAILS and head in _LOCK_FACTORY_HEADS:
        return tail
    return None


def _mutable_container(value: ast.AST) -> bool:
    if isinstance(value, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(value, ast.Call):
        tail = _dotted(value.func).rsplit(".", 1)[-1]
        return tail in ("list", "dict", "set", "deque", "defaultdict",
                        "OrderedDict", "Counter")
    return False


def _terminates(stmts) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _disp_attr(key: str) -> str:
    """'module:Class.attr' -> 'Class.attr' for messages."""
    return key.rsplit(":", 1)[-1]


def _disp_lock(key: Optional[str]) -> str:
    return key.rsplit(":", 1)[-1] if key else "<none>"


def _disp_root(root_id: str) -> str:
    if root_id == MAIN_ROOT:
        return "main"
    form, _, qual = root_id.partition(":")
    return f"{form}:{qual.rsplit(':', 1)[-1]}"


def _module_name(path: str) -> str:
    from .callgraph import module_name_for_path
    return module_name_for_path(path)
