"""Intraprocedural dataflow for the in-place lifecycle rules
(counterpart of fluidframework_tpu's analysis/dataflow.py).

JAX donates a buffer to a ``donate_argnums`` call; the port's
counterpart is an in-place form, a function that IN_PLACE_ARGS declares
to mutate the tensors at some argument positions (the paged ops of
mergetree/kernel.py, the page writes of mergetree/paging.py,
serve_step.serve_paged_burst and serve_step.serve_megakernel; their
``_keep`` twins mutate nothing). The discipline: once a binding is
passed to an in-place position, every binding that aliases it holds the
new state, and a read of it other than through the value the call
returns is a silent read of that new state (in JAX it was a read of a
freed buffer). This pass walks each function with a small abstract
interpreter:

* **regions**: every binding (local name or ``self.x.y`` attribute
  chain) maps to an abstract buffer region; ``a = b`` aliases, tuple
  unpacks of a composite share its region (NamedTuple fields die with
  the tuple), ``tuple(xs)``/``list(xs)`` share ``xs``'s region, a fresh
  call result gets a fresh region, reassignment kills.
* **in-place calls**: at a call site whose callee resolves
  (ProgramIndex) to an in-place signature, the regions read by the
  mutated argument expressions are marked; same-statement assignment
  targets rebind AFTER the marking, so the canonical
  ``pool, ... = apply_ops_paged(pool, ...)`` stays clean.
* **reads**: a later Load of a marked region is USE_AFTER_DONATE; a
  ``self.*`` store left holding a marked region at function exit (or a
  store of an already-marked value) is DONATED_ESCAPE.
* **dtype lattice**: integer dtypes (int16/int32/int64/uint8/unknown)
  propagate through ``.to``/``.long``/``.int``/``.short``/``astype``,
  the factories (``torch.tensor``/``as_tensor``/``zeros``/...),
  arithmetic and subscripts, so PAGE_ID_DTYPE follows a page id through
  intermediate bindings: page tables are torch.int32.

Sanctioned patterns are modeled, not suppressed: metadata probes
(``.shape``/``.dtype``/``.device``, ``len``/``isinstance``), calls whose
resolved callee only reads a parameter's metadata (including through
``map(probe, xs)``), and the ``*_keep`` twins, which simply declare no
in-place positions.

Branches merge conservatively (marked-anywhere stays marked; a kill on
one branch does not kill the merge), ``except`` handlers see every
in-place call the ``try`` body made WITHOUT its rebinds (the handler
runs at an arbitrary raise point), and loop bodies are processed once
(no fixpoint).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .callgraph import ProgramIndex, ResolvedCallee
from .engine import _dotted

# Attribute reads that touch metadata, never buffer contents.
METADATA_ATTRS = {
    "shape", "dtype", "ndim", "dim", "size", "numel", "nbytes", "device",
    "is_cuda", "layout", "spec", "mesh", "capacity", "overlap_slots",
    "anno_slots", "steps", "element_size",
}

# Calls whose reading of an argument is a metadata/structure probe.
METADATA_CALLS = {
    "len", "isinstance", "type", "id", "repr", "hasattr", "getattr",
}

_PROBE_TAILS = ("is_sharded",)

_MAX_CHAIN_DEPTH = 4

# -- dtype lattice -----------------------------------------------------------

_INT_WIDTH = {"int8": 8, "int16": 16, "int32": 32, "int64": 64,
              "uint8": 8, "uint16": 16, "uint32": 32, "uint64": 64}

#: torch's aliases of the integer dtypes.
_TORCH_ALIASES = {"long": "int64", "int": "int32", "short": "int16"}

#: Tensor methods that cast to one integer dtype.
_CAST_METHODS = {"long": "int64", "int": "int32", "short": "int16",
                 "byte": "uint8", "char": "int8"}

#: Integer dtypes that are NOT the canonical int32 page index: narrower
#: wraps past 32k pages, wider doubles transfers, unsigned 32-bit
#: destroys the -1 padding sentinel.
BAD_PAGE_DTYPES = {"int8", "int16", "int64",
                   "uint8", "uint16", "uint32", "uint64"}

_DTYPE_FACTORIES = {
    "asarray", "array", "tensor", "as_tensor", "zeros", "ones", "empty",
    "full", "arange", "full_like", "zeros_like", "ones_like", "empty_like",
}

_ARRAY_MODULES = ("torch", "np", "numpy")


def dtype_literal(node: ast.AST) -> Optional[str]:
    """'int64' for ``torch.int64``/``torch.long``/``np.int64``/``"int64"``
    nodes."""
    if isinstance(node, ast.Attribute) and \
            _dotted(node.value) in _ARRAY_MODULES:
        name = node.attr
        if _dotted(node.value) == "torch":
            name = _TORCH_ALIASES.get(name, name)
        return name if name in _INT_WIDTH else None
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value in _INT_WIDTH:
        return node.value
    return None


def join_dtypes(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """Arithmetic promotion, pessimistically: unsigned taint sticks
    (it is the sentinel-destroying case), otherwise the wider wins;
    one-sided knowledge propagates."""
    if a is None:
        return b
    if b is None:
        return a
    if a.startswith("u") or b.startswith("u"):
        return a if a.startswith("u") else b
    return a if _INT_WIDTH.get(a, 0) >= _INT_WIDTH.get(b, 0) else b


# -- the abstract state ------------------------------------------------------


@dataclass(frozen=True)
class DonationSite:
    line: int
    callee: str
    binding: str  # the binding whose region was donated (for messages)


class Env:
    """Binding -> region + per-region facts. Copy-on-branch."""

    __slots__ = ("vars", "donated", "dtype", "page", "stores",
                 "terminated")

    def __init__(self):
        self.vars: Dict[str, int] = {}
        self.donated: Dict[int, DonationSite] = {}
        self.dtype: Dict[int, str] = {}
        self.page: Set[int] = set()
        # self.* attr chains stored in THIS function: chain -> store line
        self.stores: Dict[str, int] = {}
        self.terminated: Optional[str] = None  # "return" | "raise" | loop

    def copy(self) -> "Env":
        out = Env()
        out.vars = dict(self.vars)
        out.donated = dict(self.donated)
        out.dtype = dict(self.dtype)
        out.page = set(self.page)
        out.stores = dict(self.stores)
        out.terminated = self.terminated
        return out


@dataclass
class FunctionSummary:
    """Interprocedural facts about one function, keyed by qualname."""
    qualname: str
    donated_params: Set[str] = field(default_factory=set)
    donated_positions: Set[int] = field(default_factory=set)
    metadata_only_params: Set[int] = field(default_factory=set)


@dataclass
class Finding:
    kind: str          # "USE_AFTER_DONATE" | "DONATED_ESCAPE" | "PAGE_ID_DTYPE"
    node: ast.AST
    message: str


class FunctionDataflow(ast.NodeVisitor):
    """One pass over one function body. Drives both the donation
    lifecycle findings and the page-id dtype lattice."""

    def __init__(self, fn: ast.AST, module: str,
                 class_name: Optional[str],
                 index: Optional[ProgramIndex],
                 summaries: Optional[Dict[str, "FunctionSummary"]] = None,
                 page_name_re=None,
                 paged_kernel_names: Optional[Set[str]] = None,
                 track_donation: bool = True):
        self.fn = fn
        self.module = module
        self.class_name = class_name
        self.index = index
        self.summaries = summaries or {}
        self.page_name_re = page_name_re
        self.paged_kernel_names = paged_kernel_names or set()
        self.track_donation = track_donation
        self.findings: List[Finding] = []
        self._next_region = 0
        self._seen_nodes: Set[int] = set()
        self._escaped: Set[Tuple[str, int]] = set()
        self.local_defs: Dict[str, ast.AST] = {
            n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn}
        # Nested defs get metadata-only summaries of their own so the
        # metadata-probe closure (`_probe(self.tstate)`) stays quiet.
        self.local_summaries: Dict[str, FunctionSummary] = {}
        from .callgraph import FunctionDecl
        for name, node in self.local_defs.items():
            qual = f"{module}:<local>.{name}"
            decl = FunctionDecl(qualname=qual, module=module, name=name,
                                class_name=class_name, node=node)
            s = FunctionSummary(qual)
            s.metadata_only_params = _metadata_only_params(decl)
            self.local_summaries[qual] = s
        self.exit_envs: List[Env] = []

    def _summary_for(self, qualname: str) -> Optional["FunctionSummary"]:
        return self.summaries.get(qualname) or \
            self.local_summaries.get(qualname)

    # -- plumbing ----------------------------------------------------------
    def fresh(self) -> int:
        self._next_region += 1
        return self._next_region

    def region_of(self, env: Env, key: str, create: bool = True
                  ) -> Optional[int]:
        r = env.vars.get(key)
        if r is None and create:
            r = self.fresh()
            env.vars[key] = r
            if self.page_name_re is not None and \
                    self.page_name_re.search(key.rsplit(".", 1)[-1]):
                env.page.add(r)
        return r

    def bind(self, env: Env, key: str, region: int) -> None:
        env.vars[key] = region
        # Rebinding a root kills the chains hanging off it.
        prefix = key + "."
        for k in [k for k in env.vars if k.startswith(prefix)]:
            del env.vars[k]
        if self.page_name_re is not None and \
                self.page_name_re.search(key.rsplit(".", 1)[-1]):
            env.page.add(region)

    # -- analysis entry ----------------------------------------------------
    def run(self) -> List[Finding]:
        env = Env()
        args = self.fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            self.region_of(env, a.arg)
        # Pre-seed a region for every trackable chain the body mentions:
        # branch/handler env copies then agree on region ids, so a
        # donation inside a try body is visible to the except handler
        # even for chains (self.tstate) first touched inside the try.
        for node in ast.walk(self.fn):
            if isinstance(node, (ast.Name, ast.Attribute)):
                chain = self._chain(node)
                if chain is not None:
                    self.region_of(env, chain)
        out = self._exec_block(self.fn.body, env)
        if out.terminated is None:
            self.exit_envs.append(out)
        self._check_escapes()
        return self.findings

    # -- statement execution ----------------------------------------------
    def _exec_block(self, stmts: List[ast.stmt], env: Env) -> Env:
        for stmt in stmts:
            if env.terminated:
                break
            env = self._exec(stmt, env)
        return env

    def _exec(self, stmt: ast.stmt, env: Env) -> Env:
        method = getattr(self, "_exec_" + type(stmt).__name__, None)
        if method is not None:
            return method(stmt, env)
        # Default: check reads in every expression the statement holds,
        # apply call effects, no binding changes.
        for expr in ast.iter_child_nodes(stmt):
            if isinstance(expr, ast.expr):
                self._read_check(expr, env)
                self._apply_call_effects(expr, env)
        return env

    # assignments ----------------------------------------------------------
    def _exec_Assign(self, stmt: ast.Assign, env: Env) -> Env:
        escape = self._escape_target(stmt) \
            if self._chain(stmt.value) is not None else None
        self._read_check(stmt.value, env, escape_store=escape)
        self._apply_call_effects(stmt.value, env)
        self._bind_targets(stmt.targets, stmt.value, env, stmt)
        return env

    def _exec_AnnAssign(self, stmt: ast.AnnAssign, env: Env) -> Env:
        if stmt.value is not None:
            escape = self._escape_target(stmt) \
                if self._chain(stmt.value) is not None else None
            self._read_check(stmt.value, env, escape_store=escape)
            self._apply_call_effects(stmt.value, env)
            self._bind_targets([stmt.target], stmt.value, env, stmt)
        return env

    def _exec_AugAssign(self, stmt: ast.AugAssign, env: Env) -> Env:
        self._read_check(stmt.value, env)
        target_key = self._chain(stmt.target)
        if target_key is not None:
            r = self.region_of(env, target_key)
            if r in env.donated:
                self._uad(stmt.target, target_key, env.donated[r], env)
            d = self._infer_dtype(stmt.value, env)
            if d is not None and r is not None:
                env.dtype[r] = join_dtypes(env.dtype.get(r), d)
                self._page_dtype_check(stmt.target, target_key, env, stmt)
        return env

    def _escape_target(self, stmt) -> Optional[str]:
        """When the statement is a plain ``self.x = <name-or-chain>``,
        a donated value read is an ESCAPE (stored into state that
        outlives the call), not a mere use."""
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        if len(targets) == 1:
            chain = self._chain(targets[0])
            if chain is not None and chain.startswith("self."):
                return chain
        return None

    def _bind_targets(self, targets, value: ast.expr, env: Env,
                      stmt: ast.stmt) -> None:
        for target in targets:
            if isinstance(target, (ast.Tuple, ast.List)):
                if isinstance(value, (ast.Tuple, ast.List)) and \
                        len(value.elts) == len(target.elts):
                    for t, v in zip(target.elts, value.elts):
                        self._bind_targets([t], v, env, stmt)
                    continue
                src_key = self._chain(value)
                if src_key is not None:
                    # Unpacking a composite: the leaves share its
                    # region (donating the carry kills them all).
                    region = self.region_of(env, src_key)
                    for t in target.elts:
                        self._bind_simple(t, region, None, env, stmt)
                else:
                    # Call-result unpack: each leaf is its own fresh
                    # buffer — donating one later must not poison its
                    # siblings.
                    for t in target.elts:
                        self._bind_simple(t, self.fresh(), None, env,
                                          stmt)
                continue
            self._bind_value(target, value, env, stmt)

    def _bind_value(self, target: ast.expr, value: ast.expr, env: Env,
                    stmt: ast.stmt) -> None:
        key = self._chain(target)
        if key is None:
            return
        region, dtype = self._value_region(value, env)
        self._bind_simple(target, region, dtype, env, stmt)

    def _bind_simple(self, target: ast.expr, region: Optional[int],
                     dtype: Optional[str], env: Env,
                     stmt: ast.stmt) -> None:
        key = self._chain(target)
        if key is None:
            return
        if region is None:
            region = self.fresh()
        self.bind(env, key, region)
        if dtype is not None:
            env.dtype[region] = dtype
        if key.startswith("self."):
            env.stores[key] = getattr(stmt, "lineno", 0)
        self._page_dtype_check(target, key, env, stmt)

    def _value_region(self, value: ast.expr, env: Env
                      ) -> Tuple[Optional[int], Optional[str]]:
        """Abstract value of an expression: (region, dtype). Aliasing
        expressions return an EXISTING region; everything else is
        fresh."""
        dtype = self._infer_dtype(value, env)
        key = self._chain(value)
        if key is not None:
            return self.region_of(env, key), dtype
        if isinstance(value, ast.Subscript):
            base = self._chain(value.value)
            if base is not None:
                return self.region_of(env, base), dtype
            return self.fresh(), dtype
        if isinstance(value, ast.Call):
            fn = _dotted(value.func)
            if fn in ("tuple", "list") and len(value.args) == 1:
                inner = self._chain(value.args[0])
                if inner is not None:
                    return self.region_of(env, inner), dtype
            # torch.as_tensor(x) / np.asarray(x) with no dtype change
            # alias their input; sharing the region keeps the in-place
            # tracking sound there.
            if fn.rpartition(".")[2] in ("asarray", "as_tensor") \
                    and value.args and \
                    not value.keywords and len(value.args) == 1:
                inner = self._chain(value.args[0])
                if inner is not None:
                    return self.region_of(env, inner), dtype
            r = self.fresh()
            if self._page_taint_of(value, env):
                env.page.add(r)
            return r, dtype
        if isinstance(value, (ast.Tuple, ast.List)):
            r = self.fresh()
            return r, dtype
        if isinstance(value, (ast.BinOp, ast.UnaryOp)):
            r = self.fresh()
            if self._page_taint_of(value, env):
                env.page.add(r)
            return r, dtype
        if isinstance(value, ast.IfExp):
            r = self.fresh()
            return r, dtype
        return self.fresh(), dtype

    # expressions / other statements ---------------------------------------
    def _exec_Expr(self, stmt: ast.Expr, env: Env) -> Env:
        self._read_check(stmt.value, env)
        self._apply_call_effects(stmt.value, env)
        return env

    def _exec_Return(self, stmt: ast.Return, env: Env) -> Env:
        if stmt.value is not None:
            self._read_check(stmt.value, env)
            self._apply_call_effects(stmt.value, env)
        env.terminated = "return"
        self.exit_envs.append(env)
        return env

    def _exec_Raise(self, stmt: ast.Raise, env: Env) -> Env:
        if stmt.exc is not None:
            self._read_check(stmt.exc, env)
        env.terminated = "raise"
        return env

    def _exec_Delete(self, stmt: ast.Delete, env: Env) -> Env:
        for t in stmt.targets:
            key = self._chain(t)
            if key is not None:
                env.vars.pop(key, None)
        return env

    def _exec_Pass(self, stmt, env: Env) -> Env:
        return env

    def _exec_Continue(self, stmt, env: Env) -> Env:
        env.terminated = "continue"
        return env

    def _exec_Break(self, stmt, env: Env) -> Env:
        env.terminated = "break"
        return env

    def _exec_FunctionDef(self, stmt, env: Env) -> Env:
        return env  # nested defs analyzed as their own functions

    _exec_AsyncFunctionDef = _exec_FunctionDef

    def _exec_ClassDef(self, stmt, env: Env) -> Env:
        return env

    def _exec_Import(self, stmt, env: Env) -> Env:
        return env

    _exec_ImportFrom = _exec_Import
    _exec_Global = _exec_Import
    _exec_Nonlocal = _exec_Import
    _exec_Assert = None  # falls through to default (read check only)

    # control flow ---------------------------------------------------------
    def _exec_If(self, stmt: ast.If, env: Env) -> Env:
        self._read_check(stmt.test, env)
        self._apply_call_effects(stmt.test, env)
        env_t = self._exec_block(stmt.body, env.copy())
        env_f = self._exec_block(stmt.orelse, env.copy())
        return self._merge(env_t, env_f)

    def _exec_While(self, stmt: ast.While, env: Env) -> Env:
        self._read_check(stmt.test, env)
        body_env = self._exec_block(stmt.body, env.copy())
        if body_env.terminated in ("continue", "break"):
            body_env.terminated = None
        merged = self._merge(env.copy(), body_env)
        return self._exec_block(stmt.orelse, merged)

    def _exec_For(self, stmt: ast.For, env: Env) -> Env:
        self._read_check(stmt.iter, env)
        self._apply_call_effects(stmt.iter, env)
        loop_env = env.copy()
        self._bind_targets([stmt.target], ast.Constant(value=None),
                           loop_env, stmt)
        body_env = self._exec_block(stmt.body, loop_env)
        if body_env.terminated in ("continue", "break"):
            body_env.terminated = None
        merged = self._merge(env.copy(), body_env)
        return self._exec_block(stmt.orelse, merged)

    _exec_AsyncFor = _exec_For

    def _exec_With(self, stmt: ast.With, env: Env) -> Env:
        for item in stmt.items:
            self._read_check(item.context_expr, env)
            self._apply_call_effects(item.context_expr, env)
            if item.optional_vars is not None:
                self._bind_targets([item.optional_vars],
                                   item.context_expr, env, stmt)
        return self._exec_block(stmt.body, env)

    _exec_AsyncWith = _exec_With

    def _exec_Try(self, stmt: ast.Try, env: Env) -> Env:
        entry = env.copy()
        donations_before = dict(env.donated)
        body_env = self._exec_block(stmt.body, env)
        # The handler runs from an ARBITRARY raise point inside the try
        # body: it sees every in-place call the body made, but none of
        # the rebinds that followed (after a failed in-place dispatch the
        # tensors hold a partial write and the assignment never
        # happened).
        new_donations = {r: s for r, s in body_env.donated.items()
                         if r not in donations_before}
        handler_outs: List[Env] = []
        for handler in stmt.handlers:
            henv = entry.copy()
            henv.donated.update(new_donations)
            # Each donation records the binding it went through; rebind
            # that key to the donated region in the handler env so a
            # carry first PACKED inside the try body (absent from the
            # entry env, or rebound after the donation) still reads as
            # donated at the arbitrary raise point the handler models.
            for r, s in new_donations.items():
                henv.vars[s.binding] = r
            if handler.name:
                self.bind(henv, handler.name, self.fresh())
            hout = self._exec_block(handler.body, henv)
            handler_outs.append(hout)
        out = body_env
        for hout in handler_outs:
            out = self._merge(out, hout)
        out = self._exec_block(stmt.orelse, out)
        return self._exec_block(stmt.finalbody, out)

    _exec_TryStar = _exec_Try

    def _merge(self, a: Env, b: Env) -> Env:
        if a.terminated and not b.terminated:
            return b
        if b.terminated and not a.terminated:
            return a
        out = a.copy()
        for k, r in b.vars.items():
            if k not in out.vars:
                out.vars[k] = r
            elif out.vars[k] != r:
                # Conflicting bindings: a key that is donated ON ITS OWN
                # PATH stays donated in the merge (a kill on one branch
                # must not hide the hazard on the other), but a branch
                # that both donates AND rebinds (`if c: s = step(s, x)`)
                # leaves the other path untouched — there the donation
                # never happened, so the live region wins.
                a_donated = out.vars[k] in a.donated
                b_donated = r in b.donated
                if b_donated and not a_donated:
                    out.vars[k] = r
        out.donated.update(b.donated)
        for r, d in b.dtype.items():
            out.dtype[r] = join_dtypes(out.dtype.get(r), d)
        out.page |= b.page
        for k, line in b.stores.items():
            out.stores.setdefault(k, line)
        if a.terminated and b.terminated:
            out.terminated = a.terminated
        return out

    # -- donation effects --------------------------------------------------
    def _apply_call_effects(self, expr: ast.expr, env: Env) -> None:
        """Walk ``expr`` for in-place calls; mark the regions their
        mutated argument expressions read."""
        if not self.track_donation:
            return
        for call in ast.walk(expr):
            if not isinstance(call, ast.Call):
                continue
            res = self._resolve(call)
            donation = None
            bound = False
            if res is not None:
                donation = res.donation
                bound = res.bound_self
                s = self._summary_for(res.qualname)
                if donation is None and s is not None:
                    if s.donated_positions or s.donated_params:
                        from .callgraph import DonationSignature
                        donation = DonationSignature(
                            callee=res.qualname.rsplit(":", 1)[-1],
                            positions=set(s.donated_positions),
                            names=set(s.donated_params))
            if donation is None:
                continue
            for arg in donation.donated_args(call, bound_self=bound):
                for key, node in self._donatable_keys(arg):
                    r = self.region_of(env, key)
                    if r is not None:
                        env.donated[r] = DonationSite(
                            line=getattr(call, "lineno", 0),
                            callee=donation.callee, binding=key)

    def _donatable_keys(self, arg: ast.expr
                        ) -> Iterable[Tuple[str, ast.AST]]:
        """Bindings whose buffers a donated argument expression hands
        over. Only COMPLETE trackable chains count: a ListComp or
        subscript-bearing expression is unmappable and stays untracked
        (conservative, quiet)."""
        key = self._chain(arg)
        if key is not None:
            yield key, arg
            return
        if isinstance(arg, (ast.Tuple, ast.List)):
            for el in arg.elts:
                yield from self._donatable_keys(el)
            return
        if isinstance(arg, ast.Call):
            fn = _dotted(arg.func)
            if fn in ("tuple", "list") and len(arg.args) == 1:
                yield from self._donatable_keys(arg.args[0])

    def _resolve(self, call: ast.Call) -> Optional[ResolvedCallee]:
        if self.index is None:
            return None
        return self.index.resolve_call(self.module, call,
                                       class_name=self.class_name,
                                       local_defs=self.local_defs)

    # -- read checking -----------------------------------------------------
    def _read_check(self, expr: ast.expr, env: Env,
                    escape_store: Optional[str] = None) -> None:
        """Flag Loads of donated regions inside ``expr`` (evaluated
        against the env BEFORE this statement's own donations/rebinds
        apply)."""
        if not self.track_donation or not env.donated:
            self._page_operand_check(expr, env)
            return
        self._scan_reads(expr, env, escape_store)
        self._page_operand_check(expr, env)

    def _scan_reads(self, node: ast.AST, env: Env,
                    escape_store: Optional[str],
                    parent_stack: Tuple[ast.AST, ...] = ()) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # deferred execution: closures analyzed separately
        chain = self._chain(node) if isinstance(
            node, (ast.Name, ast.Attribute)) else None
        if chain is not None and isinstance(
                getattr(node, "ctx", ast.Load()), ast.Load):
            hit = self._donated_prefix(chain, env)
            if hit is not None:
                site, rest = hit
                # `state.shape` / `state.device` on a mutated `state`
                # is a metadata probe; `state.sum()` (or any other
                # attribute) reads the tensor.
                if rest and any(p in METADATA_ATTRS for p in rest):
                    pass  # `pool.length.shape`: a NamedTuple field's shape
                elif not rest and self._is_metadata_read(node,
                                                         parent_stack):
                    pass
                elif escape_store is not None:
                    self._escaped.add((escape_store, site.line))
                    self.findings.append(Finding(
                        "DONATED_ESCAPE", node,
                        f"`{escape_store}` stores `{chain}`, which "
                        f"`{site.callee}` mutated in place at line "
                        f"{site.line} (via `{site.binding}`); the stored "
                        f"state outlives the call and aliases what the "
                        f"next in-place call writes"))
                else:
                    self._uad(node, chain, site, env)
            return  # chains checked whole, not per component
        for child in ast.iter_child_nodes(node):
            self._scan_reads(child, env, escape_store,
                             parent_stack + (node,))

    def _donated_prefix(self, chain: str, env: Env):
        """(DonationSite, remaining components) when the chain or any
        prefix of it maps to a donated region — reading `state.sum` is
        a read of donated `state`."""
        parts = chain.split(".")
        for cut in range(1, len(parts) + 1):
            prefix = ".".join(parts[:cut])
            r = env.vars.get(prefix)
            if r is not None and r in env.donated:
                return env.donated[r], parts[cut:]
        return None

    def _uad(self, node: ast.AST, chain: str, site: DonationSite,
             env: Env) -> None:
        key = id(node)
        if key in self._seen_nodes:
            return
        self._seen_nodes.add(key)
        self.findings.append(Finding(
            "USE_AFTER_DONATE", node,
            f"`{chain}` reads a tensor that `{site.callee}` mutated in "
            f"place at line {site.line} (via `{site.binding}`) and that "
            f"was not rebound from the call's result since: it silently "
            f"sees the call's new state"))

    def _is_metadata_read(self, node: ast.AST,
                          parents: Tuple[ast.AST, ...]) -> bool:
        """Reads that only touch metadata (shape/dtype/device) are the
        sanctioned probe idiom and stay quiet."""
        # Immediate attribute: x.shape, x.device, …
        for parent in reversed(parents):
            if isinstance(parent, ast.Attribute) and \
                    parent.attr in METADATA_ATTRS:
                return True
            if isinstance(parent, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot))
                    for op in parent.ops):
                return True
            if isinstance(parent, ast.Call):
                fn = _dotted(parent.func)
                if fn in METADATA_CALLS or \
                        fn.rpartition(".")[2] in _PROBE_TAILS:
                    return True
                if fn in ("map", "filter") and parent.args and \
                        self._probe_fn(parent.args[0]):
                    return True
                res = self._resolve(parent)
                summ = self._summary_for(res.qualname) \
                    if res is not None else None
                if summ is not None:
                    # The read is an argument of a call whose resolved
                    # callee only probes that parameter's metadata.
                    try:
                        pos = parent.args.index(node)
                    except ValueError:
                        pos = next(
                            (i for i, a in enumerate(parent.args)
                             if node in ast.walk(a)), None)
                    if pos is not None and \
                            pos in summ.metadata_only_params:
                        return True
                return False  # a real call consumes the buffer
            if not isinstance(parent, (ast.Attribute, ast.Subscript,
                                       ast.Starred)):
                break
        return False

    def _probe_fn(self, expr: ast.AST) -> bool:
        """True when ``expr`` names a function whose param 0 is
        metadata-only (``map(probe, states)``)."""
        if not isinstance(expr, ast.Name):
            return False
        fake = ast.Call(func=ast.Name(id=expr.id, ctx=ast.Load()),
                        args=[], keywords=[])
        ast.copy_location(fake, expr)
        res = self.index.resolve_call(
            self.module, fake, class_name=self.class_name,
            local_defs=self.local_defs) if self.index else None
        summ = self._summary_for(res.qualname) if res is not None else None
        return summ is not None and 0 in summ.metadata_only_params

    # -- escapes -----------------------------------------------------------
    def _check_escapes(self) -> None:
        """A ``self.*`` chain stored in this function and left holding
        a mutated region on any clean exit path escapes the in-place
        call: instance state now aliases what the next in-place call
        writes (a stale lane plane)."""
        reported: Set[Tuple[str, int]] = set(self._escaped)
        for env in self.exit_envs:
            for chain, line in env.stores.items():
                r = env.vars.get(chain)
                if r is None or r not in env.donated:
                    continue
                site = env.donated[r]
                if (chain, site.line) in reported:
                    continue
                reported.add((chain, site.line))
                node = ast.Pass()
                node.lineno = line or site.line
                node.col_offset = 0
                self.findings.append(Finding(
                    "DONATED_ESCAPE", node,
                    f"`{chain}` still holds the tensor `{site.callee}` "
                    f"mutated in place at line {site.line} (stored at "
                    f"line {line}) when the function returns; the "
                    f"stored plane aliases what the next in-place call "
                    f"writes"))

    # -- page-id dtype lattice ---------------------------------------------
    def _infer_dtype(self, expr: ast.expr, env: Env) -> Optional[str]:
        lit = dtype_literal(expr)
        if lit is not None:
            return lit
        key = self._chain(expr)
        if key is not None:
            r = env.vars.get(key)
            return env.dtype.get(r) if r is not None else None
        if isinstance(expr, ast.Subscript):
            base = self._chain(expr.value)
            if base is not None:
                r = env.vars.get(base)
                return env.dtype.get(r) if r is not None else None
            return None
        if isinstance(expr, ast.Call):
            return self._infer_call_dtype(expr, env)
        if isinstance(expr, ast.BinOp):
            return join_dtypes(self._infer_dtype(expr.left, env),
                               self._infer_dtype(expr.right, env))
        if isinstance(expr, ast.UnaryOp):
            return self._infer_dtype(expr.operand, env)
        if isinstance(expr, ast.IfExp):
            return join_dtypes(self._infer_dtype(expr.body, env),
                               self._infer_dtype(expr.orelse, env))
        return None

    def _infer_call_dtype(self, call: ast.Call, env: Env
                          ) -> Optional[str]:
        fn = _dotted(call.func)
        tail = fn.rpartition(".")[2]
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in ("astype", "to", "type"):
            for arg in list(call.args) + [k.value for k in call.keywords]:
                lit = dtype_literal(arg)
                if lit is not None:
                    return lit
            if call.func.attr == "to":  # .to(device) keeps the dtype
                return self._infer_dtype(call.func.value, env)
            return None
        if isinstance(call.func, ast.Attribute) and not call.args and \
                call.func.attr in _CAST_METHODS:
            return _CAST_METHODS[call.func.attr]
        if tail in _DTYPE_FACTORIES:
            for arg in list(call.args) + [k.value for k in call.keywords]:
                lit = dtype_literal(arg)
                if lit is not None:
                    return lit
            # asarray/tensor with no dtype: passes the input through.
            if tail in ("asarray", "array", "tensor", "as_tensor") \
                    and call.args:
                return self._infer_dtype(call.args[0], env)
            return None
        if tail in ("where", "minimum", "maximum", "clamp", "clip"):
            dt = None
            args = call.args[-2:] if tail in ("where", "minimum",
                                               "maximum") else call.args[:1]
            if isinstance(call.func, ast.Attribute) and tail in (
                    "clamp", "clip") and not fn.startswith(("torch.",
                                                            "np.")):
                return self._infer_dtype(call.func.value, env)
            for arg in args:
                dt = join_dtypes(dt, self._infer_dtype(arg, env))
            return dt
        return None

    def _page_taint_of(self, expr: ast.expr, env: Env) -> bool:
        for sub in ast.walk(expr):
            key = self._chain(sub) if isinstance(
                sub, (ast.Name, ast.Attribute)) else None
            if key is None:
                continue
            if self.page_name_re is not None and \
                    self.page_name_re.search(key.rsplit(".", 1)[-1]):
                return True
            r = env.vars.get(key)
            if r is not None and r in env.page:
                return True
        return False

    def _page_dtype_check(self, target: ast.expr, key: str, env: Env,
                          stmt: ast.stmt) -> None:
        """Fire PAGE_ID_DTYPE when a page-named (or page-tainted)
        binding ends up with a non-int32 integer dtype."""
        if self.page_name_re is None:
            return
        r = env.vars.get(key)
        if r is None:
            return
        leaf = key.rsplit(".", 1)[-1]
        is_page = r in env.page or self.page_name_re.search(leaf)
        if not is_page:
            return
        env.page.add(r)
        d = env.dtype.get(r)
        if d is None or d not in BAD_PAGE_DTYPES:
            return
        node = self._dtype_node_in(stmt) or target
        self._emit_page(node, d, f"assigned to `{key}`")

    def _dtype_node_in(self, stmt: ast.stmt) -> Optional[ast.AST]:
        for sub in ast.walk(stmt):
            lit = dtype_literal(sub)
            if lit is not None and lit in BAD_PAGE_DTYPES:
                return sub
        return None

    def _emit_page(self, node: ast.AST, dtype: str, where: str) -> None:
        key = id(node)
        if key in self._seen_nodes:
            return
        self._seen_nodes.add(key)
        self.findings.append(Finding(
            "PAGE_ID_DTYPE", node,
            f"page-id dtype `{dtype}` {where} drifts from the "
            f"canonical int32 page-table index"))

    def _page_operand_check(self, expr: ast.expr, env: Env) -> None:
        """Operands of the gather/scatter-by-page-id kernel surface and
        ``.astype`` casts onto page-tainted values."""
        if self.page_name_re is None:
            return
        for call in ast.walk(expr):
            if not isinstance(call, ast.Call):
                continue
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in ("astype", "to", "type") and \
                    self._page_taint_of(call.func.value, env):
                for arg in list(call.args) + [k.value
                                              for k in call.keywords]:
                    lit = dtype_literal(arg)
                    if lit in BAD_PAGE_DTYPES:
                        base = self._chain(call.func.value) or "page id"
                        self._emit_page(arg, lit,
                                        f"cast onto `{base}`")
                continue
            if isinstance(call.func, ast.Attribute) and not call.args \
                    and call.func.attr in _CAST_METHODS and \
                    _CAST_METHODS[call.func.attr] in BAD_PAGE_DTYPES and \
                    self._page_taint_of(call.func.value, env):
                base = self._chain(call.func.value) or "page id"
                self._emit_page(call, _CAST_METHODS[call.func.attr],
                                f"cast onto `{base}`")
                continue
            fn = _dotted(call.func)
            tail = fn.rpartition(".")[2]
            if tail not in self.paged_kernel_names:
                continue
            for arg in list(call.args) + [k.value for k in call.keywords]:
                hit = False
                for sub in ast.walk(arg):
                    lit = dtype_literal(sub)
                    if lit in BAD_PAGE_DTYPES and not (
                            isinstance(sub, ast.AST) and
                            self._inside_astype_onto_page(sub, arg, env)):
                        self._emit_page(sub, lit,
                                        f"in a `{tail}` operand")
                        hit = True
                if hit:
                    continue
                # No syntactic cast: fall back to the lattice.
                key = self._chain(arg)
                if key is not None:
                    r = env.vars.get(key)
                    d = env.dtype.get(r) if r is not None else None
                    if d in BAD_PAGE_DTYPES:
                        self._emit_page(arg, d,
                                        f"in a `{tail}` operand")

    def _inside_astype_onto_page(self, node, arg, env) -> bool:
        """Avoid double-reporting a literal already flagged by the
        astype-onto-page check within the same operand."""
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("astype", "to", "type") and \
                    self._page_taint_of(sub.func.value, env) and \
                    any(s is node for s in ast.walk(sub)):
                return True
        return False

    # -- chains ------------------------------------------------------------
    def _chain(self, node: ast.AST) -> Optional[str]:
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        parts.append(cur.id)
        if len(parts) > _MAX_CHAIN_DEPTH:
            return None
        return ".".join(reversed(parts))


# -- summaries ---------------------------------------------------------------


def compute_summaries(index: ProgramIndex,
                      iterations: int = 3
                      ) -> Dict[str, FunctionSummary]:
    """Per-function interprocedural facts, to a small fixpoint:

    * ``donated_params`` — params the function passes (as a bare name)
      to a donated position of a known donating callee, so plain
      wrappers propagate donation transitively;
    * ``metadata_only_params`` — params whose every read is a metadata
      probe (shape/device checks), safe to receive mutated
      values.
    """
    summaries: Dict[str, FunctionSummary] = {}
    decls = list(index.iter_functions())
    for decl in decls:
        summaries[decl.qualname] = FunctionSummary(decl.qualname)
        summaries[decl.qualname].metadata_only_params = \
            _metadata_only_params(decl)
    for _ in range(iterations):
        changed = False
        for decl in decls:
            s = summaries[decl.qualname]
            donated = _direct_donated_params(decl, index, summaries)
            if donated - s.donated_params:
                s.donated_params |= donated
                params = decl.param_names
                s.donated_positions |= {
                    params.index(p) for p in donated if p in params}
                changed = True
        if not changed:
            break
    return summaries


def _direct_donated_params(decl, index: ProgramIndex,
                           summaries: Dict[str, FunctionSummary]
                           ) -> Set[str]:
    params = set(decl.param_names)
    if not params:
        return set()
    if decl.in_place:
        return set()  # declared in place: the declaration is its boundary
    out: Set[str] = set()
    local_defs = {n.name: n for n in ast.walk(decl.node)
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))
                  and n is not decl.node}
    for call in ast.walk(decl.node):
        if not isinstance(call, ast.Call):
            continue
        res = index.resolve_call(decl.module, call,
                                 class_name=decl.class_name,
                                 local_defs=local_defs)
        if res is None:
            continue
        donation = res.donation
        if donation is None and res.qualname in summaries:
            s = summaries[res.qualname]
            if s.donated_positions or s.donated_params:
                from .callgraph import DonationSignature
                donation = DonationSignature(
                    callee=res.qualname, positions=set(s.donated_positions),
                    names=set(s.donated_params))
        if donation is None:
            continue
        for arg in donation.donated_args(call,
                                         bound_self=res.bound_self):
            if isinstance(arg, ast.Name) and arg.id in params:
                out.add(arg.id)
    return out


_METADATA_PARENT_OK = (ast.Attribute, ast.Subscript, ast.Compare)


_PROBE_MAX_NODES = 200


def _metadata_only_params(decl) -> Set[int]:
    """Param positions whose every Load in the body is a metadata
    probe. Parameters that are never read as data may safely receive a
    mutated tensor. Only probe-sized functions qualify: a metadata
    probe is a handful of lines, and skipping the walk for real
    functions keeps the summary pass off the warm path's critical
    cost."""
    node = decl.node
    params = decl.param_names
    if not params:
        return set()
    parents: Dict[int, ast.AST] = {}
    count = 0
    for parent in ast.walk(node):
        count += 1
        if count > _PROBE_MAX_NODES:
            return set()
        for child in ast.iter_child_nodes(parent):
            parents[id(child)] = parent
    data_read: Set[str] = set()
    for sub in ast.walk(node):
        if not (isinstance(sub, ast.Name)
                and isinstance(sub.ctx, ast.Load)
                and sub.id in params):
            continue
        cur = parents.get(id(sub))
        ok = False
        hops = 0
        probe = sub
        while cur is not None and hops < 6:
            if isinstance(cur, ast.Attribute) and \
                    cur.attr in METADATA_ATTRS:
                ok = True
                break
            if isinstance(cur, ast.Call):
                fn = _dotted(cur.func)
                if fn in METADATA_CALLS or \
                        fn.rpartition(".")[2] in _PROBE_TAILS:
                    ok = True
                break
            if isinstance(cur, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot))
                    for op in cur.ops):
                ok = True
                break
            if not isinstance(cur, _METADATA_PARENT_OK):
                break
            probe = cur
            cur = parents.get(id(cur))
            hops += 1
        if not ok:
            data_read.add(sub.id)
    # A value DERIVED from a metadata call is probe plumbing: names
    # assigned from metadata calls whose own uses are all metadata reads
    # are covered by the loop above because the derived name is not a
    # param.
    return {i for i, p in enumerate(params) if p not in data_read}
