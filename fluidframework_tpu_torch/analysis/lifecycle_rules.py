"""In-place lifecycle rules (whole-program; counterpart of
fluidframework_tpu's analysis/lifecycle_rules.py).

Three rules over the callgraph + dataflow layer (callgraph.py /
dataflow.py), guarding the port's counterpart of JAX's donated-dispatch
discipline. Where JAX donates a buffer, the port mutates it in place:
the in-place forms are declared in IN_PLACE_ARGS tables beside their
functions (mergetree/kernel.py's paged ops, mergetree/paging.py's page
writes, server/serve_step.py's paged burst and megakernel), and their
``_keep`` twins mutate nothing.

* ``USE_AFTER_DONATE``: a binding (or alias: tuple leaf, NamedTuple
  member, attribute chain) that was passed to an in-place position is
  read again, other than through the value the call returns, before it
  is rebound. In JAX the read was of a freed buffer and raised; in torch
  it is no crash but a silent read of the call's new state.
* ``DONATED_ESCAPE``: a binding passed to an in-place position is
  stored into ``self.*`` state that outlives the call, either
  stored-then-mutated or mutated-then-stored.
* ``PAGE_ID_DTYPE``: the integer dtype lattice propagated through
  ``.to``/``.long``/``astype``/the factories/arithmetic/subscripts, so a
  page id widened or narrowed from torch.int32 through an intermediate
  binding is caught.

Sanctioned patterns are modeled as guards, not blanket suppressions: the
``_keep`` twins simply declare no in-place positions; metadata probes
(``.shape``/``.device``) are reads of no data; and the canonical
``pool, ... = apply_ops_paged(pool, ...)`` rebind kills the mark in the
same statement.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set, Tuple

from .engine import ModuleContext, Violation
from .registry import rule
from .torch_rules import _scan_scope

# Page-table indices are the canonical torch.int32 page id. The name
# trigger and the paged kernel surface are the JAX package's.
_PAGE_NAME_RE = re.compile(
    r"(^|_)(page_?(ids?|tables?)|pids)($|_)", re.IGNORECASE)

_PAGED_KERNEL_NAMES = {
    "gather_pages", "scatter_pages", "rollback_pages", "apply_ops_paged",
    "compact_pages", "compact_extract_paged", "serve_paged_burst",
}


def _program_for(ctx: ModuleContext):
    """The whole-program context. analyze_paths attaches one spanning
    every analyzed module; analyze_source (fixtures) gets a
    single-module program built on demand."""
    program = getattr(ctx, "program", None)
    if program is None:
        from .engine import ProgramContext
        program = ProgramContext([ctx])
        ctx.program = program
    return program


def _enclosing_class(ctx: ModuleContext, fn: ast.AST) -> Optional[str]:
    cur = ctx.parents.get(fn)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = ctx.parents.get(cur)
    return None


def _module_findings(ctx: ModuleContext):
    """Run the dataflow pass once per module; the three rules below
    each filter their kind. Cached on the context because the registry
    invokes every rule's check() independently."""
    cached = getattr(ctx, "_lifecycle_findings", None)
    if cached is not None:
        return cached
    from .callgraph import module_name_for_path
    from .dataflow import FunctionDataflow
    program = _program_for(ctx)
    module_name = module_name_for_path(ctx.path)
    findings: List[Tuple[str, ast.AST, str]] = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        df = FunctionDataflow(
            fn, module_name, _enclosing_class(ctx, fn),
            program.index, program.summaries,
            page_name_re=_PAGE_NAME_RE,
            paged_kernel_names=_PAGED_KERNEL_NAMES)
        for f in df.run():
            findings.append((f.kind, f.node, f.message))
    # Module-level statements: dtype lattice only, no in-place semantics.
    mod_fn = ast.FunctionDef(
        name="<module>", body=[s for s in ctx.tree.body
                               if not isinstance(s, (ast.FunctionDef,
                                                     ast.AsyncFunctionDef,
                                                     ast.ClassDef))],
        decorator_list=[],
        args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                           kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]))
    df = FunctionDataflow(mod_fn, module_name, None, program.index,
                          program.summaries,
                          page_name_re=_PAGE_NAME_RE,
                          paged_kernel_names=_PAGED_KERNEL_NAMES,
                          track_donation=False)
    for f in df.run():
        findings.append((f.kind, f.node, f.message))
    ctx._lifecycle_findings = findings
    return findings


def _emit(ctx: ModuleContext, kind: str) -> Iterator[Violation]:
    if not _scan_scope(ctx):
        return
    seen: Set[Tuple[int, int, str]] = set()
    for k, node, message in _module_findings(ctx):
        if k != kind:
            continue
        key = (getattr(node, "lineno", 0),
               getattr(node, "col_offset", 0), message)
        if key in seen:
            continue
        seen.add(key)
        yield ctx.violation(kind, node, message)


@rule("USE_AFTER_DONATE",
      "Read of a binding (or alias) passed to an in-place form, other "
      "than through the value the call returns",
      family="torch",
      rationale="An in-place form (IN_PLACE_ARGS) writes its argument's "
                "tensors: a later read of that binding, or of an alias "
                "of it, is no crash in torch but a silent read of the "
                "call's new state where the code names the old one. "
                "Rebind from the call's result, or call the _keep twin "
                "where the old state must survive.")
def use_after_donate(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "USE_AFTER_DONATE")


@rule("DONATED_ESCAPE",
      "Binding passed to an in-place form stored into self.*/module "
      "state that outlives the call",
      family="torch",
      rationale="Instance state holding a plane that an in-place form "
                "writes aliases whatever the next such call writes: the "
                "next reader (often a whole flush later) sees state it "
                "never applied. Store the call's RESULT, or rebind the "
                "attribute before returning.")
def donated_escape(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "DONATED_ESCAPE")


@rule("PAGE_ID_DTYPE",
      "Page-table index built, cast, or propagated with a non-int32 "
      "integer dtype",
      family="torch",
      rationale="Page ids are the canonical torch.int32 device index: "
                "int64 doubles every page-table transfer, int16 wraps "
                "past 32k pages into another document's page, and "
                "unsigned dtypes destroy the -1 padding sentinel. The "
                "dtype propagates through .to/.long/astype/arithmetic, "
                "so the drift is caught even through intermediate "
                "bindings.")
def page_id_dtype(ctx: ModuleContext) -> Iterator[Violation]:
    yield from _emit(ctx, "PAGE_ID_DTYPE")
