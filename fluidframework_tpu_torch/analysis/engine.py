"""fluidlint engine for the port: parse, shared AST context,
suppressions, dispatch (counterpart of fluidframework_tpu's
analysis/engine.py).

The engine owns everything rule implementations share: the parsed tree
with parent links, the device-path index, inline suppression comments,
and stable violation fingerprints for the baseline. Rules stay small
predicate functions over this context.

The device path. The JAX analyzer keys its kernel rules on ``jax.jit``;
the port has no jit, so its torch rules (torch_rules.py) key on the
functions that compose tensors on the serving and stepping paths. The
scope is a declared root table, DEVICE_PATH_ROOTS: pipeline.full_step
(as its factory make_full_step), the serve_step window, burst, paged
burst and megakernel entry points, the kernel.apply_ops* scan apply and
the paged ops (each with its _keep twin), ticket_kernel.scan_tickets,
the pallas_apply / pallas_ops wrappers, the LWW lane scan's two entry
points (lww_kernel.apply_lww_batched and apply_lww_window), the
window's admission and pack wrappers (serve_step.admit_merge_ops and
_pack_window), the zamboni and narrow-wire wrappers (kernel.compact,
compact_batched, extract_visible_batched, compact_extract_batched and
narrow_pack), and the fused apply over sp tiles
(fused_sp.apply_ops_fused_sp and apply_ops_fused_shardmap). The call
graph (callgraph.py) closes the table over resolved callees in the
analyzed package; the closure does not enter a function named *_plain
(the plain references the kernels are held to, run on CPU tensors) or
the host modules of DEVICE_PATH_STOP_MODULES (the kernel build and
loader, the mesh runtime's bookkeeping, telemetry). A function is on the
device path when the roots reach it, and a def nested in such a function
is in its scope. A fixture marks a root with ``# fluidlint: device-root``
on or above its def line.
"""

from __future__ import annotations

import ast
import hashlib
import re
import tokenize
from dataclasses import dataclass
from io import StringIO
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

# Repo root = the directory holding the fluidframework_tpu_torch package;
# baseline entries key file paths relative to it so the gate is stable
# regardless of the CWD the analyzer runs from.
REPO_ROOT = Path(__file__).resolve().parents[2]

SUPPRESS_RE = re.compile(
    r"#\s*fluidlint:\s*disable(?:=(?P<rules>[A-Z0-9_,\s]+))?"
    r"(?:\s*[—:-]\s*(?P<reason>.*))?")


@dataclass(frozen=True)
class Violation:
    rule_id: str
    path: str          # repo-root-relative (or absolute if outside)
    line: int
    col: int
    message: str
    symbol: str        # enclosing def/class qualname ("" at module level)
    line_text: str

    @property
    def fingerprint(self) -> str:
        """Stable identity for baseline matching: deliberately excludes
        the line *number* (which drifts on unrelated edits) in favour of
        the enclosing symbol plus the normalized source line."""
        raw = "|".join((self.rule_id, self.path, self.symbol,
                        " ".join(self.line_text.split())))
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.rule_id}{sym}: {self.message}"


@dataclass
class DeviceInfo:
    """A device-path function: the function that composes tensors on the
    serving path, and the root of DEVICE_PATH_ROOTS (or the fixture's
    ``# fluidlint: device-root`` def) that reaches it."""
    node: ast.AST
    qualname: str
    root: str

    def tensor_params(self) -> Set[str]:
        """Parameters taken to hold tensors (or NamedTuples of tensors):
        those annotated with a tensor type, and unannotated ones with no
        default whose name does not read as a Python scalar, a flag or a
        handle (STATIC_PARAM_RE). A parameter with a default is a flag or
        a size: the port passes every tensor positionally."""
        args = self.node.args
        out: Set[str] = set()
        positional = args.posonlyargs + args.args
        n_defaults = len(args.defaults)
        for i, a in enumerate(positional):
            has_default = i >= len(positional) - n_defaults
            if _tensor_annotation(a.annotation):
                out.add(a.arg)
            elif (a.annotation is None and not has_default
                  and not STATIC_PARAM_RE.search(a.arg)):
                out.add(a.arg)
        out.update(a.arg for a in args.kwonlyargs
                   if _tensor_annotation(a.annotation))
        return out


#: The device path's roots: the entry points that compose tensors on the
#: serving and stepping paths, as "module:function" (a factory such as
#: make_full_step stands for the step it builds: its nested defs are in
#: the root's lexical scope).
DEVICE_PATH_ROOTS = (
    "fluidframework_tpu_torch.server.pipeline:make_full_step",
    "fluidframework_tpu_torch.server.serve_step:serve_window",
    "fluidframework_tpu_torch.server.serve_step:serve_burst",
    "fluidframework_tpu_torch.server.serve_step:serve_paged_burst",
    "fluidframework_tpu_torch.server.serve_step:serve_paged_burst_keep",
    "fluidframework_tpu_torch.server.serve_step:make_serve_megakernel",
    "fluidframework_tpu_torch.mergetree.kernel:apply_ops",
    "fluidframework_tpu_torch.mergetree.kernel:apply_ops_batched",
    "fluidframework_tpu_torch.mergetree.kernel:apply_ops_keep",
    "fluidframework_tpu_torch.mergetree.kernel:apply_ops_batched_keep",
    "fluidframework_tpu_torch.mergetree.kernel:apply_ops_paged",
    "fluidframework_tpu_torch.mergetree.kernel:apply_ops_paged_keep",
    "fluidframework_tpu_torch.mergetree.kernel:rollback_pages",
    "fluidframework_tpu_torch.mergetree.kernel:rollback_pages_keep",
    "fluidframework_tpu_torch.mergetree.kernel:compact_pages",
    "fluidframework_tpu_torch.mergetree.kernel:compact_pages_keep",
    "fluidframework_tpu_torch.mergetree.kernel:compact_extract_paged",
    "fluidframework_tpu_torch.mergetree.kernel:compact_extract_paged_keep",
    "fluidframework_tpu_torch.mergetree.kernel:compact",
    "fluidframework_tpu_torch.mergetree.kernel:compact_batched",
    "fluidframework_tpu_torch.mergetree.kernel:extract_visible_batched",
    "fluidframework_tpu_torch.mergetree.kernel:compact_extract_batched",
    "fluidframework_tpu_torch.mergetree.kernel:narrow_pack",
    "fluidframework_tpu_torch.server.ticket_kernel:scan_tickets",
    "fluidframework_tpu_torch.mergetree.pallas_apply:apply_ops_fused",
    "fluidframework_tpu_torch.mergetree.pallas_ops:summary_lengths",
    "fluidframework_tpu_torch.server.lww_kernel:apply_lww_batched",
    "fluidframework_tpu_torch.server.lww_kernel:apply_lww_window",
    "fluidframework_tpu_torch.server.serve_step:admit_merge_ops",
    "fluidframework_tpu_torch.server.serve_step:_pack_window",
    "fluidframework_tpu_torch.mergetree.fused_sp:apply_ops_fused_sp",
    "fluidframework_tpu_torch.mergetree.fused_sp:apply_ops_fused_shardmap",
)

#: The closure does not enter these: the plain references the kernels are
#: held to (a function named *_plain), and the host modules a launch
#: calls into (the kernel build and loader, the mesh runtime's block and
#: launch bookkeeping, telemetry).
DEVICE_PATH_STOP_RE = re.compile(r"_plain$")
DEVICE_PATH_STOP_MODULES = (
    "fluidframework_tpu_torch.kernels.build",
    "fluidframework_tpu_torch.parallel.mesh",
    "fluidframework_tpu_torch.telemetry",
)

DEVICE_ROOT_RE = re.compile(r"#\s*fluidlint:\s*device-root\b")

#: Parameter names that read as a Python scalar, a flag or a handle (not
#: a tensor) when a parameter carries no annotation.
STATIC_PARAM_RE = re.compile(
    r"(^|_)(self|cls|n|k|t|a|b|c|i|j|num|slots|capacity|steps|batch|width|"
    r"size|shards|dims?|axis|mesh|fn|stage|plain|fused|keep|stats|extract|"
    r"batched|path|name|device|dev|dtype|geo|layout|ln|by|what|entry|"
    r"k_slots|a_slots|kind_name|noop_skip|paged_scalars)$")

_TENSOR_TYPES = ("Tensor", "DocState", "PackedOps", "RunCols",
                 "TicketState", "RawOps", "Ticketed", "LwwState", "LwwOps",
                 "Sharded")


def _tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    return any(t in text for t in _TENSOR_TYPES)


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' for anything
    else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _int_elems(node: ast.AST) -> Set[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        out: Set[int] = set()
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, int):
                out.add(el.value)
        return out
    return set()


def device_root_defs(tree: ast.Module, lines: Sequence[str]) -> Set[str]:
    """Names of the module's defs marked ``# fluidlint: device-root`` (on
    the def line or the line above it): the fixture form of a root."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for ln in (node.lineno, node.lineno - 1):
                if 0 < ln <= len(lines) and DEVICE_ROOT_RE.search(
                        lines[ln - 1]):
                    out.add(node.name)
    return out


class ModuleContext:
    """Everything rules need about one source file.

    The derived indexes (parent links, device-path functions,
    suppressions) are LAZY: a fully-cached analyze_paths run parses every
    module for the whole-program layer but never runs a rule against most
    of them, and building the parent map for every module dominates warm
    wall time."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        self._device_functions: Optional[Dict[ast.AST, DeviceInfo]] = None
        self._suppressions: Optional[Dict[int, Set[str]]] = None

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    @property
    def device_functions(self) -> Dict[ast.AST, DeviceInfo]:
        """This module's device-path functions (the module-level defs and
        methods the program's device path reaches), by def node."""
        if self._device_functions is None:
            from .lifecycle_rules import _program_for
            self._device_functions = _program_for(self).device_functions(
                self.path)
        return self._device_functions

    @property
    def suppressions(self) -> Dict[int, Set[str]]:
        if self._suppressions is None:
            self._suppressions = self._scan_suppressions()
        return self._suppressions

    # -- the device path ---------------------------------------------------
    def enclosing_device(self, node: ast.AST) -> Optional[DeviceInfo]:
        """The device-path function lexically containing ``node``, if any:
        nested defs inside a device-path function count (the step a
        factory builds, a phase helper)."""
        funcs = self.device_functions
        if not funcs:
            return None
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and cur in funcs:
                return funcs[cur]
            cur = self.parents.get(cur)
        return None

    def device_nodes(self) -> List[ast.AST]:
        """Every function node on the device path in this module, nested
        defs included (each once)."""
        out: List[ast.AST] = []
        seen: Set[int] = set()
        for fn in self.device_functions:
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and id(sub) not in seen:
                    seen.add(id(sub))
                    out.append(sub)
        return out

    def symbol_for(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    # -- suppressions ------------------------------------------------------
    def _scan_suppressions(self) -> Dict[int, Set[str]]:
        """line -> rule ids disabled there ({"all"} disables everything).
        A suppression comment applies to its own line; a standalone
        comment line applies to the next line as well (so long
        statements can carry the comment just above them)."""
        out: Dict[int, Set[str]] = {}
        try:
            tokens = list(tokenize.generate_tokens(
                StringIO(self.source).readline))
        except (tokenize.TokenError, IndentationError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = m.group("rules")
            ids = ({r.strip() for r in rules.split(",") if r.strip()}
                   if rules else {"all"})
            line = tok.start[0]
            out.setdefault(line, set()).update(ids)
            stripped = self.lines[line - 1].strip() if \
                line <= len(self.lines) else ""
            if stripped.startswith("#"):
                # Standalone comment: applies to the next code line, even
                # across the rest of the comment block and blank lines.
                nxt = line + 1
                while nxt <= len(self.lines) and (
                        not self.lines[nxt - 1].strip()
                        or self.lines[nxt - 1].strip().startswith("#")):
                    nxt += 1
                out.setdefault(nxt, set()).update(ids)
        return out

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        ids = self.suppressions.get(line, set())
        return "all" in ids or rule_id in ids

    # -- violation helper --------------------------------------------------
    def violation(self, rule_id: str, node: ast.AST,
                  message: str) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        return Violation(rule_id=rule_id, path=self.path, line=line,
                         col=col, message=message,
                         symbol=self.symbol_for(node),
                         line_text=text.strip())


@dataclass
class AnalysisResult:
    violations: List[Violation]          # new (not suppressed/baselined)
    baselined: List[Violation]
    suppressed: int
    files: int
    wall_ms: float = 0.0                 # analyzer wall time, this run
    cache_hits: int = 0                  # modules served from the cache
    cache_misses: int = 0                # modules actually re-analyzed
    race_rules_wall_ms: float = 0.0      # lockset model build + findings
    placement_rules_wall_ms: float = 0.0  # placement model build + findings

    @property
    def summary(self) -> dict:
        return {"violations": len(self.violations),
                "baselined": len(self.baselined)}

    @property
    def stats(self) -> dict:
        """The perf block of a run (wall time + cache effectiveness +
        counts)."""
        return {"wall_ms": round(self.wall_ms, 3), "files": self.files,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "race_rules_wall_ms": round(self.race_rules_wall_ms, 3),
                "placement_rules_wall_ms":
                    round(self.placement_rules_wall_ms, 3),
                "suppressed": self.suppressed, **self.summary}


class ProgramContext:
    """Whole-program layer shared by the cross-module rules: the
    symbol/call graph (callgraph.ProgramIndex) plus the per-function
    dataflow summaries (dataflow.compute_summaries). Built once per
    analyze_paths run and attached to every ModuleContext as
    ``ctx.program``; analyze_source builds a single-module one on
    demand (lifecycle_rules._program_for)."""

    def __init__(self, contexts: Sequence["ModuleContext"]):
        from .callgraph import ProgramIndex, module_name_for_path
        self.contexts = list(contexts)
        self.index = ProgramIndex(
            [(module_name_for_path(c.path), c.tree, c.path)
             for c in contexts])
        from .dataflow import compute_summaries
        self.summaries = compute_summaries(self.index)
        self._concurrency = None
        self.race_wall_ms = 0.0
        self._placement = None
        self.placement_wall_ms = 0.0
        self._device_path: Optional[Dict[str, str]] = None
        self._device_by_path: Dict[str, Dict[ast.AST, DeviceInfo]] = {}

    def device_path(self) -> Dict[str, str]:
        """qualname -> root for every function on the device path: the
        roots (DEVICE_PATH_ROOTS present in this program, and the defs
        marked ``# fluidlint: device-root``), closed over their resolved
        same-package callees. The closure does not enter a *_plain
        function or a module of DEVICE_PATH_STOP_MODULES."""
        if self._device_path is not None:
            return self._device_path
        from .callgraph import module_name_for_path
        decls = {d.qualname: d for d in self.index.iter_functions()}
        roots = [q for q in DEVICE_PATH_ROOTS if q in decls]
        for ctx in self.contexts:
            module = module_name_for_path(ctx.path)
            for name in sorted(device_root_defs(ctx.tree, ctx.lines)):
                q = f"{module}:{name}"
                if q in decls:
                    roots.append(q)
        out: Dict[str, str] = {}
        stack = [(q, q) for q in roots]
        edges: Dict[str, Set[str]] = {}
        while stack:
            qual, root = stack.pop()
            if qual in out:
                continue
            out[qual] = root
            decl = decls[qual]
            module = decl.module
            if module not in edges:
                edges[module] = set()
                for caller, callee in self.index.call_edges(module):
                    edges.setdefault(caller, set()).add(callee)
            for callee in sorted(edges.get(qual, ())):
                d = decls.get(callee)
                if d is None or callee in out:
                    continue
                if DEVICE_PATH_STOP_RE.search(d.name) or \
                        d.module.startswith(DEVICE_PATH_STOP_MODULES):
                    continue
                stack.append((callee, root))
        self._device_path = out
        return out

    def device_functions(self, path: str) -> Dict[ast.AST, DeviceInfo]:
        """The device-path defs of the module at ``path``, by node."""
        hit = self._device_by_path.get(path)
        if hit is not None:
            return hit
        from .callgraph import module_name_for_path
        module = module_name_for_path(path)
        reached = self.device_path()
        out: Dict[ast.AST, DeviceInfo] = {}
        syms = self.index.modules.get(module)
        if syms is not None:
            decls = list(syms.functions.values()) + [
                m for ms in syms.methods.values() for m in ms.values()]
            for decl in decls:
                if decl.qualname in reached:
                    out[decl.node] = DeviceInfo(
                        node=decl.node, qualname=decl.qualname,
                        root=reached[decl.qualname])
        self._device_by_path[path] = out
        return out

    def concurrency(self):
        """The whole-program lockset model (concurrency_model.py),
        built lazily once per run and shared by the race rules, the
        --changed-only reach expansion, and the cache digest. Build
        time accumulates into ``race_wall_ms`` (reported as
        ``race_rules_wall_ms``)."""
        if self._concurrency is None:
            import time
            t0 = time.perf_counter()
            from .concurrency_model import ConcurrencyModel
            self._concurrency = ConcurrencyModel(self.index,
                                                 self.contexts)
            self.race_wall_ms += (time.perf_counter() - t0) * 1000.0
        return self._concurrency

    def placement(self):
        """The whole-program placement lattice (placement_model.py),
        built lazily once per run and shared by the placement rules,
        the --changed-only reach expansion, and the cache digest. Build
        time accumulates into ``placement_wall_ms`` (reported as
        ``placement_rules_wall_ms``)."""
        if self._placement is None:
            import time
            t0 = time.perf_counter()
            from .placement_model import PlacementModel
            self._placement = PlacementModel(self.index, self.contexts)
            self.placement_wall_ms += (time.perf_counter() - t0) * 1000.0
        return self._placement

    def digest(self, include_concurrency: bool = True,
               include_placement: bool = True) -> str:
        """Interface digest for the result cache: any change to a
        donation signature, transitive summary, concurrency fact
        (lock decl, thread root, race finding), or placement fact
        (mesh axes, partition-rule table, placement finding) anywhere
        invalidates every module's cached result (a caller two modules
        away may now be donating — or racing, or resharding — where it
        wasn't). ``include_concurrency=False`` / ``include_placement=
        False`` skip the family's model facts for runs whose rule
        filter excludes it — their cached results contain no findings
        of that family, so its drift is irrelevant to them (the rule
        filter is part of the cache key), and skipping avoids both the
        model-build cost and spurious invalidation."""
        items = list(self.index.signature_digest_items())
        items.extend(f"device|{q}|{r}"
                     for q, r in sorted(self.device_path().items()))
        for q in sorted(self.summaries):
            s = self.summaries[q]
            if s.donated_params or s.metadata_only_params:
                items.append(f"{q}|{sorted(s.donated_params)}|"
                             f"{sorted(s.metadata_only_params)}")
        if include_concurrency:
            items.extend(self.concurrency().digest_items())
        if include_placement:
            items.extend(self.placement().digest_items())
        return hashlib.sha1("\n".join(items).encode()).hexdigest()[:20]


def _rel_path(path: Path) -> str:
    path = path.resolve()
    try:
        return path.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def iter_python_files(paths: Sequence[str]) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix == ".py":
            yield p


def analyze_source(source: str, path: str = "<memory>",
                   only: Iterable[str] = ()) -> List[Violation]:
    """Run (a subset of) the rules over one source string. Suppressions
    apply; baseline does not (that is a CLI-level concern). Fixture
    tests drive this directly."""
    from .registry import iter_checks
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Violation(rule_id="PARSE_ERROR", path=path,
                          line=exc.lineno or 1, col=exc.offset or 0,
                          message=f"could not parse: {exc.msg}",
                          symbol="", line_text="")]
    ctx = ModuleContext(path, source, tree)
    out: List[Violation] = []
    for r in iter_checks(only):
        for v in r.check(ctx):
            if not ctx.is_suppressed(v.rule_id, v.line):
                out.append(v)
    out.sort(key=lambda v: (v.line, v.col, v.rule_id))
    return out


def analyze_paths(paths: Sequence[str], baseline=None,
                  only: Iterable[str] = (), cache=None,
                  restrict: Optional[Set[str]] = None) -> AnalysisResult:
    """Analyze ``paths``. ``cache`` (analysis.cache.ResultCache) skips
    modules whose (source, rules, program-interface) fingerprints are
    unchanged. ``restrict`` limits REPORTING to the given repo-relative
    paths while the whole-program context still spans everything parsed
    — the ``--changed-only`` pre-commit mode."""
    import time
    t0 = time.perf_counter()
    from .registry import iter_checks
    rules = iter_checks(only)
    new: List[Violation] = []
    base: List[Violation] = []
    suppressed = 0
    files = 0
    contexts: List[ModuleContext] = []
    sources: Dict[str, str] = {}
    for file in iter_python_files(paths):
        rel = _rel_path(file)
        try:
            source = file.read_text()
            tree = ast.parse(source)
        except (OSError, SyntaxError, UnicodeDecodeError) as exc:
            if restrict is None or rel in restrict:
                files += 1
                new.append(Violation(
                    rule_id="PARSE_ERROR", path=rel, line=1, col=0,
                    message=f"could not parse: {exc}", symbol="",
                    line_text=""))
            continue
        contexts.append(ModuleContext(rel, source, tree))
        sources[rel] = source
    # The whole-program layer spans every parsed module, restricted or
    # not: a donation signature lives wherever it lives.
    program = ProgramContext(contexts)
    race_active = any(r.family == "race" for r in rules)
    placement_active = any(r.family == "placement" for r in rules)
    # The digest (and the family-model builds inside it) is a cache
    # concern: a cacheless run pays a model only if a rule of that
    # family actually checks a module in scope.
    program_dig = "" if cache is None else \
        program.digest(include_concurrency=race_active,
                       include_placement=placement_active)
    rules_dig = ""
    if cache is not None:
        from .cache import rules_digest
        rules_dig = rules_digest()
    only_key = tuple(sorted(only))
    # Storage slot per (module, rule filter): a focused run (--rule) and
    # the full run share the cache file without evicting each other's
    # entries.
    slot_suffix = ("#" + ",".join(only_key)) if only_key else ""
    # Race and placement findings are whole-program: a change to any
    # file in a thread root's reach (or a placement group — mesh axes
    # and the partition-rule table span modules) can alter that
    # family's findings in OTHER files, so --changed-only additionally
    # re-reports the family's rules on every file its model's reach
    # expansion ties to a changed file.
    extra_rules: Dict[str, List] = {}
    if restrict is not None:
        for family, model_of in (
                ("race", lambda: program.concurrency()),
                ("placement", lambda: program.placement())):
            family_rules = [r for r in rules if r.family == family]
            if not family_rules:
                continue
            for path in model_of().reach_expansion(set(restrict)) \
                    - set(restrict):
                extra_rules.setdefault(path, []).extend(family_rules)
    def split_baseline(module_violations):
        for v in module_violations:
            if baseline is not None and baseline.contains(v):
                base.append(v)
            else:
                new.append(v)

    def run_rules(ctx, active_rules):
        module_violations = []
        module_suppressed = 0
        for r in active_rules:
            for v in r.check(ctx):
                if ctx.is_suppressed(v.rule_id, v.line):
                    module_suppressed += 1
                else:
                    module_violations.append(v)
        return module_violations, module_suppressed

    for ctx in contexts:
        ctx.program = program
        if restrict is not None and ctx.path not in restrict:
            if ctx.path in extra_rules:
                files += 1
                module_violations, module_suppressed = \
                    run_rules(ctx, extra_rules[ctx.path])
                suppressed += module_suppressed
                split_baseline(module_violations)
            continue
        files += 1
        cache_key = None
        if cache is not None:
            cache_key = cache.key(sources[ctx.path], rules_dig,
                                  program_dig, only_key)
            hit = cache.get(ctx.path + slot_suffix, cache_key)
            if hit is not None:
                module_violations, module_suppressed = hit
                suppressed += module_suppressed
                split_baseline(module_violations)
                continue
        module_violations, module_suppressed = run_rules(ctx, rules)
        if cache is not None:
            cache.put(ctx.path + slot_suffix, cache_key,
                      module_violations, module_suppressed)
        suppressed += module_suppressed
        split_baseline(module_violations)
    if cache is not None:
        cache.save()
    key = lambda v: (v.path, v.line, v.col, v.rule_id)  # noqa: E731
    new.sort(key=key)
    base.sort(key=key)
    return AnalysisResult(
        violations=new, baselined=base, suppressed=suppressed,
        files=files, wall_ms=(time.perf_counter() - t0) * 1000.0,
        cache_hits=cache.hits if cache is not None else 0,
        cache_misses=cache.misses if cache is not None else 0,
        race_rules_wall_ms=program.race_wall_ms,
        placement_rules_wall_ms=program.placement_wall_ms)
