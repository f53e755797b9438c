"""Torch kernel-hygiene rules on the device path (counterpart of
fluidframework_tpu's analysis/jax_rules.py; the seven ids are the JAX
package's).

Every rule here scopes itself to the device path (engine.py:
DEVICE_PATH_ROOTS closed over their callees), so host-side code never
trips them. Each checks the torch form of its JAX hazard:

* HOST_SYNC: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``bool()``/``int()``/``float()`` of a tensor, ``torch.cuda.synchronize``;
* TRACED_BRANCH: a Python ``if``/``while`` on a tensor value, and
  boolean-mask indexing (both wait for the device);
* RETRACE_HAZARD: launching calls (torch calls, tensor methods, calls
  of device-path functions) inside a Python loop over a step axis
  (``while``, or ``for`` over a ``range`` bounded by a shape or a step
  count): launches per step, the many-small-launches pattern;
* SCAN_HOST_CALLBACK: a host sync inside such a loop, or inside a kernel
  wrapper (a function that calls ``note_launch``);
* MUTABLE_CAPTURE: a device-path function reading a module-level
  mutable;
* DTYPE_DRIFT: a dtype literal outside mergetree/constants.py's
  CANONICAL_DEVICE_DTYPES;
* MISSING_DONATE: a state-threading step that copies its state where an
  in-place form exists.

They are heuristics over the AST, with no dataflow beyond a per-function
pass that marks which names hold tensors (DeviceInfo.tensor_params, and
locals bound from torch calls, tensor methods, arithmetic and subscripts
of tensors), tuned to stay quiet on the port's idioms: ``is None``
guards, ``.device.type`` / ``.shape`` / ``.dtype`` reads, flags with
defaults.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Optional, Set, Tuple

from .engine import DeviceInfo, ModuleContext, Violation, _dotted
from .registry import rule

DTYPE_NAME_RE = re.compile(
    r"^(u?int(8|16|32|64)|float(16|32|64)?|bfloat16|bool_?|complex(64|128)"
    r"|long|int|short|half|double|cfloat|uint)$")

#: torch's dtype aliases, by canonical name.
_DTYPE_ALIASES = {"long": "int64", "int": "int32", "short": "int16",
                  "half": "float16", "float": "float32", "double": "float64",
                  "cfloat": "complex64", "bool_": "bool"}

_ARRAY_MODULES = ("torch", "np", "numpy")

# Attribute reads that touch metadata, never tensor contents.
_METADATA_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "type", "layout",
    "spec", "mesh", "capacity", "overlap_slots", "anno_slots", "steps",
    "blocks", "path", "launches", "index",
}

# Tensor methods whose result is a Python value or metadata (a sync is
# flagged separately by HOST_SYNC).
_SCALAR_METHODS = {
    "item", "tolist", "dim", "size", "numel", "data_ptr", "element_size",
    "is_contiguous", "stride", "storage_offset", "get_device", "numpy",
    "nelement", "__len__",
}

_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}

# torch calls whose result is not a tensor.
_TORCH_NON_TENSOR = ("torch.device", "torch.Size", "torch.cuda.",
                     "torch.iinfo", "torch.finfo", "torch.get_",
                     "torch.is_", "torch.set_", "torch.no_grad",
                     "torch.inference_mode", "torch.manual_seed")


def _canonical_dtypes() -> Set[str]:
    from ..mergetree.constants import CANONICAL_DEVICE_DTYPES
    return set(CANONICAL_DEVICE_DTYPES)


# -- which names hold tensors --------------------------------------------


class _TensorNames:
    """Per device-path function: the names that hold tensors (or
    NamedTuples of tensors), from the parameters and the function's own
    assignments in source order, nested defs included."""

    def __init__(self, info: DeviceInfo):
        self.names: Set[str] = set(info.tensor_params())
        self.masks: Set[str] = set()
        assigns = [n for n in ast.walk(info.node)
                   if isinstance(n, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign))]
        assigns.sort(key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            value = node.value
            if value is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            tensor = self.is_tensor(value)
            mask = self.is_mask(value)
            for t in targets:
                for name in _target_names(t):
                    if tensor:
                        self.names.add(name)
                    if mask:
                        self.masks.add(name)

    def is_tensor(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Attribute):
            if expr.attr in _METADATA_ATTRS:
                return False
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Subscript):
            if isinstance(expr.value, ast.Attribute) and \
                    expr.value.attr == "shape":
                return False
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Call):
            fn = _dotted(expr.func)
            if fn.startswith("torch."):
                return not fn.startswith(_TORCH_NON_TENSOR)
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in _SCALAR_METHODS:
                    return False
                return self.is_tensor(expr.func.value)
            return False
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left) or self.is_tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False
            return any(self.is_tensor(x)
                       for x in [expr.left] + list(expr.comparators))
        if isinstance(expr, ast.IfExp):
            return self.is_tensor(expr.body) or self.is_tensor(expr.orelse)
        return False

    def is_mask(self, expr: ast.AST) -> bool:
        """A boolean tensor: a comparison of tensors, its negation or
        conjunction, a name bound to one, or a .bool() cast."""
        if isinstance(expr, ast.Name):
            return expr.id in self.masks
        if isinstance(expr, ast.Compare):
            return self.is_tensor(expr)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op,
                                                        ast.Invert):
            return self.is_mask(expr.operand)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(expr.left) or self.is_mask(expr.right)
        if isinstance(expr, ast.Call) and isinstance(expr.func,
                                                     ast.Attribute):
            if expr.func.attr == "bool" and not expr.args:
                return self.is_tensor(expr.func.value)
            if _dotted(expr.func).startswith("torch.logical_"):
                return True
        return False

    def truth_forces(self, test: ast.AST) -> bool:
        """Does Python truth-testing ``test`` read a tensor's value?"""
        if isinstance(test, ast.BoolOp):
            return any(self.truth_forces(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.truth_forces(test.operand)
        if isinstance(test, ast.Call) and _dotted(test.func) in (
                "isinstance", "len", "hasattr", "getattr", "callable",
                "bool", "int", "float", "any", "all"):
            return False  # bool()/int()/float() are HOST_SYNC's
        return self.is_tensor(test)


def _target_names(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            if isinstance(el, ast.Name):
                yield el.id


def _tensor_names(ctx: ModuleContext, info: DeviceInfo) -> _TensorNames:
    cache: Dict[int, _TensorNames] = ctx.__dict__.setdefault(
        "_torch_names", {})
    hit = cache.get(id(info.node))
    if hit is None:
        hit = cache[id(info.node)] = _TensorNames(info)
    return hit


def _device_nodes(ctx: ModuleContext, types) -> Iterator[
        Tuple[ast.AST, DeviceInfo]]:
    """(node, its device-path function) for every node of ``types``
    inside a device-path function of this module."""
    for fn, info in ctx.device_functions.items():
        for node in ast.walk(fn):
            if isinstance(node, types):
                yield node, info


# -- loops and kernel wrappers -------------------------------------------


# A range() bound that reads as a step count: a shape or size read, or a
# lower-case name like t_steps / steps / windows. A slot count (k,
# k_slots, a_slots) or an upper-case constant (RUN_K) bounds an unrolled
# slot loop, not a step axis.
_STEP_BOUND_RE = re.compile(r"(^|_)(t|steps|windows?)$")


def _step_loop(node: ast.AST) -> bool:
    """A loop over a step axis: ``while``, or ``for ... in range(...)``
    whose bound reads a shape or a step count."""
    if isinstance(node, ast.While):
        return True
    if not (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)
            and _dotted(node.iter.func) == "range"):
        return False
    for arg in node.iter.args:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Attribute) and sub.attr in ("shape",
                                                               "steps"):
                return True
            if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) and sub.func.attr == "size":
                return True
            name = sub.id if isinstance(sub, ast.Name) else (
                sub.attr if isinstance(sub, ast.Attribute) else None)
            if name is not None and name.islower() and \
                    _STEP_BOUND_RE.search(name):
                return True
    return False


def _in_step_loop(ctx: ModuleContext, node: ast.AST,
                  stop: ast.AST) -> Optional[ast.AST]:
    cur = ctx.parents.get(node)
    while cur is not None and cur is not stop:
        if _step_loop(cur) and node is not getattr(cur, "iter", None) \
                and node is not getattr(cur, "test", None):
            return cur
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return None  # a nested def runs when called, not per step
        cur = ctx.parents.get(cur)
    return None


def _is_kernel_wrapper(fn: ast.AST) -> bool:
    """A function that launches a kernel: it calls note_launch (every
    kernel wrapper of the port does, where it launches)."""
    return any(isinstance(n, ast.Call)
               and _dotted(n.func).rpartition(".")[2] == "note_launch"
               for n in ast.walk(fn))


def _host_syncs(ctx: ModuleContext):
    """(node, form, device info) for every host-sync form on the device
    path: the sync methods, torch.cuda.synchronize, and bool()/int()/
    float() of a tensor."""
    for node, info in _device_nodes(ctx, ast.Call):
        fn = _dotted(node.func)
        if fn in _SYNC_CALLS:
            yield node, f"{fn}()", info
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args:
            yield node, f".{node.func.attr}()", info
        elif isinstance(node.func, ast.Name) and \
                node.func.id in ("bool", "int", "float") and \
                len(node.args) == 1 and \
                _tensor_names(ctx, info).is_tensor(node.args[0]):
            yield node, f"{node.func.id}()", info


def _sync_context(ctx: ModuleContext, node: ast.AST,
                  info: DeviceInfo) -> Optional[str]:
    """Where a sync repeats: inside a step-axis loop, or inside a kernel
    wrapper's launch. None for a sync at the function's own level."""
    fn = ctx.parents.get(node)
    while fn is not None and not isinstance(
            fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        fn = ctx.parents.get(fn)
    if _in_step_loop(ctx, node, info.node) is not None:
        return "loop"
    if fn is not None and _is_kernel_wrapper(fn):
        return "wrapper"
    return None


@rule("HOST_SYNC",
      "Host synchronization (.item()/.tolist()/.cpu()/.numpy()/bool()/"
      "int()/float() of a tensor, torch.cuda.synchronize) on the device "
      "path",
      family="torch",
      rationale="Reading a tensor's value on the host waits for every "
                "launch queued before it: a device-path function that "
                "syncs serializes the host on the card once per call, "
                "which is the round trip the fused serving ring exists "
                "to remove. Keep the value on the device (torch.where, "
                "a reduction into the flat16 plane) or read it at the "
                "ring's boundary.")
def host_sync(ctx: ModuleContext) -> Iterator[Violation]:
    for node, form, info in _host_syncs(ctx):
        if _sync_context(ctx, node, info) is not None:
            continue  # SCAN_HOST_CALLBACK's
        yield ctx.violation(
            "HOST_SYNC", node,
            f"`{form}` on the device path (`{info.node.name}`, reached "
            f"from {info.root}) waits for the device")


@rule("TRACED_BRANCH",
      "Python if/while on a tensor value, or boolean-mask indexing, on "
      "the device path",
      family="torch",
      rationale="Branching on a tensor reads its value on the host (a "
                "sync), and a boolean-mask index sizes its result by the "
                "mask's count (a sync too): either one stalls the "
                "launch queue. Use torch.where / a masked arithmetic "
                "select, and keep the branch on metadata (shape, device, "
                "dtype) or on flags.")
def traced_branch(ctx: ModuleContext) -> Iterator[Violation]:
    for node, info in _device_nodes(ctx, (ast.If, ast.While, ast.IfExp)):
        names = _tensor_names(ctx, info)
        if names.truth_forces(node.test):
            kind = {ast.While: "while", ast.If: "if"}.get(type(node),
                                                          "if-expression")
            yield ctx.violation(
                "TRACED_BRANCH", node,
                f"`{kind}` branches on a tensor value inside device-path "
                f"`{info.node.name}`; use torch.where or branch on "
                f"metadata")
    for node, info in _device_nodes(ctx, ast.Subscript):
        names = _tensor_names(ctx, info)
        if names.is_tensor(node.value) and names.is_mask(node.slice):
            yield ctx.violation(
                "TRACED_BRANCH", node,
                f"boolean-mask index inside device-path "
                f"`{info.node.name}` sizes its result on the host; use "
                f"torch.where or an index tensor")


def _launching_functions(program) -> Set[str]:
    """Device-path qualnames whose body launches device work: a torch
    call, a kernel launch (note_launch), or a call of another such
    function (to a fixpoint). Cached on the program."""
    hit = getattr(program, "_torch_launching", None)
    if hit is not None:
        return hit
    reached = program.device_path()
    decls = {d.qualname: d for d in program.index.iter_functions()
             if d.qualname in reached}
    callees: Dict[str, Set[str]] = {}
    out: Set[str] = set()
    for q, d in decls.items():
        for n in ast.walk(d.node):
            if isinstance(n, ast.Call):
                fn = _dotted(n.func)
                if fn.startswith("torch.") or \
                        fn.rpartition(".")[2] == "note_launch":
                    out.add(q)
                    break
    for module in {d.module for d in decls.values()}:
        for caller, callee in program.index.call_edges(module):
            callees.setdefault(caller, set()).add(callee)
    changed = True
    while changed:
        changed = False
        for q in decls:
            if q not in out and callees.get(q, set()) & out:
                out.add(q)
                changed = True
    program._torch_launching = out
    return out


def _launching_calls(ctx: ModuleContext, loop: ast.AST,
                     info: DeviceInfo):
    """Calls in ``loop`` that launch device work: torch calls, tensor
    methods, and calls of device-path functions that launch."""
    from .callgraph import module_name_for_path
    from .lifecycle_rules import _program_for
    program = _program_for(ctx)
    launching = _launching_functions(program)
    module = module_name_for_path(ctx.path)
    local_defs = {n.name: n for n in ast.walk(info.node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not info.node}
    class_name = info.qualname.rpartition(":")[2].rpartition(".")[0] or None
    names = _tensor_names(ctx, info)
    for sub in ast.walk(loop):
        if not isinstance(sub, ast.Call):
            continue
        if _dotted(sub.func).startswith("torch.") or names.is_tensor(sub):
            yield sub
            continue
        if isinstance(sub.func, ast.Name) and sub.func.id in local_defs:
            if any(isinstance(n, ast.Call) and (
                    _dotted(n.func).startswith("torch."))
                   for n in ast.walk(local_defs[sub.func.id])):
                yield sub
            continue
        res = program.index.resolve_call(module, sub,
                                         class_name=class_name)
        if res is not None and res.qualname in launching:
            yield sub


@rule("RETRACE_HAZARD",
      "Launching calls inside a Python loop over a step axis on the "
      "device path",
      family="torch",
      rationale="A Python loop over steps issues the loop body's "
                "launches once per step: the launch count (and the "
                "host's launch time) scales with the trip count, the "
                "many-small-launches pattern. Fold the steps into one "
                "kernel that loops on the device, or suppress where the "
                "loop is a deliberate bound (the K windows of a ring, "
                "the dp shards of a mesh).")
def retrace_hazard(ctx: ModuleContext) -> Iterator[Violation]:
    for node, info in _device_nodes(ctx, (ast.For, ast.While)):
        if not _step_loop(node):
            continue
        calls = list(_launching_calls(ctx, node, info))
        if calls:
            yield ctx.violation(
                "RETRACE_HAZARD", node,
                f"Python loop over a step axis inside device-path "
                f"`{info.node.name}` issues {len(calls)} launching "
                f"call(s) per step; fold the steps into one launch")


@rule("SCAN_HOST_CALLBACK",
      "Host sync inside a step-axis loop or a kernel wrapper's launch on "
      "the device path",
      family="torch",
      rationale="A sync inside a step loop waits for the device once per "
                "step, and one inside a kernel wrapper once per launch: "
                "either serializes the queue that the ring keeps full. "
                "Move the read to the loop's or the ring's boundary, or "
                "keep the value on the device.")
def scan_host_callback(ctx: ModuleContext) -> Iterator[Violation]:
    for node, form, info in _host_syncs(ctx):
        where = _sync_context(ctx, node, info)
        if where is None:
            continue
        what = ("a step-axis loop: every step waits for the device"
                if where == "loop" else
                "a kernel wrapper: every launch waits for the device")
        yield ctx.violation(
            "SCAN_HOST_CALLBACK", node,
            f"`{form}` inside {what} (`{info.node.name}`)")


def _module_mutable_globals(ctx: ModuleContext) -> Set[str]:
    out: Set[str] = set()
    for stmt in ctx.tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp,
                                     ast.SetComp))
        if isinstance(value, ast.Call) and _dotted(value.func) in (
                "list", "dict", "set", "collections.defaultdict",
                "defaultdict", "collections.deque", "deque", "bytearray"):
            mutable = True
        if mutable:
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


@rule("MUTABLE_CAPTURE",
      "Device-path function reads a module-level mutable (list/dict/set) "
      "global",
      family="torch",
      rationale="Module state that the device path reads is shared by "
                "every caller in the process: a mutation from one "
                "serving lane (or one test) changes what another's "
                "launches compute. Pass the data as an argument or "
                "freeze it into a tuple/constant.")
def mutable_capture(ctx: ModuleContext) -> Iterator[Violation]:
    mutables = _module_mutable_globals(ctx)
    if not mutables:
        return
    for fn in ctx.device_nodes():
        local: Set[str] = {a.arg for a in fn.args.args}
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                local.add(sub.id)
        seen: Set[str] = set()
        for sub in ast.walk(fn):
            if (isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
                    and sub.id in mutables and sub.id not in local
                    and sub.id not in seen):
                seen.add(sub.id)
                yield ctx.violation(
                    "MUTABLE_CAPTURE", sub,
                    f"device-path `{fn.name}` reads module-level mutable "
                    f"global `{sub.id}`")


@rule("DTYPE_DRIFT",
      "Device dtype literal outside CANONICAL_DEVICE_DTYPES "
      "(mergetree/constants.py)",
      family="torch",
      rationale="The device schema is int32 columns, bool masks and "
                "int64 index tensors (CANONICAL_DEVICE_DTYPES); a stray "
                "float or narrow literal silently changes a column's "
                "bytes or its arithmetic. Deliberate narrow packing "
                "(the int16 wire) carries an inline suppression.")
def dtype_drift(ctx: ModuleContext) -> Iterator[Violation]:
    canonical = _canonical_dtypes()
    for node, info in _device_nodes(ctx, ast.Attribute):
        if not DTYPE_NAME_RE.match(node.attr):
            continue
        head = _dotted(node.value)
        if head not in _ARRAY_MODULES:
            continue
        name = _DTYPE_ALIASES.get(node.attr, node.attr)
        if head != "torch" and node.attr == "int":
            continue  # np.int is no dtype literal of the device
        if name in canonical:
            continue
        yield ctx.violation(
            "DTYPE_DRIFT", node,
            f"dtype `{head}.{node.attr}` in device-path "
            f"`{info.node.name}` drifts from the canonical device dtypes "
            f"({', '.join(sorted(canonical))})")


# The name shapes of a state-threading step, as JAX's rule reads them.
_STEP_NAME_RE = re.compile(r"(^|_)(step|apply|serve|window)",
                           re.IGNORECASE)
_STATE_PARAM_RE = re.compile(r"(state|pool)s?$")
_COPY_TAILS = {"clone", "_copy_pool", "deepcopy", "copy"}


def _state_copies(fn: ast.AST):
    """(node, param) for every copy of a state-named parameter:
    ``p.clone()``, ``clone(p)``, ``_copy_pool(p)``, ``copy(p)``."""
    params = {a.arg for a in fn.args.args if _STATE_PARAM_RE.search(a.arg)}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        tail = _dotted(node.func).rpartition(".")[2] or (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if tail not in _COPY_TAILS:
            continue
        subjects = list(node.args)
        if isinstance(node.func, ast.Attribute) and not node.args:
            subjects = [node.func.value]
        for s in subjects:
            if isinstance(s, ast.Name) and s.id in params:
                yield node, s.id


@rule("MISSING_DONATE",
      "State-threading step on the device path copies its state where an "
      "in-place form exists",
      family="torch",
      rationale="A step that copies the state it threads holds two "
                "copies of every column it touches at peak: where the "
                "module declares an in-place form (IN_PLACE_ARGS), the "
                "step should write through it. A non-mutating twin kept "
                "for a retry path (the _keep forms) carries an inline "
                "suppression saying why.")
def missing_donate(ctx: ModuleContext) -> Iterator[Violation]:
    from .callgraph import module_name_for_path
    from .lifecycle_rules import _program_for
    program = _program_for(ctx)
    syms = program.index.modules.get(module_name_for_path(ctx.path))
    if syms is None or not syms.in_place:
        return
    for fn in ctx.device_nodes():
        if fn.name in syms.in_place or not _STEP_NAME_RE.search(fn.name):
            continue
        for node, param in _state_copies(fn):
            yield ctx.violation(
                "MISSING_DONATE", node,
                f"device-path `{fn.name}` copies `{param}` while this "
                f"module declares in-place forms "
                f"({', '.join(sorted(syms.in_place))}); the previous "
                f"state stays live across the step")
            break


# PAGE_ID_DTYPE lives in lifecycle_rules.py: a dtype lattice propagated
# by the dataflow pass (analysis/dataflow.py). SCAN scope below is shared
# with it: the op pipeline's device code.
_SCAN_SCOPE_PREFIXES = (
    "fluidframework_tpu_torch/mergetree", "fluidframework_tpu_torch/server",
    "<memory>")


def _scan_scope(ctx: ModuleContext) -> bool:
    path = ctx.path.replace("\\", "/")
    return any(path.startswith(p) or f"/{p}" in path
               for p in _SCAN_SCOPE_PREFIXES)
