"""CC* rules: server concurrency and robustness (counterpart of
fluidframework_tpu's analysis/concurrency_rules.py: the same ids,
heuristics and messages, scoped to the port's tiers).

These run over the whole tree but are written against the failure modes
of the server/ and loader/ pipelines: a swallowed exception in a lambda
op path loses ops silently, a blocking call in async code stalls every
document sharing the loop, and a listener registered without a removal
path pins a document's worth of state for the process lifetime.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .engine import ModuleContext, Violation, _dotted
from .registry import rule


def _lockish(expr: ast.AST) -> bool:
    """Does this context-manager expression look like a lock? Matches
    bare names/attributes containing 'lock'/'mutex'/'sem' and calls on
    them (e.g. ``self._lock``, ``lock.acquire()``)."""
    target = expr
    if isinstance(target, ast.Call):
        target = target.func
    dotted = _dotted(target).lower()
    last = dotted.rsplit(".", 1)[-1].lstrip("_")
    return any(tok in last for tok in ("lock", "mutex", "semaphore"))


@rule("AWAIT_IN_LOCK",
      "await while holding a lock",
      family="concurrency",
      rationale="Awaiting under a held lock serializes every coroutine "
                "behind the slowest holder — and deadlocks outright when "
                "the awaited task needs the same lock. Narrow the critical "
                "section to the state mutation; await outside it.")
def await_in_lock(ctx: ModuleContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_lockish(item.context_expr) for item in node.items):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Await):
                yield ctx.violation(
                    "AWAIT_IN_LOCK", sub,
                    "await while holding a lock: the lock is held across "
                    "the suspension point")


_BLOCKING_CALLS = {
    "time.sleep": "time.sleep blocks the event loop; use asyncio.sleep",
    "open": "sync file IO blocks the event loop; read via a thread "
            "(asyncio.to_thread) or an async file API",
    "subprocess.run": "subprocess.run blocks the event loop; use "
                      "asyncio.create_subprocess_exec",
    "subprocess.check_output": "blocking subprocess call in async code",
    "subprocess.call": "blocking subprocess call in async code",
    "socket.create_connection": "blocking connect in async code",
}


@rule("BLOCKING_IN_ASYNC",
      "Blocking call (time.sleep / sync IO / subprocess) inside async def",
      family="concurrency",
      rationale="One blocking call inside a coroutine stalls the whole "
                "event loop — every other document's pipeline stops "
                "making progress until it returns.")
def blocking_in_async(ctx: ModuleContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = _dotted(sub.func)
                if fn in _BLOCKING_CALLS:
                    yield ctx.violation(
                        "BLOCKING_IN_ASYNC", sub,
                        f"`{fn}` inside `async def {node.name}`: "
                        f"{_BLOCKING_CALLS[fn]}")


_BROAD = ("Exception", "BaseException")


def _broad_types(type_node: Optional[ast.AST]) -> bool:
    if type_node is None:  # bare except
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_broad_types(el) for el in type_node.elts)
    return _dotted(type_node).rsplit(".", 1)[-1] in _BROAD


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    """Silent = no raise, no call, and the bound exception (if any) is
    never read — nothing observes the failure."""
    for stmt in handler.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.Raise, ast.Call)):
                return False
            if (handler.name and isinstance(sub, ast.Name)
                    and sub.id == handler.name
                    and isinstance(sub.ctx, ast.Load)):
                return False
    return True


@rule("SWALLOWED_EXCEPTION",
      "Broad except (bare / Exception / BaseException) that silently "
      "drops the error",
      family="concurrency",
      rationale="On an op-pipeline path a silent drop loses ops with no "
                "forensic trail (the class of bug behind the alfred/"
                "historian route-reply handlers). Narrow the type, or at "
                "minimum count the swallow via telemetry.counters so "
                "/healthz exposes the rate.")
def swallowed_exception(ctx: ModuleContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _broad_types(node.type):
            continue
        if not _handler_is_silent(node):
            continue
        shown = "bare except" if node.type is None else \
            f"except {ast.unparse(node.type)}"
        yield ctx.violation(
            "SWALLOWED_EXCEPTION", node,
            f"`{shown}` swallows the error with no raise, log, or "
            f"counter; narrow the type or record the swallow "
            f"(telemetry.counters.record_swallow)")


_REGISTER_NAMES = {"on", "subscribe", "add_listener", "add_handler",
                   "register_listener"}
_REMOVE_NAMES = {"off", "unsubscribe", "remove_listener", "remove_handler",
                 "unregister_listener", "remove_all_listeners", "dispose"}


@rule("LISTENER_LEAK",
      "Class registers event listeners but offers no removal path",
      family="concurrency",
      rationale="A subscribe/on API without unsubscribe/off pins every "
                "registered closure (and whatever document state it "
                "captures) for the lifetime of the emitter — the "
                "long-lived-server leak class.")
def listener_leak(ctx: ModuleContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {m.name: m for m in node.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        registers = [m for name, m in methods.items()
                     if name in _REGISTER_NAMES]
        if not registers:
            continue
        if any(name in _REMOVE_NAMES for name in methods):
            continue
        for m in registers:
            yield ctx.violation(
                "LISTENER_LEAK", m,
                f"`{node.name}.{m.name}` registers listeners but "
                f"`{node.name}` has no removal path "
                f"({'/'.join(sorted(_REMOVE_NAMES))})")


_SPAN_PRODUCERS = {"span", "start_span"}

# Span discipline is enforced where spans matter operationally: the op
# pipeline (client engine, drivers, server stages, telemetry itself).
# The server prefix deliberately covers the WHOLE tier — including the
# read path (server/readpath.py), the lambdas (broadcaster shard
# workers), and the paged rescue path in tpu_sequencer.py, which all
# carry spans as of the observability catch-up (docs/observability.md
# v2) — so a span added anywhere on the serving tier is born under the
# leak rule. "<memory>" keeps the fixture tests in scope.
_SPAN_SCOPE_PREFIXES = (
    "fluidframework_tpu_torch/mergetree", "fluidframework_tpu_torch/loader",
    "fluidframework_tpu_torch/server", "fluidframework_tpu_torch/telemetry",
    "<memory>")


def _span_scope(ctx: ModuleContext) -> bool:
    path = ctx.path.replace("\\", "/")
    return any(path.startswith(p) or f"/{p}" in path
               for p in _SPAN_SCOPE_PREFIXES)


def _enclosing_scope(ctx: ModuleContext, node: ast.AST) -> ast.AST:
    cur = ctx.parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
        cur = ctx.parents.get(cur)
    return cur if cur is not None else ctx.tree


def _span_end_calls(scope: ast.AST, name: str):
    for sub in ast.walk(scope):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("end", "cancel")
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id == name):
            yield sub


def _assign_block(ctx: ModuleContext, assign: ast.AST):
    """The statement list the assignment sits in, plus its index."""
    owner = ctx.parents.get(assign)
    if owner is None:
        return None, -1
    for field in ("body", "orelse", "finalbody"):
        block = getattr(owner, field, None)
        if isinstance(block, list) and assign in block:
            return block, block.index(assign)
    return None, -1


def _covered_by_finally(ctx: ModuleContext, scope: ast.AST,
                        assign: ast.AST, call: ast.Call) -> bool:
    """True when `call` (an end/cancel) sits in a Try's finalbody AND
    that Try actually protects the code after the span start: the start
    is inside the try body, or the Try is the statement IMMEDIATELY
    after the start in the same block. A finally elsewhere in the
    function proves nothing — an exception raised between the start and
    that try still leaks the span."""
    block, idx = _assign_block(ctx, assign)
    for t in ast.walk(scope):
        if not isinstance(t, ast.Try) or not t.finalbody:
            continue
        if not any(sub is call for stmt in t.finalbody
                   for sub in ast.walk(stmt)):
            continue
        if any(sub is assign for stmt in t.body
               for sub in ast.walk(stmt)):
            return True
        if block is not None and idx + 1 < len(block) \
                and block[idx + 1] is t:
            return True
    return False


@rule("SPAN_LEAK",
      "Span started without context-manager or try/finally end() "
      "protection",
      family="concurrency",
      rationale="A span whose end() sits in straight-line code never "
                "closes when anything between start and end raises — the "
                "trace shows a hole exactly where the failure happened, "
                "and an unsampled-slow span (the always-sample-on-slow "
                "policy's quarry) is lost entirely. Use `with "
                "tracing.span(...)` or end in a finally block.")
def span_leak(ctx: ModuleContext) -> Iterator[Violation]:
    if not _span_scope(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        if not isinstance(call, ast.Call):
            continue
        if _dotted(call.func).rsplit(".", 1)[-1] not in _SPAN_PRODUCERS:
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not names:
            continue
        name = names[0]
        scope = _enclosing_scope(ctx, node)
        ends = list(_span_end_calls(scope, name))
        if not ends:
            yield ctx.violation(
                "SPAN_LEAK", node,
                f"span `{name}` is started but never end()ed in this "
                f"scope; use `with` or end it in a finally block")
        elif not any(_covered_by_finally(ctx, scope, node, e)
                     for e in ends):
            yield ctx.violation(
                "SPAN_LEAK", node,
                f"span `{name}` can exit without end(): no finally "
                f"block that COVERS the span start ends it — an "
                f"exception between start and end leaks the span; use "
                f"`with` or a try/finally around the started region")


def _mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    return (isinstance(node, ast.Call)
            and _dotted(node.func) in ("list", "dict", "set", "bytearray"))


@rule("MUTABLE_DEFAULT",
      "Mutable default argument",
      family="concurrency",
      rationale="Default values evaluate once at def time; a mutable one "
                "is shared across every call and every thread — state "
                "leaks between requests.")
def mutable_default(ctx: ModuleContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        defaults: List[ast.AST] = list(args.defaults) + [
            d for d in args.kw_defaults if d is not None]
        for d in defaults:
            if _mutable_default(d):
                yield ctx.violation(
                    "MUTABLE_DEFAULT", d,
                    f"mutable default argument in `{node.name}`; use "
                    f"None and create inside the body")


# Queue discipline is enforced where unbounded growth turns overload
# into OOM: the server pipeline. "<memory>" keeps fixture tests in
# scope. (Client-side pending queues are the DRIVER's flow-control
# problem and resubmit on reconnect; flagging them would be noise.)
_QUEUE_SCOPE_PREFIXES = ("fluidframework_tpu_torch/server", "<memory>")

# Attribute names that read as ingest/backlog containers. Deliberately
# narrow: the rule's contract is "a thing named like a queue must show
# its bound", not "every list is suspect".
_QUEUE_NAME_TOKENS = ("queue", "backlog", "pending", "inbox", "mailbox",
                      "held", "unacked", "buffer")

_GROWTH_METHODS = {"append", "appendleft", "extend", "extendleft",
                   "insert"}


def _queue_scope(ctx: ModuleContext) -> bool:
    path = ctx.path.replace("\\", "/")
    return any(path.startswith(p) or f"/{p}" in path
               for p in _QUEUE_SCOPE_PREFIXES)


def _queueish(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _QUEUE_NAME_TOKENS)


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.NAME` -> NAME (plain attribute on self only)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _unbounded_container_init(value: ast.AST) -> bool:
    """[] / list() / dict-of-lists factories aside, a deque() WITHOUT
    maxlen. A deque(maxlen=...) is the bounded idiom and never fires."""
    if isinstance(value, ast.List):
        return True
    if isinstance(value, ast.Call):
        fn = _dotted(value.func).rsplit(".", 1)[-1]
        if fn == "list" and not value.args:
            return True
        if fn == "deque":
            return not any(kw.arg == "maxlen" for kw in value.keywords)
    return False


def _bound_evidence(cls: ast.ClassDef, attr: str) -> bool:
    """Anything in the class that reads as a bound on self.<attr>:
    a len(self.<attr>) comparison (the admission/limit-check idiom), a
    slicing trim (`self.x = self.x[-n:]` / `del self.x[:n]`), or a
    `.clear()` (swap-and-drain pattern)."""
    for node in ast.walk(cls):
        if isinstance(node, ast.Compare):
            for side in [node.left] + list(node.comparators):
                if (isinstance(side, ast.Call)
                        and _dotted(side.func) == "len" and side.args
                        and _self_attr(side.args[0]) == attr):
                    return True
        if isinstance(node, ast.Assign):
            if (any(_self_attr(t) == attr for t in node.targets)
                    and isinstance(node.value, ast.Subscript)
                    and _self_attr(node.value.value) == attr):
                return True
        if isinstance(node, ast.Delete):
            for target in node.targets:
                if (isinstance(target, ast.Subscript)
                        and _self_attr(target.value) == attr):
                    return True
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "clear"
                    and _self_attr(node.func.value) == attr):
                return True
    return False


@rule("UNBOUNDED_QUEUE",
      "Server-module queue grows without a maxlen, bound check, or trim",
      family="concurrency",
      rationale="An ingest/backlog container with no visible bound turns "
                "overload into OOM: the process dies instead of shedding. "
                "Bound it (deque maxlen), check len() against a limit "
                "before growing (the admission idiom — see "
                "docs/overload.md), or trim after. Consumption alone is "
                "not a bound: a pump that drains slower than producers "
                "fill still grows forever.")
def unbounded_queue(ctx: ModuleContext) -> Iterator[Violation]:
    if not _queue_scope(ctx):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        unbounded: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    attr = _self_attr(target)
                    if (attr is not None and _queueish(attr)
                            and _unbounded_container_init(node.value)):
                        unbounded.add(attr)
        if not unbounded:
            continue
        flagged: Set[str] = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _GROWTH_METHODS):
                continue
            attr = _self_attr(node.func.value)
            if (attr is None or attr not in unbounded
                    or attr in flagged):
                continue
            if _bound_evidence(cls, attr):
                continue
            flagged.add(attr)
            yield ctx.violation(
                "UNBOUNDED_QUEUE", node,
                f"`self.{attr}` in `{cls.name}` grows via "
                f".{node.func.attr}() with no visible bound (no deque "
                f"maxlen, no len() limit check, no trim): overload must "
                f"hit admission control, not RAM")
