"""Runtime lockset verification: fluidlint's dynamic half (counterpart
of fluidframework_tpu's testing/lockcheck.py).

The port's static race detector (analysis/concurrency_model.py) PROVES
the lock discipline it can see and TRUSTS the annotations it cannot
(``# fluidlint: guarded-by=…``, the ``disable``d racy-by-design probes).
This module closes the loop: a debug-mode monkey-wrap asserts the
statically inferred (or explicitly declared) locksets while the real
code runs under the soak suites and on the card, so the model and the
code cannot silently drift apart.

Usage::

    from fluidframework_tpu_torch.testing.lockcheck import instrument

    check = instrument(store, {"_deferred_frees": "_guard_lock",
                               "_extract_guards": "_guard_lock"})
    ...  # drive the store, including its worker threads
    check.assert_clean()   # raises listing every unguarded access
    check.uninstrument()

``instrument`` wraps the named lock attributes in ownership-tracking
proxies (``acquire``/``release``/``with`` all count, per thread,
re-entrantly) and patches the class's ``__getattribute__``/
``__setattr__`` so every touch of a guarded attribute checks that the
declared lock is held by the touching thread. Violations are recorded
(or raised immediately with ``strict=True``) with the offending
attribute, thread, and call site.

``static_guards(cls)`` derives the guard map from the port's
single-module concurrency model, so a test can assert exactly what
fluidlint inferred. Everything here is import-cheap and debug-only:
production code never imports this module.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Type

_GUARDS_SLOT = "_lockcheck_registry"
_PATCHED: Dict[type, dict] = {}  # class -> {orig get/set, refcount}


class LockDisciplineError(AssertionError):
    """Raised by strict mode / assert_clean on an unguarded access."""


@dataclass
class Violation:
    cls: str
    attr: str
    lock: str
    op: str        # "get" | "set"
    thread: str
    site: str      # "file.py:123 in caller"

    def render(self) -> str:
        return (f"{self.cls}.{self.attr} {self.op} on thread "
                f"{self.thread} without holding {self.lock} ({self.site})")


class TrackedLock:
    """Ownership-tracking proxy over a Lock/RLock/Condition: records
    which threads currently hold it (re-entrantly) while delegating the
    actual blocking to the wrapped primitive."""

    def __init__(self, inner):
        self._inner = inner
        self._holds: Dict[int, int] = {}
        self._meta = threading.Lock()

    # -- the lock protocol -------------------------------------------------
    def acquire(self, *args, **kwargs) -> bool:
        ok = self._inner.acquire(*args, **kwargs)
        if ok:
            self._note(+1)
        return ok

    def release(self) -> None:
        self._note(-1)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _note(self, delta: int) -> None:
        ident = threading.get_ident()
        with self._meta:
            n = self._holds.get(ident, 0) + delta
            if n <= 0:
                self._holds.pop(ident, None)
            else:
                self._holds[ident] = n

    def held_by_current_thread(self) -> bool:
        return self._holds.get(threading.get_ident(), 0) > 0

    # Condition passthrough (wait/notify keep working when a Condition
    # is wrapped; ownership still tracks through acquire/release).
    def __getattr__(self, name):
        return getattr(self._inner, name)


class LockCheck:
    """One instrumented instance's registry: guard map, wrapped locks,
    recorded violations."""

    def __init__(self, obj, guards: Dict[str, str], strict: bool):
        self.obj = obj
        self.guards = dict(guards)
        self.strict = strict
        self.violations: List[Violation] = []
        self._checking = threading.local()
        self._locks: Dict[str, TrackedLock] = {}
        for lock_attr in sorted(set(guards.values())):
            inner = object.__getattribute__(obj, lock_attr)
            tracked = inner if isinstance(inner, TrackedLock) \
                else TrackedLock(inner)
            object.__setattr__(obj, lock_attr, tracked)
            self._locks[lock_attr] = tracked

    # -- the check ---------------------------------------------------------
    def check(self, attr: str, op: str) -> None:
        if getattr(self._checking, "active", False):
            return  # re-entrant introspection during recording
        lock_attr = self.guards[attr]
        tracked = self._locks[lock_attr]
        if tracked.held_by_current_thread():
            return
        self._checking.active = True
        try:
            site = "<unknown>"
            # Last two frames are check() and the class wrapper; the
            # filename filter then lands on the ACCESSING frame itself
            # (not its caller) even if wrapper nesting changes.
            for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
                if frame.filename != __file__:
                    site = (f"{frame.filename.rsplit('/', 1)[-1]}:"
                            f"{frame.lineno} in {frame.name}")
                    break
            v = Violation(cls=type(self.obj).__name__, attr=attr,
                          lock=lock_attr, op=op,
                          thread=threading.current_thread().name,
                          site=site)
            self.violations.append(v)
        finally:
            self._checking.active = False
        if self.strict:
            raise LockDisciplineError(v.render())

    # -- results -----------------------------------------------------------
    def assert_clean(self) -> None:
        if self.violations:
            lines = "\n  ".join(v.render() for v in self.violations)
            raise LockDisciplineError(
                f"{len(self.violations)} unguarded access(es):\n  {lines}")

    def uninstrument(self) -> None:
        """Restore the instance's plain locks and drop this instance
        from the class patch (the class unpatches with the last one)."""
        for lock_attr, tracked in self._locks.items():
            object.__setattr__(self.obj, lock_attr, tracked._inner)
        d = object.__getattribute__(self.obj, "__dict__")
        d.pop(_GUARDS_SLOT, None)
        _unpatch_class(type(self.obj))


def instrument(obj, guards: Optional[Dict[str, str]] = None, *,
               strict: bool = False) -> LockCheck:
    """Wrap ``obj`` so every access to a guarded attribute asserts its
    declared lock is held by the accessing thread.

    ``guards`` maps attribute name -> lock attribute name; omit it to
    use ``static_guards(type(obj))`` — the locksets fluidlint inferred.
    ``strict=True`` raises at the first violation instead of recording.
    """
    if guards is None:
        guards = static_guards(type(obj))
    if not guards:
        raise ValueError(
            f"no guards given and none inferred for {type(obj).__name__}")
    check = LockCheck(obj, guards, strict)
    object.__getattribute__(obj, "__dict__")[_GUARDS_SLOT] = check
    _patch_class(type(obj))
    return check


# -- class patching ----------------------------------------------------------


def _patch_class(cls: type) -> None:
    entry = _PATCHED.get(cls)
    if entry is not None:
        entry["refs"] += 1
        return
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__

    def checked_getattribute(self, name):
        if name != "__dict__":
            d = object.__getattribute__(self, "__dict__")
            reg = d.get(_GUARDS_SLOT)
            if reg is not None and name in reg.guards:
                reg.check(name, "get")
        return orig_get(self, name)

    def checked_setattr(self, name, value):
        d = object.__getattribute__(self, "__dict__")
        reg = d.get(_GUARDS_SLOT)
        if reg is not None and name in reg.guards:
            reg.check(name, "set")
        return orig_set(self, name, value)

    cls.__getattribute__ = checked_getattribute  # type: ignore[assignment]
    cls.__setattr__ = checked_setattr            # type: ignore[assignment]
    _PATCHED[cls] = {"get": orig_get, "set": orig_set, "refs": 1}


def _unpatch_class(cls: type) -> None:
    entry = _PATCHED.get(cls)
    if entry is None:
        return
    entry["refs"] -= 1
    if entry["refs"] <= 0:
        cls.__getattribute__ = entry["get"]  # type: ignore[assignment]
        cls.__setattr__ = entry["set"]       # type: ignore[assignment]
        del _PATCHED[cls]


# -- static-model bridge ------------------------------------------------------


_STATIC_GUARDS_CACHE: Dict[type, Dict[str, str]] = {}


def static_guards(cls: Type) -> Dict[str, str]:
    """attr -> lock-attr guard map fluidlint infers for ``cls`` from
    its defining module (single-module concurrency model): the shared
    attributes whose lockset intersection is exactly one same-class
    lock. The runtime wrap then asserts precisely what the static pass
    proved: drift in either direction fails a test. Memoized per class:
    the soak suites instrument per trial, and the model build (about a
    second for the sequencer module) is invariant within a process."""
    cached = _STATIC_GUARDS_CACHE.get(cls)
    if cached is not None:
        return dict(cached)
    import ast
    import inspect

    from ..analysis.callgraph import module_name_for_path
    from ..analysis.engine import ModuleContext, ProgramContext, _rel_path
    from pathlib import Path

    src_file = inspect.getsourcefile(cls)
    if src_file is None:  # pragma: no cover - C extension class
        return {}
    rel = _rel_path(Path(src_file))
    source = Path(src_file).read_text()
    ctx = ModuleContext(rel, source, ast.parse(source))
    model = ProgramContext([ctx]).concurrency()
    guards = model.inferred_guards(
        f"{module_name_for_path(rel)}:{cls.__name__}")
    _STATIC_GUARDS_CACHE[cls] = dict(guards)
    return guards
