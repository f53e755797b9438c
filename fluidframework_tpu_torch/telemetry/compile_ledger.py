"""The compile/dispatch observatory: a process-wide compile ledger (a
port of fluidframework_tpu's telemetry/compile_ledger.py).

PyTorch has no jit cache, so a "compile" here is one of two things:

  * a new input signature at a probed symbol (counters.JitRetraceProbe:
    the shape and dtype of each tensor argument, and the structure) — the
    probe calls :func:`note_call` for every wrapped call, cold when the
    signature is new;
  * a build or load of the CUDA kernel library (kernels/build.py
    `library()`): one cold call per source under ``kernels/csrc/<name>``
    with the wall milliseconds of the build or load that produced the
    library (the sources compile in parallel, so each carries the same
    wall), and that wall once in the ``compile.backend_ms`` counter.

The ledger keeps, per symbol: compile count, cumulative compile
milliseconds (the wall of the cold calls), the warm-vs-cold call split,
and the occupancy (distinct signatures, where the watched callable
reports it through ``_cache_size()``). Call sites that must not wrap
their callable register it once with :func:`watch` and stamp each call
with :func:`note_call` or :func:`track`. :func:`bench_stamp` is the
compact form for a bench record.

JAX's ``install_jax_listener`` (jax.monitoring's backend-compile events)
has no counterpart: the port's backend compile is nvcc, which the build
records itself.

Stdlib only, like counters.py, so every layer can import it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from . import counters as _counters


class _Entry:
    __slots__ = ("name", "fn", "compiles", "retraces", "cold_calls",
                 "warm_calls", "compile_ms", "warm_ms", "cache_size",
                 "_last_size", "_seen_compile")

    def __init__(self, name: str, fn: Optional[Callable]):
        self.name = name
        self.fn = fn
        self.compiles = 0
        self.retraces = 0
        self.cold_calls = 0
        self.warm_calls = 0
        self.compile_ms = 0.0
        self.warm_ms = 0.0
        self.cache_size = -1
        self._last_size: Optional[int] = None
        self._seen_compile = False


def _cache_size(fn) -> int:
    size = getattr(fn, "_cache_size", None)
    if size is None:
        return -1  # the callable reports no occupancy
    try:
        return int(size())
    except (TypeError, ValueError):
        return -1


class CompileLedger:
    """Registry of watched symbols + their compile attribution."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}

    # -- registration -------------------------------------------------------
    def watch(self, name: str, fn: Optional[Callable] = None) -> str:
        """Register ``name`` (idempotent). ``fn`` — when it reports its
        occupancy through ``_cache_size()`` (a JitRetraceProbe does) —
        gives the ledger that occupancy; callers that count their own
        compiles report them via ``note_call(grew=...)``."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                self._entries[name] = entry = _Entry(name, fn)
                if fn is not None:
                    # Baseline at registration: compiles made earlier
                    # are not charged here, but the FIRST call through
                    # this site attributes its own compile.
                    size = _cache_size(fn)
                    if size >= 0:
                        entry._last_size = size
                        entry.cache_size = size
            elif fn is not None and entry.fn is None:
                entry.fn = fn
                size = _cache_size(fn)
                if size >= 0 and entry._last_size is None:
                    entry._last_size = size
                    entry.cache_size = size
            return name

    # -- attribution --------------------------------------------------------
    def note_call(self, name: str, dur_ms: float,
                  grew: Optional[int] = None) -> None:
        """Attribute one call of a watched symbol. ``grew`` — when the
        caller already counted its compiles (JitRetraceProbe, the kernel
        build) — is authoritative; otherwise the ledger diffs the watched
        callable's occupancy across calls. A call that compiled is COLD:
        its wall time lands in compile_ms, and compiles past the first
        count as retraces (a leaked signature on a shape-stable path)."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                self._entries[name] = entry = _Entry(name, None)
            if grew is None and entry.fn is not None:
                size = _cache_size(entry.fn)
                if size >= 0:
                    last = entry._last_size
                    grew = size - last if last is not None \
                        and size > last else 0
                    entry._last_size = size
                    entry.cache_size = size
            grew = int(grew or 0)
            if grew > 0:
                entry.compiles += grew
                entry.cold_calls += 1
                entry.compile_ms += dur_ms
                if entry._seen_compile:
                    entry.retraces += grew
                entry._seen_compile = True
            else:
                entry.warm_calls += 1
                entry.warm_ms += dur_ms

    def track(self, name: str, fn: Callable) -> "_Tracked":
        """Context manager for un-wrappable call sites::

            with ledger.track("kernel.compact_extract",
                              kernel.compact_extract_batched):
                out = kernel.compact_extract_batched(...)
        """
        self.watch(name, fn)
        return _Tracked(self, name)

    # -- views --------------------------------------------------------------
    def snapshot(self) -> dict:
        """{"symbols": {name: {...}}, "totals": {...}} — the /health and
        bench view. Occupancy refreshes lazily here for watched
        callables that have not been stamped since their cache last
        grew (a /health read must not under-report)."""
        with self._lock:
            symbols: Dict[str, dict] = {}
            tot_compiles = tot_retraces = 0
            tot_compile_ms = 0.0
            tot_cold = tot_warm = 0
            for name, e in sorted(self._entries.items()):
                if e.fn is not None:
                    size = _cache_size(e.fn)
                    if size >= 0:
                        e.cache_size = size
                symbols[name] = {
                    "compiles": e.compiles,
                    "retraces": e.retraces,
                    "coldCalls": e.cold_calls,
                    "warmCalls": e.warm_calls,
                    "compileMs": round(e.compile_ms, 3),
                    "warmMs": round(e.warm_ms, 3),
                    "cacheSize": e.cache_size,
                }
                tot_compiles += e.compiles
                tot_retraces += e.retraces
                tot_compile_ms += e.compile_ms
                tot_cold += e.cold_calls
                tot_warm += e.warm_calls
        return {
            "symbols": symbols,
            "totals": {
                "compiles": tot_compiles,
                "retraces": tot_retraces,
                "compileMs": round(tot_compile_ms, 3),
                "coldCalls": tot_cold,
                "warmCalls": tot_warm,
                "backendCompileMs": round(
                    _counters.get("compile.backend_ms"), 3),
            },
        }

    def bench_stamp(self) -> dict:
        """The bench-record form: per-symbol {compiles, compileMs,
        cacheSize} + totals — compact enough to ride every record, rich
        enough that a warm-up bug (compiles observed inside a measured
        region) is machine-visible instead of re-diagnosed."""
        snap = self.snapshot()
        return {
            "total_compiles": snap["totals"]["compiles"],
            "total_compile_ms": snap["totals"]["compileMs"],
            "retraces": snap["totals"]["retraces"],
            "symbols": {
                name: {"compiles": s["compiles"],
                       "compile_ms": s["compileMs"],
                       "cache_size": s["cacheSize"]}
                for name, s in snap["symbols"].items()},
        }

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._entries.clear()


class _Tracked:
    __slots__ = ("_ledger", "_name", "_t0")

    def __init__(self, ledger: CompileLedger, name: str):
        self._ledger = ledger
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_Tracked":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *_exc) -> None:
        self._ledger.note_call(
            self._name, (time.perf_counter() - self._t0) * 1000.0)


ledger = CompileLedger()
