"""Process-wide named counters, stage latency histograms and the input
signature probe (a copy of fluidframework_tpu's telemetry/counters.py,
with `JitRetraceProbe` given the one meaning it can have without a jit
cache: see its docstring).

Wherever a broad exception handler deliberately swallows an error on an
op-pipeline path, it calls ``record_swallow(site)`` so the drop is
visible as a rate instead of silence. Stdlib only, so every layer can
import it without cycles.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_lock = threading.Lock()
_counters: Dict[str, float] = {}

# -- cardinality guard -------------------------------------------------------
# /metrics.prom renders every counter name as a sample line, so a name
# minted per tenant/shard/document grows the exposition text
# monotonically under churn (the UNBOUNDED_QUEUE class, for metrics).
# Two bounds: `bounded()` caps each declared dynamic family at
# FAMILY_CAP distinct labels (overflow collapses into one
# `<family>.__other__` bucket), and a global name cap backstops any
# site that mints names directly — past it, new names collapse into
# their two-segment family's overflow bucket. Every collapse counts in
# telemetry.metrics_dropped so the condition is visible, not silent.

FAMILY_CAP = int(os.environ.get("FLUID_METRIC_FAMILY_CAP", "64"))
MAX_COUNTER_NAMES = int(os.environ.get("FLUID_METRIC_NAME_CAP", "4096"))
OVERFLOW_LABEL = "__other__"
_families: Dict[str, set] = {}


def _guarded_name(name: str) -> str:
    """Global-cap backstop; call with _lock held."""
    if name in _counters or name == "telemetry.metrics_dropped" \
            or len(_counters) < MAX_COUNTER_NAMES:
        return name
    _counters["telemetry.metrics_dropped"] = \
        _counters.get("telemetry.metrics_dropped", 0.0) + 1.0
    family = ".".join(name.split(".")[:2])
    return f"{family}.{OVERFLOW_LABEL}"


def bounded(family: str, label) -> str:
    """The bounded name for a dynamic-label counter family: the first
    FAMILY_CAP distinct labels get their own `<family>.<label>` name;
    later labels share `<family>.__other__` (and count a drop). Use for
    any per-tenant / per-shard / per-document metric."""
    label = str(label)
    with _lock:
        seen = _families.setdefault(family, set())
        if label in seen:
            return f"{family}.{label}"
        if len(seen) < FAMILY_CAP:
            seen.add(label)
            return f"{family}.{label}"
        _counters["telemetry.metrics_dropped"] = \
            _counters.get("telemetry.metrics_dropped", 0.0) + 1.0
    return f"{family}.{OVERFLOW_LABEL}"


def increment(name: str, by: float = 1.0) -> float:
    with _lock:
        name = _guarded_name(name)
        _counters[name] = value = _counters.get(name, 0.0) + by
        return value


def gauge(name: str, value: float) -> None:
    """Set an absolute reading (probe outputs like decay_probe's
    per-wave rate — the LAST observation is the signal, not a sum)."""
    with _lock:
        _counters[_guarded_name(name)] = float(value)


def get(name: str) -> float:
    with _lock:
        return _counters.get(name, 0.0)


def snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


# -- latency histograms ------------------------------------------------------
# Per-stage latency distributions (the serving flush's named sub-spans,
# historian reads, ...): a rolling sample window for percentile/SLO math
# plus cumulative Prometheus-style buckets (with the last trace id seen
# per bucket as an exemplar) for /metrics.prom exposition.

LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 10000.0, math.inf)

LATENCY_WINDOW = 512


class _Hist:
    __slots__ = ("samples", "bucket_counts", "exemplars", "total", "count")

    def __init__(self):
        self.samples: List[float] = []      # rolling window
        self.bucket_counts = [0] * len(LATENCY_BUCKETS_MS)  # non-cumulative
        self.exemplars: List[Optional[Tuple[str, float]]] = \
            [None] * len(LATENCY_BUCKETS_MS)
        self.total = 0.0                    # cumulative sum (ms)
        self.count = 0


_hists: Dict[str, _Hist] = {}


def nearest_rank(ordered: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over an ASCENDING-sorted sample window:
    the ceil(p*N)-th smallest value (p in (0, 1]). Shared by
    MetricClient.snapshot and the SLO evaluation so both quote the same
    number for the same window — and exact at tiny N (p50 of [1, 2] is
    1, the lower median; p99 of a 100-sample window is the 99th value,
    not the max)."""
    if not ordered:
        return 0.0
    idx = max(0, math.ceil(p * len(ordered)) - 1)
    return ordered[min(idx, len(ordered) - 1)]


def observe(name: str, ms: float,
            trace_id: Optional[str] = None) -> None:
    """Record one latency sample for stage ``name``."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = _Hist()
        h.samples.append(ms)
        if len(h.samples) > LATENCY_WINDOW:
            del h.samples[:len(h.samples) - LATENCY_WINDOW]
        for i, le in enumerate(LATENCY_BUCKETS_MS):
            if ms <= le:
                h.bucket_counts[i] += 1
                if trace_id is not None:
                    h.exemplars[i] = (trace_id, ms)
                break
        h.total += ms
        h.count += 1


def latency_snapshot() -> Dict[str, Dict[str, float]]:
    """Per-stage window aggregates: {name: {count, p50, p99, max}} —
    the health-report / SLO view."""
    with _lock:
        items = [(name, list(h.samples)) for name, h in _hists.items()]
    out: Dict[str, Dict[str, float]] = {}
    for name, samples in items:
        if not samples:
            continue
        ordered = sorted(samples)
        out[name] = {"count": len(ordered),
                     "p50": nearest_rank(ordered, 0.50),
                     "p99": nearest_rank(ordered, 0.99),
                     "max": ordered[-1]}
    return out


def latency_window(name: str) -> List[float]:
    """The raw rolling window for one stage (SLO evaluation input)."""
    with _lock:
        h = _hists.get(name)
        return list(h.samples) if h is not None else []


def histogram_export() -> Dict[str, dict]:
    """Cumulative-bucket view for Prometheus text exposition: {name:
    {"buckets": [(le_ms, cumulative_count, exemplar|None)], "sum": ms,
    "count": n}} with exemplar = (trace_id, value_ms)."""
    with _lock:
        copies = [(name, list(h.bucket_counts), list(h.exemplars),
                   h.total, h.count) for name, h in _hists.items()]
    out: Dict[str, dict] = {}
    for name, bucket_counts, exemplars, total, count in copies:
        cum = 0
        buckets = []
        for le, c, ex in zip(LATENCY_BUCKETS_MS, bucket_counts, exemplars):
            cum += c
            buckets.append((le, cum, ex))
        out[name] = {"buckets": buckets, "sum": total, "count": count}
    return out


def reset_histograms() -> None:
    """Test isolation only: drop latency histograms (the rolling SLO
    window) without touching the named counters — cross-test flush
    samples would otherwise let one test's tail flip another test's
    /health verdict."""
    with _lock:
        _hists.clear()


def reset_stage(name: str) -> None:
    """Drop ONE stage's latency histogram (window + buckets). Harnesses
    that feed a private SLO stage (the capacity soak's virtual-clock
    flush window) clear it per run so back-to-back runs in one process
    grade on their own samples, not the previous run's residue."""
    with _lock:
        _hists.pop(name, None)


def reset() -> None:
    """Test isolation only."""
    with _lock:
        _counters.clear()
        _hists.clear()
        _families.clear()


def record_swallow(site: str) -> None:
    """Count a deliberately swallowed exception at ``site``. The point is
    the rate: a handful of swallows is a degraded dependency, a climbing
    counter is an outage hiding behind a broad except."""
    increment(f"swallowed.{site}")


def input_signature(x) -> tuple:
    """The signature of a call's arguments: the shape and dtype of each
    tensor (anything with `shape` and `dtype`), and the structure around
    them (container types, NamedTuple field names, dict keys, the types of
    other leaves; not their values)."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, getattr(x, "_fields", None),
                tuple(input_signature(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, input_signature(v))
                              for k, v in sorted(x.items(), key=repr)))
    return (type(x).__name__,)


class JitRetraceProbe:
    """Transparent wrapper that counts the distinct input signatures
    (input_signature: each tensor argument's shape and dtype, and the
    structure) seen across THIS probe's calls. PyTorch has no jit cache, so
    this is the one meaning the JAX probe's compile-cache growth has here:
    the first signature a probe sees is an expected compile
    (``<name>.compiles``); a new signature on a later call is a retrace, a
    shape on a path meant to be shape-stable, counted as
    ``<name>.retraces`` and aggregated into ``kernel.retrace_count``.

    Every call also feeds the process-wide compile ledger
    (telemetry/compile_ledger.py) with its wall time and whether its
    signature was new (cold) or seen (warm).
    """

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self.name = name
        # Probes are module globals shared across threads: guard the
        # signature set so two concurrent first calls count once.
        self._probe_lock = threading.Lock()
        self._signatures: set = set()

    def _cache_size(self) -> int:
        """Distinct signatures seen (the ledger's occupancy)."""
        with self._probe_lock:
            return len(self._signatures)

    def __call__(self, *args, **kwargs):
        import time as _time

        from . import compile_ledger as _ledger  # lazy: avoids a cycle

        sig = input_signature((args, kwargs))
        t0 = _time.perf_counter()
        out = self._fn(*args, **kwargs)
        dur_ms = (_time.perf_counter() - t0) * 1000.0
        grew = 0
        with self._probe_lock:
            if sig not in self._signatures:
                grew = 1
                increment(f"{self.name}.compiles")
                if self._signatures:
                    increment(f"{self.name}.retraces")
                    increment("kernel.retrace_count")
                self._signatures.add(sig)
        _ledger.ledger.watch(self.name, self)
        _ledger.ledger.note_call(self.name, dur_ms, grew=grew)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)
