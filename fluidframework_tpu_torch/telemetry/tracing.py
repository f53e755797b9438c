"""Op-lifecycle distributed tracing + the serving-stage flight recorder
(a copy of fluidframework_tpu's telemetry/tracing.py).

The span-context analog of the reference's ``ITelemetryLogger`` boundary
(telemetry-utils threads a logger through every layer; this threads a
``TraceContext`` through the op envelope): a client edit starts a trace,
the context rides ``DocumentMessage.metadata["trace"]`` across the
driver wire, and every pipeline stage (alfred ingest, deli ticket, the
serving flush's named sub-spans, broadcaster fan-out, scribe summarize,
historian reads) records child spans into a bounded, lock-cheap ring
buffer — the flight recorder. ``server/monitor.py`` drains it over
``/trace`` as Chrome trace-event JSON, which perfetto/chrome://tracing
open directly.

Sampling policy: head-based 1-in-N at trace creation (``configure
(sample=N)``; N=0 disables tracing entirely and every entry point
short-circuits to a shared no-op — the <2% overhead budget that
``make trace-smoke`` enforces is measured at N=1, the worst case).
Always-sample-on-slow rides on top: a span that was NOT selected still
records itself when its duration crosses ``slow_ms`` — tail latency
outliers never escape the recorder just because the sampler skipped
them.

Kept dependency-free (stdlib only) so every layer — mergetree, loader,
server — can import it without cycles, exactly like counters.py.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import counters

# DocumentMessage.metadata key the wire context rides under. Metadata is
# already propagated verbatim by SequencedDocumentMessage.from_document_
# message and by every driver serializer, so no wire-format change is
# needed for end-to-end propagation.
TRACE_KEY = "trace"


class TraceContext:
    """Identity of one trace position: (trace_id, span_id) plus the
    head-sampling decision. Child spans inherit trace_id + sampled and
    parent onto span_id."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled", "_wire")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self._wire: Optional[str] = None

    def to_wire(self) -> str:
        """Compact "traceId:spanId:sampled" string (cached). A string —
        not a dict — deliberately: metadata rides dataclasses.asdict on
        every persisted message, and asdict deep-copies dict values but
        passes strings through atomically, so the wire form costs ~0 on
        the scriptorium hot path."""
        wire = self._wire
        if wire is None:
            wire = self._wire = (f"{self.trace_id}:{self.span_id}:"
                                 f"{1 if self.sampled else 0}")
        return wire

    @staticmethod
    def from_wire(v: Any) -> Optional["TraceContext"]:
        if isinstance(v, str):
            parts = v.split(":")
            if len(parts) != 3 or not parts[0]:
                return None
            return TraceContext(parts[0], parts[1],
                                sampled=parts[2] != "0")
        if isinstance(v, dict) and "traceId" in v:  # legacy dict form
            return TraceContext(str(v["traceId"]),
                                str(v.get("spanId", "0")),
                                sampled=bool(v.get("sampled", True)))
        return None

    def __repr__(self) -> str:  # debugging aid only
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"{' sampled' if self.sampled else ''})")


class _Config:
    __slots__ = ("sample", "slow_ms", "capacity")

    def __init__(self):
        self.sample = int(os.environ.get("FLUID_TRACE_SAMPLE", "0"))
        self.slow_ms = float(os.environ.get("FLUID_TRACE_SLOW_MS", "50"))
        self.capacity = 4096


_cfg = _Config()
# Fleet identity: every exported span names the process that recorded
# it, so the observatory's cross-process join can tell alfred's ingest
# span from the tpu-deli worker's ticket span. Workers set this at
# startup (server/main.py); unset falls back to the OS pid.
_process_name: Optional[str] = None
# Sampling counters are PER SITE FAMILY (op roots vs stage roots): one
# shared modulo counter phase-locks against a steady submit->flush
# cadence and can systematically over- or never-sample one family.
_op_counter = itertools.count()       # CPython-atomic
_root_counter = itertools.count()
_span_seq = itertools.count(1)        # process-unique span id suffix
# Trace ids are a random process prefix + a counter: unique in-process,
# collision-improbable across processes, and ~10x cheaper than an
# os.urandom syscall per trace (the sample=1 overhead budget's largest
# single line item before this).
_trace_prefix = os.urandom(4).hex()
_trace_seq = itertools.count(1)
# Wall-clock epoch for span timestamps derived from perf_counter once:
# one clock read per span instead of two.
_epoch = time.time() - time.perf_counter()


def configure(sample: Optional[int] = None,
              slow_ms: Optional[float] = None,
              capacity: Optional[int] = None) -> None:
    """Set the sampling rate (0 = tracing off, 1 = every op, N = 1-in-N),
    the always-record slow threshold, and/or the recorder capacity."""
    if sample is not None:
        _cfg.sample = int(sample)
    if slow_ms is not None:
        _cfg.slow_ms = float(slow_ms)
    if capacity is not None:
        recorder.resize(int(capacity))


def enabled() -> bool:
    return _cfg.sample > 0


def set_process_name(name: Optional[str]) -> None:
    """Tag every span exported from this process (fleet join identity)."""
    global _process_name
    _process_name = name


def process_name() -> str:
    return _process_name or f"pid{os.getpid()}"


def _new_trace_id() -> str:
    return f"{_trace_prefix}{next(_trace_seq) & 0xFFFFFFFFFF:010x}"


def _new_span_id() -> str:
    return f"{next(_span_seq):x}"


def _op_sampled_now() -> bool:
    return (next(_op_counter) % _cfg.sample) == 0


def _root_sampled_now() -> bool:
    return (next(_root_counter) % _cfg.sample) == 0


# Ring-entry layout: spans live as flat tuples on the write path (one
# allocation, no dict churn inside the <2% overhead budget) and
# materialize as dicts only when read.
_SPAN_FIELDS = ("name", "ts", "dur", "tid", "trace_id", "span_id",
                "parent_id", "attrs", "sampled")


class FlightRecorder:
    """Bounded ring buffer of finished spans. The write path holds the
    lock only to bump an index and store one reference (no allocation,
    no ordering work); overflow overwrites the oldest entry — a flight
    recorder keeps the last N seconds, not the full history."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self.resize(capacity)

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._buf: List[Optional[tuple]] = [None] * max(capacity, 1)
            self._next = 0
            self.dropped = 0  # overwritten since last drain

    def record(self, span: tuple) -> None:
        """span: a tuple in _SPAN_FIELDS order."""
        with self._lock:
            i = self._next % len(self._buf)
            if self._buf[i] is not None:
                self.dropped += 1
            self._buf[i] = span
            self._next += 1

    def _ordered(self) -> List[tuple]:
        n = len(self._buf)
        start = self._next % n
        return self._buf[start:] + self._buf[:start]

    def snapshot(self) -> List[dict]:
        """Recorded spans as dicts, oldest first, without clearing."""
        with self._lock:
            ordered = self._ordered()
        return [dict(zip(_SPAN_FIELDS, s)) for s in ordered
                if s is not None]

    def drain(self) -> List[dict]:
        """Snapshot + clear (the /trace endpoint's read)."""
        with self._lock:
            ordered = self._ordered()
            self._buf = [None] * len(self._buf)
            self._next = 0
            self.dropped = 0
        return [dict(zip(_SPAN_FIELDS, s)) for s in ordered
                if s is not None]

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for s in self._buf if s is not None)


recorder = FlightRecorder()

# The ambient span (for parent resolution across nested stages within a
# thread/task); explicit parent= always wins.
_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("fluid_trace_span", default=None)

# Pending op-root handoff between a client-local edit (mergetree/client)
# and the driver submit that ships the resulting op — same thread,
# different layers, no shared call signature.
_tls = threading.local()


class _NullSpan:
    """Shared no-op for the tracing-off path (and unsampled fast exits)."""

    __slots__ = ()
    ctx = None

    def end(self, **_attrs) -> None:
        pass

    cancel = end

    def set(self, **_attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *_exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class _HistTimer:
    """Tracing is off but the stage histogram must still fill (the SLO
    and /metrics.prom surfaces are always on): a bare timer that feeds
    counters.observe on end."""

    __slots__ = ("_hist", "_t0", "_done")
    ctx = None

    def __init__(self, hist: str):
        self._hist = hist
        self._t0 = time.perf_counter()
        self._done = False

    def end(self, **_attrs) -> None:
        if self._done:
            return
        self._done = True
        counters.observe(self._hist,
                         (time.perf_counter() - self._t0) * 1000.0)

    def cancel(self, **_attrs) -> None:
        self.end()

    def set(self, **_attrs) -> None:
        pass

    def __enter__(self) -> "_HistTimer":
        return self

    def __exit__(self, *_exc) -> None:
        self.end()


class Span:
    """One timed operation. End via ``end()`` or context-manager exit
    (fluidlint's SPAN_LEAK rule enforces one of the two on op-pipeline
    modules). Recording happens at end: when the context is sampled, or
    when the duration crosses the slow threshold (always-sample-on-slow).
    """

    __slots__ = ("name", "ctx", "attrs", "hist", "_t0",
                 "_done", "_token")

    def __init__(self, name: str, ctx: TraceContext,
                 hist: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.ctx = ctx
        self.hist = hist
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._done = False
        self._token = None

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        if attrs:
            self.set(**attrs)
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        record = self.ctx.sampled or dur_ms >= _cfg.slow_ms
        if self.hist is not None:
            counters.observe(self.hist, dur_ms,
                             trace_id=self.ctx.trace_id if record
                             else None)
        if record:
            # Tuple in _SPAN_FIELDS order; ts/dur in µs (chrome
            # convention), sampled=False marks a slow-capture.
            recorder.record((
                self.name, (_epoch + self._t0) * 1e6, dur_ms * 1000.0,
                threading.get_ident() & 0xFFFF, self.ctx.trace_id,
                self.ctx.span_id, self.ctx.parent_id, self.attrs or {},
                self.ctx.sampled))

    def cancel(self, **attrs) -> None:
        self.end(error=True, **attrs)

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, _exc, _tb) -> None:
        if exc_type is not None:
            self.cancel()
        else:
            self.end()


def current() -> Optional[TraceContext]:
    sp = _current.get()
    return sp.ctx if sp is not None else None


def span(name: str, parent: Optional[TraceContext] = None,
         root: bool = False, hist: Optional[str] = None,
         **attrs):
    """Open a span.

    parent: explicit wire/context parent (wins over the ambient span).
    root:   with no parent anywhere, mint a fresh head-sampled trace
            (stage entry points: the serving flush, scribe summarize);
            without root, no-parent means no span (per-op stages only
            trace ops that carry a context).
    hist:   also feed this latency histogram (always, even tracing-off).
    """
    if not enabled():
        return _HistTimer(hist) if hist is not None else NULL_SPAN
    ctx = parent
    if ctx is None:
        cur = _current.get()
        ctx = cur.ctx if cur is not None else None
    if ctx is None:
        if not root:
            return _HistTimer(hist) if hist is not None else NULL_SPAN
        ctx = TraceContext(_new_trace_id(), _new_span_id(),
                           sampled=_root_sampled_now())
    else:
        ctx = TraceContext(ctx.trace_id, _new_span_id(),
                           parent_id=ctx.span_id, sampled=ctx.sampled)
    # Unsampled spans still time themselves: always-sample-on-slow needs
    # the duration to decide at end().
    return Span(name, ctx, hist=hist, attrs=attrs or None)


def record_span(name: str, parent: Optional[TraceContext],
                t0: float, t1: float, wall0: Optional[float] = None,
                hist: Optional[str] = None, **attrs) -> None:
    """Record a pre-measured interval (perf_counter endpoints) as a
    finished span — for stages measured across call sites (the deferred
    readback join, per-op ticket stamps inside a batched window)."""
    dur_ms = (t1 - t0) * 1000.0
    # Exemplars only for spans that actually land in the recorder (same
    # gate as Span.end): a bucket exemplar whose trace never appears in
    # /trace would dangle.
    will_record = (enabled() and parent is not None
                   and (parent.sampled or dur_ms >= _cfg.slow_ms))
    if hist is not None:
        counters.observe(hist, dur_ms,
                         trace_id=parent.trace_id if will_record
                         else None)
    if not will_record:
        return
    wall_start = wall0 if wall0 is not None else _epoch + t0
    recorder.record((
        name, wall_start * 1e6, dur_ms * 1000.0,
        threading.get_ident() & 0xFFFF, parent.trace_id,
        _new_span_id(), parent.span_id, attrs or {}, parent.sampled))


# -- op-root handoff (client edit -> driver submit) -------------------------

# Parked between edit and submit: a context, None (no decision yet), or
# this sentinel — the edit's sampler draw said NO, and the submit
# boundary must respect that instead of rolling the dice again (a second
# draw would double the effective sample rate for edited ops and mint
# driver-rooted traces with the client.local_edit span missing).
_UNSAMPLED = object()


def new_op_trace() -> Optional[TraceContext]:
    """Head-sample a fresh root for one client-local op. The decision
    (context or decided-unsampled) is parked thread-locally so the
    driver submit that ships the op (same thread, layers apart) adopts
    it via take_op_trace()/ensure_op_context()."""
    if not enabled():
        return None
    if not _op_sampled_now():
        _tls.op_ctx = _UNSAMPLED
        return None
    ctx = TraceContext(_new_trace_id(), _new_span_id(), sampled=True)
    _tls.op_ctx = ctx
    return ctx


def _take_op_decision():
    decision = getattr(_tls, "op_ctx", None)
    _tls.op_ctx = None
    return decision


def take_op_trace() -> Optional[TraceContext]:
    """Adopt (and clear) the pending op root, if the edit minted one."""
    decision = _take_op_decision()
    return None if decision is _UNSAMPLED else decision


def ensure_op_context() -> Optional[TraceContext]:
    """The submit boundary's context resolution: the edit's parked
    decision (context OR decided-unsampled), else the ambient span, else
    a freshly head-sampled root (ops that enter at the driver without a
    client-edit span — protocol messages, direct submits). None when
    tracing is off or the sampler skips."""
    decision = _take_op_decision()
    if decision is _UNSAMPLED:
        return None
    if decision is not None:
        return decision
    ctx = current()
    if ctx is not None:
        return ctx
    if not enabled() or not _op_sampled_now():
        return None
    return TraceContext(_new_trace_id(), _new_span_id(), sampled=True)


def root_context() -> Optional[TraceContext]:
    """Head-sample a fresh root for a system-initiated message (ghost
    evictions, scribe acks outside any ambient span): these enter the
    raw log without a client edit, and an unstamped system message is a
    hole in the fleet-joined timeline. Uses the stage-root sampling
    counter so op sampling phase stays undisturbed."""
    if not enabled() or not _root_sampled_now():
        return None
    return TraceContext(_new_trace_id(), _new_span_id(), sampled=True)


# -- wire propagation -------------------------------------------------------

def stamp_message(msg, ctx: Optional[TraceContext]) -> None:
    """Attach the context to a DocumentMessage's metadata (no-op when
    tracing is off, ctx is None, or the message is already stamped)."""
    if ctx is None:
        return
    meta = msg.metadata
    if meta is None:
        msg.metadata = {TRACE_KEY: ctx.to_wire()}
    elif isinstance(meta, dict) and TRACE_KEY not in meta:
        meta[TRACE_KEY] = ctx.to_wire()


def message_context(msg) -> Optional[TraceContext]:
    """The wire context a (Document|SequencedDocument)Message carries."""
    if not enabled():
        return None
    meta = getattr(msg, "metadata", None)
    if isinstance(meta, dict):
        return TraceContext.from_wire(meta.get(TRACE_KEY))
    return None


def first_message_context(messages) -> Optional[TraceContext]:
    """The first stamped context in a batch (window/boxcar parents)."""
    if not enabled():
        return None
    for msg in messages:
        ctx = message_context(msg)
        if ctx is not None:
            return ctx
    return None


# -- export -----------------------------------------------------------------

def chrome_trace(spans: Optional[List[dict]] = None) -> dict:
    """Chrome trace-event JSON (the ``/trace`` payload): one complete
    ("ph": "X") event per span; perfetto and chrome://tracing open it
    as-is. Span identity rides in args so a capture can be re-grouped
    by trace_id offline; process identity (pid + args.proc) lets the
    fleet observatory join rings drained from several workers into one
    timeline without ambiguity."""
    events = []
    pid = os.getpid()
    proc = process_name()
    for s in (recorder.snapshot() if spans is None else spans):
        events.append({
            "name": s["name"],
            "cat": "slow" if not s.get("sampled", True) else "fluid",
            "ph": "X",
            "ts": s["ts"],
            "dur": s["dur"],
            "pid": s.get("pid", pid),
            "tid": s.get("tid", 0),
            "args": dict(s.get("attrs") or {},
                         trace_id=s["trace_id"], span_id=s["span_id"],
                         parent_id=s.get("parent_id"),
                         proc=s.get("proc", proc)),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_json(spans: Optional[List[dict]] = None) -> str:
    return json.dumps(chrome_trace(spans))


def reset() -> None:
    """Test isolation only: drop recorded spans and disable tracing."""
    global _process_name
    _cfg.sample = 0
    _cfg.slow_ms = 50.0
    recorder.resize(len(recorder._buf))
    _tls.op_ctx = None
    _process_name = None
