"""Occupancy-driven admission control: the overload front door.

A copy of fluidframework_tpu's server/admission.py, host code that the
port keeps as its own.

The serving ring sustains a measured per-process capacity (BENCH r06),
but nothing in the ingest path protected that figure under overload:
alfred and `LocalServer` accepted every op, partition queues grew
without bound, and the p99<=2xp50 serving SLO (server/monitor.py
SloPolicy) was merely *reported* as breached. This module closes the
loop: a credit-based controller consumes the live occupancy signals the
pipeline already publishes —

  * raw-topic partition backlog (messages appended but not yet pumped
    through the sequencer; `LocalServer.raw_backlog`),
  * the sequencer's occupancy hints (in-flight window ring depth and
    staged-op backlog; `TpuSequencerLambda.occupancy_hints`),
  * the rolling serving-flush latency histogram
    (telemetry/counters.py), normalized against the declared SLO budget

— and moves ingest through explicit states:

  ACCEPT    everything admitted; only the hard queue bound applies.
  THROTTLE  per-tenant fair-share credits; over-credit submissions nack
            429 with a server-computed `retry_after` the driver already
            honors (loader/drivers/resilience.py ThrottlingError,
            loader/container.py throttle recovery).
  SHED      non-essential traffic (signals/presence, no-ops) rejected
            outright; essential ops ride tighter credits. Shedding the
            cheap-to-regenerate traffic first is what keeps the SLO
            holding *for admitted ops* instead of breached for all.
  DEGRADE   survival mode: ingest refused (503 + retry_after), archival
            pumps paused via the registered degrade hooks, queues
            bounded — the process never OOMs and never wedges.

De-escalation is hysteretic and time-based: one level per
`recover_after_s` of calm, so a controller in DEGRADE returns to ACCEPT
within ~3x `recover_after_s` of load dropping (the overload-smoke
grades this at 5 s).

The controller is deliberately deterministic and clock-injectable: the
fault-injection harness (testing/faultinject.py SkewedClock) and the
admission unit tests drive it with scripted signals and virtual time.

Sharded ingest (server/sharding.py) adds a PARTITION channel: the tier
registers one occupancy source per partition (`add_partition_source`)
and submits carry the document's home partition. Those feeds never join
the global queue depth — the aggregate core source already counts every
partition's backlog, and double-counting would re-introduce the PR 6
phantom-drain inflation N-fold. Instead they drive a per-partition soft
bound (default 2x the fair share of the queue limit): a submit to a HOT
partition throttles (429 + retry_after) even while the global ladder
sits in ACCEPT, so one storming partition cannot queue unboundedly nor
starve its siblings' admission (docs/ingest_sharding.md).

Config keys (nconf slice, all optional):
  admission.enabled      (default true)
  admission.queueLimit   hard backlog bound in queued units — broker
                         records (one submit batch = one record) plus
                         sequencer staged ops (default 4096)
  admission.throttleAt / admission.shedAt / admission.degradeAt
                         pressure thresholds (defaults 0.5 / 0.8 / 0.95)
  admission.recoverAfterS  calm seconds per de-escalation step (0.5)
  admission.sloStage     latency histogram feeding the pressure term
                         (default serving.flush)
  admission.partitionLimit  per-partition soft record bound (default
                         2x queueLimit / registered partitions)

See docs/overload.md for the full state machine and credit accounting.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from ..telemetry.counters import (bounded, gauge, increment,
                                  latency_window, nearest_rank, observe,
                                  record_swallow)

# -- states (ordered ladder) -------------------------------------------------
ACCEPT = "accept"
THROTTLE = "throttle"
SHED = "shed"
DEGRADE = "degrade"

STATE_LEVEL = {ACCEPT: 0, THROTTLE: 1, SHED: 2, DEGRADE: 3}
LEVEL_STATE = {v: k for k, v in STATE_LEVEL.items()}

# -- op classes (shed ordering) ----------------------------------------------
# Essential traffic (sequenced content ops, joins/leaves) sheds LAST;
# transient fan-out (signals/presence) and no-ops shed FIRST — they are
# cheap for the client to regenerate and carry no document state.
CLASS_OP = "op"
CLASS_JOIN = "join"
CLASS_SIGNAL = "signal"
CLASS_NOOP = "noop"

_NON_ESSENTIAL = frozenset((CLASS_SIGNAL, CLASS_NOOP))

# Credit headroom per state: the fraction of the measured drain rate
# handed out as per-tenant credits. THROTTLE keeps near-capacity flowing
# (the point is pacing, not starving); SHED leaves slack for the queue
# to actually drain.
_HEADROOM = {THROTTLE: 0.95, SHED: 0.7}

_BURST_S = 0.25          # per-tenant credit burst window (seconds of share)
_ACTIVE_TTL_S = 2.0      # tenant counts toward fair-share split this long
# Idle buckets past this are DELETED (not just dropped from the active
# split): a churning tenant population must not grow the dict — and the
# /health status block serialized from it — without bound; a returning
# tenant simply re-buckets at zero credits.
_TENANT_EVICT_S = 10 * _ACTIVE_TTL_S
_MIN_RETRY_S = 0.05
_MAX_RETRY_S = 2.0


class Decision(NamedTuple):
    admitted: bool
    state: str
    retry_after_s: float
    reason: str


_ADMITTED = Decision(True, ACCEPT, 0.0, "ok")


class _TenantBucket:
    __slots__ = ("tokens", "last_seen")

    def __init__(self, now: float):
        self.tokens = 0.0
        self.last_seen = now


class AdmissionController:
    """One controller fronts one process's ingest (a LocalServer core,
    or shared across every tenant core of an alfred — fair-share credits
    are keyed by tenant either way)."""

    def __init__(self, queue_limit: int = 4096,
                 throttle_at: float = 0.5, shed_at: float = 0.8,
                 degrade_at: float = 0.95,
                 recover_after_s: float = 0.5,
                 interval_s: float = 0.02,
                 slo_stage: str = "serving.flush",
                 slo_ratio: float = 2.0,
                 slo_min_samples: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 partition_limit: Optional[int] = None,
                 config=None):
        self._partition_limit_cfg = partition_limit
        if config is not None:
            queue_limit = int(config.get("admission.queueLimit",
                                         queue_limit))
            throttle_at = float(config.get("admission.throttleAt",
                                           throttle_at))
            shed_at = float(config.get("admission.shedAt", shed_at))
            degrade_at = float(config.get("admission.degradeAt",
                                          degrade_at))
            recover_after_s = float(config.get("admission.recoverAfterS",
                                               recover_after_s))
            slo_stage = config.get("admission.sloStage", slo_stage)
            self._partition_limit_cfg = config.get(
                "admission.partitionLimit", self._partition_limit_cfg)
        self.queue_limit = int(queue_limit)
        self.throttle_at = float(throttle_at)
        self.shed_at = float(shed_at)
        self.degrade_at = float(degrade_at)
        self.recover_after_s = float(recover_after_s)
        self.interval_s = float(interval_s)
        self.slo_stage = slo_stage
        self.slo_ratio = float(slo_ratio)
        self.slo_min_samples = int(slo_min_samples)
        self.clock = clock

        self._lock = threading.RLock()
        self._state = ACCEPT
        self._forced: Optional[str] = None
        self._sources: Dict[str, dict] = {}
        # Per-partition fairness channel (sharded ingest): occupancy
        # feeds keyed by partition index, and the cached per-partition
        # depths (polled on the observe cadence, bumped optimistically
        # between polls exactly like the global cache).
        self._partition_sources: Dict[int, dict] = {}
        self._partition_depth: Dict[int, int] = {}
        self._tenants: Dict[str, _TenantBucket] = {}
        self._degrade_enter: List[Callable[[], None]] = []
        self._degrade_exit: List[Callable[[], None]] = []

        now = self.clock()
        self._last_observe = now - self.interval_s  # first admit observes
        self._calm_since: Optional[float] = None
        self._queue_depth = 0          # cached raw backlog + staged ops
        self._depth_at_poll = 0        # depth as of the last source poll
        self._staged_ops = 0
        self._ring_frac = 0.0
        self._lat_ratio = 0.0
        self._pressure = 0.0
        self.peak_queue_depth = 0
        self._admitted_since = 0       # records admitted since last observe
        self._rejects_since = 0        # credit rejects since last observe
        self._drain_rate: Optional[float] = None  # EWMA records/s drained
        self._drain_acc = 0.0          # queue-limited drained-op window
        self._drain_acc_dt = 0.0

    # -- wiring -------------------------------------------------------------
    def add_source(self, name: str,
                   queue_depth: Optional[Callable[[], int]] = None,
                   hints: Optional[Callable[[], dict]] = None) -> None:
        """Register an occupancy feed: `queue_depth` returns this
        source's un-pumped ingest backlog in broker records; `hints`
        returns the
        sequencer's occupancy-hint dict (ring_occupancy / ring_depth /
        staged_ops). Sources are polled on the observe cadence."""
        with self._lock:
            self._sources[name] = {"queue_depth": queue_depth,
                                   "hints": hints}

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def add_partition_source(self, partition: int,
                             queue_depth: Optional[Callable[[], int]] = None,
                             hints: Optional[Callable[[], dict]] = None,
                             scope: Optional[str] = None) -> None:
        """Register one ingest partition's occupancy feed for the
        FAIRNESS channel (module docstring): `queue_depth` returns the
        partition's raw-record backlog, `hints` the owning sequencer's
        occupancy dict (staged ops count toward the partition's depth).
        Deliberately NOT summed into the global queue depth — the
        aggregate source already counts it (double-count audit,
        docs/ingest_sharding.md).

        `scope` namespaces the channel on a SHARED controller: alfred
        runs one controller across every tenant core, and each core's
        tier registers its partitions under its tenant id — without the
        scope, core B's feeds would silently replace core A's. A
        scope-less registration (single-core deployments, direct
        controller tests) matches any tenant."""
        with self._lock:
            key = (scope, int(partition))
            self._partition_sources[key] = {
                "queue_depth": queue_depth, "hints": hints}
            self._partition_depth.setdefault(key, 0)

    def _partition_key(self, tenant: str,
                       partition: int) -> Optional[tuple]:
        """The registered feed a (tenant, partition) admit maps to:
        tenant-scoped first, then the scope-less fallback."""
        if (tenant, partition) in self._partition_sources:
            return (tenant, partition)
        if (None, partition) in self._partition_sources:
            return (None, partition)
        return None

    def partition_limit(self, scope: Optional[str] = None) -> int:
        """The per-partition soft record bound: configured, or 2x the
        fair share of the hard queue limit over the scope's partition
        count — enough headroom for benign skew, far below the point
        one partition could exhaust the global budget."""
        if self._partition_limit_cfg is not None:
            return int(self._partition_limit_cfg)
        n = sum(1 for (s, _p) in self._partition_sources if s == scope)
        if n == 0:
            # No feeds under this scope (introspection with the default
            # scope on a tenant-scoped controller): fall back to the
            # distinct partition indices across every scope.
            n = len({p for (_s, p) in self._partition_sources})
        n = max(1, n)
        return max(1, min(self.queue_limit,
                          (2 * self.queue_limit) // n))

    def add_degrade_hooks(self, enter: Callable[[], None],
                          exit: Callable[[], None]) -> None:
        """Callbacks fired on the DEGRADE boundary (pause/resume the
        archival partition pumps; LocalServer registers these)."""
        with self._lock:
            self._degrade_enter.append(enter)
            self._degrade_exit.append(exit)

    def force_state(self, state: Optional[str]) -> None:
        """Pin the ladder (tests / operator override); None releases.
        Degrade hooks fire on the boundary exactly as for organic
        transitions."""
        with self._lock:
            previous = self._state
            self._forced = state
            if state is not None:
                self._transition(previous, state)
                self._state = state
                self._calm_since = None

    # -- signal collection --------------------------------------------------
    def _poll_sources(self) -> None:
        depth = 0
        staged = 0
        ring_frac = 0.0
        for name, src in list(self._sources.items()):
            try:
                if src["queue_depth"] is not None:
                    depth += int(src["queue_depth"]())
                if src["hints"] is not None:
                    h = src["hints"]() or {}
                    staged += int(h.get("staged_ops", 0))
                    ring_depth = max(1, int(h.get("ring_depth", 1)))
                    # Occupancy is WINDOW-counted (a K-window fused
                    # burst reports K, not 1 — see TpuSequencerLambda.
                    # occupancy_hints), so the raw ratio can exceed 1
                    # whenever a burst is in flight. Clamp at "full":
                    # that keeps the latency term live during long scan
                    # steps (an uncapped ratio is not more full than
                    # full) while the 0.45 damping below still
                    # guarantees bursting-by-design never reaches the
                    # 0.5 THROTTLE threshold on its own.
                    ring_frac = max(
                        ring_frac,
                        min(1.0, float(h.get("ring_occupancy", 0))
                            / ring_depth))
            except Exception:  # noqa: BLE001 — a probe must not block ingest
                record_swallow("admission.source")
        self._staged_ops = staged
        self._queue_depth = depth + staged
        self._ring_frac = ring_frac
        if self._queue_depth > self.peak_queue_depth:
            self.peak_queue_depth = self._queue_depth
        # Fairness channel: refresh each partition's cached depth (raw
        # records + the owning sequencer's staged ops). Kept OUT of the
        # global depth above — see add_partition_source.
        for key, src in list(self._partition_sources.items()):
            try:
                d = int(src["queue_depth"]()) \
                    if src["queue_depth"] is not None else 0
                if src["hints"] is not None:
                    d += int((src["hints"]() or {}).get("staged_ops", 0))
                self._partition_depth[key] = d
            except Exception:  # noqa: BLE001 — a probe must not block ingest
                record_swallow("admission.partition_source")

    def _latency_pressure(self) -> float:
        window = latency_window(self.slo_stage)
        if len(window) < self.slo_min_samples:
            self._lat_ratio = 0.0
            return 0.0
        ordered = sorted(window)
        p50 = nearest_rank(ordered, 0.50)
        p99 = nearest_rank(ordered, 0.99)
        self._lat_ratio = (p99 / p50) if p50 > 0 else 0.0
        # Normalized so the SLO-budget edge (p99 == ratio*p50) lands
        # exactly on the THROTTLE threshold and 2x budget on DEGRADE:
        # latency spread starts pacing ingest the moment the declared
        # budget is at risk, not after it is long gone.
        return (self._lat_ratio / (2.0 * self.slo_ratio)) \
            if self._lat_ratio else 0.0

    def observe(self, force: bool = False) -> None:
        """Refresh signals + run the state ladder. Rate-limited to
        `interval_s` (the admit hot path calls this on every decision)."""
        with self._lock:
            now = self.clock()
            dt = now - self._last_observe
            if not force and dt < self.interval_s:
                return
            # Depth at the LAST poll, not the live cache: admits bump
            # the cache optimistically between polls, and reading the
            # bumped value here would count those arrivals twice (once
            # in prev_depth, once in _admitted_since), inflating the
            # capacity estimate by the admission rate — credits then
            # overshoot and the queue equilibrates half-full instead of
            # near-empty, taxing every admitted op's latency.
            prev_depth = self._depth_at_poll
            self._poll_sources()
            self._depth_at_poll = self._queue_depth
            # Drain-rate (capacity) estimate: what left the queue, but
            # only over QUEUE-LIMITED intervals — backlog present at
            # BOTH ends, so the server was verifiably saturated the
            # whole time. An idle or credit-starved server drains
            # exactly its arrival rate, which says nothing about
            # capacity — feeding those samples in is the death spiral
            # where a quiet DEGRADE decays the estimate to zero and the
            # de-escalated ladder then hands out near-zero credits.
            # Samples accumulate to a full-interval window before the
            # EWMA sees them: drains are bursty (a pump cycle lands
            # whole batches between polls, and the queue-full path
            # forces micro-dt re-polls), and an instantaneous burst/dt
            # reading can be wrong by orders of magnitude.
            drained = prev_depth + self._admitted_since - self._queue_depth
            self._admitted_since = 0
            if dt > 0 and drained >= 0 and prev_depth > 0 \
                    and self._queue_depth > 0:
                self._drain_acc += drained
                self._drain_acc_dt += dt
                if self._drain_acc_dt >= 2 * self.interval_s:
                    rate = self._drain_acc / self._drain_acc_dt
                    self._drain_rate = rate if self._drain_rate is None \
                        else 0.5 * self._drain_rate + 0.5 * rate
                    self._drain_acc = 0.0
                    self._drain_acc_dt = 0.0
            elif (self._rejects_since > 0 and self._queue_depth == 0
                    and self._drain_rate is not None
                    and STATE_LEVEL[self._state] >= 1):
                # Upward probe: credit rejects while the queue sits EMPTY
                # mean the estimate — not the server — is the limit (the
                # stall has passed, or the estimate bootstrapped low).
                # Grow it until either the rejects stop or the queue
                # starts building, at which point real queue-limited
                # samples take over and re-anchor it at true capacity.
                self._drain_rate *= 1.05
            self._rejects_since = 0
            lat_frac = self._latency_pressure()
            queue_frac = self._queue_depth / max(1, self.queue_limit)
            # A full in-flight ring is a UTILIZATION signal, not overload
            # — pipelined serving runs the ring at depth by design and
            # the ring itself is bounded (dispatch blocks at depth). It
            # contributes damped pressure (never enough to throttle on
            # its own) that stacks with real queue growth. Likewise the
            # latency-spread term only counts when ingest is actually
            # queueing: tail spread over an empty queue is compile /
            # GC noise, and pacing admitted traffic cannot fix it.
            if queue_frac <= 0.05 and self._ring_frac < 1.0:
                lat_frac = 0.0
            self._pressure = max(queue_frac, 0.45 * self._ring_frac,
                                 lat_frac)
            self._last_observe = now
            self._step_ladder(now)
            self._refill_credits(dt, now)
            gauge("admission.pressure", round(self._pressure, 4))
            gauge("admission.level", STATE_LEVEL[self._state])
            gauge("admission.queue_depth", self._queue_depth)
            gauge("admission.peak_queue_depth", self.peak_queue_depth)
            for (scope, p) in sorted(
                    self._partition_sources,
                    key=lambda k: (k[0] or "", k[1])):
                label = f"p{p}" if scope is None else f"{scope}.p{p}"
                gauge(bounded("admission.partition_depth", label),
                      self._partition_depth.get((scope, p), 0))

    # -- the ladder ---------------------------------------------------------
    def _target_level(self) -> int:
        p = self._pressure
        if p >= self.degrade_at:
            return 3
        if p >= self.shed_at:
            return 2
        if p >= self.throttle_at:
            return 1
        return 0

    def _entry_threshold(self, level: int) -> float:
        return (self.throttle_at, self.shed_at,
                self.degrade_at)[level - 1]

    def _step_ladder(self, now: float) -> None:
        if self._forced is not None:
            return
        level = STATE_LEVEL[self._state]
        target = self._target_level()
        if target > level:
            # Escalate immediately — overload does not wait politely.
            self._transition(self._state, LEVEL_STATE[target])
            self._state = LEVEL_STATE[target]
            self._calm_since = None
            return
        if level == 0:
            self._calm_since = None
            return
        # De-escalate one level per recover_after_s of sustained calm
        # (pressure clearly below the current level's entry edge) —
        # hysteresis so a queue hovering at the threshold cannot flap.
        # THROTTLE additionally requires the calm window to be free of
        # credit rejects before opening back to ACCEPT: under sustained
        # overload the credits keep the queue empty (pressure ~0), and
        # pressure-only calm would flap ACCEPT->burst->THROTTLE forever,
        # sawtoothing the queue and the admitted ops' latency with it.
        # (Credit rejects clear _calm_since in admit; SHED/DEGRADE
        # de-escalation stays pressure-only — dropping into the next
        # credit state is always safe.)
        if self._pressure < self._entry_threshold(level) * 0.7:
            if self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= self.recover_after_s:
                self._transition(self._state, LEVEL_STATE[level - 1])
                self._state = LEVEL_STATE[level - 1]
                self._calm_since = now
        else:
            self._calm_since = None

    def _transition(self, old: str, new: str) -> None:
        if old == new:
            return
        increment(f"admission.transitions.{old}_to_{new}")
        was_degraded = STATE_LEVEL[old] == 3
        is_degraded = STATE_LEVEL[new] == 3
        hooks = self._degrade_enter if (is_degraded and not was_degraded) \
            else self._degrade_exit if (was_degraded and not is_degraded) \
            else ()
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — a pump hook must not kill admit
                record_swallow("admission.degrade_hook")

    # -- credits ------------------------------------------------------------
    def _credit_scale(self) -> float:
        """Credit rate = drain capacity x state headroom x REMAINING
        QUEUE HEADROOM. The last factor is the drain control law: with a
        standing queue, pacing at 95% of capacity would clear it at only
        5% per interval, holding admitted-op latency elevated long after
        the burst that built it; scaling the share down with queue depth
        makes the backlog clear at near-full drain rate and the system
        settle where the queue is ~empty and credits ~= capacity."""
        headroom = _HEADROOM.get(self._state, 0.0)
        return headroom * max(
            0.0, 1.0 - self._queue_depth / max(1, self.queue_limit))

    def _refill_credits(self, dt: float, now: float) -> None:
        for tenant, b in list(self._tenants.items()):
            if now - b.last_seen > _TENANT_EVICT_S:
                del self._tenants[tenant]
        if STATE_LEVEL[self._state] < 1 or dt <= 0:
            return
        active = [t for t, b in self._tenants.items()
                  if now - b.last_seen <= _ACTIVE_TTL_S]
        if not active or self._drain_rate is None:
            return
        share = self._drain_rate * self._credit_scale() / len(active)
        cap = max(1.0, share * _BURST_S)
        for tenant in active:
            bucket = self._tenants[tenant]
            bucket.tokens = min(cap, bucket.tokens + share * dt)

    def _share_rate(self, now: float) -> float:
        active = max(1, sum(1 for b in self._tenants.values()
                            if now - b.last_seen <= _ACTIVE_TTL_S))
        return (self._drain_rate or 0.0) * self._credit_scale() / active

    def _retry_after(self, need: float, now: float) -> float:
        share = self._share_rate(now)
        if share <= 0:
            return max(_MIN_RETRY_S, self.recover_after_s)
        return min(_MAX_RETRY_S, max(_MIN_RETRY_S, need / share))

    # -- the decision -------------------------------------------------------
    def admit(self, tenant: str = "local", kind: str = CLASS_OP,
              count: int = 1, records: Optional[int] = None,
              partition: Optional[int] = None,
              trace_id: Optional[str] = None) -> Decision:
        """One admission decision for `count` ops of class `kind` from
        `tenant`, arriving as `records` broker records (a multi-op
        submit batch rides ONE boxcar record — the unit `raw_backlog`
        polls and the pumps drain; defaults to `count`). Queue depth,
        the hard bound, credits, and the drain estimator all account in
        records so the cached depth stays calibrated against the polled
        backlog; the admission.* counters keep op units for
        observability. `partition` (sharded ingest) additionally applies
        the per-partition fairness bound. Thread-safe; O(1) beyond the
        rate-limited observe."""
        recs = count if records is None else records
        self.observe()
        with self._lock:
            now = self.clock()
            bucket = self._tenants.get(tenant)
            if bucket is None:
                bucket = self._tenants[tenant] = _TenantBucket(now)
            bucket.last_seen = now
            state = self._state
            # Hard bound FIRST, in every state: the raw queue must never
            # outgrow its limit, whatever the ladder believes — this is
            # the never-OOM invariant the overload bench grades.
            if kind != CLASS_SIGNAL \
                    and self._queue_depth + recs > self.queue_limit:
                # The cached depth inflates optimistically between
                # observes (every admit bumps it, only a poll decrements)
                # — re-poll before rejecting so a burst admitted inside
                # one observe interval can't trip the bound spuriously.
                self.observe(force=True)
                state = self._state
            if kind != CLASS_SIGNAL \
                    and self._queue_depth + recs > self.queue_limit:
                increment("admission.rejected.queue_full", count)
                retry = self._retry_after(recs, now)
                self._note_reject(retry, trace_id)
                return Decision(False, state if state != ACCEPT else SHED,
                                retry, "queue full")
            # Per-partition fairness bound (sharded ingest): a HOT
            # partition's documents throttle — 429 + retry_after, the
            # ladder's THROTTLE contract — while the GLOBAL state stays
            # wherever pressure puts it, so siblings keep their
            # admission untouched. Records-unit accounting, same
            # optimistic-bump/re-poll discipline as the hard bound.
            pkey = self._partition_key(tenant, partition) \
                if partition is not None else None
            if kind != CLASS_SIGNAL and pkey is not None:
                limit = self.partition_limit(pkey[0])
                if self._partition_depth.get(pkey, 0) + recs > limit:
                    self.observe(force=True)
                if self._partition_depth.get(pkey, 0) + recs > limit:
                    increment("admission.rejected.partition_hot", count)
                    # Bounded family (PR 12 cardinality guard): per-
                    # partition labels are few, but the guard is the
                    # contract for any dynamic-label family.
                    increment(bounded("admission.partition_hot",
                                      f"p{partition}"), count)
                    retry = self._retry_after(recs, now)
                    self._note_reject(retry, trace_id)
                    return Decision(False, THROTTLE, retry,
                                    f"partition {partition} hot")
            if state == ACCEPT:
                return self._admitted(kind, count, recs, pkey)
            if state == DEGRADE:
                if kind == CLASS_SIGNAL:
                    increment("admission.shed_signals", count)
                    return Decision(False, state, 0.0, "degraded")
                increment("admission.rejected.degrade", count)
                retry = max(self.recover_after_s * 2, _MIN_RETRY_S)
                self._note_reject(retry, trace_id)
                return Decision(False, state, retry, "degraded")
            if kind in _NON_ESSENTIAL and state == SHED:
                if kind == CLASS_SIGNAL:
                    increment("admission.shed_signals", count)
                else:
                    increment("admission.rejected.shed", count)
                # Signals are transient fire-and-forget: no retry loop.
                return Decision(False, state, 0.0, "shedding non-essential")
            # THROTTLE (all classes) / SHED (essential): fair-share
            # credits. With no drain estimate yet, fall back to queue
            # headroom at the state's allowance.
            if self._drain_rate is None:
                allowance = self.queue_limit * (0.75 if state == THROTTLE
                                                else 0.5)
                if self._queue_depth + recs <= allowance:
                    return self._admitted(kind, count, recs, pkey)
                increment(f"admission.rejected.{state}", count)
                self._credit_reject(recs)
                retry = self._retry_after(recs, now)
                self._note_reject(retry, trace_id)
                return Decision(False, state, retry, "no headroom")
            if bucket.tokens >= recs:
                bucket.tokens -= recs
                return self._admitted(kind, count, recs, pkey)
            increment(f"admission.rejected.{state}", count)
            self._credit_reject(recs)
            retry = self._retry_after(recs - bucket.tokens, now)
            self._note_reject(retry, trace_id)
            return Decision(False, state, retry, "over credit share")

    def retract(self, count: int = 1, records: Optional[int] = None,
                partition: Optional[int] = None,
                tenant: str = "local") -> None:
        """Undo an `admit` whose batch never reached the queue (a LATER
        gate — e.g. the per-document token bucket — nacked it). Without
        this the phantom records read as drained at the next observe,
        inflating the capacity estimate exactly when both limiters are
        active. A retract after an intervening poll can push
        `_admitted_since` negative; the drain window's `drained >= 0`
        guard discards that sample rather than crediting it."""
        recs = count if records is None else records
        with self._lock:
            self._queue_depth = max(0, self._queue_depth - recs)
            self._admitted_since -= recs
            pkey = self._partition_key(tenant, partition) \
                if partition is not None else None
            if pkey is not None:
                self._partition_depth[pkey] = max(
                    0, self._partition_depth.get(pkey, 0) - recs)
            increment("admission.retracted", count)

    def _credit_reject(self, count: int) -> None:
        """Bookkeeping for a fair-share (credit/headroom) rejection:
        feeds the upward capacity probe, and in THROTTLE resets the calm
        clock — offered load still exceeds the admitted share, so the
        door to ACCEPT must stay shut (see _step_ladder)."""
        self._rejects_since += count
        if self._state == THROTTLE:
            self._calm_since = None

    def _admitted(self, kind: str, count: int,
                  records: Optional[int] = None,
                  pkey: Optional[tuple] = None) -> Decision:
        increment("admission.admitted", count)
        if kind != CLASS_SIGNAL:
            # Signals never enter the sequencer queue. Depth is bumped
            # in RECORDS — the unit the source polls replace it with.
            recs = count if records is None else records
            self._admitted_since += recs
            self._queue_depth += recs
            if pkey is not None:
                # Optimistic per-partition bump, replaced by the next
                # poll (same discipline as the global cache).
                self._partition_depth[pkey] = \
                    self._partition_depth.get(pkey, 0) + recs
            if self._queue_depth > self.peak_queue_depth:
                self.peak_queue_depth = self._queue_depth
        return _ADMITTED if self._state == ACCEPT else Decision(
            True, self._state, 0.0, "ok")

    def _note_reject(self, retry_after_s: float,
                     trace_id: Optional[str]) -> None:
        # Histogram (with trace exemplars for /metrics.prom): how long
        # the server is asking rejected traffic to stay away.
        observe("admission.retry_wait_ms", retry_after_s * 1000.0,
                trace_id)

    # -- introspection ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def queue_depth(self) -> int:
        with self._lock:
            return self._queue_depth

    def status(self) -> dict:
        """The /health `admission` block (server/monitor.py
        watch_admission)."""
        with self._lock:
            now = self.clock()
            return {
                "state": self._state,
                "level": STATE_LEVEL[self._state],
                "forced": self._forced,
                "pressure": round(self._pressure, 4),
                "queueDepth": self._queue_depth,
                "stagedOps": self._staged_ops,
                "queueLimit": self.queue_limit,
                "peakQueueDepth": self.peak_queue_depth,
                "ringOccupancyFrac": round(self._ring_frac, 4),
                "latencyRatio": round(self._lat_ratio, 3),
                "drainRateOpsS": round(self._drain_rate, 1)
                if self._drain_rate is not None else None,
                "thresholds": {"throttle": self.throttle_at,
                               "shed": self.shed_at,
                               "degrade": self.degrade_at},
                "recoverAfterS": self.recover_after_s,
                "tenants": {
                    t: {"credits": round(b.tokens, 2),
                        "idleS": round(now - b.last_seen, 3)}
                    for t, b in self._tenants.items()},
                "partitions": {
                    (str(p) if scope is None else f"{scope}:{p}"): {
                        "depth": self._partition_depth.get((scope, p), 0),
                        "limit": self.partition_limit(scope)}
                    for (scope, p) in sorted(
                        self._partition_sources,
                        key=lambda k: (k[0] or "", k[1]))
                } if self._partition_sources else None,
            }


def admission_from_config(config=None) -> Optional[AdmissionController]:
    """The standard construction gate: honors `admission.enabled`
    (default on) and passes the config through for the knob overrides."""
    if config is not None and not _truthy(
            config.get("admission.enabled", True)):
        return None
    return AdmissionController(config=config)


def _truthy(value) -> bool:
    if isinstance(value, str):
        return value.lower() not in ("0", "false", "no", "off", "")
    return bool(value)
