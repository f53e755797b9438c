"""Multi-window SLO burn-rate engine (a copy of fluidframework_tpu's
telemetry/slo.py; docs/observability.md v3).

Generalizes server/monitor.SloPolicy (one stage, one ratio check) to
the SRE-workbook shape: an *objective* declares a target good-event
fraction (e.g. 99% of flushes inside budget); producers feed good/bad
event counts; the engine evaluates the **burn rate** — the observed
bad fraction divided by the error budget (1 - target) — over a fast
and a slow window simultaneously. Burn rate 1.0 spends the budget
exactly at the sustainable pace; an alert fires only when BOTH windows
exceed their thresholds, so a brief spike (fast window only) and a
long-ago incident (slow window only) both stay quiet.

The clock is injectable (same contract as AdmissionController) so the
virtual-clock capacity soak grades burn rates deterministically, and
`evaluate()` returns per-objective attribution for /fleet/health.

State is O(buckets): events land in fixed-width time buckets pruned
past the slow window. Stdlib only, like counters.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

# Default thresholds per the multiwindow alerting recipe: the fast
# window catches "burning 2% of a 30-day budget in an hour" (14.4x),
# the slow window confirms it is sustained (6x). The absolute numbers
# matter less than the two-window AND.
FAST_BURN = 14.4
SLOW_BURN = 6.0


class Objective:
    """One SLO: `target` is the required good fraction (0 < t < 1)."""

    __slots__ = ("name", "target", "description")

    def __init__(self, name: str, target: float,
                 description: str = ""):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1): {target}")
        self.name = name
        self.target = float(target)
        self.description = description

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target


class BurnRateEngine:
    """Time-bucketed good/bad counters + two-window burn evaluation."""

    def __init__(self, objectives: List[Objective],
                 clock: Callable[[], float] = time.monotonic,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 fast_burn: float = FAST_BURN,
                 slow_burn: float = SLOW_BURN,
                 bucket_s: Optional[float] = None):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        self._lock = threading.Lock()
        self._clock = clock
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        # Bucket width: 12 buckets across the fast window keeps the
        # fast-window estimate honest while the slow window stays
        # O(slow/fast * 12) buckets.
        self.bucket_s = float(bucket_s) if bucket_s else \
            self.fast_window_s / 12.0
        self.objectives: Dict[str, Objective] = {
            o.name: o for o in objectives}
        # name -> deque of [bucket_start, good, bad]
        self._buckets: Dict[str, Deque[list]] = {
            name: deque() for name in self.objectives}

    # -- feeding -------------------------------------------------------
    def record(self, objective: str, good: int = 0, bad: int = 0,
               now: Optional[float] = None) -> None:
        if good <= 0 and bad <= 0:
            return
        with self._lock:
            if objective not in self.objectives:
                raise KeyError(f"unknown objective: {objective}")
            if now is None:
                now = self._clock()
            start = now - (now % self.bucket_s)
            buckets = self._buckets[objective]
            if buckets and buckets[-1][0] == start:
                buckets[-1][1] += good
                buckets[-1][2] += bad
            else:
                buckets.append([start, good, bad])
            self._prune(buckets, now)

    def _prune(self, buckets: Deque[list], now: float) -> None:
        horizon = now - self.slow_window_s - self.bucket_s
        while buckets and buckets[0][0] < horizon:
            buckets.popleft()

    # -- evaluation ----------------------------------------------------
    def _window_bad_fraction(self, buckets: Deque[list], now: float,
                             window_s: float) -> Optional[float]:
        cut = now - window_s
        good = bad = 0
        for start, g, b in buckets:
            if start + self.bucket_s > cut:
                good += g
                bad += b
        total = good + bad
        if total == 0:
            return None
        return bad / total

    def burn_rates(self, objective: str,
                   now: Optional[float] = None):
        """(fast, slow) burn rates; None where the window saw no
        events (no data is not a breach)."""
        obj = self.objectives[objective]
        with self._lock:
            if now is None:
                now = self._clock()
            buckets = self._buckets[objective]
            self._prune(buckets, now)
            out = []
            for window in (self.fast_window_s, self.slow_window_s):
                frac = self._window_bad_fraction(buckets, now, window)
                out.append(None if frac is None
                           else frac / obj.error_budget)
            return tuple(out)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Verdict for /fleet/health: per-objective burn rates +
        breach bits, overall ok, and attribution (the worst-burning
        breached objective, or None)."""
        verdict: Dict[str, dict] = {}
        worst_name, worst_burn = None, 0.0
        for name, obj in self.objectives.items():
            fast, slow = self.burn_rates(name, now=now)
            breach = (fast is not None and slow is not None
                      and fast >= self.fast_burn
                      and slow >= self.slow_burn)
            verdict[name] = {
                "target": obj.target,
                "fastBurn": fast,
                "slowBurn": slow,
                "breach": breach,
            }
            if obj.description:
                verdict[name]["description"] = obj.description
            if breach and (fast or 0.0) >= worst_burn:
                worst_name, worst_burn = name, fast or 0.0
        return {
            "ok": worst_name is None,
            "objectives": verdict,
            "attribution": worst_name,
        }

    # -- lifecycle -----------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        with self._lock:
            self._clock = clock

    def reset(self) -> None:
        with self._lock:
            for buckets in self._buckets.values():
                buckets.clear()
