"""Capacity grading: binary-search the sustained rate the SLO holds at.

The open-loop methodology (docs/capacity.md, after the Pulsar
enterprise-scale study): capacity is NOT "ops the loop managed to push"
— it is the highest OFFERED rate at which the pipeline still meets its
SLO (admission ladder <= THROTTLE over the steady window, admitted-op
flush p99 under budget, readers adopting catch-up artifacts). The
grader probes a rate-multiplier axis with a deterministic probe
function (a fresh FleetSoak per probe in the bench; a synthetic tier in
tests), bisects the pass/fail boundary, and attributes the binding
bottleneck from the first failing sample's per-tier pressure feed.

The probe contract keeps this module generic and unit-testable with a
known-capacity synthetic tier:

    probe(rate_mult) -> {"ok": bool,
                         "pressures": {tier: float, ...},   # optional
                         ...figures...}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


def attribute_bottleneck(pressures: Dict[str, float],
                         lags: Optional[Dict[str, float]] = None
                         ) -> Tuple[Optional[str], List[Tuple[str, float]]]:
    """Name the binding tier: the argmax of the normalized pressure
    feed, with the full ranking returned for the record (ties break
    alphabetically so attribution is deterministic). When the probe
    also reports per-tier watermark lags (SoakResult.tier_lags), a
    pressure tie breaks toward the tier with the larger peak lag —
    lag is the direct consumer-side evidence, pressure the proxy."""
    if not pressures:
        return None, []
    lags = lags or {}
    ranked = sorted(pressures.items(),
                    key=lambda kv: (-kv[1], -lags.get(kv[0], 0.0), kv[0]))
    return ranked[0][0], ranked


@dataclass
class GradeSample:
    rate_mult: float
    ok: bool
    sample: dict


@dataclass
class GradeResult:
    """The graded capacity point: the highest probed multiplier that
    held the SLO, the first failing one above it, and the bottleneck
    named from the failing sample's pressures (a pipeline that never
    failed inside [lo, hi] reports ``saturated=False`` and attributes
    from the highest passing sample instead)."""

    capacity_mult: float
    saturated: bool
    bottleneck: Optional[str]
    pressure_ranking: List[Tuple[str, float]] = field(default_factory=list)
    bottleneck_lag: Optional[float] = None
    passing: Optional[GradeSample] = None
    failing: Optional[GradeSample] = None
    history: List[GradeSample] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "capacity_mult": round(self.capacity_mult, 4),
            "saturated": self.saturated,
            "bottleneck": self.bottleneck,
            # The losing tier's peak watermark lag from the attributed
            # sample (ops or records behind, per the edge) — the direct
            # consumer-side evidence beside the normalized pressure.
            "bottleneck_lag": (round(self.bottleneck_lag, 1)
                               if self.bottleneck_lag is not None
                               else None),
            "pressure_ranking": [[t, round(v, 4)]
                                 for t, v in self.pressure_ranking],
            "probes": [{"rate_mult": round(s.rate_mult, 4), "ok": s.ok}
                       for s in self.history],
        }


class CapacityGrader:
    """Bisect the SLO boundary over a rate-multiplier axis.

    probe: deterministic sample function (same mult => same verdict —
    the FleetSoak probe reseeds workload + plan per run, so this holds
    by construction). lo should comfortably pass and hi should
    comfortably fail; when lo fails the capacity is graded 0 (under
    the floor), when hi passes the range is reported unsaturated with
    capacity pinned at hi."""

    def __init__(self, probe: Callable[[float], dict],
                 lo: float = 0.25, hi: float = 2.0, iters: int = 5):
        if lo <= 0 or hi <= lo:
            raise ValueError("need 0 < lo < hi")
        self.probe = probe
        self.lo = lo
        self.hi = hi
        self.iters = iters

    def _sample(self, mult: float, history: List[GradeSample]
                ) -> GradeSample:
        out = self.probe(mult)
        s = GradeSample(rate_mult=mult, ok=bool(out.get("ok")), sample=out)
        history.append(s)
        return s

    @staticmethod
    def _attribute(sample: GradeSample):
        """Bottleneck + ranking + the named tier's watermark lag from
        one sample (probes without a lag feed cite None)."""
        lags = sample.sample.get("tier_lags") or {}
        tier, ranking = attribute_bottleneck(
            sample.sample.get("pressures", {}), lags)
        lag = lags.get(tier) if tier is not None else None
        return tier, ranking, lag

    def search(self) -> GradeResult:
        history: List[GradeSample] = []
        lo_s = self._sample(self.lo, history)
        if not lo_s.ok:
            tier, ranking, lag = self._attribute(lo_s)
            return GradeResult(capacity_mult=0.0, saturated=True,
                               bottleneck=tier, pressure_ranking=ranking,
                               bottleneck_lag=lag,
                               failing=lo_s, history=history)
        hi_s = self._sample(self.hi, history)
        if hi_s.ok:
            tier, ranking, lag = self._attribute(hi_s)
            return GradeResult(capacity_mult=self.hi, saturated=False,
                               bottleneck=tier, pressure_ranking=ranking,
                               bottleneck_lag=lag,
                               passing=hi_s, history=history)
        best_pass, first_fail = lo_s, hi_s
        for _ in range(self.iters):
            mid = (best_pass.rate_mult + first_fail.rate_mult) / 2.0
            mid_s = self._sample(mid, history)
            if mid_s.ok:
                best_pass = mid_s
            else:
                first_fail = mid_s
        tier, ranking, lag = self._attribute(first_fail)
        return GradeResult(capacity_mult=best_pass.rate_mult,
                           saturated=True, bottleneck=tier,
                           pressure_ranking=ranking, bottleneck_lag=lag,
                           passing=best_pass,
                           failing=first_fail, history=history)
