"""Per-tier watermark table: Kafka-style consumer lag for the whole
pipeline (docs/observability.md v3).

A copy of fluidframework_tpu's telemetry/watermarks.py, host code that the
port keeps as its own.

Every tier stamps a per-(tenant, partition) watermark as work passes
through it:

  raw_end       newest raw-log offset appended (records domain)
  raw_ingested  raw-log offset committed by the sequencer tier
  ticketed      ops assigned sequence numbers (ops domain)
  broadcast     sequenced ops delivered to rooms
  summarized    ops covered by a committed summary
  catchup       ops covered by a published catch-up artifact
  adopted       ops covered by a reader's adopted artifact

Lag is a *difference of watermarks* along a declared edge — never a
per-op measurement — so the steady-state cost is O(partitions) state
and the hot paths pay at most one dict high-water update:

  ingest     raw_end  - raw_ingested   (records; matches partition_stats)
  broadcast  ticketed - broadcast      (ops)
  summarize  ticketed - summarized     (ops)
  catchup    ticketed - catchup        (ops)
  adopt      catchup  - adopted        (ops)

The downstream tiers hang off `ticketed` as parallel consumers of the
sequenced stream (the consumer-group shape), except `adopt`, which
chains off `catchup` (readers can only adopt what was published).

Replay safety: chaos restarts replay the uncommitted raw window, so a
cumulative "advance by batch size" counter would double-count. The
ops-domain tiers therefore keep a per-document sequence-number
high-water mark (`advance_doc`): replayed ops fold in max(0, seq -
prev) = 0, making every watermark exact and run-twice deterministic
under partition crashes. Offset-domain tiers are plain monotonic
maxima for the same reason.

Export rides the existing cardinality guard: `export_gauges()` writes
`lag.<edge>.p<N>` through counters.bounded — surfaced by the monitor
as `fluid_lag_*` — plus a per-edge total and an op-age gauge (seconds
since the downstream tier last advanced while lag is nonzero; 0 when
caught up). The clock is injectable so the virtual-clock capacity soak
can grade ages deterministically.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from . import counters

# -- tier names (watermark producers) ----------------------------------
RAW_END = "raw_end"
RAW_INGESTED = "raw_ingested"
TICKETED = "ticketed"
BROADCAST = "broadcast"
SUMMARIZED = "summarized"
CATCHUP = "catchup"
ADOPTED = "adopted"

TIERS = (RAW_END, RAW_INGESTED, TICKETED, BROADCAST, SUMMARIZED,
         CATCHUP, ADOPTED)

# Tiers whose watermark is a sum of per-document sequence-number
# high-water marks (replay-safe under partition-crash chaos).
_DOC_TIERS = frozenset((TICKETED, BROADCAST, SUMMARIZED, CATCHUP,
                        ADOPTED))

# -- lag edges: (edge name, upstream tier, downstream tier) ------------
LAG_EDGES = (
    ("ingest", RAW_END, RAW_INGESTED),
    ("broadcast", TICKETED, BROADCAST),
    ("summarize", TICKETED, SUMMARIZED),
    ("catchup", TICKETED, CATCHUP),
    ("adopt", CATCHUP, ADOPTED),
)

_Key = Tuple[str, str, int]  # (tier, tenant, partition)


class WatermarkTable:
    """Thread-safe watermark store; one process-global instance below."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._marks: Dict[_Key, float] = {}
        # Per-doc high-water marks backing the ops-domain tiers.
        self._docs: Dict[_Key, Dict[str, int]] = {}
        # Clock time of the last advance per (tier, tenant, partition):
        # the op-age signal while an edge is behind.
        self._touched: Dict[_Key, float] = {}

    # -- producers -----------------------------------------------------
    def advance(self, tier: str, partition: int, value: float,
                tenant: str = "local") -> None:
        """Monotonic watermark for offset-domain tiers (raw_end /
        raw_ingested): replays re-present old offsets and fold to 0."""
        key = (tier, tenant, int(partition))
        value = float(value)
        with self._lock:
            if value > self._marks.get(key, float("-inf")):
                self._marks[key] = value
                self._touched[key] = self._clock()

    def advance_doc(self, tier: str, partition: int, document_id: str,
                    seq: int, tenant: str = "local") -> None:
        """Ops-domain watermark: fold this document's sequence-number
        high-water into the partition aggregate. Replayed (already
        counted) sequence numbers contribute nothing."""
        key = (tier, tenant, int(partition))
        seq = int(seq)
        with self._lock:
            docs = self._docs.get(key)
            if docs is None:
                docs = self._docs[key] = {}
            prev = docs.get(document_id, 0)
            if seq > prev:
                docs[document_id] = seq
                self._marks[key] = self._marks.get(key, 0.0) + (seq - prev)
                self._touched[key] = self._clock()

    # -- readers -------------------------------------------------------
    def mark(self, tier: str, partition: int,
             tenant: str = "local") -> float:
        with self._lock:
            return self._marks.get((tier, tenant, int(partition)), 0.0)

    def lags(self) -> Dict[str, Dict[Tuple[str, int], float]]:
        """Per-edge, per-(tenant, partition) lag. A partition appears
        when EITHER end of the edge has stamped it; a missing
        downstream mark reads as 0 (nothing consumed yet)."""
        with self._lock:
            out: Dict[str, Dict[Tuple[str, int], float]] = {}
            for edge, up, down in LAG_EDGES:
                per: Dict[Tuple[str, int], float] = {}
                for (tier, tenant, part), val in self._marks.items():
                    if tier != up:
                        continue
                    got = self._marks.get((down, tenant, part), 0.0)
                    per[(tenant, part)] = max(0.0, val - got)
                out[edge] = per
            return out

    def total_lag(self, edge: str) -> float:
        per = self.lags().get(edge, {})
        return float(sum(per.values()))

    def ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """Seconds each edge has been behind: 0 when lag is 0, else
        clock-now minus the downstream tier's last advance (or the
        upstream's first stamp if the consumer never ran)."""
        lags = self.lags()
        with self._lock:
            if now is None:
                now = self._clock()
            out: Dict[str, float] = {}
            for edge, up, down in LAG_EDGES:
                worst = 0.0
                for (tenant, part), lag in lags[edge].items():
                    if lag <= 0:
                        continue
                    t0 = self._touched.get(
                        (down, tenant, part),
                        self._touched.get((up, tenant, part), now))
                    worst = max(worst, now - t0)
                out[edge] = worst
            return out

    # -- export --------------------------------------------------------
    def export_gauges(self) -> None:
        """Write the lag surface through the cardinality guard:
        lag.<edge>.p<N> per partition (capped at the bounded() family
        limit), lag.<edge>.total, and lag_age_s.<edge>. The monitor's
        /metrics.prom pass renders these as fluid_lag_* gauges."""
        lags = self.lags()
        for edge, per in lags.items():
            for (_tenant, part), lag in sorted(per.items()):
                counters.gauge(
                    counters.bounded(f"lag.{edge}", f"p{part}"), lag)
            counters.gauge(f"lag.{edge}.total",
                           float(sum(per.values())))
        for edge, age in self.ages().items():
            counters.gauge(f"lag_age_s.{edge}", age)

    def snapshot(self) -> dict:
        """JSON-safe dump for /health and /fleet/lag: raw tier marks,
        per-edge lags keyed '<tenant>/p<partition>', totals, ages."""
        lags = self.lags()
        ages = self.ages()
        with self._lock:
            tiers: Dict[str, Dict[str, float]] = {}
            for (tier, tenant, part), val in sorted(self._marks.items()):
                tiers.setdefault(tier, {})[f"{tenant}/p{part}"] = val
        edges = {}
        for edge, per in lags.items():
            edges[edge] = {
                "perPartition": {f"{tenant}/p{part}": lag
                                 for (tenant, part), lag
                                 in sorted(per.items())},
                "total": float(sum(per.values())),
                "ageS": ages.get(edge, 0.0),
            }
        return {"tiers": tiers, "lags": edges}

    # -- lifecycle -----------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        with self._lock:
            self._clock = clock

    def reset(self) -> None:
        with self._lock:
            self._marks.clear()
            self._docs.clear()
            self._touched.clear()
            self._clock = time.monotonic


# Process-global table: tiers stamp it directly, the monitor and the
# fleet observatory read it. Tests isolate via reset().
table = WatermarkTable()

advance = table.advance
advance_doc = table.advance_doc
lags = table.lags
total_lag = table.total_lag
ages = table.ages
export_gauges = table.export_gauges
snapshot = table.snapshot
set_clock = table.set_clock


def reset() -> None:
    table.reset()
