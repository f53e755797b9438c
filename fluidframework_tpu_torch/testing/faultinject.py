"""Seeded deterministic fault injection for the server pipeline.

The soak/chaos suites and the overload bench need failure modes beyond
in-process chaos seeds: lost/duplicated/delayed broker deliveries,
connection resets, slow-device stalls, and clock skew. This module
provides them with one hard guarantee: **every decision is drawn from a
single seeded RNG in call order and appended to ``plan.trace``**, so a
scenario replayed with the same seed and the same call sequence
reproduces bit-identically — the suites assert
``plan_a.fingerprint() == plan_b.fingerprint()`` (and the overload
smoke stamps the verdict into its BENCH record).

Pieces:

  FaultPlan          the seeded decision source (probabilities + trace)
  FaultyMessageLog   MessageLog wrapper injecting broker-delivery faults
                     (drop / duplicate / delay-by-k-sends) on selected
                     topics; delegates everything else
  SkewedClock        monotonic-like clock with constant offset + drift
                     (admission-controller clock injection)
  stall()            slow-device stall helper for the sequencer's
                     ``stall_hook``

Faults are injected on the PRODUCE side (``send``), which models the
broker losing/reordering deliveries while keeping consumer offset
arithmetic exact — a dropped message simply never enters the partition,
a duplicate appends twice, a delayed message appends k sends later (or
at ``flush_delayed()``).
"""

from __future__ import annotations

import hashlib
import random
import time
from typing import Callable, List, Optional, Tuple

from ..telemetry.counters import increment

DELIVER = "deliver"
DROP = "drop"
DUP = "dup"
DELAY = "delay"


class FaultPlan:
    """Deterministic, seeded fault schedule. All probabilities are
    evaluated in a FIXED draw order per decision, so two plans with the
    same seed and parameters make identical choices forever."""

    def __init__(self, seed: int, drop: float = 0.0, dup: float = 0.0,
                 delay: float = 0.0, max_delay_sends: int = 3,
                 reset: float = 0.0, stall: float = 0.0,
                 stall_range_ms: Tuple[float, float] = (0.5, 4.0),
                 skew_s: float = 0.0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.drop = drop
        self.dup = dup
        self.delay = delay
        self.max_delay_sends = max(1, int(max_delay_sends))
        self.reset = reset
        self.stall = stall
        self.stall_range_ms = stall_range_ms
        self.skew_s = skew_s
        self.trace: List[Tuple[str, str]] = []

    def _record(self, site: str, action: str) -> None:
        self.trace.append((site, action))
        increment(f"faultinject.{action}")

    # -- decision draws (one rng consumption path per call) -----------------
    def delivery(self) -> Tuple[str, int]:
        """(action, delay_sends) for the next broker delivery."""
        r = self.rng.random()
        if r < self.drop:
            self._record("delivery", DROP)
            return DROP, 0
        if r < self.drop + self.dup:
            self._record("delivery", DUP)
            return DUP, 0
        if r < self.drop + self.dup + self.delay:
            k = self.rng.randrange(1, self.max_delay_sends + 1)
            self._record("delivery", f"{DELAY}:{k}")
            return DELAY, k
        self._record("delivery", DELIVER)
        return DELIVER, 0

    def should_reset(self) -> bool:
        """Connection-reset decision (the reconnect-avalanche driver)."""
        hit = self.rng.random() < self.reset
        self._record("reset", "reset" if hit else "ok")
        return hit

    def stall_s(self) -> float:
        """Slow-device stall duration for the next flush (0.0 = none)."""
        if self.rng.random() >= self.stall:
            self._record("stall", "none")
            return 0.0
        lo, hi = self.stall_range_ms
        ms = lo + self.rng.random() * (hi - lo)
        self._record("stall", f"stall:{ms:.3f}ms")
        return ms / 1000.0

    def pick(self, n: int, site: str = "pick") -> int:
        """Deterministic index choice (which client resets, which doc a
        burst targets) — recorded like every other decision."""
        i = self.rng.randrange(n)
        self._record(site, str(i))
        return i

    def fingerprint(self) -> str:
        """Stable digest of every decision made so far — the
        bit-identity witness two same-seed runs must agree on."""
        h = hashlib.sha256()
        for site, action in self.trace:
            h.update(site.encode())
            h.update(b"\x00")
            h.update(action.encode())
            h.update(b"\x01")
        return h.hexdigest()


class FaultyMessageLog:
    """MessageLog wrapper injecting plan-driven broker faults on
    ``send`` for the listed topics (default: the raw ingest topic).
    Reads/commits/offsets delegate untouched, so partition pumps and
    checkpoint replay behave exactly as against the real log."""

    def __init__(self, inner, plan: FaultPlan,
                 topics: Tuple[str, ...] = ("rawdeltas",)):
        self.inner = inner
        self.plan = plan
        self.fault_topics = frozenset(topics)
        # Delayed deliveries: (due_send_ordinal, topic, partition, key,
        # value) with partition None for keyed sends, released in due
        # order before later sends (deterministic).
        self._held: List[Tuple[int, str, Optional[int], str, object]] = []
        self._sends = 0

    # -- producer (the injection point) -------------------------------------
    def send(self, topic: str, key: str, value):
        return self._faulty_send(topic, None, key, value)

    def send_to(self, topic: str, partition: int, key: str, value):
        """Explicit-partition produce rides the SAME fault schedule as
        keyed sends — the sharded ingest tier (server/sharding.py)
        routes documents itself, and its traffic must stay inside the
        chaos envelope, not silently bypass it via __getattr__."""
        return self._faulty_send(topic, int(partition), key, value)

    def send_to_many(self, topic: str, partition: int, items):
        """Batched produce decomposes to one fault draw PER record —
        send_to_many(t, p, xs) must sit in exactly the same chaos
        envelope as len(xs) send_to calls, or batch-path callers would
        silently dodge injected drops/dups/delays (and break run-twice
        fingerprint identity between batched and unbatched drivers)."""
        return [self._faulty_send(topic, int(partition), key, value)
                for key, value in items]

    def _faulty_send(self, topic: str, partition: Optional[int], key: str,
                     value):
        if topic not in self.fault_topics:
            return self._deliver(topic, partition, key, value)
        self._sends += 1
        self._release_due()
        action, k = self.plan.delivery()
        if action == DROP:
            return None
        if action == DUP:
            self._deliver(topic, partition, key, value)
            return self._deliver(topic, partition, key, value)
        if action == DELAY:
            self._held.append((self._sends + k, topic, partition, key,
                               value))
            return None
        return self._deliver(topic, partition, key, value)

    def _deliver(self, topic: str, partition: Optional[int], key: str,
                 value):
        if partition is None:
            return self.inner.send(topic, key, value)
        return self.inner.send_to(topic, partition, key, value)

    def _release_due(self) -> None:
        if not self._held:
            return
        due = [h for h in self._held if h[0] <= self._sends]
        if not due:
            return
        self._held = [h for h in self._held if h[0] > self._sends]
        for _, topic, partition, key, value in due:
            self._deliver(topic, partition, key, value)

    def flush_delayed(self) -> int:
        """Deliver every still-held message (scenario teardown: nothing
        may stay lost-in-flight before the convergence assert)."""
        held, self._held = self._held, []
        for _, topic, partition, key, value in held:
            self._deliver(topic, partition, key, value)
        return len(held)

    @property
    def held_count(self) -> int:
        return len(self._held)

    # -- everything else delegates ------------------------------------------
    def __getattr__(self, item):
        return getattr(self.inner, item)


class SkewedClock:
    """A monotonic-like clock with constant offset and linear drift —
    what a fleet node with a bad NTP sync looks like to the admission
    controller. Deterministic when ``base`` is (tests inject a virtual
    counter)."""

    def __init__(self, skew_s: float = 0.0, drift: float = 0.0,
                 base: Callable[[], float] = time.monotonic):
        self.skew_s = skew_s
        self.drift = drift
        self.base = base
        self._t0 = base()

    def __call__(self) -> float:
        t = self.base()
        return t + self.skew_s + self.drift * (t - self._t0)


def crash_partition(plan: FaultPlan, manager,
                    site: str = "partition-crash"):
    """Partition-worker crash chaos: deterministically pick one of a
    PartitionManager's pumps (or none) from the plan and crash-restart
    it — the lambda is rebuilt from its checkpoint store and the pump
    replays from the last committed offset, exactly the recovery the
    sharded ingest tier promises (docs/ingest_sharding.md). The draw is
    recorded in the plan trace, so run-twice fingerprints pin both WHEN
    a crash happened and WHICH partition it hit. Returns the crashed
    partition index, or None for the no-crash draw."""
    pumps = sorted(manager.pumps)
    idx = plan.pick(len(pumps) + 1, site=site)
    if idx == len(pumps):
        return None  # the no-crash slot — crashes stay occasional
    manager.pumps[pumps[idx]].restart()
    return pumps[idx]


def stall(plan: FaultPlan,
          sleep: Callable[[float], None] = time.sleep) -> float:
    """Slow-device stall hook body: draw a stall from the plan and sleep
    it (tests pass a recording `sleep` to keep wall time at zero).
    Attach as ``sequencer.stall_hook = lambda: faultinject.stall(plan)``.
    Returns the stall applied (seconds)."""
    s = plan.stall_s()
    if s > 0:
        sleep(s)
    return s
