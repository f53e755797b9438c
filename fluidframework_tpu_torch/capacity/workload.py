"""Seeded open-loop workload models for the fleet capacity soak.

The per-tier smokes drive hand-rolled fixed-rate schedules; this module
is the ONE arrival-process implementation in the tree (docs/capacity.md).
It models load the way the Pulsar enterprise-scale study does
(PAPERS.md): OPEN LOOP — arrivals happen at their drawn virtual times
whether or not the server keeps up, so overload shows up as queue growth
and ladder escalation instead of silently stretching a closed loop's
busy time.

Determinism contract (the same one testing/faultinject.py FaultPlan
keeps): **every draw flows through one seeded RNG in a fixed call order
and is appended to ``model.trace``**, so two models with the same seed
and the same ``tick()`` call sequence produce bit-identical event
streams — ``fingerprint()`` is the witness the run-twice gates compare.

Pieces:

  OpMix             the stress rig's weighted op-kind draw (shared with
                    testing/load_test.py — the fold that keeps one op-mix
                    implementation in the tree)
  poisson_draw      Knuth Poisson sampler over an injected RNG
  ZipfPopularity    rank-frequency document popularity (hot-doc skew)
  PoissonArrivals   memoryless open-loop arrivals at a fixed mean rate
  OnOffArrivals     bursty two-state (Markov on/off) arrivals
  WorkloadModel     the composed writer/catch-up-reader mix, one RNG,
                    traced, replayable
"""

from __future__ import annotations

import bisect
import hashlib
import math
import random
from dataclasses import dataclass, field, replace
from typing import Iterator, List, Sequence, Tuple

OP_KINDS = ("map", "insert", "remove", "counter")

POISSON = "poisson"
BURSTY = "bursty"


class OpMix:
    """The load rig's op-kind mix: one weighted draw per op, consuming
    the caller's RNG exactly as ``rng.choices(kinds, weights)`` does —
    testing/load_test.py folds onto this so a profile replayed against
    either driver picks the same kinds in the same order."""

    def __init__(self, weights: Sequence[float] = (4, 3, 1, 2),
                 kinds: Sequence[str] = OP_KINDS):
        if len(weights) != len(kinds):
            raise ValueError("one weight per op kind")
        self.weights = tuple(weights)
        self.kinds = tuple(kinds)

    def draw(self, rng: random.Random) -> str:
        return rng.choices(self.kinds, weights=self.weights)[0]


def closed_loop_schedule(documents: int, clients_per_document: int,
                         ops_per_client: int
                         ) -> Iterator[Tuple[int, int, int]]:
    """The stress rig's closed-loop schedule: (doc, op, client) triples
    in the exact nesting order testing/load_test.py has always driven
    (per doc, op rounds over clients round-robin) — kept here so the
    rig and the soak share one schedule definition."""
    for d in range(documents):
        for op_index in range(ops_per_client):
            for client_index in range(clients_per_document):
                yield d, op_index, client_index


def poisson_draw(rng: random.Random, lam: float) -> int:
    """Knuth's Poisson sampler over the injected RNG (no numpy: every
    draw must ride the model's one seeded RNG). Large means split into
    <=50 chunks so exp(-lam) never underflows."""
    if lam <= 0.0:
        return 0
    k = 0
    remaining = lam
    while remaining > 0.0:
        step = min(remaining, 50.0)
        remaining -= step
        limit = math.exp(-step)
        prod = rng.random()
        while prod > limit:
            k += 1
            prod *= rng.random()
    return k


class ZipfPopularity:
    """Zipf(s) rank-frequency popularity over n documents: document i
    (0-ranked) drawn with weight 1/(i+1)^s — the hot-document skew real
    collaboration fleets show. s=0 degenerates to uniform. One
    ``rng.random()`` per draw (CDF + bisect), so the consumption is a
    fixed one-draw-per-event schedule."""

    def __init__(self, n: int, s: float = 1.0):
        if n < 1:
            raise ValueError("need at least one document")
        self.n = n
        self.s = float(s)
        weights = [1.0 / (i + 1) ** self.s for i in range(n)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0  # guard float drift at the top bin
        self._cdf = cdf

    def draw(self, rng: random.Random) -> int:
        return bisect.bisect_left(self._cdf, rng.random())


class PoissonArrivals:
    """Memoryless open-loop arrivals: count per tick ~ Poisson(rate*dt)."""

    def __init__(self, rate_per_s: float):
        self.rate_per_s = float(rate_per_s)

    def draw_count(self, rng: random.Random, dt_s: float) -> int:
        return poisson_draw(rng, self.rate_per_s * dt_s)


class OnOffArrivals:
    """Bursty two-state arrivals (Markov-modulated Poisson): ON ticks
    arrive at ``rate_on`` (chosen so the LONG-RUN mean matches the
    requested rate), OFF ticks arrive at zero; state flips with the
    per-tick transition probabilities. One transition draw + one count
    draw per tick — fixed RNG consumption."""

    def __init__(self, rate_per_s: float, p_on_off: float = 0.18,
                 p_off_on: float = 0.30, start_on: bool = True):
        self.rate_per_s = float(rate_per_s)
        self.p_on_off = p_on_off
        self.p_off_on = p_off_on
        self.on = start_on
        # Stationary P(on) = p_off_on / (p_on_off + p_off_on); scale the
        # burst rate so the delivered mean stays the requested rate.
        duty = p_off_on / max(1e-9, (p_on_off + p_off_on))
        self.rate_on = self.rate_per_s / max(1e-9, duty)

    def draw_count(self, rng: random.Random, dt_s: float) -> int:
        flip = rng.random()
        if self.on and flip < self.p_on_off:
            self.on = False
        elif not self.on and flip < self.p_off_on:
            self.on = True
        if not self.on:
            return 0
        return poisson_draw(rng, self.rate_on * dt_s)


@dataclass(frozen=True)
class WorkloadSpec:
    """The load model: an open-loop writer stream + an open-loop
    catch-up-reader stream over a Zipf-popular document fleet."""

    documents: int = 16
    writers_per_document: int = 2
    seed: int = 0
    arrival: str = POISSON          # POISSON | BURSTY
    writer_rate_per_s: float = 800.0    # fleet-wide op submissions/s
    reader_rate_per_s: float = 200.0    # fleet-wide catch-up connects/s
    zipf_s: float = 1.0
    tick_s: float = 0.02
    op_weights: Tuple[float, ...] = (4, 3, 1, 2)

    def scaled(self, mult: float) -> "WorkloadSpec":
        """The grader's probe knob: the same model shape at ``mult``
        times the offered rate (writers and readers together)."""
        return replace(self, writer_rate_per_s=self.writer_rate_per_s * mult,
                       reader_rate_per_s=self.reader_rate_per_s * mult)


@dataclass(frozen=True)
class WriteEvent:
    offset: float          # arrival position within the tick, [0, 1)
    document: int
    writer: int


@dataclass(frozen=True)
class ReadEvent:
    offset: float
    document: int


@dataclass
class TickPlan:
    index: int
    writes: List[WriteEvent] = field(default_factory=list)
    reads: List[ReadEvent] = field(default_factory=list)


class WorkloadModel:
    """The seeded, traced event source the fleet soak consumes tick by
    tick. All draws (arrival counts, in-tick offsets, Zipf document
    picks, writer picks) ride ONE ``random.Random(seed)`` in a fixed
    per-tick order and land in ``trace`` — replaying the same seed for
    the same number of ticks is bit-identical, and ``fingerprint()``
    digests the whole decision history."""

    def __init__(self, spec: WorkloadSpec):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.trace: List[Tuple[str, str]] = []
        self.popularity = ZipfPopularity(spec.documents, spec.zipf_s)
        if spec.arrival == BURSTY:
            self.writer_arrivals = OnOffArrivals(spec.writer_rate_per_s)
        elif spec.arrival == POISSON:
            self.writer_arrivals = PoissonArrivals(spec.writer_rate_per_s)
        else:
            raise ValueError(f"unknown arrival model {spec.arrival!r}")
        self.reader_arrivals = PoissonArrivals(spec.reader_rate_per_s)
        self.ticks = 0

    def _record(self, site: str, action: str) -> None:
        self.trace.append((site, action))

    def tick(self) -> TickPlan:
        """Draw one tick's arrivals. Writer events: (offset, Zipf doc,
        uniform writer). Reader events: (offset, Zipf doc). Sorted by
        offset with draw order as the tiebreak (sort is stable)."""
        spec = self.spec
        plan = TickPlan(index=self.ticks)
        nw = self.writer_arrivals.draw_count(self.rng, spec.tick_s)
        self._record("writes", str(nw))
        for _ in range(nw):
            ev = WriteEvent(
                offset=self.rng.random(),
                document=self.popularity.draw(self.rng),
                writer=self.rng.randrange(spec.writers_per_document))
            self._record("w", f"{ev.document}:{ev.writer}")
            plan.writes.append(ev)
        nr = self.reader_arrivals.draw_count(self.rng, spec.tick_s)
        self._record("reads", str(nr))
        for _ in range(nr):
            ev = ReadEvent(offset=self.rng.random(),
                           document=self.popularity.draw(self.rng))
            self._record("r", str(ev.document))
            plan.reads.append(ev)
        plan.writes.sort(key=lambda e: e.offset)
        plan.reads.sort(key=lambda e: e.offset)
        self.ticks += 1
        return plan

    def fingerprint(self) -> str:
        """Stable digest of every draw made so far (the FaultPlan
        idiom) — the replayability witness."""
        h = hashlib.sha256()
        for site, action in self.trace:
            h.update(site.encode())
            h.update(b"\x00")
            h.update(action.encode())
            h.update(b"\x01")
        return h.hexdigest()
