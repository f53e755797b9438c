"""The chaos-on capacity grade, run the same way on either package.

`grade` runs the whole-pipeline capacity soak (capacity/fleet.py) the way
bench.py's e2e smoke does (bench.py:3629-3720): a seeded open-loop
workload over a TpuLocalServer with sharded ingest, sharded broadcast,
scribe summaries and the catch-up read path, partition crash-restarts and
reconnect avalanches drawn from a FaultPlan inside the measured envelope.
The CapacityGrader bisects the offered-rate multiplier for the highest
rate whose SLO holds, and the capacity point then runs twice. Everything
graded is on the soak's virtual clock, so the result compares by
equality across runs, devices and packages.

The scenario takes a `CapacityPackage`: the capacity package, the
testing/faultinject module and the server/local_server module of one
package, plus keyword arguments for TpuLocalServer (device="cuda" or
"cpu" for the port). chip_smoke.py phase 22 runs it on the card and, in
a child process, on the CPU; tests/test_torch_capacity_golden.py runs it
through the JAX package to build testing/golden/capacity_golden.json.
Apart from `port_package`, which loads the port's modules, this module
needs neither torch nor JAX.

Sections:

- CAPACITY_SMALL is bench's e2e-smoke shape (bench.py:3665-3673): 12
  documents, 2 writers each, 600 writes/s and 150 catch-up reads/s at
  1x, 2 partitions and 2 broadcaster shards, 40 ticks of 20 ms (10 to
  settle), a crash draw every 16 ticks, 16 avalanche readers; FaultPlan
  seed 31 with reset 0.06; the grader over [0.5, 6.0] in 4 bisections.
  Nothing is cut.
- CAPACITY_CARD is the same shape at 256 documents and 32 ticks: every
  rate, drain budget, queue limit and the avalanche-reader count is the
  small one's times 256/12, rounded, so each document carries the load
  it carries in the small shape; the seeds, the settle ticks, the
  topology and the grader's range stay. Two cuts, for chip_smoke.py
  phase 22's time, whose CPU twin grades the same section on the CPU:
  512 documents (phase 17's size) to 256, because at 512 the fault plan
  (seed 31) draws no crash-restart in any soak (the 683-reader
  avalanches consume its draws between the crash ticks;
  tests/test_torch_capacity.py replays a section's draws) and the twin
  would not finish inside the
  script; then 40 ticks to 32, which keeps the crash-restart (tick 31)
  and the 3 avalanches and takes a fifth off the twin and the card.

Three things the reference's soak leaves to timing are pinned for the
run, the same way in both packages, so that two runs compare by equality:

- The broadcaster's shard workers deliver on their own threads, so the
  fan-out queue depth the soak samples (the broadcast pressure, and the
  admission ladder's read-tier occupancy source) depends on how far the
  workers got. Here every downstream pump of the broadcaster waits for
  its shards to drain (`drain_broadcast`), so at every sample point the
  fan-out of the messages sequenced so far has been delivered.
- Ghost-client eviction reads the wall clock (`deli.clientTimeoutMsec`
  0 turns it off): a soak that outlasts the timeout would sequence
  leaves for idle writers.
- The sequenced-stream digests label clients by the soak's own writer
  labels (the reference does this), so `uuid` needs no pin.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, List, NamedTuple, Optional

from .server_runs import _Cfg

# Broadcast fan-out drains this long at most before the run is refused.
DRAIN_TIMEOUT_S = 120.0
CARD_DOCS = 256
CARD_TICKS = 32


class CapacityPackage(NamedTuple):
    capacity: Any       # the capacity package
    faultinject: Any    # testing/faultinject module
    local_server: Any   # server/local_server module
    kwargs: dict        # extra TpuLocalServer arguments (device=...)


def port_package(device) -> CapacityPackage:
    """The port's CapacityPackage on `device` (its modules import torch,
    so they load here, on the first call)."""
    from .. import capacity
    from ..server import local_server
    from . import faultinject
    return CapacityPackage(capacity, faultinject, local_server,
                           {"device": device})


class Section(NamedTuple):
    """One capacity scenario: WorkloadSpec and FleetSpec arguments, the
    fault plan and the grader's range."""
    workload: dict
    fleet: dict
    plan_seed: int = 31
    reset: float = 0.06
    lo: float = 0.5
    hi: float = 6.0
    iters: int = 4


CAPACITY_SMALL = Section(
    workload=dict(documents=12, writers_per_document=2, seed=29,
                  writer_rate_per_s=600.0, reader_rate_per_s=150.0,
                  zipf_s=1.0, tick_s=0.02),
    fleet=dict(partitions=2, broadcaster_shards=2,
               broadcast_queue_limit=4096, subscribers_per_document=2,
               ticks=40, settle_ticks=10, drain_budget_per_partition=24,
               queue_limit=512, crash_every=16, avalanche_readers=16))


def scaled_section(section: Section, documents: int,
                   ticks: Optional[int] = None) -> Section:
    """`section` at `documents` (and `ticks`, if given), with every rate,
    drain budget, queue limit and the avalanche-reader count scaled by
    documents / the section's documents (rounded), so each document
    carries the load it carries in the small shape."""
    k = documents / section.workload["documents"]
    w = dict(section.workload, documents=documents)
    for key in ("writer_rate_per_s", "reader_rate_per_s"):
        w[key] = float(round(section.workload[key] * k))
    f = dict(section.fleet, ticks=ticks or section.fleet["ticks"])
    for key in ("broadcast_queue_limit", "drain_budget_per_partition",
                "queue_limit", "avalanche_readers"):
        f[key] = int(round(section.fleet[key] * k))
    return section._replace(workload=w, fleet=f)


CAPACITY_CARD = scaled_section(CAPACITY_SMALL, CARD_DOCS, CARD_TICKS)


SECTIONS = {"small": CAPACITY_SMALL, "card": CAPACITY_CARD}


def config(fleet) -> dict:
    """bench's TpuLocalServer configuration (bench.py:3675-3680) with the
    ghost-eviction clock off (module docstring)."""
    return {"broadcaster.shards": fleet.broadcaster_shards,
            "broadcaster.queueLimit": fleet.broadcast_queue_limit,
            "catchup.enabled": True,
            "deli.clientTimeoutMsec": 0}


def _sync_broadcast(server) -> None:
    """Make each downstream pump of the broadcaster return only once its
    shards have delivered (module docstring)."""
    mgr = server._broadcaster_mgr
    pump_all = mgr.pump_all

    def pump_all_delivered(*args, **kwargs):
        n = pump_all(*args, **kwargs)
        if not server.drain_broadcast(DRAIN_TIMEOUT_S):
            raise RuntimeError(
                f"broadcast fan-out did not drain in {DRAIN_TIMEOUT_S} s")
        return n

    mgr.pump_all = pump_all_delivered


def server_factory(pkg: CapacityPackage, tpu: bool = True,
                   on_server: Optional[Callable[[Any], None]] = None):
    """The soak's server factory: bench's TpuLocalServer (or the scalar
    LocalServer) with the pins above; `on_server` sees each server built
    (chip_smoke.py counts kernel launches per path through it)."""
    ls = pkg.local_server

    def factory(fleet, adm):
        cls, kwargs = (ls.TpuLocalServer, pkg.kwargs) if tpu \
            else (ls.LocalServer, {})
        server = cls(auto_pump=False, partitions=fleet.partitions,
                     admission=adm, config=_Cfg(config(fleet)), **kwargs)
        _sync_broadcast(server)
        if on_server is not None:
            on_server(server)
        return server

    return factory


def soak(pkg: CapacityPackage, section: Section, mult: float,
         tpu: bool = True, on_server=None):
    """One FleetSoak run of `section` at `mult` times its offered rate,
    with a fresh workload model and fault plan (the grader's determinism
    contract: the same mult gives the same run)."""
    cap = pkg.capacity
    model = cap.WorkloadModel(cap.WorkloadSpec(**section.workload)
                              .scaled(mult))
    plan = pkg.faultinject.FaultPlan(seed=section.plan_seed,
                                     reset=section.reset)
    return cap.FleetSoak(model, cap.FleetSpec(**section.fleet), plan=plan,
                         server_factory=server_factory(
                             pkg, tpu, on_server)).run()


def soak_record(result) -> dict:
    """A SoakResult's graded figures (its as_dict without the wall time)."""
    out = result.as_dict()
    out.pop("wall_s")
    return out


def grade(section: Section, device=None, pkg: Optional[CapacityPackage] = None,
          tpu: bool = True, on_server=None) -> dict:
    """Grade `section`, then run the capacity point twice (bench.py:
    3682-3707). `pkg` defaults to the port on `device` (None means the
    card, which raises without CUDA). Returns the comparable record
    (`comparable`) plus `wall_s`: the grade's and each soak's wall time."""
    if pkg is None:
        pkg = port_package(device)
    walls: List[float] = []

    def timed_soak(mult):
        t0 = time.perf_counter()
        r = soak(pkg, section, mult, tpu, on_server)
        walls.append(time.perf_counter() - t0)
        return r

    def probe(mult):
        r = timed_soak(mult)
        slo = r.slo(grade_readers=tpu)
        return {"ok": slo["ok"], "pressures": r.tier_pressures(),
                "tier_lags": r.tier_lags, "slo": slo,
                "sustained_ops_per_sec": r.sustained_ops_per_sec,
                "readers_per_sec": r.readers_per_sec}

    t0 = time.perf_counter()
    g = pkg.capacity.CapacityGrader(probe, lo=section.lo, hi=section.hi,
                                    iters=section.iters).search()
    grade_wall = time.perf_counter() - t0
    final_a = timed_soak(g.capacity_mult)
    final_b = timed_soak(g.capacity_mult)
    return {
        "grade": dict(g.as_dict(), probes=[
            {"rate_mult": s.rate_mult, "ok": s.ok,
             "pressures": s.sample["pressures"],
             "tier_lags": s.sample["tier_lags"],
             "slo": s.sample["slo"],
             "sustained_ops_per_sec": s.sample["sustained_ops_per_sec"],
             "readers_per_sec": s.sample["readers_per_sec"]}
            for s in g.history]),
        "fingerprints": [final_a.fingerprint(), final_b.fingerprint()],
        "final_seq": final_a.final_seq,
        "stream_digests": final_a.stream_digests,
        "partition_restarts": final_a.partition_restarts,
        "avalanches": final_a.avalanches,
        "final": soak_record(final_a),
        "final_b": soak_record(final_b),
        "wall_s": {"grade": grade_wall, "soaks": walls},
    }


def comparable(record: dict) -> dict:
    """The part of a grade record that must be equal across runs,
    devices and packages: all of it but the wall times, in its JSON form
    (as the golden file holds it: integer keys become strings)."""
    return json.loads(json.dumps(
        {k: v for k, v in record.items() if k != "wall_s"}, sort_keys=True))

