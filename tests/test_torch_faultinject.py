"""The port's fault-injection harness (fluidframework_tpu_torch/testing/
faultinject.py) and the chaos cases that use it, mirrored from the JAX
package's tests and held against the JAX package with zero tolerance:

- tests/test_admission.py: FaultPlan, FaultyMessageLog, SkewedClock, the
  stall helper, and a faulty raw log under LocalServer;
- tests/test_rebalance.py TestRebalanceChaos and tests/
  test_sharded_ingest.py TestPartitionCrashChaos: crash-restarts drawn
  from the plan (`crash_partition`) beside live handoffs and faulty
  deliveries;
- tests/test_pipelined_serving.py:443 and tests/test_paged_memory.py:439:
  a plan-drawn device stall through the sequencer lambda's `stall_hook`,
  with a recording sleep;
- tests/test_watermarks.py TestSoakReconciliation: the watermark table
  reconciled with a chaos-on fleet soak.

Each chaos run goes through both packages; the fault fingerprints, the
sequenced streams and the sequence numbers must be equal across packages
as well as across two runs of one seed.
"""

from __future__ import annotations

import hashlib
from importlib import import_module
from types import SimpleNamespace

import pytest
import torch

from fluidframework_tpu.testing import faultinject as jfi
from fluidframework_tpu_torch.server.admission import (ACCEPT, DEGRADE,
                                                       AdmissionController)
from fluidframework_tpu_torch.telemetry import counters as port_counters
from fluidframework_tpu_torch.testing import faultinject, ingest

from test_torch_sequencer_fast import _keystroke_waves
from test_torch_sequencer_lambda import Pair, assert_same, doc_names, drive

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global: the flushes
    these tests drive must not reach another file's /health verdict on
    the same worker (tests/conftest.py resets only the JAX package's)."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


def package(name: str) -> SimpleNamespace:
    port = name == "fluidframework_tpu_torch"
    return SimpleNamespace(
        name=name,
        messages=import_module(f"{name}.protocol.messages"),
        local_server=import_module(f"{name}.server.local_server"),
        faultinject=import_module(f"{name}.testing.faultinject"),
        tpu_kw={"device": "cpu"} if port else {})


PACKAGES = [package("fluidframework_tpu_torch"), package("fluidframework_tpu")]


def both(run, *args):
    """run(pkg, *args) on the port and on JAX; the two must be equal."""
    port, ref = (run(pkg, *args) for pkg in PACKAGES)
    assert port == ref
    return port


class TestFaultPlan:
    def test_same_seed_same_fingerprint(self):
        def run(mod, seed):
            plan = mod.FaultPlan(seed, drop=0.2, dup=0.2, delay=0.2,
                                 reset=0.3, stall=0.4)
            for _ in range(200):
                plan.delivery()
                plan.should_reset()
                plan.stall_s()
                plan.pick(7)
            return plan.fingerprint(), plan.trace

        assert run(faultinject, 42) == run(faultinject, 42) \
            == run(jfi, 42)
        assert run(faultinject, 42)[0] != run(faultinject, 43)[0]

    def test_trace_records_every_decision(self):
        plan = faultinject.FaultPlan(1, drop=1.0)
        plan.delivery()
        plan.should_reset()
        assert [a for _, a in plan.trace] == ["drop", "ok"]

    def test_delay_sends_within_bound(self):
        plan = faultinject.FaultPlan(7, delay=1.0, max_delay_sends=3)
        ref = jfi.FaultPlan(7, delay=1.0, max_delay_sends=3)
        for _ in range(50):
            action, k = plan.delivery()
            assert action == faultinject.DELAY
            assert 1 <= k <= 3
            assert (action, k) == ref.delivery()

    def test_stall_range(self):
        plan = faultinject.FaultPlan(3, stall=1.0, stall_range_ms=(1, 2))
        ref = jfi.FaultPlan(3, stall=1.0, stall_range_ms=(1, 2))
        for _ in range(20):
            s = plan.stall_s()
            assert 0.001 <= s <= 0.002
            assert s == ref.stall_s()
        none = faultinject.FaultPlan(3, stall=0.0)
        assert none.stall_s() == 0.0


class _RecLog:
    """Recording MessageLog stand-in: captures every delivered send."""

    def __init__(self):
        self.sent = []

    def send(self, topic, key, value):
        self.sent.append((topic, key, value))
        return len(self.sent)

    def send_to(self, topic, partition, key, value):
        self.sent.append((topic, partition, key, value))
        return len(self.sent)

    def committed(self, group, topic, partition):
        return 0


class TestFaultyMessageLog:
    def test_drop_never_reaches_inner(self):
        log = faultinject.FaultyMessageLog(
            _RecLog(), faultinject.FaultPlan(1, drop=1.0))
        log.send("rawdeltas", "d", "v")
        assert log.inner.sent == []

    def test_dup_delivers_twice(self):
        log = faultinject.FaultyMessageLog(
            _RecLog(), faultinject.FaultPlan(1, dup=1.0))
        log.send("rawdeltas", "d", "v")
        assert log.inner.sent == [("rawdeltas", "d", "v")] * 2

    def test_delay_release_order_and_flush(self):
        def run(mod):
            log = mod.FaultyMessageLog(
                _RecLog(), mod.FaultPlan(5, delay=1.0, max_delay_sends=2))
            for i in range(4):
                log.send("rawdeltas", "d", i)
            held = log.held_count
            before = list(log.inner.sent)
            released = log.flush_delayed()
            assert released == held
            assert log.held_count == 0
            assert sorted(v for _, _, v in log.inner.sent) == [0, 1, 2, 3]
            return before, log.inner.sent

        assert run(faultinject) == run(jfi)

    def test_batched_sends_draw_per_record(self):
        """send_to_many rides the schedule one draw per record, exactly
        as the same number of send_to calls do."""
        def run(mod, batched):
            log = mod.FaultyMessageLog(
                _RecLog(), mod.FaultPlan(8, drop=0.3, dup=0.3, delay=0.2))
            items = [(f"k{i}", i) for i in range(24)]
            if batched:
                log.send_to_many("rawdeltas", 1, items)
            else:
                for k, v in items:
                    log.send_to("rawdeltas", 1, k, v)
            log.flush_delayed()
            return log.plan.fingerprint(), log.inner.sent

        assert run(faultinject, True) == run(faultinject, False) \
            == run(jfi, True)

    def test_non_fault_topics_bypass_the_plan(self):
        plan = faultinject.FaultPlan(1, drop=1.0)
        log = faultinject.FaultyMessageLog(_RecLog(), plan)
        log.send("deltas", "d", "v")
        assert log.inner.sent == [("deltas", "d", "v")]
        assert plan.trace == []  # no decision drawn

    def test_delegates_everything_else(self):
        log = faultinject.FaultyMessageLog(
            _RecLog(), faultinject.FaultPlan(1))
        assert log.committed("deli", "rawdeltas", 0) == 0


class TestSkewedClock:
    def test_offset_and_drift_are_exact(self):
        t = {"n": 100.0}
        clock = faultinject.SkewedClock(skew_s=5.0, drift=0.01,
                                        base=lambda: t["n"])
        ref = jfi.SkewedClock(skew_s=5.0, drift=0.01, base=lambda: t["n"])
        assert clock() == pytest.approx(105.0)
        t["n"] = 110.0
        assert clock() == pytest.approx(115.1) == ref()

    def test_admission_controller_survives_skew(self):
        t = {"n": 0.0}
        clock = faultinject.SkewedClock(skew_s=3600.0, drift=0.05,
                                        base=lambda: t["n"])
        depth = {"n": 0}
        ctl = AdmissionController(queue_limit=1000, recover_after_s=0.5,
                                  interval_s=0.01, clock=clock)
        ctl.add_source("s", queue_depth=lambda: depth["n"])
        depth["n"] = 990
        t["n"] += 0.02
        ctl.observe(force=True)
        assert ctl.state == DEGRADE
        depth["n"] = 0
        for _ in range(200):
            t["n"] += 0.02
            ctl.observe(force=True)
        assert ctl.state == ACCEPT

    def test_stall_helper_draws_and_sleeps(self):
        plan = faultinject.FaultPlan(9, stall=1.0, stall_range_ms=(1, 1))
        slept = []
        s = faultinject.stall(plan, sleep=slept.append)
        assert s == pytest.approx(0.001)
        assert slept == [s]


def _faulty_stream(pkg, seed):
    """tests/test_admission.py TestFaultDeterminismThroughServer: boxcars
    straight onto a faulty raw log under the scalar LocalServer."""
    M, fi = pkg.messages, pkg.faultinject
    srv = pkg.local_server.LocalServer(auto_pump=False)
    plan = fi.FaultPlan(seed, drop=0.15, dup=0.15, delay=0.2)
    srv.log = fi.FaultyMessageLog(srv.log, plan)
    conn = srv.connect("d")
    seen = []
    conn.on("op", lambda m: seen.append(
        (m.sequence_number, m.client_sequence_number)))
    srv.pump()
    for i in range(1, 41):
        srv.log.send("rawdeltas", "d", M.Boxcar(
            tenant_id="local", document_id="d", client_id=conn.client_id,
            contents=[M.DocumentMessage(
                client_sequence_number=i, reference_sequence_number=0,
                type=M.MessageType.OPERATION, contents={"i": i})]))
        srv.pump()
    srv.log.flush_delayed()
    srv.pump()
    return plan.fingerprint(), seen


def test_same_seed_same_sequenced_stream_through_server():
    a = both(_faulty_stream, 99)
    assert a == _faulty_stream(PACKAGES[0], 99)
    assert a[1]  # faults thinned, not silenced, the stream


def _op(M, csn, ref=0):
    return M.DocumentMessage(
        client_sequence_number=csn, reference_sequence_number=ref,
        type=M.MessageType.OPERATION,
        contents={"pos": 0, "text": "x", "kind": "insert", "channel": "t"})


def _chaos_fleet(pkg, server, plan, docs, rounds, every):
    """Writers on `docs`, one op a document a round; `every(i)` runs the
    round's chaos. Returns the fault fingerprint, the digest of every
    document's sequenced stream and the final sequence numbers."""
    M = pkg.messages
    digest = hashlib.sha256()
    conns, last = {}, {d: 0 for d in docs}
    for d in docs:
        c = server.connect(d)
        conns[d] = c
        c.on("op", lambda m, d=d: (
            digest.update(f"{d}:{m.sequence_number}:"
                          f"{m.client_sequence_number};".encode()),
            last.__setitem__(d, m.sequence_number)))
    server.pump()
    csn = {d: 0 for d in docs}
    for i in range(rounds):
        for d in docs:
            csn[d] += 1
            conns[d].submit([_op(M, csn[d], ref=last[d])])
        server.pump()
        every(i)
    server.log.flush_delayed()
    server.pump()
    return (plan.fingerprint(), digest.hexdigest(),
            tuple(server.sequence_number(d) for d in docs))


def _rebalance_chaos(pkg, seed):
    """tests/test_rebalance.py TestRebalanceChaos: crashes interleaved
    with live handoffs, dup and delay faults (drop=0: the handoff records
    ride the raw topic durably)."""
    fi = pkg.faultinject
    plan = fi.FaultPlan(seed, drop=0.0, dup=0.05, delay=0.1)
    server = pkg.local_server.LocalServer(partitions=4, auto_pump=False)
    server.log = fi.FaultyMessageLog(server.log, plan)
    server.ingest.log = server.log
    docs = [f"rc-{i}" for i in range(5)]

    def chaos(i):
        if i % 6 == 2:
            d = docs[(i // 6) % len(docs)]
            cur = server.ingest.partition_for(d)
            server.rebalance_document(d, (cur + 1) % 4)
        if i % 7 == 4:
            fi.crash_partition(plan, server.ingest.manager)
            server.pump()

    return _chaos_fleet(pkg, server, plan, docs, 24, chaos)


def _crash_chaos(pkg, seed):
    """tests/test_sharded_ingest.py TestPartitionCrashChaos: a 4-partition
    TpuLocalServer whose pumps the plan crash-restarts (the lambda
    rebuilds from its partition-scoped checkpoints and replays)."""
    fi = pkg.faultinject
    plan = fi.FaultPlan(seed, drop=0.05, dup=0.05, delay=0.1)
    server = pkg.local_server.TpuLocalServer(partitions=4, auto_pump=False,
                                             **pkg.tpu_kw)
    server.log = fi.FaultyMessageLog(server.log, plan)
    docs = [f"c{i}" for i in range(6)]

    def chaos(i):
        if i % 7 == 3:
            fi.crash_partition(plan, server.ingest.manager)
            server.pump()

    return _chaos_fleet(pkg, server, plan, docs, 30, chaos)


@pytest.mark.parametrize("scenario, seed", [(_rebalance_chaos, 4242),
                                            (_crash_chaos, 777)])
class TestPartitionChaos:
    def test_run_twice_bit_identical(self, scenario, seed):
        a = both(scenario, seed)
        assert a == scenario(PACKAGES[0], seed)
        assert all(s > 0 for s in a[2])

    def test_different_seed_differs(self, scenario, seed):
        assert scenario(PACKAGES[0], seed)[0] != \
            scenario(PACKAGES[0], seed + 1)[0]


def _stalled_pair(waves, seed, stall_range_ms, sleeps, **kw):
    """A Pair whose lambdas each draw a device stall from their own plan
    (same seed) at the top of every flush, into a recording sleep."""
    pair = Pair(**kw)
    pair.set(pipelined=True, fused_bursts=True, adaptive_window=False)
    plans = {}
    for side, mod in ((pair.torch, faultinject), (pair.jax, jfi)):
        plan = plans[side.package] = mod.FaultPlan(
            seed=seed, stall=1.0, stall_range_ms=stall_range_ms)
        slept = sleeps.setdefault(side.package, [])
        side.lam.stall_hook = (lambda plan=plan, mod=mod, slept=slept:
                               mod.stall(plan, sleep=slept.append))
    drive(pair, waves, raw=True)
    return pair, plans


@pytest.mark.parametrize("paged, seed, stall_range_ms", [
    (False, 1234, (0.1, 0.4)),    # tests/test_pipelined_serving.py:443
    (True, 4242, (0.05, 0.2)),    # tests/test_paged_memory.py:439
])
def test_plan_stall_through_stall_hook_is_deterministic(paged, seed,
                                                        stall_range_ms):
    """A FaultPlan device stall at every flush while bursts accumulate
    reproduces bit for bit from its seed: the same fault fingerprint, the
    same emitted stream and views (equal to JAX's), run twice; the stall
    reaches the recording sleep once a flush."""
    waves = _keystroke_waves(n_waves=8)
    docs = doc_names(waves)
    runs = []
    for _ in range(2):
        sleeps = {}
        pair, plans = _stalled_pair(waves, seed, stall_range_ms, sleeps,
                                    paged_lanes=paged)
        got = assert_same(pair, docs)
        assert plans["torch"].fingerprint() == plans["jax"].fingerprint()
        assert sleeps["torch"] == sleeps["jax"]
        assert len(sleeps["torch"]) == len(waves)
        lo, hi = stall_range_ms
        assert all(lo / 1e3 <= s <= hi / 1e3 for s in sleeps["torch"])
        if not paged:
            assert pair.torch.counter_deltas()["serving.bursts"] > 0
        else:
            assert pair.torch.lam.merge.paged_stats() == \
                pair.jax.lam.merge.paged_stats()
        runs.append((plans["torch"].fingerprint(), got,
                     list(pair.torch.emits)))
    assert runs[0] == runs[1]


def test_stall_hook_is_off_by_default():
    pair = Pair()
    assert pair.torch.lam.stall_hook is None is pair.jax.lam.stall_hook
    frames = [(0, "d0", ingest.boxcar("t", "d0", "c0", [ingest.join("c0")]))]
    calls = []
    pair.torch.lam.stall_hook = lambda: calls.append(1) or 0.0
    drive(pair, [frames], raw=True)
    assert calls == [1]


SOAK_WORKLOAD = dict(documents=4, writers_per_document=2, seed=23,
                     writer_rate_per_s=300.0, reader_rate_per_s=80.0,
                     tick_s=0.02)
SOAK_FLEET = dict(partitions=2, broadcaster_shards=2,
                  subscribers_per_document=1, ticks=24, settle_ticks=6,
                  drain_budget_per_partition=16, queue_limit=256,
                  crash_every=8, avalanche_readers=6)


def _watermark_soak(pkg):
    """tests/test_watermarks.py's chaos-on soak, then the table."""
    cap = import_module(f"{pkg.name}.capacity")
    wm = import_module(f"{pkg.name}.telemetry.watermarks")
    r = cap.FleetSoak(cap.WorkloadModel(cap.WorkloadSpec(**SOAK_WORKLOAD)),
                      cap.FleetSpec(**SOAK_FLEET),
                      plan=pkg.faultinject.FaultPlan(seed=31,
                                                     reset=0.08)).run()
    tiers = wm.snapshot()["tiers"]
    return r, wm, {t: tiers.get(t) for t in (
        "raw_end", "raw_ingested", "ticketed", "summarized", "catchup",
        "adopted")}


class TestSoakReconciliation:
    """The lag gauges reconcile with the pipeline's own seq and offset
    deltas on a seeded sharded fleet, chaos on, run twice, on both
    packages."""

    def test_ticketed_mark_equals_final_sequence_numbers(self):
        r, wm, _ = _watermark_soak(PACKAGES[0])
        ticketed = sum(wm.table.mark(wm.TICKETED, p)
                       for p in range(SOAK_FLEET["partitions"]))
        assert ticketed == sum(r.final_seq.values()) > 0

    def test_ingest_drained_to_zero_lag(self):
        _, wm, _ = _watermark_soak(PACKAGES[0])
        assert wm.total_lag("ingest") == 0

    def test_run_twice_marks_are_bit_identical(self):
        # Deterministic tiers: raw offsets and the sequencer, summary,
        # catch-up and adoption seqs (broadcast is threaded fan-out).
        a = _watermark_soak(PACKAGES[0])
        b = _watermark_soak(PACKAGES[0])
        ref = _watermark_soak(PACKAGES[1])
        assert a[2] == b[2] == ref[2]
        assert a[0].fingerprint() == b[0].fingerprint() \
            == ref[0].fingerprint()

    def test_broadcast_reconciles_after_drain_when_nothing_shed(self):
        r, wm, _ = _watermark_soak(PACKAGES[0])
        assert r.broadcaster_shed == 0
        for p in range(SOAK_FLEET["partitions"]):
            assert (wm.table.mark(wm.BROADCAST, p)
                    == wm.table.mark(wm.TICKETED, p))

    def test_soak_cites_tier_lags_and_burn_verdict(self):
        r, _, _ = _watermark_soak(PACKAGES[0])
        assert set(r.tier_lags) <= {"ingest", "broadcast", "scribe",
                                    "readpath"}
        assert r.burn is not None and "objectives" in r.burn
        d = r.as_dict()
        assert "tier_lags" in d and "burn" in d
        assert "burn_ok" in d["slo"]
