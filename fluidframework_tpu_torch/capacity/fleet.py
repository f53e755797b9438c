"""The fleet soak: open-loop workload against the WHOLE pipeline.

Every tier smoke grades one stage in isolation; this driver runs the
full alfred→deli→broadcast→scribe→reader pipeline AT ONCE — sharded
ingest (server/sharding.py SequencerShardSet), sharded broadcast
fan-out, scribe summarization, and the catch-up read path — under one
seeded open-loop load model (capacity/workload.py) on the VIRTUAL
clock: arrivals land at their drawn virtual times whether or not the
server keeps up, drains are budgeted per partition per tick, and wall
time never enters a graded figure (the ingest-smoke overload
discipline, docs/capacity.md).

Chaos lives INSIDE the measured envelope: plan-driven partition
crash-restarts (the sequencer rebuilds from checkpoints and replays)
and reconnect avalanches (a burst of catch-up readers + subscriber
churn) draw from the injected FaultPlan-shaped ``plan``, so run-twice
is bit-identical — ``SoakResult.fingerprint()`` digests the workload
trace, the fault trace, every document's sequenced emit stream, and
the final per-document sequence numbers.

The plan is duck-typed (``pick``/``should_reset``/``fingerprint``) so
this layer never imports testing/; callers hand in a
testing.faultinject.FaultPlan.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..mergetree.client import OP_INSERT
from ..protocol.messages import DocumentMessage, MessageType
from ..server import admission as admission_mod
from ..server.admission import AdmissionController
from ..server.lambdas.base import IPartitionLambda
from ..server.local_server import DELTAS_TOPIC, LocalServer
from ..server.partition import PartitionManager
from ..telemetry import counters as _counters
from ..telemetry import watermarks
from ..telemetry.slo import BurnRateEngine, Objective

# Watermark lag edge -> soak tier name (the attribution vocabulary of
# tier_pressures): both read-side edges fold into "readpath".
LAG_EDGE_TIER = {"ingest": "ingest", "broadcast": "broadcast",
                 "summarize": "scribe", "catchup": "readpath",
                 "adopt": "readpath"}

OK_STATES = (admission_mod.ACCEPT, admission_mod.THROTTLE)

# The soak's private admission SLO stage. The default "serving.flush"
# window holds WALL-clock samples, and the first flushes' warm-up spike
# (kernel builds, allocator growth: p99/p50 in the thousands) would
# drive the ladder straight to DEGRADE the moment the queue un-mutes
# the latency term — grading wall noise, not load. The soak instead
# feeds this stage with VIRTUAL-time flush latencies (sequenced-tap
# flush vt minus submit vt), so ladder escalation under the grader is a
# pure function of the seeded workload. The window is cleared per run
# (reset_stage) so back-to-back grader probes in one process do not
# inherit residue.
FLUSH_STAGE = "capacity.flush"


@dataclass(frozen=True)
class FleetSpec:
    """Soak shape + budgets. Rates live in the WorkloadSpec; this is
    the serving side: topology, drain budgets, SLO thresholds, chaos
    cadence."""

    partitions: int = 2
    broadcaster_shards: int = 2
    broadcast_queue_limit: int = 4096
    subscribers_per_document: int = 2
    ticks: int = 48
    settle_ticks: int = 10
    drain_budget_per_partition: int = 48   # broker records per tick
    queue_limit: int = 1024
    partition_limit: Optional[int] = None
    catchup_refresh_every: int = 4         # ticks per artifact epoch
    # Chaos cadence (plan-driven; 0 disables the crash draw).
    crash_every: int = 16
    avalanche_readers: int = 24
    # SLO: ladder <= THROTTLE over the steady window, admitted-op flush
    # p99 under the virtual budget, the gate actually ABSORBING the
    # offered load (goodput: admitted/submitted over the steady window
    # — THROTTLE credit pacing sheds excess at the gate while internals
    # stay green, so without this term capacity is unbounded), and
    # (when the read tier serves artifacts) readers adopting instead of
    # tail-replaying.
    slo_flush_p99_s: float = 0.20
    slo_reader_adoption: float = 0.7
    slo_goodput: float = 0.95


@dataclass
class SoakResult:
    spec: FleetSpec
    workload_fp: str
    fault_fp: str
    duration_s: float                   # virtual
    steady_s: float                     # virtual, post-settle
    submitted: int = 0
    admitted: int = 0
    nacked: int = 0
    flushed: int = 0
    flushed_steady: int = 0
    submitted_steady: int = 0
    admitted_steady: int = 0
    flush_p50_ms: Optional[float] = None    # virtual ms, steady window
    flush_p99_ms: Optional[float] = None
    states: List[Tuple[int, str]] = field(default_factory=list)
    peak_backlog_global: int = 0
    peak_backlog_by_partition: Dict[int, int] = field(default_factory=dict)
    peak_broadcast_depth: int = 0
    peak_scribe_lag: int = 0
    partition_restarts: List[int] = field(default_factory=list)
    avalanches: int = 0
    reader_events: int = 0
    reader_events_steady: int = 0
    readers_adopted: int = 0
    readers_replayed: int = 0
    reader_residue_ops: int = 0
    refresh_epochs: int = 0
    refresh_dispatches: int = 0
    final_seq: Dict[str, int] = field(default_factory=dict)
    stream_digests: Dict[str, str] = field(default_factory=dict)
    broadcaster_shed: int = 0
    effective_partition_limit: int = 0
    wall_s: float = 0.0
    # Peak watermark lag per tier over the run (telemetry/watermarks
    # edges folded through LAG_EDGE_TIER) — the grader cites the losing
    # tier's figure — and the multi-window burn-rate verdict evaluated
    # on the virtual clock at the end of the measured envelope. Peaks
    # sample the threaded broadcast fan-out mid-flight, so they are
    # advisory citations, NOT part of the bit-identity fingerprint.
    tier_lags: Dict[str, float] = field(default_factory=dict)
    burn: Optional[dict] = None

    # -- graded figures ------------------------------------------------------
    @property
    def sustained_ops_per_sec(self) -> float:
        """Admitted-and-flushed ops per virtual second over the steady
        window — the open-loop capacity figure."""
        return self.flushed_steady / self.steady_s if self.steady_s else 0.0

    @property
    def readers_per_sec(self) -> float:
        return (self.reader_events_steady / self.steady_s
                if self.steady_s else 0.0)

    @property
    def reader_adoption(self) -> float:
        served = self.readers_adopted + self.readers_replayed
        return self.readers_adopted / served if served else 0.0

    @property
    def goodput(self) -> float:
        """Fraction of steady-window submits the gate admitted. 1.0
        when the offered load is fully absorbed; falls as THROTTLE
        credit pacing starts shedding at the gate."""
        return (self.admitted_steady / self.submitted_steady
                if self.submitted_steady else 1.0)

    def steady_states(self) -> List[str]:
        return [s for t, s in self.states
                if t >= self.spec.settle_ticks]

    # -- SLO -----------------------------------------------------------------
    def slo(self, grade_readers: bool = True) -> dict:
        """The capacity SLO: which components held over the steady
        window, and the verdict the grader binary-searches on."""
        spec = self.spec
        bad_states = sorted({s for s in self.steady_states()
                             if s not in OK_STATES})
        ladder_ok = not bad_states
        p99 = self.flush_p99_ms
        latency_ok = p99 is not None and p99 <= spec.slo_flush_p99_s * 1000.0
        served = self.readers_adopted + self.readers_replayed
        readers_graded = grade_readers and served > 0
        adoption_ok = (not readers_graded
                       or self.reader_adoption >= spec.slo_reader_adoption)
        goodput_ok = self.goodput >= spec.slo_goodput
        # Burn-rate term: a breach needs BOTH windows hot (slo.py), so
        # a run the point checks above pass cannot newly fail here —
        # sustained budget burn only confirms an overload verdict.
        burn_ok = self.burn is None or bool(self.burn.get("ok", True))
        return {
            "ladder_le_throttle": ladder_ok,
            "bad_states": bad_states,
            "flush_p99_ms": p99,
            "flush_p99_budget_ms": spec.slo_flush_p99_s * 1000.0,
            "flush_latency_ok": latency_ok,
            "goodput": round(self.goodput, 4),
            "goodput_ok": goodput_ok,
            "readers_graded": readers_graded,
            "reader_adoption": round(self.reader_adoption, 4),
            "reader_adoption_ok": adoption_ok,
            "burn_ok": burn_ok,
            "burn_attribution": (self.burn or {}).get("attribution"),
            "ok": (ladder_ok and latency_ok and goodput_ok
                   and adoption_ok and burn_ok),
        }

    # -- bottleneck attribution feed ----------------------------------------
    def tier_pressures(self) -> Dict[str, float]:
        """Normalized [~0, ~1+] pressure per tier from the run's own
        counters — the grader names the argmax as the binding
        bottleneck (docs/capacity.md)."""
        spec = self.spec
        part_limit = max(1, self.effective_partition_limit)
        peak_part = max(self.peak_backlog_by_partition.values() or [0])
        p99 = self.flush_p99_ms or 0.0
        served = self.readers_adopted + self.readers_replayed
        return {
            # The gate binds two ways: backlog filling the global queue,
            # or credit pacing shedding offered load (goodput shortfall)
            # — the larger of the two is the gate's pressure.
            "admission": max(
                self.peak_backlog_global / max(1, spec.queue_limit),
                1.0 - self.goodput),
            "ingest": peak_part / part_limit,
            "broadcast": (self.peak_broadcast_depth
                          / max(1, spec.broadcast_queue_limit)),
            "scribe": self.peak_scribe_lag / max(1, spec.queue_limit),
            "serving": p99 / max(1e-9, spec.slo_flush_p99_s * 1000.0),
            "readpath": (self.readers_replayed / served) if served else 0.0,
        }

    def fingerprint(self) -> str:
        """The run-twice bit-identity witness: every workload draw,
        every fault draw, every document's sequenced emit stream, and
        the final sequence numbers."""
        h = hashlib.sha256()
        h.update(self.workload_fp.encode())
        h.update(self.fault_fp.encode())
        for doc in sorted(self.final_seq):
            h.update(f"{doc}={self.final_seq[doc]}".encode())
            h.update(b"\x00")
            h.update(self.stream_digests.get(doc, "").encode())
            h.update(b"\x01")
        return h.hexdigest()

    def as_dict(self) -> dict:
        return {
            "duration_s": round(self.duration_s, 4),
            "submitted": self.submitted,
            "admitted": self.admitted,
            "nacked": self.nacked,
            "flushed": self.flushed,
            "goodput": round(self.goodput, 4),
            "sustained_ops_per_sec": round(self.sustained_ops_per_sec, 1),
            "readers_per_sec": round(self.readers_per_sec, 1),
            "flush_p50_ms": self.flush_p50_ms,
            "flush_p99_ms": self.flush_p99_ms,
            "steady_states": sorted(set(self.steady_states())),
            "peak_backlog_global": self.peak_backlog_global,
            "peak_backlog_by_partition": dict(
                self.peak_backlog_by_partition),
            "peak_broadcast_depth": self.peak_broadcast_depth,
            "peak_scribe_lag": self.peak_scribe_lag,
            "partition_restarts": list(self.partition_restarts),
            "avalanches": self.avalanches,
            "readers": {"events": self.reader_events,
                        "adopted": self.readers_adopted,
                        "replayed": self.readers_replayed,
                        "adoption": round(self.reader_adoption, 4),
                        "residue_ops": self.reader_residue_ops},
            "refresh": {"epochs": self.refresh_epochs,
                        "dispatches": self.refresh_dispatches},
            "broadcaster_shed": self.broadcaster_shed,
            "slo": self.slo(),
            "tier_pressures": {k: round(v, 4)
                               for k, v in self.tier_pressures().items()},
            "tier_lags": {k: round(v, 1)
                          for k, v in sorted(self.tier_lags.items())},
            "burn": self.burn,
            "fingerprint": self.fingerprint(),
            "wall_s": round(self.wall_s, 3),
        }


class _TapLambda(IPartitionLambda):
    """Deterministic sequenced-stream tap: its own consumer group over
    the deltas topic, pumped on the soak thread, so flush virtual-times
    and per-doc stream digests never depend on broadcaster worker
    scheduling."""

    def __init__(self, ctx, sink: Callable[[str, Any], None]):
        self.ctx = ctx
        self.sink = sink

    def handler(self, message) -> None:
        value = message.value
        if isinstance(value, tuple) and len(value) == 2:
            self.sink(value[0], value[1])
        # commit() stores "processed through offset" (next read starts
        # at offset+1) — commit the message's own offset.
        self.ctx.checkpoint(message.offset)


def default_server_factory(spec: FleetSpec,
                           adm: AdmissionController) -> LocalServer:
    """The scalar-pipeline fleet core (tests; bench builds the
    TpuLocalServer equivalent): manual pump, sharded ingest + sharded
    broadcast, admission injected with the soak's virtual clock."""
    return LocalServer(
        auto_pump=False, partitions=spec.partitions, admission=adm,
        config={"broadcaster.shards": spec.broadcaster_shards,
                "broadcaster.queueLimit": spec.broadcast_queue_limit})


class FleetSoak:
    """One open-loop soak run: consumes a WorkloadModel tick by tick
    against a freshly built server, chaos plan riding along, and
    returns a SoakResult. Single-use (build a new soak per run — the
    grader probes with a fresh server per offered rate)."""

    def __init__(self, workload, spec: Optional[FleetSpec] = None,
                 plan: Optional[Any] = None,
                 server_factory: Optional[
                     Callable[[FleetSpec, AdmissionController],
                              LocalServer]] = None):
        self.workload = workload
        self.spec = spec or FleetSpec()
        self.plan = plan
        self.server_factory = server_factory or default_server_factory
        self._used = False

    # -- the run -------------------------------------------------------------
    def run(self) -> SoakResult:
        if self._used:
            raise RuntimeError("FleetSoak is single-use; build a new one")
        self._used = True
        spec = self.spec
        wspec = self.workload.spec
        tick_s = wspec.tick_s
        vnow = {"t": 0.0}
        _counters.reset_stage(FLUSH_STAGE)
        # Fresh watermark table on the soak's virtual clock: the lag
        # pipeline is itself part of the graded surface (run-twice marks
        # fold into the fingerprint), and op-ages grade in virtual
        # seconds, never wall time.
        watermarks.reset()
        watermarks.set_clock(lambda: vnow["t"])
        burn = BurnRateEngine(
            [Objective("flush_latency", 0.99,
                       "admitted-op flush latency inside the virtual "
                       "p99 budget"),
             Objective("ingest_lag", 0.95,
                       "raw-log ingest lag stays under the global "
                       "queue limit")],
            clock=lambda: vnow["t"],
            fast_window_s=8 * tick_s,
            slow_window_s=max(8 * tick_s, spec.ticks * tick_s))
        flush_gb = {"good": 0, "bad": 0}
        budget_ms = spec.slo_flush_p99_s * 1000.0
        peak_lag: Dict[str, float] = {}
        # slo_ratio=4.0: virtual latencies land on the sub-slot grid
        # (tick_s/4 resolution), so a healthy same-tick flush already
        # shows p99/p50 up to 4x as a quantization artifact. 4.0 puts
        # the budget edge at one-full-tick spread and DEGRADE at 2x
        # that — genuine queueing delay, not grid noise.
        adm = AdmissionController(
            queue_limit=spec.queue_limit,
            partition_limit=spec.partition_limit,
            recover_after_s=0.5, interval_s=tick_s / 2,
            slo_stage=FLUSH_STAGE, slo_ratio=4.0,
            clock=lambda: vnow["t"])
        server = self.server_factory(spec, adm)
        tier = server.ingest
        catchup = getattr(server, "catchup", None)
        doc_ids = [f"soak-doc-{i}" for i in range(wspec.documents)]

        result = SoakResult(
            spec=spec, workload_fp="", fault_fp="",
            duration_s=spec.ticks * tick_s,
            steady_s=(spec.ticks - spec.settle_ticks) * tick_s,
            peak_backlog_by_partition={p: 0
                                       for p in range(spec.partitions)})

        # -- the deterministic sequenced-stream tap --------------------------
        last_seq = {d: 0 for d in doc_ids}
        submit_vt: Dict[Tuple[str, str, int], float] = {}
        flushed_lat: List[Tuple[float, float]] = []  # (submit_vt, flush_vt)
        digests = {d: hashlib.sha256() for d in doc_ids}
        # Wire client ids carry a per-process random suffix; the stream
        # digest uses the soak's own stable labels so run-twice
        # fingerprints compare the STREAM, not the uuid draw.
        cid_label: Dict[Any, str] = {None: "sys"}

        def tap_sink(doc_id: str, m: Any) -> None:
            if doc_id not in digests:
                return
            seq = m.sequence_number
            last_seq[doc_id] = seq
            digests[doc_id].update(
                f"{m.type}|{cid_label.get(m.client_id, '?')}"
                f"|{m.client_sequence_number}"
                f"|{seq}|{m.minimum_sequence_number};".encode())
            key = (doc_id, m.client_id, m.client_sequence_number)
            t0 = submit_vt.pop(key, None)
            if t0 is not None:
                result.flushed += 1
                flushed_lat.append((t0, vnow["t"]))
                lat_ms = (vnow["t"] - t0) * 1000.0
                _counters.observe(FLUSH_STAGE, lat_ms)
                flush_gb["good" if lat_ms <= budget_ms else "bad"] += 1

        tap = PartitionManager(server.log, "capacity-tap", DELTAS_TOPIC,
                               lambda ctx: _TapLambda(ctx, tap_sink))

        # -- writer + subscriber connections ---------------------------------
        conns: Dict[Tuple[str, int], Any] = {}
        csn: Dict[Tuple[str, int], int] = {}
        subscribers: Dict[str, List[Any]] = {d: [] for d in doc_ids}
        for d in doc_ids:
            for w in range(wspec.writers_per_document):
                c = server.connect(d)
                conns[(d, w)] = c
                csn[(d, w)] = 0
                cid_label[c.client_id] = f"w{w}"

                def on_nack(n, d=d, w=w):
                    result.nacked += 1
                    if n.operation is not None:
                        submit_vt.pop(
                            (d, conns[(d, w)].client_id,
                             n.operation.client_sequence_number), None)

                c.on("nack", on_nack)
            for _ in range(spec.subscribers_per_document):
                subscribers[d].append(server.connect(d, {"mode": "read"}))

        downstream = [m for m in (
            getattr(server, "_broadcaster_mgr", None),
            getattr(server, "_scriptorium_mgr", None),
            getattr(server, "_copier_mgr", None),
            getattr(server, "_scribe_mgr", None)) if m is not None]

        def pump_downstream() -> None:
            for mgr in downstream:
                mgr.pump_all()
            tap.pump_all()

        def drain_all() -> None:
            while True:
                n = sum(tier.manager.pumps[p].pump()
                        for p in sorted(tier.manager.pumps))
                tier.flush_acks()
                pump_downstream()
                if n == 0:
                    break

        drain_all()  # settle the joins before the measured envelope
        adm.observe(force=True)

        # -- per-tick machinery ----------------------------------------------
        # Head-insert merge-tree op in the raw runtime envelope: the
        # device pipeline materializes lanes for it, so catch-up
        # artifacts exist for the reader leg; the scalar deli carries
        # the contents opaquely. Position 0 is always valid, so no
        # client-side length tracking enters the driver.
        mt_op = {"address": "load", "contents": {
            "address": "text", "contents": {
                "type": OP_INSERT, "pos1": 0, "seg": {"text": "x"}}}}
        disp0 = _counters.get("catchup.refresh_dispatches")
        scribe_topic = server.log.topic(DELTAS_TOPIC)

        t_settled = spec.settle_ticks * tick_s

        def submit_write(doc_idx: int, writer: int) -> None:
            d = doc_ids[doc_idx % len(doc_ids)]
            w = writer % wspec.writers_per_document
            c = conns[(d, w)]
            csn[(d, w)] += 1
            n = csn[(d, w)]
            steady = vnow["t"] >= t_settled
            result.submitted += 1
            if steady:
                result.submitted_steady += 1
            submit_vt[(d, c.client_id, n)] = vnow["t"]
            nacked0 = result.nacked
            try:
                c.submit([DocumentMessage(
                    client_sequence_number=n,
                    reference_sequence_number=last_seq[d],
                    type=MessageType.OPERATION, contents=mt_op)])
            except ConnectionError:
                submit_vt.pop((d, c.client_id, n), None)
                return
            if result.nacked == nacked0:
                result.admitted += 1
                if steady:
                    result.admitted_steady += 1

        def serve_reader(doc_idx: int, steady: bool) -> None:
            d = doc_ids[doc_idx % len(doc_ids)]
            result.reader_events += 1
            if steady:
                result.reader_events_steady += 1
            art = (catchup.get(server.tenant_id, d,
                               head_seq=last_seq[d])
                   if catchup is not None else None)
            if art is not None:
                result.readers_adopted += 1
                result.reader_residue_ops += max(
                    0, last_seq[d] - int(art["seq"]))
            else:
                result.readers_replayed += 1

        def poll_peaks() -> None:
            backlogs = tier.raw_backlog_by_partition()
            for p, b in backlogs.items():
                result.peak_backlog_by_partition[p] = max(
                    result.peak_backlog_by_partition.get(p, 0), b)
            result.peak_backlog_global = max(result.peak_backlog_global,
                                             sum(backlogs.values()))
            result.peak_broadcast_depth = max(
                result.peak_broadcast_depth, server.broadcast_queue_depth())
            lag = sum(max(0, scribe_topic.partitions[p].end_offset
                          - server.log.committed("scribe", DELTAS_TOPIC, p))
                      for p in range(spec.partitions))
            result.peak_scribe_lag = max(result.peak_scribe_lag, lag)
            # Pull-model watermark refresh (raw offsets + ticketed seqs)
            # at the same boundaries the peaks sample, then fold each
            # edge's total into the per-tier peak-lag citation.
            refresh = getattr(tier, "refresh_watermarks", None)
            if refresh is not None:
                refresh()
            for edge, per in watermarks.lags().items():
                t_name = LAG_EDGE_TIER[edge]
                peak_lag[t_name] = max(peak_lag.get(t_name, 0.0),
                                       float(sum(per.values())))

        budget = spec.drain_budget_per_partition
        wall0 = time.perf_counter()
        for t in range(spec.ticks):
            start = t * tick_s
            steady = t >= spec.settle_ticks
            plan_tick = self.workload.tick()
            # Chaos draws ride the fault plan, INSIDE the envelope.
            extra_reads = 0
            if self.plan is not None:
                if spec.crash_every and (t + 1) % spec.crash_every == 0:
                    idx = self.plan.pick(spec.partitions + 1,
                                         site="partition-crash")
                    if idx < spec.partitions:
                        tier.restart_partition(idx)
                        result.partition_restarts.append(idx)
                if spec.avalanche_readers and self.plan.should_reset():
                    result.avalanches += 1
                    extra_reads = spec.avalanche_readers
            writes, reads = plan_tick.writes, plan_tick.reads
            wi = ri = 0
            for s in range(4):
                hi = (s + 1) / 4.0
                while wi < len(writes) and writes[wi].offset < hi:
                    ev = writes[wi]
                    vnow["t"] = start + ev.offset * tick_s
                    submit_write(ev.document, ev.writer)
                    wi += 1
                while ri < len(reads) and reads[ri].offset < hi:
                    ev = reads[ri]
                    vnow["t"] = start + ev.offset * tick_s
                    serve_reader(ev.document, steady)
                    ri += 1
                vnow["t"] = start + hi * tick_s
                poll_peaks()
                for p in sorted(tier.manager.pumps):
                    tier.pump_partition(
                        p, (budget * (s + 1)) // 4 - (budget * s) // 4)
                tier.flush_acks()
                pump_downstream()
            # Avalanche reconnects land at the tick edge: churn one
            # subscriber and slam the catch-up path with a reader burst.
            if extra_reads:
                d_idx = self.plan.pick(len(doc_ids), site="avalanche-doc")
                d = doc_ids[d_idx]
                if subscribers[d]:
                    subscribers[d].pop(0).disconnect()
                    subscribers[d].append(
                        server.connect(d, {"mode": "read"}))
                for _ in range(extra_reads):
                    serve_reader(self.plan.pick(len(doc_ids),
                                                site="avalanche-read"),
                                 steady)
            vnow["t"] = start + tick_s
            if (spec.catchup_refresh_every and catchup is not None
                    and (t + 1) % spec.catchup_refresh_every == 0):
                server.refresh_catchup()
                result.refresh_epochs += 1
            adm.observe(force=True)
            result.states.append((t, adm.state))
            # Burn-rate feed, once per tick on the virtual clock: the
            # tick's flush good/bad split and whether ingest lag stayed
            # under the global queue limit.
            burn.record("flush_latency", good=flush_gb["good"],
                        bad=flush_gb["bad"])
            flush_gb["good"] = flush_gb["bad"] = 0
            ingest_lag = watermarks.total_lag("ingest")
            ok_lag = ingest_lag <= spec.queue_limit
            burn.record("ingest_lag", good=1 if ok_lag else 0,
                        bad=0 if ok_lag else 1)

        # -- converge: drain everything left, chaos off ----------------------
        drain_all()
        if catchup is not None:
            server.refresh_catchup()
            result.refresh_epochs += 1
        server.drain_broadcast(20.0)
        result.refresh_dispatches = (_counters.get(
            "catchup.refresh_dispatches") - disp0)
        result.wall_s = time.perf_counter() - wall0
        # Final watermark refresh so the exported lag surface reconciles
        # with the drained pipeline; the burn verdict is evaluated at
        # virtual end-of-run, then the table's clock goes back to wall
        # time for whoever scrapes it next.
        refresh = getattr(tier, "refresh_watermarks", None)
        if refresh is not None:
            refresh()
        for edge, per in watermarks.lags().items():
            t_name = LAG_EDGE_TIER[edge]
            peak_lag[t_name] = max(peak_lag.get(t_name, 0.0),
                                   float(sum(per.values())))
        result.tier_lags = dict(peak_lag)
        result.burn = burn.evaluate(now=vnow["t"])
        watermarks.set_clock(time.monotonic)

        # -- figures ---------------------------------------------------------
        steady_lat = sorted((f1 - f0) * 1000.0
                            for f0, f1 in flushed_lat if f0 >= t_settled)
        result.flushed_steady = len(steady_lat)
        if steady_lat:
            result.flush_p50_ms = round(
                _counters.nearest_rank(steady_lat, 0.50), 3)
            result.flush_p99_ms = round(
                _counters.nearest_rank(steady_lat, 0.99), 3)
        result.effective_partition_limit = (
            adm.partition_limit()
            or max(1, spec.queue_limit // max(1, spec.partitions)))
        # The controller observes mid-burst (the admit hot path polls
        # it between sub-slot boundaries), so its own peak sees depth
        # the boundary-sampled poll above can miss. Attribution grades
        # on the larger of the two.
        result.peak_backlog_global = max(result.peak_backlog_global,
                                         adm.peak_queue_depth)
        result.final_seq = dict(last_seq)
        result.stream_digests = {d: h.hexdigest()
                                 for d, h in digests.items()}
        result.workload_fp = self.workload.fingerprint()
        result.fault_fp = (self.plan.fingerprint()
                           if self.plan is not None else "")
        result.broadcaster_shed = sum(
            b.stats().get("shed", 0)
            for b in getattr(server, "broadcasters", []))
        # Reap the fan-out worker threads: the grader builds a fresh
        # server per probed rate and shard workers must not accumulate.
        for b in getattr(server, "broadcasters", []):
            b.close()
        return result
