"""Service entrypoints: the deployment wiring (docker-compose analog).

The reference runs every lambda as its own service against the Kafka
broker (server/docker-compose.yml:2-55; `kafka-service/index.js <name>
<lambda>` per service). The equivalent here:

    python -m fluidframework_tpu_torch.server.main broker  --config deploy/config.json
    python -m fluidframework_tpu_torch.server.main worker  --config deploy/config.json
    python -m fluidframework_tpu_torch.server.main worker  --stages scriptorium,scribe ...
    python -m fluidframework_tpu_torch.server.main historian --config deploy/config.json

- `broker` hosts the ordered log (pure-Python or the native C++ engine)
  over gRPC (server/log_service.py) — the Kafka role.
- `worker` runs any subset of lambda stages over RemoteMessageLog against
  the broker, with durable sqlite checkpoints/deltas and a file-backed git
  store (server/durable.py) — the per-lambda service role. `--stages
  tpu-deli` swaps the scalar sequencer for the device-batched
  TpuSequencerLambda (server/tpu_sequencer.py), on the card unless
  `worker.device` names another device (`"cpu"` for the plain PyTorch
  versions).
- `historian` runs the standalone summary-cache tier
  (server/historian.py) over the shared git directory (or proxying an
  alfred URL via `historian.upstream`); scribe workers notify it on
  summary commits when `historian.url` points at it.

Deli nacks publish to the `nacks` topic (the front door consumes it and
routes to the offending client's socket); sequenced deltas flow through
the `deltas` topic exactly as in-process. Crash/restart semantics are the
lambda host's: offsets commit with checkpoints, replay is idempotent.

See deploy/RUNBOOK.md for topology, scaling, and failure handling.

A port of fluidframework_tpu's server/main.py: run it as `python -m
fluidframework_tpu_torch.server.main SERVICE`.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from typing import List, Optional

RAW_TOPIC = "rawdeltas"
DELTAS_TOPIC = "deltas"
NACKS_TOPIC = "nacks"

DEFAULT_CONFIG = {
    # monitorPort > 0 serves /health + /metrics.prom on the broker
    # process — the durable engine's group-commit counters
    # (fluid_durable_fsyncs_total, fluid_durable_batch_bytes, the
    # durable.group_commit latency histogram) live HERE, not in the
    # workers, so the observatory must scrape the broker to see them.
    "broker": {"host": "127.0.0.1", "port": 7080, "native": False,
               "partitions": 1, "monitorPort": 0},
    "storage": {"db": "var/fluid.sqlite", "git": "var/git"},
    # monitorPort > 0 serves /health + /metrics.prom + /trace for the
    # fleet observatory to scrape; `name` tags every exported span with
    # this process identity (default worker:<stages>); traceSample > 0
    # head-samples 1-in-N op traces in this worker.
    # `partitions`: null pumps every broker partition (single-host
    # shape); a list like [0,1,2,3] makes this worker pump ONLY those
    # raw-topic partitions — the cross-host placement config (two
    # workers owning [0..7] and [8..15] against one remote broker ARE
    # the 16-partition ingest tier; deploy/RUNBOOK.md multi-host
    # recipe). Applies to the sequencing stage (deli/tpu-deli).
    # `device`: where a tpu-deli stage keeps its ticket table and lanes;
    # null means "cuda" and raises without CUDA.
    "worker": {"stages": ["deli", "scriptorium", "scribe", "copier"],
               "poll_ms": 10, "tenant": "local", "monitorPort": 0,
               "name": None, "traceSample": 0, "partitions": None,
               "device": None},
    # The fleet observatory (server/observatory.py): scrapes each
    # worker's monitor endpoints on intervalS, merges /fleet/health,
    # /fleet/metrics.prom, /fleet/lag, and joins drained trace rings by
    # traceId into /fleet/trace. `workers` lists monitor base URLs.
    "observatory": {"host": "127.0.0.1", "port": 7090, "workers": [],
                    "intervalS": 2.0},
    "deli": {"checkpointBatchSize": 8, "checkpointTimeIntervalMsec": 500},
    # The summary-cache tier (server/historian.py). `historian` service:
    # host/port to serve on; upstream (alfred URL) switches store mode ->
    # proxy mode; monitorPort exposes /health+/metrics with the cache
    # counters. Workers: a non-empty `url` makes scribe notify the tier
    # on every summary commit (write-through invalidation).
    "historian": {"host": "127.0.0.1", "port": 7081, "upstream": None,
                  "url": None, "refTtlS": 2.0,
                  "maxBytes": 256 * 1024 * 1024, "monitorPort": 0},
    # Read-tier catch-up artifact push-through (server/readpath.py
    # ArtifactPushThrough, docs/read_path.md): a `tpu-deli` worker with a
    # configured historian url pushes refreshed artifacts to the tier's
    # /historian/catchup route on this cadence — default ON; connecting
    # clients then get summary + artifact in one round trip without the
    # worker in the path.
    "catchup": {"push": True, "intervalS": 0.25},
}


def load_config(path: Optional[str]) -> dict:
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))  # deep copy
    if path:
        with open(path) as f:
            loaded = json.load(f)
        for key, value in loaded.items():
            if isinstance(value, dict):
                cfg.setdefault(key, {}).update(value)
            else:
                cfg[key] = value
    return cfg


class _ConfigView:
    """Dotted-key accessor over the config dict (the nconf role —
    services-core/src/lambdas.ts:56 passes each lambda its config slice)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def get(self, dotted: str, default=None):
        node = self.cfg
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def run_broker(cfg: dict) -> None:
    from .log import make_message_log
    from .log_service import LogServiceServer

    bcfg = cfg["broker"]
    log_dir = cfg.get("storage", {}).get("log")
    if log_dir:
        # Durable broker: partitions + offsets persist to disk, a restart
        # resumes with full history (server/durable.py DurableMessageLog).
        from .durable import DurableMessageLog
        log = DurableMessageLog(log_dir,
                                default_partitions=bcfg.get("partitions", 1))
    else:
        log = make_message_log(default_partitions=bcfg.get("partitions", 1),
                               native=bcfg.get("native", False))
    log.topic(RAW_TOPIC)
    log.topic(DELTAS_TOPIC)
    log.topic(NACKS_TOPIC)
    server = LogServiceServer(log, port=bcfg.get("port", 7080))
    server.start()
    print(f"broker: serving ordered log on {server.address}", flush=True)
    monitor = None
    if bcfg.get("monitorPort"):
        from .monitor import ServiceMonitor
        # The broker holds nothing on the card: /profile traces the CPU.
        monitor = ServiceMonitor(host=bcfg.get("host", "127.0.0.1"),
                                 port=bcfg["monitorPort"], device="cpu")
        monitor.watch_durable("broker", log)
        monitor.start()
        print(f"broker: monitor on {monitor.url}", flush=True)
    _wait_for_signal()
    if monitor is not None:
        monitor.stop()
    server.stop()


def run_historian(cfg: dict) -> None:
    from .historian import HistorianService

    hcfg = cfg.get("historian", {})
    store = None
    upstream = hcfg.get("upstream")
    if not upstream:
        from .durable import FileHistorian
        store = FileHistorian(cfg["storage"]["git"])
    service = HistorianService(
        upstream_url=upstream, store=store,
        host=hcfg.get("host", "127.0.0.1"), port=hcfg.get("port", 7081),
        max_bytes=hcfg.get("maxBytes", 256 * 1024 * 1024),
        ref_ttl_s=hcfg.get("refTtlS", 2.0))
    service.start()
    print(f"historian: serving cache tier on {service.url} "
          f"({'proxy' if upstream else 'store'} mode)", flush=True)
    monitor = None
    if hcfg.get("monitorPort"):
        from .monitor import ServiceMonitor
        # The cache tier holds nothing on the card: /profile traces the
        # CPU.
        monitor = ServiceMonitor(host=hcfg.get("host", "127.0.0.1"),
                                 port=hcfg["monitorPort"], device="cpu")
        monitor.watch_historian("historian", service)
        monitor.start()
        print(f"historian: monitor on {monitor.url}", flush=True)
    _wait_for_signal()
    if monitor is not None:
        monitor.stop()
    service.stop()


def build_worker(cfg: dict, stages: List[str]):
    """Wire the requested lambda stages over the remote log + durable
    services. Returns (runner, close_fn).

    A `tpu-deli` stage resolves `worker.device` first (None means "cuda"),
    so a worker asked for the card on a host without one raises before it
    opens the log or the database."""
    from ..core.device import resolve_device
    from .durable import FileHistorian, SqliteDatabaseManager
    from .lambdas import (
        BroadcasterLambda,
        CopierLambda,
        DeliLambda,
        ScribeLambda,
        ScriptoriumLambda,
    )
    from .lambdas.scriptorium import delta_key
    from .log_service import RemoteMessageLog
    from .partition import LambdaRunner, PartitionManager
    from .routing import doc_shard
    from ..protocol.messages import Boxcar

    device = (resolve_device(cfg["worker"].get("device"))
              if "tpu-deli" in stages else None)
    bcfg = cfg["broker"]
    address = f"{bcfg.get('host', '127.0.0.1')}:{bcfg.get('port', 7080)}"
    log = RemoteMessageLog(address,
                           default_partitions=bcfg.get("partitions", 1))
    db = SqliteDatabaseManager(cfg["storage"]["db"])
    historian = FileHistorian(cfg["storage"]["git"])
    tenant = cfg["worker"].get("tenant", "local")
    deltas = db.collection("deltas", unique_key=delta_key)
    raw_deltas = db.collection("rawdeltas")
    deli_ckpt = db.collection("deliCheckpoints")
    scribe_ckpt = db.collection("scribeCheckpoints")
    view = _ConfigView(cfg)

    # Explicit-partition produce through the shared md5 router
    # (server/routing.py): a worker's system messages (deli ghost
    # evictions, scribe acks) and sequenced emits must land on the SAME
    # partition the front door routes the document to — the broker's
    # own key hash is never consulted on a sharded topology.
    n_parts = int(bcfg.get("partitions", 1))

    def emit_sequenced(doc_id, sequenced):
        log.send_to(DELTAS_TOPIC, doc_shard(doc_id, n_parts), doc_id,
                    (doc_id, sequenced))

    def emit_nack(doc_id, client_id, nack):
        log.send_to(NACKS_TOPIC, doc_shard(doc_id, n_parts), doc_id,
                    (doc_id, client_id, nack))

    def send_system(doc_id, message):
        log.send_to(RAW_TOPIC, doc_shard(doc_id, n_parts), doc_id, Boxcar(
            tenant_id=tenant, document_id=doc_id, client_id=None,
            contents=[message]))

    # Sequencer checkpoints are PARTITION-SCOPED (server/sharding.py
    # PartitionCheckpoints): with partitions > 1, N lambdas over one
    # raw collection would clobber each other's tpu-sequencer row, and
    # every scalar deli restart would adopt every OTHER partition's
    # documents.
    from .sharding import PartitionCheckpoints

    # Cross-host placement: a worker owning a partition subset pumps
    # only ITS slice of the raw topic against the shared remote broker.
    owned_partitions = cfg["worker"].get("partitions")
    if owned_partitions is not None:
        owned_partitions = [int(p) for p in owned_partitions]

    runner = LambdaRunner()
    for stage in stages:
        if stage == "deli":
            runner.add(PartitionManager(
                log, "deli", RAW_TOPIC,
                lambda ctx: DeliLambda(
                    ctx, emit=emit_sequenced,
                    nack=emit_nack,
                    checkpoints=PartitionCheckpoints(deli_ckpt,
                                                     ctx.partition),
                    fresh_log=False, config=view,
                    send_system=send_system),
                auto_commit=False, partitions=owned_partitions))
        elif stage == "tpu-deli":
            from .tpu_sequencer import TpuSequencerLambda

            def make_tpu_deli(ctx):
                lam = TpuSequencerLambda(
                    ctx, emit=emit_sequenced, nack=emit_nack,
                    checkpoints=PartitionCheckpoints(deli_ckpt,
                                                     ctx.partition),
                    deltas=deltas,
                    config=view, send_system=send_system, device=device)
                # Batched emit: ONE deltas-topic produce per fast flush
                # window (downstream lambdas fan it out), matching the
                # reference's per-message produce amortized per window.
                # Produced to the SAME partition index the window's source
                # documents hash to (raw and deltas topics share the
                # partition count), so per-doc ordering and consumer
                # affinity hold with multi-partition brokers.
                lam.emit_window = lambda w, p=ctx.partition: log.send_to(
                    DELTAS_TOPIC, p, "__window__", w)
                return lam

            deli_mgr = runner.add(PartitionManager(
                log, "deli", RAW_TOPIC, make_tpu_deli, auto_commit=False,
                partitions=owned_partitions))

            # Catch-up artifact push-through (default-on): refreshed
            # artifacts land in the historian tier's catch-up cache so
            # clients connecting through the historian adopt `summary +
            # delta` in one round trip (docs/read_path.md). The supplier
            # reads LIVE lambdas from the manager's pumps — a crashed/
            # restarted partition's replacement lambda is picked up, the
            # dead one dropped. A worker without a historian url (or
            # with catchup.push=false) runs exactly as before.
            historian_url = cfg.get("historian", {}).get("url")
            if historian_url and view.get("catchup.push", True):
                from .historian import notify_catchup_refresh
                from .readpath import ArtifactPushThrough

                push = ArtifactPushThrough(
                    sequencers=lambda m=deli_mgr: [
                        p.lambda_ for p in m.pumps.values()],
                    scribe_checkpoints=scribe_ckpt,
                    historian=historian,
                    tenant_id=tenant,
                    publish=lambda t, d, a, _url=historian_url:
                        notify_catchup_refresh(_url, t, d, a),
                    interval_s=float(view.get("catchup.intervalS", 0.25)))
                runner.add_ticker(push.pump)
        elif stage == "scriptorium":
            runner.add(PartitionManager(
                log, "scriptorium", DELTAS_TOPIC,
                lambda ctx: ScriptoriumLambda(ctx, deltas)))
        elif stage == "scribe":
            # A configured historian tier hears about every commit the
            # scribe acks (write-through invalidation + warm prefetch);
            # without one (or with it down) the notify is a no-op.
            historian_url = cfg.get("historian", {}).get("url")
            on_commit = None
            if historian_url:
                from .historian import notify_summary_commit

                def on_commit(doc_id, sha, _url=historian_url,
                              _tenant=tenant):
                    notify_summary_commit(_url, _tenant, doc_id, sha)

            runner.add(PartitionManager(
                log, "scribe", DELTAS_TOPIC,
                lambda ctx, _oc=on_commit: ScribeLambda(
                    ctx, historian, tenant, send_system=send_system,
                    checkpoints=scribe_ckpt, fresh_log=False,
                    on_commit=_oc)))
        elif stage == "copier":
            runner.add(PartitionManager(
                log, "copier", RAW_TOPIC,
                lambda ctx: CopierLambda(ctx, raw_deltas)))
        elif stage == "broadcaster":
            # Standalone broadcaster keeps room state empty — real
            # deployments host it inside the front door (alfred) where the
            # websockets live; this stage exists for topology parity.
            runner.add(PartitionManager(
                log, "broadcaster", DELTAS_TOPIC,
                lambda ctx: BroadcasterLambda(ctx, rooms={})))
        else:
            raise SystemExit(f"unknown stage {stage!r}")

    def close():
        for manager in runner.managers:
            for pump in manager.pumps.values():
                pump.lambda_.close()
        db.close()

    return runner, close


def run_worker(cfg: dict, stages: List[str]) -> None:
    from ..telemetry import tracing

    wcfg = cfg.get("worker", {})
    # Fleet identity BEFORE any span records: every span this process
    # exports carries the name the observatory joins timelines by.
    tracing.set_process_name(wcfg.get("name")
                             or f"worker:{'+'.join(stages)}")
    sample = int(wcfg.get("traceSample", 0) or 0)
    if sample:
        tracing.configure(sample=sample)
    runner, close = build_worker(cfg, stages)
    poll_s = cfg["worker"].get("poll_ms", 10) / 1000.0
    print(f"worker: stages={stages} broker="
          f"{cfg['broker'].get('host')}:{cfg['broker'].get('port')}",
          flush=True)
    monitor = None
    if wcfg.get("monitorPort"):
        from ..telemetry import watermarks
        from .monitor import ServiceMonitor

        # Worker-side scrape surface for the observatory. SLO
        # enforcement stays fleet-level (observatory) — a worker whose
        # stages never observe the policy stage must not 503.
        monitor = ServiceMonitor(host=cfg["broker"].get("host",
                                                        "127.0.0.1"),
                                 port=int(wcfg["monitorPort"]),
                                 enforce_slo=False,
                                 device=wcfg.get("device"))

        def watermark_probe() -> dict:
            # Pull-model `ticketed` refresh from the live sequencer
            # lambdas (crash-restarted replacements included); the
            # raw_end mark needs broker-side end offsets and is the
            # single-process/broker monitor's job (known limit:
            # docs/observability.md v3).
            for manager in runner.managers:
                for p, pump in manager.pumps.items():
                    seqs = getattr(pump.lambda_, "doc_sequence_numbers",
                                   None)
                    if seqs is None:
                        continue
                    for doc, seq in seqs().items():
                        watermarks.advance_doc(watermarks.TICKETED, p,
                                               doc, seq)
            return {"stages": stages}

        monitor.add_probe("worker", watermark_probe)
        monitor.start()
        print(f"worker: monitor on {monitor.url}", flush=True)
    stop = {"flag": False}

    def on_signal(*_):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    while not stop["flag"]:
        try:
            n = runner.pump()
        except Exception as err:  # noqa: BLE001 — transport outage
            # Broker unreachable (restarting, network blip): keep polling —
            # the gRPC channel reconnects and the durable log serves our
            # committed offsets when the broker is back. Lambda-level
            # crashes are already handled inside the pump (restart +
            # replay); only transport errors surface here.
            print(f"worker: broker unavailable ({type(err).__name__}); "
                  "retrying", flush=True)
            time.sleep(min(poll_s * 20, 1.0))
            continue
        if n == 0:
            time.sleep(poll_s)
    if monitor is not None:
        monitor.stop()
    close()
    print("worker: stopped", flush=True)


def run_observatory(cfg: dict) -> None:
    from .observatory import FleetObservatory

    ocfg = cfg.get("observatory", {})
    targets = ocfg.get("workers") or []
    obs = FleetObservatory(workers=targets,
                           host=ocfg.get("host", "127.0.0.1"),
                           port=int(ocfg.get("port", 7090)),
                           interval_s=float(ocfg.get("intervalS", 2.0)))
    obs.start()
    print(f"observatory: aggregating {len(targets)} workers on "
          f"{obs.url}", flush=True)
    _wait_for_signal()
    obs.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="fluidframework_tpu_torch.server.main",
        description="Run one service of the ordering pipeline")
    parser.add_argument("service", choices=["broker", "worker",
                                            "historian", "observatory"])
    parser.add_argument("--config", default=None,
                        help="path to deploy config JSON")
    parser.add_argument("--stages", default=None,
                        help="comma-separated lambda stages for `worker`")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.service == "broker":
        run_broker(cfg)
    elif args.service == "historian":
        run_historian(cfg)
    elif args.service == "observatory":
        run_observatory(cfg)
    else:
        stages = (args.stages.split(",") if args.stages
                  else cfg["worker"]["stages"])
        run_worker(cfg, stages)


def _wait_for_signal() -> None:
    done = {"flag": False}

    def on_signal(*_):
        done["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    while not done["flag"]:
        time.sleep(0.2)


if __name__ == "__main__":
    main(sys.argv[1:])
