"""The deployment's fleet, run the same way on either package.

`run` builds a worker in this process with the package's
`server.main.build_worker` (the `tpu-deli,scriptorium,scribe,copier`
stages, durable sqlite deltas and a file git store under `storage`)
against a broker at `address` (the package's `server.main broker`, or a
LogServiceServer the caller runs), and feeds it a fleet the way the front
door does: through the package's RemoteMessageLog, one `send_to` a
boxcar onto the raw topic's partition of the document. Each document has
one writer, which joins first; then every wave each writer sends `ops`
inserts into one SharedString channel in boxcars of `boxcar`
(phase 17's traffic, testing/server_runs.py, without its LWW, storm,
reader and summary documents). After each wave the worker is pumped until
the wave's every delta is persisted.

`run` returns sha256 digests (testing/lambda_runs.py `digest`) of each
document's persisted delta rows (every field but the timestamp and the
trace spans), with the rows' count, so two runs
compare by equality; and, apart from the result, the timings a caller
reads (`Timings`). The sequencing does not depend on how the worker's
polls cut the stream into windows, so the digests do not depend on the
host's speed.

The scenario takes a `DeployPackage` of one package's modules plus the
worker's device (`worker.device`: "cuda" or "cpu" for the port, None for
the JAX package). chip_smoke.py phase 21 (c) runs it on the card against
a broker process; tests/test_torch_deploy_golden.py runs it through the
JAX package on the CPU to build testing/golden/deploy_golden.json. Apart
from `port_package`, which loads the port's modules, this module needs
neither torch nor JAX.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, NamedTuple

from .lambda_runs import digest

STORE, TEXT = "s", "t"
TENANT = "local"
STAGES = ["tpu-deli", "scriptorium", "scribe", "copier"]
# How long a wave may take from its first send to its last persisted
# delta.
DEADLINE_S = 120.0


class DeployPackage(NamedTuple):
    main: Any              # server/main module
    log_service: Any       # server/log_service module
    durable: Any           # server/durable module
    messages: Any          # protocol/messages module
    routing: Any           # server/routing module
    scriptorium: Any       # server/lambdas/scriptorium module


def port_package() -> DeployPackage:
    """The port's DeployPackage (its modules import torch, so they load
    here, on the first call)."""
    from ..protocol import messages
    from ..server import durable, log_service, main, routing
    from ..server.lambdas import scriptorium
    return DeployPackage(main, log_service, durable, messages, routing,
                         scriptorium)


class Spec(NamedTuple):
    """`docs` documents, `warm` + `measured` waves of `ops` inserts a
    writer in boxcars of `boxcar`, on a broker of `partitions`."""
    docs: int
    ops: int = 32
    boxcar: int = 8
    warm: int = 1
    measured: int = 3
    partitions: int = 1
    seed: int = 17


class Timings(NamedTuple):
    """Host seconds of each wave, measured waves last: from the first
    send to the last persisted delta (`wall`), the sends alone (`send`),
    and the messages the wave sent."""
    wall: List[float]
    send: List[float]
    messages: List[int]


def config(spec: Spec, address: str, storage: str, device) -> dict:
    """The worker's configuration: the broker at `address`, durable
    storage under `storage`, the card (or `device`) for tpu-deli, no
    historian tier, and the wall-clock ghost-client eviction off."""
    host, port = address.rsplit(":", 1)
    return {
        "broker": {"host": host, "port": int(port),
                   "partitions": spec.partitions},
        "storage": {"db": os.path.join(storage, "fluid.sqlite"),
                    "git": os.path.join(storage, "git")},
        "worker": {"stages": STAGES, "tenant": TENANT, "device": device,
                   "poll_ms": 1},
        "deli": {"clientTimeoutMsec": 0},
        "historian": {"url": None},
    }


def _insert(text: str) -> dict:
    return {"address": STORE, "contents": {
        "address": TEXT,
        "contents": {"type": 0, "pos1": 0, "seg": {"text": text}}}}


def wave_boxcars(pkg: DeployPackage, spec: Spec, wave: int,
                 seen: Dict[str, int], csn: Dict[str, int]) -> list:
    """One wave's (document, boxcar) list, in send order."""
    import random

    M = pkg.messages
    rng = random.Random(spec.seed * 1000 + wave)
    out = []
    for d in range(spec.docs):
        doc, client = f"d{d}", f"c{d}"
        msgs = []
        for i in range(spec.ops):
            csn[doc] += 1
            letter = chr(ord("a") + (wave + i) % 26)
            msgs.append(M.DocumentMessage(
                client_sequence_number=csn[doc],
                reference_sequence_number=seen[doc],
                type=M.MessageType.OPERATION,
                contents=_insert(letter * rng.randrange(1, 4))))
        for i in range(0, spec.ops, spec.boxcar):
            out.append((doc, M.Boxcar(
                tenant_id=TENANT, document_id=doc, client_id=client,
                contents=msgs[i:i + spec.boxcar])))
    return out


def _rows(deltas, docs) -> Dict[str, list]:
    out: Dict[str, list] = {doc: [] for doc in docs}
    for r in deltas.find(lambda r: r["documentId"] in out):
        out[r["documentId"]].append(
            {k: v for k, v in r.items() if k not in ("timestamp", "traces")})
    for rows in out.values():
        rows.sort(key=lambda r: r["sequence_number"])
    return out


def run(pkg: DeployPackage, spec: Spec, address: str, storage: str,
        device=None) -> tuple:
    """The fleet through a worker built in this process. Returns (result,
    Timings). Raises TimeoutError when a wave is not persisted within
    DEADLINE_S of its first send."""
    M = pkg.messages
    main = pkg.main
    cfg = main.load_config(None)
    for key, value in config(spec, address, storage, device).items():
        cfg.setdefault(key, {}).update(value)
    runner, close = main.build_worker(cfg, list(STAGES))
    log = pkg.log_service.RemoteMessageLog(
        address, default_partitions=spec.partitions)
    db = pkg.durable.SqliteDatabaseManager(cfg["storage"]["db"])
    try:
        deltas = db.collection("deltas",
                               unique_key=pkg.scriptorium.delta_key)
        docs = [f"d{d}" for d in range(spec.docs)]
        part = {doc: pkg.routing.doc_shard(doc, spec.partitions)
                for doc in docs}
        seen = {doc: 0 for doc in docs}
        csn = {doc: 0 for doc in docs}
        expected = [0]

        def persist(t0: float) -> None:
            while len(deltas) < expected[0]:
                if runner.pump() == 0:
                    time.sleep(0.001)
                if time.perf_counter() - t0 > DEADLINE_S:
                    raise TimeoutError(
                        f"{len(deltas)} of {expected[0]} deltas persisted "
                        f"after {DEADLINE_S} s")

        t0 = time.perf_counter()
        for d, doc in enumerate(docs):
            log.send_to(main.RAW_TOPIC, part[doc], doc, M.Boxcar(
                tenant_id=TENANT, document_id=doc, client_id=None,
                contents=[M.DocumentMessage(
                    client_sequence_number=0, reference_sequence_number=-1,
                    type=M.MessageType.CLIENT_JOIN,
                    data=json.dumps({"clientId": f"c{d}", "detail": {}}))]))
        expected[0] += len(docs)
        persist(t0)
        walls, sends, counts = [], [], []
        for wave in range(spec.warm + spec.measured):
            boxcars = wave_boxcars(pkg, spec, wave, seen, csn)
            t0 = time.perf_counter()
            for doc, boxcar in boxcars:
                log.send_to(main.RAW_TOPIC, part[doc], doc, boxcar)
            sends.append(time.perf_counter() - t0)
            n = sum(len(b.contents) for _, b in boxcars)
            expected[0] += n
            persist(t0)
            walls.append(time.perf_counter() - t0)
            counts.append(n)
            # Each writer has seen its own ops before the next wave, as
            # a client acked by the broadcast would.
            last = _rows(deltas, docs)
            for doc in docs:
                seen[doc] = last[doc][-1]["sequence_number"]
        rows = _rows(deltas, docs)
        result = {"docs": spec.docs, "rows": sum(map(len, rows.values())),
                  "ops": sum(1 for rs in rows.values() for r in rs
                             if r["type"] == M.MessageType.OPERATION),
                  "deltas": {doc: digest(rs) for doc, rs in rows.items()}}
        return result, Timings(walls, sends, counts)
    finally:
        log.close()
        close()
        db.close()
