"""Read-tier serving state: the per-document catch-up artifact cache.

A copy of fluidframework_tpu's server/readpath.py, host code that the port
keeps as its own.

The write path got seven PRs of batching; this module is the read tier's
half of the first one (docs/read_path.md). A connecting client's catch-up
used to be summary + an op-tail replay — O(tail) work PER CLIENT. The
serving tier now maintains one constant-size artifact per document:

    { seq, msn, quorum snapshot, summary ref,
      clients: [wire ids], channels: [(store, channel, header, blob)] }

where each channel blob is the narrow int16 packed entry wire
(mergetree/catchup.py pack_entries_narrow) of that channel's full-fidelity
snapshot entries at `seq`. The artifact is refreshed from the per-lane
change generations at flush boundaries — ONE batched device dispatch per
refresh epoch covering every dirty document (TpuSequencerLambda
.catchup_snapshot) — so server cost scales with dirty docs, never with
connecting clients. Clients fetch summary + artifact in one round trip
(storage.get_catchup / the historian `/catchup` route), adopt, and replay
only the residue past `seq`.

Staleness contract (the adopter's side is loader/container.py):
  - an ABSENT artifact is a miss: the client falls back to tail replay.
  - a STALE artifact (seq behind the head) is still served and counted:
    adoption at `seq` plus residue replay is exactly as correct as a
    fresh artifact, just with a longer residue.
  - an artifact older than the summary the client loaded is useless and
    the CLIENT ignores it (the summary already covers more history).
Publishes ride LruTtlCache.put_if_newer keyed on `seq`, so a racing
refresh can never regress a fresher artifact.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ..mergetree.catchup import (  # noqa: F401 — re-exported: this module
    pack_entries_narrow,           # OWNS the artifact format, so loader-
    translate_entry_clients,       # side adopters import the codec from
    unpack_entries_narrow,         # here (layering: loader may import
)                                  # server, not mergetree)
from ..telemetry import tracing
from ..telemetry import watermarks
from ..telemetry.counters import increment
from .cache import LruTtlCache


def artifact_nbytes(artifact: dict) -> int:
    """Cache-accounting size: the dominant term is the packed channel
    text + columns; JSON length over the whole artifact is close enough
    and computed once per publish."""
    try:
        return len(json.dumps(artifact))
    except (TypeError, ValueError):
        return 4096


class CatchupCache:
    """Bounded store of per-(tenant, document) catch-up artifacts.

    Counters (process-wide, /metrics.prom):
      catchup.delta_hit    reads served an artifact
      catchup.delta_miss   reads with no artifact (client tail-replays)
      catchup.delta_stale  hits whose artifact trails the current head
      catchup.published    artifacts (re)published
    """

    def __init__(self, max_entries: int = 65536,
                 max_bytes: int = 256 * 1024 * 1024,
                 ttl_s: Optional[float] = None,
                 partition_of=None):
        self.blobs = LruTtlCache(max_entries=max_entries,
                                 max_bytes=max_bytes, ttl_s=ttl_s)
        self.hits = 0
        self.misses = 0
        self.stale_hits = 0
        self.published = 0
        # doc_id -> ingest partition, for the catchup/adopted watermark
        # stamps (telemetry/watermarks.py). The cache itself is
        # partition-agnostic; owners that know the routing pass the
        # tier's partition_for so lag attributes to the right partition,
        # everyone else folds into partition 0.
        self.partition_of = partition_of or (lambda _doc: 0)

    def publish(self, tenant_id: str, document_id: str,
                artifact: dict) -> bool:
        """Write-through publish; loses quietly to a fresher artifact.
        Spanned (catchup.publish + the always-on histogram): the
        refresh epoch's per-doc publish cost attributes to a stage
        instead of hiding inside the epoch total."""
        with tracing.span("catchup.publish", hist="catchup.publish",
                          document=document_id) as sp:
            wrote = self.blobs.put_if_newer(
                (tenant_id, document_id), artifact,
                version=int(artifact["seq"]),
                nbytes=artifact_nbytes(artifact))
            if wrote:
                self.published += 1
                increment("catchup.published")
                # `catchup` watermark: ops up to the artifact's seq are
                # now adoptable in O(1) (per-doc high-water, replay-safe).
                # Default tenant key on purpose: every tier must stamp
                # the SAME tenant axis or the lag edges split — process
                # identity is the observatory's dimension, not tenant.
                watermarks.advance_doc(
                    watermarks.CATCHUP, self.partition_of(document_id),
                    document_id, int(artifact["seq"]))
            else:
                sp.set(lost_to_fresher=True)
        return wrote

    def get(self, tenant_id: str, document_id: str,
            head_seq: Optional[int] = None) -> Optional[dict]:
        """The read path: returns the artifact or None (miss). head_seq,
        when the caller knows it, classifies the hit as fresh/stale."""
        with tracing.span("catchup.get", hist="catchup.get",
                          document=document_id) as sp:
            held = self.blobs.get((tenant_id, document_id))
            if held is None:
                self.misses += 1
                increment("catchup.delta_miss")
                sp.set(miss=True)
                return None
            _version, artifact = held
            self.hits += 1
            increment("catchup.delta_hit")
            # `adopted` watermark: a served artifact is the adoption
            # frontier the read tier can vouch for (the loader-side swap
            # is client-local; the serve is the last server-visible hop).
            watermarks.advance_doc(
                watermarks.ADOPTED, self.partition_of(document_id),
                document_id, int(artifact["seq"]))
            if head_seq is not None and int(artifact["seq"]) < head_seq:
                self.stale_hits += 1
                increment("catchup.delta_stale")
                sp.set(stale=True)
        return artifact

    def peek_seq(self, tenant_id: str, document_id: str) -> Optional[int]:
        """Freshness probe without hit/miss accounting (the refresh-on-
        read gate must not skew the rates operators alert on)."""
        return self.blobs.peek_version((tenant_id, document_id))

    def invalidate(self, tenant_id: str, document_id: str) -> bool:
        return self.blobs.invalidate((tenant_id, document_id))

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "artifacts": len(self.blobs),
            "bytes": self.blobs.bytes,
            "hits": self.hits,
            "misses": self.misses,
            "staleHits": self.stale_hits,
            "hitRate": (self.hits / total) if total else 0.0,
            "published": self.published,
        }


class ArtifactPushThrough:
    """Worker-side catch-up refresh epochs for the MULTI-PROCESS
    topology (server/main.py `tpu-deli` stage). The in-process
    LocalServer joins sequencer snapshots with scribe checkpoints inside
    its own refresh_catchup; a deployed worker has no CatchupCache of
    its own — it builds the same artifacts and PUSHES them to the
    historian tier's `/historian/catchup` route, where connecting
    clients fetch summary + artifact in one round trip (the
    docs/read_path.md contract, now spanning processes).

    Epochs ride the worker's pump loop as a runner ticker (rate-limited
    to `interval_s`), each costing one batched device extraction over
    every dirty document together (TpuSequencerLambda.catchup_snapshot)
    — push cost scales with dirty docs per epoch, never with connecting
    clients. A doc whose scribe checkpoint trails the sequencer skips
    the epoch (stale-but-correct: its previous artifact keeps serving).
    The change generation is marked published ONLY after the publish
    callback reports success, so a dead historian leaves the doc dirty
    and the artifact retries next epoch instead of silently dropping."""

    def __init__(self, sequencers, scribe_checkpoints, historian,
                 tenant_id: str, publish, interval_s: float = 0.25,
                 clock=None):
        import time as _time

        self.sequencers = sequencers          # () -> live sequencer lambdas
        self.scribe_checkpoints = scribe_checkpoints
        self.historian = historian            # summary-ref source (get_ref)
        self.tenant_id = tenant_id
        self.publish = publish                # (tenant, doc, artifact) -> bool
        self.interval_s = float(interval_s)
        self.clock = clock or _time.monotonic
        self._last: Optional[float] = None
        self.epochs = 0
        self.published = 0
        self.skipped = 0
        self.failed = 0

    def pump(self, force: bool = False) -> int:
        """One rate-limited refresh epoch; returns artifacts pushed."""
        now = self.clock()
        if not force and self._last is not None \
                and now - self._last < self.interval_s:
            return 0
        self._last = now
        bodies: Dict[str, dict] = {}
        owner: Dict[str, Any] = {}
        for lam in self.sequencers():
            snap = getattr(lam, "catchup_snapshot", None)
            if snap is None:
                continue  # scalar deli: no lane state to extract from
            for doc_id, body in snap().items():
                bodies[doc_id] = body
                owner[doc_id] = lam
        if not bodies:
            return 0
        self.epochs += 1
        by_doc = {row["documentId"]: row
                  for row in self.scribe_checkpoints.find(
                      lambda d: d.get("documentId") in bodies)}
        pushed = 0
        for doc_id, body in bodies.items():
            row = by_doc.get(doc_id)
            if row is None or int(row["sequenceNumber"]) != body["seq"]:
                self.skipped += 1
                increment("catchup.publish_skipped")
                continue
            sha = self.historian.store(self.tenant_id,
                                       doc_id).get_ref("main")
            artifact = build_artifact(body, row["minimumSequenceNumber"],
                                      row["quorum"], sha)
            if self.publish(self.tenant_id, doc_id, artifact):
                pushed += 1
                self.published += 1
                increment("catchup.pushed")
                owner[doc_id].catchup_mark_published(doc_id, body["gen"])
            else:
                self.failed += 1
                increment("catchup.push_failed")
        return pushed

    def stats(self) -> dict:
        return {"epochs": self.epochs, "published": self.published,
                "skipped": self.skipped, "failed": self.failed}


def quorum_ordinals(quorum_snapshot: dict) -> Dict[str, int]:
    """wire client id -> quorum ordinal (its join sequence number) — the
    ordinal space a CLIENT's runtime uses for merge perspectives, derived
    from the same snapshot the artifact carries so the adopter and the
    protocol state can never disagree."""
    return {cid: int(m["sequenceNumber"])
            for cid, m in quorum_snapshot.get("members", [])}


def build_artifact(doc_body: dict, msn: int, quorum_snapshot: dict,
                   summary_sha: Optional[str]) -> dict:
    """Join a sequencer-side doc body (catchup_snapshot output: seq,
    clients, channels) with the protocol half into the published shape."""
    return {
        "v": 1,
        "seq": int(doc_body["seq"]),
        "msn": int(msn),
        "quorum": quorum_snapshot,
        "summarySha": summary_sha,
        "clients": list(doc_body["clients"]),
        "channels": doc_body["channels"],
    }
