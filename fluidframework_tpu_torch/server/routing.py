"""Restart-stable document routing shared by every sharded tier.

A copy of fluidframework_tpu's server/routing.py, host code that the port
keeps as its own.

One hash, two consumers: the broadcaster's fan-out shards
(server/lambdas/broadcaster.py) and the ingest tier's partition router
(server/sharding.py) both assign a document a "home" by the SAME md5
scheme, so the two tiers can never disagree about where a document's
traffic lives — the broadcast shard draining a document's deliveries is
always derivable from the partition sequencing it (and vice versa) by
taking the digest modulo the respective shard count.

md5 rather than ``hash()`` because Python's string hash is seeded per
process: a restart would re-home every document, breaking per-document
ordering for durable logs and run-twice determinism in the soak suite.
md5 rather than crc32 (the broker's internal key hash) because the md5
scheme is the one the broadcaster shipped with (docs/read_path.md) and
re-homing broadcast shards to match the broker would invalidate
existing shard-affinity expectations; the ingest tier instead produces
to EXPLICIT partitions (`MessageLog.send_to`) so the broker's own key
hash never routes a sharded tenant's documents.

Dependency-free (stdlib only): imported by lambdas and the server tier
alike without cycles.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict


def doc_shard(document_id: str, shards: int) -> int:
    """The stable home of a document among ``shards`` slots.

    Little-endian first 4 digest bytes, modulo the slot count — byte
    order is pinned so the mapping is identical across hosts and
    restarts (run-twice determinism; see the broadcaster's routing
    stability tests in tests/test_broadcaster.py)."""
    if shards <= 1:
        return 0
    digest = hashlib.md5(str(document_id).encode()).digest()
    return int.from_bytes(digest[:4], "little") % shards


class PartitionRouter:
    """Doc -> ingest-partition routing for one topic's partition count.

    The BASE mapping is restart-stable by construction (pure function of
    the document id and the partition count). On top of it sits a
    routing-EPOCH override table for live rebalancing
    (docs/ingest_sharding.md): `install_override(doc, partition)` bumps
    the epoch and re-homes ONE document's raw-topic traffic without
    touching anything else — the sharded ingest tier
    (server/sharding.py SequencerShardSet.rebalance_doc) pairs the bump
    with an explicit handoff record on the source partition, so
    ownership transfers with no drain-to-barrier fleet restart.
    Overrides apply to the RAW (sequencing-input) side only; emit-side
    routing (deltas/broadcast) stays on `base_partition_for`, so a
    document's output stream never changes partitions and per-doc
    delivery order is total within one partition by construction.

    Changing the partition COUNT still re-homes (1 - 1/N) of documents
    and keeps the drain-to-a-checkpoint-barrier procedure, exactly like
    a Kafka repartition."""

    def __init__(self, partitions: int):
        self.partitions = max(1, int(partitions))
        self.epoch = 0
        self._overrides: Dict[str, int] = {}
        self._lock = threading.Lock()

    def base_partition_for(self, document_id: str) -> int:
        """The epoch-0 md5 home — rebalance-invariant; the emit-side
        (deltas/broadcast) routing anchor."""
        return doc_shard(document_id, self.partitions)

    def partition_for(self, document_id: str) -> int:
        """The document's CURRENT raw-side owner (override-aware)."""
        with self._lock:
            override = self._overrides.get(document_id)
        if override is not None:
            return override
        return doc_shard(document_id, self.partitions)

    def install_override(self, document_id: str, partition: int) -> int:
        """Re-home one document's raw traffic; returns the new routing
        epoch. Atomic w.r.t. partition_for: a submit either routes by
        the old owner (and is sequenced before the handoff marker the
        tier appends AFTER this bump) or by the new one."""
        if not 0 <= int(partition) < self.partitions:
            raise ValueError(
                f"override partition {partition} out of range "
                f"[0, {self.partitions})")
        with self._lock:
            self.epoch += 1
            self._overrides[str(document_id)] = int(partition)
            return self.epoch

    def overrides_targeting(self, partition: int) -> list:
        """Documents whose CURRENT override homes them on `partition` —
        the build-time seed for a partition's awaiting-adoption set."""
        with self._lock:
            return sorted(doc for doc, p in self._overrides.items()
                          if p == int(partition))

    def snapshot(self) -> dict:
        """Persistable override state (the tier stores it in the shared
        checkpoint collection so a restarted process re-derives the same
        routes — restart stability now includes live-rebalance moves)."""
        with self._lock:
            return {"epoch": self.epoch, "overrides": dict(self._overrides)}

    def restore(self, dump: dict) -> None:
        with self._lock:
            self.epoch = max(self.epoch, int(dump.get("epoch", 0)))
            for doc, p in dict(dump.get("overrides", {})).items():
                if 0 <= int(p) < self.partitions:
                    self._overrides[str(doc)] = int(p)

    def assignment(self, document_ids) -> dict:
        """{partition: [document_id, ...]} for a document set (bench &
        monitor convenience; deterministic order preserved)."""
        out: dict = {p: [] for p in range(self.partitions)}
        for doc_id in document_ids:
            out[self.partition_for(doc_id)].append(doc_id)
        return out
