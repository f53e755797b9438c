"""The ordered log: topics, partitions, offsets, consumer checkpoints (a
copy of fluidframework_tpu's server/log.py).

Capability parity with the reference's Kafka backbone (services-core
IProducer/IConsumer/IQueuedMessage, queue.ts) and its in-memory stand-in
LocalKafka (memory-orderer/src/localKafka.ts). Messages are boxcars keyed
by document; documents hash to partitions; consumers poll per partition and
commit offsets, so a crashed lambda replays from its last checkpoint
idempotently (kafka-service/README design).

This module is the pure-Python engine. The C++ engine
(native/oplog.py over native/src/oplog.cpp) has the same surface;
`make_message_log` chooses between them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class QueuedMessage:
    topic: str
    partition: int
    offset: int
    key: str
    value: Any


class Partition:
    def __init__(self, topic: str, index: int, base_offset: int = 0):
        self.topic = topic
        self.index = index
        # First offset held in memory. Always 0 for the in-memory engines;
        # a durable log opened in replay="committed" mode keeps only the
        # uncheckpointed suffix resident and serves older offsets from its
        # segment files (server/durable.py poll override).
        self.base_offset = base_offset
        self.messages: List[QueuedMessage] = []
        self.lock = threading.Lock()
        self.listeners: List[Callable[[QueuedMessage], None]] = []

    def append(self, key: str, value: Any) -> QueuedMessage:
        with self.lock:
            msg = QueuedMessage(self.topic, self.index,
                                self.base_offset + len(self.messages),
                                key, value)
            self.messages.append(msg)
            listeners = list(self.listeners)
        for fn in listeners:
            fn(msg)
        return msg

    def read(self, offset: int, limit: int = 1000) -> List[QueuedMessage]:
        with self.lock:
            lo = max(offset - self.base_offset, 0)
            return self.messages[lo:lo + limit]

    @property
    def end_offset(self) -> int:
        with self.lock:
            return self.base_offset + len(self.messages)


class Topic:
    def __init__(self, name: str, partitions: int):
        self.name = name
        self.partitions = [Partition(name, i) for i in range(partitions)]

    def partition_for(self, key: str) -> Partition:
        # STABLE hash: Python's hash() is randomized per process, which
        # would re-route a document to a different partition after a broker
        # restart — breaking per-document ordering for durable logs.
        import zlib
        digest = zlib.crc32(key.encode("utf-8"))
        return self.partitions[digest % len(self.partitions)]


class MessageLog:
    """Broker: named topics with N partitions each + consumer-group offsets."""

    def __init__(self, default_partitions: int = 1):
        self.topics: Dict[str, Topic] = {}
        self.default_partitions = default_partitions
        # (group, topic, partition) -> committed offset
        self.checkpoints: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def topic(self, name: str, partitions: Optional[int] = None) -> Topic:
        with self._lock:
            if name not in self.topics:
                self.topics[name] = Topic(
                    name, partitions or self.default_partitions)
            return self.topics[name]

    # -- producer ----------------------------------------------------------
    def send(self, topic: str, key: str, value: Any) -> QueuedMessage:
        return self.topic(topic).partition_for(key).append(key, value)

    def send_to(self, topic: str, partition: int, key: str,
                value: Any) -> QueuedMessage:
        """Produce to an EXPLICIT partition (bypassing key hashing) — for
        records that span many keys, like a sequencer window, which must
        land on the partition its source documents hash to."""
        return self.topic(topic).partitions[partition].append(key, value)

    def send_to_many(self, topic: str, partition: int,
                     items: List[tuple]) -> List[QueuedMessage]:
        """Batched explicit-partition produce: append [(key, value), ...]
        to one partition in order. On this engine it is a convenience
        loop; on the durable engine the whole batch rides ONE group
        commit (one write+fsync), and on the gRPC engine it is one round
        trip — the producer-side half of the million-msgs/s broker path.
        Per-partition order is the list order, exactly as if the caller
        had issued send_to() per item."""
        part = self.topic(topic).partitions[partition]
        return [part.append(key, value) for key, value in items]

    # -- consumer ----------------------------------------------------------
    def poll(self, group: str, topic: str, partition: int = 0,
             limit: int = 1000) -> List[QueuedMessage]:
        start = self.committed(group, topic, partition)
        return self.topic(topic).partitions[partition].read(start, limit)

    def read_from(self, topic: str, partition: int, offset: int,
                  limit: int = 1000) -> List[QueuedMessage]:
        """Group-independent read from an explicit offset — the replay
        surface crash recovery uses when it must re-read records BELOW a
        group's committed offset (rebalance buffer recovery in
        server/sharding.py). The durable engine overrides this to serve
        offsets below the resident window from its segment index."""
        return self.topic(topic).partitions[partition].read(offset, limit)

    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        """Commit 'processed through offset' (next poll starts at offset+1)."""
        with self._lock:
            key = (group, topic, partition)
            if offset + 1 > self.checkpoints.get(key, 0):
                self.checkpoints[key] = offset + 1

    def commit_many(self, group: str, topic: str,
                    offsets: Dict[int, int]) -> None:
        """Batched cross-partition ack: commit {partition: offset} for a
        whole consumer group in ONE lock acquisition — the sharded
        ingest tier (server/sharding.py AckBatcher) flushes a pump
        round's per-partition checkpoints through here instead of N
        broker round-trips. Same never-regress semantics as commit()."""
        with self._lock:
            for partition, offset in offsets.items():
                key = (group, topic, partition)
                if offset + 1 > self.checkpoints.get(key, 0):
                    self.checkpoints[key] = offset + 1

    def committed(self, group: str, topic: str, partition: int) -> int:
        return self.checkpoints.get((group, topic, partition), 0)

    def subscribe(self, topic: str, partition: int,
                  fn: Callable[[QueuedMessage], None]) -> None:
        self.topic(topic).partitions[partition].listeners.append(fn)

    def unsubscribe(self, topic: str, partition: int,
                    fn: Callable[[QueuedMessage], None]) -> None:
        """Removal path for subscribe: a consumer that rebalances away
        must drop its listener or the broker pins it (and everything the
        closure captured) for the process lifetime."""
        listeners = self.topic(topic).partitions[partition].listeners
        if fn in listeners:
            listeners.remove(fn)


def make_message_log(default_partitions: int = 1,
                     native: Optional[bool] = None):
    """Broker factory. native=True and native=None (the default, as in the
    JAX package where its engine builds) build the C++ engine and use it;
    a failed build or load raises (NativeBuildError, OSError,
    AttributeError), and nothing falls back. native=False pins the
    pure-Python engine."""
    if native is False:
        return MessageLog(default_partitions)
    from ..native.oplog import NativeMessageLog
    return NativeMessageLog(default_partitions)
