"""ctypes binding over the C++ ordered-log broker (src/oplog.cpp): a port
of fluidframework_tpu's native/oplog.py.

NativeMessageLog is drop-in compatible with server.log.MessageLog (the
pure-Python engine): same topics/partitions/poll/commit/subscribe surface,
so the lambda host and LocalServer can run over either. Payloads cross the
boundary pickled, the way the reference's rdkafka path ships serialized
frames (services/package.json:40 node-rdkafka).

Partition assignment differs deliberately: the native engine uses stable
FNV-1a keyed hashing (survives process restarts, like Kafka's murmur2
partitioner) where the Python engine uses crc32. The local server routes
documents to partitions itself (server/routing.py, md5 by document) and
produces with send_to, so no per-document result depends on the engine.

The library builds with g++ at first use (native/build.py). A failed
build, an unloadable library or a missing symbol raises: nothing falls
back to the Python engine.
"""

from __future__ import annotations

import ctypes
import pickle
import struct
import threading
from typing import Any, Callable, Dict, List, Optional

from .build import ensure_built

_LIB = None
_load_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The broker library, built and bound on the first call. Raises
    NativeBuildError, OSError or AttributeError."""
    global _LIB
    with _load_lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(ensure_built("oplog"))
        c = ctypes.c_char_p
        i64, i32 = ctypes.c_int64, ctypes.c_int
        size_t = ctypes.c_size_t
        lib.oplog_create.argtypes = [i32]
        lib.oplog_create.restype = i64
        lib.oplog_destroy.argtypes = [i64]
        lib.oplog_destroy.restype = None
        lib.oplog_topic.argtypes = [i64, c, i32]
        lib.oplog_topic.restype = i32
        lib.oplog_partition_for.argtypes = [i64, c, c, size_t]
        lib.oplog_partition_for.restype = i32
        lib.oplog_append.argtypes = [i64, c, i32, c, size_t, c, size_t]
        lib.oplog_append.restype = i64
        lib.oplog_end_offset.argtypes = [i64, c, i32]
        lib.oplog_end_offset.restype = i64
        lib.oplog_poll.argtypes = [i64, c, c, i32, i32, i64,
                                   ctypes.c_char_p, i64,
                                   ctypes.POINTER(i64)]
        lib.oplog_poll.restype = i64
        lib.oplog_commit.argtypes = [i64, c, c, i32, i64]
        lib.oplog_commit.restype = None
        lib.oplog_committed.argtypes = [i64, c, c, i32]
        lib.oplog_committed.restype = i64
        _LIB = lib
        return _LIB


# Reuse the host-side message record type so consumers are agnostic.
from ..server.log import QueuedMessage  # noqa: E402  (cycle-safe: log does
# not import this module at import time)


class _NativePartitionView:
    """Read view matching server.log.Partition's consumer surface."""

    def __init__(self, log: "NativeMessageLog", topic: str, index: int):
        self._log = log
        self.topic = topic
        self.index = index

    def read(self, offset: int, limit: int = 1000) -> List[QueuedMessage]:
        return self._log._read(self.topic, self.index, offset, limit)

    @property
    def end_offset(self) -> int:
        return self._log._lib.oplog_end_offset(
            self._log._h, self.topic.encode(), self.index)

    @property
    def listeners(self) -> List[Callable[[QueuedMessage], None]]:
        return self._log._listeners.setdefault((self.topic, self.index), [])


class _NativeTopicView:
    def __init__(self, log: "NativeMessageLog", name: str, partitions: int):
        self.name = name
        self.partitions = [_NativePartitionView(log, name, i)
                           for i in range(partitions)]
        self._log = log

    def partition_for(self, key: str) -> _NativePartitionView:
        idx = self._log._lib.oplog_partition_for(
            self._log._h, self.name.encode(), key.encode(), len(key.encode()))
        return self.partitions[idx]


class NativeMessageLog:
    """MessageLog-compatible broker backed by the C++ engine."""

    def __init__(self, default_partitions: int = 1):
        lib = library()
        self._lib = lib
        self._h = lib.oplog_create(default_partitions)
        self.default_partitions = default_partitions
        self._topics: Dict[str, _NativeTopicView] = {}
        self._listeners: Dict[tuple, List[Callable]] = {}
        self._buf = ctypes.create_string_buffer(1 << 20)
        self._lock = threading.Lock()

    def __del__(self):
        try:
            self._lib.oplog_destroy(self._h)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # -- topics ------------------------------------------------------------
    def topic(self, name: str, partitions: Optional[int] = None
              ) -> _NativeTopicView:
        with self._lock:
            if name not in self._topics:
                n = self._lib.oplog_topic(self._h, name.encode(),
                                          partitions or 0)
                self._topics[name] = _NativeTopicView(self, name, n)
            return self._topics[name]

    # -- producer ----------------------------------------------------------
    def send(self, topic: str, key: str, value: Any) -> QueuedMessage:
        view = self.topic(topic)
        kb = key.encode()
        vb = pickle.dumps(value)
        part = self._lib.oplog_partition_for(self._h, topic.encode(), kb,
                                             len(kb))
        offset = self._lib.oplog_append(self._h, topic.encode(), part, kb,
                                        len(kb), vb, len(vb))
        msg = QueuedMessage(topic, part, offset, key, value)
        for fn in list(self._listeners.get((topic, part), [])):
            fn(msg)
        return msg

    def send_to(self, topic: str, partition: int, key: str,
                value: Any) -> QueuedMessage:
        """Produce to an EXPLICIT partition (MessageLog.send_to parity):
        the sharded ingest tier routes documents itself (server/
        routing.py md5 scheme) and must bypass the engine's key hash."""
        view = self.topic(topic)
        del view  # ensure the topic exists engine-side
        kb = key.encode()
        vb = pickle.dumps(value)
        offset = self._lib.oplog_append(self._h, topic.encode(),
                                        int(partition), kb, len(kb),
                                        vb, len(vb))
        msg = QueuedMessage(topic, int(partition), offset, key, value)
        for fn in list(self._listeners.get((topic, int(partition)), [])):
            fn(msg)
        return msg

    def send_to_many(self, topic: str, partition: int,
                     items) -> List[QueuedMessage]:
        """Batched explicit-partition produce (MessageLog.send_to_many
        parity). The C++ engine appends are already memory-speed, so this
        loops oplog_append — the batch shape exists so callers written
        against the durable engine's one-group-commit-per-batch path run
        unchanged here."""
        return [self.send_to(topic, partition, key, value)
                for key, value in items]

    # -- consumer ----------------------------------------------------------
    def poll(self, group: str, topic: str, partition: int = 0,
             limit: int = 1000) -> List[QueuedMessage]:
        return self._poll(group, topic, partition, limit, start=-1)

    def _read(self, topic: str, partition: int, offset: int,
              limit: int = 1000) -> List[QueuedMessage]:
        return self._poll("", topic, partition, limit, start=offset)

    def read_from(self, topic: str, partition: int, offset: int,
                  limit: int = 1000) -> List[QueuedMessage]:
        """Group-independent explicit-offset read (MessageLog.read_from
        parity) — the C++ ring keeps full history in memory, so this is
        the same O(limit) copy-out as any read."""
        return self._read(topic, partition, offset, limit)

    def _poll(self, group: str, topic: str, partition: int, limit: int,
              start: int) -> List[QueuedMessage]:
        self.topic(topic)
        count = ctypes.c_int64(0)
        out: List[QueuedMessage] = []
        while True:
            with self._lock:
                n = self._lib.oplog_poll(
                    self._h, group.encode(), topic.encode(), partition,
                    limit - len(out), start, self._buf, len(self._buf),
                    ctypes.byref(count))
                if n < 0 and count.value == 0 and -n > len(self._buf):
                    # One record larger than the buffer: grow and retry.
                    self._buf = ctypes.create_string_buffer(-n)
                    continue
                data = self._buf.raw[:max(n, 0)]
            break
        pos = 0
        for _ in range(count.value):
            offset, klen, vlen = struct.unpack_from("<QII", data, pos)
            pos += 16
            key = data[pos:pos + klen].decode()
            pos += klen
            value = pickle.loads(data[pos:pos + vlen])
            pos += vlen
            out.append(QueuedMessage(topic, partition, offset, key, value))
        return out

    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        self._lib.oplog_commit(self._h, group.encode(), topic.encode(),
                               partition, offset)

    def commit_many(self, group: str, topic: str,
                    offsets: Dict[int, int]) -> None:
        """Batched cross-partition ack (MessageLog.commit_many parity).
        The engine's commit is already monotonic per partition; batching
        here saves the per-call Python/ctypes overhead, not a lock."""
        for partition, offset in offsets.items():
            self.commit(group, topic, partition, offset)

    def committed(self, group: str, topic: str, partition: int) -> int:
        return self._lib.oplog_committed(self._h, group.encode(),
                                         topic.encode(), partition)

    def subscribe(self, topic: str, partition: int,
                  fn: Callable[[QueuedMessage], None]) -> None:
        self.topic(topic)
        self._listeners.setdefault((topic, partition), []).append(fn)

    def unsubscribe(self, topic: str, partition: int,
                    fn: Callable[[QueuedMessage], None]) -> None:
        """Removal path for subscribe (same contract as MessageLog)."""
        listeners = self._listeners.get((topic, partition), [])
        if fn in listeners:
            listeners.remove(fn)
