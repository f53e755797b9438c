"""Durable service backends: checkpoints/deltas/summaries that survive
process death.

The reference persists lambda state to MongoDB and summaries to bare git
repos on disk (scriptorium/lambda.ts:16-103 insertMany into Mongo;
gitrest over nodegit). The equivalents here:

- SqliteDatabaseManager / SqliteCollection: the services-core ICollection
  SPI over a sqlite3 file — same API as the in-memory DatabaseManager
  (database.py), drop-in for LocalServer(db=...). Unique-key idempotence
  (the dup-key-11000 replay guard) becomes a UNIQUE column.
- FileGitStore / FileHistorian: content-addressed objects + refs persisted
  to a directory (objects/<sha>, refs.json), loadable by a fresh process.

In-memory remains the test default; pass these in where durability is the
point (kill-and-restart, multi-node over shared storage).

A port of fluidframework_tpu's server/durable.py. The sqlite rows and
the git directory are JSON with the reference's encoding, so either
package reopens what the other wrote; the message log's segment frames
are pickled and belong to the package that wrote them.
"""

from __future__ import annotations

import bisect
import json
import os
import pickle
import sqlite3
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..telemetry.counters import bounded, gauge, increment, observe
from .log import MessageLog
from .storage import GitBlob, GitCommit, GitStore, GitTree, Historian


class SqliteCollection:
    """services-core ICollection over one sqlite table. Documents are JSON
    rows; the unique key (when configured) is a computed TEXT column with a
    UNIQUE index, so replayed inserts are dropped exactly like the
    reference's ignored dup-key errors."""

    def __init__(self, conn: sqlite3.Connection, lock: threading.Lock,
                 name: str,
                 unique_key: Optional[Callable[[dict], Any]] = None):
        self._conn = conn
        self._lock = lock
        self._table = f'col_{name}'
        self._unique_key = unique_key
        with self._lock:
            self._conn.execute(
                f'CREATE TABLE IF NOT EXISTS "{self._table}" '
                '(id INTEGER PRIMARY KEY AUTOINCREMENT, '
                ' ukey TEXT, doc TEXT NOT NULL)')
            if unique_key is not None:
                self._conn.execute(
                    f'CREATE UNIQUE INDEX IF NOT EXISTS '
                    f'"{self._table}_ukey" ON "{self._table}" (ukey) '
                    'WHERE ukey IS NOT NULL')
            self._conn.commit()

    def _key(self, doc: dict) -> Optional[str]:
        if self._unique_key is None:
            return None
        return json.dumps(self._unique_key(doc), sort_keys=True, default=str)

    def insert_one(self, doc: dict) -> bool:
        with self._lock:
            try:
                self._conn.execute(
                    f'INSERT INTO "{self._table}" (ukey, doc) VALUES (?, ?)',
                    (self._key(doc), json.dumps(doc, default=str)))
                self._conn.commit()
                return True
            except sqlite3.IntegrityError:
                return False  # idempotent replay

    def insert_many(self, docs: List[dict]) -> int:
        """Batch insert as ONE transaction: executemany under a single
        commit instead of a commit per row (the reference's insertMany).
        INSERT OR IGNORE keeps the per-row idempotence contract — a
        replayed row with a duplicate unique key is dropped without
        aborting the rest of the batch, exactly like insert_one's
        swallowed IntegrityError — and rowcount reports only the rows
        actually inserted."""
        if not docs:
            return 0
        with self._lock:
            cur = self._conn.executemany(
                f'INSERT OR IGNORE INTO "{self._table}" (ukey, doc) '
                'VALUES (?, ?)',
                [(self._key(d), json.dumps(d, default=str)) for d in docs])
            self._conn.commit()
            return max(cur.rowcount, 0)

    def _rows(self) -> List[Tuple[int, dict]]:
        # Takes the shared-connection lock itself: every reader of the
        # row snapshot is serialized against writers' commits even if a
        # future caller forgets the outer lock.
        with self._lock:
            return self._rows_locked()

    def _rows_locked(self) -> List[Tuple[int, dict]]:
        cur = self._conn.execute(
            f'SELECT id, doc FROM "{self._table}" ORDER BY id')
        return [(rid, json.loads(doc)) for rid, doc in cur.fetchall()]

    def find(self, predicate: Callable[[dict], bool]) -> List[dict]:
        return [d for _, d in self._rows() if predicate(d)]

    def find_one(self, predicate: Callable[[dict], bool]) -> Optional[dict]:
        for _, d in self._rows():
            if predicate(d):
                return d
        return None

    def upsert(self, match: Callable[[dict], bool], doc: dict) -> None:
        with self._lock:
            for rid, d in self._rows_locked():
                if match(d):
                    self._conn.execute(
                        f'UPDATE "{self._table}" SET doc = ?, ukey = ? '
                        'WHERE id = ?',
                        (json.dumps(doc, default=str), self._key(doc), rid))
                    self._conn.commit()
                    return
            self._conn.execute(
                f'INSERT INTO "{self._table}" (ukey, doc) VALUES (?, ?)',
                (self._key(doc), json.dumps(doc, default=str)))
            self._conn.commit()

    def __len__(self) -> int:
        with self._lock:
            cur = self._conn.execute(
                f'SELECT COUNT(*) FROM "{self._table}"')
            return cur.fetchone()[0]


class SqliteDatabaseManager:
    """IDatabaseManager over one sqlite file (drop-in for DatabaseManager)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._collections: Dict[str, SqliteCollection] = {}
        self._meta_lock = threading.Lock()

    def collection(self, name: str,
                   unique_key: Optional[Callable[[dict], Any]] = None
                   ) -> SqliteCollection:
        with self._meta_lock:
            if name not in self._collections:
                self._collections[name] = SqliteCollection(
                    self._conn, self._lock, name, unique_key)
            return self._collections[name]

    def close(self) -> None:
        self._conn.close()


# ---------------------------------------------------------------------------
# durable ordered log: segment files + group commit
# ---------------------------------------------------------------------------

# Record framing inside a segment: <u32 payload len><u32 crc32(payload)>
# <payload>. The CRC is what detects a torn tail — a crash can persist the
# header without (all of) the payload, or the payload bytes only partially,
# and a length check alone cannot tell a torn record from a valid one.
_FRAME_HDR = struct.Struct("<II")
# Sparse index sidecar (<base>.idx): fixed (absolute offset, file pos)
# pairs every INDEX_EVERY records. Never fsynced — it is a pure
# accelerator, rebuilt from the segment walk whenever recovery rewrites
# the tail.
_IDX_ENTRY = struct.Struct("<QQ")
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024
DEFAULT_INDEX_EVERY = 64


class _SegmentStore:
    """Disk half of ONE partition: rotating append-only segment files named
    by base offset (<base:020d>.seg) under <topic>/<partition>.d/, each
    with a sparse offset->position sidecar index. The rdkafka segment
    shape: rolled segments are immutable and fully fsynced; only the
    active tail can be torn by a crash."""

    def __init__(self, dirpath: str, segment_bytes: int, index_every: int):
        self.dir = dirpath
        self.segment_bytes = segment_bytes
        self.index_every = index_every
        os.makedirs(dirpath, exist_ok=True)
        self.bases: List[int] = sorted(
            int(name[:-4]) for name in os.listdir(dirpath)
            if name.endswith(".seg"))
        self.end = 0                 # next offset to assign
        self.truncated_bytes = 0     # torn tail dropped by last recover()
        self._active = None          # append handle for the last segment
        self._active_base = -1
        self._active_size = 0
        self._idx = None             # append handle for the active index

    def _seg_path(self, base: int) -> str:
        return os.path.join(self.dir, f"{base:020d}.seg")

    def _idx_path(self, base: int) -> str:
        return os.path.join(self.dir, f"{base:020d}.idx")

    # -- recovery ----------------------------------------------------------
    def recover(self) -> int:
        """Walk the segments, establish the end offset, and truncate a torn
        final record (short header, short payload, or CRC mismatch) off
        the last segment AND its index. Returns the end offset. Rolled
        (non-final) segments were fsynced before the roll, so only the
        final segment gets the full CRC walk."""
        self.end = self.bases[0] if self.bases else 0
        for i, base in enumerate(self.bases):
            final = i == len(self.bases) - 1
            path = self._seg_path(base)
            count, valid_bytes = self._walk(path, check_crc=final)
            self.end = base + count
            size = os.path.getsize(path)
            if valid_bytes < size:
                self.truncated_bytes += size - valid_bytes
                with open(path, "r+b") as f:
                    f.truncate(valid_bytes)
                self._rewrite_index(base, count, path)
                break  # nothing after a torn record is trustworthy
        return self.end

    @staticmethod
    def _walk(path: str, check_crc: bool) -> Tuple[int, int]:
        """Count whole valid records; returns (count, byte length of the
        valid prefix). With check_crc, payload bytes are read and
        checksummed; without, payloads are seeked over (header walk)."""
        count, pos = 0, 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                header = f.read(_FRAME_HDR.size)
                if len(header) < _FRAME_HDR.size:
                    break
                length, crc = _FRAME_HDR.unpack(header)
                if pos + _FRAME_HDR.size + length > size:
                    break  # torn payload
                if check_crc:
                    payload = f.read(length)
                    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                        break  # torn write that completed the length field
                else:
                    f.seek(length, 1)
                pos += _FRAME_HDR.size + length
                count += 1
        return count, pos

    def _rewrite_index(self, base: int, count: int, seg_path: str) -> None:
        """Drop index entries past a truncation point (a stale entry would
        otherwise point mid-record once appends resume)."""
        entries = [(off, fpos) for off, fpos in self._load_index(base)
                   if off < base + count]
        tmp = self._idx_path(base) + ".tmp"
        with open(tmp, "wb") as f:
            for off, fpos in entries:
                f.write(_IDX_ENTRY.pack(off, fpos))
        os.replace(tmp, self._idx_path(base))

    def _load_index(self, base: int) -> List[Tuple[int, int]]:
        path = self._idx_path(base)
        if not os.path.exists(path):
            return []
        out = []
        with open(path, "rb") as f:
            blob = f.read()
        for i in range(0, len(blob) - len(blob) % _IDX_ENTRY.size,
                       _IDX_ENTRY.size):
            out.append(_IDX_ENTRY.unpack_from(blob, i))
        return out

    # -- iteration / indexed reads -----------------------------------------
    def read(self, start: int, limit: int) -> List[Tuple[int, str, Any]]:
        """Indexed seek: find the segment covering `start` via bisect over
        base offsets, jump to the greatest indexed position <= start,
        and decode forward — replay from a committed offset touches only
        the record's neighbourhood, not the whole partition history."""
        out: List[Tuple[int, str, Any]] = []
        if not self.bases or start >= self.end:
            return out
        start = max(start, self.bases[0])
        si = bisect.bisect_right(self.bases, start) - 1
        for base in self.bases[si:]:
            if len(out) >= limit:
                break
            off, pos = base, 0
            if base <= start:
                for ioff, ipos in self._load_index(base):
                    if ioff <= start:
                        off, pos = ioff, ipos
                    else:
                        break
            path = self._seg_path(base)
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(pos)
                while pos < size and len(out) < limit:
                    header = f.read(_FRAME_HDR.size)
                    if len(header) < _FRAME_HDR.size:
                        break
                    length, _crc = _FRAME_HDR.unpack(header)
                    if pos + _FRAME_HDR.size + length > size:
                        break
                    payload = f.read(length)
                    if off >= start:
                        key, value = pickle.loads(payload)
                        out.append((off, key, value))
                    pos += _FRAME_HDR.size + length
                    off += 1
        return out

    def records(self, start: int = 0):
        """Stream (offset, key, value) from `start` to the end — the full
        replay path at open."""
        remaining = self.end - start
        while remaining > 0:
            chunk = self.read(start, min(remaining, 1024))
            if not chunk:
                break
            for row in chunk:
                yield row
            start = chunk[-1][0] + 1
            remaining = self.end - start

    # -- append ------------------------------------------------------------
    def _roll(self) -> None:
        if self._active is not None:
            self._active.flush()
            os.fsync(self._active.fileno())
            self._active.close()
            if self._idx is not None:
                self._idx.close()
        base = self.end
        self.bases.append(base)
        self._active = open(self._seg_path(base), "ab")
        self._idx = open(self._idx_path(base), "ab")
        self._active_base = base
        self._active_size = 0

    def _open_tail(self) -> None:
        """Attach the append handles to the recovered final segment."""
        base = self.bases[-1]
        self._active = open(self._seg_path(base), "ab")
        self._idx = open(self._idx_path(base), "ab")
        self._active_base = base
        self._active_size = os.path.getsize(self._seg_path(base))

    def append_frame(self, frame: bytes) -> int:
        """Stage one record into the active segment (NO fsync — the group
        commit fsyncs once per batch). Returns the assigned offset."""
        if self._active is None:
            if self.bases:
                self._open_tail()
            else:
                self._roll()
        if self._active_size >= self.segment_bytes:
            self._roll()
        if self.end % self.index_every == 0:
            self._idx.write(_IDX_ENTRY.pack(self.end, self._active_size))
        self._active.write(_FRAME_HDR.pack(
            len(frame), zlib.crc32(frame) & 0xFFFFFFFF) + frame)
        self._active_size += _FRAME_HDR.size + len(frame)
        offset = self.end
        self.end += 1
        return offset

    def fsync(self) -> None:
        if self._active is not None:
            self._active.flush()
            os.fsync(self._active.fileno())
        if self._idx is not None:
            self._idx.flush()  # index is rebuildable: flushed, not fsynced

    def close(self) -> None:
        if self._active is not None:
            self._active.flush()
            os.fsync(self._active.fileno())
            self._active.close()
            self._active = None
        if self._idx is not None:
            self._idx.close()
            self._idx = None

    @property
    def segment_count(self) -> int:
        return len(self.bases)


class _PendingAppend:
    """One producer's record waiting for the covering fsync."""

    __slots__ = ("topic", "part", "key", "value", "done", "msg", "error")

    def __init__(self, topic: str, part, key: str, value: Any):
        self.topic = topic
        self.part = part
        self.key = key
        self.value = value
        self.done = threading.Event()
        self.msg = None
        self.error: Optional[BaseException] = None


class DurableMessageLog(MessageLog):
    """MessageLog whose partitions and consumer offsets persist to disk —
    the Kafka durability role for the broker deployment (a crashed broker
    restarts with its full history and committed offsets; lambdas replay
    only their uncheckpointed suffix).

    Layout: <root>/<topic>/<partition>.d/<base>.seg rotating segment files
    (length+CRC framed pickle frames, sparse <base>.idx offset->position
    sidecars) + <root>/offsets.json (atomic fsync'd rewrite on commit).
    The pre-segment single-file layout (<partition>.log) is migrated in
    place at open. Pickle is fine here for the same reason it is on the
    gRPC link: this is a trusted internal surface; untrusted clients speak
    to alfred's JSON/JWT front door, never to the broker.

    Produce runs through a GROUP COMMIT: senders stage their record into a
    bounded append buffer; the first sender in becomes the drain leader,
    writes every staged frame, and issues ONE fsync per touched partition
    file for the whole batch. An ack (the send_to return / listener fire)
    is released only after the covering fsync, so the at-least-once
    contract is bit-for-bit the per-message-fsync engine's — what changes
    is only that N concurrent producers share one disk flush instead of
    queueing N. A single-threaded producer degrades to exactly the old
    one-fsync-per-send behaviour. send_to_many() batches explicitly: the
    whole list rides one commit regardless of concurrency.

    replay="committed" keeps only each partition's uncheckpointed suffix
    in memory (Partition.base_offset) and serves colder offsets straight
    from the segment files via the sparse index — a restarted broker with
    a long history seeks to the committed frontier instead of re-reading
    and re-materializing every record ever appended."""

    def __init__(self, root: str, default_partitions: int = 1,
                 replay: str = "full",
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 index_every: int = DEFAULT_INDEX_EVERY,
                 max_pending: int = 4096):
        if replay not in ("full", "committed"):
            raise ValueError(f"replay must be full|committed, got {replay!r}")
        super().__init__(default_partitions)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.segment_bytes = segment_bytes
        self.index_every = index_every
        self._stores: Dict[Tuple[str, int], _SegmentStore] = {}
        self._io_lock = threading.Lock()
        # Group-commit state: bounded staging buffer + leader election.
        self._gc_cv = threading.Condition()
        self._gc_pending: List[_PendingAppend] = []
        self._gc_leader = False
        self._gc_max_pending = max_pending
        self._offsets_path = os.path.join(root, "offsets.json")
        if os.path.exists(self._offsets_path):
            with open(self._offsets_path) as f:
                for key, off in json.load(f).items():
                    group, topic, part = key.rsplit("|", 2)
                    self.checkpoints[(group, topic, int(part))] = off
        for topic_name in sorted(os.listdir(root)):
            tdir = os.path.join(root, topic_name)
            if not os.path.isdir(tdir):
                continue
            self._open_topic(topic_name, tdir, replay)

    # -- open / recovery ---------------------------------------------------
    def _open_topic(self, topic_name: str, tdir: str, replay: str) -> None:
        parts: set = set()
        for entry in os.listdir(tdir):
            if entry.endswith(".log") and entry[:-4].isdigit():
                parts.add(int(entry[:-4]))       # pre-segment layout
            elif entry.endswith(".d") and entry[:-2].isdigit():
                parts.add(int(entry[:-2]))
        topic = self.topic(topic_name,
                           partitions=max(len(parts) and max(parts) + 1,
                                          self.default_partitions))
        for p in sorted(parts):
            legacy = os.path.join(tdir, f"{p}.log")
            if os.path.exists(legacy):
                self._migrate_legacy(topic_name, p, legacy)
            store = self._store_for(topic_name, p)
            store.recover()
            partition = topic.partitions[p]
            start = 0
            if replay == "committed":
                committed = [off for (g, t, pi), off
                             in self.checkpoints.items()
                             if t == topic_name and pi == p]
                start = min(committed) if committed else 0
                start = min(start, store.end)
            partition.base_offset = start
            for off, key, value in store.records(start):
                msg = partition.append(key, value)  # on disk: no re-write
                assert msg.offset == off

    def _migrate_legacy(self, topic_name: str, p: int, legacy: str) -> None:
        """One-time layout upgrade: re-frame a pre-segment <p>.log (length-
        only framing, no CRC) into the segment store. Idempotent across a
        crash mid-migration: the legacy file is removed only after the
        migrated segment is fsynced, and a partial <p>.d left by an
        earlier attempt is wiped before redoing (the legacy file is still
        the authority while it exists)."""
        dirpath = os.path.join(self.root, topic_name, f"{p}.d")
        if os.path.isdir(dirpath):
            for name in os.listdir(dirpath):
                os.unlink(os.path.join(dirpath, name))
        store = self._store_for(topic_name, p)
        with open(legacy, "rb") as f:
            while True:
                header = f.read(4)
                if len(header) < 4:
                    break  # clean EOF or torn tail: stop here
                (size,) = struct.unpack("<I", header)
                frame = f.read(size)
                if len(frame) < size:
                    break  # torn frame from a mid-write crash: drop it
                store.append_frame(frame)
        store.fsync()
        os.unlink(legacy)

    def _store_for(self, topic: str, partition: int) -> _SegmentStore:
        skey = (topic, partition)
        store = self._stores.get(skey)
        if store is None:
            dirpath = os.path.join(self.root, topic, f"{partition}.d")
            store = _SegmentStore(dirpath, self.segment_bytes,
                                  self.index_every)
            self._stores[skey] = store
        return store

    # -- produce: group commit ---------------------------------------------
    def send(self, topic: str, key: str, value: Any):
        part = self.topic(topic).partition_for(key)
        return self._produce(topic, part, [(key, value)])[0]

    def send_to(self, topic: str, partition: int, key: str, value: Any):
        # Explicit-partition produce (the sharded ingest tier's md5
        # routing) must hit the SAME disk-first path as keyed sends — the
        # inherited in-memory send_to would silently drop durability.
        part = self.topic(topic).partitions[partition]
        return self._produce(topic, part, [(key, value)])[0]

    def send_to_many(self, topic: str, partition: int, items):
        """The whole batch rides one group commit: one write pass + one
        fsync covers every record, and every ack releases together after
        that fsync."""
        part = self.topic(topic).partitions[partition]
        return self._produce(topic, part, list(items))

    def _produce(self, topic: str, part, items) -> list:
        entries = [_PendingAppend(topic, part, k, v) for k, v in items]
        if not entries:
            return []
        lead = False
        with self._gc_cv:
            while (len(self._gc_pending) >= self._gc_max_pending
                   and self._gc_leader):
                self._gc_cv.wait(0.05)  # bounded buffer: backpressure
            self._gc_pending.extend(entries)
            if not self._gc_leader:
                self._gc_leader = True
                lead = True
        if lead:
            self._drain_as_leader()
        for e in entries:
            e.done.wait()
            if e.error is not None:
                raise e.error
        return [e.msg for e in entries]

    def _drain_as_leader(self) -> None:
        """Group-commit drain loop: swap out whatever accumulated, write
        and fsync it as one batch, release its acks, repeat until the
        buffer is empty. Records staged while a batch is on disk form
        the next batch — the Kafka group-commit window."""
        while True:
            with self._gc_cv:
                batch = self._gc_pending
                self._gc_pending = []
                if not batch:
                    self._gc_leader = False
                    self._gc_cv.notify_all()
                    return
                self._gc_cv.notify_all()  # wake backpressured producers
            self._commit_batch(batch)

    def _commit_batch(self, batch: List[_PendingAppend]) -> None:
        t0 = time.perf_counter()
        touched: Dict[_SegmentStore, str] = {}
        nbytes = 0
        error: Optional[BaseException] = None
        with self._io_lock:
            try:
                # Disk first, memory second: a crash between the two
                # replays the batch from disk; the reverse order would
                # lose acked records.
                for e in batch:
                    frame = pickle.dumps((e.key, e.value))
                    store = self._store_for(e.topic, e.part.index)
                    store.append_frame(frame)
                    touched[store] = e.topic
                    nbytes += _FRAME_HDR.size + len(frame)
                for store, tname in touched.items():
                    store.fsync()
                    increment("durable.fsyncs_total")
                    increment(bounded("durable.fsyncs_by_topic", tname))
            except BaseException as exc:  # noqa: BLE001 — disk faults vary
                error = exc
        if error is not None:
            # Nothing in this batch is known durable: fail every sender
            # (none were acked, so at-least-once holds — callers retry).
            for e in batch:
                e.error = error
                e.done.set()
            return
        increment("durable.batch_bytes", nbytes)
        increment("durable.records_total", len(batch))
        increment("durable.group_commits")
        gauge("durable.last_batch_records", len(batch))
        # Acks release only now, after the covering fsync: the in-memory
        # append (whose return value / listener fire IS the ack) happens
        # per record in staging order, so per-partition order on disk and
        # in memory are identical.
        for e in batch:
            try:
                e.msg = e.part.append(e.key, e.value)
            except BaseException as exc:  # noqa: BLE001
                e.error = exc
            e.done.set()
        observe("durable.group_commit", (time.perf_counter() - t0) * 1000.0)

    # -- consume: indexed cold reads ---------------------------------------
    def poll(self, group: str, topic: str, partition: int = 0,
             limit: int = 1000) -> list:
        return self.read_from(topic, partition,
                              self.committed(group, topic, partition),
                              limit)

    def read_from(self, topic: str, partition: int, offset: int,
                  limit: int = 1000) -> list:
        part = self.topic(topic).partitions[partition]
        if offset >= part.base_offset:
            return part.read(offset, limit)
        # Cold read below the resident window (replay="committed" open):
        # serve from the segment files via the sparse index.
        store = self._stores.get((topic, partition))
        if store is None:
            return part.read(offset, limit)
        with self._io_lock:
            rows = store.read(offset, limit)
        from .log import QueuedMessage
        return [QueuedMessage(topic, partition, off, key, value)
                for off, key, value in rows]

    # -- offsets -----------------------------------------------------------
    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        super().commit(group, topic, partition, offset)
        self._persist_offsets()

    def commit_many(self, group: str, topic: str, offsets) -> None:
        # Batched cross-partition ack: ONE offsets-file rewrite for the
        # whole batch (the per-commit fsync'd rewrite is the expensive
        # half on this engine).
        super().commit_many(group, topic, offsets)
        self._persist_offsets()

    def _persist_offsets(self) -> None:
        with self._io_lock:
            dump = {f"{g}|{t}|{p}": off
                    for (g, t, p), off in self.checkpoints.items()}
            tmp = self._offsets_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dump, f)
                f.flush()
                # fsync BEFORE the rename: os.replace is atomic in the
                # namespace but says nothing about the data — without
                # this, a crash can publish a zero-length/torn offsets
                # file under the final name.
                os.fsync(f.fileno())
            os.replace(tmp, self._offsets_path)

    def durable_stats(self) -> dict:
        """Monitor probe surface (server/monitor.py watch_durable)."""
        with self._gc_cv:
            pending = len(self._gc_pending)
        with self._io_lock:
            segments = sum(s.segment_count for s in self._stores.values())
            truncated = sum(s.truncated_bytes for s in self._stores.values())
        return {"pendingAppends": pending, "segments": segments,
                "tornBytesTruncated": truncated,
                "partitions": len(self._stores)}

    def close(self) -> None:
        # Drain in-flight group commits before tearing down the handles.
        with self._gc_cv:
            while self._gc_leader or self._gc_pending:
                self._gc_cv.wait(0.05)
        with self._io_lock:
            for store in self._stores.values():
                store.close()
            self._stores.clear()


# ---------------------------------------------------------------------------
# file-backed git storage
# ---------------------------------------------------------------------------

class FileGitStore(GitStore):
    """GitStore whose objects/refs persist under a directory:
    <root>/objects/<sha> (JSON-framed object) and <root>/refs.json —
    the gitrest bare-repo equivalent. Loads everything at construction
    (object counts here are summary-scale, not monorepo-scale)."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self._objdir = os.path.join(root, "objects")
        os.makedirs(self._objdir, exist_ok=True)
        self._refs_path = os.path.join(root, "refs.json")
        if os.path.exists(self._refs_path):
            with open(self._refs_path) as f:
                self._refs.update(json.load(f))
        for sha in os.listdir(self._objdir):
            self._objects[sha] = self._load_object(sha)

    def _load_object(self, sha: str):
        with open(os.path.join(self._objdir, sha), "rb") as f:
            framed = json.loads(f.read().decode("utf-8"))
        kind = framed["kind"]
        if kind == "blob":
            return GitBlob(sha, bytes.fromhex(framed["content"]))
        if kind == "tree":
            return GitTree(sha, {k: tuple(v)
                                 for k, v in framed["entries"].items()})
        return GitCommit(sha, framed["tree"], framed["parents"],
                         framed["message"], framed["timestamp"])

    def _persist_object(self, sha: str, obj) -> None:
        path = os.path.join(self._objdir, sha)
        if os.path.exists(path):
            return  # content-addressed: same sha == same bytes
        if isinstance(obj, GitBlob):
            framed = {"kind": "blob", "content": obj.content.hex()}
        elif isinstance(obj, GitTree):
            framed = {"kind": "tree",
                      "entries": {k: list(v)
                                  for k, v in obj.entries.items()}}
        else:
            framed = {"kind": "commit", "tree": obj.tree_sha,
                      "parents": obj.parents, "message": obj.message,
                      "timestamp": obj.timestamp}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(framed, f)
        os.replace(tmp, path)  # atomic publish

    def put_blob(self, content: bytes) -> str:
        sha = super().put_blob(content)
        self._persist_object(sha, self._objects[sha])
        return sha

    def put_tree(self, entries) -> str:
        sha = super().put_tree(entries)
        self._persist_object(sha, self._objects[sha])
        return sha

    def put_commit(self, tree_sha, parents, message) -> str:
        sha = super().put_commit(tree_sha, parents, message)
        self._persist_object(sha, self._objects[sha])
        return sha

    def set_ref(self, name: str, commit_sha: str) -> None:
        super().set_ref(name, commit_sha)
        tmp = self._refs_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._refs, f)
        os.replace(tmp, self._refs_path)


class FileHistorian(Historian):
    """Historian whose per-document stores persist under
    <root>/<tenant>/<document>/ (reference gitrest's repo-per-document
    layout behind the historian proxy)."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def store(self, tenant_id: str, document_id: str) -> GitStore:
        key = (tenant_id, document_id)
        with self._lock:
            if key not in self._stores:
                self._stores[key] = FileGitStore(
                    os.path.join(self.root, _safe(tenant_id),
                                 _safe(document_id)))
            return self._stores[key]


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
