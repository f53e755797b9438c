"""Durable backends: checkpoints/deltas/summaries survive process death
(reference: Mongo-backed lambda checkpoints + gitrest bare repos on disk;
scriptorium/lambda.ts:16-103).

A mirror of tests/test_durable.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

import functools

import pytest
import torch

from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as _container
from fluidframework_tpu_torch.loader.drivers.local import LocalDocumentServiceFactory
from fluidframework_tpu_torch.server.durable import (
    FileGitStore,
    FileHistorian,
    SqliteDatabaseManager,
)
from fluidframework_tpu_torch.server.local_server import LocalServer


torch.set_num_threads(1)

# The port runs on the card unless told otherwise; these tests run on
# the CPU.
Loader = functools.partial(_container.Loader, device="cpu")


class TestSqliteCollection:
    def test_roundtrip_and_dup_key(self, tmp_path):
        db = SqliteDatabaseManager(str(tmp_path / "db.sqlite"))
        col = db.collection("deltas", unique_key=lambda d: (d["doc"],
                                                            d["seq"]))
        assert col.insert_one({"doc": "a", "seq": 1, "v": "x"})
        assert not col.insert_one({"doc": "a", "seq": 1, "v": "dup"})
        assert col.insert_one({"doc": "a", "seq": 2, "v": "y"})
        assert len(col) == 2
        assert col.find_one(lambda d: d["seq"] == 1)["v"] == "x"

        # A second connection (fresh process) sees the same rows.
        db2 = SqliteDatabaseManager(str(tmp_path / "db.sqlite"))
        col2 = db2.collection("deltas", unique_key=lambda d: (d["doc"],
                                                              d["seq"]))
        assert len(col2) == 2
        assert not col2.insert_one({"doc": "a", "seq": 2, "v": "dup"})

    def test_upsert_persists(self, tmp_path):
        path = str(tmp_path / "db.sqlite")
        db = SqliteDatabaseManager(path)
        col = db.collection("ckpt")
        col.upsert(lambda d: d.get("k") == "a", {"k": "a", "n": 1})
        col.upsert(lambda d: d.get("k") == "a", {"k": "a", "n": 2})
        assert len(col) == 1
        db.close()
        col2 = SqliteDatabaseManager(path).collection("ckpt")
        assert col2.find_one(lambda d: d["k"] == "a")["n"] == 2


class TestFileGitStore:
    def test_objects_and_refs_reload(self, tmp_path):
        root = str(tmp_path / "git")
        store = FileGitStore(root)
        b = store.put_blob(b"hello")
        t = store.put_tree({"f": ("blob", b)})
        c = store.put_commit(t, [], "first")
        store.set_ref("main", c)

        fresh = FileGitStore(root)
        assert fresh.get_ref("main") == c
        assert fresh.get(b).content == b"hello"
        assert fresh.get(t).entries["f"] == ("blob", b)
        assert fresh.get(c).tree_sha == t


def _durable_services(tmp_path):
    return (SqliteDatabaseManager(str(tmp_path / "db.sqlite")),
            FileHistorian(str(tmp_path / "git")))


class TestKillAndRestartE2E:
    def _services(self, tmp_path):
        return _durable_services(tmp_path)

    def test_server_death_resumes_from_disk(self, tmp_path):
        # Life 1: create, edit, summarize, edit past the summary.
        db1, hist1 = self._services(tmp_path)
        server1 = LocalServer(db=db1, historian=hist1)
        loader1 = Loader(LocalDocumentServiceFactory(server1))
        c1 = loader1.create_detached("doc")
        ds1 = c1.runtime.create_datastore("default")
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        m = ds1.create_channel("root", SharedMap.TYPE)
        text.insert_text(0, "summarized-part")
        m.set("k", 1)
        acked = []
        c1.summarize(lambda h, ok, _: acked.append(ok))
        server1.pump()
        assert acked == [True]
        text.insert_text(text.get_length(), "/tail-after-summary")
        m.set("k", 2)
        seq_before = server1.sequence_number("doc")
        final_text = text.get_text()
        db1.close()
        del server1  # process death: nothing handed over in memory

        # Life 2: fresh process over the same files.
        db2, hist2 = self._services(tmp_path)
        server2 = LocalServer(db=db2, historian=hist2)
        loader2 = Loader(LocalDocumentServiceFactory(server2))
        c2 = loader2.resolve("doc")
        ds2 = c2.runtime.get_datastore("default")
        assert ds2.get_channel("text").get_text() == final_text
        assert ds2.get_channel("root").get("k") == 2
        # Sequencing resumes past the old high-water mark (no seq reuse).
        t2 = ds2.get_channel("text")
        t2.insert_text(0, "!")
        assert server2.sequence_number("doc") > seq_before

    def test_restart_preserves_summary_commits(self, tmp_path):
        db1, hist1 = self._services(tmp_path)
        server1 = LocalServer(db=db1, historian=hist1)
        loader1 = Loader(LocalDocumentServiceFactory(server1))
        c1 = loader1.create_detached("doc")
        ds = c1.runtime.create_datastore("default")
        c1.attach()
        ds.create_channel("root", SharedMap.TYPE).set("a", 1)
        acked = []
        c1.summarize(lambda h, ok, _: acked.append((h, ok)))
        server1.pump()
        handle = acked[0][0]
        db1.close()

        _, hist2 = self._services(tmp_path)
        store = hist2.store("local", "doc")
        assert store.get(handle) is not None
        assert store.get_ref("main") == handle


class TestDurableMessageLog:
    def test_messages_and_offsets_survive_restart(self, tmp_path):
        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        root = str(tmp_path / "log")
        log = DurableMessageLog(root, default_partitions=2)
        for i in range(10):
            log.send("raw", f"k{i % 2}", {"n": i})
        log.commit("deli", "raw", 0, 2)
        log.close()

        fresh = DurableMessageLog(root, default_partitions=2)
        topic = fresh.topic("raw")
        total = sum(p.end_offset for p in topic.partitions)
        assert total == 10
        assert fresh.committed("deli", "raw", 0) == 3
        # Replayed payloads intact + appends continue at the right offset
        # (partitioning is a stable key hash, so "k0" lands on the same
        # partition in every process).
        part = fresh.topic("raw").partition_for("k0")
        first = part.read(0, 1)[0]
        assert first.value["n"] in (0, 1)
        before = part.end_offset
        fresh.send("raw", "k0", {"n": 99})
        assert part.end_offset == before + 1
        fresh.close()

    def test_torn_tail_write_is_dropped(self, tmp_path):
        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        root = str(tmp_path / "log")
        log = DurableMessageLog(root)
        log.send("raw", "k", {"n": 1})
        log.send("raw", "k", {"n": 2})
        log.close()
        # Simulate a mid-write crash: truncate into the tail segment's
        # final frame (segment layout: <topic>/<partition>.d/<base>.seg).
        segs = sorted((tmp_path / "log" / "raw" / "0.d").glob("*.seg"))
        assert segs, "segment layout expected"
        path = segs[-1]
        data = path.read_bytes()
        path.write_bytes(data[:-3])

        fresh = DurableMessageLog(root)
        part = fresh.topic("raw").partitions[0]
        assert part.end_offset == 1  # torn frame dropped, prefix intact
        assert part.read(0, 10)[0].value == {"n": 1}
        assert fresh.durable_stats()["tornBytesTruncated"] > 0
        fresh.close()

    def test_reopened_log_feeds_consumers(self, tmp_path):
        """A reopened durable log serves consumers from history: the broker
        restart story (workers replay their uncheckpointed suffix)."""
        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        root = str(tmp_path / "log")
        log = DurableMessageLog(root)
        log.topic("rawdeltas")
        for i in range(5):
            log.send("rawdeltas", "doc", {"op": i})
        log.commit("deli", "rawdeltas", 0, 1)  # processed through offset 1
        log.close()

        fresh = DurableMessageLog(root)
        pending = fresh.poll("deli", "rawdeltas", 0)
        assert [m.value["op"] for m in pending] == [2, 3, 4]
        fresh.close()


class TestGroupCommitEngine:
    """The segment-log engine's durability contract: one fsync covers a
    whole batch, acks release only after it, a kill mid-commit keeps the
    acked prefix bit-intact, and cold reads seek through the sparse
    offset index instead of scanning from zero."""

    def test_batch_rides_one_fsync_and_acks_after(self, tmp_path):
        from fluidframework_tpu_torch.server.durable import DurableMessageLog
        from fluidframework_tpu_torch.telemetry import counters

        log = DurableMessageLog(str(tmp_path / "log"))
        log.topic("raw", 1)
        before = counters.snapshot()
        msgs = log.send_to_many(
            "raw", 0, [("k", {"n": i}) for i in range(64)])
        after = counters.snapshot()
        assert [m.offset for m in msgs] == list(range(64))
        assert after.get("durable.fsyncs_total", 0) \
            - before.get("durable.fsyncs_total", 0) == 1
        assert after.get("durable.records_total", 0) \
            - before.get("durable.records_total", 0) == 64
        log.close()

    def test_kill_mid_group_commit_keeps_acked_prefix(self, tmp_path,
                                                      monkeypatch):
        """Disk dies during a batch's covering fsync: every sender in
        that batch gets the error (never acked), the process dies with
        the staged frames unflushed — and a fresh process sees exactly
        the previously ACKED records, nothing more, nothing torn."""
        from fluidframework_tpu_torch.server import durable as durable_mod
        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        root = str(tmp_path / "log")
        log = DurableMessageLog(root)
        log.topic("raw", 1)
        log.send_to_many("raw", 0, [("k", {"n": i}) for i in range(5)])

        def dead_fsync(self):
            raise OSError("simulated disk failure mid-commit")

        monkeypatch.setattr(durable_mod._SegmentStore, "fsync",
                            dead_fsync)
        with pytest.raises(OSError):
            log.send_to_many("raw", 0, [("k", {"n": 99}),
                                        ("k", {"n": 100})])
        monkeypatch.undo()
        # Process death: `log` is abandoned WITHOUT close(), so the
        # failed batch's userspace-buffered frames never reach disk.
        fresh = DurableMessageLog(root)
        part = fresh.topic("raw").partitions[0]
        assert part.end_offset == 5  # acked prefix, unacked tail gone
        assert [m.value["n"] for m in part.read(0, 10)] == list(range(5))
        fresh.close()

    def test_cold_reads_seek_via_index_across_segments(self, tmp_path):
        """Tiny segments force rolls; a fresh process (resident window
        empty) must serve arbitrary offsets through read_from() — the
        sparse-index seek path — without the legacy full replay."""
        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        root = str(tmp_path / "log")
        log = DurableMessageLog(root, segment_bytes=256, index_every=4)
        log.topic("raw", 1)
        for i in range(40):
            log.send_to("raw", 0, "k", {"n": i})
        assert log.durable_stats()["segments"] > 1
        log.close()

        fresh = DurableMessageLog(root, replay="committed")
        # replay="committed" with nothing committed keeps offset 0 as
        # base, but records stay ON DISK until polled — exercise seeks.
        for start, limit in ((0, 3), (17, 5), (38, 10)):
            got = fresh.read_from("raw", 0, start, limit)
            want = list(range(start, min(start + limit, 40)))
            assert [m.value["n"] for m in got] == want
            assert [m.offset for m in got] == want
        assert fresh.read_from("raw", 0, 40, 5) == []
        fresh.close()

    def test_concurrent_producers_all_acked_in_order(self, tmp_path):
        """Producer threads race the leader election; every record is
        acked exactly once and lands on its partition in a single total
        order with offsets dense from zero."""
        import threading

        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        log = DurableMessageLog(str(tmp_path / "log"))
        log.topic("raw", 4)
        errors = []

        def produce(t):
            try:
                for b in range(8):
                    log.send_to_many(
                        "raw", t % 4,
                        [(f"k{t}", {"t": t, "b": b, "i": i})
                         for i in range(16)])
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=produce, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        for p in range(4):
            part = log.topic("raw").partitions[p]
            msgs = part.read(0, 10 ** 6)
            assert part.end_offset == 2 * 8 * 16
            assert [m.offset for m in msgs] == list(range(len(msgs)))
            # Per-producer batches stay contiguous: the group commit
            # appends each sender's run intact.
            for t in (p, p + 4):
                seen = [(m.value["b"], m.value["i"]) for m in msgs
                        if m.value["t"] == t]
                assert seen == sorted(seen)
        log.close()

    def test_commit_many_one_atomic_rewrite(self, tmp_path):
        from fluidframework_tpu_torch.server.durable import DurableMessageLog

        root = str(tmp_path / "log")
        log = DurableMessageLog(root)
        log.topic("raw", 4)
        for p in range(4):
            log.send_to_many("raw", p,
                             [("k", {"i": i}) for i in range(p + 1)])
        # "Processed through offset p" on each partition — one atomic
        # fsync'd offsets.json rewrite covers the whole batch.
        log.commit_many("deli", "raw", {p: p for p in range(4)})
        log.close()
        fresh = DurableMessageLog(root)
        for p in range(4):
            assert fresh.committed("deli", "raw", p) == p + 1
        fresh.close()


class TestTpuKillAndRestart:
    def test_tpu_server_death_resumes_with_materialization(self, tmp_path):
        """TPU serving path over durable services: a fresh process restores
        ticket state from sqlite checkpoints, seeds merge lanes from the
        on-disk summary, replays the durable delta tail — and serves
        byte-correct materialized reads."""
        from fluidframework_tpu_torch.server.local_server import TpuLocalServer
        db1, hist1 = _durable_services(tmp_path)
        server1 = TpuLocalServer(db=db1, historian=hist1, device="cpu")
        loader1 = Loader(LocalDocumentServiceFactory(server1))
        c1 = loader1.create_detached("doc")
        ds1 = c1.runtime.create_datastore("default")
        text = ds1.create_channel("text", SharedString.TYPE)
        text.insert_text(0, "pre-attach base ")  # rides the attach summary
        c1.attach()
        text.insert_text(text.get_length(), "live-tail")
        final_text = text.get_text()
        seq_before = server1.sequence_number("doc")
        db1.close()
        del server1

        db2, hist2 = _durable_services(tmp_path)
        server2 = TpuLocalServer(db=db2, historian=hist2, device="cpu")
        loader2 = Loader(LocalDocumentServiceFactory(server2))
        c2 = loader2.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == final_text
        # Device materialization rebuilt across the process boundary.
        assert server2.sequencer().channel_text(
            "doc", "default", "text") == final_text
        t2.insert_text(0, "!")
        assert server2.sequence_number("doc") > seq_before
        assert server2.sequencer().channel_text(
            "doc", "default", "text") == "!" + final_text
