"""The port's DDSes, held to the JAX package's: a mirror of
tests/test_dds.py, tests/test_dds_depth.py and tests/test_small_dds.py.

Every assertion of those files is made again on fluidframework_tpu_torch's
classes, over its MockSequencedEnvironment and, for the small DDSes, its
Loader on its own LocalServer, on the CPU (device="cpu"; without it they
take the card). The parity cases at the end run one seeded op script
through both packages and require equal summaries, byte for byte, for each
of the 14 types of the default registry.
"""

import random
import threading
import time

import pytest

from fluidframework_tpu_torch.core.events import Deferred
from fluidframework_tpu_torch.dds.cell import SharedCell
from fluidframework_tpu_torch.dds.counter import SharedCounter
from fluidframework_tpu_torch.dds.directory import SharedDirectory
from fluidframework_tpu_torch.dds.ink import Ink
from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.matrix import SharedMatrix
from fluidframework_tpu_torch.dds.ordered_collection import ConsensusQueue
from fluidframework_tpu_torch.dds.register_collection import (
    ConsensusRegisterCollection, READ_LWW)
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.dds.sparse_matrix import SparseMatrix
from fluidframework_tpu_torch.dds.summary_block import SharedSummaryBlock
from fluidframework_tpu_torch.loader import container as port_container
from fluidframework_tpu_torch.loader.drivers.local import \
    LocalDocumentServiceFactory
from fluidframework_tpu_torch.runtime import container_runtime as port_runtime
from fluidframework_tpu_torch.server.local_server import LocalServer
from fluidframework_tpu_torch.testing import mocks as port_mocks


def Loader(*args, **kwargs):
    return port_container.Loader(*args, device="cpu", **kwargs)


def MockSequencedEnvironment(*args, **kwargs):
    return port_mocks.MockSequencedEnvironment(*args, device="cpu", **kwargs)


def ContainerRuntime(*args, **kwargs):
    return port_runtime.ContainerRuntime(*args, device="cpu", **kwargs)


# --- mirrors tests/test_dds.py ---------------------------------------------

def pair(env, dds_cls, object_id="obj"):
    """Two connected runtimes each holding a replica of one DDS."""
    r1 = env.create_runtime()
    r2 = env.create_runtime()
    ds1 = r1.create_datastore("ds")
    ds2 = r2.create_datastore("ds")
    a = ds1.create_channel(object_id, dds_cls.TYPE)
    b = ds2.create_channel(object_id, dds_cls.TYPE)
    env.process_all()  # joins
    return r1, r2, a, b


class TestSharedMap:
    def test_set_get_converges(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("k", 1)
        b.set("j", {"nested": True})
        env.process_all()
        assert a.get("k") == b.get("k") == 1
        assert a.get("j") == b.get("j") == {"nested": True}

    def test_lww_conflict(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("k", "from-a")
        b.set("k", "from-b")
        env.process_all()
        assert a.get("k") == b.get("k")  # whoever sequenced last wins

    def test_pending_shadows_remote(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("k", "a1")
        env.process_all()
        b.set("k", "b1")           # b's write in flight
        a.set("k", "a2")           # a writes again, also in flight
        # Deliver b's first: a must keep showing its pending value.
        rng = random.Random(3)
        env.process_all(rng)
        assert a.get("k") == b.get("k")

    def test_clear_and_delete(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("x", 1)
        a.set("y", 2)
        env.process_all()
        b.delete("x")
        env.process_all()
        assert not a.has("x") and a.get("y") == 2
        a.clear()
        env.process_all()
        assert len(b) == 0

    def test_reconnect_resubmits(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("survives", "yes")
        env.disconnect(r1)
        env.process_all()
        assert not b.has("survives")
        env.reconnect(r1)
        env.process_all()
        assert b.get("survives") == "yes"


class TestSharedString:
    def test_concurrent_editing(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedString)
        a.insert_text(0, "hello world")
        env.process_all()
        b.insert_text(5, ",")
        a.remove_text(0, 1)
        a.insert_text(0, "H")
        env.process_all()
        assert a.get_text() == b.get_text() == "Hello, world"

    def test_annotate(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedString)
        a.insert_text(0, "styled")
        env.process_all()
        b.annotate_range(0, 6, {"bold": True})
        env.process_all()
        assert any(s.props == {"bold": True}
                   for s in a.client.tree.segments)

    def test_reconnect_with_offline_edits(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedString)
        a.insert_text(0, "base")
        env.process_all()
        env.disconnect(r1)
        a.insert_text(4, " offline")
        b.insert_text(0, "B:")
        env.process_all()
        env.reconnect(r1)
        env.process_all()
        assert a.get_text() == b.get_text()
        assert "offline" in a.get_text() and "B:" in a.get_text()

    def test_summary_roundtrip_into_new_runtime(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedString)
        a.insert_text(0, "persist me")
        a.annotate_range(0, 7, {"em": 1})
        env.process_all()
        summary = r1.summarize()
        # New environment loads from the summary.
        env2 = MockSequencedEnvironment()
        r3 = env2.create_runtime()
        r3.load(summary)
        env2.process_all()
        c = r3.get_datastore("ds").get_channel("obj")
        assert c.get_text() == "persist me"


class TestSmallDDSes:
    def test_counter(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedCounter)
        a.increment(5)
        b.increment(-2)
        env.process_all()
        assert a.value == b.value == 3

    def test_cell(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedCell)
        a.set({"payload": 1})
        env.process_all()
        assert b.get() == {"payload": 1}
        b.delete()
        env.process_all()
        assert a.empty() and b.empty()

    def test_directory_subdirs(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedDirectory)
        sub = a.create_sub_directory("settings")
        sub.set("theme", "dark")
        a.set("rootKey", 1)
        env.process_all()
        assert b.get_sub_directory("settings").get("theme") == "dark"
        assert b.get("rootKey") == 1
        b.get_sub_directory("settings").set("theme", "light")
        env.process_all()
        assert a.get_sub_directory("settings").get("theme") == "light"

    def test_register_collection_versions(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, ConsensusRegisterCollection)
        acks = []
        a.write("leader", "alice", on_ack=lambda won: acks.append(won))
        b.write("leader", "bob")
        env.process_all()
        # Concurrent writes: both versions retained, same on both replicas.
        assert a.read_versions("leader") == b.read_versions("leader")
        assert len(a.read_versions("leader")) == 2
        # a's ack says whether its write became the atomic (first) version.
        assert acks == [a.read("leader") == "alice"]
        # A later write that has seen everything supersedes.
        a.write("leader", "carol")
        env.process_all()
        assert b.read_versions("leader") == ["carol"]
        assert b.read("leader", READ_LWW) == "carol"

    def test_consensus_queue_acquire(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, ConsensusQueue)
        a.add("task-1")
        env.process_all()
        got = []
        a.acquire(lambda item_id, value: got.append((item_id, value)))
        b.acquire(lambda item_id, value: got.append((item_id, value)))
        env.process_all()
        # Exactly one acquirer got the task; queues agree it is leased.
        values = [v for _, v in got]
        assert values.count("task-1") == 1 and values.count(None) == 1
        assert len(a.jobs) == len(b.jobs) == 1
        # Complete clears the lease everywhere.
        item_id = next(iter(a.jobs))
        a.complete(item_id)
        env.process_all()
        assert not a.jobs and not b.jobs


class TestSharedMatrix:
    def test_rows_cols_cells(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 2)
        a.insert_cols(0, 2)
        env.process_all()
        assert (b.row_count, b.col_count) == (2, 2)
        a.set_cell(0, 0, "tl")
        b.set_cell(1, 1, "br")
        env.process_all()
        assert a.extract() == b.extract() == [["tl", None], [None, "br"]]

    def test_concurrent_row_insert_and_cell_set(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 2)
        a.insert_cols(0, 1)
        env.process_all()
        a.set_cell(1, 0, "stable")  # address row 1 by stable id
        b.insert_rows(0, 1)         # concurrently shift positions
        env.process_all()
        # The cell stayed with its row despite the index shift.
        assert a.extract() == b.extract()
        assert a.extract()[2][0] == "stable"

    def test_remove_rows(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 3)
        a.insert_cols(0, 1)
        env.process_all()
        a.set_cell(0, 0, "r0")
        a.set_cell(2, 0, "r2")
        env.process_all()
        b.remove_rows(1, 1)
        env.process_all()
        assert a.extract() == b.extract() == [["r0"], ["r2"]]

    def test_matrix_summary_roundtrip(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 2)
        a.insert_cols(0, 2)
        env.process_all()
        a.set_cell(0, 1, 42)
        env.process_all()
        summary = r1.summarize()
        env2 = MockSequencedEnvironment()
        r3 = env2.create_runtime()
        r3.load(summary)
        c = r3.get_datastore("ds").get_channel("obj")
        assert c.extract() == a.extract()


class TestDetachedAttach:
    def test_detached_edits_ship_via_summary(self):
        detached = ContainerRuntime()
        ds = detached.create_datastore("ds")
        s = ds.create_channel("text", SharedString.TYPE)
        m = ds.create_channel("meta", SharedMap.TYPE)
        s.insert_text(0, "created offline")
        m.set("k", 1)
        # Attach: connect channels, take the attach summary.
        for ch in (s, m):
            ch.connect()
        summary = detached.summarize()
        env = MockSequencedEnvironment()
        r = env.create_runtime()
        r.load(summary)
        env.process_all()
        assert r.get_datastore("ds").get_channel("text").get_text() == \
            "created offline"
        assert r.get_datastore("ds").get_channel("meta").get("k") == 1


class TestReviewRegressions:
    """Repros from code review: silent-divergence bugs must stay fixed."""

    def test_loaded_runtime_can_edit(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("k", 1)
        env.process_all()
        summary = r1.summarize()
        r3 = env.create_runtime()
        r3.load(summary)
        env.process_all()
        c = r3.get_datastore("ds").get_channel("obj")
        c.set("new", 42)
        env.process_all()
        assert a.get("new") == b.get("new") == 42

    def test_directory_offline_subdir_survives_reconnect(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedDirectory)
        env.disconnect(r1)
        a.create_sub_directory("settings").set("theme", "dark")
        env.reconnect(r1)
        env.process_all()
        assert b.get_sub_directory("settings") is not None
        assert b.get_sub_directory("settings").get("theme") == "dark"

    def test_queue_add_survives_reconnect(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, ConsensusQueue)
        a.add("task-1")
        env.disconnect(r1)
        env.reconnect(r1)
        env.process_all()
        assert [i["value"] for i in b.items] == ["task-1"]

    def test_register_write_survives_reconnect(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, ConsensusRegisterCollection)
        acks = []
        a.write("leader", "alice", on_ack=acks.append)
        env.disconnect(r1)
        env.reconnect(r1)
        env.process_all()
        assert b.read("leader") == "alice"
        assert acks == [True]

    def test_prejoin_matrix_inserts_do_not_collide(self):
        env = MockSequencedEnvironment()
        r1 = env.create_runtime()
        r2 = env.create_runtime()
        a = r1.create_datastore("ds").create_channel("m", SharedMatrix.TYPE)
        b = r2.create_datastore("ds").create_channel("m", SharedMatrix.TYPE)
        # Edits before any join is sequenced.
        a.insert_rows(0, 1)
        b.insert_rows(0, 1)
        env.process_all()
        assert a.row_count == b.row_count == 2
        a.insert_cols(0, 1)
        env.process_all()
        a.set_cell(0, 0, "first")
        env.process_all()
        assert a.extract() == b.extract()
        assert a.extract()[1][0] is None  # distinct rows, no aliasing

    def test_queue_lease_released_on_client_leave(self):
        import json as _json
        from fluidframework_tpu_torch.protocol.messages import (
            MessageType, SequencedDocumentMessage)
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, ConsensusQueue)
        a.add("job")
        env.process_all()
        got = []
        a.acquire(lambda i, v: got.append((i, v)))
        env.process_all()
        assert a.jobs and b.jobs
        # r1's client leaves the quorum: its lease must release everywhere.
        state = env._state_of(r1)
        env.seq += 1
        leave = SequencedDocumentMessage(
            client_id=state.client_id, sequence_number=env.seq,
            minimum_sequence_number=env.seq - 1, client_sequence_number=0,
            reference_sequence_number=env.seq - 1,
            type=MessageType.CLIENT_LEAVE,
            contents={"clientId": state.client_id})
        for s in env.clients.values():
            s.runtime.process(leave)
            s.last_seen_seq = env.seq
        assert not b.jobs
        assert [i["value"] for i in b.items] == ["job"]


# --- mirrors tests/test_dds_depth.py ---------------------------------------

class TestDeferred:
    def test_resolve_and_result(self):
        d = Deferred()
        assert not d.settled
        d.resolve(42)
        assert d.settled
        assert d.result(0) == 42

    def test_reject_raises(self):
        d = Deferred()
        d.reject(ValueError("nope"))
        with pytest.raises(ValueError):
            d.result(0)

    def test_timeout(self):
        with pytest.raises(TimeoutError):
            Deferred().result(0.01)

    def test_settles_only_once(self):
        d = Deferred()
        d.resolve(1)
        d.resolve(2)
        d.reject(RuntimeError("late"))
        assert d.result(0) == 1


class TestMapWait:
    def test_wait_returns_immediately_when_present(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        a.set("k", "v")
        env.process_all()
        assert b.wait("k", timeout=0) == "v"

    def test_wait_resolves_on_remote_set_from_another_thread(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)

        def setter():
            time.sleep(0.05)
            a.set("slow", "arrived")
            env.process_all()
        t = threading.Thread(target=setter)
        t.start()
        try:
            assert b.wait("slow", timeout=5) == "arrived"
        finally:
            t.join()

    def test_wait_times_out(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        with pytest.raises(TimeoutError):
            b.wait("never", timeout=0.02)

    def test_wait_listener_removed_after_resolution(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMap)
        before = b.listener_count("valueChanged")
        a.set("k", 1)
        env.process_all()
        b.wait("k", timeout=0)
        assert b.listener_count("valueChanged") == before


class TestDirectoryWait:
    def test_root_wait(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedDirectory)
        a.set("k", 9)
        env.process_all()
        assert b.wait("k", timeout=0) == 9

    def test_subdirectory_wait_is_path_scoped(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedDirectory)
        a.create_sub_directory("inner")
        env.process_all()
        inner_b = b.get_sub_directory("inner")
        # A root-level set of the same key must NOT satisfy the subdir wait.
        a.set("k", "root-value")
        env.process_all()
        with pytest.raises(TimeoutError):
            inner_b.wait("k", timeout=0.02)
        a.get_sub_directory("inner").set("k", "inner-value")
        env.process_all()
        assert inner_b.wait("k", timeout=0) == "inner-value"


class Recorder:
    """An IMatrixConsumer: records every notification."""

    def __init__(self):
        self.rows = []
        self.cols = []
        self.cells = []

    def rows_changed(self, pos, delta):
        self.rows.append((pos, delta))

    def cols_changed(self, pos, delta):
        self.cols.append((pos, delta))

    def cells_changed(self, row, col, value):
        self.cells.append((row, col, value))


class TestMatrixConsumers:
    def test_local_notifications(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        rec = Recorder()
        a.open_matrix(rec)
        a.insert_rows(0, 2)
        a.insert_cols(0, 3)
        a.set_cell(1, 2, "x")
        a.remove_rows(0, 1)
        assert rec.rows == [(0, 2), (0, -1)]
        assert rec.cols == [(0, 3)]
        assert rec.cells == [(1, 2, "x")]

    def test_remote_axis_changes_resolve_positions(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 3)
        a.insert_cols(0, 1)
        env.process_all()
        rec = Recorder()
        b.open_matrix(rec)
        a.insert_rows(1, 2)   # remote insert in the middle of b's view
        a.remove_rows(0, 1)   # then remove the first row
        env.process_all()
        assert rec.rows == [(1, 2), (0, -1)]

    def test_remote_cell_changes_resolve_indices(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 2)
        a.insert_cols(0, 2)
        env.process_all()
        rec = Recorder()
        b.open_matrix(rec)
        got = []
        b.on("cellChanged", lambda row, col, value, local, prev:
             got.append((row, col, value, local)))
        a.set_cell(1, 0, "val")
        env.process_all()
        assert rec.cells == [(1, 0, "val")]
        assert got == [(1, 0, "val", False)]

    def test_cell_write_to_removed_row_reports_no_indices(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 2)
        a.insert_cols(0, 1)
        env.process_all()
        got = []
        rec = Recorder()
        b.open_matrix(rec)
        b.on("cellChanged", lambda row, col, value, local, prev:
             got.append((row, col)))
        # a writes to row 1 while b concurrently removes it: the sequenced
        # cell op lands after the removal on b's replica.
        a.set_cell(1, 0, "ghost")
        b.remove_rows(1, 1)
        env.process_all()
        # The event fired with an unresolvable row (col intact); the
        # consumer (which needs addressable coordinates) was skipped.
        assert (None, 0) in got
        assert all(c[0] is not None for c in rec.cells)

    def test_overlapping_remove_emits_no_spurious_change(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        a.insert_rows(0, 3)
        a.insert_cols(0, 1)
        env.process_all()
        rec = Recorder()
        b.open_matrix(rec)
        # Both replicas remove the same row concurrently; b's view already
        # dropped it locally, so the remote (winning) remove is silent.
        a.remove_rows(1, 1)
        b.remove_rows(1, 1)
        env.process_all()
        assert rec.rows == [(1, -1)]  # b's own local remove only
        assert a.extract() == b.extract()

    def test_close_matrix_stops_notifications(self):
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedMatrix)
        rec = Recorder()
        a.open_matrix(rec)
        a.insert_rows(0, 1)
        a.close_matrix(rec)
        a.insert_rows(0, 1)
        assert rec.rows == [(0, 1)]


class TestMarkerQueries:
    def _string(self):
        from fluidframework_tpu_torch.dds.sequence import SharedString
        env = MockSequencedEnvironment()
        r1, r2, a, b = pair(env, SharedString, "text")
        return env, a, b

    def test_get_marker_from_id(self):
        env, a, b = self._string()
        a.insert_text(0, "hello world")
        a.insert_marker(5, {"markerId": "sep", "style": "line"})
        env.process_all()
        pos, props = b.get_marker_from_id("sep")
        assert pos == 5 and props["style"] == "line"
        assert b.get_marker_from_id("ghost") is None
        # Markers keep their identity through concurrent edits.
        b.insert_text(0, ">> ")
        env.process_all()
        assert a.get_marker_from_id("sep")[0] == 8

    def test_search_for_marker_both_directions(self):
        env, a, b = self._string()
        a.insert_text(0, "0123456789")
        a.insert_marker(2, {"tileLabels": ["pg"], "n": 1})
        a.insert_marker(7, {"tileLabels": ["pg"], "n": 2})
        a.insert_marker(9, {"tileLabels": ["hdr"], "n": 3})
        env.process_all()
        assert b.search_for_marker(0, "pg")[1]["n"] == 1
        assert b.search_for_marker(3, "pg")[1]["n"] == 2
        assert b.search_for_marker(8, "pg", forwards=False)[1]["n"] == 2
        assert b.search_for_marker(1, "pg", forwards=False) is None
        assert b.search_for_marker(3, "hdr")[1]["n"] == 3
        assert b.search_for_marker(12, "pg") is None


# --- mirrors tests/test_small_dds.py ---------------------------------------

def make_pair(dds_type):
    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ds1 = c1.runtime.create_datastore("default")
    ch1 = ds1.create_channel("x", dds_type)
    c1.attach()
    c2 = loader.resolve("doc")
    ch2 = c2.runtime.get_datastore("default").get_channel("x")
    return server, loader, (c1, ch1), (c2, ch2)


class TestInk:
    def test_strokes_converge(self):
        server, loader, (c1, i1), (c2, i2) = make_pair(Ink.TYPE)
        sid = i1.create_stroke({"color": "red", "thickness": 3})
        i1.append_point_to_stroke(sid, {"x": 1, "y": 2})
        i2.append_point_to_stroke(sid, {"x": 3, "y": 4})
        s1, s2 = i1.get_stroke(sid), i2.get_stroke(sid)
        assert s1["points"] == s2["points"]
        assert len(s1["points"]) == 2
        assert s1["pen"] == {"color": "red", "thickness": 3}

    def test_clear(self):
        server, loader, (c1, i1), (c2, i2) = make_pair(Ink.TYPE)
        i1.create_stroke()
        i2.clear()
        assert i1.get_strokes() == [] and i2.get_strokes() == []

    def test_summary_roundtrip(self):
        server, loader, (c1, i1), (c2, i2) = make_pair(Ink.TYPE)
        sid = i1.create_stroke({"color": "blue"})
        i1.append_point_to_stroke(sid, {"x": 0, "y": 0})
        c1.summarize()
        server.pump()
        c3 = loader.resolve("doc")
        i3 = c3.runtime.get_datastore("default").get_channel("x")
        assert i3.get_stroke(sid)["points"] == [{"x": 0, "y": 0}]


class TestSharedSummaryBlock:
    def test_persists_only_via_summary(self):
        server, loader, (c1, b1), (c2, b2) = make_pair(
            SharedSummaryBlock.TYPE)
        b1.set("index", {"terms": ["a", "b"]})
        # No ops flow: the second client does NOT see it live.
        assert b2.get("index") is None
        c1.summarize()
        server.pump()
        c3 = loader.resolve("doc")
        b3 = c3.runtime.get_datastore("default").get_channel("x")
        assert b3.get("index") == {"terms": ["a", "b"]}

    def test_rejects_non_serializable(self):
        server, loader, (c1, b1), _ = make_pair(SharedSummaryBlock.TYPE)
        with pytest.raises(TypeError):
            b1.set("bad", object())


class TestSparseMatrix:
    def test_rows_and_items(self):
        server, loader, (c1, m1), (c2, m2) = make_pair(SparseMatrix.TYPE)
        m1.insert_rows(0, 3)
        m1.set_items(0, 2, ["a", "b", "c"])
        assert m2.get_item(0, 2) == "a"
        assert m2.get_item(0, 4) == "c"
        assert m2.get_item(0, 100) is None
        assert m1.num_rows == m2.num_rows == 3
        assert m1.num_cols == 1 << 31

    def test_row_insert_shifts_identity(self):
        server, loader, (c1, m1), (c2, m2) = make_pair(SparseMatrix.TYPE)
        m1.insert_rows(0, 2)
        m1.set_items(1, 0, ["keep"])
        m2.insert_rows(0, 1)  # shifts rows down
        assert m1.get_item(2, 0) == "keep"
        assert m2.get_item(2, 0) == "keep"

    def test_remove_rows(self):
        server, loader, (c1, m1), (c2, m2) = make_pair(SparseMatrix.TYPE)
        m1.insert_rows(0, 3)
        m1.set_items(2, 0, ["last"])
        m2.remove_rows(0, 2)
        assert m1.num_rows == m2.num_rows == 1
        assert m1.get_item(0, 0) == m2.get_item(0, 0) == "last"


# --- parity with the JAX package, one op script per registry type ----------

import itertools  # noqa: E402
import json  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def jax_modules():
    import fluidframework_tpu.dds.ink as ink
    import fluidframework_tpu.dds.ordered_collection as ordered
    import fluidframework_tpu.dds.sequence as sequence
    from fluidframework_tpu.protocol import summary
    from fluidframework_tpu.runtime.datastore_runtime import default_registry
    from fluidframework_tpu.testing.mocks import MockSequencedEnvironment
    return SimpleNamespace(env=MockSequencedEnvironment, ink=ink,
                           ordered=ordered, sequence=sequence,
                           summary=summary, registry=default_registry)


def port_modules():
    import fluidframework_tpu_torch.dds.ink as ink
    import fluidframework_tpu_torch.dds.ordered_collection as ordered
    import fluidframework_tpu_torch.dds.sequence as sequence
    from fluidframework_tpu_torch.protocol import summary
    from fluidframework_tpu_torch.runtime.datastore_runtime import \
        default_registry
    return SimpleNamespace(env=MockSequencedEnvironment, ink=ink,
                           ordered=ordered, sequence=sequence,
                           summary=summary, registry=default_registry)


class CountingUuid:
    """Stands in for the uuid module: uuid4() counts."""

    def __init__(self):
        self._n = itertools.count(1)

    def uuid4(self):
        return SimpleNamespace(hex=f"{next(self._n):032x}")


def edit_sequence(ch, rng, i, kind):
    n = ch.get_length()
    r = rng.random()
    if n > 6 and r < 0.25:
        a = rng.randrange(n - 1)
        if kind == "text":
            ch.remove_text(a, a + 1 + rng.randrange(min(3, n - a - 1)))
        elif kind == "items":
            ch.remove_range(a, a + 1)
        else:
            ch.submit_local_message(ch.client.remove_range_local(a, a + 1))
    elif n > 3 and r < 0.35:
        a = rng.randrange(n - 1)
        props = {"w": i}
        if kind == "base":
            ch.submit_local_message(
                ch.client.annotate_range_local(a, a + 1, props))
        else:
            ch.annotate_range(a, a + 1, props)
    else:
        at = rng.randrange(n + 1)
        if kind == "text":
            ch.insert_text(at, f"<{i}>")
        elif kind == "items":
            ch.insert_range(at, [i, {"v": i}] if ch.TYPE.endswith(
                "ObjectSequence") else [i, i + 1])
        else:
            ch.submit_local_message(
                ch.client.insert_text_local(at, f"<{i}>"))


def edit(ch, rng, i):
    """One seeded edit on a replica of any of the registry's types."""
    t = ch.TYPE.rsplit("/", 1)[-1]
    if t in ("mergeTree", "string", "numberSequence", "objectSequence"):
        kind = {"mergeTree": "base", "string": "text"}.get(t, "items")
        edit_sequence(ch, rng, i, kind)
    elif t == "map":
        if rng.random() < 0.2:
            ch.delete(f"k{rng.randrange(5)}")
        else:
            ch.set(f"k{rng.randrange(5)}", [i, "v"])
    elif t == "counter":
        ch.increment(rng.randrange(1, 4))
    elif t == "cell":
        if rng.random() < 0.2:
            ch.delete()
        else:
            ch.set({"i": i})
    elif t == "directory":
        sub = ch.get_working_directory(f"/s{rng.randrange(2)}") or \
            ch.root.create_sub_directory(f"s{rng.randrange(2)}")
        sub.set(f"k{rng.randrange(4)}", i)
    elif t == "consensus-register-collection":
        ch.write(f"r{rng.randrange(3)}", i)
    elif t == "consensus-queue":
        if rng.random() < 0.6:
            ch.add(i)
        else:
            ch.acquire(lambda item_id, value: None)
    elif t in ("sharedmatrix", "sparse-matrix"):
        if ch.row_count < 3 or rng.random() < 0.1:
            ch.insert_rows(rng.randrange(ch.row_count + 1), 1)
        elif t == "sharedmatrix" and (ch.col_count < 3
                                      or rng.random() < 0.1):
            ch.insert_cols(rng.randrange(ch.col_count + 1), 1)
        elif t == "sharedmatrix":
            ch.set_cell(rng.randrange(ch.row_count),
                        rng.randrange(ch.col_count), i)
        else:
            ch.set_items(rng.randrange(ch.row_count), rng.randrange(8),
                         [i, i + 1])
    elif t == "ink":
        ch.create_stroke({"color": i % 3})
    elif t == "shared-summary-block":
        ch.set(f"k{rng.randrange(4)}", i)
    else:
        raise AssertionError(f"no op script for {ch.TYPE}")


def summary_of_script(mods, type_name, seed=5, steps=60):
    """Two replicas of one channel edited in seeded turns, sequenced in
    batches; returns the first replica's summary in dict form."""
    saved = (mods.ink._stroke_uid, mods.sequence._interval_uid,
             mods.ordered.uuid, random.getstate())
    mods.ink._stroke_uid = itertools.count(1)
    mods.sequence._interval_uid = itertools.count(1)
    mods.ordered.uuid = CountingUuid()
    random.seed(seed)
    try:
        env = mods.env()
        r1, r2 = env.create_runtime(), env.create_runtime()
        a = r1.create_datastore("ds").create_channel("obj", type_name)
        b = r2.create_datastore("ds").create_channel("obj", type_name)
        env.process_all()
        rng = random.Random(seed)
        for i in range(steps):
            edit(a if rng.random() < 0.5 else b, rng, i)
            if i % 7 == 6:
                env.process_all()
        env.process_all()
        return json.dumps(mods.summary.summary_tree_to_dict(a.summarize()),
                          sort_keys=True)
    finally:
        (mods.ink._stroke_uid, mods.sequence._interval_uid,
         mods.ordered.uuid, state) = saved
        random.setstate(state)


REGISTRY_TYPES = sorted(port_modules().registry().types())


def test_registry_holds_the_fourteen_types():
    assert len(REGISTRY_TYPES) == 14
    assert REGISTRY_TYPES == sorted(jax_modules().registry().types())


@pytest.mark.parametrize("type_name", REGISTRY_TYPES,
                         ids=lambda t: t.rsplit("/", 1)[-1])
def test_summary_equals_jax(type_name):
    """The same seeded op script through the JAX DDS and the port's gives
    the same summary, byte for byte."""
    want = summary_of_script(jax_modules(), type_name)
    got = summary_of_script(port_modules(), type_name)
    assert got == want
    assert len(got) > 200  # the script reached the channel's state
