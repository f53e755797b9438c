"""The port's loader, container runtime and summarizer, held to the JAX
package's: a mirror of tests/test_e2e_local.py, tests/test_summarizer.py,
tests/test_lazy_snapshot.py and tests/test_runtime_features.py.

Every assertion of those files is made again on fluidframework_tpu_torch's
Loader, Container, runtime and DDSes over its own LocalServer and
TpuLocalServer, on the CPU (device="cpu"; without it they take the card).
"""

import json
import os

from fluidframework_tpu_torch.core.config import ConfigProvider
from fluidframework_tpu_torch.dds.counter import SharedCounter
from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as port_container
from fluidframework_tpu_torch.loader.drivers.local import \
    LocalDocumentServiceFactory
from fluidframework_tpu_torch.runtime.summarizer import (
    RunningSummarizer,
    SummaryCollection,
    SummaryConfig,
    SummaryManager,
    run_garbage_collection,
)
from fluidframework_tpu_torch.server import local_server as port_local
from fluidframework_tpu_torch.server.local_server import LocalServer
from fluidframework_tpu_torch.testing import mocks as port_mocks


def Loader(*args, **kwargs):
    return port_container.Loader(*args, device="cpu", **kwargs)


def TpuLocalServer(*args, **kwargs):
    return port_local.TpuLocalServer(*args, device="cpu", **kwargs)


def MockSequencedEnvironment(*args, **kwargs):
    return port_mocks.MockSequencedEnvironment(*args, device="cpu", **kwargs)


# --- mirrors tests/test_e2e_local.py ---------------------------------------

def make_doc(server, doc_id="doc"):
    """Create-detached -> populate -> attach (the reference detached-attach
    flow), returning (loader, container, datastore)."""
    loader = Loader(LocalDocumentServiceFactory(server))
    container = loader.create_detached(doc_id)
    ds = container.runtime.create_datastore("default")
    return loader, container, ds


class TestCreateAttachLoad:
    def test_attach_then_load_second_client(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        text = ds1.create_channel("text", SharedString.TYPE)
        text.insert_text(0, "made offline")
        c1.attach()
        assert c1.connected

        c2 = loader.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == "made offline"

        # Live collaboration after load.
        t2.insert_text(0, "c2:")
        text.insert_text(text.get_length(), "!")
        assert text.get_text() == t2.get_text() == "c2:made offline!"

    def test_three_clients_counter(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        ds1.create_channel("clicks", SharedCounter.TYPE)
        c1.attach()
        c2 = loader.resolve("doc")
        c3 = loader.resolve("doc")
        counters = [
            c.runtime.get_datastore("default").get_channel("clicks")
            for c in (c1, c2, c3)]
        for i, counter in enumerate(counters):
            counter.increment(i + 1)
        assert [c.value for c in counters] == [6, 6, 6]

    def test_audience_tracks_members(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        c2 = loader.resolve("doc")
        assert len(c1.audience.members) == 2
        c2.close()
        server.pump()
        assert len(c1.audience.members) == 1


class TestSummarizeFlow:
    def test_client_summarize_scribe_ack(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        m.set("k", "v")
        results = []
        c1.summarize(lambda handle, ack, contents:
                     results.append((handle, ack)))
        server.pump()
        assert results and results[0][1] is True

        # A late client loads from the new summary without replaying ops
        # it covers (op tail may be empty).
        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        assert m2.get("k") == "v"

    def test_bad_summary_handle_nacked(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        results = []
        from fluidframework_tpu_torch.protocol.messages import MessageType
        c1.delta_manager.submit(
            MessageType.SUMMARIZE, {"handle": "deadbeef"},
            before_send=lambda csn: c1._summary_waiters.append(
                {"csn": csn, "summary_seq": None,
                 "fn": lambda handle, ack, contents: results.append(ack)}))
        server.pump()
        assert results == [False]

    def test_incremental_summary_dedupes_blobs(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        m.set("k", 1)
        h1 = c1.summarize()
        server.pump()
        m.set("k", 2)
        h2 = c1.summarize()
        server.pump()
        assert h1 != h2
        store = server.storage("doc")
        assert store.get_ref("main") == h2


class TestReconnect:
    def test_nack_triggers_resubmit(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("root")

        # Force a stale submission: disconnect c1's socket server-side, then
        # submit — the op is lost; reconnect resubmits.
        c1.delta_manager.connection._conn.connected = False
        try:
            m.set("lost", "no")
        except ConnectionError:
            pass
        c1.reconnect()
        server.pump()
        assert m2.get("lost") == "no"
        assert m.get("lost") == "no"

    def test_explicit_reconnect_with_pending_string_ops(self):
        server = LocalServer(auto_pump=True)
        loader, c1, ds1 = make_doc(server)
        s1 = ds1.create_channel("text", SharedString.TYPE)
        c1.attach()
        c2 = loader.resolve("doc")
        s2 = c2.runtime.get_datastore("default").get_channel("text")
        s1.insert_text(0, "hello")
        # Concurrent edit from c2, then c1 reconnects (new identity).
        s2.insert_text(0, "x")
        c1.reconnect()
        server.pump()
        assert s1.get_text() == s2.get_text()


class TestServerInternals:
    def test_scriptorium_idempotent_on_replay(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        m.set("a", 1)
        n1 = len(server.deltas)
        # Simulate a crashed scriptorium replaying from offset 0.
        for key in list(server.log.checkpoints):
            if key[0] == "scriptorium":
                del server.log.checkpoints[key]
        server.pump()
        assert len(server.deltas) == n1  # dup inserts ignored

    def test_deli_nacks_unjoined_client(self):
        from fluidframework_tpu_torch.protocol.messages import (
            Boxcar, DocumentMessage, MessageType)
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        nacks = []
        conn = server.connect("doc")
        conn.on("nack", nacks.append)
        # Forge a message from a never-joined client id.
        server._submit_boxcar(Boxcar(
            tenant_id="local", document_id="doc", client_id="ghost",
            contents=[DocumentMessage(client_sequence_number=1,
                                      reference_sequence_number=0,
                                      type=MessageType.OPERATION,
                                      contents={})]))
        server.pump()
        # Ghost has no connection; no crash, and no sequenced op appeared.
        ops = server.get_deltas("doc")
        assert all(o["client_id"] != "ghost" for o in ops)

    def test_deli_checkpoint_persisted(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        m.set("a", 1)
        assert server.sequence_number("doc") >= 2  # join + op

    def test_copier_captures_raw_ops(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        m.set("a", 1)
        assert len(server.raw_deltas) >= 2


class TestOpSizeCeiling:
    """Server-side max-op-size enforcement (reference alfred
    maxMessageSize): oversized content nacks 413 on BOTH sequencer paths;
    well-behaved clients chunk long before the ceiling."""

    def _giant_and_ok(self, server):
        from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                          MessageType,
                                                          NACK_TOO_LARGE)
        conn = server.connect("doc")
        nacks = []
        conn.on("nack", nacks.append)
        seq_before = server.sequence_number("doc")
        conn.submit([DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION,
            contents={"blob": "x" * (2 * 1024 * 1024)})])
        assert nacks and nacks[-1].content.code == NACK_TOO_LARGE
        assert server.sequence_number("doc") == seq_before
        # A normal op still sequences afterwards.
        conn.submit([DocumentMessage(
            client_sequence_number=2, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={"ok": 1})])
        assert server.sequence_number("doc") == seq_before + 1

    def test_scalar_deli_nacks_oversized(self):
        self._giant_and_ok(LocalServer())

    def test_tpu_sequencer_nacks_oversized(self):
        self._giant_and_ok(TpuLocalServer())

    def test_chunked_large_op_still_round_trips(self):
        """The client chunking path keeps every wire message under the
        ceiling, so app-level ops far above 1MB still work end-to-end."""
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m1 = ds1.create_channel("map", SharedMap.TYPE)
        c1.attach()
        c2 = loader.resolve("doc")
        big = "y" * (3 * 1024 * 1024)
        m1.set("big", big)
        m2 = c2.runtime.get_datastore("default").get_channel("map")
        assert m2.get("big") == big


class TestThrottling:
    """Per-connection op-rate limiting (reference alfred throttler):
    429 nacks with retryAfter; clients back off and converge."""

    def _server(self, rate, burst):
        from fluidframework_tpu_torch.core.config import ConfigProvider
        cfg = ConfigProvider({"alfred": {"throttling": {
            "opsPerSecond": rate, "burst": burst}}})
        return LocalServer(config=cfg)

    def test_burst_exceeded_nacks_429_with_retry_after(self):
        from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                          MessageType,
                                                          NACK_THROTTLED)
        server = self._server(rate=5, burst=3)
        conn = server.connect("doc")
        nacks = []
        conn.on("nack", nacks.append)
        for i in range(6):
            conn.submit([DocumentMessage(
                client_sequence_number=i + 1,
                reference_sequence_number=0,
                type=MessageType.OPERATION, contents={"i": i})])
        assert nacks, "burst of 6 over burst=3 must throttle"
        assert nacks[0].content.code == NACK_THROTTLED
        assert nacks[0].content.retry_after_s > 0
        # Admitted ops sequenced; throttled ones did not.
        assert 0 < server.sequence_number("doc") - 1 < 6  # -1: the join

    def test_bucket_refills_over_time(self):
        import time as _time
        server = self._server(rate=50, burst=2)
        conn = server.connect("doc")
        nacks = []
        conn.on("nack", nacks.append)
        from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                          MessageType)

        def push(i):
            conn.submit([DocumentMessage(
                client_sequence_number=i, reference_sequence_number=0,
                type=MessageType.OPERATION, contents={})])
        push(1)
        push(2)
        push(3)  # bucket empty: throttled
        assert len(nacks) == 1
        _time.sleep(0.1)  # 50/s refill: ~5 tokens
        push(4)
        assert len(nacks) == 1  # admitted after refill

    def test_container_backs_off_and_converges(self):
        import time as _time
        server = self._server(rate=200, burst=5)
        loader, c1, ds1 = make_doc(server)
        m1 = ds1.create_channel("map", SharedMap.TYPE)
        c1.attach()
        for i in range(12):  # exceeds burst: nack -> retryAfter -> resubmit
            m1.set(f"k{i}", i)
        # Throttle recovery waits retryAfter on a worker thread, then
        # reconnects + resubmits: wait for convergence.
        want = {f"k{i}": i for i in range(12)}
        deadline = _time.time() + 20
        while _time.time() < deadline and dict(m1.items()) != want:
            _time.sleep(0.05)
        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("map")
        deadline = _time.time() + 20
        while _time.time() < deadline and dict(m2.items()) != want:
            _time.sleep(0.05)
        assert dict(m2.items()) == want

    def test_per_document_bucket_survives_reconnect(self):
        """Reconnecting must not mint a fresh throttle budget (the bucket
        is keyed by document on the server)."""
        from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                          MessageType,
                                                          NACK_THROTTLED)
        server = self._server(rate=1, burst=3)
        conn = server.connect("doc")
        nacks = []
        conn.on("nack", nacks.append)
        for i in range(3):
            conn.submit([DocumentMessage(
                client_sequence_number=i + 1,
                reference_sequence_number=0,
                type=MessageType.OPERATION, contents={})])
        conn.disconnect()
        conn2 = server.connect("doc")  # same doc: same (drained) bucket
        nacks2 = []
        conn2.on("nack", nacks2.append)
        conn2.submit([DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={})])
        assert nacks2 and nacks2[0].content.code == NACK_THROTTLED


class TestOversizedNonRetryable:
    def test_unchunkable_oversized_op_closes_container(self):
        """A 413 is non-retryable: the container surfaces an error and
        closes instead of reconnect-looping with the identical op."""
        loader, c1, ds1 = make_doc(LocalServer())
        m1 = ds1.create_channel("map", SharedMap.TYPE)
        c1.attach()
        c1.runtime.max_op_size = 8 * 1024 * 1024  # defeat client chunking
        errors = []
        c1.on("error", errors.append)
        m1.set("too-big", "x" * (2 * 1024 * 1024))
        assert errors and errors[0].content.code == 413
        assert c1.closed


# --- mirrors tests/test_summarizer.py --------------------------------------

class TestGarbageCollection:
    def test_mark_pass(self):
        nodes = {
            "/a/root": ["/b"],
            "/b/data": [],
            "/c/orphan": [],
        }
        result = run_garbage_collection(nodes, roots=["/a"])
        assert result.referenced == ["/a/root", "/b/data"]
        assert result.unreferenced == ["/c/orphan"]

    def test_transitive_and_cyclic(self):
        nodes = {
            "/a/x": ["/b"],
            "/b/y": ["/c"],
            "/c/z": ["/a"],  # cycle back
            "/d/w": ["/d"],  # self-cycle, unreachable
        }
        result = run_garbage_collection(nodes, roots=["/a"])
        assert result.unreferenced == ["/d/w"]

    def test_runtime_gc_via_handles(self):
        """A non-root datastore is unreferenced until a handle to it is
        stored in a root store's map."""
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        root_map = ds1.create_channel("root", SharedMap.TYPE)
        ds2 = c1.runtime.create_datastore("loose", root=False)
        loose = ds2.create_channel("data", SharedMap.TYPE)
        c1.attach()

        gc = c1.runtime.run_gc()
        assert "/loose/data" in gc.unreferenced

        root_map.set("ref", loose.handle)
        gc = c1.runtime.run_gc()
        assert "/loose/data" in gc.referenced

    def test_unreferenced_recorded_in_summary(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        ds1.create_channel("root", SharedMap.TYPE)
        c1.runtime.create_datastore("dead", root=False) \
            .create_channel("d", SharedMap.TYPE)
        c1.attach()
        import json
        tree = c1.runtime.summarize()
        meta = json.loads(tree.entries[".metadata"].content)
        assert "/dead/d" in meta["unreferenced"]


class TestBlobManager:
    def test_create_and_roundtrip_through_summary(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        payload = b"\x00\x01binary payload\xff"
        handle = c1.runtime.blob_manager.create_blob(payload)
        m.set("attachment", handle)
        c1.attach()
        c1.summarize()
        server.pump()

        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        h2 = m2.get("attachment")
        sha = h2.absolute_path.split("/")[-1]
        assert c2.runtime.blob_manager.get_blob(sha) == payload

    def test_blobs_participate_in_gc(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        used = c1.runtime.blob_manager.create_blob(b"used")
        c1.runtime.blob_manager.create_blob(b"orphan")
        m.set("k", used)
        c1.attach()
        gc = c1.runtime.run_gc()
        assert used.absolute_path in gc.referenced
        assert len(gc.unreferenced) == 1


class TestSummaryCollection:
    def test_tracks_latest_ack(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        sc = SummaryCollection()
        c1.on("op", sc.process)
        counter.increment(1)
        handle = c1.summarize()
        server.pump()
        assert sc.last_ack is not None
        assert sc.last_ack["handle"] == handle

    def test_waiter_fires_once(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        sc = SummaryCollection()
        c1.on("op", sc.process)
        fired = []
        sc.wait_summary_ack(lambda ack, c: fired.append(ack))
        counter.increment(1)
        c1.summarize()
        server.pump()
        c1.summarize()
        server.pump()
        assert fired == [True]


class TestHeuristics:
    def test_max_ops_triggers(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        clock = [0.0]
        rs = RunningSummarizer(c1, SummaryConfig(max_ops=5),
                               clock=lambda: clock[0])
        c1.on("op", rs.on_op)
        for _ in range(5):
            counter.increment(1)
        server.pump()
        assert rs.summaries_run == 1
        assert rs.ops_since_ack < 5

    def test_idle_trigger_via_tick(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        clock = [0.0]
        rs = RunningSummarizer(c1, SummaryConfig(idle_time=5.0, max_ops=10**6),
                               clock=lambda: clock[0])
        c1.on("op", rs.on_op)
        counter.increment(1)
        server.pump()
        rs.tick()
        assert rs.summaries_run == 0  # not idle long enough
        clock[0] = 6.0
        rs.tick()
        server.pump()
        assert rs.summaries_run == 1

    def test_no_summary_without_ops(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        clock = [100.0]
        rs = RunningSummarizer(c1, SummaryConfig(), clock=lambda: clock[0])
        clock[0] = 1000.0
        rs.tick()
        assert rs.summaries_run == 0


class TestElection:
    def test_oldest_interactive_client_elected(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        c2 = loader.resolve("doc")

        sm1 = SummaryManager(c1, SummaryConfig(max_ops=3))
        sm2 = SummaryManager(c2, SummaryConfig(max_ops=3))
        counter.increment(1)  # flush events through both managers
        assert sm1.elected_self and not sm2.elected_self
        assert sm1.running is not None and sm2.running is None

    def test_election_flips_on_leave(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        c2 = loader.resolve("doc")
        n2 = c2.runtime.get_datastore("default").get_channel("n")
        sm2 = SummaryManager(c2, SummaryConfig(max_ops=3))
        assert not sm2.elected_self
        c1.close()
        n2.increment(1)
        assert sm2.elected_self and sm2.running is not None

    def test_elected_summarizer_produces_acked_summaries(self):
        server = LocalServer()
        loader, c1, ds1 = make_doc(server)
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        sm = SummaryManager(c1, SummaryConfig(max_ops=4))
        sc = SummaryCollection()
        c1.on("op", sc.process)
        for _ in range(4):
            counter.increment(1)
        server.pump()
        assert sm.running is not None and sm.running.summaries_run == 1
        assert sc.last_ack is not None

        # New client loads from the acked summary.
        c2 = loader.resolve("doc")
        assert c2.runtime.get_datastore("default").get_channel("n").value == 4


# --- mirrors tests/test_lazy_snapshot.py -----------------------------------

def make_big_doc(server, doc_id="big", chunks=100):
    """A document whose string snapshot spans ~`chunks` body chunks
    (10k chars each)."""
    loader = Loader(LocalDocumentServiceFactory(server))
    c = loader.create_detached(doc_id)
    ds = c.runtime.create_datastore("default")
    t = ds.create_channel("text", SharedString.TYPE)
    block = "x" * 9000
    for _ in range(chunks):
        t.insert_text(t.get_length(), block)
    c.attach()
    return loader, c, t


class TestLazySnapshotLoad:
    def test_header_query_fetches_at_most_two_chunks(self):
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=100)
        hist = server.historian
        before = hist.blob_fetches
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        # Header query: answered WITHOUT materializing the body.
        assert t2.get_length() == t.get_length()
        fetched = hist.blob_fetches - before
        # Loaded blobs: .metadata, .attributes, channel header, protocol
        # riders — but at most 2 of the ~100 body chunks.
        assert fetched <= 8, f"fetched {fetched} blobs for a header query"
        assert t2._lazy is not None, "body materialized for get_length"
        # Touching content materializes and matches.
        assert t2.get_text() == t.get_text()
        assert t2._lazy is None
        assert hist.blob_fetches - before >= 100  # body now transferred

    def test_deferred_remote_ops_replay_on_materialize(self):
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=10)
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2._lazy is not None
        base_len = t2.get_length()
        # Remote edits arrive while c2's body is still pending.
        t.insert_text(0, "HEAD-")
        t.remove_text(5, 8)
        assert t2._lazy is not None, "remote ops should defer, not load"
        assert t2.get_length() == base_len + 5 - 3
        # Materialize: deferred ops replay in order.
        assert t2.get_text() == t.get_text()

    def test_lazy_survives_bulk_catchup(self):
        """A ≥64-op contiguous catch-up tail routes through
        process_bulk_core and is absorbed as deferrals — the doc STAYS
        lazy (round-3 regression: the bulk preconditions touched
        self.client and materialized the body just to probe)."""
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=10)
        for i in range(70):  # > bulk_catchup_threshold (64)
            t.insert_text(0, f"e{i}-")
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.bulk_catchup_count >= 1, "tail did not take the bulk path"
        assert t2._lazy is not None, "bulk catch-up materialized the body"
        assert t2.get_length() == t.get_length()
        assert t2.get_text() == t.get_text()  # materialize: replay in order
        assert t2._lazy is None

    def test_deferred_remove_overlapping_unseen_remove_materializes(self):
        """Safety valve: a remove whose client had NOT seen a prior
        deferred remove from another client may overlap already-removed
        text, so it must materialize, not defer."""
        from fluidframework_tpu_torch.protocol.messages import MessageType
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=5)
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2._lazy is not None
        seen_seq = c2.delta_manager.last_sequence_number
        t.remove_text(0, 10)  # defers on c2 (t saw everything)
        assert t2._lazy is not None
        # Hand-deliver a remove stamped ref_seq BEFORE t's remove: the
        # wire shape alone cannot bound its overlap, so c2 materializes.
        ds2 = c2.runtime.get_datastore("default")
        t2.process_core({"type": 1, "pos1": 0, "pos2": 5}, False,
                        c2.delta_manager.last_sequence_number + 1,
                        seen_seq, 99, None)
        assert t2._lazy is None

    def test_local_edit_materializes_first(self):
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=5)
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2._lazy is not None
        t2.insert_text(0, "local-")
        assert t2._lazy is None
        assert t2.get_text() == t.get_text()
        assert t.get_text().startswith("local-")

    def test_lazy_doc_summarizes_correctly(self):
        """A summarizer that loaded lazily still produces a complete
        summary (summarize touches the body)."""
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=4)
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        t.insert_text(0, "edit-")
        done = []
        c2.summarize(lambda h, a, _: done.append(a))
        assert done and done[-1]
        c3 = loader.resolve("big")
        t3 = c3.runtime.get_datastore("default").get_channel("text")
        assert t3.get_text() == t.get_text()

    def test_interval_ops_force_materialization(self):
        server = LocalServer()
        loader, c, t = make_big_doc(server, chunks=3)
        coll = t.get_interval_collection("marks")
        coll.add(1, 5)
        c2 = loader.resolve("big")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        # The snapshot carried intervals; a remote interval op arrives.
        coll.add(2, 6)
        coll2 = t2.get_interval_collection("marks")
        assert len(coll2) == 2
        assert t2.get_text() == t.get_text()

    def test_mixed_channels_only_sequence_defers(self):
        server = LocalServer()
        loader = Loader(LocalDocumentServiceFactory(server))
        c = loader.create_detached("mixed")
        ds = c.runtime.create_datastore("default")
        t = ds.create_channel("text", SharedString.TYPE)
        m = ds.create_channel("meta", SharedMap.TYPE)
        t.insert_text(0, "y" * 25000)
        m.set("k", 1)
        c.attach()
        c2 = loader.resolve("mixed")
        ds2 = c2.runtime.get_datastore("default")
        assert dict(ds2.get_channel("meta").items()) == {"k": 1}
        t2 = ds2.get_channel("text")
        assert t2._lazy is not None
        assert t2.get_length() == 25000
        assert t2.get_text() == t.get_text()


# --- mirrors tests/test_runtime_features.py --------------------------------

def live_pair(dds_type):
    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ch1 = c1.runtime.create_datastore("default").create_channel("x", dds_type)
    c1.attach()
    c2 = loader.resolve("doc")
    ch2 = c2.runtime.get_datastore("default").get_channel("x")
    return (c1, ch1), (c2, ch2)


class TestChunkedOps:
    def test_oversized_op_roundtrips(self):
        (c1, m1), (c2, m2) = live_pair(SharedMap.TYPE)
        c1.runtime.max_op_size = 256
        big = "x" * 2000
        m1.set("big", big)
        assert m2.get("big") == big
        assert m1.get("big") == big  # local ack path: no double-apply

    def test_chunks_interleave_between_clients(self):
        env = MockSequencedEnvironment()
        r1, r2 = env.create_runtime(), env.create_runtime()
        m1 = r1.create_datastore("d").create_channel("m", SharedMap.TYPE)
        m2 = r2.create_datastore("d").create_channel("m", SharedMap.TYPE)
        env.process_all()
        r1.max_op_size = 128
        r2.max_op_size = 128
        m1.set("a", "A" * 500)
        m2.set("b", "B" * 500)
        env.process_all()  # random interleave of the two chunk streams
        assert m1.get("a") == m2.get("a") == "A" * 500
        assert m1.get("b") == m2.get("b") == "B" * 500

    def test_small_ops_not_chunked(self):
        env = MockSequencedEnvironment()
        r1 = env.create_runtime()
        m1 = r1.create_datastore("d").create_channel("m", SharedMap.TYPE)
        m1.set("k", "v")
        types = [entry[0] for state in env.clients.values()
                 for entry in state.queue]
        assert "chunkedOp" not in types


class TestDeltaScheduler:
    def test_yields_during_long_drain(self):
        (c1, s1), (c2, s2) = live_pair(SharedString.TYPE)
        c2.delta_manager.scheduler.quantum_s = 0.0  # yield after every op
        for i in range(30):
            s1.insert_text(0, f"{i},")
        assert s2.get_text() == s1.get_text()
        assert c2.delta_manager.scheduler.interruptions > 0
        assert c2.delta_manager.scheduler.ops_processed >= 30

    def test_counters_quiet_by_default(self):
        (c1, s1), (c2, s2) = live_pair(SharedString.TYPE)
        s1.insert_text(0, "hi")
        # 20ms quantum: a 2-op drain never yields.
        assert c2.delta_manager.scheduler.interruptions == 0


class TestConfigProvider:
    def test_layer_precedence(self, tmp_path):
        cfg_file = tmp_path / "config.json"
        cfg_file.write_text(json.dumps(
            {"deli": {"checkpointBatchSize": 10, "fromFile": True}}))
        os.environ["FFT__deli__checkpointBatchSize"] = "99"
        try:
            cfg = ConfigProvider.from_sources(
                defaults={"deli": {"checkpointBatchSize": 1,
                                   "timeoutMs": 500}},
                file_path=str(cfg_file),
                env_prefix="FFT",
                overrides={"logger": {"level": "debug"}})
        finally:
            del os.environ["FFT__deli__checkpointBatchSize"]
        assert cfg.get("deli.checkpointBatchSize") == 99  # env beats file
        assert cfg.get("deli.fromFile") is True           # file beats default
        assert cfg.get("deli.timeoutMs") == 500           # default survives
        assert cfg.get("logger.level") == "debug"         # overrides top
        assert cfg.get("missing.key", "fallback") == "fallback"

    def test_sub_and_require(self):
        cfg = ConfigProvider({"scribe": {"maxPending": 3}})
        sub = cfg.sub("scribe")
        assert sub.get("maxPending") == 3
        assert cfg.require("scribe.maxPending") == 3
        try:
            cfg.require("nope")
            assert False
        except KeyError:
            pass

    def test_env_json_parsing(self):
        os.environ["PX__a__b"] = '{"deep": [1, 2]}'
        os.environ["PX__plain"] = "hello"
        try:
            cfg = ConfigProvider.from_sources(env_prefix="PX")
        finally:
            del os.environ["PX__a__b"]
            del os.environ["PX__plain"]
        assert cfg.get("a.b") == {"deep": [1, 2]}
        assert cfg.get("plain") == "hello"


# --- parity with the JAX package: one seeded script per group --------------
#
# Each script runs once through the JAX package and once through the port
# (device="cpu"), with the same seed and the same pins
# (testing/client_runs.pinned: client ids, commit clock, idle clock,
# interval ids, `random`, the forced bulk route), and returns plain data:
# summary trees in dict form, texts, values and counters. The two results
# must be equal.

import importlib  # noqa: E402
import random  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import pytest  # noqa: E402

from fluidframework_tpu_torch.testing import client_runs  # noqa: E402

STACK = {"container": "loader.container",
         "local_driver": "loader.drivers.local",
         "local_server": "server.local_server", "storage": "server.storage",
         "delta_manager": "loader.delta_manager",
         "sequence": "dds.sequence", "map": "dds.map",
         "counter": "dds.counter", "summarizer": "runtime.summarizer",
         "summary": "protocol.summary"}


def stack(package: str) -> SimpleNamespace:
    s = SimpleNamespace(**{k: importlib.import_module(f"{package}.{v}")
                           for k, v in STACK.items()})
    device = {"device": "cpu"} if package.endswith("_torch") else {}
    s.loader = lambda server: s.container.Loader(
        s.local_driver.LocalDocumentServiceFactory(server), **device)
    return s


def both(script, seed: int) -> list:
    """script(stack, rng) through the JAX package and the port, as JSON."""
    out = []
    for package in ("fluidframework_tpu", "fluidframework_tpu_torch"):
        s = stack(package)
        with client_runs.pinned(s, seed):
            out.append(json.dumps(script(s, random.Random(seed)),
                                  sort_keys=True))
    return out


def channels_of(container) -> dict:
    ds = container.runtime.get_datastore("default")
    return {name: ds.get_channel(name) for name in ("n", "kv", "text")}


def values_of(container) -> dict:
    ch = channels_of(container)
    return {"n": ch["n"].value, "kv": sorted(
        (k, v if isinstance(v, (int, str)) else v.absolute_path)
        for k, v in ch["kv"].items()), "text": ch["text"].get_text()}


def summarizer_script(s, rng) -> dict:
    """Two clients under summarizer election (max_ops 7) edit a counter,
    a map (holding a blob's handle and, later, a loose store's) and a
    string; a third client loads from the last acked summary."""
    S = s.summarizer
    server = s.local_server.LocalServer()
    loader = s.loader(server)
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    ds.create_channel("n", s.counter.SharedCounter.TYPE)
    ds.create_channel("kv", s.map.SharedMap.TYPE)
    ds.create_channel("text", s.sequence.SharedString.TYPE)
    loose = c1.runtime.create_datastore("loose", root=False) \
        .create_channel("data", s.map.SharedMap.TYPE)
    used = c1.runtime.blob_manager.create_blob(b"used")
    c1.runtime.blob_manager.create_blob(b"orphan")
    channels_of(c1)["kv"].set("blob", used)
    c1.attach()
    c2 = loader.resolve("doc")
    managers = [S.SummaryManager(c, S.SummaryConfig(max_ops=7),
                                 clock=lambda: 0.0) for c in (c1, c2)]
    sc = S.SummaryCollection()
    c1.on("op", sc.process)
    gc_before = c1.runtime.run_gc()
    for i in range(80):
        c = c1 if rng.random() < 0.5 else c2
        ch = channels_of(c)
        r = rng.random()
        if r < 0.25:
            ch["n"].increment(rng.randrange(1, 4))
        elif r < 0.5:
            ch["kv"].set(f"k{rng.randrange(4)}", i)
        elif r < 0.55 and c is c1:
            ch["kv"].set("ref", loose.handle)
        else:
            at = rng.randrange(ch["text"].get_length() + 1)
            ch["text"].insert_text(at, f"<{i}>")
        if i % 9 == 8:
            server.pump()
    server.pump()
    gc = c1.runtime.run_gc()
    c3 = loader.resolve("doc")
    running = [m.running for m in managers]
    return {
        "elected": [m.elected_self for m in managers],
        "summaries_run": [r.summaries_run if r else None for r in running],
        "ops_since_ack": [r.ops_since_ack if r else None for r in running],
        "last_ack": sc.last_ack,
        "gc": [gc_before.referenced, gc_before.unreferenced,
               gc.referenced, gc.unreferenced],
        "values": [values_of(c) for c in (c1, c2, c3)],
        "tree": s.summary.summary_tree_to_dict(c1.runtime.summarize()),
        "tree_c3": s.summary.summary_tree_to_dict(c3.runtime.summarize()),
    }


def lazy_script(s, rng) -> dict:
    """A 12-chunk string beside a map loads lazily on a second client;
    remote edits defer (a 70-op burst takes the bulk path as deferrals),
    a header query stays lazy, the body materializes at first touch, and
    the lazily loaded client summarizes for a third."""
    server = s.local_server.LocalServer()
    loader = s.loader(server)
    c = loader.create_detached("big")
    ds = c.runtime.create_datastore("default")
    t = ds.create_channel("text", s.sequence.SharedString.TYPE)
    m = ds.create_channel("meta", s.map.SharedMap.TYPE)
    for k in range(12):
        t.insert_text(t.get_length(), chr(97 + k) * 9000)
    m.set("k", 1)
    c.attach()
    for i in range(70):
        t.insert_text(rng.randrange(t.get_length() + 1), f"e{i}-")
    hist = server.historian
    f0 = hist.blob_fetches
    c2 = loader.resolve("big")
    t2 = c2.runtime.get_datastore("default").get_channel("text")
    seen = {"bulk": t2.bulk_catchup_count, "lazy": t2._lazy is not None,
            "length": t2.get_length(), "fetched": hist.blob_fetches - f0}
    for i in range(20):
        n = t.get_length()
        if rng.random() < 0.3:
            a = rng.randrange(n - 10)
            t.remove_text(a, a + rng.randrange(1, 8))
        else:
            t.insert_text(rng.randrange(n + 1), f"r{i}")
    seen.update(lazy_after=t2._lazy is not None, length2=t2.get_length())
    done = []
    c2.summarize(lambda h, a, _: done.append(a))
    server.pump()
    c3 = loader.resolve("big")
    t3 = c3.runtime.get_datastore("default").get_channel("text")
    return {"seen": seen, "acked": done, "texts_equal": [
        t2.get_text() == t.get_text(), t3.get_text() == t.get_text()],
        "text": t.get_text()[:2000], "length": t.get_length(),
        "lazy_end": [t2._lazy is None, t3._lazy is not None],
        "tree": s.summary.summary_tree_to_dict(c2.runtime.summarize())}


def runtime_features_script(s, rng) -> dict:
    """Two live clients chunk oversized map ops (max_op_size 128) between
    string edits, one draining with a zero scheduler quantum; the
    sequenced stream and both replicas are compared."""
    server = s.local_server.LocalServer()
    loader = s.loader(server)
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    ds.create_channel("m", s.map.SharedMap.TYPE)
    ds.create_channel("t", s.sequence.SharedString.TYPE)
    c1.attach()
    c2 = loader.resolve("doc")
    c2.delta_manager.scheduler.quantum_s = 0.0
    for c in (c1, c2):
        c.runtime.max_op_size = 128
    pairs = [(c, c.runtime.get_datastore("default")) for c in (c1, c2)]
    for i in range(40):
        c, d = pairs[rng.randrange(2)]
        if rng.random() < 0.3:
            d.get_channel("m").set(f"k{i % 5}", chr(65 + i % 26) *
                                   rng.randrange(50, 600))
        else:
            t = d.get_channel("t")
            t.insert_text(rng.randrange(t.get_length() + 1), f"{i},")
        if i % 6 == 5:
            server.pump()
    server.pump()
    deltas = [{k: v for k, v in m.items()
               if k not in ("timestamp", "traces")}
              for m in server.get_deltas("doc")]
    sched = c2.delta_manager.scheduler
    return {"maps": [sorted(d.get_channel("m").items()) for _, d in pairs],
            "texts": [d.get_channel("t").get_text() for _, d in pairs],
            "types": [str(d["type"]) for d in deltas],
            "contents": [json.dumps(d["contents"], sort_keys=True,
                                    default=str) for d in deltas],
            "scheduler": [sched.ops_processed, sched.interruptions > 0],
            "tree": s.summary.summary_tree_to_dict(c1.runtime.summarize())}


class TestParityWithJax:
    @pytest.mark.parametrize("seed", [3, 11])
    def test_summarizer_gc_and_blobs(self, seed):
        jax, port = both(summarizer_script, seed)
        assert port == jax

    @pytest.mark.parametrize("seed", [3, 11])
    def test_lazy_snapshot(self, seed):
        jax, port = both(lazy_script, seed)
        assert port == jax

    @pytest.mark.parametrize("seed", [3, 11])
    def test_runtime_features(self, seed):
        jax, port = both(runtime_features_script, seed)
        assert port == jax
