"""The port's local server on the serving path, driven by either client
stack: a mirror of tests/test_tpu_serving.py.

Each test that drives a client runs twice (the `client_stack` fixture):
with the port's own Loader, local driver and DDSes (SharedString,
SharedMap, SharedCounter, SharedCell) on the CPU, and with the JAX
package's, the interop check. Both drive fluidframework_tpu_torch's
TpuLocalServer(device="cpu") and LocalServer, and every assertion of the
JAX file is made again. The JAX client stack only duck-types the server
(loader/drivers/local.py) and the messages and Nacks that cross; the one
place that does not is the git store's tree writer, which recognises
summary trees by class, so for it `server.storage(doc)` is wrapped here: a
summary the JAX container uploads is re-encoded through
summary_tree_to_dict / summary_tree_from_dict into the port's classes.
Reads go the other way unchanged: the JAX loader reads the port's
SummaryTree and LazySummaryBlob objects by duck typing. The port's stack
needs no wrapper. The keystroke stress tests drive each loader through
its own package's testing/load_test.LoadRunner, and the texts the two
stacks end with must be equal.

Where a JAX test reaches into the server (its sequencer's lane stores,
the extraction helpers), the port's counterparts stand in, on the CPU.
TestTpuClusterTakeover is mirrored in tests/test_torch_multinode.py and
tests/test_torch_cluster_golden.py, over the port's server/nodes.py.
"""

import random

import numpy as np
import pytest

from fluidframework_tpu.dds import cell as jax_cell
from fluidframework_tpu.dds import counter as jax_counter
from fluidframework_tpu.dds import map as jax_map
from fluidframework_tpu.dds import sequence as jax_sequence
from fluidframework_tpu.loader import container as jax_container
from fluidframework_tpu.loader.drivers import local as jax_local
from fluidframework_tpu.protocol import summary as jax_summary
from fluidframework_tpu.testing import load_test as jax_load_test

from fluidframework_tpu_torch.dds import cell as port_cell
from fluidframework_tpu_torch.dds import counter as port_counter
from fluidframework_tpu_torch.dds import map as port_map
from fluidframework_tpu_torch.dds import sequence as port_sequence
from fluidframework_tpu_torch.loader import container as port_container
from fluidframework_tpu_torch.loader.drivers import local as port_local_driver

from fluidframework_tpu_torch.protocol import summary as port_summary
from fluidframework_tpu_torch.protocol.messages import (
    Boxcar,
    DocumentMessage,
    MessageType,
)
from fluidframework_tpu_torch.server import local_server as port_local
from fluidframework_tpu_torch.server import tpu_sequencer as port_seq
from fluidframework_tpu_torch.server.lambdas.deli import DeliLambda
from fluidframework_tpu_torch.server.log import QueuedMessage
from fluidframework_tpu_torch.telemetry import counters as port_counters
from fluidframework_tpu_torch.testing import load_test as port_load_test


@pytest.fixture(autouse=True)
def isolate_port_histograms():
    """The port's stage latency histograms are process-global, as the JAX
    package's are (tests/conftest.py resets those after every test): the
    admission controller's latency term reads serving.flush, so another
    file's flush tail on the same worker must not throttle these tests'
    submits."""
    port_counters.reset_histograms()
    yield
    port_counters.reset_histograms()


class ForeignSummaryStore:
    """A port GitStore that takes summary trees of either package: a tree
    of other classes is re-encoded through the dict form first."""

    def __init__(self, store):
        self._store = store

    def write_summary(self, tree, *args, **kwargs):
        if not isinstance(tree, port_summary.SummaryTree):
            tree = port_summary.summary_tree_from_dict(
                jax_summary.summary_tree_to_dict(tree))
        return self._store.write_summary(tree, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._store, name)


def with_foreign_storage(server):
    storage = server.storage
    server.storage = lambda doc: ForeignSummaryStore(storage(doc))
    return server


def jax_tpu_server(*args, **kwargs):
    return with_foreign_storage(
        port_local.TpuLocalServer(*args, device="cpu", **kwargs))


def jax_scalar_server(*args, **kwargs):
    return with_foreign_storage(port_local.LocalServer(*args, **kwargs))


def port_tpu_server(*args, **kwargs):
    return port_local.TpuLocalServer(*args, device="cpu", **kwargs)


# Tests key results by the server constructor's name.
jax_tpu_server.__name__ = port_tpu_server.__name__ = "TpuLocalServer"
jax_scalar_server.__name__ = "LocalServer"


def port_loader(*args, **kwargs):
    return port_container.Loader(*args, device="cpu", **kwargs)


CLIENT_STACKS = {
    "jax": dict(SharedCell=jax_cell.SharedCell,
                SharedCounter=jax_counter.SharedCounter,
                SharedMap=jax_map.SharedMap,
                SharedString=jax_sequence.SharedString,
                Loader=jax_container.Loader,
                LocalDocumentServiceFactory=(
                    jax_local.LocalDocumentServiceFactory),
                TpuLocalServer=jax_tpu_server,
                LocalServer=jax_scalar_server,
                LoadRunner=jax_load_test.LoadRunner,
                LoadProfile=jax_load_test.LoadProfile),
    "port": dict(SharedCell=port_cell.SharedCell,
                 SharedCounter=port_counter.SharedCounter,
                 SharedMap=port_map.SharedMap,
                 SharedString=port_sequence.SharedString,
                 Loader=port_loader,
                 LocalDocumentServiceFactory=(
                     port_local_driver.LocalDocumentServiceFactory),
                 TpuLocalServer=port_tpu_server,
                 LocalServer=port_local.LocalServer,
                 LoadRunner=port_load_test.LoadRunner,
                 LoadProfile=port_load_test.LoadProfile),
}
# Outside the fixture the module's names are the JAX stack's: other files
# (test_torch_local_server_batched.py, _modules.py) import its servers
# for the interop check.
globals().update(CLIENT_STACKS["jax"])


@pytest.fixture(params=sorted(CLIENT_STACKS))
def client_stack(request, monkeypatch):
    """The client stack the test drives the port's server with: its
    classes and the server constructors that go with it become this
    module's names for the test."""
    for name, value in CLIENT_STACKS[request.param].items():
        monkeypatch.setitem(globals(), name, value)
    return request.param


def TpuSequencerLambda(*args, **kwargs):
    return port_seq.TpuSequencerLambda(*args, device="cpu", **kwargs)


def MergeLaneStore(*args, **kwargs):
    return port_seq.MergeLaneStore(*args, device="cpu", **kwargs)


def LwwLaneStore(*args, **kwargs):
    return port_seq.LwwLaneStore(*args, device="cpu", **kwargs)


def make_doc(server, doc_id="doc"):
    loader = Loader(LocalDocumentServiceFactory(server))
    container = loader.create_detached(doc_id)
    ds = container.runtime.create_datastore("default")
    return loader, container, ds


@pytest.mark.usefixtures("client_stack")
class TestTpuServingE2E:
    def test_sharedstring_multi_client_convergence(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        c2 = loader.resolve("doc")
        c3 = loader.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        t3 = c3.runtime.get_datastore("default").get_channel("text")

        text.insert_text(0, "hello")
        t2.insert_text(t2.get_length(), " world")
        t3.insert_text(0, ">> ")
        text.remove_text(0, 1)
        t2.insert_text(t2.get_length(), "!")

        assert text.get_text() == t2.get_text() == t3.get_text()
        assert "world" in text.get_text()

    def test_server_materializes_document_state_on_device(self):
        """The serving win: the sequencer's device merge lanes hold the
        authoritative document text, byte-equal to every client replica."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        c2 = loader.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")

        text.insert_text(0, "abcdef")
        t2.insert_text(3, "XYZ")
        text.remove_text(1, 2)
        t2.annotate_range(0, 4, {"bold": True})

        server_text = server.sequencer().channel_text("doc", "default", "text")
        assert server_text == text.get_text() == t2.get_text()

    def test_mixed_dds_traffic(self):
        """Non-merge-tree ops (map/counter) ride the same device sequencer
        (and materialize via the LWW kernel — TestLwwMaterialization)."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        m = ds1.create_channel("root", SharedMap.TYPE)
        counter = ds1.create_channel("clicks", SharedCounter.TYPE)
        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        k2 = c2.runtime.get_datastore("default").get_channel("clicks")

        m.set("a", 1)
        m2.set("b", 2)
        counter.increment(5)
        k2.increment(7)

        assert m.get("b") == 2 and m2.get("a") == 1
        assert counter.value == k2.value == 12

    def test_random_interleaving_matches_scalar_server(self):
        """The same randomized edit schedule converges to the same text on
        the TPU serving path and the scalar serving path."""
        texts = {}
        for server_cls in (LocalServer, TpuLocalServer):
            rng = random.Random(7)
            server = server_cls()
            loader, c1, ds1 = make_doc(server)
            c1.attach()
            t1 = ds1.create_channel("text", SharedString.TYPE)
            c2 = loader.resolve("doc")
            t2 = c2.runtime.get_datastore("default").get_channel("text")
            for step in range(60):
                t = rng.choice([t1, t2])
                n = t.get_length()
                if n > 4 and rng.random() < 0.3:
                    a = rng.randrange(n - 1)
                    t.remove_text(a, min(n, a + rng.randrange(1, 4)))
                elif n > 2 and rng.random() < 0.2:
                    a = rng.randrange(n - 1)
                    t.annotate_range(a, a + 1, {"k": step})
                else:
                    t.insert_text(rng.randrange(n + 1) if n else 0,
                                  f"[{step}]")
            assert t1.get_text() == t2.get_text()
            texts[server_cls.__name__] = t1.get_text()
        assert texts["LocalServer"] == texts["TpuLocalServer"]

    def test_summarize_flow_on_tpu_path(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        m.set("k", "v")
        results = []
        c1.summarize(lambda handle, ack, contents:
                     results.append((handle, ack)))
        server.pump()
        assert results and results[0][1] is True

    def test_crash_restart_resumes_sequencing(self):
        """Kill the sequencer lambda; the rebuilt one restores its ticket
        state + interner from the checkpoint and rebuilds merge lanes from
        the deltas collection (device bulk catch-up), then sequencing
        continues without seq reuse or divergence."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        c2 = loader.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        text.insert_text(0, "before-crash")
        seq_before = server.sequence_number("doc")
        assert seq_before > 0

        server._deli_mgr.restart()  # crash: lambda rebuilt from checkpoint

        t2.insert_text(t2.get_length(), "/after")
        text.insert_text(0, "!")
        assert text.get_text() == t2.get_text() == "!before-crash/after"
        assert server.sequence_number("doc") > seq_before
        # Merge lanes rebuilt from sequenced deltas match the clients.
        assert server.sequencer().channel_text("doc", "default", "text") \
            == text.get_text()


class TestDeviceTicketingVsScalarDeli:
    """Differential test: random message streams (joins/leaves/ops/system)
    through sequence_batched_strict vs the host DeliLambda produce identical
    (seq, msn, nack) outcomes — the kernel IS the deli state machine."""

    def _run_scalar(self, streams):
        class Ctx:
            def checkpoint(self, *_):
                pass

            def error(self, e, restart):
                raise e

        out = []
        lam = DeliLambda(Ctx(), emit=lambda d, s: out.append(
            ("seq", d, s.sequence_number, s.minimum_sequence_number)),
            nack=lambda d, c, n: out.append(("nack", d, c)))
        offset = 0
        for doc_id, client_id, msg in streams:
            lam.handler(QueuedMessage(
                topic="rawdeltas", partition=0, offset=offset, key=doc_id,
                value=Boxcar(tenant_id="t", document_id=doc_id,
                             client_id=client_id, contents=[msg])))
            offset += 1
        return out

    def _run_device(self, streams, flush_every):

        class Ctx:
            def checkpoint(self, *_):
                pass

            def error(self, e, restart):
                raise e

        out = []
        lam = TpuSequencerLambda(
            Ctx(), emit=lambda d, s: out.append(
                ("seq", d, s.sequence_number, s.minimum_sequence_number)),
            nack=lambda d, c, n: out.append(("nack", d, c)),
            materialize=False)
        for offset, (doc_id, client_id, msg) in enumerate(streams):
            lam.handler(QueuedMessage(
                topic="rawdeltas", partition=0, offset=offset, key=doc_id,
                value=Boxcar(tenant_id="t", document_id=doc_id,
                             client_id=client_id, contents=[msg])))
            if (offset + 1) % flush_every == 0:
                lam.flush()
        lam.flush()
        return out

    @pytest.mark.parametrize("seed,flush_every", [(0, 1), (1, 3), (2, 7),
                                                  (3, 100)])
    def test_differential(self, seed, flush_every):
        import json
        rng = random.Random(seed)
        docs = ["alpha", "beta"]
        clients = {d: [] for d in docs}
        cseq = {}
        streams = []
        for i in range(60):
            d = rng.choice(docs)
            roll = rng.random()
            if roll < 0.15 or not clients[d]:
                cid = f"c{seed}-{i}"
                clients[d].append(cid)
                cseq[(d, cid)] = 0
                streams.append((d, None, DocumentMessage(
                    client_sequence_number=0, reference_sequence_number=-1,
                    type=MessageType.CLIENT_JOIN,
                    data=json.dumps({"clientId": cid, "detail": {}}))))
            elif roll < 0.25:
                # May empty the table: exercises NoClient emission parity.
                cid = clients[d].pop(rng.randrange(len(clients[d])))
                streams.append((d, None, DocumentMessage(
                    client_sequence_number=0, reference_sequence_number=-1,
                    type=MessageType.CLIENT_LEAVE,
                    data=json.dumps({"clientId": cid}))))
            else:
                cid = rng.choice(clients[d])
                cseq[(d, cid)] += 1
                # refSeqs wander upward (advancing the MSN) and sometimes
                # lag far behind (forcing real stale-refSeq nacks) — both
                # paths must match the scalar deli exactly.
                if rng.random() < 0.15:
                    ref = 0  # likely below the advanced MSN -> nack
                else:
                    ref = rng.randrange(max(1, i))
                streams.append((d, cid, DocumentMessage(
                    client_sequence_number=cseq[(d, cid)],
                    reference_sequence_number=ref,
                    type=MessageType.OPERATION,
                    contents={"n": i})))
        scalar = self._run_scalar(streams)
        device = self._run_device(streams, flush_every)
        # Ordering guarantees are per-document (the deltas topic partitions
        # by doc key); the device flush may interleave documents differently.
        for d in docs:
            assert [e for e in scalar if e[1] == d] == \
                [e for e in device if e[1] == d], f"doc {d} diverged"

    def test_unjoined_client_nacks(self):
        streams = [("doc", "ghost", DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={}))]
        device = self._run_device(streams, 1)
        assert device == [("nack", "doc", "ghost")]

    def test_redelivered_op_with_stale_refseq_drops_silently(self):
        """An at-least-once redelivery whose refSeq has since fallen below
        the MSN must be a silent duplicate drop, not a nack (the scalar
        deli checks duplicate before stale; the kernel must match or the
        client gets a spurious reconnect)."""
        import json
        streams = []
        for cid in ("c1", "c2"):
            streams.append(("doc", None, DocumentMessage(
                client_sequence_number=0, reference_sequence_number=-1,
                type=MessageType.CLIENT_JOIN,
                data=json.dumps({"clientId": cid, "detail": {}}))))
        # c1 op at refSeq 0, then both clients advance the window well past
        # it, then the first op is redelivered verbatim.
        first = ("doc", "c1", DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={"n": 0}))
        streams.append(first)
        for i in range(2, 8):
            streams.append(("doc", "c1", DocumentMessage(
                client_sequence_number=i, reference_sequence_number=i,
                type=MessageType.OPERATION, contents={"n": i})))
            streams.append(("doc", "c2", DocumentMessage(
                client_sequence_number=i, reference_sequence_number=i,
                type=MessageType.OPERATION, contents={"n": i})))
        streams.append(first)  # redelivery
        scalar = self._run_scalar(streams)
        device = self._run_device(streams, 1)
        assert scalar == device
        assert not any(e[0] == "nack" for e in device)

    def test_duplicate_clientseq_dropped(self):
        import json
        join = ("doc", None, DocumentMessage(
            client_sequence_number=0, reference_sequence_number=-1,
            type=MessageType.CLIENT_JOIN,
            data=json.dumps({"clientId": "c1", "detail": {}})))
        op = ("doc", "c1", DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={}))
        device = self._run_device([join, op, op], 1)
        assert [e[0] for e in device] == ["seq", "seq"]  # dup silently drops


@pytest.mark.usefixtures("client_stack")
class TestBatchedSummarization:
    def _server_with_text(self, n_docs=3, ops_per_doc=30):
        server = TpuLocalServer()
        loader = Loader(LocalDocumentServiceFactory(server))
        texts = {}
        rng = random.Random(5)
        for d in range(n_docs):
            doc = f"doc{d}"
            c = loader.create_detached(doc)
            ds = c.runtime.create_datastore("default")
            c.attach()
            t = ds.create_channel("text", SharedString.TYPE)
            for i in range(ops_per_doc):
                n = t.get_length()
                if n > 4 and rng.random() < 0.3:
                    a = rng.randrange(n - 1)
                    t.remove_text(a, min(n, a + 2))
                else:
                    t.insert_text(rng.randrange(n + 1) if n else 0,
                                  f"d{d}i{i};")
            texts[doc] = t
        return server, texts

    def test_batched_extraction_matches_live_text(self):
        """One device pass per bucket reproduces every document's text."""
        server, texts = self._server_with_text()
        snaps = server.sequencer().summarize_documents()
        for doc, t in texts.items():
            snap = snaps[(doc, "default", "text")]
            joined = "".join(
                e.get("text") or "￼"
                for chunk in snap["chunks"] for e in chunk
                if e.get("removedSeq") is None)
            assert joined == t.get_text()
            assert snap["header"]["totalLength"] == t.get_length()

    def test_materialized_snapshots_commit_to_git(self):
        server, texts = self._server_with_text(n_docs=2)
        # Mixed channel families in one document snapshot.
        loader = Loader(LocalDocumentServiceFactory(server))
        c = loader.resolve("doc0")
        ds = c.runtime.get_datastore("default")
        # doc0 also gets an LWW channel alongside its string.
        m = ds.create_channel("meta", SharedMap.TYPE)
        m.set("title", "hello")
        shas = server.write_materialized_snapshots()
        assert set(shas) == {"doc0", "doc1"}
        for doc, sha in shas.items():
            store = server.historian.store(server.tenant_id, doc)
            assert store.get(sha) is not None
            assert store.get_ref("materialized") == sha
        # The committed tree carries the LWW channel blob too.
        import json as _json
        store = server.historian.store(server.tenant_id, "doc0")
        tree = store.read_summary(shas["doc0"])
        node = tree.entries["default"].entries["meta"]
        payload = _json.loads(node.entries["lww"].content)
        assert payload["entries"]["title"] == "hello"

    def test_async_extraction_overlaps_sequencing(self):
        """The summary snapshot reflects the state at DISPATCH time even
        though sequencing continues while the host assembly runs — the
        stage-overlap contract (device arrays immutable)."""
        server, texts = self._server_with_text(n_docs=1, ops_per_doc=10)
        t = texts["doc0"]
        frozen = t.get_text()
        done = {}
        th = server.sequencer().summarize_documents_async(
            lambda snaps: done.update(snaps))
        # Keep sequencing while the summary assembles.
        for i in range(20):
            t.insert_text(0, f"+{i}")
        th.join(timeout=30)
        assert not th.is_alive()
        snap = done[("doc0", "default", "text")]
        joined = "".join(
            e.get("text") or "￼"
            for chunk in snap["chunks"] for e in chunk
            if e.get("removedSeq") is None)
        assert joined == frozen
        assert t.get_text() != frozen


@pytest.mark.usefixtures("client_stack")
class TestHostFold:
    """The serving zamboni pack (MergeLaneStore._fold_crowded): acked
    adjacent rows coalesce host-side so long-lived documents stay in the
    small fast buckets instead of climbing capacities whose apply cost
    scales with C (reference mergeTree.ts:1289 scour/pack)."""

    def test_sustained_typing_stays_in_small_bucket(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        rng = random.Random(11)
        for i in range(400):
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, f"x{i % 10}")
        store = server.sequencer().merge
        key = ("doc", "default", "text")
        b, _ = store.where[key]
        fold_b = store.capacities.index(store.fold_min_capacity)
        assert store.folds > 0, "fold never fired"
        assert b <= fold_b, (
            f"folded lane should never pass the fold bucket {fold_b}, "
            f"got {b}")
        assert server.sequencer().channel_text(*key) == text.get_text()
        # Ops after a fold must resolve positions against the packed rows.
        for i in range(40):
            pos = rng.randrange(text.get_length() + 1)
            if text.get_length() > 10 and rng.random() < 0.4:
                start = rng.randrange(text.get_length() - 4)
                text.remove_text(start, start + 3)
            else:
                text.insert_text(pos, "Y")
        assert server.sequencer().channel_text(*key) == text.get_text()

    def test_fold_preserves_props_and_segmentation_boundaries(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        rng = random.Random(13)
        for i in range(260):
            text.insert_text(text.get_length(), f"w{i % 10}")
            if i % 7 == 0 and text.get_length() > 8:
                start = rng.randrange(text.get_length() - 6)
                text.annotate_range(start, start + 4, {"b": i % 3})
        store = server.sequencer().merge
        key = ("doc", "default", "text")
        assert store.folds > 0
        assert server.sequencer().channel_text(*key) == text.get_text()
        # The materialized snapshot must carry identical (text, props)
        # runs to the client replica's own snapshot.
        snap = store.extract_all()[key]
        server_runs = [(e.get("text", ""), e.get("props"))
                       for chunk in snap["chunks"] for e in chunk
                       if e.get("removedSeq") is None]
        client_runs = [(e.get("text", ""), e.get("props"))
                       for e in text.client.tree.snapshot_segments()
                       if e.get("removedSeq") is None]

        def flat(runs):
            out = []
            for t, p in runs:
                norm = tuple(sorted(p.items())) if p else None
                for ch in t:
                    out.append((ch, norm))
            return out

        assert flat(server_runs) == flat(client_runs)

    def test_fold_frees_superseded_payload_generation(self):
        """Each fold re-seeds the lane with fresh payload ids; the
        previous generation (including the whole-document folded string)
        must return to the PayloadTable free-list — otherwise a
        long-lived document retains O(doc_size x folds) dead strings."""
        store = MergeLaneStore(capacities=(8, 64), lanes_per_bucket=1)
        store.fold_min_capacity = 64
        key = ("d", "s", "t")
        seq = 0

        def drive(batches, txt):
            nonlocal seq
            for _ in range(batches):
                ops = []
                for _ in range(6):
                    seq += 1
                    ops.append(store.builder.insert_text(
                        0, txt, seq - 1, 0, seq, msn=seq - 1))
                store.apply({key: ops})

        drive(12, "ab")
        assert store.folds >= 1, "fold never fired"
        assert store.fold_rows_reclaimed > 0
        gen1 = list(store._fold_payloads[key])
        freed = []
        orig_free = store.payloads.free
        store.payloads.free = lambda i: (freed.append(i), orig_free(i))
        drive(12, "cd")
        assert store.folds >= 2
        gen2 = set(store._fold_payloads[key])
        assert gen2 != set(gen1)
        # Every gen1 id was freed by the next fold (or carried forward).
        assert set(gen1) <= set(freed) | gen2, (gen1, freed, gen2)
        assert store.text(key) == "cd" * 72 + "ab" * 72

    def test_inline_fold_equivalence_and_non_ascii_arena(self):
        """extract_entries(fold=True) must equal
        coalesce_entries(extract_entries(fold=False)) — including on a
        NON-ASCII arena, where fast_text's byte-offset slicing must
        refuse (len(decoded) != len(arena)) and fall back to resolve();
        a regression there silently corrupts snapshot text."""

        from fluidframework_tpu_torch.mergetree.catchup import (
            coalesce_entries, extract_entries)

        for payload_txt in ("ascii", "héllo·wörld"):
            server = TpuLocalServer()
            loader, c1, ds1 = make_doc(server)
            c1.attach()
            text = ds1.create_channel("text", SharedString.TYPE)
            rng = random.Random(37)
            for i in range(120):
                pos = rng.randrange(text.get_length() + 1)
                text.insert_text(pos, payload_txt[i % len(payload_txt)])
                if i % 9 == 0 and text.get_length() > 6:
                    start = rng.randrange(text.get_length() - 4)
                    text.annotate_range(start, start + 3, {"k": i % 2})
            store = server.sequencer().merge
            key = ("doc", "default", "text")
            b, lane = store.where[key]
            row = store.buckets[b].row(lane)
            mseq = int(row.min_seq)
            folded = extract_entries(row, store.payloads, mseq, fold=True)
            perrow = coalesce_entries(
                extract_entries(row, store.payloads, mseq))
            assert coalesce_entries(folded) == perrow, payload_txt
            joined = "".join(e["text"] for e in perrow
                             if e.get("removedSeq") is None)
            assert joined == text.get_text(), payload_txt

    def test_payload_id_compaction_renumbers_and_shrinks(self):
        """Major collection: the payload-table LIST grows one slot per
        ingested op; compact_payload_ids must renumber the live ids,
        shrink the table to live size, and leave every read path and
        subsequent editing exact."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        rng = random.Random(41)
        for i in range(500):
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, f"p{i % 10}")
        store = server.sequencer().merge
        before = len(store.payloads.entries)
        assert store.compact_payload_ids()
        after = len(store.payloads.entries)
        assert after < before // 3, (before, after)
        assert not store._blocks and not store._lane_blocks
        key = ("doc", "default", "text")
        assert server.sequencer().channel_text(*key) == text.get_text()
        # Renumbered generation tracking still frees on the next fold.
        gen = store._fold_payloads.get(key)
        assert gen is None or all(i < after for i in gen)
        for i in range(200):  # editing continues exactly post-renumber
            pos = rng.randrange(text.get_length() + 1)
            if text.get_length() > 10 and rng.random() < 0.3:
                start = rng.randrange(text.get_length() - 4)
                text.remove_text(start, start + 2)
            else:
                text.insert_text(pos, "Z")
        assert server.sequencer().channel_text(*key) == text.get_text()
        # The cadence trigger fires organically once the table doubles
        # past its post-collection size (heap-doubling heuristic: dead
        # slow-path slots never enter free_ids, so the gate must not
        # depend on the free list).
        before_count = store.payload_compactions
        store.payload_compact_every = 1
        store.payload_compact_min_entries = 0
        while store.payload_compactions == before_count:
            text.insert_text(0, "q")
            assert text.get_length() < 6000, "organic trigger never fired"
        assert server.sequencer().channel_text(*key) == text.get_text()

    def test_fold_preserves_overlap_removers(self):
        """Overlap-remove clients (rem_clients slots 1+) must survive the
        fold's extract->reseed cycle: an op from the SECOND remover at a
        ref below the first remove's seq must still see the segment as
        removed — losing the overlap shifts its positions and diverges
        the lane from the clients."""
        store = MergeLaneStore(capacities=(64,), lanes_per_bucket=1)
        store.fold_min_capacity = 64
        key = ("d", "s", "t")
        b = store.builder
        # 50 acked rows below the window: "ABCDEFGH" + 49 tail fillers.
        ops = [b.insert_text(0, "ABCDEFGH", 0, 0, 1, msn=0)]
        for s in range(2, 51):
            ops.append(b.insert_text(6 + s, "z", s - 1, 0, s, msn=s - 1))
        # Concurrent removes of [2,5)="CDE" by clients 1 and 2 (overlap),
        # ABOVE the window (min_seq stays 50).
        ops.append(b.remove(2, 5, 50, 1, 51, msn=50))
        ops.append(b.remove(2, 5, 50, 2, 52, msn=50))
        store.apply({key: ops})
        removed = [e for e in store.entries(key) if "removedSeq" in e]
        assert removed and removed[0].get("removedOverlapClients") == [2], \
            removed
        # Crowd past capacity with in-window fillers appended at the
        # inserting client's view end (client 0 at ref 50 still sees
        # CDE): the overflow fold packs the 50 acked rows while the
        # removed row stays in-window.
        seq = 52
        vlen = 8 + 49  # client-0 view length at ref 50
        while store.folds == 0:
            chunk = []
            for _ in range(6):
                seq += 1
                chunk.append(b.insert_text(vlen, "z", 50, 0, seq, msn=50))
                vlen += 1
            store.apply({key: chunk})
            assert seq < 600, "fold never fired"
        # Client 2 edits at ref 50 (below both removes): it must see
        # [2,5) as removed (its own remove survived the fold), so its
        # view is AB+FGH... and view-pos 3 lands after F — not inside
        # the tombstoned CDE.
        seq += 1
        store.apply({key: [b.insert_text(3, "!", 50, 2, seq, msn=50)]})
        text = store.text(key)
        assert text.startswith("ABF!"), text

    def test_collection_defers_during_chunked_apply(self):
        """A single apply() with a stream longer than the largest
        T-bucket chunks into successive windows whose compact ticks
        could hit the collection cadence — renumbering then would
        corrupt the un-applied tail's op_ids (reproduced as IndexError
        pre-fix). The collection must wait for the apply to finish."""
        store = MergeLaneStore(capacities=(8, 64, 1024),
                               lanes_per_bucket=1,
                               t_buckets=(1, 4, 16, 64))
        store.fold_min_capacity = 64
        store.compact_every = 1          # tick at every window
        store.payload_compact_every = 1  # collection eligible every tick
        store.payload_compact_min_entries = 0
        key = ("d", "s", "t")
        ops = [store.builder.insert_text(0, "xy", s, 0, s + 1, msn=s)
               for s in range(300)]      # >> max_t=64: many chunks
        store.apply({key: ops})          # must not crash nor corrupt
        assert store.text(key) == "xy" * 300
        # At the next safe boundary the collection still runs.
        assert store.compact_payload_ids() is True
        assert store.text(key) == "xy" * 300

    def test_extract_guard_defers_frees_and_collection(self):
        """While an async summary worker may still resolve the shared
        payload table, fold frees must defer (a recycled id would
        materialize the WRONG text into the in-flight snapshot) and the
        major collection must refuse to renumber; both proceed after
        release."""
        store = MergeLaneStore(capacities=(8, 64), lanes_per_bucket=1)
        store.fold_min_capacity = 64
        key = ("d", "s", "t")
        seq = 0

        def drive(batches):
            nonlocal seq
            for _ in range(batches):
                ops = []
                for _ in range(6):
                    seq += 1
                    ops.append(store.builder.insert_text(
                        0, "ab", seq - 1, 0, seq, msn=seq - 1))
                store.apply({key: ops})

        drive(12)
        assert store.folds >= 1
        store.extract_guard_acquire()
        # Snapshot content under guard (what the async worker reads).
        text_before = store.text(key)
        assert store.compact_payload_ids() is False, \
            "collection must defer under an extract guard"
        drive(12)  # folds fire; their frees must defer, not recycle
        assert store._deferred_frees, "fold frees should have deferred"
        assert store.text(key) == "ab" * 144
        store.extract_guard_release()
        assert store.compact_payload_ids() is True
        assert not store._deferred_frees  # table rebuilt wholesale
        drive(2)  # editing continues exactly post-release+renumber
        assert store.text(key) == "ab" * 156
        assert text_before == "ab" * 72

    def test_arena_blocks_age_out(self):
        """Fast-path arena blocks pin the flush's raw wire buffers; once
        every referencing lane folds (or the block ages), the registry
        must let them go — a long-lived server must not retain its whole
        raw ingest history in host memory."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        store = server.sequencer().merge
        store.block_age_ticks = 2  # age fast for the test
        rng = random.Random(31)
        for i in range(600):
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, f"b{i % 10}")
        live = len(store._blocks)
        assert store.folds > 0 or store.blocks_aged > 0
        # Registry stays bounded: folds release refs and aging drains
        # stragglers, so live blocks ~ the last few compact windows.
        assert live <= store.block_age_ticks * store.compact_every + 4, live
        key = ("doc", "default", "text")
        assert server.sequencer().channel_text(*key) == text.get_text()
        # Content survives aging: materialized payloads resolve the same.
        snap = store.extract_all()[key]
        joined = "".join(e.get("text", "") for chunk in snap["chunks"]
                         for e in chunk if e.get("removedSeq") is None)
        assert joined == text.get_text()

    def test_fold_survives_restart(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        rng = random.Random(17)
        for i in range(300):
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, f"z{i % 10}")
        assert server.sequencer().merge.folds > 0
        server._deli_mgr.restart()  # rebuild from checkpoint + log replay
        for i in range(40):
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, "Q")
        key = ("doc", "default", "text")
        assert server.sequencer().channel_text(*key) == text.get_text()


@pytest.mark.usefixtures("client_stack")
class TestOverflowRecovery:
    def test_lane_promotes_through_buckets(self):
        """A document that outgrows its capacity bucket mid-batch recovers
        by compaction/promotion with no flag leaks and correct text
        (SURVEY.md §7 hard parts 1/3)."""
        server = TpuLocalServer()
        # Pin the host fold off: this test exercises the overflow
        # recovery/promotion cascade specifically, and with folding on a
        # single-client acked stream packs at the fold bucket forever
        # (that behavior has its own tests in TestHostFold).
        server.sequencer().merge.FOLD_NUM = 10 ** 9
        server.sequencer().merge.fold_min_capacity = 10 ** 9
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        rng = random.Random(3)
        # Interleave inserts at random positions: splits force segment-count
        # growth far past the first bucket (64).
        for i in range(300):
            pos = rng.randrange(text.get_length() + 1)
            text.insert_text(pos, f"x{i % 10}")
        store = server.sequencer().merge
        key = ("doc", "default", "text")
        b, lane = store.where[key]
        assert b > 0, "lane never promoted past the first capacity bucket"
        assert not bool(np.asarray(
            store.buckets[b].state.overflow)[lane]), "overflow flag leaked"
        assert server.sequencer().channel_text(*key) == text.get_text()

    def test_freed_merge_lane_zeroed_before_reuse(self):
        """A freed lane (drop/promotion) hands CLEAN state to the next
        channel that allocates it — the previous channel's segments must
        not leak into the new channel's materialization."""
        store = MergeLaneStore(capacities=(8,), lanes_per_bucket=1)
        a, b = ("d", "s", "a"), ("d", "s", "b")
        store.apply({a: [store.builder.insert_text(0, "SECRET", 0, 0, 1)]})
        assert store.text(a) == "SECRET"
        store.drop(a)  # degraded: lane freed
        store.apply({b: [store.builder.insert_text(0, "clean", 0, 0, 2)]})
        assert store.where[b] == (0, 0), "expected the recycled lane"
        assert store.text(b) == "clean"
        snap = store.extract_all()[b]
        joined = "".join(e.get("text") or ""
                         for chunk in snap["chunks"] for e in chunk
                         if e.get("removedSeq") is None)
        assert joined == "clean"

    def test_freed_lww_lane_zeroed_before_reuse(self):
        """Same hygiene for LWW lanes: a promotion frees the bucket-0 lane
        and the next channel allocating it must not see stale keys."""
        store = LwwLaneStore(capacities=(4, 8), lanes_per_bucket=1)
        lk = store.lk
        a, b = ("d", "s", "a"), ("d", "s", "b")
        store.apply({a: [(lk.LwwKind.SET, store.intern_key(f"k{i}"),
                          store.add_value(i), 0, i + 1) for i in range(6)]})
        assert store.where[a][0] == 1, "lane should have promoted"
        store.apply({b: [(lk.LwwKind.SET, store.intern_key("mine"),
                          store.add_value("v"), 0, 10)]})
        assert store.where[b] == (0, 0), "expected the recycled lane"
        assert store.snapshot(b)["entries"] == {"mine": "v"}

    def test_compaction_avoids_promotion_for_transient_growth(self):
        """Insert/remove churn inside the collab window stays in-bucket via
        zamboni compaction (tombstones freed once min_seq passes)."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        for round_ in range(40):
            text.insert_text(0, "abcdefgh")
            text.remove_text(0, 8)
        store = server.sequencer().merge
        store.compact_all()
        key = ("doc", "default", "text")
        b, lane = store.where[key]
        count = int(np.asarray(store.buckets[b].state.count)[lane])
        assert count <= 4, f"zamboni left {count} live segments"
        assert text.get_text() == ""


@pytest.mark.usefixtures("client_stack")
class TestLwwMaterialization:
    """Map/cell/counter channels materialize on device via the batched LWW
    kernel (server/lww_kernel.py) — every common channel type has a
    server-side device representation."""

    def test_map_counter_cell_materialize(self):

        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        m = ds1.create_channel("root", SharedMap.TYPE)
        k = ds1.create_channel("clicks", SharedCounter.TYPE)
        cell = ds1.create_channel("cfg", SharedCell.TYPE)
        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        k2 = c2.runtime.get_datastore("default").get_channel("clicks")

        m.set("a", 1)
        m2.set("b", {"nested": True})
        m.set("a", 2)          # LWW overwrite
        m2.set("gone", "x")
        m.delete("gone")
        k.increment(5)
        k2.increment(-2)
        cell.set({"theme": "dark"})

        seq = server.sequencer()
        snap = seq.channel_snapshot("doc", "default", "root")
        assert snap["entries"] == {"a": 2, "b": {"nested": True}}
        assert seq.channel_snapshot("doc", "default", "clicks")[
            "counter"] == 3 == k.value
        cell_snap = seq.channel_snapshot("doc", "default", "cfg")
        assert list(cell_snap["entries"].values()) == [{"theme": "dark"}]

    def test_clear_and_key_capacity_growth(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        m = ds1.create_channel("root", SharedMap.TYPE)
        # Blow past the initial 64-key slot capacity: overflow retries the
        # window at doubled capacity.
        for i in range(150):
            m.set(f"key{i}", i)
        seq = server.sequencer()
        snap = seq.channel_snapshot("doc", "default", "root")
        assert len(snap["entries"]) == 150
        assert snap["entries"]["key149"] == 149
        m.clear()
        m.set("fresh", True)
        snap2 = seq.channel_snapshot("doc", "default", "root")
        assert snap2["entries"] == {"fresh": True}

    def test_lww_random_matches_clients(self):
        rng = random.Random(21)
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        m = ds1.create_channel("root", SharedMap.TYPE)
        c2 = loader.resolve("doc")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        keys = [f"k{i}" for i in range(8)]
        for step in range(120):
            target = rng.choice([m, m2])
            key = rng.choice(keys)
            r = rng.random()
            if r < 0.7:
                target.set(key, step)
            elif target.has(key):
                target.delete(key)
        snap = server.sequencer().channel_snapshot("doc", "default", "root")
        client_view = {k: m.get(k) for k in m.keys()}
        assert snap["entries"] == client_view == {
            k: m2.get(k) for k in m2.keys()}

    def test_lww_rebuild_after_crash_restart(self):
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        m = ds1.create_channel("root", SharedMap.TYPE)
        k = ds1.create_channel("clicks", SharedCounter.TYPE)
        m.set("x", "pre")
        k.increment(4)
        server._deli_mgr.restart()
        m.set("y", "post")
        k.increment(1)
        seq = server.sequencer()
        snap = seq.channel_snapshot("doc", "default", "root")
        assert snap["entries"] == {"x": "pre", "y": "post"}
        assert seq.channel_snapshot("doc", "default", "clicks")[
            "counter"] == 5

    def test_value_compaction_reclaims_dead_payloads(self):
        """Payload memory tracks live state, not op count: overwritten
        values are reclaimed by compact_values (the zamboni analog)."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        m = ds1.create_channel("root", SharedMap.TYPE)
        for i in range(200):
            m.set("hot", i)  # 200 payloads submitted, 1 live
        m.set("other", "keep")
        store = server.sequencer().lww
        # Auto-compaction (every value_compact_every windows) already keeps
        # the table bounded by LIVE state, not op count...
        assert len(store.values) < 100
        store.compact_values()
        assert len(store.values) <= 4  # ...and a manual pass gets exact
        snap = server.sequencer().channel_snapshot("doc", "default", "root")
        assert snap["entries"] == {"hot": 199, "other": "keep"}
        # Continues to work after compaction (refs were remapped).
        m.set("post", 1)
        snap2 = server.sequencer().channel_snapshot("doc", "default", "root")
        assert snap2["entries"]["post"] == 1

    def test_malformed_increment_does_not_crash_partition(self):
        """A garbage delta must not crash-loop the sequencer (review
        finding): the op still sequences (clients decide how to react);
        only device materialization skips it."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        k = ds1.create_channel("clicks", SharedCounter.TYPE)
        k.increment(2)
        conn = server._connections["doc"][0]
        conn.submit([DocumentMessage(
            client_sequence_number=999, reference_sequence_number=0,
            type=MessageType.OPERATION,
            contents={"address": "default", "contents": {
                "address": "clicks",
                "contents": {"type": "increment", "delta": "garbage"}}})])
        server.pump()
        k.increment(3)  # partition still sequencing
        snap = server.sequencer().channel_snapshot("doc", "default",
                                                   "clicks")
        assert snap["counter"] == 5


@pytest.mark.usefixtures("client_stack")
class TestMarkersOnServingPath:
    def test_markers_and_annotates_materialize(self):
        """Markers (length-1 non-text segments) + annotates flow through
        the device merge lanes and extraction like the clients' oracles."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server)
        c1.attach()
        text = ds1.create_channel("text", SharedString.TYPE)
        c2 = loader.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")

        text.insert_text(0, "para one")
        text.insert_marker(8, {"kind": "pg"})
        t2.insert_text(t2.get_length(), "para two")
        t2.annotate_range(0, 4, {"bold": True})
        text.remove_text(2, 6)

        assert text.get_text() == t2.get_text()
        assert server.sequencer().channel_text(
            "doc", "default", "text") == text.get_text()
        # The marker survives in the chunked snapshot with its props.
        snaps = server.sequencer().summarize_documents()
        entries = [e for chunk in snaps[("doc", "default", "text")]["chunks"]
                   for e in chunk]
        markers = [e for e in entries if e.get("kind") == 1]
        assert markers and markers[0].get("props", {}).get("kind") == "pg"


@pytest.mark.usefixtures("client_stack")
class TestSnapshotSeededLanes:
    """Documents whose base content ships in the attach/client summary
    (not ops): merge lanes bootstrap from the stored summary instead of
    overflowing on the first op addressed against snapshot content."""

    def _attach_with_content(self, server, doc_id="snap-doc"):
        loader, c1, ds1 = make_doc(server, doc_id)
        text = ds1.create_channel("text", SharedString.TYPE)
        text.insert_text(0, "shipped in the attach summary")
        c1.attach()
        return loader, c1, text

    def test_ops_over_snapshot_content_materialize(self):
        server = TpuLocalServer()
        loader, c1, text = self._attach_with_content(server)
        # Edits addressed INSIDE the snapshot-seeded content.
        text.insert_text(7, "[mid] ")
        text.remove_text(0, 3)
        text.insert_text(text.get_length(), " +tail")
        c2 = loader.resolve("snap-doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == text.get_text()
        assert server.sequencer().channel_text(
            "snap-doc", "default", "text") == text.get_text()
        assert server.sequencer().merge.overflow_drops == 0

    def test_restart_rebuild_seeds_then_replays_tail(self):
        server = TpuLocalServer()
        loader, c1, text = self._attach_with_content(server)
        text.insert_text(0, ">> ")
        server._deli_mgr.restart()  # rebuild: seed summary + replay tail
        text.insert_text(text.get_length(), " post-restart")
        c2 = loader.resolve("snap-doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == text.get_text()
        assert server.sequencer().channel_text(
            "snap-doc", "default", "text") == text.get_text()

    def test_bucket_exhaustion_degrades_to_opaque_not_crash(self):
        """A channel that outgrows the LARGEST capacity bucket loses its
        server-side materialization (opaque) but sequencing continues for
        it and for every other document — no partition pump crash.

        A SECOND connected client that never advances its refSeq pins the
        MSN at its join, so every segment stays contended (inside the
        collab window) — the host-fold rescue cannot coalesce contended
        rows, making exhaustion genuine. (Acked single-client growth is
        now RESCUED by the fold instead: TestAnnotateRingRescue.)"""
        server = TpuLocalServer()
        # Shrink the buckets so exhaustion is cheap to reach.
        server.sequencer().merge = MergeLaneStore(capacities=(4, 8))
        loader, c1, ds1 = make_doc(server, "grow-doc")
        text = ds1.create_channel("text", SharedString.TYPE)
        c1.attach()
        # The MSN-pinning laggard: joins, then never sends another ref.
        stalled = Loader(
            LocalDocumentServiceFactory(server)).resolve("grow-doc")
        stalled.delta_manager.disconnect = lambda: None  # keep it joined
        for i in range(30):  # far beyond 8 segment slots
            text.insert_text(0, f"{i},")
        assert server.sequencer().merge.overflow_drops >= 1
        assert server.sequencer().channel_text(
            "grow-doc", "default", "text") is None
        # Sequencing survived: clients still converge...
        c2 = loader.resolve("grow-doc")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == text.get_text()
        # ...and other documents still materialize.
        loader3, c3, ds3 = make_doc(server, "healthy-doc")
        t3 = ds3.create_channel("text", SharedString.TYPE)
        c3.attach()
        t3.insert_text(0, "fine")
        assert server.sequencer().channel_text(
            "healthy-doc", "default", "text") == "fine"

    def test_lww_channels_seed_from_attach_summary(self):
        """Map/cell/counter base state that shipped in the attach summary
        materializes server-side, with live ops layered LWW on top."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server, "lww-snap")
        m = ds1.create_channel("map", SharedMap.TYPE)
        k = ds1.create_channel("clicks", SharedCounter.TYPE)
        cell = ds1.create_channel("cell", SharedCell.TYPE)
        m.set("base", "from-summary")
        m.set("will-change", 1)
        k.increment(10)
        cell.set("cell-base")
        c1.attach()
        # Live ops over the seeded base.
        m.set("will-change", 2)
        m.set("live", True)
        k.increment(5)
        snap = server.sequencer().channel_snapshot("lww-snap", "default",
                                                   "map")
        assert snap["entries"] == {"base": "from-summary",
                                   "will-change": 2, "live": True}
        ksnap = server.sequencer().channel_snapshot("lww-snap", "default",
                                                    "clicks")
        assert ksnap["counter"] == 15
        csnap = server.sequencer().channel_snapshot("lww-snap", "default",
                                                    "cell")
        assert csnap["entries"].get("\x00cell") == "cell-base"
        # Clients agree.
        c2 = loader.resolve("lww-snap")
        m2 = c2.runtime.get_datastore("default").get_channel("map")
        assert dict(m2.items()) == snap["entries"]

    def test_lww_restart_rebuild_does_not_double_count(self):
        """Counter rebuild: seeded base + tail replay past the summary seq
        — pre-summary increments must not re-apply."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server, "lww-restart")
        k = ds1.create_channel("clicks", SharedCounter.TYPE)
        k.increment(7)  # ships in the attach summary (acked base)
        c1.attach()
        k.increment(3)  # sequenced op
        server._deli_mgr.restart()
        k.increment(1)
        snap = server.sequencer().channel_snapshot("lww-restart", "default",
                                                   "clicks")
        assert snap["counter"] == 11
        assert k.value == 11

    def test_oversized_lww_summary_degrades_to_opaque(self):
        """A map summary with more keys than the largest LWW bucket loses
        materialization for that channel only — no pump crash, no restart
        crash loop."""
        server = TpuLocalServer()
        # Shrink the LWW buckets so exhaustion is cheap.
        server.sequencer().lww = LwwLaneStore(capacities=(4, 8))
        loader, c1, ds1 = make_doc(server, "big-map")
        m = ds1.create_channel("map", SharedMap.TYPE)
        for i in range(30):  # far beyond 8 key slots
            m.set(f"k{i}", i)
        c1.attach()
        m.set("live", 1)  # first live op triggers the seed attempt
        lww = server.sequencer().lww
        assert ("big-map", "default", "map") in lww.opaque
        assert server.sequencer().channel_snapshot(
            "big-map", "default", "map") is None
        # Sequencing survived; clients converge.
        c2 = loader.resolve("big-map")
        m2 = c2.runtime.get_datastore("default").get_channel("map")
        assert m2.get("live") == 1 and m2.get("k7") == 7

    def test_unrepresentable_lww_summary_degrades_to_opaque(self):
        """A counter whose summary base exceeds int32 must NOT materialize
        live deltas over an empty base (silently wrong totals) — the
        channel degrades to opaque instead."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server, "big-counter")
        k = ds1.create_channel("clicks", SharedCounter.TYPE)
        k.increment(3_000_000_000)  # acked base beyond int32
        c1.attach()
        k.increment(5)
        assert server.sequencer().channel_snapshot(
            "big-counter", "default", "clicks") is None
        assert ("big-counter", "default", "clicks") in \
            server.sequencer().lww.opaque
        # Clients are unaffected.
        c2 = loader.resolve("big-counter")
        k2 = c2.runtime.get_datastore("default").get_channel("clicks")
        assert k2.value == 3_000_000_005

    def test_mass_overflow_batch_promotes_all_lanes(self):
        """A burst overflowing MANY lanes at once recovers via the batched
        compact->rerun->group-promote path with identical results to the
        per-lane recovery."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server, "burst")
        texts = [ds1.create_channel(f"t{i}", SharedString.TYPE)
                 for i in range(6)]
        c1.attach()
        server.auto_pump = False
        for i, tx in enumerate(texts):
            for j in range(80):  # ~80+ segments: overflows the 64 bucket
                tx.insert_text(0, f"{i}.{j},")
        server.auto_pump = True
        server.pump()
        sq = server.sequencer()
        assert sq.merge.overflow_drops == 0
        for i, tx in enumerate(texts):
            mat = sq.channel_text("burst", "default", f"t{i}")
            assert mat == tx.get_text(), f"t{i}"
            b, _lane = sq.merge.where[("burst", "default", f"t{i}")]
            assert sq.merge.capacities[b] > 64  # promoted out of bucket 0


def keystroke_load(stack: str, **profile):
    """A keystroke-trace load over a fresh TpuLocalServer(device="cpu"),
    driven by `stack`'s LoadRunner and Loader: the result, the server and
    each document's final text (read by a fresh client)."""
    names = CLIENT_STACKS[stack]
    server = names["TpuLocalServer"]()
    factory = names["LocalDocumentServiceFactory"]
    runner = names["LoadRunner"](lambda: names["Loader"](factory(server)))
    result = runner.run(names["LoadProfile"](keystroke_trace=True,
                                             **profile))
    texts = {}
    for d in range(profile["documents"]):
        doc_id = f"load-doc-{d}"
        texts[doc_id] = names["Loader"](factory(server)).resolve(
            doc_id).runtime.get_datastore("load").get_channel(
                "text").get_text()
    return result, server, texts


@pytest.mark.usefixtures("client_stack")
class TestKeystrokeTraceStress:
    def test_trace_load_converges_and_server_materializes(self,
                                                          client_stack):
        """Service-load stress with the keystroke editing model (the
        position-locality real editors produce) against the DEVICE
        serving path: every replica converges AND the server's own
        merge-lane materialization matches the clients — the
        nodeStressTest analog on realistic traffic. Each stack's own
        LoadRunner drives it, and both stacks end with the same texts."""
        profile = dict(documents=2, clients_per_document=3,
                       ops_per_client=60, seed=11)
        result, server, texts = keystroke_load(client_stack, **profile)
        assert result.total_ops == 2 * 3 * 60
        assert result.converged, result.divergences
        sq = server.sequencer()
        for doc_id, text in texts.items():
            assert sq.channel_text(doc_id, "load", "text") == text, doc_id
        other = "jax" if client_stack == "port" else "port"
        assert keystroke_load(other, **profile)[2] == texts

    def test_trace_load_with_reconnect_churn(self, client_stack):
        profile = dict(documents=1, clients_per_document=3,
                       ops_per_client=50, seed=3,
                       reconnect_probability=0.05)
        result, _, texts = keystroke_load(client_stack, **profile)
        assert result.converged, result.divergences
        other = "jax" if client_stack == "port" else "port"
        assert keystroke_load(other, **profile)[2] == texts


@pytest.mark.usefixtures("client_stack")
class TestAnnotateRingRescue:
    def test_annotate_accumulation_survives_via_host_fold(self):
        """>anno_slots annotates accumulating on one span across flushes
        overflow the per-segment ring; capacity promotion can't widen
        rings, so the lane must take the host-fold rescue
        (MergeLaneStore._rescue_lane) instead of going opaque."""
        server = TpuLocalServer()
        loader, c1, ds1 = make_doc(server, "anno")
        t = ds1.create_channel("text", SharedString.TYPE)
        c1.attach()
        t.insert_text(0, "abcdefghij")
        for i in range(12):  # each flush pushes one more ring entry
            t.annotate_range(2, 7, {"w": i})
        t.insert_text(0, "Z")  # lane must still be live for new ops
        sq = server.sequencer()
        key = ("anno", "default", "text")
        assert key not in sq.merge.opaque, "lane went opaque"
        assert sq.channel_text("anno", "default", "text") == t.get_text()
        import json

        summary = sq.summarize_documents(only={key})
        blob = json.dumps(summary[key])
        assert '"w": 11' in blob, "folded props lost"
