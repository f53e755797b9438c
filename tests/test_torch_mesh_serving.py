"""The port's serving sequencer on a dp mesh: a mirror of the ten tests of
tests/test_mesh_serving.py and of test_pipelined_serving.py's
test_mesh_placement_disables_lane_state_donation, held against the JAX
package.

The port's mesh is a list of `cpu` entries the size of the JAX test's
mesh (8; 16 for the wide mesh): one process drives every entry, as JAX's
single controller drives the conftest's virtual devices. Where a JAX test
reads `sharding.device_set`, this one reads each leaf's blocks: one per
grid entry, each on its entry's device. Beside the mirror: the pool's
spec table equals JAX's string for string, and testing/server_runs.py's
scenario at golden.SERVER_SMALL on a 4-entry mesh equals the JAX golden's
small sections (every reader's stream, nack, delta, text, checkpoint,
summary and snapshot digest), with testing/shardcheck.verify_store
passing after it.
"""

import json

import pytest

from fluidframework_tpu_torch.dds.counter import SharedCounter
from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader.container import Loader
from fluidframework_tpu_torch.loader.drivers.local import \
    LocalDocumentServiceFactory
from fluidframework_tpu_torch.parallel.mesh import Sharded, make_mesh
from fluidframework_tpu_torch.server.local_server import TpuLocalServer
from fluidframework_tpu_torch.testing import golden, server_runs, shardcheck


def cpu_mesh(n=8):
    return make_mesh(sp=1, devices=["cpu"] * n)


def spans(x, n=8) -> bool:
    """The leaf is sharded over all n grid entries, each block on its
    entry's device (the port's reading of JAX's device_set)."""
    return isinstance(x, Sharded) and \
        len([b for row in x.blocks for b in row]) == n and \
        all(b.device == x.mesh.device(i, j)
            for i, row in enumerate(x.blocks) for j, b in enumerate(row))


def server(mesh=None, **kw):
    return TpuLocalServer(device="cpu", mesh=mesh or cpu_mesh(), **kw)


def make_doc(srv, doc_id="doc"):
    loader = Loader(LocalDocumentServiceFactory(srv), device="cpu")
    c = loader.create_detached(doc_id)
    ds = c.runtime.create_datastore("default")
    return loader, c, ds


def written_text(srv, doc, shas):
    store = srv.historian.store(srv.tenant_id, doc)
    tree = store.read_summary(shas[doc])
    body = json.loads(tree.entries["default"].entries["text"]
                      .entries["chunk_0"].content)
    return "".join(e.get("text") or "" for e in body
                   if e.get("removedSeq") is None)


class _Ctx:
    def checkpoint(self, *_):
        pass

    def error(self, err, restart=False):
        raise err


def traffic(pkg):
    """The JAX test's wire traffic: ten documents, a join and six inserts
    each, as raw boxcars of `pkg`'s own modules."""
    messages, log, wire = pkg
    out = []
    for d in range(10):
        doc = f"w{d}"
        msgs = [messages.DocumentMessage(
            0, -1, messages.MessageType.CLIENT_JOIN,
            data=json.dumps({"clientId": f"c{d}", "detail": {}}))]
        for i in range(6):
            msgs.append(messages.DocumentMessage(
                i + 1, i, messages.MessageType.OPERATION,
                contents={"address": "s", "contents": {
                    "address": "t", "contents": {
                        "type": 0, "pos1": 0,
                        "seg": {"text": f"{d}:{i} "}}}}))
        out.append(log.QueuedMessage(
            "rawdeltas", 0, d, doc, wire.boxcar_to_wire(
                messages.Boxcar("t", doc, f"c{d}", msgs))))
    return out


def fast_run(lambda_cls, pkg, **kw):
    emits = []
    lam = lambda_cls(
        _Ctx(), emit=lambda doc, m: emits.append(
            (doc, m.sequence_number, m.minimum_sequence_number, m.type)),
        nack=lambda *a: None, client_timeout_s=0.0, **kw)
    for qm in traffic(pkg):
        lam.handler_raw(qm)
    lam.flush()
    return emits, {d: lam.channel_text(f"w{d}", "s", "t")
                   for d in range(10)}


class TestMeshServing:
    def test_multi_client_convergence_on_sharded_sequencer(self):
        srv = server()
        docs, loaders = {}, {}
        for d in range(12):  # more docs than dp shards
            loader, c, ds = make_doc(srv, f"m{d}")
            t = ds.create_channel("text", SharedString.TYPE)
            m = ds.create_channel("meta", SharedMap.TYPE)
            c.attach()
            t.insert_text(0, f"doc{d}:")
            m.set("d", d)
            docs[f"m{d}"] = (c, t, m)
            loaders[f"m{d}"] = loader
        for d in range(12):  # second clients edit concurrently
            c2 = loaders[f"m{d}"].resolve(f"m{d}")
            t2 = c2.runtime.get_datastore("default").get_channel("text")
            t2.insert_text(t2.get_length(), f"+peer{d}")
            docs[f"m{d}"] += (c2, t2)
        for d in range(12):
            c, t, m, c2, t2 = docs[f"m{d}"]
            assert t.get_text() == t2.get_text() == f"doc{d}:+peer{d}"
            assert srv.sequencer().channel_text(
                f"m{d}", "default", "text") == t.get_text()
        # The ticket state and the lanes really span the mesh.
        lam = srv.sequencer()
        assert spans(lam.tstate.next_seq)
        b, lane = lam.merge.where[("m0", "default", "text")]
        assert spans(lam.merge.buckets[b].state.length)

    @pytest.mark.parametrize("paged", [False, True])
    def test_mesh_fast_path_matches_unsharded(self, paged):
        """The same wire traffic through a mesh lambda, an unsharded one
        and the JAX package's: the same emits in the same order (the
        shards' results re-joined in lane order), the same texts. Paged,
        the windows run the megakernel over pages gathered from the
        pool's shards."""
        from fluidframework_tpu.protocol import messages as jm
        from fluidframework_tpu.server import log as jlog, wire as jwire
        from fluidframework_tpu.server.tpu_sequencer import \
            TpuSequencerLambda as JaxLambda
        from fluidframework_tpu_torch.protocol import messages as pm
        from fluidframework_tpu_torch.server import log as plog, \
            wire as pwire
        from fluidframework_tpu_torch.server.tpu_sequencer import \
            TpuSequencerLambda

        port = (pm, plog, pwire)
        ea, ta = fast_run(TpuSequencerLambda, port, device="cpu",
                          paged_lanes=paged)
        eb, tb = fast_run(TpuSequencerLambda, port, device="cpu",
                          mesh=cpu_mesh(), paged_lanes=paged)
        ej, tj = fast_run(JaxLambda, (jm, jlog, jwire), paged_lanes=paged)
        assert eb == ea and tb == ta
        assert sorted(eb) == sorted(ej) and tb == tj

    def test_restart_rebuild_on_mesh(self):
        srv = server()
        loader, c, ds = make_doc(srv, "mr")
        t = ds.create_channel("text", SharedString.TYPE)
        k = ds.create_channel("n", SharedCounter.TYPE)
        c.attach()
        t.insert_text(0, "before ")
        k.increment(4)
        srv._deli_mgr.restart()
        t.insert_text(7, "after")
        k.increment(1)
        lam = srv.sequencer()
        assert lam.channel_text("mr", "default", "text") == "before after"
        assert lam.channel_snapshot("mr", "default", "n")["counter"] == 5
        # The rebuilt lambda placed its lanes on the mesh again.
        assert spans(lam.tstate.next_seq)
        assert shardcheck.verify_store(lam.merge, lam.mesh) > 0

    def test_paged_lanes_on_mesh_place_via_partition_rules(self):
        """A paged sequencer builds on a dp mesh: the page pool placed
        leaf by leaf by POOL_PARTITION_RULES, serving real traffic with
        the pre states kept (no donation on a mesh), and the runtime
        shardcheck proves every plane sits where the table says. The
        pool's spec table equals JAX's string for string."""
        mesh = cpu_mesh()
        srv = server(mesh, paged_lanes=True)
        loader, c, ds = make_doc(srv, "pgm")
        t = ds.create_channel("text", SharedString.TYPE)
        c.attach()
        t.insert_text(0, "paged ")
        t.insert_text(6, "mesh")
        lam = srv.sequencer()
        assert lam.channel_text("pgm", "default", "text") == "paged mesh"
        assert lam.merge.pages.mesh is mesh
        assert lam.merge.pages.donate is False
        assert shardcheck.verify_store(lam.merge, mesh) > 0
        specs = lam.merge.pages.placement_spec_table()
        assert specs["length"] == "PartitionSpec('dp',)"
        assert spans(lam.merge.pages.pool.length)

        from fluidframework_tpu.parallel.mesh import make_mesh as jmesh
        from fluidframework_tpu.server.local_server import \
            TpuLocalServer as JaxServer
        jsrv = JaxServer(mesh=jmesh(sp=1), paged_lanes=True)
        assert jsrv.sequencer().merge.pages.placement_spec_table() == specs

    def test_materialized_not_stale_after_sequencer_restart(self):
        """A crash-restart replaces the lambda (generation counters back
        to 0); the materialized writer must not skip real edits."""
        srv = server()
        loader, c, ds = make_doc(srv, "rs")
        t = ds.create_channel("text", SharedString.TYPE)
        c.attach()
        t.insert_text(0, "one ")
        srv.write_materialized_snapshots()
        srv._deli_mgr.restart()  # fresh lambda, counters reset
        t.insert_text(4, "two")
        shas = srv.write_materialized_snapshots()
        assert written_text(srv, "rs", shas) == "one two"

    def test_mesh_larger_than_default_lanes(self):
        """dp above the default 8 bucket lanes grows then shards (the
        JAX test's 16-device shape, here 16 CPU entries in-process)."""
        from fluidframework_tpu_torch.server.tpu_sequencer import \
            TpuSequencerLambda
        lam = TpuSequencerLambda(_Ctx(), emit=lambda *a: None,
                                 nack=lambda *a: None, device="cpu",
                                 mesh=cpu_mesh(16))
        assert lam.lanes % 16 == 0
        for b in lam.merge.buckets + lam.lww.buckets:
            assert b.lanes % 16 == 0, b.lanes
            assert spans(b.state[0], 16)

    def test_materialized_snapshots_on_mesh(self):
        srv = server()
        loader, c, ds = make_doc(srv, "ms")
        t = ds.create_channel("text", SharedString.TYPE)
        c.attach()
        t.insert_text(0, "sharded extraction " * 5)
        shas = srv.write_materialized_snapshots()
        assert written_text(srv, "ms", shas) == t.get_text()

    def test_payload_collection_preserves_sharding(self):
        """The major payload collection rebuilds the origin_op / anno
        planes on the host; on a mesh the bucket's placer places them
        again, and the renumbered ids still resolve the exact text."""
        srv = server()
        loader, c, ds = make_doc(srv, "mc")
        t = ds.create_channel("text", SharedString.TYPE)
        c.attach()
        for i in range(60):
            t.insert_text(t.get_length(), f"w{i} ")
        store = srv.sequencer().merge
        b, lane = store.where[("mc", "default", "text")]
        bucket = store.buckets[b]
        assert spans(bucket.state.origin_op)
        store.payload_compact_min_entries = 0
        assert store.compact_payload_ids() is True
        assert store.payload_compactions >= 1
        assert spans(bucket.state.origin_op) and spans(bucket.state.anno)
        assert srv.sequencer().channel_text(
            "mc", "default", "text") == t.get_text()
        t.insert_text(0, ">>")
        assert srv.sequencer().channel_text(
            "mc", "default", "text") == t.get_text()

    def test_lww_value_compaction_preserves_sharding(self):
        srv = server()
        loader, c, ds = make_doc(srv, "mv")
        m = ds.create_channel("meta", SharedMap.TYPE)
        c.attach()
        for i in range(30):
            m.set("k", f"v{i}")  # 29 superseded values to reclaim
        lww = srv.sequencer().lww
        b, lane = lww.where[("mv", "default", "meta")]
        assert spans(lww.buckets[b].state.val)
        lww.compact_values()
        assert spans(lww.buckets[b].state.val)
        snap = srv.sequencer().channel_snapshot("mv", "default", "meta")
        assert snap["entries"]["k"] == "v29"
        m.set("k2", "post")  # lanes still editable after the re-place
        assert srv.sequencer().channel_snapshot(
            "mv", "default", "meta")["entries"]["k2"] == "post"

    def test_host_fold_on_sharded_lanes(self):
        """The serving zamboni pack on sharded lanes: the fold's row
        reads, host reseed and batched row writes cross the shards.
        Sustained typing overflows the fold bucket and packs there instead
        of promoting, with the exact text after."""
        import random

        srv = server()
        loader, c, ds = make_doc(srv, "mf")
        t = ds.create_channel("text", SharedString.TYPE)
        c.attach()
        store = srv.sequencer().merge
        rng = random.Random(53)
        for i in range(400):
            t.insert_text(rng.randrange(t.get_length() + 1), f"s{i % 10}")
        assert store.folds > 0, "fold never fired on the mesh"
        b, lane = store.where[("mf", "default", "text")]
        assert b <= store.capacities.index(store.fold_min_capacity)
        assert spans(store.buckets[b].state.length)
        assert srv.sequencer().channel_text(
            "mf", "default", "text") == t.get_text()
        for i in range(40):
            if t.get_length() > 10 and rng.random() < 0.4:
                start = rng.randrange(t.get_length() - 4)
                t.remove_text(start, start + 3)
            else:
                t.insert_text(rng.randrange(t.get_length() + 1), "Q")
        assert srv.sequencer().channel_text(
            "mf", "default", "text") == t.get_text()


def test_mesh_placement_disables_lane_state_donation():
    """The stated rule in place of JAX's knob: a lambda on a mesh keeps
    every window's pre lane states (JAX's donate_lane_states is False
    there), takes the scan apply (its _fused_serve is off) and so runs no
    fused burst; without a mesh it may donate. The rule is read, not
    set."""
    from fluidframework_tpu_torch.server.tpu_sequencer import \
        TpuSequencerLambda

    def lam(**kw):
        return TpuSequencerLambda(_Ctx(), emit=lambda *a: None,
                                  nack=lambda *a: None, device="cpu", **kw)

    plain, meshed = lam(), lam(mesh=cpu_mesh())
    assert plain.donate_lane_states is True and plain.fused_serve is True
    assert meshed.donate_lane_states is False
    assert meshed.fused_serve is False
    with pytest.raises(AttributeError):
        meshed.donate_lane_states = True


@pytest.mark.parametrize("layout", ["bucketed", "paged"])
def test_server_scenario_on_mesh_matches_golden(layout):
    """testing/server_runs.py at SERVER_SMALL through TpuLocalServer on a
    4-entry CPU mesh equals the JAX golden's small section, digest for
    digest, and the store's placement holds after the run."""
    mesh = make_mesh(dp=4, devices=["cpu"] * 4)
    stores = []

    def measured(srv, run_waves):
        stores.append(srv)
        return run_waves()

    got = server_runs.run(server_runs.port_package("cpu", mesh),
                          server_runs.Spec(**golden.SERVER_SMALL),
                          hooks={"measured": measured},
                          **server_runs.VARIANTS[layout])
    assert got == golden.load_server()["small"][layout]
    for lam in stores[0].ingest.sequencers():
        assert lam.mesh is mesh
        assert shardcheck.verify_store(lam.merge) > 0
