"""Historian tier tests: the standalone summary-cache between serving and
GitStore (server/historian.py + server/cache.py).

Covers the acceptance behaviors: cold-miss -> warm-hit on a second
container load (counters visible through monitor.py), write-through
invalidation on summary commit (stale blob never served), and graceful
degradation to direct GitStore reads when the historian dies mid-load.

A mirror of tests/test_historian.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

import functools
import json
import time
import urllib.request

import pytest

from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as _container
from fluidframework_tpu_torch.loader.drivers.routerlicious import (
    NetworkDocumentServiceFactory,
    RestError,
    RestWrapper,
)
from fluidframework_tpu_torch.server.cache import LruTtlCache
from fluidframework_tpu_torch.server.historian import (
    HistorianService,
    HistorianTier,
    StoreUpstream,
)
from fluidframework_tpu_torch.server.monitor import ServiceMonitor
from fluidframework_tpu_torch.server.storage import Historian
from fluidframework_tpu_torch.server.tinylicious import DEFAULT_TENANT, Tinylicious
from fluidframework_tpu_torch.protocol.summary import SummaryTree


# The port runs on the card unless told otherwise; these tests run on
# the CPU.
Loader = functools.partial(_container.Loader, device="cpu")


def wait_until(predicate, timeout=10.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


class TestLruTtlCache:
    def test_lru_eviction_order(self):
        c = LruTtlCache(max_entries=2)
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1  # refresh a; b is now coldest
        c.put("c", 3)
        assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
        assert c.evictions == 1

    def test_byte_budget_evicts_cold_end(self):
        c = LruTtlCache(max_entries=100, max_bytes=100)
        c.put("a", "x", nbytes=60)
        c.put("b", "y", nbytes=60)  # over budget: a evicts
        assert c.get("a") is None and c.get("b") == "y"
        assert c.bytes == 60
        # A single oversized entry stays (never evict down to empty).
        c.put("huge", "z", nbytes=500)
        assert c.get("huge") == "z"

    def test_ttl_expiry_and_override(self):
        c = LruTtlCache(ttl_s=0.05)
        c.put("short", 1)
        c.put("pinned", 2, ttl_s=None)  # overrides to no expiry
        time.sleep(0.08)
        assert c.get("short") is None
        assert c.get("pinned") == 2
        assert c.expirations == 1

    def test_invalidate_and_counters(self):
        c = LruTtlCache()
        c.put("k", "v", nbytes=10)
        assert c.invalidate("k") is True
        assert c.invalidate("k") is False
        assert c.get("k") is None
        s = c.stats()
        assert s["invalidations"] == 1 and s["misses"] == 1
        assert s["bytes"] == 0


def _summary_v(text: str) -> SummaryTree:
    root = SummaryTree()
    ds = root.add_tree("default")
    ds.add_blob("header", json.dumps({"text": text}))
    return root


class TestHistorianTierStoreMode:
    """Tier semantics against a direct (in-process) store — the
    shared-storage deployment mode, deterministic by construction."""

    def _tier(self, ref_ttl_s=60.0):
        store = Historian()
        return store, HistorianTier(StoreUpstream(store),
                                    ref_ttl_s=ref_ttl_s)

    def test_cold_miss_then_warm_hit(self):
        store, tier = self._tier()
        gstore = store.store("t", "d")
        gstore.write_summary(_summary_v("one"), advance_ref=True)
        first = tier.read_summary_dict("t", "d")
        assert first["entries"]["default"]["entries"]["header"]["content"] \
            == json.dumps({"text": "one"})
        miss_baseline = tier.objects.misses
        assert miss_baseline > 0 and tier.objects.hits == 0
        second = tier.read_summary_dict("t", "d")
        assert second == first
        assert tier.objects.misses == miss_baseline  # no new upstream reads
        assert tier.objects.hits >= 3  # commit + tree(s) + blob

    def test_stale_ref_without_invalidation_then_fresh_after(self):
        """The causal chain the invalidation contract exists for: a
        writer that bypasses the tier leaves the cached ref pointer
        stale (within TTL); handle_summary_commit flushes it so the next
        read serves the new summary."""
        store, tier = self._tier(ref_ttl_s=60.0)
        gstore = store.store("t", "d")
        gstore.write_summary(_summary_v("one"), advance_ref=True)
        assert tier.read_summary_dict("t", "d") is not None  # ref cached
        sha2 = gstore.write_summary(_summary_v("two"), advance_ref=True)
        stale = tier.read_summary_dict("t", "d")
        assert stale["entries"]["default"]["entries"]["header"]["content"] \
            == json.dumps({"text": "one"})  # pointer staleness is real
        tier.handle_summary_commit("t", "d", sha=sha2)
        fresh = tier.read_summary_dict("t", "d")
        assert fresh["entries"]["default"]["entries"]["header"]["content"] \
            == json.dumps({"text": "two"})
        assert tier.refs.invalidations >= 1

    def test_write_through_invalidates_and_prefetches(self):
        store, tier = self._tier(ref_ttl_s=60.0)
        gstore = store.store("t", "d")
        gstore.write_summary(_summary_v("one"), advance_ref=True)
        tier.read_summary_dict("t", "d")
        from fluidframework_tpu_torch.protocol.summary import summary_tree_to_dict
        sha2 = tier.upload_summary("t", "d", {
            "summary": summary_tree_to_dict(_summary_v("two")),
            "parent": None, "initial": False})
        assert gstore.get(sha2) is not None  # landed upstream
        assert tier.prefetched_objects > 0   # warm-on-summary
        # The proposal does NOT advance the ref (scribe acks do); the
        # tier must still serve the CURRENT ref, not the proposal.
        cur = tier.read_summary_dict("t", "d")
        assert cur["entries"]["default"]["entries"]["header"]["content"] \
            == json.dumps({"text": "one"})
        # Once the "scribe" advances the ref and the commit notification
        # fires, the new summary serves entirely from the warm cache.
        gstore.set_ref("main", sha2)
        tier.handle_summary_commit("t", "d", sha=sha2)
        fetches = tier.upstream_fetches
        new = tier.read_summary_dict("t", "d")
        assert new["entries"]["default"]["entries"]["header"]["content"] \
            == json.dumps({"text": "two"})
        # Only the ref lookup touched upstream; every object was warm.
        assert tier.upstream_fetches == fetches + 1

    def test_prefetch_skips_shared_subtrees(self):
        """Incremental summaries share unchanged subtrees by sha; the
        warm-on-summary walk serves them straight from the cache — zero
        upstream fetches beyond the changed set — and counts them
        (prefetchSharedTrees must actually move, proving the shared
        detection isn't dead code against the bare-sha cache keying)."""
        store, tier = self._tier()
        gstore = store.store("t", "d")

        def two_channel(text_a: str, text_b: str) -> SummaryTree:
            root = SummaryTree()
            for name, text in (("a", text_a), ("b", text_b)):
                ds = root.add_tree(name)
                ds.add_blob("header", json.dumps({"text": text}))
            return root

        sha1 = gstore.write_summary(two_channel("one", "same"),
                                    advance_ref=True)
        tier.handle_summary_commit("t", "d", sha=sha1)
        assert tier.prefetch_shared_trees == 0
        # Second commit changes only channel "a": channel "b"'s subtree
        # sha is unchanged and already warm from the first prefetch.
        sha2 = gstore.write_summary(two_channel("two", "same"),
                                    advance_ref=True,
                                    base_commit=sha1)
        fetched_before = tier.upstream_fetches
        tier.handle_summary_commit("t", "d", sha=sha2)
        assert tier.prefetch_shared_trees >= 1
        assert tier.stats()["prefetchSharedTrees"] >= 1
        # The shared subtree's blob was NOT re-fetched upstream.
        walked = tier.upstream_fetches - fetched_before
        assert walked <= 4, walked  # commit + root + changed subtree+blob

    def test_ttl_bounds_staleness_for_bypass_writers(self):
        store, tier = self._tier(ref_ttl_s=0.05)
        gstore = store.store("t", "d")
        gstore.write_summary(_summary_v("one"), advance_ref=True)
        tier.read_summary_dict("t", "d")
        gstore.write_summary(_summary_v("two"), advance_ref=True)
        time.sleep(0.08)  # pointer expired; no notification needed
        fresh = tier.read_summary_dict("t", "d")
        assert fresh["entries"]["default"]["entries"]["header"]["content"] \
            == json.dumps({"text": "two"})

    def test_versions_walk_rides_object_cache(self):
        store, tier = self._tier()
        gstore = store.store("t", "d")
        gstore.write_summary(_summary_v("one"), advance_ref=True)
        gstore.write_summary(_summary_v("two"), advance_ref=True)
        shas = tier.versions("t", "d", count=2)
        assert len(shas) == 2
        assert shas == [c.sha for c in gstore.list_commits(limit=2)]


@pytest.fixture()
def topology():
    """The local topology: tinylicious alfred + standalone historian
    (proxy mode) + monitor, fully cross-wired."""
    with Tinylicious() as tiny:
        hist = HistorianService(upstream_url=tiny.url).start()
        tiny.attach_historian(hist.url)
        monitor = ServiceMonitor(device="cpu")
        monitor.watch_historian("historian", hist)
        monitor.start()
        try:
            yield tiny, hist, monitor
        finally:
            monitor.stop()
            try:
                hist.stop()
            except Exception:
                pass


def _make_doc(tiny, hist, doc_id):
    factory = NetworkDocumentServiceFactory(tiny.url, DEFAULT_TENANT,
                                            historian_url=hist.url)
    loader = Loader(factory)
    container = loader.create_detached(doc_id)
    ds = container.runtime.create_datastore("default")
    return loader, container, ds


def _load_doc(tiny, hist, doc_id):
    factory = NetworkDocumentServiceFactory(tiny.url, DEFAULT_TENANT,
                                            historian_url=hist.url)
    return Loader(factory).resolve(doc_id)


class TestHistorianTopology:
    def test_second_load_serves_blobs_from_cache(self, topology):
        tiny, hist, monitor = topology
        loader, c1, ds1 = _make_doc(tiny, hist, "hist-warm")
        m = ds1.create_channel("root", SharedMap.TYPE)
        with c1.op_lock:
            m.set("k", "v1")
        c1.attach()  # write-through upload + warm-on-summary prefetch
        assert hist.stats()["prefetchedObjects"] > 0
        c2 = _load_doc(tiny, hist, "hist-warm")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        assert m2.get("k") == "v1"
        stats = hist.stats()
        assert stats["objects"]["hits"] > 0
        # The counters are VISIBLE through monitor.py's HTTP surface.
        report = json.loads(urllib.request.urlopen(
            monitor.url + "/metrics").read())
        probe = report["probes"]["historian"]
        assert probe["objects"]["hits"] > 0
        assert probe["objects"]["hitRate"] > 0
        c1.close()
        c2.close()

    def test_summary_write_invalidates_before_next_read(self, topology):
        tiny, hist, monitor = topology
        loader, c1, ds1 = _make_doc(tiny, hist, "hist-inv")
        t = ds1.create_channel("text", SharedString.TYPE)
        with c1.op_lock:
            t.insert_text(0, "before")
        c1.attach()
        # Prime the tier's latest pointer.
        rest = RestWrapper(hist.url)
        repo = f"/repos/{DEFAULT_TENANT}/hist-inv"
        first = rest.get(repo + "/summaries/latest")["summary"]
        with c1.op_lock:
            t.insert_text(6, " after")
        results = []
        with c1.op_lock:
            c1.summarize(lambda handle, ack, contents:
                         results.append((handle, ack)))
        assert wait_until(lambda: bool(results))
        assert results[0][1] is True  # scribe acked; ref advanced
        # The commit notification must have flushed the pointer: the
        # very next read through the tier serves the NEW summary.
        second = rest.get(repo + "/summaries/latest")["summary"]
        assert second != first
        direct = RestWrapper(tiny.url).get(
            repo + "/summaries/latest")["summary"]
        assert second == direct  # never a stale blob vs the GitStore
        assert hist.stats()["refs"]["invalidations"] >= 1
        c1.close()

    def test_alfred_delegates_latest_to_historian(self, topology):
        tiny, hist, monitor = topology
        loader, c1, ds1 = _make_doc(tiny, hist, "hist-deleg")
        m = ds1.create_channel("root", SharedMap.TYPE)
        with c1.op_lock:
            m.set("k", "v")
        c1.attach()
        reads_before = hist.stats()["summaryReads"]
        out = RestWrapper(tiny.url).get(
            f"/repos/{DEFAULT_TENANT}/hist-deleg/summaries/latest")
        assert "summary" in out
        # Alfred's own route rode the tier (TIER_HEADER loop guard keeps
        # the tier's upstream fetches direct).
        assert hist.stats()["summaryReads"] == reads_before + 1
        c1.close()

    def test_historian_killed_mid_load_degrades_to_gitstore(self, topology):
        tiny, hist, monitor = topology
        loader, c1, ds1 = _make_doc(tiny, hist, "hist-kill")
        m = ds1.create_channel("root", SharedMap.TYPE)
        with c1.op_lock:
            m.set("k", "survives")
        c1.attach()
        hist.stop()  # the tier dies; alfred + clients must keep working
        c2 = _load_doc(tiny, hist, "hist-kill")  # still pointed at it
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        assert m2.get("k") == "survives"
        # Alfred's delegated route degrades to direct GitStore too.
        out = RestWrapper(tiny.url).get(
            f"/repos/{DEFAULT_TENANT}/hist-kill/summaries/latest")
        assert "summary" in out
        c1.close()
        c2.close()

    def test_gitrest_object_routes(self, topology):
        tiny, hist, monitor = topology
        loader, c1, ds1 = _make_doc(tiny, hist, "hist-git")
        m = ds1.create_channel("root", SharedMap.TYPE)
        with c1.op_lock:
            m.set("k", "v")
        c1.attach()
        repo = f"/repos/{DEFAULT_TENANT}/hist-git"
        for base in (tiny.url, hist.url):
            rest = RestWrapper(base)
            ref = rest.get(repo + "/git/refs/main")
            assert ref["sha"]
            commit = rest.get(repo + f"/git/objects/{ref['sha']}")
            assert commit["kind"] == "commit"
            tree = rest.get(repo + f"/git/trees/{commit['tree']}")
            assert tree["kind"] == "tree" and tree["entries"]
            with pytest.raises(RestError) as exc:
                rest.get(repo + f"/git/blobs/{commit['tree']}")  # wrong kind
            assert exc.value.status == 404
        c1.close()


class TestHistorianAuth:
    def test_token_forwarded_and_required(self):
        with Tinylicious(require_auth=True) as tiny:
            hist = HistorianService(upstream_url=tiny.url).start()
            try:
                provider = tiny.token_provider()
                factory = NetworkDocumentServiceFactory(
                    tiny.url, DEFAULT_TENANT, token_provider=provider,
                    historian_url=hist.url)
                loader = Loader(factory)
                c1 = loader.create_detached("authed")
                ds = c1.runtime.create_datastore("default")
                m = ds.create_channel("root", SharedMap.TYPE)
                with c1.op_lock:
                    m.set("k", "v")
                c1.attach()
                c2 = Loader(NetworkDocumentServiceFactory(
                    tiny.url, DEFAULT_TENANT, token_provider=provider,
                    historian_url=hist.url)).resolve("authed")
                assert c2.runtime.get_datastore("default") \
                    .get_channel("root").get("k") == "v"
                assert hist.stats()["objects"]["hits"] > 0
                # No token: the tier forwards nothing, alfred rejects.
                with pytest.raises(RestError) as exc:
                    RestWrapper(hist.url).get(
                        f"/repos/{DEFAULT_TENANT}/authed/summaries/latest")
                assert exc.value.status in (401, 403)
                c1.close()
                c2.close()
            finally:
                hist.stop()


class TestClusterFailoverWithHistorian:
    def test_failover_keeps_serving_through_tier_then_degrades(self):
        """The cluster failover path with the cache tier in the loop: a
        node death + takeover keeps loading through the tier (the cache
        is content-keyed, not node-keyed), and poisoning the tier
        degrades reads to the direct shared store."""
        from fluidframework_tpu_torch.loader.drivers.cluster import (
            ClusterDocumentServiceFactory,
        )
        from fluidframework_tpu_torch.server.nodes import Cluster

        cluster = Cluster()
        n1 = cluster.create_node("A")
        n2 = cluster.create_node("B")
        tier = HistorianTier(StoreUpstream(cluster.historian),
                             ref_ttl_s=0.0)  # refs always fresh
        factory = ClusterDocumentServiceFactory(cluster, n1,
                                                historian_tier=tier)
        loader = Loader(factory)
        c1 = loader.create_detached("failover")
        ds = c1.runtime.create_datastore("default")
        m = ds.create_channel("root", SharedMap.TYPE)
        with c1.op_lock:
            m.set("k", "v")
        c1.attach()
        # First load populates the tier's object cache.
        c_warm = loader.resolve("failover")
        assert tier.objects.misses > 0
        c_warm.close()
        hits_before = tier.objects.hits
        # Entry node dies; repoint and reload through the surviving node.
        n1.stop()
        factory.set_node(n2)
        c2 = loader.resolve("failover")
        assert c2.runtime.get_datastore("default") \
            .get_channel("root").get("k") == "v"
        assert tier.objects.hits > hits_before  # served from cache
        # Tier death mid-flight: reads degrade to the direct store.
        tier.upstream = None  # every tier call now raises
        c3 = loader.resolve("failover")
        assert c3.runtime.get_datastore("default") \
            .get_channel("root").get("k") == "v"
        c1.close()
        c2.close()
        c3.close()
