"""The port's host-only drivers held to the JAX package's: a mirror of
tests/test_drivers.py (replay, file, debug drivers, URL resolvers),
tests/test_driver_wrappers.py (caching and proxy drivers),
tests/test_resilience.py (retry, single flight, prefetch, the server's
throttle honored end to end) and
tests/test_incremental_summary.py::test_caching_driver_never_caches_handle_trees.

Every test runs one script through the JAX package and through
fluidframework_tpu_torch (device="cpu"), with the same pins
(testing/client_runs.pinned). Each script makes every assertion of the
JAX test it mirrors and returns what it observed; the results must be
equal. No test waits on wall time: the retry policies take a recording
sleep, and the nack recovery's sleep is an event the test releases.
test_resilience.py's two historian cases (TestStickyDegradationWithHistorian)
drive the routerlicious driver; they are mirrored in
tests/test_torch_server_services.py.
"""

import json
import random
import threading
import time

import pytest
import torch

from torch_stacks import same

torch.set_num_threads(1)


def untimed(messages) -> list:
    """Messages in JSON form without their wall-clock timestamps."""
    return [{k: v for k, v in m.items() if k != "timestamp"}
            for m in messages]


def text_of(container, store="default", channel="t"):
    return container.runtime.get_datastore(store).get_channel(channel) \
        .get_text()


# --- mirrors tests/test_drivers.py -----------------------------------------

def record_session(s):
    """A live session: attach summary + op tail, returned as a capture."""
    server = s.local_server.LocalServer()
    loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    text = ds.create_channel("t", s.sequence.SharedString.TYPE)
    text.insert_text(0, "recorded")
    c1.attach()
    text.insert_text(8, " session")
    server.pump()
    summary = server.storage("doc").read_summary()
    ops = loader.factory.create_document_service("doc") \
        .connect_to_delta_storage().get(0)
    return summary, ops, text.get_text()


class TestReplayDriver:
    def test_full_replay_matches_live(self):
        def script(s):
            summary, ops, expected = record_session(s)
            c = s.load("doc", s.replay.ReplayDocumentService(summary, ops))
            assert text_of(c) == expected
            return [text_of(c), len(ops)]
        same(script)

    def test_watermark_stepping(self):
        def script(s):
            summary, ops, expected = record_session(s)
            controller = s.replay.ReplayController(replay_to=0)
            service = s.replay.ReplayDocumentService(summary, ops,
                                                     controller)
            c = s.load("doc", service)
            before = text_of(c)
            controller.forward(None)  # release everything
            assert text_of(c) == expected
            assert before != expected or not ops  # the watermark held ops
            return [before, text_of(c)]
        same(script)

    def test_read_only(self):
        def script(s):
            summary, ops, _ = record_session(s)
            c = s.load("doc", s.replay.ReplayDocumentService(summary, ops))
            with pytest.raises(PermissionError):
                c.delta_manager.submit("op", {"x": 1})
            storage = s.replay.ReplayDocumentService(
                summary, ops).connect_to_storage()
            with pytest.raises(PermissionError):
                storage.upload_summary(summary)
            return storage.get_versions()
        same(script)


class TestFileDriver:
    def test_capture_and_reload(self, tmp_path):
        def script(s):
            summary, ops, expected = record_session(s)
            root = tmp_path / s.name
            capture = s.file.FileDocumentCapture(str(root / "doc"))
            capture.write_summary(summary)
            capture.write_ops(ops)
            factory = s.file.FileDocumentServiceFactory(str(root))
            c = s.load("doc", factory.create_document_service("doc"))
            assert text_of(c) == expected
            return [text_of(c), untimed(json.loads(
                (root / "doc" / "ops.json").read_text())),
                (root / "doc" / "summary.json").read_text()]
        same(script)

    def test_missing_document(self, tmp_path):
        def script(s):
            factory = s.file.FileDocumentServiceFactory(
                str(tmp_path / s.name))
            with pytest.raises(FileNotFoundError):
                s.load("nope", factory.create_document_service("nope"))
            return sorted(p.name for p in (tmp_path / s.name).iterdir())
        same(script)

    def test_append_ops(self, tmp_path):
        def script(s):
            capture = s.file.FileDocumentCapture(str(tmp_path / s.name))
            _, ops, _ = record_session(s)
            capture.write_ops(ops[:2])
            capture.append_ops(ops[2:])
            assert len(capture.read_ops()) == len(ops)
            return untimed(s.file.message_to_json(m)
                           for m in capture.read_ops())
        same(script)


class TestDebugDriver:
    def test_step_through_ops(self):
        def script(s):
            server = s.local_server.LocalServer(auto_pump=False)
            loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server))
            c1 = loader.create_detached("doc")
            ds = c1.runtime.create_datastore("default")
            text = ds.create_channel("t", s.sequence.SharedString.TYPE)
            c1.attach()
            server.pump()
            controller = s.debug.DebugController(paused=False)
            debug_factory = s.debug.DebugDocumentServiceFactory(
                s.local_driver.LocalDocumentServiceFactory(server),
                controller)
            c2 = s.Loader(debug_factory).resolve("doc")
            server.pump()  # sequence c2's own join before pausing
            controller.pause()
            text.insert_text(0, "abc")
            text.insert_text(3, "def")
            server.pump()
            assert text_of(c2) == ""  # held by the debugger
            held = c2.delta_manager.connection.held_count
            controller.step(1)
            assert text_of(c2) == "abc"
            controller.go()
            assert text_of(c2) == "abcdef"
            return [held, text_of(c2)]
        same(script)


class TestUrlResolvers:
    def test_fluid_url(self):
        def script(s):
            resolved = s.url_resolver.FluidUrlResolver().resolve(
                "fluid://localhost:3000/tenantA/doc42/path/x")
            assert resolved.tenant_id == "tenantA"
            assert resolved.document_id == "doc42"
            assert resolved.path == "/path/x"
            assert resolved.endpoint == "localhost:3000"
            with pytest.raises(ValueError, match="unsupported scheme"):
                s.url_resolver.FluidUrlResolver().resolve("ftp://h/t/d")
            return vars(resolved)
        same(script)

    def test_default_tenant(self):
        def script(s):
            resolved = s.url_resolver.FluidUrlResolver(
                default_tenant="local").resolve("fluid://host/onlydoc")
            assert resolved.tenant_id == "local"
            assert resolved.document_id == "onlydoc"
            return vars(resolved)
        same(script)

    def test_multi_resolver(self):
        def script(s):
            class Rejecting:
                def resolve(self, url):
                    raise ValueError("nope")

            multi = s.url_resolver.MultiUrlResolver(
                Rejecting(), s.url_resolver.FluidUrlResolver())
            assert multi.resolve("fluid://h/t/d").document_id == "d"
            with pytest.raises(ValueError):
                s.url_resolver.MultiUrlResolver(Rejecting()).resolve(
                    "fluid://h/t/d")
            return vars(multi.resolve("fluid://h/t/d"))
        same(script)


# --- mirrors tests/test_driver_wrappers.py ----------------------------------

def seeded_server(s, text="cached content"):
    server = s.local_server.LocalServer()
    loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    t = ds.create_channel("t", s.sequence.SharedString.TYPE)
    t.insert_text(0, text)
    c1.attach()
    c1.summarize()
    server.pump()
    return server, c1, t


def caching(s, server, cache):
    return s.caching.CachingDocumentServiceFactory(
        s.local_driver.LocalDocumentServiceFactory(server), cache)


class TestCachingDriver:
    def test_cache_hit_on_second_load(self, tmp_path):
        def script(s):
            server, c1, t = seeded_server(s)
            cache = s.caching.PersistentCache(str(tmp_path / s.name))
            loader = s.Loader(caching(s, server, cache))
            a = loader.resolve("doc")
            assert cache.misses >= 1
            hits_before = cache.hits
            b = loader.resolve("doc")
            assert cache.hits > hits_before
            for c in (a, b):
                assert text_of(c) == "cached content"
            return [cache.hits, cache.misses]
        same(script)

    def test_epoch_invalidation_on_new_summary(self, tmp_path):
        def script(s):
            server, c1, t = seeded_server(s)
            factory = caching(s, server, s.caching.PersistentCache(
                str(tmp_path / s.name)))
            s.Loader(factory).resolve("doc")        # populate cache
            t.insert_text(0, "fresh ")
            c1.summarize()                          # head version moves
            server.pump()
            c2 = s.Loader(factory).resolve("doc")   # cache must refresh
            assert text_of(c2) == "fresh cached content"
            return text_of(c2)
        same(script)

    def test_live_edits_flow_through_cached_load(self):
        def script(s):
            server, c1, t = seeded_server(s)
            c2 = s.Loader(caching(s, server, s.caching.PersistentCache())) \
                .resolve("doc")
            t2 = c2.runtime.get_datastore("default").get_channel("t")
            t.insert_text(0, "live ")
            assert t2.get_text() == "live cached content"
            t2.insert_text(0, "both ")
            assert t.get_text() == "both live cached content"
            return t.get_text()
        same(script)

    def test_cached_tail_beyond_hole_not_served(self):
        """Cached ops past an uncached hole must not mask the hole."""
        def script(s):
            server, c1, t = seeded_server(s)
            cache = s.caching.PersistentCache()
            service = caching(s, server, cache).create_document_service(
                "doc")
            service.connect_to_storage().get_summary()  # the cache entry
            delta = service.connect_to_delta_storage()
            full = delta.get(0)  # populates the cached op tail
            entry = cache.get("doc")
            entry["ops"] = entry["ops"][2:]  # a hole: drop two cached ops
            cache.put("doc", entry)
            refetched = delta.get(0)
            assert [m.sequence_number for m in refetched] == \
                [m.sequence_number for m in full]
            return [m.sequence_number for m in refetched]
        same(script)

    def test_explicit_version_bypasses_cache(self):
        def script(s):
            server, c1, t = seeded_server(s)
            cache = s.caching.PersistentCache()
            storage = caching(s, server, cache).create_document_service(
                "doc").connect_to_storage()
            storage.get_summary()              # populates cache with head
            assert cache.get("doc") is not None
            version_entry = dict(cache.get("doc"))
            storage.get_summary(version="some-old-sha")  # must not poison
            assert cache.get("doc")["version"] == version_entry["version"]
            return [cache.hits, cache.misses]
        same(script)

    def test_token_refresh_on_auth_failure(self):
        def script(s):
            calls = []

            def provider(refresh):
                calls.append(refresh)
                return "tok-2" if refresh else "tok-1"

            wrapper = s.caching.TokenRefreshWrapper(provider)

            def guarded(token):
                if token != "tok-2":
                    raise PermissionError("expired")
                return "ok"

            assert wrapper.call(guarded) == "ok"
            assert calls == [False, True]
            # The refreshed token is reused without refetching.
            assert wrapper.call(guarded) == "ok"
            assert calls == [False, True]
            return calls
        same(script)


class TestProxyDriver:
    @staticmethod
    def proxy_loader(s, server):
        host = s.proxy.DriverProxyHost(
            s.local_driver.LocalDocumentServiceFactory(server))
        # Every payload crosses the boundary through JSON.
        codec = lambda d: json.loads(json.dumps(d))  # noqa: E731
        return s.Loader(s.proxy.ProxyDocumentServiceFactory.over_host(
            host, codec))

    def test_full_session_through_serialized_boundary(self):
        def script(s):
            server, c1, t = seeded_server(s)
            c2 = self.proxy_loader(s, server).resolve("doc")
            t2 = c2.runtime.get_datastore("default").get_channel("t")
            assert t2.get_text() == "cached content"
            t2.insert_text(0, "inner ")
            assert t.get_text() == "inner cached content"
            t.insert_text(0, "outer ")
            assert t2.get_text() == "outer inner cached content"
            return t2.get_text()
        same(script)

    def test_detached_create_through_proxy(self):
        def script(s):
            server = s.local_server.LocalServer()
            c = self.proxy_loader(s, server).create_detached("fresh")
            m = c.runtime.create_datastore("d").create_channel(
                "m", s.map.SharedMap.TYPE)
            c.attach()
            m.set("k", [1, 2, 3])
            direct = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server)).resolve("fresh")
            assert direct.runtime.get_datastore("d").get_channel("m") \
                .get("k") == [1, 2, 3]
            return direct.runtime.get_datastore("d").get_channel("m") \
                .get("k")
        same(script)

    def test_errors_marshal_across_boundary(self):
        def script(s):
            loader = self.proxy_loader(s, s.local_server.LocalServer())
            with pytest.raises(FileNotFoundError):
                loader.resolve("missing-doc")
            host = s.proxy.DriverProxyHost(
                s.local_driver.LocalDocumentServiceFactory(
                    s.local_server.LocalServer()))
            return [host.handle({"op": "nonsense"})["kind"],
                    host.handle({"op": "getSummary", "documentId": "x"})]
        same(script)


def test_caching_driver_never_caches_handle_trees(tmp_path):
    """An incremental upload is not self-contained; the caching driver must
    not serve it as a boot summary (mirrors tests/test_incremental_summary
    .py::test_caching_driver_never_caches_handle_trees)."""
    def script(s):
        server = s.local_server.LocalServer()
        cache = s.caching.PersistentCache(str(tmp_path / s.name))
        factory = caching(s, server, cache)
        loader = s.Loader(factory)
        c = loader.create_detached("cached")
        ds = c.runtime.create_datastore("default")
        t = ds.create_channel("text", s.sequence.SharedString.TYPE)
        c.attach()
        t.insert_text(0, "alpha ")
        done = []
        c.summarize(lambda h, ack, _: done.append(ack))
        assert done[-1]
        t.insert_text(6, "beta")
        done2 = []
        c.summarize(lambda h, ack, _: done2.append(ack))  # incremental
        assert done2[-1]
        # A fresh boot through the same cache loads FULL content.
        c2 = s.Loader(factory).resolve("cached")
        assert text_of(c2, channel="text") == "alpha beta"
        return [done, done2, text_of(c2, channel="text")]
    same(script)


# --- mirrors tests/test_resilience.py ---------------------------------------

def instant_policy(s, **kw):
    delays = []
    kw.setdefault("sleep", delays.append)
    return s.resilience.RetryPolicy(**kw), delays


class TestRetryPolicy:
    def test_retries_transient_then_succeeds(self):
        def script(s):
            policy, delays = instant_policy(s, max_attempts=5,
                                            rng=random.Random(1))
            calls = {"n": 0}

            def flaky():
                calls["n"] += 1
                if calls["n"] < 3:
                    raise ConnectionError("blip")
                return "ok"

            assert policy.run(flaky) == "ok"
            assert calls["n"] == 3 and len(delays) == 2
            return delays
        same(script)

    def test_exhausts_attempts(self):
        def script(s):
            policy, delays = instant_policy(s, max_attempts=3,
                                            rng=random.Random(2))
            with pytest.raises(ConnectionError):
                policy.run(lambda: (_ for _ in ()).throw(ConnectionError()))
            return delays
        same(script)

    def test_throttle_retry_after_honored(self):
        def script(s):
            policy, delays = instant_policy(s, max_attempts=3)
            calls = {"n": 0}

            def throttled():
                calls["n"] += 1
                if calls["n"] == 1:
                    raise s.resilience.ThrottlingError(retry_after_s=1.25)
                return "ok"

            assert policy.run(throttled) == "ok"
            assert delays == [1.25]
            return delays
        same(script)

    def test_non_retryable_is_immediate(self):
        def script(s):
            policy, delays = instant_policy(s, max_attempts=5)
            with pytest.raises(s.resilience.NonRetryableError):
                policy.run(lambda: (_ for _ in ()).throw(
                    s.resilience.NonRetryableError()))
            assert delays == []
            return delays
        same(script)

    def test_backoff_grows_and_caps(self):
        def script(s):
            policy, delays = instant_policy(
                s, max_attempts=6, base_delay_s=1.0, max_delay_s=4.0,
                rng=random.Random(0))
            retries = []
            with pytest.raises(ConnectionError):
                policy.run(lambda: (_ for _ in ()).throw(ConnectionError()),
                           on_retry=lambda n, d: retries.append(n))
            # Full jitter: each delay <= min(max, base * 2^(attempt-1)).
            caps = [1.0, 2.0, 4.0, 4.0, 4.0]
            assert all(d <= c for d, c in zip(delays, caps))
            assert retries == [1, 2, 3, 4, 5]
            return delays
        same(script)


class TestSingleFlight:
    def test_concurrent_calls_collapse(self):
        def script(s):
            flight = s.resilience.SingleFlight()
            calls = {"n": 0}
            gate = threading.Event()
            results = []

            def slow():
                calls["n"] += 1
                gate.wait(5)
                return "value"

            def worker():
                results.append(flight.do("k", slow))

            threads = [threading.Thread(target=worker) for _ in range(5)]
            for t in threads:
                t.start()
            while calls["n"] == 0:
                pass
            gate.set()
            for t in threads:
                t.join(5)
            assert results == ["value"] * 5
            assert calls["n"] == 1
            return results
        same(script)

    def test_failure_propagates_to_followers(self):
        def script(s):
            flight = s.resilience.SingleFlight()

            def boom():
                raise ConnectionError("down")

            with pytest.raises(ConnectionError):
                flight.do("k", boom)
            # A later call re-runs (not a cached failure).
            assert flight.do("k", lambda: 7) == 7
            return 7
        same(script)


class _FlakyFactory:
    """Wraps the local factory; storage get_summary fails N times."""

    def __init__(self, inner, failures):
        self.inner = inner
        self.failures = failures

    def create_document_service(self, document_id):
        outer = self

        class Svc:
            def __init__(self, inner_svc):
                self.inner_svc = inner_svc

            def connect_to_storage(self):
                real = self.inner_svc.connect_to_storage()

                class Storage:
                    def get_summary(self, version=None):
                        if outer.failures > 0:
                            outer.failures -= 1
                            raise ConnectionError("transient")
                        return real.get_summary(version)

                    def upload_summary(self, *a, **k):
                        return real.upload_summary(*a, **k)

                    def get_versions(self, count=1):
                        return real.get_versions(count)

                return Storage()

            def connect_to_delta_storage(self):
                return self.inner_svc.connect_to_delta_storage()

            def connect_to_delta_stream(self, details=None):
                return self.inner_svc.connect_to_delta_stream(details)

        return Svc(self.inner.create_document_service(document_id))


class TestFullStackResilience:
    def test_load_through_flaky_service(self):
        def script(s):
            server = s.local_server.LocalServer()
            R = s.resilience
            loader = s.Loader(R.RetryingDocumentServiceFactory(
                _FlakyFactory(s.local_driver.LocalDocumentServiceFactory(
                    server), failures=0), R.RetryPolicy(sleep=lambda _: None)))
            c1 = loader.create_detached("doc")
            ds = c1.runtime.create_datastore("default")
            c1.attach()
            ds.create_channel("root", s.map.SharedMap.TYPE).set("k", 1)
            flaky = _FlakyFactory(s.local_driver.LocalDocumentServiceFactory(
                server), failures=3)
            c2 = s.Loader(R.RetryingDocumentServiceFactory(
                flaky, R.RetryPolicy(sleep=lambda _: None))).resolve("doc")
            assert c2.runtime.get_datastore("default") \
                .get_channel("root").get("k") == 1
            assert flaky.failures == 0  # all failures consumed by retries
            return flaky.failures
        same(script)

    def test_prefetch_warms_cache(self, tmp_path):
        def script(s):
            server = s.local_server.LocalServer()
            cache = s.caching.PersistentCache(str(tmp_path / s.name))
            stack_ = s.resilience.RetryingDocumentServiceFactory(
                caching(s, server, cache),
                s.resilience.RetryPolicy(sleep=lambda _: None))
            c1 = s.Loader(stack_).create_detached("doc")
            ds = c1.runtime.create_datastore("default")
            c1.attach()
            ds.create_channel("root", s.map.SharedMap.TYPE).set("k", "v")
            assert stack_.prefetch_snapshot("doc") is True
            hits_before = cache.hits
            c2 = s.Loader(stack_).resolve("doc")
            assert c2.runtime.get_datastore("default") \
                .get_channel("root").get("k") == "v"
            assert cache.hits > hits_before  # served from the warm cache
            return [cache.hits - hits_before]
        same(script)


class TestServerIssuedThrottling:
    """The admission controller issues the throttle (429/503 nacks with a
    server-computed retry_after) and the driver/container stack honors
    it."""

    def test_container_honors_degrade_retry_after_end_to_end(self,
                                                              monkeypatch):
        def script(s):
            A, MT = s.admission, s.messages.MessageType
            server = s.local_server.LocalServer()
            assert server.admission is not None
            server.admission.recover_after_s = 0.02  # fast retry_after
            loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server))
            c1 = loader.create_detached("doc")
            ds = c1.runtime.create_datastore("default")
            c1.attach()
            root = ds.create_channel("root", s.map.SharedMap.TYPE)
            root.set("k", 1)
            obs = server.connect("doc", {"mode": "read"})
            sequenced, landed_k = [], threading.Event()

            def on_op(m):
                if m.type == MT.OPERATION:
                    sequenced.append(m)
                    if "k" in str(m.contents):
                        landed_k.set()

            obs.on("op", on_op)
            # The recovery thread's backoff: recorded, and held until the
            # test releases it (no wall-clock wait).
            sleeps, release = [], threading.Event()

            def held_sleep(seconds):
                sleeps.append(seconds)
                release.wait(10)

            monkeypatch.setattr(time, "sleep", held_sleep)
            rejected0 = s.counters.snapshot().get(
                "admission.rejected.degrade", 0)
            server.admission.force_state(A.DEGRADE)
            try:
                root.set("k", 2)  # nacked 503: the recovery thread takes over
                assert s.counters.snapshot()[
                    "admission.rejected.degrade"] > rejected0
                assert sequenced == []  # the edit did NOT land degraded
                assert not landed_k.is_set()
            finally:
                server.admission.force_state(A.ACCEPT)
                release.set()
            assert landed_k.wait(10)
            landed = [m for m in sequenced if "k" in str(m.contents)]
            assert len(landed) == 1
            c2 = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server)).resolve("doc")
            assert c2.runtime.get_datastore("default") \
                .get_channel("root").get("k") == 2
            c1.close()
            c2.close()
            monkeypatch.undo()
            return [len(landed), len(sleeps) >= 1,
                    all(0 < x <= 5.0 for x in sleeps)]
        same(script)

    def test_retry_policy_honors_admission_retry_after_exactly(self):
        def script(s):
            ctl = s.admission.AdmissionController(queue_limit=10,
                                                  recover_after_s=0.3)
            ctl.force_state(s.admission.DEGRADE)
            decision = ctl.admit("t")
            assert not decision.admitted and decision.retry_after_s > 0
            sleeps = []
            attempts = {"n": 0}

            def op():
                attempts["n"] += 1
                if attempts["n"] <= 2:
                    raise s.resilience.ThrottlingError(
                        decision.retry_after_s)
                return "ok"

            policy = s.resilience.RetryPolicy(max_attempts=5,
                                              sleep=sleeps.append)
            assert policy.run(op) == "ok"
            assert sleeps == [decision.retry_after_s] * 2
            return sleeps
        same(script)

    def test_single_flight_dedups_fetches_under_throttle(self):
        def script(s):
            release = threading.Event()
            state = {"calls": 0, "throttles": 2}

            class ThrottledStorage:
                def get_summary(self, version=None):
                    state["calls"] += 1
                    release.wait(timeout=5)
                    if state["throttles"]:
                        state["throttles"] -= 1
                        raise s.resilience.ThrottlingError(0.0)
                    return "SUMMARY"

            svc = s.resilience.RetryingStorageService(
                ThrottledStorage(),
                s.resilience.RetryPolicy(sleep=lambda _: None),
                s.resilience.SingleFlight(), "doc")
            results = []
            threads = [threading.Thread(
                target=lambda: results.append(svc.get_summary()))
                for _ in range(2)]
            threads[0].start()
            while state["calls"] == 0:
                pass  # the leader is in flight
            threads[1].start()
            release.set()
            for t in threads:
                t.join(timeout=5)
            assert results == ["SUMMARY", "SUMMARY"]
            # 2 throttled attempts + 1 success from the ONE leader.
            assert state["calls"] == 3
            return state
        same(script)
