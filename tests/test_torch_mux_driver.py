"""Multiplexed network driver: join-session discovery + one shared
websocket per endpoint across documents (the odsp-driver connection
management analog, loader/drivers/mux.py + alfred /socket-mux).

A mirror of tests/test_mux_driver.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

import functools
import time

import pytest

from fluidframework_tpu_torch.dds.counter import SharedCounter
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as _container
from fluidframework_tpu_torch.loader.drivers.routerlicious import (
    NetworkDocumentServiceFactory)
from fluidframework_tpu_torch.server.tinylicious import DEFAULT_TENANT, Tinylicious


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


@pytest.fixture(scope="module")
def server():
    with Tinylicious() as t:
        yield t


def make_doc(factory, doc_id):
    loader = Loader(factory)
    c = loader.create_detached(doc_id)
    ds = c.runtime.create_datastore("default")
    return loader, c, ds


class TestJoinSession:
    def test_session_discovery_route(self, server):
        from fluidframework_tpu_torch.loader.drivers.routerlicious import (
            RestWrapper)
        info = RestWrapper(server.url).get(
            f"/api/v1/session/{DEFAULT_TENANT}/any-doc")
        assert info["socketPath"] == "/socket-mux"
        assert info["sessionExpiryMs"] > 0

    def test_discovery_cached_until_expiry(self, server):
        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT,
                                                multiplex=True)
        calls = []
        real_fetch = factory.session_cache._fetch
        factory.session_cache._fetch = \
            lambda t, d: calls.append((t, d)) or real_fetch(t, d)
        factory.session_cache.get(DEFAULT_TENANT, "doc-x")
        factory.session_cache.get(DEFAULT_TENANT, "doc-x")
        assert len(calls) == 1  # second hit served from cache
        factory.session_cache.invalidate(DEFAULT_TENANT, "doc-x")
        factory.session_cache.get(DEFAULT_TENANT, "doc-x")
        assert len(calls) == 2


class TestSocketSharing:
    def test_two_documents_share_one_socket(self, server):
        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT,
                                                multiplex=True)
        loader1, c1, ds1 = make_doc(factory, "mux-a")
        text = ds1.create_channel("text", SharedString.TYPE)
        with c1.op_lock:
            text.insert_text(0, "doc-a")
            c1.attach()
        loader2, c2, ds2 = make_doc(factory, "mux-b")
        clicks = ds2.create_channel("clicks", SharedCounter.TYPE)
        with c2.op_lock:
            clicks.increment(5)
            c2.attach()

        managers = list(factory.mux_pool._managers.values())
        assert len(managers) == 1
        assert managers[0].document_count == 2
        assert managers[0].socket_alive

        # Both documents converge to second clients over the SAME socket.
        c1b = loader1.resolve("mux-a")
        c2b = loader2.resolve("mux-b")
        assert managers[0].document_count == 4
        t1b = c1b.runtime.get_datastore("default").get_channel("text")
        with c1b.op_lock:
            t1b.insert_text(5, "!")
        assert wait_until(lambda: text.get_text() == "doc-a!")
        k2b = c2b.runtime.get_datastore("default").get_channel("clicks")
        with c2b.op_lock:
            k2b.increment(2)
        assert wait_until(lambda: clicks.value == 7)
        for c in (c1, c2, c1b, c2b):
            c.close()

    def test_per_document_disconnect_leaves_others_alive(self, server):
        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT,
                                                multiplex=True)
        loader1, c1, ds1 = make_doc(factory, "mux-c")
        ds1.create_channel("clicks", SharedCounter.TYPE)
        with c1.op_lock:
            c1.attach()
        loader2, c2, ds2 = make_doc(factory, "mux-d")
        ds2.create_channel("clicks", SharedCounter.TYPE)
        with c2.op_lock:
            c2.attach()
        manager = list(factory.mux_pool._managers.values())[0]
        assert manager.document_count == 2

        c1.close()
        assert wait_until(lambda: manager.document_count == 1)
        assert manager.socket_alive  # c2 still rides it

        # c2 keeps working after its sibling detached.
        clicks2 = ds2.get_channel("clicks")
        with c2.op_lock:
            clicks2.increment(3)
        assert clicks2.value == 3
        c2.close()
        # Last rider gone: the physical socket is released.
        assert wait_until(lambda: not manager.socket_alive)

    def test_signals_ride_the_shared_socket(self, server):
        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT,
                                                multiplex=True)
        loader, c1, _ = make_doc(factory, "mux-sig")
        with c1.op_lock:
            c1.attach()
        c2 = loader.resolve("mux-sig")
        got = []
        c2.runtime.on("signal", lambda t, c, local, cid: got.append((t, c)))
        with c1.op_lock:
            c1.submit_signal("hello", {"n": 1})
        assert wait_until(lambda: got == [("hello", {"n": 1})])
        c1.close()
        c2.close()

    def test_dead_socket_disconnects_all_and_reconnect_redials(self, server):
        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT,
                                                multiplex=True)
        loader, c1, ds1 = make_doc(factory, "mux-e")
        clicks = ds1.create_channel("clicks", SharedCounter.TYPE)
        with c1.op_lock:
            clicks.increment(1)
            c1.attach()
        manager = list(factory.mux_pool._managers.values())[0]
        drops = []
        c1.on("disconnected", lambda: drops.append(1))
        # Kill the transport out from under every rider.
        manager._ws.close()
        assert wait_until(lambda: drops)
        # The container auto-reconnect path dials a fresh shared socket.
        c1.reconnect()
        assert wait_until(lambda: c1.connected)
        assert manager.socket_alive
        with c1.op_lock:
            clicks.increment(1)
        c2 = loader.resolve("mux-e")
        k2 = c2.runtime.get_datastore("default").get_channel("clicks")
        assert k2.value == 2
        c1.close()
        c2.close()

    def test_malformed_frame_answers_on_cid_without_killing_socket(
            self, server):
        """One rider's garbage frame must not tear down the shared socket
        (per-document error isolation in alfred's mux handler)."""
        import json as _json

        from fluidframework_tpu_torch.server import websocket as ws_mod

        factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT,
                                                multiplex=True)
        loader, c1, ds1 = make_doc(factory, "mux-iso")
        clicks = ds1.create_channel("clicks", SharedCounter.TYPE)
        with c1.op_lock:
            c1.attach()
        manager = list(factory.mux_pool._managers.values())[0]
        # Speak raw garbage on a second mux socket sharing the endpoint.
        raw = ws_mod.connect(manager.host, manager.port, manager.path)
        raw.send_text(_json.dumps({"type": "submitOp", "cid": 1,
                                   "messages": [{}]}))  # unknown cid
        assert _json.loads(raw.recv())["type"] == "error"
        raw.send_text(_json.dumps(
            {"type": "connect_document", "cid": 1,
             "tenantId": DEFAULT_TENANT, "documentId": "mux-iso",
             "token": None, "client": {}}))
        assert _json.loads(raw.recv())["type"] == "connected"
        raw.send_text(_json.dumps({"type": "submitOp", "cid": 1,
                                   "messages": [{}]}))  # malformed message
        frame = _json.loads(raw.recv())
        assert frame["type"] == "error" and frame["cid"] == 1
        # The same socket still works after the error...
        raw.send_text(_json.dumps({"type": "disconnect_document", "cid": 1}))
        # ...and the good client's socket was never involved.
        assert manager.socket_alive
        with c1.op_lock:
            clicks.increment(1)
        assert clicks.value == 1
        raw.close()
        c1.close()

    def test_bad_token_fails_that_document_only(self):
        with Tinylicious(require_auth=True) as server:
            good = server.token_provider()
            factory = NetworkDocumentServiceFactory(
                server.url, DEFAULT_TENANT, good, multiplex=True)
            loader, c1, ds1 = make_doc(factory, "mux-auth")
            ds1.create_channel("clicks", SharedCounter.TYPE)
            with c1.op_lock:
                c1.attach()
            manager = list(factory.mux_pool._managers.values())[0]

            bad_factory = NetworkDocumentServiceFactory(
                server.url, DEFAULT_TENANT,
                lambda t, d: "garbage-token", multiplex=True)
            # The bad client's join-session REST call itself is rejected.
            with pytest.raises(Exception):
                Loader(bad_factory).resolve("mux-auth")
            # The good client's shared socket is unaffected.
            assert manager.socket_alive
            clicks = ds1.get_channel("clicks")
            with c1.op_lock:
                clicks.increment(1)
            assert clicks.value == 1
            c1.close()


class TestFailedConnectReleasesSocket:
    def test_last_rider_connect_failure_closes_socket(self, server,
                                                      monkeypatch):
        """A failed connect_document that was the socket's ONLY rider must
        release the physical socket and reader thread (the same refcount-
        zero path detach takes) — not leak them for the process lifetime."""
        from urllib.parse import urlparse
        from fluidframework_tpu_torch.loader.drivers import mux as mux_mod
        u = urlparse(server.url)
        mgr = mux_mod.MuxSocketManager(u.hostname, u.port)
        monkeypatch.setattr(
            mux_mod.Deferred, "result",
            lambda self, timeout=None: (_ for _ in ()).throw(
                TimeoutError("forced handshake failure")))
        with pytest.raises(TimeoutError):
            mgr.connect_document(DEFAULT_TENANT, "leak-doc", None, {},
                                 timeout=1.0)
        monkeypatch.undo()
        assert mgr.document_count == 0
        assert not mgr._handshakes
        assert not mgr.socket_alive, "failed last-rider connect leaked ws"
        # The manager recovers: a later connect dials a fresh socket.
        conn = mgr.connect_document(DEFAULT_TENANT, "leak-doc", None, {})
        assert mgr.socket_alive and conn.client_id
        conn.close()
