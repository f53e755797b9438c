"""Network-stack tests: JWT/tenant auth (riddler), websocket framing,
alfred REST routes, and full two-client E2E over real sockets through the
network driver (reference routerlicious-driver against tinylicious).

A mirror of tests/test_network.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

import functools
import json
import time

import pytest

from fluidframework_tpu_torch.dds.counter import SharedCounter
from fluidframework_tpu_torch.dds.map import SharedMap
from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as _container
from fluidframework_tpu_torch.loader.drivers.routerlicious import (
    NetworkDocumentServiceFactory,
    RestError,
    RestWrapper,
)
from fluidframework_tpu_torch.server.auth import (
    AuthError,
    TenantManager,
    generate_token,
    sign_token,
    verify_token,
)
from fluidframework_tpu_torch.server.tinylicious import (
    DEFAULT_TENANT,
    Tinylicious,
)


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


class TestAuth:
    def test_token_roundtrip(self):
        token = generate_token("secret", "t1", "doc1")
        claims = verify_token("secret", token)
        assert claims["tenantId"] == "t1"
        assert claims["documentId"] == "doc1"
        assert "doc:write" in claims["scopes"]

    def test_bad_signature_rejected(self):
        token = generate_token("secret", "t1", "doc1")
        with pytest.raises(AuthError):
            verify_token("wrong", token)

    def test_expired_rejected(self):
        token = generate_token("secret", "t1", "doc1", lifetime_s=-10)
        with pytest.raises(AuthError):
            verify_token("secret", token)

    def test_tampered_claims_rejected(self):
        token = generate_token("secret", "t1", "doc1")
        header, claims, sig = token.split(".")
        with pytest.raises(AuthError):
            verify_token("secret", header + "." + claims[:-2] + "xx." + sig)

    def test_tenant_manager_scoping(self):
        tm = TenantManager()
        t = tm.create_tenant("acme")
        token = generate_token(t.key, "acme", "docA", scopes=["doc:read"])
        claims = tm.validate_token("acme", token, "docA", "doc:read")
        assert claims["user"]["id"] == "anonymous"
        with pytest.raises(AuthError):
            tm.validate_token("acme", token, "docB")  # wrong doc
        with pytest.raises(AuthError):
            tm.validate_token("acme", token, "docA", "doc:write")  # scope
        with pytest.raises(AuthError):
            tm.validate_token("nope", token)  # unknown tenant

    def test_non_jwt_garbage(self):
        with pytest.raises(AuthError):
            verify_token("k", "not-a-token")
        with pytest.raises(AuthError):
            verify_token("k", "")

    def test_sign_token_arbitrary_claims(self):
        tok = sign_token("k", {"tenantId": "x", "custom": [1, 2]})
        assert verify_token("k", tok)["custom"] == [1, 2]


@pytest.fixture(scope="module")
def server():
    with Tinylicious() as t:
        yield t


@pytest.fixture(scope="module")
def authed_server():
    with Tinylicious(require_auth=True) as t:
        yield t


class TestRest:
    def test_ping(self, server):
        rest = RestWrapper(server.url)
        assert rest.get("/api/v1/ping")["ok"] is True

    def test_404_route(self, server):
        rest = RestWrapper(server.url)
        with pytest.raises(RestError) as exc:
            rest.get("/definitely/not/a/route")
        assert exc.value.status == 404

    def test_create_document(self, server):
        rest = RestWrapper(server.url)
        out = rest.post(f"/documents/{DEFAULT_TENANT}", {"id": "mydoc"})
        assert out["id"] == "mydoc"
        out2 = rest.post(f"/documents/{DEFAULT_TENANT}", {})
        assert out2["id"].startswith("doc-")

    def test_get_document_metadata(self, server):
        rest = RestWrapper(server.url)
        rest.post(f"/documents/{DEFAULT_TENANT}", {"id": "metadoc"})
        with pytest.raises(RestError) as exc:
            rest.get(f"/documents/{DEFAULT_TENANT}/never-created")
        assert exc.value.status == 404
        # A document with live history reports its sequence number + head.
        loader, c1, ds1 = make_network_doc(server, "metadoc2")
        ds1.create_channel("n", SharedCounter.TYPE).increment(1)
        c1.attach()
        assert wait_until(lambda: rest.get(
            f"/documents/{DEFAULT_TENANT}/metadoc2")["sequenceNumber"] > 0)
        out = rest.get(f"/documents/{DEFAULT_TENANT}/metadoc2")
        assert out["id"] == "metadoc2"
        assert out["headSummary"]
        c1.close()

    def test_raw_deltas_route(self, server):
        rest = RestWrapper(server.url)
        loader, c1, ds1 = make_network_doc(server, "rawdoc")
        ds1.create_channel("n", SharedCounter.TYPE).increment(2)
        c1.attach()
        assert wait_until(lambda: len(rest.get(
            f"/deltas/raw/{DEFAULT_TENANT}/rawdoc")["rawDeltas"]) > 0)
        out = rest.get(f"/deltas/raw/{DEFAULT_TENANT}/rawdoc")
        c1.close()
        assert len(out["rawDeltas"]) > 0
        assert all(r["documentId"] == "rawdoc" for r in out["rawDeltas"])

    def test_blob_upload(self, server):
        import base64
        rest = RestWrapper(server.url)
        rest.post(f"/documents/{DEFAULT_TENANT}", {"id": "blobdoc"})
        payload = base64.b64encode(b"attachment-bytes").decode()
        out = rest.post(f"/api/{DEFAULT_TENANT}/blobdoc/blobs",
                        {"content": payload})
        assert out["size"] == len(b"attachment-bytes")
        # Content-addressed: same bytes, same sha.
        again = rest.post(f"/api/{DEFAULT_TENANT}/blobdoc/blobs",
                          {"content": payload})
        assert again["sha"] == out["sha"]
        with pytest.raises(RestError) as exc:
            rest.post(f"/api/{DEFAULT_TENANT}/blobdoc/blobs",
                      {"content": "!!!not-base64!!!"})
        assert exc.value.status == 400

    def test_tenant_routes(self, server):
        rest = RestWrapper(server.url)
        created = rest.post("/tenants/newco", {"key": "sekrit"})
        assert created == {"id": "newco", "key": "sekrit"}
        assert rest.get("/tenants/newco/key")["key"] == "sekrit"
        token = generate_token("sekrit", "newco", "d")
        claims = rest.post("/tenants/newco/validate", {"token": token})
        assert claims["claims"]["tenantId"] == "newco"
        with pytest.raises(RestError) as exc:
            rest.post("/tenants/newco", {})  # duplicate
        assert exc.value.status == 409

    def test_riddler_routes_admin_gated(self, authed_server):
        import urllib.request

        rest = RestWrapper(authed_server.url)
        with pytest.raises(RestError) as exc:
            rest.get(f"/tenants/{DEFAULT_TENANT}/key")
        assert exc.value.status == 403  # tenant secret not world-readable
        with pytest.raises(RestError) as exc:
            rest.post("/tenants/evilco", {"key": "x"})
        assert exc.value.status == 403
        # With the operator key the same routes work.
        req = urllib.request.Request(
            authed_server.url + f"/tenants/{DEFAULT_TENANT}/key",
            headers={"X-Admin-Key": authed_server.admin_key})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["key"]

    def test_create_doc_requires_doc_scoped_token(self, authed_server):
        from fluidframework_tpu_torch.server.tinylicious import DEFAULT_KEY

        token_a = generate_token(DEFAULT_KEY, DEFAULT_TENANT, "docA")
        rest = RestWrapper(authed_server.url, token_a)
        with pytest.raises(RestError) as exc:
            rest.post(f"/documents/{DEFAULT_TENANT}", {"id": "docB"})
        assert exc.value.status == 403
        assert rest.post(f"/documents/{DEFAULT_TENANT}",
                         {"id": "docA"})["id"] == "docA"
        wildcard = generate_token(DEFAULT_KEY, DEFAULT_TENANT, "*")
        rest_w = RestWrapper(authed_server.url, wildcard)
        assert rest_w.post(f"/documents/{DEFAULT_TENANT}",
                           {"id": "docC"})["id"] == "docC"

    def test_auth_required_rejects_missing_and_bad_tokens(self, authed_server):
        rest = RestWrapper(authed_server.url)  # no token
        with pytest.raises(RestError) as exc:
            rest.get(f"/deltas/{DEFAULT_TENANT}/doc1")
        assert exc.value.status == 401
        bad = RestWrapper(authed_server.url,
                          generate_token("wrongkey", DEFAULT_TENANT, "doc1"))
        with pytest.raises(RestError) as exc:
            bad.get(f"/deltas/{DEFAULT_TENANT}/doc1")
        assert exc.value.status == 403


def make_network_doc(server, doc_id, tenant=DEFAULT_TENANT,
                     token_provider=None):
    factory = NetworkDocumentServiceFactory(server.url, tenant,
                                            token_provider)
    loader = Loader(factory)
    container = loader.create_detached(doc_id)
    ds = container.runtime.create_datastore("default")
    return loader, container, ds


class TestNetworkE2E:
    def test_two_clients_converge_over_sockets(self, server):
        loader, c1, ds1 = make_network_doc(server, "net-conv")
        text = ds1.create_channel("text", SharedString.TYPE)
        with c1.op_lock:
            text.insert_text(0, "hello")
        c1.attach()
        assert c1.connected

        c2 = loader.resolve("net-conv")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert t2.get_text() == "hello"

        with c2.op_lock:
            t2.insert_text(5, " world")
        with c1.op_lock:
            text.insert_text(0, ">> ")
        assert wait_until(
            lambda: text.get_text() == t2.get_text() == ">> hello world")
        c1.close()
        c2.close()

    def test_counter_three_network_clients(self, server):
        loader, c1, ds1 = make_network_doc(server, "net-counter")
        ds1.create_channel("clicks", SharedCounter.TYPE)
        c1.attach()
        c2 = loader.resolve("net-counter")
        c3 = loader.resolve("net-counter")
        containers = (c1, c2, c3)
        counters = [c.runtime.get_datastore("default").get_channel("clicks")
                    for c in containers]
        for i, (c, counter) in enumerate(zip(containers, counters)):
            with c.op_lock:
                counter.increment(i + 1)
        assert wait_until(lambda: [c.value for c in counters] == [6, 6, 6])
        for c in containers:
            c.close()

    def test_summary_rides_rest_storage(self, server):
        loader, c1, ds1 = make_network_doc(server, "net-summary")
        m = ds1.create_channel("root", SharedMap.TYPE)
        c1.attach()
        with c1.op_lock:
            m.set("k", "v")
        results = []
        with c1.op_lock:
            c1.summarize(lambda handle, ack, contents:
                         results.append((handle, ack)))
        assert wait_until(lambda: bool(results))
        assert results[0][1] is True

        # A late-joining client loads the summary over REST.
        c2 = loader.resolve("net-summary")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        assert m2.get("k") == "v"
        c1.close()
        c2.close()

    def test_authed_e2e_with_token_provider(self, authed_server):
        provider = authed_server.token_provider()
        loader, c1, ds1 = make_network_doc(
            authed_server, "authed-doc", token_provider=provider)
        text = ds1.create_channel("t", SharedString.TYPE)
        with c1.op_lock:
            text.insert_text(0, "secured")
        c1.attach()
        c2 = loader.resolve("authed-doc")
        t2 = c2.runtime.get_datastore("default").get_channel("t")
        assert t2.get_text() == "secured"
        c1.close()
        c2.close()

    def test_ws_connect_rejected_without_token(self, authed_server):
        factory = NetworkDocumentServiceFactory(
            authed_server.url, DEFAULT_TENANT, token_provider=None)
        service = factory.create_document_service("rejected-doc")
        with pytest.raises(ConnectionError):
            service.connect_to_delta_stream({})

    def test_network_client_reconnect(self, server):
        loader, c1, ds1 = make_network_doc(server, "net-reconn")
        counter = ds1.create_channel("n", SharedCounter.TYPE)
        c1.attach()
        old_id = c1.delta_manager.client_id
        c1.reconnect()
        assert c1.delta_manager.client_id != old_id
        with c1.op_lock:
            counter.increment(5)
        c2 = loader.resolve("net-reconn")
        n2 = c2.runtime.get_datastore("default").get_channel("n")
        assert wait_until(lambda: n2.value == 5)
        c1.close()
        c2.close()


class TestWebSocketFraming:
    def test_large_and_unicode_messages(self, server):
        """>64KiB payload exercises the 64-bit length path; unicode
        exercises utf-8 framing."""
        from fluidframework_tpu_torch.server import websocket as ws

        conn = ws.connect(server.service.host, server.service.port,
                          "/socket")
        big = "x" * 70000
        conn.send_text(json.dumps({
            "type": "connect_document", "tenantId": DEFAULT_TENANT,
            "documentId": "frame-doc", "token": None,
            "client": {"pad": big, "emoji": "☃️"}}))
        hello = json.loads(conn.recv())
        assert hello["type"] == "connected"
        conn.close()
