"""The wire and the durable state across the two packages.

The websocket and REST wire is JSON and the RFC 6455 framing is the
reference's, so a client of either package works against a server of
either: a JAX routerlicious client on the port's Tinylicious and the
port's on the JAX one reach the texts a same-package session reaches, and
a scripted raw session receives byte-equal frames from both servers when
the client ids and the message clock are pinned. The sqlite rows and the
file git store are JSON as well: what one package's durable services wrote
(deltas, checkpoints including the device sequencer's dump, summaries)
reopens in the other with equal rows and summary trees, and the other
package's TpuLocalServer restarts from it. The broker's frames are
pickled with the package's classes and stay out of this.

Every wait on a socket has a deadline.
"""

import importlib
import json
import socket
import time

import pytest
import torch

from fluidframework_tpu_torch.testing.server_runs import (_CommitClock,
                                                          _SeededUuid)

torch.set_num_threads(1)

JAX, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
PACKAGES = (JAX, PORT)


def mod(package: str, path: str):
    return importlib.import_module(f"{package}.{path}")


def device_kwargs(package: str) -> dict:
    return {"device": "cpu"} if package == PORT else {}


def wait_until(predicate, timeout=10.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# --- the framing -----------------------------------------------------------

class _Capture:
    """A socket that records what is sent and replays it on recv."""

    def __init__(self, data: bytes = b""):
        self.sent = b""
        self.data = data

    def sendall(self, b: bytes) -> None:
        self.sent += b

    def recv(self, n: int) -> bytes:
        out, self.data = self.data[:n], self.data[n:]
        return out


@pytest.mark.parametrize("size", [0, 1, 125, 126, 65535, 65536, 70000])
@pytest.mark.parametrize("mask", [False, True])
def test_frames_byte_equal_and_read_across(size, mask, monkeypatch):
    """write_frame gives the same bytes in both packages (the masking key
    pinned), and each package's read_frame reads the other's frames."""
    import os
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(1, n + 1)))
    payload = bytes((i * 7 + 3) % 256 for i in range(size))
    sent = {}
    for package in PACKAGES:
        ws = mod(package, "server.websocket")
        cap = _Capture()
        ws.write_frame(cap, 0x1, payload, mask)
        sent[package] = cap.sent
    assert sent[PORT] == sent[JAX]
    for reader, writer in ((JAX, PORT), (PORT, JAX)):
        ws = mod(reader, "server.websocket")
        opcode, got = ws.read_frame(_Capture(sent[writer]))
        assert (opcode, got) == (0x1 | 0x10, payload)
    assert mod(PORT, "server.websocket").accept_key("dGhlIHNhbXBsZQ==") == \
        mod(JAX, "server.websocket").accept_key("dGhlIHNhbXBsZQ==")


def test_tokens_verify_across_packages():
    for signer, verifier in ((JAX, PORT), (PORT, JAX)):
        token = mod(signer, "server.auth").generate_token(
            "k", "tenant", "doc", lifetime_s=600)
        claims = mod(verifier, "server.auth").verify_token("k", token)
        assert (claims["tenantId"], claims["documentId"]) == \
            ("tenant", "doc")


# --- sessions over the sockets ---------------------------------------------

def network_session(client: str, server: str) -> dict:
    """Two clients of package `client` edit one SharedString through
    package `server`'s Tinylicious; returns what they converge to."""
    loader_mod = mod(client, "loader.container")
    net = mod(client, "loader.drivers.routerlicious")
    SharedString = mod(client, "dds.sequence").SharedString
    tiny = mod(server, "server.tinylicious")
    with tiny.Tinylicious() as t:
        loader = loader_mod.Loader(
            net.NetworkDocumentServiceFactory(t.url, tiny.DEFAULT_TENANT),
            **device_kwargs(client))
        c1 = loader.create_detached("cross")
        text = c1.runtime.create_datastore("default").create_channel(
            "text", SharedString.TYPE)
        with c1.op_lock:
            text.insert_text(0, "hello")
        c1.attach()
        c2 = loader.resolve("cross")
        t2 = c2.runtime.get_datastore("default").get_channel("text")
        assert wait_until(lambda: t2.get_text() == "hello")
        for i in range(20):
            with c1.op_lock:
                text.insert_text(text.get_length(), f" a{i}")
            with c2.op_lock:
                t2.insert_text(0, f"b{i} ")
        assert wait_until(lambda: text.get_text() == t2.get_text()
                          and c1.delta_manager.last_sequence_number
                          == c2.delta_manager.last_sequence_number, 20.0)
        rest = net.RestWrapper(t.url)
        rows = rest.get(f"/deltas/{tiny.DEFAULT_TENANT}/cross")["deltas"]
        out = {"text": text.get_text(), "rows": len(rows),
               "ops": sum(1 for r in rows if r["type"] == "op")}
        c1.close()
        c2.close()
    return out


@pytest.mark.parametrize("client,server", [(JAX, PORT), (PORT, JAX)])
def test_client_of_one_package_on_the_others_server(client, server):
    """Across the packages the session converges; its text and its
    sequenced ops have the same shape as a same-package session's (the
    interleaving of the two writers depends on the sockets, the text's
    multiset of words does not)."""
    cross = network_session(client, server)
    same = network_session(server, server)
    assert cross["ops"] == same["ops"] == 40  # 20 a writer
    assert sorted(cross["text"].split()) == sorted(same["text"].split())


def raw_session(package: str) -> list:
    """A scripted session on package's Tinylicious over raw websockets:
    the client ids and the message clock pinned; returns every frame the
    client received, as text."""
    from fluidframework_tpu_torch.protocol.messages import DocumentMessage
    from fluidframework_tpu_torch.server.websocket import connect
    from fluidframework_tpu_torch.server.wire import document_message_to_dict
    ls, msgs = mod(package, "server.local_server"), mod(
        package, "protocol.messages")
    tiny = mod(package, "server.tinylicious")
    saved = ls.uuid, msgs.time
    ls.uuid, msgs.time = _SeededUuid(5), _CommitClock()
    frames = []
    try:
        with tiny.Tinylicious() as t:
            conn = connect("127.0.0.1", t.port, "/socket")
            conn.sock.settimeout(10.0)
            conn.send_text(json.dumps({
                "type": "connect_document", "tenantId": tiny.DEFAULT_TENANT,
                "documentId": "raw", "token": None, "client": {}}))
            frames.append(conn.recv())
            client_id = json.loads(frames[0])["clientId"]
            for i in range(1, 4):
                conn.send_text(json.dumps({
                    "type": "submitOp", "messages": [
                        document_message_to_dict(DocumentMessage(
                            client_sequence_number=i,
                            reference_sequence_number=1, type="op",
                            contents={"n": i}))]}))
            conn.send_text(json.dumps({"type": "submitSignal",
                                       "content": {"hi": client_id}}))
            while len(frames) < 5:  # 3 ops and the signal
                frames.append(conn.recv())
            conn.send_text(json.dumps({"type": "disconnect"}))
            conn.close()
    finally:
        ls.uuid, msgs.time = saved
    return frames


def test_raw_session_frames_byte_equal():
    got = {package: raw_session(package) for package in PACKAGES}
    assert got[PORT] == got[JAX]
    kinds = [json.loads(f)["type"] for f in got[PORT]]
    assert kinds == ["connected", "op", "op", "op", "signal"]


def test_rest_bodies_byte_equal():
    """The REST routes answer with the same bytes (ids pinned)."""
    import urllib.request

    bodies = {}
    for package in PACKAGES:
        tiny = mod(package, "server.tinylicious")
        out = []
        with tiny.Tinylicious() as t:
            for method, path, body in (
                    ("GET", "/api/v1/ping", None),
                    ("POST", f"/documents/{tiny.DEFAULT_TENANT}",
                     {"id": "d1"}),
                    ("GET", f"/documents/{tiny.DEFAULT_TENANT}/d1", None),
                    ("GET", f"/deltas/{tiny.DEFAULT_TENANT}/d1", None),
                    ("GET", "/no/such/route", None)):
                req = urllib.request.Request(
                    t.url + path, method=method,
                    data=None if body is None else json.dumps(body).encode())
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        out.append((r.status, r.read()))
                except urllib.error.HTTPError as err:
                    out.append((err.code, err.read()))
        bodies[package] = out
    assert bodies[PORT] == bodies[JAX]


# --- the durable state -----------------------------------------------------

def durable_session(package: str, root) -> dict:
    """A TpuLocalServer of `package` over sqlite and a file git store
    under `root`: a document with text, a summary acked by the scribe,
    more ops after it. Returns the text."""
    dds = mod(package, "dds.sequence")
    durable = mod(package, "server.durable")
    ls = mod(package, "server.local_server")
    loader_mod = mod(package, "loader.container")
    local = mod(package, "loader.drivers.local")
    db = durable.SqliteDatabaseManager(str(root / "db.sqlite"))
    hist = durable.FileHistorian(str(root / "git"))
    server = ls.TpuLocalServer(db=db, historian=hist,
                               **device_kwargs(package))
    loader = loader_mod.Loader(local.LocalDocumentServiceFactory(server),
                               **device_kwargs(package))
    c1 = loader.create_detached("doc")
    text = c1.runtime.create_datastore("default").create_channel(
        "text", dds.SharedString.TYPE)
    text.insert_text(0, "pre-attach base ")
    c1.attach()
    text.insert_text(text.get_length(), "first tail")
    acks = []
    with c1.op_lock:
        c1.summarize(lambda handle, ack, contents: acks.append(ack))
    server.pump()
    assert acks == [True]
    text.insert_text(0, "after summary: ")
    server.pump()
    out = text.get_text()
    c1.close()
    db.close()
    return out


COLLECTIONS = ("deltas", "rawdeltas", "deliCheckpoints",
               "scribeCheckpoints")


def durable_state(package: str, root) -> dict:
    """Every row of the four collections and the document's latest
    summary tree (dict form), read through `package`."""
    durable = mod(package, "server.durable")
    summary = mod(package, "protocol.summary")
    db = durable.SqliteDatabaseManager(str(root / "db.sqlite"))
    rows = {name: db.collection(name).find(lambda d: True)
            for name in COLLECTIONS}
    db.close()
    hist = durable.FileHistorian(str(root / "git"))
    tree = hist.read_summary("local", "doc")
    return {"rows": rows, "summary": summary.summary_tree_to_dict(tree)}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_durable_state_reopens_in_the_other_package(writer, reader,
                                                    tmp_path):
    """Rows and summary trees written by one package read back equal in
    the other, every row is plain JSON (no default=str text), the device
    sequencer's dump is among the checkpoints, and the other package's
    TpuLocalServer restarts from the state and serves the same text."""
    text = durable_session(writer, tmp_path)
    written = durable_state(writer, tmp_path)
    read = durable_state(reader, tmp_path)
    assert read == written
    for name, rows in written["rows"].items():
        for row in rows:
            assert json.loads(json.dumps(row)) == row
    assert any(r.get("kind") == "tpu-sequencer"
               for r in written["rows"]["deliCheckpoints"])
    assert written["rows"]["deltas"] and written["summary"]["entries"]

    durable = mod(reader, "server.durable")
    ls = mod(reader, "server.local_server")
    loader_mod = mod(reader, "loader.container")
    local = mod(reader, "loader.drivers.local")
    db = durable.SqliteDatabaseManager(str(tmp_path / "db.sqlite"))
    server = ls.TpuLocalServer(
        db=db, historian=durable.FileHistorian(str(tmp_path / "git")),
        **device_kwargs(reader))
    c2 = loader_mod.Loader(local.LocalDocumentServiceFactory(server),
                           **device_kwargs(reader)).resolve("doc")
    t2 = c2.runtime.get_datastore("default").get_channel("text")
    assert t2.get_text() == text
    assert server.sequencer_for("doc").channel_text(
        "doc", "default", "text") == text
    t2.insert_text(0, ">> ")
    server.pump()
    assert t2.get_text() == ">> " + text
    c2.close()
    db.close()


def test_no_listener_left(tmp_path):
    """The sessions above close every server they start: a fresh socket
    binds to the ports they used (a smoke check of the fixtures)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.close()
