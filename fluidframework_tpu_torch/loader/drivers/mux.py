"""Multiplexed network driver: many documents over one physical websocket,
discovered via the join-session flow.

Capability parity with the reference odsp-driver's production connection
management (packages/drivers/odsp-driver/src, 6,713 LoC): (a) joinSession —
a REST call discovers the socket endpoint for a document before connecting,
with the discovery cached until its expiry; (b) socket references — one
physical socket per endpoint shared by every document connected through
it, refcounted, torn down when the last document disconnects or the socket
dies. The wire protocol is alfred's `/socket-mux` frame set (legacy frames
plus a client-chosen connection id `cid`).

A port of fluidframework_tpu's loader/drivers/mux.py.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ...core.events import Deferred, TypedEventEmitter
from ...protocol.messages import DocumentMessage, SignalMessage
from ...server import websocket
from ...server.wire import (
    document_message_to_dict,
    nack_from_dict,
    sequenced_message_from_dict,
)
from .base import IDocumentDeltaConnection


class JoinSessionCache:
    """Caches session discoveries per (tenant, document) until expiry
    (odsp joinSession + its cached ISocketStorageDiscovery)."""

    def __init__(self, fetch: Callable[[str, str], dict]):
        self._fetch = fetch
        self._cache: Dict[Tuple[str, str], Tuple[float, dict]] = {}
        self._lock = threading.Lock()

    def get(self, tenant_id: str, document_id: str) -> dict:
        key = (tenant_id, document_id)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0] > now:
                return hit[1]
        discovery = self._fetch(tenant_id, document_id)
        expiry = now + discovery.get("sessionExpiryMs", 600_000) / 1000.0
        with self._lock:
            self._cache[key] = (expiry, discovery)
        return discovery

    def invalidate(self, tenant_id: str, document_id: str) -> None:
        with self._lock:
            self._cache.pop((tenant_id, document_id), None)


class MuxDeltaConnection(TypedEventEmitter, IDocumentDeltaConnection):
    """One document's delta connection riding a shared socket. Same event
    surface as every other driver connection; close() detaches only this
    document (the socket lives while other documents ride it)."""

    def __init__(self, manager: "MuxSocketManager", cid: int,
                 client_id: str, checkpoint_sequence_number: int):
        TypedEventEmitter.__init__(self)
        self._manager = manager
        self._cid = cid
        self.client_id = client_id
        self.checkpoint_sequence_number = checkpoint_sequence_number
        self._closed = False
        self._sock = None  # the physical socket this connection rides

    def submit(self, messages: List[DocumentMessage]) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        self._manager.send({
            "type": "submitOp", "cid": self._cid,
            "messages": [document_message_to_dict(m) for m in messages]})

    def submit_signal(self, content) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        self._manager.send({"type": "submitSignal", "cid": self._cid,
                            "content": content})

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._manager.detach(self._cid)

    # called by the manager's reader thread
    def _dispatch(self, frame: dict) -> None:
        ftype = frame.get("type")
        if ftype == "op":
            self.emit("op", sequenced_message_from_dict(frame["message"]))
        elif ftype == "nack":
            self.emit("nack", nack_from_dict(frame["nack"]))
        elif ftype == "signal":
            self.emit("signal", SignalMessage(
                client_id=frame.get("clientId"),
                content=frame.get("content")))
        elif ftype == "error":
            # Server-side per-document error (alfred's cid isolation):
            # surface it to whoever listens; an unobserved error frame is
            # at least observable, not silently identical to a dropped op.
            self.emit("error", frame.get("error"))

    def _on_socket_dead(self) -> None:
        if not self._closed:
            self._closed = True
            self.emit("disconnect")


class MuxSocketManager:
    """One physical websocket to one `/socket-mux` endpoint, shared by all
    documents connected through it (the odsp socket-reference). Dead socket
    => every riding connection gets "disconnect"; the next connect_document
    dials a fresh socket."""

    def __init__(self, host: str, port: int, path: str = "/socket-mux"):
        self.host, self.port, self.path = host, port, path
        self._ws: Optional[websocket.WebSocketConnection] = None
        self._reader: Optional[threading.Thread] = None
        self._conns: Dict[int, MuxDeltaConnection] = {}
        self._handshakes: Dict[int, Deferred] = {}
        self._cids = itertools.count(1)
        self._lock = threading.RLock()

    @property
    def socket_alive(self) -> bool:
        return self._ws is not None and not self._ws.closed

    @property
    def document_count(self) -> int:
        return len(self._conns)

    def _ensure_socket(self) -> websocket.WebSocketConnection:
        with self._lock:
            if self.socket_alive:
                return self._ws
            self._ws = websocket.connect(self.host, self.port, self.path)
            self._reader = threading.Thread(
                target=self._read_loop, args=(self._ws,),
                name=f"ws-mux-{self.host}:{self.port}", daemon=True)
            self._reader.start()
            return self._ws

    def send(self, payload: dict) -> None:
        with self._lock:
            ws = self._ws
        if ws is None or ws.closed:
            raise ConnectionError("mux socket closed")
        try:
            ws.send_text(json.dumps(payload))
        except websocket.WebSocketClosed as exc:
            raise ConnectionError(str(exc)) from exc

    def connect_document(self, tenant_id: str, document_id: str,
                         token: Optional[str],
                         client_details: Optional[dict],
                         timeout: float = 30.0) -> MuxDeltaConnection:
        cid = next(self._cids)
        # Register the connection BEFORE the handshake resolves: the server
        # broadcasts room frames the instant the document is joined, so ops
        # for this cid can arrive ahead of (or interleaved with) the
        # "connected" reply on the reader thread — they must find a
        # dispatch target, and a socket death in that window must deliver
        # this connection its "disconnect".
        conn = MuxDeltaConnection(self, cid, client_id=None,
                                  checkpoint_sequence_number=0)
        deferred = Deferred()
        with self._lock:
            # Socket acquisition and registration are ONE atomic step: a
            # concurrent last-rider detach either sees this registration
            # (and keeps the socket) or finishes releasing the socket
            # first (and _ensure_socket dials a fresh one) — it can never
            # close the socket under a half-registered handshake.
            ws = self._ensure_socket()
            conn._sock = ws
            deferred.sock = ws  # scope dead-socket cleanup to this socket
            self._handshakes[cid] = deferred
            self._conns[cid] = conn
        try:
            self.send({"type": "connect_document", "cid": cid,
                       "tenantId": tenant_id, "documentId": document_id,
                       "token": token, "client": client_details or {}})
            hello = deferred.result(timeout)
            if hello.get("type") != "connected":
                raise ConnectionError(
                    f"connect_document rejected: "
                    f"{hello.get('error', hello)}")
        except BaseException:
            # Unregister the handshake BEFORE detaching so detach's
            # last-rider count sees the truth; detach then tells the
            # server to let go of the document (it may have joined — e.g.
            # handshake timeout raced the reply) AND releases the socket +
            # reader thread if this failed connect was the only rider.
            with self._lock:
                self._handshakes.pop(cid, None)
            self.detach(cid)
            raise
        finally:
            with self._lock:
                self._handshakes.pop(cid, None)
        conn.client_id = hello["clientId"]
        conn.checkpoint_sequence_number = hello.get("sequenceNumber", 0)
        return conn

    def detach(self, cid: int) -> None:
        # The last-rider DECISION commits under the lock by unpublishing
        # the socket (racing connect_documents then dial fresh instead of
        # adopting a socket mid-teardown), but the teardown I/O itself
        # runs outside it — a blocked send must not stall the reader
        # thread's per-frame lock acquisitions for sibling documents.
        with self._lock:
            self._conns.pop(cid, None)
            last = not self._conns and not self._handshakes
            ws = self._ws
            if ws is None or ws.closed:
                return
            if last:
                self._ws = None  # released: no new rider adopts it
        try:
            ws.send_text(json.dumps(
                {"type": "disconnect_document", "cid": cid}))
            if last:
                # Last rider gone: release the physical socket (odsp
                # socket-reference refcount reaching zero).
                ws.send_text(json.dumps({"type": "disconnect"}))
                ws.close()
        except (websocket.WebSocketClosed, OSError):
            pass

    def _read_loop(self, ws: websocket.WebSocketConnection) -> None:
        try:
            while True:
                frame = json.loads(ws.recv())
                cid = frame.get("cid")
                ftype = frame.get("type")
                if ftype in ("connected", "connect_error", "error"):
                    # Generic "error" frames settle a pending handshake on
                    # the same cid too (an older/foreign server answering a
                    # failed connect_document that way must fail the
                    # connect fast, not let it sit out the 30s timeout).
                    with self._lock:
                        handshake = self._handshakes.get(cid)
                    if handshake is not None:
                        handshake.resolve(frame)
                        continue
                    if ftype != "error":
                        continue
                with self._lock:
                    conn = self._conns.get(cid)
                if conn is None:
                    continue
                try:
                    conn._dispatch(frame)
                except Exception:  # noqa: BLE001 — isolate per document
                    # Mirror the legacy per-doc reader (and the server's
                    # per-cid isolation): a failing op handler (RestError
                    # on catch-up, malformed contents) drops THAT document
                    # — its container reconnects — never its siblings.
                    with self._lock:
                        self._conns.pop(cid, None)
                    try:
                        # Release the server side too, or the document
                        # stays joined (ghost client in the quorum) for
                        # the shared socket's lifetime.
                        self.send({"type": "disconnect_document",
                                   "cid": cid})
                    except (ConnectionError, OSError):
                        pass  # half-dead socket: its teardown handles it
                    conn._on_socket_dead()
        except (websocket.WebSocketClosed, OSError,
                json.JSONDecodeError, ValueError):
            pass
        finally:
            # Scope cleanup to riders of THIS socket: a replacement socket
            # may already be live with its own registrations.
            with self._lock:
                dead_conns = [c for c in self._conns.values()
                              if c._sock is ws]
                dead_handshakes = [h for h in self._handshakes.values()
                                   if getattr(h, "sock", None) is ws]
                for c in dead_conns:
                    self._conns.pop(c._cid, None)
                self._handshakes = {
                    cid: h for cid, h in self._handshakes.items()
                    if getattr(h, "sock", None) is not ws}
                if self._ws is ws:
                    self._ws = None
            for handshake in dead_handshakes:
                handshake.reject(ConnectionError("mux socket closed"))
            for conn in dead_conns:
                conn._on_socket_dead()


class MuxConnectionPool:
    """Socket managers keyed by endpoint — the factory-level registry that
    makes two documents on the same endpoint share one socket."""

    def __init__(self):
        self._managers: Dict[Tuple[str, int, str], MuxSocketManager] = {}
        self._lock = threading.Lock()

    def manager(self, host: str, port: int,
                path: str = "/socket-mux") -> MuxSocketManager:
        key = (host, port, path)
        with self._lock:
            mgr = self._managers.get(key)
            if mgr is None:
                mgr = MuxSocketManager(host, port, path)
                self._managers[key] = mgr
            return mgr
