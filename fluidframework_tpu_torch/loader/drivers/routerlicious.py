"""Network driver: REST storage/delta catch-up + websocket delta stream.

Capability parity with reference packages/drivers/routerlicious-driver
(`src/documentService.ts`, `documentDeltaConnection.ts`,
`deltaStorageService.ts`, `documentStorageService.ts`) and driver-base
(`src/documentDeltaConnection.ts`): the production driver that talks to an
Alfred front door (server/alfred.py) over real sockets. Token minting
follows the reference's ITokenProvider pattern — the host supplies a
callable returning a JWT for (tenantId, documentId).

A port of fluidframework_tpu's loader/drivers/routerlicious.py. The
wire is JSON, so this driver speaks to either package's alfred; the
Loader above it chooses the device.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Optional

from ...core.events import TypedEventEmitter
from ...protocol.messages import (DocumentMessage,
                                  SequencedDocumentMessage, SignalMessage)
from ...protocol.summary import (
    SummaryTree,
    summary_tree_from_dict,
    summary_tree_to_dict,
)
from ...server import websocket
from ...telemetry import tracing
from ...server.wire import (
    delta_rows_to_messages,
    document_message_to_dict,
    nack_from_dict,
    sequenced_message_from_dict,
)
from .base import (
    IDocumentDeltaConnection,
    IDocumentDeltaStorageService,
    IDocumentService,
    IDocumentServiceFactory,
    IDocumentStorageService,
)

TokenProvider = Callable[[str, str], str]  # (tenant_id, document_id) -> jwt


def _q(segment: str) -> str:
    """Percent-encode a caller-supplied id for use as one URL path/query
    segment (ids may contain spaces, '#', '%', ...)."""
    return urllib.parse.quote(str(segment), safe="")


class RestWrapper:
    """Thin authenticated JSON REST client (reference services-client
    RestWrapper)."""

    def __init__(self, base_url: str, token: Optional[str] = None,
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    def request(self, method: str, path: str,
                body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base_url + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")
            raise RestError(exc.code, detail) from exc

    def get(self, path: str) -> dict:
        return self.request("GET", path)

    def post(self, path: str, body: Optional[dict] = None) -> dict:
        return self.request("POST", path, body or {})


class RestError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


RestFactory = Callable[[], RestWrapper]


def _never_sent(exc: OSError) -> bool:
    """True when the transport error proves the request never reached the
    server (safe to replay a non-idempotent call elsewhere)."""
    if isinstance(exc, ConnectionRefusedError):
        return True
    reason = getattr(exc, "reason", None)  # urllib wraps in URLError
    return isinstance(reason, ConnectionRefusedError)


class NetworkDocumentStorageService(IDocumentStorageService):
    """Summary upload/download over the historian REST routes. Takes a
    RestWrapper *factory* so every request gets a freshly minted token —
    these services are long-lived and tokens expire.

    historian_factory: a second RestFactory pointed at a standalone
    summary-cache tier (server/historian.py). When set, storage traffic
    rides the tier — reads serve from its object cache, uploads
    write-through it — and a dead tier degrades to the direct endpoint
    (sticky per service instance, so one mid-load kill costs one timeout,
    not one per blob)."""

    def __init__(self, rest_factory: RestFactory, tenant_id: str,
                 document_id: str,
                 historian_factory: Optional[RestFactory] = None):
        self._rest = rest_factory
        self._historian = historian_factory
        self._historian_down = False
        self.tenant_id = tenant_id
        self.document_id = document_id
        self._repo = f"/repos/{_q(tenant_id)}/{_q(document_id)}"

    def _call(self, fn, idempotent: bool = True):
        """fn(rest) against the cache tier first; transport failure or a
        503 (tier lost ITS upstream) falls back to the direct endpoint —
        the historian-killed-mid-load degradation path.

        idempotent=False (summary uploads): an AMBIGUOUS transport error
        (timeout / reset mid-flight) must NOT replay against the direct
        endpoint — the tier may already have committed the write (a
        replayed initial upload would 409 a document that was in fact
        created; a replayed proposal would orphan a duplicate commit).
        Only a provably-unsent request (connection refused) falls back."""
        if self._historian is not None and not self._historian_down:
            try:
                return fn(self._historian())
            except RestError as exc:
                if exc.status != 503:
                    raise
                self._historian_down = True
            except OSError as exc:
                self._historian_down = True
                if not idempotent and not _never_sent(exc):
                    raise
        return fn(self._rest())

    def get_summary(self, version: Optional[str] = None
                    ) -> Optional[SummaryTree]:
        path = self._repo + "/summaries/latest"
        if version:
            path += f"?sha={_q(version)}"
        try:
            data = self._call(lambda rest: rest.get(path))
        except RestError as exc:
            if exc.status == 404:
                return None
            raise
        return summary_tree_from_dict(data["summary"])

    def upload_summary(self, summary: SummaryTree,
                       parent: Optional[str] = None,
                       initial: bool = False) -> str:
        body = {
            "summary": summary_tree_to_dict(summary),
            "parent": parent,
            "initial": initial,
        }
        return self._call(
            lambda rest: rest.post(self._repo + "/summaries", body),
            idempotent=False)["sha"]

    def get_versions(self, count: int = 1) -> List[str]:
        return self._call(lambda rest: rest.get(
            self._repo + f"/versions?count={count}"))["versions"]

    def get_catchup(self):
        """`summary + delta` in ONE historian round trip (the read tier's
        `/catchup` route, docs/read_path.md). A tier without the route
        (404), a dead tier, or a tier with no artifact degrades to the
        plain summary read — the loader then tail-replays."""
        try:
            data = self._call(lambda rest: rest.get(
                self._repo + "/catchup"))
        except RestError as exc:
            if exc.status in (404, 501):
                return self.get_summary(), None
            raise
        except OSError:
            return self.get_summary(), None
        summary = data.get("summary")
        artifact = data.get("catchup")
        if summary is None:
            return self.get_summary(), artifact
        return summary_tree_from_dict(summary), artifact

    def get_catchup_artifact(self):
        try:
            data = self._call(lambda rest: rest.get(
                self._repo + "/catchup?artifactOnly=1"))
        except (RestError, OSError):
            return None
        return data.get("catchup")


class NetworkDeltaStorageService(IDocumentDeltaStorageService):
    """Catch-up reads over the alfred delta REST route."""

    def __init__(self, rest_factory: RestFactory, tenant_id: str,
                 document_id: str):
        self._rest = rest_factory
        self.path = f"/deltas/{_q(tenant_id)}/{_q(document_id)}"

    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        path = self.path + f"?from={from_seq}"
        if to_seq is not None:
            path += f"&to={to_seq}"
        return delta_rows_to_messages(self._rest().get(path)["deltas"])


class NetworkDocumentDeltaConnection(TypedEventEmitter,
                                     IDocumentDeltaConnection):
    """The live op stream over a websocket. A reader thread dispatches
    server frames to "op"/"nack"/"signal"/"disconnect" listeners — same
    event surface as the local driver so DeltaManager is agnostic."""

    def __init__(self, host: str, port: int, tenant_id: str,
                 document_id: str, token: Optional[str],
                 client_details: Optional[dict]):
        TypedEventEmitter.__init__(self)
        self._ws = websocket.connect(host, port, "/socket")
        self._ws.send_text(json.dumps({
            "type": "connect_document",
            "tenantId": tenant_id,
            "documentId": document_id,
            "token": token,
            "client": client_details or {},
        }))
        # The server registers broadcast listeners before sending
        # "connected", so a busy document can push op frames ahead of the
        # handshake reply. Skip them — they are already durable (the server
        # persists before broadcasting) and the post-connect catch-up fetch
        # replays them in order.
        while True:
            hello = json.loads(self._ws.recv())
            htype = hello.get("type")
            if htype == "connected":
                break
            if htype in ("op", "nack", "signal"):
                # Ops replay via catch-up; a pre-handshake signal is
                # droppable by definition (transient, no ordering contract).
                continue
            self._ws.close()
            raise ConnectionError(
                f"connect_document rejected: {hello.get('error', hello)}")
        self.client_id = hello["clientId"]
        self.checkpoint_sequence_number = hello.get("sequenceNumber", 0)
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"ws-{self.client_id}",
                                        daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                frame = json.loads(self._ws.recv())
                ftype = frame.get("type")
                if ftype == "op":
                    self.emit("op",
                              sequenced_message_from_dict(frame["message"]))
                elif ftype == "nack":
                    self.emit("nack", nack_from_dict(frame["nack"]))
                elif ftype == "signal":
                    self.emit("signal", SignalMessage(
                        client_id=frame.get("clientId"),
                        content=frame.get("content")))
        except (websocket.WebSocketClosed, OSError,
                json.JSONDecodeError, ValueError, RestError):
            # RestError: an op handler's catch-up fetch failed (e.g. expired
            # token); treat like a dropped connection so the container's
            # disconnect/reconnect path takes over instead of a dead thread.
            pass
        finally:
            if not self._closed:
                self._closed = True
                self.emit("disconnect")

    def submit(self, messages: List[DocumentMessage]) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        # Trace context onto the wire: metadata serializes inside
        # document_message_to_dict, so the context survives the socket
        # hop into alfred's ingest verbatim.
        ctx = tracing.ensure_op_context()
        if ctx is not None:
            for msg in messages:
                tracing.stamp_message(msg, ctx)
        with tracing.span("driver.submit", parent=ctx, transport="ws",
                          count=len(messages)):
            self._ws.send_text(json.dumps({
                "type": "submitOp",
                "messages": [document_message_to_dict(m)
                             for m in messages],
            }))

    def submit_signal(self, content) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        try:
            self._ws.send_text(json.dumps(
                {"type": "submitSignal", "content": content}))
        except websocket.WebSocketClosed as exc:
            # The reader thread flips the websocket's flag before ours:
            # normalize to the ConnectionError the runtime's drop-don't-
            # raise contract catches.
            raise ConnectionError(str(exc)) from exc

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._ws.send_text(json.dumps({"type": "disconnect"}))
        except (websocket.WebSocketClosed, OSError):
            pass
        self._ws.close()
        # close() can be reached from the reader thread itself (e.g. a nack
        # handler triggering reconnect); a thread cannot join itself.
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=5)


class NetworkDocumentService(IDocumentService):
    def __init__(self, base_url: str, tenant_id: str, document_id: str,
                 token_provider: Optional[TokenProvider],
                 mux_pool=None, session_cache=None,
                 historian_url: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.tenant_id = tenant_id
        self.document_id = document_id
        self.token_provider = token_provider
        self.historian_url = (historian_url.rstrip("/")
                              if historian_url else None)
        # Set by a multiplexing factory: shared socket pool + join-session
        # discovery cache (loader/drivers/mux.py).
        self._mux_pool = mux_pool
        self._session_cache = session_cache
        without_scheme = self.base_url.split("://", 1)[-1]
        host, _, port = without_scheme.partition(":")
        self._host, self._port = host, int(port or 80)

    def _token(self) -> Optional[str]:
        if self.token_provider is None:
            return None
        return self.token_provider(self.tenant_id, self.document_id)

    def _rest(self) -> RestWrapper:
        return RestWrapper(self.base_url, self._token())

    def _historian_rest(self) -> RestWrapper:
        # Same bearer token: the tier forwards it upstream, so alfred's
        # riddler validation still gates every cached read.
        return RestWrapper(self.historian_url, self._token())

    def connect_to_storage(self) -> NetworkDocumentStorageService:
        return NetworkDocumentStorageService(
            self._rest, self.tenant_id, self.document_id,
            historian_factory=(self._historian_rest
                               if self.historian_url else None))

    def connect_to_delta_storage(self) -> NetworkDeltaStorageService:
        return NetworkDeltaStorageService(self._rest, self.tenant_id,
                                          self.document_id)

    def connect_to_delta_stream(self, client_details: Optional[dict] = None
                                ) -> IDocumentDeltaConnection:
        if self._mux_pool is None:
            return NetworkDocumentDeltaConnection(
                self._host, self._port, self.tenant_id, self.document_id,
                self._token(), client_details)
        # Multiplexed path: discover the socket endpoint (join-session),
        # then ride the pooled socket for that endpoint. A dead pooled
        # socket fails the first attempt; refresh the discovery and retry
        # once on a fresh socket.
        for attempt in (0, 1):
            discovery = self._session_cache.get(self.tenant_id,
                                                self.document_id)
            manager = self._mux_pool.manager(
                discovery["socketHost"], discovery["socketPort"],
                discovery.get("socketPath", "/socket-mux"))
            try:
                return manager.connect_document(
                    self.tenant_id, self.document_id, self._token(),
                    client_details)
            except ConnectionError:
                self._session_cache.invalidate(self.tenant_id,
                                               self.document_id)
                if attempt:
                    raise


class NetworkDocumentServiceFactory(IDocumentServiceFactory):
    """Driver entry point: points at an alfred URL + tenant, mints a
    document service per document.

    multiplex=True turns on the odsp-style connection management: the
    delta stream is discovered per document via the join-session REST
    call and documents on the same endpoint share ONE physical websocket
    (loader/drivers/mux.py).

    historian_url points storage traffic at a standalone summary-cache
    tier (server/historian.py); second-and-later container loads then
    serve summary blobs from its cache instead of GitStore, degrading to
    base_url if the tier is down."""

    def __init__(self, base_url: str, tenant_id: str,
                 token_provider: Optional[TokenProvider] = None,
                 multiplex: bool = False,
                 historian_url: Optional[str] = None):
        self.base_url = base_url
        self.tenant_id = tenant_id
        self.token_provider = token_provider
        self.historian_url = historian_url
        if multiplex:
            from .mux import JoinSessionCache, MuxConnectionPool
            self.mux_pool = MuxConnectionPool()
            self.session_cache = JoinSessionCache(self._fetch_session)
        else:
            self.mux_pool = None
            self.session_cache = None

    def _fetch_session(self, tenant_id: str, document_id: str) -> dict:
        token = (self.token_provider(tenant_id, document_id)
                 if self.token_provider else None)
        rest = RestWrapper(self.base_url, token)
        return rest.get(f"/api/v1/session/{_q(tenant_id)}/{_q(document_id)}")

    def set_historian_endpoint(self, historian_url: Optional[str]) -> None:
        """Repoint storage reads at a cache tier (or None to detach);
        affects services created afterwards."""
        self.historian_url = historian_url

    def create_document_service(self, document_id: str
                                ) -> NetworkDocumentService:
        return NetworkDocumentService(self.base_url, self.tenant_id,
                                      document_id, self.token_provider,
                                      mux_pool=self.mux_pool,
                                      session_cache=self.session_cache,
                                      historian_url=self.historian_url)

    def create_document(self, document_id: Optional[str] = None,
                        summary: Optional[SummaryTree] = None) -> str:
        """POST /documents (reference createDoc flow). Returns the doc id."""
        token = (self.token_provider(self.tenant_id, document_id or "*")
                 if self.token_provider else None)
        body: dict = {}
        if document_id:
            body["id"] = document_id
        if summary is not None:
            body["summary"] = summary_tree_to_dict(summary)
        rest = RestWrapper(self.base_url, token)
        return rest.post(f"/documents/{_q(self.tenant_id)}", body)["id"]
