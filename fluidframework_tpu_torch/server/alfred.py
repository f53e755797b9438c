"""Alfred: the network front door of the ordering service.

Capability parity with reference routerlicious-base Alfred
(`src/alfred/{app,runner,routes}`, socket handlers `connect_document`/
`submitOp` in `lambdas/src/alfred/index.ts:305-328`) plus the co-hosted
REST surfaces of Riddler (tenant CRUD/token validation,
`riddler/tenantManager.ts`) and historian/gitrest (git summary storage,
`server/historian`, `server/gitrest`). One `AlfredService` exposes:

  REST  GET  /api/v1/ping
        POST /documents/{tenant}                (create document)
        GET  /deltas/{tenant}/{doc}?from=&to=   (catch-up range query)
        POST /tenants/{tenant}                  (Riddler: create tenant)
        GET  /tenants/{tenant}/key              (Riddler: fetch secret)
        POST /tenants/{tenant}/validate         (Riddler: validate a JWT)
        POST /repos/{tenant}/{doc}/summaries    (upload summary tree)
        GET  /repos/{tenant}/{doc}/summaries/latest?sha=
        GET  /repos/{tenant}/{doc}/versions?count=
        GET  /repos/{tenant}/{doc}/git/commits?count=
  WS    GET  /socket  (upgrade)  -> connect_document / submitOp / op / nack

Behind the door each tenant gets a `LocalServer` core — the *real*
Deli/Scribe/Scriptorium/Broadcaster lambda pipeline (server/local_server.py)
— so the network path and the in-process test path exercise identical
sequencing code, exactly like the reference where LocalOrderer and the
Kafka deployment share lambda implementations.

The delta-stream wire protocol is JSON text frames:
  C->S {"type": "connect_document", "tenantId", "documentId", "token", "client"}
  S->C {"type": "connected", "clientId", "sequenceNumber"}
  C->S {"type": "submitOp", "messages": [DocumentMessage...]}
  C->S {"type": "submitSignal", "content": ...}   (transient; no sequencing)
  S->C {"type": "op", "message": SequencedDocumentMessage}
  S->C {"type": "nack", "nack": Nack}
  S->C {"type": "signal", "clientId", "content"}

A port of fluidframework_tpu's server/alfred.py. Its per-document cores
are the scalar LocalServer, which holds no device state; the wire (REST
and websocket JSON) is the reference's.
"""

from __future__ import annotations

import hmac
import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from ..protocol.summary import summary_tree_from_dict, summary_tree_to_dict
from ..telemetry import tracing
from ..telemetry.counters import increment, record_swallow
from .admission import admission_from_config
from .auth import AuthError, TenantManager
from .historian import TIER_HEADER, git_object_to_wire, notify_summary_commit
from .local_server import LocalServer
from .websocket import WebSocketClosed, upgrade_server_socket
from .wire import (
    document_message_from_dict,
    nack_to_dict,
    sequenced_message_to_dict,
)


class AlfredService:
    """The front-door service. Thread-safe; one instance serves many
    tenants/documents over one listening port."""

    def __init__(self, tenants: Optional[TenantManager] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 require_auth: bool = True,
                 partitions: int = 1,
                 admin_key: Optional[str] = None,
                 config=None,
                 historian_url: Optional[str] = None):
        """config: the nconf-style provider handed to each tenant core
        (throttling, op-size ceiling, deli checkpoint/eviction knobs).

        historian_url: a standalone summary-cache tier
        (server/historian.py). When set, latest-summary reads delegate to
        it (unless the request came FROM the tier — TIER_HEADER marks
        those) and summary commits notify it for invalidation + warm
        prefetch. When unset or unreachable, git routes serve straight
        from the GitStore — the degradation path."""
        self.tenants = tenants or TenantManager()
        self.config = config
        self.historian_url = historian_url
        if self.historian_url is None and config is not None:
            self.historian_url = config.get("historian.url")
        self.require_auth = require_auth
        # Riddler's tenant CRUD/key routes are operator-only (the reference
        # deploys riddler on an internal network); when auth is on they
        # require this key in an X-Admin-Key header.
        self.admin_key = admin_key or uuid.uuid4().hex
        self.partitions = partitions
        self._cores: Dict[str, LocalServer] = {}
        self._cores_lock = threading.Lock()
        # ONE admission controller across every tenant core: overload is
        # a process-level condition (the cores share this process's CPU
        # and memory), and sharing the controller is what makes the
        # per-tenant credit split an actual fairness guarantee instead of
        # per-core honor system (server/admission.py).
        self.admission = admission_from_config(config)
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                if self.headers.get("Upgrade", "").lower() == "websocket":
                    service._handle_websocket(self)
                    self.close_connection = True
                    return
                service._handle_rest(self, "GET")

            def do_POST(self):
                service._handle_rest(self, "POST")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "AlfredService":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="alfred", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def attach_historian(self, historian_url: Optional[str]) -> None:
        """Point this alfred at a summary-cache tier after construction
        (the tier usually needs alfred's URL first, so the wiring is
        two-phase). Existing cores gain the commit notifier too."""
        # Atomic reference publish of an immutable endpoint string: the
        # HTTP request threads read it lock-free and tolerate either
        # epoch (a request raced with attachment simply serves direct).
        # fluidlint: disable=SHARED_STATE_NO_LOCK — single-writer
        # publish of an immutable str; readers tolerate either epoch
        self.historian_url = historian_url
        if historian_url:
            with self._cores_lock:
                for tenant_id, core in self._cores.items():
                    self._register_commit_notifier(core, tenant_id)

    def _register_commit_notifier(self, core: LocalServer,
                                  tenant_id: str) -> None:
        # Scribe-acked commits advance refs in-process; the cache tier
        # must hear about them (invalidate + warm prefetch).
        core.summary_commit_listeners.append(
            lambda doc_id, sha, t=tenant_id:
            self.historian_url and notify_summary_commit(
                self.historian_url, t, doc_id, sha))

    def core(self, tenant_id: str) -> LocalServer:
        """The per-tenant ordering core (lazily created)."""
        with self._cores_lock:
            if tenant_id not in self._cores:
                core = LocalServer(
                    tenant_id=tenant_id, partitions=self.partitions,
                    config=self.config, admission=self.admission)
                if self.historian_url:
                    self._register_commit_notifier(core, tenant_id)
                self._cores[tenant_id] = core
            return self._cores[tenant_id]

    # -- auth --------------------------------------------------------------
    def _check_auth(self, handler, tenant_id: str,
                    document_id: Optional[str], scope: Optional[str],
                    token: Optional[str] = None) -> Optional[dict]:
        """Returns claims (or {} when auth is off); None after sending an
        error response."""
        if not self.require_auth:
            return {}
        if token is None:
            auth = handler.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                token = auth[len("Bearer "):]
        if not token:
            _send_json(handler, 401, {"error": "missing token"})
            return None
        try:
            return self.tenants.validate_token(tenant_id, token,
                                               document_id, scope)
        except AuthError as exc:
            _send_json(handler, 403, {"error": str(exc)})
            return None

    def _validate_ws_token(self, tenant_id: str, document_id: str,
                           token: Optional[str]) -> Optional[str]:
        """Returns an error string or None if admitted."""
        if not self.require_auth:
            return None
        if not token:
            return "missing token"
        try:
            self.tenants.validate_token(tenant_id, token, document_id,
                                        "doc:write")
            return None
        except AuthError as exc:
            return str(exc)

    # -- REST --------------------------------------------------------------
    _ROUTES = [
        ("GET", re.compile(r"^/api/v1/ping$"), "_r_ping"),
        ("GET", re.compile(
            r"^/api/v1/session/(?P<tenant>[^/]+)/(?P<doc>[^/]+)$"),
         "_r_join_session"),
        ("POST", re.compile(r"^/documents/(?P<tenant>[^/]+)$"), "_r_create_doc"),
        ("GET", re.compile(r"^/documents/(?P<tenant>[^/]+)/(?P<doc>[^/]+)$"),
         "_r_get_doc"),
        ("GET", re.compile(
            r"^/deltas/raw/(?P<tenant>[^/]+)/(?P<doc>[^/]+)$"),
         "_r_raw_deltas"),
        ("POST", re.compile(
            r"^/api/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/blobs$"),
         "_r_create_blob"),
        ("GET", re.compile(r"^/deltas/(?P<tenant>[^/]+)/(?P<doc>[^/?]+)$"),
         "_r_deltas"),
        ("POST", re.compile(r"^/tenants/(?P<tenant>[^/]+)/validate$"),
         "_r_validate"),
        ("GET", re.compile(r"^/tenants/(?P<tenant>[^/]+)/key$"), "_r_key"),
        ("POST", re.compile(r"^/tenants/(?P<tenant>[^/]+)$"), "_r_create_tenant"),
        ("POST", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/summaries$"),
         "_r_upload_summary"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/summaries/latest$"),
         "_r_latest_summary"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/versions$"),
         "_r_versions"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/git/commits$"),
         "_r_commits"),
        # gitrest object surface (what the historian tier proxies).
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/objects/(?P<sha>[^/]+)$"),
         "_r_git_object"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/blobs/(?P<sha>[^/]+)$"),
         "_r_git_blob"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/trees/(?P<sha>[^/]+)$"),
         "_r_git_tree"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/refs/(?P<ref>.+)$"),
         "_r_git_ref"),
    ]

    def _handle_rest(self, handler, method: str) -> None:
        path, _, query = handler.path.partition("?")
        params = _parse_query(query)
        for route_method, pattern, name in self._ROUTES:
            if route_method != method:
                continue
            m = pattern.match(path)
            if m:
                # Path params arrive percent-encoded (the driver encodes
                # ids); decode so REST and websocket paths key identically.
                groups = {k: urllib.parse.unquote(v)
                          for k, v in m.groupdict().items()}
                try:
                    getattr(self, name)(handler, params, **groups)
                except BrokenPipeError:
                    record_swallow("alfred.client_gone")
                except Exception as exc:  # route bug -> 500, keep serving
                    increment("alfred.route_errors")
                    try:
                        _send_json(handler, 500, {"error": repr(exc)})
                    except OSError:  # reply socket died mid-error
                        record_swallow("alfred.route_reply")
                return
        _send_json(handler, 404, {"error": f"no route {method} {path}"})

    def _r_ping(self, handler, params) -> None:
        _send_json(handler, 200, {"ok": True})

    def _r_join_session(self, handler, params, tenant: str,
                        doc: str) -> None:
        """Session discovery (the odsp-driver joinSession flow,
        odsp-driver/src: fetch the socket endpoint before connecting):
        returns where the delta-stream socket for this document lives and
        how long the discovery may be cached. One alfred serves every
        document here, but the indirection is the contract that lets a
        deployment shard documents across socket front-ends."""
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        # Advertise a host the CLIENT can dial: the bind address is useless
        # when alfred listens on a wildcard, so prefer what the client
        # already reached us by (its Host header).
        host = self.host
        if host in ("0.0.0.0", "::", ""):
            req_host = handler.headers.get("Host", "")
            if req_host.startswith("["):  # [v6]:port or bare [v6]
                req_host = req_host.partition("]")[0].lstrip("[")
            elif ":" in req_host:
                req_host = req_host.rsplit(":", 1)[0]
            host = req_host or "127.0.0.1"
        _send_json(handler, 200, {
            "socketHost": host,
            "socketPort": self.port,
            "socketPath": "/socket-mux",
            "tenantId": tenant,
            "documentId": doc,
            "sessionExpiryMs": 600_000,
        })

    def _check_admin(self, handler) -> bool:
        """Operator gate for riddler routes. Sends the error response when
        rejecting."""
        if not self.require_auth:
            return True
        supplied = handler.headers.get("X-Admin-Key", "")
        if hmac.compare_digest(supplied, self.admin_key):
            return True
        _send_json(handler, 403, {"error": "admin key required"})
        return False

    def _r_create_tenant(self, handler, params, tenant: str) -> None:
        if not self._check_admin(handler):
            return
        body = _read_json(handler) or {}
        try:
            t = self.tenants.create_tenant(tenant, key=body.get("key"))
        except ValueError as exc:
            _send_json(handler, 409, {"error": str(exc)})
            return
        _send_json(handler, 201, {"id": t.id, "key": t.key})

    def _r_key(self, handler, params, tenant: str) -> None:
        if not self._check_admin(handler):
            return
        try:
            key = self.tenants.get_key(tenant)
        except AuthError as exc:
            _send_json(handler, 404, {"error": str(exc)})
            return
        _send_json(handler, 200, {"key": key})

    def _r_validate(self, handler, params, tenant: str) -> None:
        body = _read_json(handler) or {}
        try:
            claims = self.tenants.validate_token(tenant, body.get("token", ""))
        except AuthError as exc:
            _send_json(handler, 403, {"error": str(exc)})
            return
        _send_json(handler, 200, {"claims": claims})

    def _r_create_doc(self, handler, params, tenant: str) -> None:
        body = _read_json(handler) or {}
        doc_id = body.get("id") or f"doc-{uuid.uuid4().hex[:12]}"
        # The token must be bound to the document being created (or be a
        # wildcard token) — a docA-scoped token must not create/overwrite
        # docB's attach summary.
        claims = self._check_auth(handler, tenant, doc_id, "doc:write")
        if claims is None:
            return
        core = self.core(tenant)
        # Existence registry: a summary-less create must still be readable
        # back immediately (create-then-GET consistency).
        core.db.collection("documents").upsert(
            lambda d, _id=doc_id: d.get("documentId") == _id,
            {"documentId": doc_id, "tenantId": tenant})
        if body.get("summary") is not None:
            store = core.storage(doc_id)
            if store.get_ref("main") is not None:
                # The document already has a load target; repointing it at
                # a fresh attach summary would orphan the existing history.
                _send_json(handler, 409,
                           {"error": f"document {doc_id!r} exists"})
                return
            # Attach-with-summary: the initial summary becomes the load
            # target immediately (no scribe ack needed for attach).
            tree = summary_tree_from_dict(body["summary"])
            store.write_summary(tree, message="attach", advance_ref=True)
        _send_json(handler, 201, {"id": doc_id})

    def _r_deltas(self, handler, params, tenant: str, doc: str) -> None:
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        from_seq = int(params.get("from", 0))
        to_seq = int(params["to"]) if "to" in params else None
        rows = self.core(tenant).get_deltas(doc, from_seq, to_seq)
        _send_json(handler, 200, {"deltas": rows})

    def _r_get_doc(self, handler, params, tenant: str, doc: str) -> None:
        """Document existence + metadata (reference alfred
        routes/api/documents.ts:14 getDocument)."""
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        core = self.core(tenant)
        head = core.storage(doc).get_ref("main")
        seq = core.sequence_number(doc)
        registered = core.db.collection("documents").find_one(
            lambda d: d.get("documentId") == doc) is not None
        if head is None and seq == 0 and not registered:
            _send_json(handler, 404, {"error": f"document {doc!r} not found"})
            return
        _send_json(handler, 200, {
            "id": doc, "tenantId": tenant, "sequenceNumber": seq,
            "headSummary": head})

    def _r_raw_deltas(self, handler, params, tenant: str, doc: str) -> None:
        """Raw (pre-sequencing) op stream persisted by the copier
        (reference alfred routes/api/deltas.ts:183 /deltas/raw)."""
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        core = self.core(tenant)
        from_off = int(params.get("from", -1))
        limit = int(params.get("limit", 1000))
        rows = core.raw_deltas.find(
            lambda d: d.get("documentId") == doc
            and d.get("offset", 0) > from_off)
        rows.sort(key=lambda d: d.get("offset", 0))
        _send_json(handler, 200, {"rawDeltas": rows[:limit]})

    def _r_create_blob(self, handler, params, tenant: str,
                       doc: str) -> None:
        """Attachment blob upload (reference alfred api.ts:59 createBlob):
        content-addressed into the document's git store; the returned sha
        is referenced from summaries/ops as an attachment handle."""
        claims = self._check_auth(handler, tenant, doc, "doc:write")
        if claims is None:
            return
        body = _read_json(handler) or {}
        content = body.get("content")
        if not isinstance(content, str):
            _send_json(handler, 400, {"error": "content (base64) required"})
            return
        import base64
        try:
            raw = base64.b64decode(content, validate=True)
        except ValueError:  # binascii.Error: malformed payload
            _send_json(handler, 400, {"error": "content is not base64"})
            return
        sha = self.core(tenant).storage(doc).put_blob(raw)
        _send_json(handler, 201, {"sha": sha, "size": len(raw),
                                  "url": f"/blobs/{tenant}/{doc}/{sha}"})

    def _r_upload_summary(self, handler, params, tenant: str,
                          doc: str) -> None:
        claims = self._check_auth(handler, tenant, doc, "summary:write")
        if claims is None:
            return
        body = _read_json(handler) or {}
        tree = summary_tree_from_dict(body["summary"])
        store = self.core(tenant).storage(doc)
        initial = bool(body.get("initial"))
        if initial and store.get_ref("main") is not None:
            # Same guard as create: only the attach of a NEW document may
            # set the load target directly; later summaries are proposals
            # that scribe acks (advance_ref stays False for them).
            _send_json(handler, 409, {"error": f"document {doc!r} exists"})
            return
        sha = store.write_summary(tree, base_commit=body.get("parent"),
                                  advance_ref=initial)
        if self.historian_url and not handler.headers.get(TIER_HEADER):
            # Direct upload bypassed the cache tier: tell it the commit
            # landed so a stale latest pointer never outlives this write
            # (and the new tree warms ahead of the scribe ack).
            notify_summary_commit(self.historian_url, tenant, doc, sha)
        _send_json(handler, 201, {"sha": sha})

    def _r_latest_summary(self, handler, params, tenant: str,
                          doc: str) -> None:
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        if (self.historian_url and not handler.headers.get(TIER_HEADER)
                and self._delegate_latest(handler, params, tenant, doc)):
            return
        core = self.core(tenant)
        tree = core.historian.read_summary(tenant, doc,
                                           commit_sha=params.get("sha"))
        if tree is None:
            _send_json(handler, 404, {"error": "no summary"})
            return
        _send_json(handler, 200, {"summary": summary_tree_to_dict(tree)})

    def _delegate_latest(self, handler, params, tenant: str,
                         doc: str) -> bool:
        """Serve the latest-summary read through the historian tier.
        Returns True when a response was sent; False (historian down)
        lets the caller fall back to the direct GitStore path."""
        path = (f"/repos/{urllib.parse.quote(tenant, safe='')}"
                f"/{urllib.parse.quote(doc, safe='')}/summaries/latest")
        if "sha" in params:
            path += "?sha=" + urllib.parse.quote(params["sha"], safe="")
        req = urllib.request.Request(self.historian_url.rstrip("/") + path)
        auth = handler.headers.get("Authorization")
        if auth:
            req.add_header("Authorization", auth)
        try:
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                _send_json(handler, resp.status,
                           json.loads(resp.read() or b"{}"))
            return True
        except urllib.error.HTTPError as exc:
            if exc.code == 503:
                return False  # tier's own upstream is down: serve direct
            _send_json(handler, exc.code, _error_payload(exc))
            return True
        except OSError:
            return False

    def _r_versions(self, handler, params, tenant: str, doc: str) -> None:
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        count = int(params.get("count", 1))
        shas = [c.sha for c in
                self.core(tenant).storage(doc).list_commits(limit=count)]
        _send_json(handler, 200, {"versions": shas})

    def _r_commits(self, handler, params, tenant: str, doc: str) -> None:
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        count = int(params.get("count", 10))
        commits = self.core(tenant).storage(doc).list_commits(limit=count)
        _send_json(handler, 200, {"commits": [
            {"sha": c.sha, "tree": c.tree_sha, "parents": c.parents,
             "message": c.message, "timestamp": c.timestamp}
            for c in commits]})

    # -- gitrest object surface (consumed by server/historian.py) ----------
    def _r_git_object(self, handler, params, tenant: str, doc: str,
                      sha: str) -> None:
        self._send_git_object(handler, tenant, doc, sha, kind=None)

    def _r_git_blob(self, handler, params, tenant: str, doc: str,
                    sha: str) -> None:
        self._send_git_object(handler, tenant, doc, sha, kind="blob")

    def _r_git_tree(self, handler, params, tenant: str, doc: str,
                    sha: str) -> None:
        self._send_git_object(handler, tenant, doc, sha, kind="tree")

    def _send_git_object(self, handler, tenant: str, doc: str, sha: str,
                         kind: Optional[str]) -> None:
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        obj = self.core(tenant).storage(doc).get(sha)
        if obj is None:
            _send_json(handler, 404,
                       {"error": f"no object {sha!r}"})
            return
        wire = git_object_to_wire(obj)
        if kind is not None and wire.get("kind") != kind:
            _send_json(handler, 404,
                       {"error": f"object {sha!r} is a "
                                 f"{wire.get('kind')}, not a {kind}"})
            return
        _send_json(handler, 200, wire)

    def _r_git_ref(self, handler, params, tenant: str, doc: str,
                   ref: str) -> None:
        claims = self._check_auth(handler, tenant, doc, "doc:read")
        if claims is None:
            return
        sha = self.core(tenant).storage(doc).get_ref(ref)
        if sha is None:
            _send_json(handler, 404, {"error": f"no ref {ref!r}"})
            return
        _send_json(handler, 200, {"ref": ref, "sha": sha})

    # -- websocket delta stream -------------------------------------------
    def _handle_websocket(self, handler) -> None:
        key = handler.headers.get("Sec-WebSocket-Key")
        if not key:
            _send_json(handler, 400, {"error": "bad upgrade"})
            return
        handler.wfile.flush()
        if handler.path.partition("?")[0] == "/socket-mux":
            self._handle_websocket_mux(handler, key)
            return
        ws = upgrade_server_socket(handler.connection, key)
        conn = None
        try:
            # First message must be connect_document.
            hello = json.loads(ws.recv())
            if hello.get("type") != "connect_document":
                ws.send_text(json.dumps(
                    {"type": "error", "error": "expected connect_document"}))
                return
            tenant_id = hello.get("tenantId", "")
            document_id = hello.get("documentId", "")
            err = self._validate_ws_token(tenant_id, document_id,
                                          hello.get("token"))
            if err is not None:
                ws.send_text(json.dumps({"type": "error", "error": err}))
                return
            core = self.core(tenant_id)
            conn = core.connect(document_id, hello.get("client"))

            def on_op(msg, ws=ws):
                try:
                    ws.send_text(json.dumps(
                        {"type": "op",
                         "message": sequenced_message_to_dict(msg)}))
                except (OSError, WebSocketClosed):
                    pass  # reader loop will notice the dead socket

            def on_nack(nack, ws=ws):
                try:
                    ws.send_text(json.dumps(
                        {"type": "nack", "nack": nack_to_dict(nack)}))
                except (OSError, WebSocketClosed):
                    pass

            def on_signal(sig, ws=ws):
                try:
                    ws.send_text(json.dumps(
                        {"type": "signal", "clientId": sig.client_id,
                         "content": sig.content}))
                except (OSError, WebSocketClosed):
                    pass

            conn.on("op", on_op)
            conn.on("nack", on_nack)
            conn.on("signal", on_signal)
            ws.send_text(json.dumps({
                "type": "connected",
                "clientId": conn.client_id,
                "sequenceNumber": core.sequence_number(document_id),
            }))
            while True:
                msg = json.loads(ws.recv())
                mtype = msg.get("type")
                if mtype == "submitOp":
                    messages = [document_message_from_dict(d)
                                for d in msg.get("messages", [])]
                    oversized = _oversized_of(messages, core.max_op_bytes)
                    if oversized is not None:
                        on_nack(oversized)
                    else:
                        # Network ingest hop: the wire context (stamped
                        # by the driver into metadata) parents alfred's
                        # span, and the in-process pipeline nests below.
                        with tracing.span(
                                "alfred.ingest",
                                parent=tracing.first_message_context(
                                    messages),
                                document=document_id):
                            conn.submit(messages)
                elif mtype == "submitSignal":
                    conn.submit_signal(msg.get("content"))
                elif mtype == "disconnect":
                    break
                else:
                    ws.send_text(json.dumps(
                        {"type": "error",
                         "error": f"unknown message {mtype!r}"}))
        except (WebSocketClosed, OSError, json.JSONDecodeError):
            pass
        finally:
            if conn is not None:
                conn.disconnect()
            ws.close()

    def _handle_websocket_mux(self, handler, key: str) -> None:
        """Multiplexed delta stream: many documents share ONE websocket
        (the odsp-driver socket-reference pattern — one physical socket per
        endpoint, documents keyed by a client-chosen connection id `cid`).
        Frames are the legacy protocol plus a `cid` field; per-document
        errors answer on the cid instead of killing the shared socket.

          C->S {"type": "connect_document", "cid", "tenantId",
                "documentId", "token", "client"}
          S->C {"type": "connected", "cid", "clientId", "sequenceNumber"}
          S->C {"type": "connect_error", "cid", "error"}
          C->S {"type": "submitOp"|"submitSignal", "cid", ...}
          C->S {"type": "disconnect_document", "cid"}
          C->S {"type": "disconnect"}   (closes every document + socket)
        """
        ws = upgrade_server_socket(handler.connection, key)
        conns: Dict[int, object] = {}

        def send(payload: dict) -> None:
            try:
                ws.send_text(json.dumps(payload))
            except (OSError, WebSocketClosed):
                pass  # reader loop will notice the dead socket

        try:
            while True:
                msg = json.loads(ws.recv())
                if msg.get("type") == "disconnect":
                    break
                try:
                    self._handle_mux_frame(msg, conns, send)
                except (WebSocketClosed, OSError):
                    raise  # transport dead: tear the socket down
                except Exception as exc:  # noqa: BLE001 — isolate per doc
                    # One document's bad frame must never kill the shared
                    # socket for its siblings: answer on the cid.
                    increment("alfred.mux_frame_errors")
                    send({"type": "error", "cid": msg.get("cid"),
                          "error": repr(exc)})
        except (WebSocketClosed, OSError, json.JSONDecodeError):
            pass
        finally:
            for conn in conns.values():
                conn.disconnect()
            ws.close()

    def _handle_mux_frame(self, msg: dict, conns: Dict,
                          send) -> None:
        mtype = msg.get("type")
        if mtype == "connect_document":
            cid = msg.get("cid")
            tenant_id = msg.get("tenantId", "")
            document_id = msg.get("documentId", "")
            err = self._validate_ws_token(tenant_id, document_id,
                                          msg.get("token"))
            if err is not None:
                send({"type": "connect_error", "cid": cid, "error": err})
                return
            if cid in conns:
                send({"type": "connect_error", "cid": cid,
                      "error": "cid already connected"})
                return
            try:
                core = self.core(tenant_id)
                conn = core.connect(document_id, msg.get("client"))
            except Exception as exc:  # noqa: BLE001 — fail the handshake
                increment("alfred.connect_errors")
                # Answer with connect_error, not the generic error frame:
                # the client routes only connect_error/connected to the
                # pending handshake, so anything else leaves
                # connect_document blocked for its full timeout.
                send({"type": "connect_error", "cid": cid,
                      "error": repr(exc)})
                return
            conns[cid] = conn
            conn.on("op", lambda m, c=cid: send(
                {"type": "op", "cid": c,
                 "message": sequenced_message_to_dict(m)}))
            conn.on("nack", lambda n, c=cid: send(
                {"type": "nack", "cid": c, "nack": nack_to_dict(n)}))
            conn.on("signal", lambda s, c=cid: send(
                {"type": "signal", "cid": c,
                 "clientId": s.client_id, "content": s.content}))
            send({"type": "connected", "cid": cid,
                  "clientId": conn.client_id,
                  "sequenceNumber": core.sequence_number(document_id)})
            return
        cid = msg.get("cid")
        conn = conns.get(cid)
        if conn is None:
            send({"type": "error", "cid": cid,
                  "error": f"unknown cid {cid!r}"})
            return
        if mtype == "submitOp":
            messages = [document_message_from_dict(d)
                        for d in msg.get("messages", [])]
            oversized = _oversized_of(messages,
                                      self.core(conn.tenant_id)
                                      .max_op_bytes)
            if oversized is not None:
                send({"type": "nack", "cid": cid,
                      "nack": nack_to_dict(oversized)})
            else:
                with tracing.span(
                        "alfred.ingest",
                        parent=tracing.first_message_context(messages),
                        document=conn.document_id):
                    conn.submit(messages)
        elif mtype == "submitSignal":
            conn.submit_signal(msg.get("content"))
        elif mtype == "disconnect_document":
            conns.pop(cid).disconnect()
            send({"type": "document_disconnected", "cid": cid})
        else:
            send({"type": "error", "cid": cid,
                  "error": f"unknown message {mtype!r}"})


def _oversized_of(messages, limit: int):
    """Exact wire-side size screen: the Nack for the first message over
    the ceiling, or None when all fit (reference alfred maxMessageSize)."""
    from ..protocol.messages import (Nack, NackContent, NACK_TOO_LARGE,
                                     op_size_exact)
    if not limit:
        return None
    for m in messages:
        if op_size_exact(m) > limit:
            return Nack(m, -1, NackContent(
                NACK_TOO_LARGE, f"op exceeds {limit} bytes"))
    return None


def _error_payload(exc: urllib.error.HTTPError) -> dict:
    try:
        return json.loads(exc.read() or b"{}")
    except (ValueError, OSError):
        return {"error": f"historian HTTP {exc.code}"}


def _send_json(handler, status: int, payload: dict) -> None:
    body = json.dumps(payload).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _read_json(handler) -> Optional[dict]:
    length = int(handler.headers.get("Content-Length", 0))
    if not length:
        return None
    return json.loads(handler.rfile.read(length))


def _parse_query(query: str) -> Dict[str, str]:
    return {name: values[-1]
            for name, values in urllib.parse.parse_qs(query).items()}
