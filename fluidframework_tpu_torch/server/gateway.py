"""Gateway: an example host service serving documents over HTTP.

Capability parity with reference server/gateway (3,410 LoC: a web host
that loads Fluid containers server-side and serves loader pages wired to
the ordering service): this gateway loads real containers through any
driver factory, renders document state (generic DDS dump, or the data
object's own view via ViewAdapter when it provides one), and serves it as
JSON — the loader-page analog for a DOM-less host. Documents stay resident
(live against the service) between requests, so successive GETs observe
remote edits.

A port of fluidframework_tpu's server/gateway.py. It serves the
containers of the Loader it is given, on that loader's device.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..loader.container import Container, Loader
from ..telemetry.counters import record_swallow


def _dump_channel(channel) -> dict:
    """Generic DDS state dump for rendering (feature-probed)."""
    out: dict = {"type": getattr(channel, "TYPE", "unknown")}
    if hasattr(channel, "get_text"):
        try:
            out["text"] = channel.get_text()
            return out
        except TypeError:
            pass
    if hasattr(channel, "get_items"):
        out["items"] = channel.get_items()
        return out
    if hasattr(channel, "keys"):
        try:
            out["entries"] = {k: channel.get(k) for k in channel.keys()}
            return out
        except Exception:  # noqa: BLE001 — duck-typed channel probe
            # Not actually map-shaped (keys() lied): fall through to the
            # value probe. Counted — a climbing rate means a DDS type is
            # rendering wrong in every gateway dump, not an odd one-off.
            record_swallow("gateway.channel_probe")
    if hasattr(channel, "value"):
        out["value"] = channel.value
    return out


class GatewayService:
    def __init__(self, loader: Loader, host: str = "127.0.0.1",
                 port: int = 0):
        self.loader = loader
        self.containers: Dict[str, Container] = {}
        self._adapters: Dict[tuple, object] = {}  # (doc, path) -> ViewAdapter
        self._lock = threading.Lock()
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                service._route(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GatewayService":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="gateway", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        with self._lock:
            for container in self.containers.values():
                container.close()
            self.containers.clear()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- document residency -------------------------------------------------
    def _container(self, doc_id: str) -> Container:
        with self._lock:
            if doc_id not in self.containers:
                self.containers[doc_id] = self.loader.resolve(doc_id)
            return self.containers[doc_id]

    # -- routes -------------------------------------------------------------
    _DOC = re.compile(r"^/doc/(?P<doc>[^/]+)$")
    _OBJ = re.compile(r"^/doc/(?P<doc>[^/]+)/view(?P<path>/.*)?$")

    def _route(self, handler) -> None:
        path = urllib.parse.unquote(handler.path.partition("?")[0])
        try:
            if path == "/health":
                with self._lock:
                    resident = len(self.containers)
                return _send(handler, 200, {"ok": True,
                                            "resident": resident})
            m = self._DOC.match(path)
            if m:
                return self._serve_document(handler, m.group("doc"))
            m = self._OBJ.match(path)
            if m:
                return self._serve_view(handler, m.group("doc"),
                                        m.group("path") or "/")
            _send(handler, 404, {"error": f"no route {path}"})
        except FileNotFoundError:
            _send(handler, 404, {"error": f"unknown document {path}"})
        except Exception as exc:  # noqa: BLE001 — route bug -> 500
            _send(handler, 500, {"error": repr(exc)})

    def _serve_document(self, handler, doc_id: str) -> None:
        container = self._container(doc_id)
        with container.op_lock:
            stores = {
                store_id: {cid: _dump_channel(ch)
                           for cid, ch in store.channels.items()}
                for store_id, store in container.runtime.datastores.items()}
            _send(handler, 200, {
                "documentId": doc_id,
                "sequenceNumber": container.protocol.sequence_number,
                "dataStores": stores,
            })

    def _serve_view(self, handler, doc_id: str, path: str) -> None:
        """Render through the code-loaded data object's own view surface.
        One adapter per (doc, path) — adapters subscribe to channel events
        for their lifetime, so per-request adapters would leak listeners on
        the resident container."""
        from ..framework.views import ViewAdapter
        container = self._container(doc_id)
        with self._lock:
            adapter = self._adapters.get((doc_id, path))
            if adapter is None:
                adapter = ViewAdapter(container.request(path))
                self._adapters[(doc_id, path)] = adapter
        frames = []
        adapter.mount(frames.append)
        adapter.unmount()
        _send(handler, 200, {"documentId": doc_id, "view": frames[-1]})


def _send(handler, status: int, payload: dict) -> None:
    body = json.dumps(payload).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
