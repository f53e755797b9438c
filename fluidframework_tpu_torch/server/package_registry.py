"""Package registry service: versioned code-bundle delivery.

Capability parity with reference server/auspkn (the npm-registry proxy that
serves package bundles to the code loader / gateway): stores package
metadata + payloads per (name, version), serves version listings and
best-match resolution over REST, and backs `RegistryCodeResolver` — the
remote source a `CodeLoader` consults when a container's code details name
a package this process has not registered locally. The reference proxies
npm/Verdaccio; here bundles are JSON module manifests (this framework's
modules are in-process Python, so a "bundle" carries the entry-point spec
rather than JS sources).

A port of fluidframework_tpu's server/package_registry.py (host only).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..core.semver import parse_version, satisfies


class PackageStore:
    """In-memory versioned package store (auspkn's npm-backed store role)."""

    def __init__(self):
        self._packages: Dict[str, Dict[str, dict]] = {}
        self._lock = threading.Lock()

    def publish(self, name: str, version: str, manifest: dict) -> None:
        with self._lock:
            versions = self._packages.setdefault(name, {})
            if version in versions:
                raise ValueError(f"{name}@{version} already published")
            versions[version] = dict(manifest)

    def versions(self, name: str) -> List[str]:
        with self._lock:
            return sorted(self._packages.get(name, {}),
                          key=parse_version)

    def resolve(self, name: str, spec: str = "*") -> Optional[dict]:
        with self._lock:
            versions = self._packages.get(name, {})
            matching = [v for v in versions if satisfies(v, spec)]
            if not matching:
                return None
            best = max(matching, key=parse_version)
            return {"name": name, "version": best,
                    "manifest": versions[best]}


class PackageRegistryService:
    """REST front (reference auspkn routes /:package/:version paths):
    GET /packages/<name>            -> {"versions": [...]}
    GET /packages/<name>/<spec>     -> best-match {"name","version","manifest"}
    POST /packages/<name>/<version> -> publish (json body = manifest)
    """

    def __init__(self, store: Optional[PackageStore] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store or PackageStore()
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                service._route(self, "GET")

            def do_POST(self):
                service._route(self, "POST")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PackageRegistryService":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="package-registry", daemon=True)
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

    def _route(self, handler, method: str) -> None:
        parts = [urllib.parse.unquote(p) for p in
                 handler.path.partition("?")[0].split("/") if p]
        try:
            if len(parts) >= 2 and parts[0] == "packages":
                name = parts[1]
                if method == "GET" and len(parts) == 2:
                    return _send(handler, 200,
                                 {"versions": self.store.versions(name)})
                if method == "GET" and len(parts) == 3:
                    resolved = self.store.resolve(name, parts[2])
                    if resolved is None:
                        return _send(handler, 404,
                                     {"error": f"no match {name}@{parts[2]}"})
                    return _send(handler, 200, resolved)
                if method == "POST" and len(parts) == 3:
                    length = int(handler.headers.get("Content-Length", 0))
                    raw = handler.rfile.read(length) if length else b""
                    try:
                        manifest = json.loads(raw) if raw else {}
                    except json.JSONDecodeError as exc:
                        return _send(handler, 400,
                                     {"error": f"malformed body: {exc}"})
                    self.store.publish(name, parts[2], manifest)
                    return _send(handler, 201, {"published":
                                                f"{name}@{parts[2]}"})
            _send(handler, 404, {"error": f"no route {handler.path}"})
        except ValueError as exc:
            _send(handler, 409, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — route bug -> 500
            _send(handler, 500, {"error": repr(exc)})


def _send(handler, status: int, payload: dict) -> None:
    body = json.dumps(payload).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class RegistryCodeResolver:
    """Client-side resolver: fetch best-match manifests from a registry and
    materialize them into a CodeLoader via a manifest interpreter
    (reference: the gateway resolves code details through auspkn before
    instantiating the runtime). `interpreter(manifest) -> runtime_factory`
    maps the served bundle spec onto an in-process factory."""

    def __init__(self, registry_url: str, interpreter):
        self.registry_url = registry_url.rstrip("/")
        self.interpreter = interpreter

    def fetch(self, name: str, spec: str = "*") -> dict:
        url = (f"{self.registry_url}/packages/"
               f"{urllib.parse.quote(name, safe='')}/"
               f"{urllib.parse.quote(spec, safe='')}")
        try:
            with urllib.request.urlopen(url) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as err:
            if err.code == 404:
                raise KeyError(f"no registry match {name}@{spec}") from err
            raise

    def install_into(self, code_loader, name: str, spec: str = "*") -> str:
        """Fetch + register; returns the concrete version installed."""
        resolved = self.fetch(name, spec)
        code_loader.register(resolved["name"], resolved["version"],
                             self.interpreter(resolved["manifest"]))
        return resolved["version"]
