"""Historian: the standalone summary-cache tier between serving and GitStore.

Capability parity with reference server/historian (README:1-4): a caching
proxy that sits between clients/lambda hosts and the git-shaped storage
tier, so summary reads scale with the cache instead of with gitrest. The
reference fronts gitrest with Redis; here the tier is its own process
(`python -m fluidframework_tpu_torch.server.historian`, or the `historian`
service of server/main.py) over the O(1) LRU+TTL policy in
server/cache.py.

Two backing modes, one behavior:
  - proxy mode (`upstream_url`): git objects fetch over alfred's gitrest
    routes (server/alfred.py `/repos/.../git/objects/<sha>`), with the
    caller's bearer token forwarded so alfred keeps enforcing auth. The
    `X-Historian-Tier` header marks tier-originated requests so an alfred
    configured to DELEGATE reads to this historian never loops.
  - store mode (`store=`): objects read straight from a (usually
    file-backed, server/durable.py FileHistorian) store shared with the
    lambda workers — the multi-process deployment shape.

Correctness model: git objects are content-addressed and immutable, so the
sha-keyed object cache never needs invalidation; only refs are mutable.
Refs ride a short-TTL pointer cache that is explicitly invalidated on
every summary commit that flows through the tier (write-through), and the
TTL bounds staleness for writers that bypass it (scribe acks in another
process). A summary upload also WARMS the cache: the new commit's tree and
blobs prefetch immediately, so the next container load is all hits.

Consumers: loader/drivers/routerlicious.py (`historian_url=`) serves
second-and-later container loads from this cache and degrades to direct
alfred/GitStore reads if the tier dies mid-load; server/alfred.py
delegates its latest-summary route here when configured; server/monitor.py
`watch_historian` exports the hit/miss/bytes/evictions counters.

A port of fluidframework_tpu's server/historian.py (host only) over this
package's cache.py, readpath.py and telemetry/logger.py.
"""

from __future__ import annotations

import base64
import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from ..protocol.summary import summary_tree_from_dict
from ..telemetry import tracing
from ..telemetry.counters import increment, record_swallow
from ..telemetry.logger import PerformanceEvent, TelemetryLogger
from .cache import LruTtlCache
from .readpath import CatchupCache
from .storage import GitBlob, GitCommit, GitTree, Historian

# Marks tier-originated upstream requests; alfred serves them directly
# from its GitStore instead of delegating back here (loop prevention).
TIER_HEADER = "X-Historian-Tier"


class SummaryConflict(Exception):
    """Initial summary for a document that already has a load target."""


class UpstreamError(Exception):
    """Non-404 HTTP failure from the upstream git storage."""

    def __init__(self, status: int, detail: str):
        super().__init__(f"upstream HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


def git_object_to_wire(obj) -> Dict[str, Any]:
    """Typed JSON encoding of a git object (the gitrest wire shape)."""
    if isinstance(obj, GitBlob):
        return {"kind": "blob", "sha": obj.sha,
                "content": base64.b64encode(obj.content).decode("ascii"),
                "size": len(obj.content), "encoding": "base64"}
    if isinstance(obj, GitTree):
        return {"kind": "tree", "sha": obj.sha,
                "entries": {name: list(pair)
                            for name, pair in obj.entries.items()}}
    if isinstance(obj, GitCommit):
        return {"kind": "commit", "sha": obj.sha, "tree": obj.tree_sha,
                "parents": list(obj.parents), "message": obj.message,
                "timestamp": obj.timestamp}
    raise TypeError(f"not a git object: {type(obj)!r}")


def _wire_nbytes(wire: Dict[str, Any]) -> int:
    if wire.get("kind") == "blob":
        return len(wire.get("content", "")) + 96
    return len(json.dumps(wire))


def _request(method: str, url: str, token: Optional[str] = None,
             body: Optional[dict] = None, timeout: float = 30.0) -> dict:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    req.add_header(TIER_HEADER, "1")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _q(segment: str) -> str:
    return urllib.parse.quote(str(segment), safe="")


def notify_summary_commit(historian_url: str, tenant_id: str,
                          document_id: str, sha: Optional[str] = None,
                          ref: str = "main", timeout: float = 5.0) -> bool:
    """Best-effort commit notification to a historian process: invalidate
    the (tenant, doc, ref) pointer and warm-prefetch `sha`. Callers treat
    a dead historian as fine — the tier's ref TTL bounds staleness."""
    try:
        _request("POST", historian_url.rstrip("/")
                 + f"/historian/invalidate/{_q(tenant_id)}/{_q(document_id)}",
                 body={"sha": sha, "ref": ref}, timeout=timeout)
        return True
    except (OSError, ValueError):
        return False


def notify_catchup_refresh(historian_url: str, tenant_id: str,
                           document_id: str, artifact: dict,
                           token: Optional[str] = None,
                           timeout: float = 5.0) -> bool:
    """Best-effort catch-up artifact push to a historian process (the
    refresh-epoch analog of notify_summary_commit). A dead historian is
    fine — its stale artifact still adopts correctly (residue replay),
    and the next successful push replaces it."""
    try:
        url = (historian_url.rstrip("/")
               + f"/historian/catchup/{_q(tenant_id)}/{_q(document_id)}")
        _request("POST", url, token=token, body=artifact, timeout=timeout)
        return True
    except (OSError, ValueError):
        return False


class StoreUpstream:
    """Direct access to a (shared, usually file-backed) Historian store —
    the deployment mode where the tier and the lambda workers mount the
    same git directory. Auth is the deployer's network boundary here, as
    for the reference's internal gitrest."""

    def __init__(self, historian: Historian):
        self.historian = historian

    def get_object(self, tenant_id: str, document_id: str, sha: str,
                   token: Optional[str] = None) -> Optional[dict]:
        obj = self.historian.store(tenant_id, document_id).get(sha)
        return None if obj is None else git_object_to_wire(obj)

    def get_ref(self, tenant_id: str, document_id: str, ref: str,
                token: Optional[str] = None) -> Optional[str]:
        return self.historian.store(tenant_id, document_id).get_ref(ref)

    def upload_summary(self, tenant_id: str, document_id: str, body: dict,
                       token: Optional[str] = None) -> str:
        store = self.historian.store(tenant_id, document_id)
        initial = bool(body.get("initial"))
        if initial and store.get_ref("main") is not None:
            raise SummaryConflict(f"document {document_id!r} exists")
        tree = summary_tree_from_dict(body["summary"])
        return store.write_summary(tree, base_commit=body.get("parent"),
                                   advance_ref=initial)


class RestUpstream:
    """Upstream over alfred's gitrest REST routes (proxy mode). The
    caller's bearer token forwards per request so alfred's riddler
    validation still gates every object read."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str, token: Optional[str]) -> Optional[dict]:
        try:
            return _request("GET", self.base_url + path, token,
                            timeout=self.timeout)
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            raise UpstreamError(exc.code,
                                exc.read().decode(errors="replace")) from exc

    def get_object(self, tenant_id: str, document_id: str, sha: str,
                   token: Optional[str] = None) -> Optional[dict]:
        return self._get(f"/repos/{_q(tenant_id)}/{_q(document_id)}"
                         f"/git/objects/{_q(sha)}", token)

    def get_ref(self, tenant_id: str, document_id: str, ref: str,
                token: Optional[str] = None) -> Optional[str]:
        data = self._get(f"/repos/{_q(tenant_id)}/{_q(document_id)}"
                         f"/git/refs/{_q(ref)}", token)
        return data["sha"] if data else None

    def upload_summary(self, tenant_id: str, document_id: str, body: dict,
                       token: Optional[str] = None) -> str:
        try:
            return _request(
                "POST",
                self.base_url
                + f"/repos/{_q(tenant_id)}/{_q(document_id)}/summaries",
                token, body, timeout=self.timeout)["sha"]
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")
            if exc.code == 409:
                raise SummaryConflict(detail) from exc
            raise UpstreamError(exc.code, detail) from exc


class HistorianTier:
    """The cache tier itself (embeddable; HistorianService adds HTTP).

    Per-request work is O(objects served), each object O(1) through the
    cache: one short-TTL ref lookup, then a walk of immutable sha-keyed
    entries. Summary commits through the tier invalidate the ref pointer
    and prefetch the new tree (warm-on-summary)."""

    def __init__(self, upstream, max_bytes: int = 256 * 1024 * 1024,
                 max_entries: int = 65536, ref_ttl_s: float = 2.0,
                 auth_ttl_s: float = 60.0,
                 logger: Optional[TelemetryLogger] = None,
                 metrics=None):
        self.upstream = upstream
        self.objects = LruTtlCache(max_entries=max_entries,
                                   max_bytes=max_bytes, ttl_s=None)
        self.refs = LruTtlCache(max_entries=4096, ttl_s=ref_ttl_s)
        # Token-authorization cache (the reference historian validates
        # tokens against riddler and caches the verdict): a (tenant, doc,
        # token) triple must prove itself upstream once per TTL window
        # before CACHED entries serve — otherwise a cache hit would skip
        # the auth check a cold read performs. Store mode's upstream
        # never rejects, making this a no-op in the trusted-network
        # deployment shape.
        self.auth = LruTtlCache(max_entries=4096, ttl_s=auth_ttl_s)
        # Read-path catch-up delta blobs (server/readpath.py): published
        # by the serving tier on refresh epochs (write-through — a
        # publish IS the invalidation: put_if_newer replaces the stale
        # artifact atomically), served beside the summary in one round
        # trip by the `/catchup` route.
        self.catchup = CatchupCache()
        self.logger = logger
        self.metrics = metrics
        self.upstream_fetches = 0
        self.prefetched_objects = 0
        self.prefetch_shared_trees = 0
        self.summary_reads = 0
        self.summary_writes = 0
        self.invalidations = 0

    # -- object/ref reads --------------------------------------------------
    def get_object(self, tenant_id: str, document_id: str, sha: str,
                   token: Optional[str] = None) -> Optional[dict]:
        """Content-addressed read-through. Shas are shareable across
        documents (same rationale as storage.Historian.get_cached): a sha
        uniquely names its bytes."""
        wire = self.objects.get(sha)
        if wire is not None:
            return wire
        wire = self.upstream.get_object(tenant_id, document_id, sha, token)
        self.upstream_fetches += 1
        if wire is not None:
            self.objects.put(sha, wire, nbytes=_wire_nbytes(wire))
        return wire

    def get_ref(self, tenant_id: str, document_id: str, ref: str = "main",
                token: Optional[str] = None) -> Optional[str]:
        key = (tenant_id, document_id, ref)
        if self.auth.get((tenant_id, document_id, token)):
            sha = self.refs.get(key)
            if sha is not None:
                return sha
        sha = self.upstream.get_ref(tenant_id, document_id, ref, token)
        self.upstream_fetches += 1
        # Reaching here without an auth error (401/403 raise) proves the
        # token for this document — a 404 (no ref) is still authorized.
        self.auth.put((tenant_id, document_id, token), True)
        if sha is not None:
            self.refs.put(key, sha, nbytes=len(sha))
        return sha

    def ensure_authorized(self, tenant_id: str, document_id: str,
                          token: Optional[str] = None) -> None:
        """Gate for cache-served requests that would otherwise never
        touch upstream (explicit-sha reads, object routes): one cheap
        upstream ref probe per (tenant, doc, token) per auth-TTL window.
        Raises UpstreamError on a rejected token (proxy mode)."""
        if self.auth.get((tenant_id, document_id, token)):
            return
        self.upstream.get_ref(tenant_id, document_id, "main", token)
        self.upstream_fetches += 1
        self.auth.put((tenant_id, document_id, token), True)

    # -- composite reads ---------------------------------------------------
    def read_summary_dict(self, tenant_id: str, document_id: str,
                          commit_sha: Optional[str] = None,
                          ref: str = "main",
                          token: Optional[str] = None) -> Optional[dict]:
        """The drivers' summary download: the full tree in
        summary_tree_to_dict wire form, every object through the cache."""
        # Tail attribution for loads: the read joins the requesting op's
        # trace when the ambient context carries one; the histogram feeds
        # /metrics.prom either way.
        with tracing.span("historian.read_summary",
                          hist="historian.read_summary",
                          document=document_id) as sp:
            if commit_sha is not None:
                self.ensure_authorized(tenant_id, document_id, token)
            sha = commit_sha or self.get_ref(tenant_id, document_id, ref,
                                             token)
            if sha is None:
                return None
            commit = self.get_object(tenant_id, document_id, sha, token)
            if commit is None or commit.get("kind") != "commit":
                return None
            self.summary_reads += 1
            sp.set(sha=sha)
            return self._tree_dict(tenant_id, document_id, commit["tree"],
                                   token)

    def _tree_dict(self, tenant_id: str, document_id: str, tree_sha: str,
                   token: Optional[str]) -> dict:
        tree = self.get_object(tenant_id, document_id, tree_sha, token)
        if tree is None or tree.get("kind") != "tree":
            raise KeyError(f"missing tree object {tree_sha!r}")
        entries: Dict[str, Any] = {}
        for name, (kind, sha) in tree["entries"].items():
            if kind == "blob":
                blob = self.get_object(tenant_id, document_id, sha, token)
                if blob is None or blob.get("kind") != "blob":
                    raise KeyError(f"missing blob object {sha!r}")
                raw = base64.b64decode(blob["content"])
                try:
                    entries[name] = {"type": "blob",
                                     "content": raw.decode(),
                                     "encoding": "utf-8"}
                except UnicodeDecodeError:
                    entries[name] = {"type": "blob", "content": raw.hex(),
                                     "encoding": "hex"}
            else:
                entries[name] = self._tree_dict(tenant_id, document_id,
                                                sha, token)
        return {"type": "tree", "entries": entries}

    def versions(self, tenant_id: str, document_id: str, count: int = 1,
                 token: Optional[str] = None) -> List[str]:
        """Commit-chain walk: one ref lookup, then immutable commits out
        of the object cache."""
        out: List[str] = []
        sha = self.get_ref(tenant_id, document_id, "main", token)
        while sha and len(out) < count:
            out.append(sha)
            commit = self.get_object(tenant_id, document_id, sha, token)
            if commit is None or commit.get("kind") != "commit":
                break
            parents = commit.get("parents") or []
            sha = parents[0] if parents else None
        return out

    # -- read-path catch-up (docs/read_path.md) ----------------------------
    def publish_catchup(self, tenant_id: str, document_id: str,
                        artifact: dict) -> bool:
        """Write-through artifact publish from the serving tier (the
        refresh-epoch push, same hook shape as summary-commit
        invalidation). put_if_newer semantics: a racing older publish
        never regresses the served artifact."""
        return self.catchup.publish(tenant_id, document_id, artifact)

    def read_catchup(self, tenant_id: str, document_id: str,
                     token: Optional[str] = None,
                     artifact_only: bool = False) -> dict:
        """`summary + delta` in one request: the artifact (when present)
        plus the summary tree of exactly the commit the artifact was
        published against — both halves cache-served, so a warm
        connecting client costs this tier zero upstream traffic."""
        # The artifact IS full document content: cache-served requests
        # must prove their token exactly like the object routes do (the
        # artifact-only path would otherwise never touch upstream).
        self.ensure_authorized(tenant_id, document_id, token)
        artifact = self.catchup.get(tenant_id, document_id)
        out: Dict[str, Any] = {"catchup": artifact}
        if artifact_only:
            return out
        sha = (artifact or {}).get("summarySha")
        out["summary"] = self.read_summary_dict(
            tenant_id, document_id, commit_sha=sha, token=token)
        return out

    # -- writes + invalidation ---------------------------------------------
    def upload_summary(self, tenant_id: str, document_id: str, body: dict,
                       token: Optional[str] = None) -> str:
        """Write-through: the commit lands upstream first, then the ref
        pointer invalidates and the new tree prefetches (warm-on-summary),
        so a concurrent load never sees the cache ahead of storage."""
        sha = self.upstream.upload_summary(tenant_id, document_id, body,
                                           token)
        self.summary_writes += 1
        if self.metrics is not None:
            self.metrics.increment("historian.summaryWrites")
        self.handle_summary_commit(tenant_id, document_id, sha=sha,
                                   token=token)
        return sha

    def handle_summary_commit(self, tenant_id: str, document_id: str,
                              sha: Optional[str] = None, ref: str = "main",
                              token: Optional[str] = None,
                              prefetch: bool = True) -> None:
        """Invalidate the mutable pointer for (tenant, doc, ref) and warm
        the cache with the new commit's objects. Also the target of
        alfred's commit notifications (scribe acks)."""
        self.refs.invalidate((tenant_id, document_id, ref))
        self.invalidations += 1
        if self.metrics is not None:
            self.metrics.increment("historian.invalidations")
        if self.logger is not None:
            self.logger.send_telemetry_event({
                "eventName": "HistorianInvalidate", "tenantId": tenant_id,
                "documentId": document_id, "ref": ref})
        if prefetch and sha:
            self._prefetch(tenant_id, document_id, sha, token)

    def _prefetch(self, tenant_id: str, document_id: str, sha: str,
                  token: Optional[str]) -> None:
        """Best-effort walk of commit -> tree -> blobs into the cache."""
        before = self.objects.puts
        event = (PerformanceEvent.timed_event(
            self.logger, {"eventName": "HistorianPrefetch",
                          "documentId": document_id})
            if self.logger is not None else None)
        with tracing.span("historian.prefetch", hist="historian.prefetch",
                          document=document_id) as sp:
            try:
                commit = self.get_object(tenant_id, document_id, sha, token)
                if commit is not None and commit.get("kind") == "commit":
                    self._prefetch_tree(tenant_id, document_id,
                                        commit["tree"], token)
            except Exception as exc:  # noqa: BLE001 — warmup must never fail a write
                if self.metrics is not None:
                    self.metrics.increment("historian.prefetchFailures")
                record_swallow("historian.prefetch")
                sp.set(error=True)
                if event is not None:
                    event.cancel(error=exc)
                return
            loaded = self.objects.puts - before
            self.prefetched_objects += loaded
            sp.set(objects=loaded)
            if self.metrics is not None:
                self.metrics.increment("historian.prefetchedObjects",
                                       loaded)
            if event is not None:
                event.end({"objects": loaded})

    def _prefetch_tree(self, tenant_id: str, document_id: str,
                       tree_sha: str, token: Optional[str]) -> None:
        # Incremental summaries share unchanged subtrees with the parent
        # commit (clean channels ride as handles / identical shas), and
        # the object cache keys by BARE sha (content-addressed — see
        # get_object), so a shared subtree's walk is all cache hits:
        # upstream prefetch traffic scales with the CHANGED set. The
        # descent itself is NOT skipped on a cached tree sha — a blob
        # evicted under a still-cached tree must re-warm, or eviction
        # would silently break warm-on-summary forever. Shared subtrees
        # are counted (prefetchSharedTrees) so operators can see the
        # incremental sharing rate.
        shared = self.objects.contains(tree_sha)
        tree = self.get_object(tenant_id, document_id, tree_sha, token)
        if tree is None or tree.get("kind") != "tree":
            return
        if shared:
            self.prefetch_shared_trees += 1
            if self.metrics is not None:
                self.metrics.increment("historian.prefetchSharedTrees")
        for _, (kind, sha) in tree["entries"].items():
            if kind == "tree":
                self._prefetch_tree(tenant_id, document_id, sha, token)
            else:
                self.get_object(tenant_id, document_id, sha, token)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "objects": self.objects.stats(),
            "refs": self.refs.stats(),
            "auth": self.auth.stats(),
            "catchup": self.catchup.stats(),
            "upstreamFetches": self.upstream_fetches,
            "prefetchedObjects": self.prefetched_objects,
            "prefetchSharedTrees": self.prefetch_shared_trees,
            "summaryReads": self.summary_reads,
            "summaryWrites": self.summary_writes,
            "invalidations": self.invalidations,
        }


class HistorianService:
    """The standalone historian process: HistorianTier behind HTTP, route
    shapes matching alfred's git surface so drivers can point their
    storage endpoint here unchanged."""

    _ROUTES = [
        ("GET", re.compile(r"^/api/v1/ping$"), "_r_ping"),
        ("GET", re.compile(r"^/historian/stats$"), "_r_stats"),
        ("POST", re.compile(
            r"^/historian/invalidate/(?P<tenant>[^/]+)/(?P<doc>[^/]+)$"),
         "_r_invalidate"),
        ("POST", re.compile(
            r"^/historian/catchup/(?P<tenant>[^/]+)/(?P<doc>[^/]+)$"),
         "_r_publish_catchup"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/catchup$"),
         "_r_catchup"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/summaries/latest$"),
         "_r_latest_summary"),
        ("POST", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/summaries$"),
         "_r_upload_summary"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)/versions$"),
         "_r_versions"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/objects/(?P<sha>[^/]+)$"),
         "_r_object"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/blobs/(?P<sha>[^/]+)$"),
         "_r_blob"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/trees/(?P<sha>[^/]+)$"),
         "_r_tree"),
        ("GET", re.compile(
            r"^/repos/(?P<tenant>[^/]+)/(?P<doc>[^/]+)"
            r"/git/refs/(?P<ref>.+)$"),
         "_r_ref"),
    ]

    def __init__(self, upstream_url: Optional[str] = None,
                 store: Optional[Historian] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_bytes: int = 256 * 1024 * 1024,
                 ref_ttl_s: float = 2.0,
                 logger: Optional[TelemetryLogger] = None,
                 metrics=None):
        if (upstream_url is None) == (store is None):
            raise ValueError(
                "exactly one of upstream_url (proxy mode) or store "
                "(shared-storage mode) is required")
        upstream = (RestUpstream(upstream_url) if upstream_url is not None
                    else StoreUpstream(store))
        self.tier = HistorianTier(upstream, max_bytes=max_bytes,
                                  ref_ttl_s=ref_ttl_s, logger=logger,
                                  metrics=metrics)
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                service._handle(self, "GET")

            def do_POST(self):
                service._handle(self, "POST")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HistorianService":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="historian", daemon=True)
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

    def stats(self) -> dict:
        return self.tier.stats()

    # -- dispatch ----------------------------------------------------------
    def _handle(self, handler, method: str) -> None:
        path, _, query = handler.path.partition("?")
        params = {name: values[-1] for name, values
                  in urllib.parse.parse_qs(query).items()}
        for route_method, pattern, name in self._ROUTES:
            if route_method != method:
                continue
            m = pattern.match(path)
            if m:
                groups = {k: urllib.parse.unquote(v)
                          for k, v in m.groupdict().items()}
                try:
                    getattr(self, name)(handler, params, **groups)
                except BrokenPipeError:
                    pass
                except SummaryConflict as exc:
                    _send_json(handler, 409, {"error": str(exc)})
                except UpstreamError as exc:
                    _send_json(handler, exc.status, {"error": exc.detail})
                except OSError as exc:
                    # Upstream unreachable: 503 tells callers to use their
                    # direct-GitStore fallback path.
                    _send_json(handler, 503, {"error": repr(exc)})
                except Exception as exc:  # noqa: BLE001 — route bug
                    increment("historian.route_errors")
                    try:
                        _send_json(handler, 500, {"error": repr(exc)})
                    except OSError:  # reply socket died mid-error
                        record_swallow("historian.route_reply")
                return
        _send_json(handler, 404, {"error": f"no route {method} {path}"})

    @staticmethod
    def _token(handler) -> Optional[str]:
        auth = handler.headers.get("Authorization", "")
        return auth[len("Bearer "):] if auth.startswith("Bearer ") else None

    # -- routes ------------------------------------------------------------
    def _r_ping(self, handler, params) -> None:
        _send_json(handler, 200, {"ok": True, "service": "historian"})

    def _r_stats(self, handler, params) -> None:
        _send_json(handler, 200, self.tier.stats())

    def _r_invalidate(self, handler, params, tenant: str, doc: str) -> None:
        body = _read_json(handler) or {}
        token = self._token(handler)
        self.tier.handle_summary_commit(
            tenant, doc, sha=body.get("sha"), ref=body.get("ref", "main"),
            token=token, prefetch=False)
        # Respond BEFORE the warm prefetch: notifiers (scribe's on_commit,
        # alfred's upload route) must not block on a whole-tree walk —
        # invalidation alone is what correctness needs. The prefetch then
        # runs on this handler thread with the response already on the
        # wire, and only for callers the upstream authorizes (otherwise
        # an unauthenticated invalidate would be a cache-bust DoS with
        # an upstream-fetch amplifier attached).
        _send_json(handler, 200, {"ok": True})
        sha = body.get("sha")
        if not sha:
            return
        try:
            self.tier.ensure_authorized(tenant, doc, token)
        except (UpstreamError, OSError):
            # Unauthorized (or upstream unreachable): the invalidate above
            # already happened — correctness holds — we only skip the warm
            # prefetch. Counted: a climbing rate means notifiers are
            # sending dead tokens and every reload is a cold miss.
            record_swallow("historian.unauthorized_prefetch")
            return
        except Exception:  # noqa: BLE001 — response already committed
            # The 200 is already on the wire (keep-alive socket): anything
            # escaping here would reach the route dispatcher and write a
            # SECOND response, desyncing the notifier's connection. E.g. a
            # malformed upstream body raises JSONDecodeError out of the
            # proxy-mode auth probe.
            record_swallow("historian.invalidate_prefetch_guard")
            return
        self.tier._prefetch(tenant, doc, sha, token)

    def _r_publish_catchup(self, handler, params, tenant: str,
                           doc: str) -> None:
        """Serving-tier artifact push (write-through). The body is
        arbitrary caller-supplied document state, so a READ token must
        not suffice (any subscriber holds one — a crafted high-seq
        artifact would poison every later connecting client): the
        publish requires the tier marker header, the same
        inside-the-service-boundary trust line the reference draws for
        internal gitrest traffic, ON TOP of upstream authorization."""
        body = _read_json(handler)
        token = self._token(handler)
        if not isinstance(body, dict) or "seq" not in body:
            _send_json(handler, 400, {"error": "not a catch-up artifact"})
            return
        if not handler.headers.get(TIER_HEADER):
            _send_json(handler, 403,
                       {"error": "catch-up publishes are serving-tier "
                                 "internal (missing tier marker)"})
            return
        self.tier.ensure_authorized(tenant, doc, token)
        wrote = self.tier.publish_catchup(tenant, doc, body)
        _send_json(handler, 200, {"ok": True, "published": wrote})

    def _r_catchup(self, handler, params, tenant: str, doc: str) -> None:
        out = self.tier.read_catchup(
            tenant, doc, token=self._token(handler),
            artifact_only=bool(params.get("artifactOnly")))
        if out.get("summary") is None and out.get("catchup") is None:
            _send_json(handler, 404, {"error": "no summary"})
            return
        _send_json(handler, 200, out)

    def _r_latest_summary(self, handler, params, tenant: str,
                          doc: str) -> None:
        tree = self.tier.read_summary_dict(
            tenant, doc, commit_sha=params.get("sha"),
            token=self._token(handler))
        if tree is None:
            _send_json(handler, 404, {"error": "no summary"})
            return
        _send_json(handler, 200, {"summary": tree})

    def _r_upload_summary(self, handler, params, tenant: str,
                          doc: str) -> None:
        body = _read_json(handler) or {}
        sha = self.tier.upload_summary(tenant, doc, body,
                                       token=self._token(handler))
        _send_json(handler, 201, {"sha": sha})

    def _r_versions(self, handler, params, tenant: str, doc: str) -> None:
        count = int(params.get("count", 1))
        _send_json(handler, 200, {"versions": self.tier.versions(
            tenant, doc, count, token=self._token(handler))})

    def _r_object(self, handler, params, tenant: str, doc: str,
                  sha: str) -> None:
        self._send_object(handler, tenant, doc, sha, kind=None)

    def _r_blob(self, handler, params, tenant: str, doc: str,
                sha: str) -> None:
        self._send_object(handler, tenant, doc, sha, kind="blob")

    def _r_tree(self, handler, params, tenant: str, doc: str,
                sha: str) -> None:
        self._send_object(handler, tenant, doc, sha, kind="tree")

    def _send_object(self, handler, tenant: str, doc: str, sha: str,
                     kind: Optional[str]) -> None:
        token = self._token(handler)
        self.tier.ensure_authorized(tenant, doc, token)
        wire = self.tier.get_object(tenant, doc, sha, token=token)
        if wire is None or (kind is not None and wire.get("kind") != kind):
            _send_json(handler, 404, {"error": f"no {kind or 'object'} "
                                               f"{sha!r}"})
            return
        _send_json(handler, 200, wire)

    def _r_ref(self, handler, params, tenant: str, doc: str,
               ref: str) -> None:
        sha = self.tier.get_ref(tenant, doc, ref,
                                token=self._token(handler))
        if sha is None:
            _send_json(handler, 404, {"error": f"no ref {ref!r}"})
            return
        _send_json(handler, 200, {"ref": ref, "sha": sha})


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


def main(argv=None) -> None:
    """Standalone entry: `python -m fluidframework_tpu_torch.server.historian
    --upstream http://alfred:PORT` (proxy mode) or `--git var/git`
    (shared-storage mode)."""
    import argparse

    from .main import _wait_for_signal

    parser = argparse.ArgumentParser(
        prog="fluidframework_tpu_torch.server.historian",
        description="Run the standalone summary-cache tier")
    parser.add_argument("--upstream", default=None,
                        help="alfred base URL (proxy mode)")
    parser.add_argument("--git", default=None,
                        help="shared git storage dir (store mode)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7081)
    parser.add_argument("--ref-ttl", type=float, default=2.0)
    parser.add_argument("--max-bytes", type=int, default=256 * 1024 * 1024)
    parser.add_argument("--monitor-port", type=int, default=0,
                        help="serve /health + /metrics here (0 = off)")
    args = parser.parse_args(argv)
    if (args.upstream is None) == (args.git is None):
        parser.error("exactly one of --upstream or --git is required")
    store = None
    if args.git is not None:
        from .durable import FileHistorian
        store = FileHistorian(args.git)
    service = HistorianService(upstream_url=args.upstream, store=store,
                               host=args.host, port=args.port,
                               max_bytes=args.max_bytes,
                               ref_ttl_s=args.ref_ttl)
    service.start()
    print(f"historian: serving cache tier on {service.url} "
          f"({'proxy' if args.upstream else 'store'} mode)", flush=True)
    monitor = None
    if args.monitor_port:
        from .monitor import ServiceMonitor
        # The cache tier holds nothing on the card: /profile traces the
        # CPU.
        monitor = ServiceMonitor(host=args.host, port=args.monitor_port,
                                 device="cpu")
        monitor.watch_historian("historian", service)
        monitor.start()
        print(f"historian: monitor on {monitor.url}", flush=True)
    _wait_for_signal()
    if monitor is not None:
        monitor.stop()
    service.stop()


if __name__ == "__main__":
    main()
