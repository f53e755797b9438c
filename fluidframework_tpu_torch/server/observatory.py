"""Fleet observatory: the cross-process observability aggregator (a copy
of fluidframework_tpu's server/observatory.py; docs/observability.md v3).

One process per fleet scrapes every worker's monitor surface
(`/health`, `/metrics.prom`, `/trace`) on an interval and serves the
merged view:

  /fleet/health        per-worker reachability + health, merged
                       watermark lag, multi-window burn-rate verdict
  /fleet/metrics.prom  every worker's exposition re-labelled with
                       instance="<worker>" (HELP/TYPE deduplicated)
  /fleet/lag           per-worker watermark snapshots + per-edge fleet
                       totals (the Kafka-style consumer-lag board)
  /fleet/trace         drained spans from every worker joined into ONE
                       perfetto-ready timeline — spans carry their
                       source process identity (pid + args.proc stamped
                       at export by telemetry/tracing.chrome_trace), so
                       a sampled op's alfred-ingest -> deli-ticket ->
                       broadcaster-fanout -> reader-adoption journey
                       reads as one trace across processes
                       (?trace_id=<id> filters to one op)
  /fleet/workers       the scrape target list + last scrape status

Scraping /trace DRAINS each worker's flight recorder (the monitor's
existing drain contract), so the observatory is the fleet's span sink:
spans accumulate here in a bounded ring, joined by args.trace_id.

Burn-rate policy: the engine (telemetry/slo.py) evaluates fleet-level
objectives fed once per scrape — `worker_health` (every worker scrape
ok) and `fleet_lag` (total broadcast-edge lag under the configured
ceiling). A breach surfaces in /fleet/health with per-objective
attribution and flips it to 503.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..telemetry.counters import record_swallow
from ..telemetry.slo import BurnRateEngine, Objective

# Sample line of the exposition format: name, optional labels, rest
# (value + optional exemplar). Label bodies never contain a literal
# '}' in this codebase's metric surface (stage/symbol names are
# escaped, not free-form), which keeps the split unambiguous.
_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s(.*)$")


def _default_fetch(url: str, timeout_s: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read()


class FleetObservatory:
    """Scrape-merge-serve loop over a list of worker monitor URLs.

    `workers` entries are monitor base URLs ("http://127.0.0.1:7101")
    or {"name": ..., "url": ...} dicts; bare URLs get worker<i> names.
    `fetch` is injectable for tests (url, timeout_s) -> bytes.
    """

    def __init__(self, workers: List, host: str = "127.0.0.1",
                 port: int = 0, interval_s: float = 2.0,
                 scrape_timeout_s: float = 2.0,
                 trace_capacity: int = 20000,
                 lag_ceiling: float = 10000.0,
                 burn: Optional[BurnRateEngine] = None,
                 fetch: Optional[Callable[[str, float], bytes]] = None):
        self.targets: List[Dict[str, str]] = []
        for i, w in enumerate(workers):
            if isinstance(w, dict):
                self.targets.append({"name": w.get("name", f"worker{i}"),
                                     "url": w["url"].rstrip("/")})
            else:
                self.targets.append({"name": f"worker{i}",
                                     "url": str(w).rstrip("/")})
        self.interval_s = float(interval_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.lag_ceiling = float(lag_ceiling)
        self.fetch = fetch or _default_fetch
        self.burn = burn or BurnRateEngine(
            [Objective("worker_health", 0.99,
                       "every worker scrape returns a healthy /health"),
             Objective("fleet_lag", 0.95,
                       "total broadcast-edge lag stays under the "
                       "configured ceiling")],
            fast_window_s=max(4 * self.interval_s, 10.0),
            slow_window_s=max(30 * self.interval_s, 60.0))
        # Guards everything the scrape thread writes and the HTTP
        # request threads read.
        self._lock = threading.Lock()
        self._state: Dict[str, dict] = {}   # worker name -> last scrape
        self._spans: deque = deque(maxlen=int(trace_capacity))
        self._scrapes = 0
        self._thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.host = host
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                service._route(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]

    # -- scraping ------------------------------------------------------
    def _scrape_worker(self, target: Dict[str, str]) -> dict:
        url = target["url"]
        out = {"name": target["name"], "url": url, "ok": False,
               "error": None, "health": None,
               "scrapedAt": time.time()}
        try:
            health = json.loads(self.fetch(
                f"{url}/health", self.scrape_timeout_s))
            out["health"] = health
            trace = json.loads(self.fetch(
                f"{url}/trace", self.scrape_timeout_s))
            events = trace.get("traceEvents", [])
            out["spans"] = len(events)
            with self._lock:
                self._spans.extend(events)
            out["ok"] = bool(health.get("ok", False))
        except Exception as exc:  # noqa: BLE001 — down worker = finding
            out["error"] = repr(exc)
        return out

    def scrape_once(self) -> dict:
        """One scrape round over every target; feeds the burn engine
        and returns the merged worker states."""
        results = [self._scrape_worker(t) for t in self.targets]
        with self._lock:
            for res in results:
                self._state[res["name"]] = res
            self._scrapes += 1
        ok = sum(1 for r in results if r["ok"])
        self.burn.record("worker_health", good=ok,
                         bad=len(results) - ok)
        lag = self._fleet_lag_locked()
        total_broadcast = lag.get("fleet", {}).get("broadcast", 0.0)
        self.burn.record("fleet_lag",
                         good=1 if total_broadcast <= self.lag_ceiling
                         else 0,
                         bad=0 if total_broadcast <= self.lag_ceiling
                         else 1)
        return {name: {"ok": r["ok"], "error": r["error"]}
                for name, r in ((res["name"], res) for res in results)}

    def _run(self) -> None:
        # fluidlint: disable=SHARED_STATE_NO_LOCK — threading.Event is
        # internally locked; start/stop flag it from the main thread.
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                record_swallow("observatory.scrape_loop")
            self._stop.wait(self.interval_s)

    # -- merged views --------------------------------------------------
    def _fleet_lag_locked(self) -> dict:
        """Per-worker watermark snapshots + per-edge fleet totals."""
        with self._lock:
            states = dict(self._state)
        workers = {}
        fleet: Dict[str, float] = {}
        for name, res in states.items():
            wm = ((res.get("health") or {}).get("watermarks")
                  if res.get("ok") else None)
            workers[name] = wm
            if not wm:
                continue
            for edge, detail in (wm.get("lags") or {}).items():
                fleet[edge] = fleet.get(edge, 0.0) + float(
                    detail.get("total", 0.0))
        return {"workers": workers, "fleet": fleet}

    def fleet_health(self) -> dict:
        with self._lock:
            states = {name: {"ok": res["ok"], "error": res["error"],
                             "url": res["url"],
                             "scrapedAt": res["scrapedAt"]}
                      for name, res in self._state.items()}
            scrapes = self._scrapes
        burn = self.burn.evaluate()
        lag = self._fleet_lag_locked()
        workers_ok = bool(states) and all(s["ok"]
                                          for s in states.values())
        return {"ok": workers_ok and burn["ok"],
                "workers": states,
                "scrapes": scrapes,
                "lag": lag["fleet"],
                "burnRate": burn}

    def fleet_prom(self) -> str:
        """Merge every worker's exposition, injecting
        instance="<worker>" into each sample. HELP/TYPE metadata is
        emitted once per metric family (first worker wins); the
        OpenMetrics EOF terminator is re-appended once.

        Fetched from each worker at REQUEST time, not in the scrape
        loop: rendering the full histogram exposition is the most
        expensive part of a worker's monitor surface, and between
        requests nobody reads it — the periodic scrape carries only
        health + trace drains. A worker whose fetch fails contributes
        nothing to this merge (same as a down worker mid-scrape)."""
        proms: Dict[str, str] = {}
        for target in self.targets:
            try:
                proms[target["name"]] = self.fetch(
                    f"{target['url']}/metrics.prom",
                    self.scrape_timeout_s).decode("utf-8", "replace")
            except Exception:  # noqa: BLE001 — down worker = absent
                record_swallow("observatory.fleet_prom")
                continue
        lines: List[str] = []
        seen_meta = set()
        for name in sorted(proms):
            for line in proms[name].splitlines():
                if not line:
                    continue
                if line.startswith("#"):
                    if line == "# EOF":
                        continue
                    parts = line.split(None, 3)
                    key = tuple(parts[:3])  # ('#', 'TYPE'|'HELP', name)
                    if key in seen_meta:
                        continue
                    seen_meta.add(key)
                    lines.append(line)
                    continue
                m = _SAMPLE_RE.match(line)
                if m is None:
                    continue
                metric, labels, rest = m.groups()
                inst = f'instance="{name}"'
                if labels:
                    labels = "{" + inst + "," + labels[1:]
                else:
                    labels = "{" + inst + "}"
                lines.append(f"{metric}{labels} {rest}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def fleet_trace(self, trace_id: Optional[str] = None) -> dict:
        """The joined timeline: every span drained from every worker,
        ordered by timestamp; each already carries its source process
        (pid + args.proc). ?trace_id= narrows to one op's journey."""
        with self._lock:
            events = list(self._spans)
        if trace_id:
            events = [e for e in events
                      if (e.get("args") or {}).get("trace_id")
                      == trace_id]
        events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
        traces: Dict[str, set] = {}
        for e in events:
            args = e.get("args") or {}
            tid = args.get("trace_id")
            if tid:
                traces.setdefault(tid, set()).add(args.get("proc"))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "joined": {
                    "traces": len(traces),
                    "crossProcess": sum(1 for procs in traces.values()
                                        if len(procs) > 1)}}

    def workers_view(self) -> dict:
        with self._lock:
            return {"targets": list(self.targets),
                    "scrapes": self._scrapes,
                    "spansHeld": len(self._spans)}

    # -- lifecycle -----------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetObservatory":
        # fluidlint: disable=SHARED_STATE_NO_LOCK — threading.Event
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="observatory-scrape",
                                        daemon=True)
        self._thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="observatory-http",
            daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        """Safe on a never-started observatory (pull-model users call
        scrape_once() directly and only ever need the socket closed)."""
        # fluidlint: disable=SHARED_STATE_NO_LOCK — threading.Event
        self._stop.set()
        if self._http_thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)

    # -- HTTP ----------------------------------------------------------
    def _route(self, handler) -> None:
        path, _, query = handler.path.partition("?")
        content_type = "application/json"
        if path == "/fleet/health":
            payload = self.fleet_health()
            status = 200 if payload["ok"] else 503
            body = json.dumps(payload).encode()
        elif path == "/fleet/metrics.prom":
            body = self.fleet_prom().encode()
            status = 200
            content_type = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")
        elif path == "/fleet/lag":
            body = json.dumps(self._fleet_lag_locked()).encode()
            status = 200
        elif path == "/fleet/trace":
            trace_id = None
            for part in query.split("&"):
                if part.startswith("trace_id="):
                    trace_id = part.split("=", 1)[1]
            body = json.dumps(self.fleet_trace(trace_id)).encode()
            status = 200
        elif path == "/fleet/workers":
            body = json.dumps(self.workers_view()).encode()
            status = 200
        else:
            body = json.dumps({"error": f"no route {path}"}).encode()
            status = 404
        handler.send_response(status)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
