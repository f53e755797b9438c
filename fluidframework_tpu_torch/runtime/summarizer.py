"""Summarization subsystem: election, heuristics, ack tracking, GC.

Capability parity with reference packages/runtime/container-runtime/src/
{summaryManager.ts, summarizer.ts:153-280, summaryCollection.ts:197} and
packages/runtime/garbage-collector/src/garbageCollector.ts:

- SummaryManager: every client watches the quorum; the OLDEST interactive
  client (minimum join sequence number) is the electee and runs the
  summarizer (summaryManager.ts:50-61). Here the summarizer runs in-process
  on the elected container rather than spawning a hidden "/_summarizer"
  client — one client fewer in the quorum, same election semantics.
- RunningSummarizer + SummarizerHeuristics: summarize after maxOps ops,
  after idleTime with no ops, or after maxTime since the last acked
  summary, with nack retries (summarizer.ts:153-280).
- SummaryCollection: watches summarize/summaryAck/summaryNack in the op
  stream; exposes the latest acked summary and waiters
  (summaryCollection.ts:197,244).
- run_garbage_collection: mark pass over the handle-reference graph built
  from each node's getGCData (garbageCollector.ts; sharedObject.ts:244).

A port of fluidframework_tpu's runtime/summarizer.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set


# ---------------------------------------------------------------------------
# Garbage collection
# ---------------------------------------------------------------------------

@dataclass
class GCResult:
    referenced: List[str]
    unreferenced: List[str]


def run_garbage_collection(nodes: Dict[str, List[str]],
                           roots: List[str]) -> GCResult:
    """Mark reachable nodes from `roots` over the outbound-route graph.

    `nodes` maps node id (e.g. "/store/channel") -> outbound routes it
    references. Routes may point at nodes or at their prefixes ("/store"
    references every "/store/..." node implicitly, matching the reference's
    route-to-node normalization)."""
    ids = sorted(nodes)
    visited: Set[str] = set()
    stack = [r for r in roots]
    while stack:
        route = stack.pop()
        targets = [n for n in ids
                   if n == route or n.startswith(route.rstrip("/") + "/")]
        for node_id in targets:
            if node_id in visited:
                continue
            visited.add(node_id)
            stack.extend(nodes[node_id])
    return GCResult(
        referenced=[n for n in ids if n in visited],
        unreferenced=[n for n in ids if n not in visited])


# ---------------------------------------------------------------------------
# Summary ack tracking
# ---------------------------------------------------------------------------

class SummaryCollection:
    """Feed every sequenced message via process(); tracks proposals and the
    latest acked summary (summaryCollection.ts)."""

    def __init__(self):
        self.last_ack: Optional[dict] = None  # {handle, summarySequenceNumber}
        self.pending: Dict[int, dict] = {}    # summarySeq -> summarize info
        self._waiters: List[Callable[[bool, dict], None]] = []

    def process(self, message) -> None:
        from ..protocol.messages import MessageType
        mtype = message.type
        if mtype == MessageType.SUMMARIZE:
            contents = message.contents or {}
            self.pending[message.sequence_number] = {
                "clientId": message.client_id,
                "handle": contents.get("handle"),
            }
        elif mtype in (MessageType.SUMMARY_ACK, MessageType.SUMMARY_NACK):
            contents = message.contents or {}
            proposal = contents.get("summaryProposal", {})
            summary_seq = proposal.get("summarySequenceNumber")
            info = self.pending.pop(summary_seq, {})
            ack = mtype == MessageType.SUMMARY_ACK
            if ack:
                self.last_ack = {
                    "handle": contents.get("handle", info.get("handle")),
                    "summarySequenceNumber": summary_seq,
                }
            waiters, self._waiters = self._waiters, []
            for fn in waiters:
                fn(ack, contents)

    def wait_summary_ack(self, fn: Callable[[bool, dict], None]) -> None:
        self._waiters.append(fn)


# ---------------------------------------------------------------------------
# Heuristics + running summarizer
# ---------------------------------------------------------------------------

@dataclass
class SummaryConfig:
    """Reference defaults: idle 5 s, max 120 s, 1000-op threshold."""

    idle_time: float = 5.0
    max_time: float = 120.0
    max_ops: int = 1000
    min_ops: int = 1
    max_attempts: int = 3


class RunningSummarizer:
    """Drives Container.summarize from op-stream heuristics. Feed ops with
    on_op(); advance wall-clock triggers with tick() (the host pump calls it;
    tests inject a fake clock)."""

    def __init__(self, container, config: Optional[SummaryConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.container = container
        self.config = config or SummaryConfig()
        self.clock = clock
        self.ops_since_ack = 0
        self.last_op_time = clock()
        self.last_summary_time = clock()
        self.summarizing = False
        self.attempts = 0
        self.stopped = False
        self.summaries_run = 0

    # -- inputs ------------------------------------------------------------
    def on_op(self, message) -> None:
        from ..protocol.messages import MessageType
        if self.stopped or message.type != MessageType.OPERATION:
            return
        self.ops_since_ack += 1
        self.last_op_time = self.clock()
        if self.ops_since_ack >= self.config.max_ops:
            self._try_summarize("maxOps")

    def tick(self) -> None:
        """Time-based triggers (idle / maxTime)."""
        if self.stopped or self.summarizing:
            return
        if self.ops_since_ack < self.config.min_ops:
            return
        now = self.clock()
        if now - self.last_op_time >= self.config.idle_time:
            self._try_summarize("idle")
        elif now - self.last_summary_time >= self.config.max_time:
            self._try_summarize("maxTime")

    def stop(self) -> None:
        self.stopped = True

    # -- internals ---------------------------------------------------------
    def _try_summarize(self, reason: str) -> None:
        if self.summarizing or self.stopped:
            return
        self.summarizing = True
        self.attempts += 1

        def on_result(handle, ack, contents):
            self.summarizing = False
            if ack:
                self.ops_since_ack = 0
                self.attempts = 0
                self.last_summary_time = self.clock()
                self.summaries_run += 1
            elif self.attempts < self.config.max_attempts:
                self._try_summarize(f"{reason}-retry")
            else:
                self.attempts = 0  # give up this round; heuristics re-arm

        self.container.summarize(on_result)


# ---------------------------------------------------------------------------
# Election
# ---------------------------------------------------------------------------

class SummaryManager:
    """Summarizer election (summaryManager.ts): the interactive client with
    the lowest join sequence number is the electee; each client runs one of
    these and starts/stops its own RunningSummarizer as election flips."""

    def __init__(self, container, config: Optional[SummaryConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.container = container
        self.config = config or SummaryConfig()
        self.clock = clock
        self.running: Optional[RunningSummarizer] = None
        container.on("op", self._on_op)
        container.on("connected", self._refresh)
        container.on("disconnected", self._refresh)

    # -- election ----------------------------------------------------------
    def electee(self) -> Optional[str]:
        members = self.container.protocol.quorum.members
        candidates = [
            (client.sequence_number, client_id)
            for client_id, client in members.items()
            if _interactive(client.details)]
        return min(candidates)[1] if candidates else None

    @property
    def elected_self(self) -> bool:
        cid = self.container.delta_manager.client_id
        return cid is not None and self.electee() == cid

    # -- wiring ------------------------------------------------------------
    def _refresh(self, *_args) -> None:
        should_run = self.container.connected and self.elected_self
        if should_run and self.running is None:
            self.running = RunningSummarizer(self.container, self.config,
                                             self.clock)
        elif not should_run and self.running is not None:
            self.running.stop()
            self.running = None

    def _on_op(self, message, *_args) -> None:
        self._refresh()
        if self.running is not None:
            self.running.on_op(message)

    def tick(self) -> None:
        if self.running is not None:
            self.running.tick()


def _interactive(details: Any) -> bool:
    if isinstance(details, dict):
        caps = details.get("capabilities") or details.get("details", {})
        if isinstance(caps, dict) and "interactive" in caps:
            return bool(caps["interactive"])
        if "interactive" in details:
            return bool(details["interactive"])
    return True
