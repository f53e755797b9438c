"""Headless agent runner: server-side containers hosting agents.

Capability parity with reference server/headless-agent (572 LoC: launches
Fluid containers in headless Chromium via puppeteer so agents — snapshot,
intelligence, translation — run server-side without a user): here agents
are plain Python; the runner loads real containers through a loader,
wires agent factories onto them, and tears them down on request. The
Foreman lambda can dispatch "help" tasks straight into a runner
(reference: foreman assigns tasks to registered headless workers).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from ..loader.container import Container, Loader


class _RunningDocument:
    def __init__(self, container: Container):
        self.container = container
        self.agents: List[Any] = []


class HeadlessAgentRunner:
    """`launch(doc_id, [agent_factory...])`: load the container and start
    one agent per factory. An agent factory is `Container -> agent` where
    the agent may expose start()/stop(). The containers load through
    `loader`, on its device."""

    def __init__(self, loader: Loader, worker_id: str = "headless-1"):
        self.loader = loader
        self.worker_id = worker_id
        self.documents: Dict[str, _RunningDocument] = {}

    # -- lifecycle ---------------------------------------------------------
    def launch(self, document_id: str,
               agent_factories: List[Callable[[Container], Any]]
               ) -> Container:
        if document_id in self.documents:
            raise ValueError(f"already running {document_id!r}")
        container = self.loader.resolve(document_id)
        running = _RunningDocument(container)
        for factory in agent_factories:
            agent = factory(container)
            start = getattr(agent, "start", None)
            if start:
                start()
            running.agents.append(agent)
        self.documents[document_id] = running
        return container

    def close(self, document_id: str) -> None:
        running = self.documents.pop(document_id, None)
        if running is None:
            return
        for agent in running.agents:
            stop = getattr(agent, "stop", None)
            if stop:
                stop()
        running.container.close()

    def close_all(self) -> None:
        for doc_id in list(self.documents):
            self.close(doc_id)

    def running(self) -> List[str]:
        return list(self.documents)

    # -- foreman integration ----------------------------------------------
    def register_with_foreman(self, foreman,
                              agent_factories: List[Callable[[Container],
                                                             Any]]) -> None:
        """Register as a foreman worker: dispatched help tasks launch the
        named document with this runner's agent set (reference: headless
        agents register for snapshot/intel help messages)."""

        def dispatch(task: dict) -> None:
            doc_id = task.get("documentId")
            if doc_id and doc_id not in self.documents:
                self.launch(doc_id, agent_factories)
            foreman.complete_task(self.worker_id, task)

        foreman.register_worker(self.worker_id, dispatch)
