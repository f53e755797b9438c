"""Foreman: background task distribution with worker heartbeats.

A copy of fluidframework_tpu's server/lambdas/foreman.py, host code that
the port keeps as its own.

Capability parity with reference foreman/README.md:1-10 + lambda.ts:
distributes help requests (snapshot, intelligence) to registered workers,
tracks heartbeats, and reassigns tasks from dead workers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...protocol.messages import MessageType
from ..log import QueuedMessage
from .base import IPartitionLambda, LambdaContext

DEFAULT_HEARTBEAT_TIMEOUT_S = 30.0


@dataclass
class Worker:
    worker_id: str
    dispatch: Callable[[dict], None]
    last_heartbeat: float = field(default_factory=time.time)
    tasks: List[dict] = field(default_factory=list)


class ForemanLambda(IPartitionLambda):
    def __init__(self, context: LambdaContext,
                 heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S):
        self.context = context
        self.workers: Dict[str, Worker] = {}
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.pending: List[dict] = []
        self._rr = 0

    # -- worker registry ---------------------------------------------------
    def register_worker(self, worker_id: str,
                        dispatch: Callable[[dict], None]) -> None:
        self.workers[worker_id] = Worker(worker_id, dispatch)
        self._drain()

    def heartbeat(self, worker_id: str) -> None:
        if worker_id in self.workers:
            self.workers[worker_id].last_heartbeat = time.time()

    def complete_task(self, worker_id: str, task: dict) -> None:
        worker = self.workers.get(worker_id)
        if worker and task in worker.tasks:
            worker.tasks.remove(task)

    def reap_dead_workers(self, now: Optional[float] = None) -> List[str]:
        """Reassign tasks from workers whose heartbeat expired."""
        now = time.time() if now is None else now
        dead = [wid for wid, w in self.workers.items()
                if now - w.last_heartbeat > self.heartbeat_timeout_s]
        for wid in dead:
            worker = self.workers.pop(wid)
            self.pending.extend(worker.tasks)
        self._drain()
        return dead

    # -- lambda ------------------------------------------------------------
    def handler(self, message: QueuedMessage) -> None:
        doc_id, sequenced = message.value
        if sequenced.type == MessageType.REMOTE_HELP:
            contents = sequenced.contents or {}
            for task_name in contents.get("tasks", []):
                self.pending.append({"documentId": doc_id, "task": task_name})
            self._drain()
        self.context.checkpoint(message.offset)

    def _drain(self) -> None:
        alive = list(self.workers.values())
        while self.pending and alive:
            task = self.pending.pop(0)
            worker = alive[self._rr % len(alive)]
            self._rr += 1
            worker.tasks.append(task)
            worker.dispatch(task)
