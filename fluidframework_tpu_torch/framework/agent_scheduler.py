"""AgentScheduler: distributed task assignment among connected clients.

Capability parity with reference packages/framework/agent-scheduler/src/
scheduler.ts:34,106 — tasks are claimed through a ConsensusRegisterCollection
(first sequenced write wins); each client registers the tasks it can run;
when the current assignee leaves, volunteers race to re-claim and exactly
one wins. The flagship consumer is summarizer election's cousin: background
work like intelligence agents (SURVEY.md §2.6 task parallelism).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..dds.register_collection import READ_ATOMIC, ConsensusRegisterCollection

UNASSIGNED = ""


class AgentScheduler:
    def __init__(self, container, registers: ConsensusRegisterCollection):
        self.container = container
        self.registers = registers
        # task id -> worker callback we volunteered with
        self._volunteered: Dict[str, Callable[[], None]] = {}
        self._running: Dict[str, bool] = {}
        registers.on("atomicChanged", self._on_register_changed)
        container.audience.on("removeMember", self._on_member_left)

    # -- api ---------------------------------------------------------------
    def pick(self, task_id: str, worker: Callable[[], None]) -> None:
        """Volunteer for a task: the first client whose claim sequences wins
        and runs `worker`; others stand by for takeover (scheduler.pick)."""
        self._volunteered[task_id] = worker
        current = self.registers.read(task_id, READ_ATOMIC)
        if current in (None, UNASSIGNED):
            self._claim(task_id)
        # else: standing by; takeover happens on removeMember

    def release(self, task_id: str) -> None:
        """Stop volunteering; if we hold the task, give it up."""
        self._volunteered.pop(task_id, None)
        if self.picked(task_id):
            self._running.pop(task_id, None)
            self.registers.write(task_id, UNASSIGNED)

    def picked(self, task_id: str) -> bool:
        return (self.registers.read(task_id, READ_ATOMIC)
                == self._client_id())

    def picked_tasks(self) -> List[str]:
        return [t for t in self.registers.keys() if self.picked(t)]

    # -- internals ---------------------------------------------------------
    def _client_id(self) -> Optional[str]:
        return self.container.delta_manager.client_id

    def _claim(self, task_id: str) -> None:
        me = self._client_id()
        if me is not None:
            self.registers.write(task_id, me)

    def _on_register_changed(self, key: str, value, local: bool) -> None:
        if key not in self._volunteered:
            return
        if value == self._client_id() and not self._running.get(key):
            self._running[key] = True
            self._volunteered[key]()
        elif value in (None, UNASSIGNED) and not local:
            self._claim(key)  # released: race to re-claim

    def _on_member_left(self, client_id: str) -> None:
        for task_id in list(self._volunteered):
            if self.registers.read(task_id, READ_ATOMIC) == client_id:
                self._claim(task_id)
