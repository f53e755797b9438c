"""ConsensusOrderedCollection: a distributed work queue with acquire leases.

Capability parity with reference packages/dds/ordered-collection/src/
consensusOrderedCollection.ts:34-61 — add/acquire/complete/release op
protocol: `acquire` removes the head only when the op is sequenced and
grants it to the acquiring client; `complete` finishes the item; `release`
(or the holder leaving the quorum) returns it to the queue, giving
crash-safe task distribution.

A port of fluidframework_tpu's dds/ordered_collection.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..protocol.summary import SummaryTree
from .shared_object import SharedObject


class ConsensusQueue(SharedObject):
    TYPE = "https://graph.microsoft.com/types/consensus-queue"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.items: List[dict] = []  # {"id", "value"}
        # acquired id -> {"value", "clientId"} (in-flight leases)
        self.jobs: Dict[str, dict] = {}
        self._acquire_waiters: Dict[str, Callable[[Optional[Any]], None]] = {}
        # In-flight ops, retired FIFO at local ack; non-acquire ops are
        # resubmitted after a reconnect so queued work is never lost.
        self._inflight: List[dict] = []

    def _submit(self, op: dict) -> None:
        self._inflight.append(op)
        self.submit_local_message(op)

    # -- producers ---------------------------------------------------------
    def add(self, value: Any) -> None:
        item = {"id": uuid.uuid4().hex, "value": value}
        if not self.attached:
            self.items.append(item)
            return
        self._submit({"type": "add", "item": item})

    # -- consumers -----------------------------------------------------------
    def acquire(self, callback: Callable[[Optional[str], Optional[Any]], None]
                ) -> None:
        """Request the queue head. callback(item_id, value) fires when our
        acquire op sequences — (None, None) if the queue was empty."""
        req = uuid.uuid4().hex
        self._acquire_waiters[req] = callback
        self._submit({"type": "acquire", "req": req})

    def complete(self, item_id: str) -> None:
        self._submit({"type": "complete", "id": item_id})

    def release(self, item_id: str) -> None:
        self._submit({"type": "release", "id": item_id})

    # -- processing ----------------------------------------------------------
    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        t = contents["type"]
        if local and self._inflight:
            self._inflight.pop(0)
        if t == "add":
            self.items.append(contents["item"])
            self.emit("add", contents["item"]["value"], local)
        elif t == "acquire":
            granted = self.items.pop(0) if self.items else None
            if granted is not None:
                self.jobs[granted["id"]] = {
                    "value": granted["value"], "client": client_ordinal}
                self.emit("acquire", granted["value"], client_ordinal)
            if local:
                waiter = self._acquire_waiters.pop(contents["req"], None)
                if waiter:
                    if granted is None:
                        waiter(None, None)
                    else:
                        waiter(granted["id"], granted["value"])
        elif t == "complete":
            job = self.jobs.pop(contents["id"], None)
            if job is not None:
                self.emit("complete", job["value"])
        elif t == "release":
            job = self.jobs.pop(contents["id"], None)
            if job is not None:
                self.items.insert(0, {"id": contents["id"],
                                      "value": job["value"]})
                self.emit("localRelease" if local else "release", job["value"])

    def client_left(self, client_ordinal: int) -> None:
        """Quorum-leave hook: release every lease held by the departed
        client (reference releaseAll on removeMember)."""
        for item_id in [i for i, j in self.jobs.items()
                        if j["client"] == client_ordinal]:
            job = self.jobs.pop(item_id)
            self.items.insert(0, {"id": item_id, "value": job["value"]})
            self.emit("release", job["value"])

    def resubmit_pending(self) -> List[Any]:
        # Adds/completes/releases replay (idempotent against current state);
        # consensus acquires don't — their waiters are failed out.
        for waiter in self._acquire_waiters.values():
            waiter(None, None)
        self._acquire_waiters.clear()
        out = [op for op in self._inflight if op["type"] != "acquire"]
        self._inflight = list(out)
        return out

    def summarize_core(self) -> SummaryTree:
        blob = json.dumps({"items": self.items, "jobs": self.jobs},
                          sort_keys=True)
        return SummaryTree().add_blob("header", blob)

    def load_core(self, tree: SummaryTree) -> None:
        data = json.loads(tree.entries["header"].content)
        self.items = data["items"]
        self.jobs = data["jobs"]
