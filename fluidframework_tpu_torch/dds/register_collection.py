"""ConsensusRegisterCollection: versioned LWW registers with atomic reads.

Capability parity with reference packages/dds/register-collection/src/
consensusRegisterCollection.ts: a write takes effect only when sequenced; a
register keeps *all* concurrent versions (writes whose refSeq precedes the
currently-stored write) so readers can choose Atomic (first/winning version)
or LWW (latest) policy. Used by leader election (agent-scheduler).

A port of fluidframework_tpu's dds/register_collection.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

from ..protocol.summary import SummaryTree
from .shared_object import SharedObject, collect_handles

READ_ATOMIC = "atomic"
READ_LWW = "lww"


class ConsensusRegisterCollection(SharedObject):
    TYPE = "https://graph.microsoft.com/types/consensus-register-collection"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        # key -> list of {"value": v, "seq": s} versions (concurrent writes)
        self.data: Dict[str, List[dict]] = {}
        # In-flight writes: (key, value, on_ack); resubmitted on reconnect.
        self._inflight: List[tuple] = []

    def write(self, key: str, value: Any,
              on_ack: Optional[Callable[[bool], None]] = None) -> None:
        """Consensus write: takes effect when sequenced. on_ack(winner)
        fires at ack with whether this write won (became a stored version)."""
        if not self.attached:
            # Detached: apply immediately as the sole version.
            self.data[key] = [{"value": value, "seq": 0}]
            if on_ack:
                on_ack(True)
            return
        self._inflight.append((key, value, on_ack or (lambda won: None)))
        self.submit_local_message({"type": "write", "key": key, "value": value})

    def read(self, key: str, policy: str = READ_ATOMIC) -> Any:
        versions = self.data.get(key)
        if not versions:
            return None
        return versions[0]["value"] if policy == READ_ATOMIC \
            else versions[-1]["value"]

    def read_versions(self, key: str) -> List[Any]:
        return [v["value"] for v in self.data.get(key, [])]

    def keys(self) -> List[str]:
        return list(self.data.keys())

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        key, value = contents["key"], contents["value"]
        versions = self.data.setdefault(key, [])
        # A write that saw every stored version (refSeq >= their seqs)
        # supersedes them; otherwise it's concurrent and appends.
        won = True
        if versions and any(v["seq"] > ref_seq for v in versions):
            versions.append({"value": value, "seq": seq})
            won = False  # concurrent: did not supersede
        else:
            self.data[key] = [{"value": value, "seq": seq}]
        self.emit("atomicChanged" if won else "versionChanged", key, value,
                  local)
        if local and self._inflight:
            self._inflight.pop(0)[2](won)

    def resubmit_pending(self) -> List[Any]:
        # Writes lost to a reconnect are re-emitted; acks fire on the new op.
        return [{"type": "write", "key": k, "value": v}
                for k, v, _ in self._inflight]

    def summarize_core(self) -> SummaryTree:
        return SummaryTree().add_blob(
            "header", json.dumps(self.data, sort_keys=True))

    def load_core(self, tree: SummaryTree) -> None:
        self.data = json.loads(tree.entries["header"].content)

    def get_gc_data(self) -> List[str]:
        routes: List[str] = []
        collect_handles(self.data, routes)
        return routes
