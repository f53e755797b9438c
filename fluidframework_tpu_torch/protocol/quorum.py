"""Quorum: membership + consensus-by-msn proposals.

A copy of fluidframework_tpu's protocol/quorum.py, host code that the port
keeps as its own.

Capability parity with reference
`server/routerlicious/packages/protocol-base/src/quorum.ts:70-307`:
- membership: ClientJoin/ClientLeave system ops add/remove sequenced clients;
- proposals: a Propose op creates a pending proposal; it is *approved* once
  the minimum sequence number passes its sequence number with no Reject ops
  (quorum.ts:284-307), i.e. every connected client has seen it and none
  objected. Used for code upgrades and (in our runtime) config consensus.

Same state machine runs client-side (Container) and server-side (Scribe).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class SequencedClient:
    client_id: str
    sequence_number: int  # seq of the join op
    details: Any = None   # capabilities / user info


@dataclass
class QuorumProposal:
    sequence_number: int
    key: str
    value: Any
    approval_sequence_number: Optional[int] = None  # set on approval
    rejections: List[str] = field(default_factory=list)

    @property
    def approved(self) -> bool:
        return self.approval_sequence_number is not None


class Quorum:
    """Tracks members, pending proposals, and approved values."""

    def __init__(
        self,
        members: Optional[Dict[str, SequencedClient]] = None,
        proposals: Optional[Dict[int, QuorumProposal]] = None,
        values: Optional[Dict[str, Any]] = None,
    ):
        self.members: Dict[str, SequencedClient] = dict(members or {})
        self.proposals: Dict[int, QuorumProposal] = dict(proposals or {})
        self.values: Dict[str, Any] = dict(values or {})
        self._listeners: Dict[str, List[Callable]] = {}

    # -- events ------------------------------------------------------------
    def on(self, event: str, fn: Callable) -> None:
        self._listeners.setdefault(event, []).append(fn)

    def off(self, event: str, fn: Callable) -> None:
        """Removal path for on(): quorum outlives individual observers
        (summarizer clients come and go), so observers must detach."""
        listeners = self._listeners.get(event)
        if listeners and fn in listeners:
            listeners.remove(fn)

    def _emit(self, event: str, *args) -> None:
        # Iterate a copy: a listener may off() itself mid-emit (the
        # one-shot pattern); mutating the live list would skip siblings.
        for fn in list(self._listeners.get(event, [])):
            fn(*args)

    # -- membership --------------------------------------------------------
    def add_member(self, client_id: str, sequence_number: int, details: Any = None):
        client = SequencedClient(client_id, sequence_number, details)
        self.members[client_id] = client
        self._emit("addMember", client_id, client)

    def remove_member(self, client_id: str) -> None:
        if client_id in self.members:
            del self.members[client_id]
            self._emit("removeMember", client_id)

    def get_member(self, client_id: str) -> Optional[SequencedClient]:
        return self.members.get(client_id)

    # -- proposals ---------------------------------------------------------
    def add_proposal(self, key: str, value: Any, sequence_number: int) -> None:
        self.proposals[sequence_number] = QuorumProposal(sequence_number, key, value)
        self._emit("addProposal", key, value, sequence_number)

    def reject_proposal(self, client_id: str, proposal_seq: int) -> None:
        prop = self.proposals.get(proposal_seq)
        if prop is not None and not prop.approved:
            prop.rejections.append(client_id)
            self._emit("rejectProposal", proposal_seq, prop.key, prop.value, client_id)

    def update_minimum_sequence_number(self, msn: int) -> None:
        """Approve / drop pending proposals the MSN has passed (quorum.ts:284-307)."""
        for seq in sorted(self.proposals):
            prop = self.proposals[seq]
            if prop.approved or seq > msn:
                continue
            if prop.rejections:
                del self.proposals[seq]
                self._emit("dropProposal", prop.key, prop.value, seq)
            else:
                prop.approval_sequence_number = msn
                self.values[prop.key] = prop.value
                del self.proposals[seq]
                self._emit("approveProposal", seq, prop.key, prop.value, msn)

    def get(self, key: str) -> Any:
        return self.values.get(key)

    def has(self, key: str) -> bool:
        return key in self.values

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "members": [
                [cid, {"sequenceNumber": m.sequence_number, "details": m.details}]
                for cid, m in sorted(self.members.items())
            ],
            "proposals": [
                [seq, {"key": p.key, "value": p.value, "rejections": list(p.rejections)}]
                for seq, p in sorted(self.proposals.items())
            ],
            "values": [[k, v] for k, v in sorted(self.values.items())],
        }

    @staticmethod
    def load(snap: dict) -> "Quorum":
        q = Quorum()
        for cid, m in snap.get("members", []):
            q.members[cid] = SequencedClient(cid, m["sequenceNumber"], m.get("details"))
        for seq, p in snap.get("proposals", []):
            prop = QuorumProposal(seq, p["key"], p["value"])
            prop.rejections = list(p.get("rejections", []))
            q.proposals[seq] = prop
        for k, v in snap.get("values", []):
            q.values[k] = v
        return q
