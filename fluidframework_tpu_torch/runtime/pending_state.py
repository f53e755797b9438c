"""PendingStateManager: tracks in-flight local ops for ack and reconnect.

Capability parity with reference packages/runtime/container-runtime/src/
pendingStateManager.ts:56 — every submitted op is recorded; sequenced own
ops must ack in submission order (a mismatch is data corruption); on
reconnect the recorded ops are discarded and channels regenerate their
pending work (merge-tree rewrites positions, map re-emits sets).

A port of fluidframework_tpu's runtime/pending_state.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional


class DataCorruptionError(Exception):
    """Ack arrived out of order vs submission (reference DataCorruptionError)."""


@dataclass
class PendingOp:
    client_sequence_number: int
    contents: Any


class PendingStateManager:
    def __init__(self):
        self._pending: List[PendingOp] = []
        # Ops still in flight under previous connections' client ids. An op
        # submitted just before a disconnect may still get sequenced under
        # the OLD id; recognizing it here acks it instead of double-applying
        # it (once as "remote", once via reconnect resubmission).
        self._prior: Dict[str, List[PendingOp]] = {}

    @property
    def count(self) -> int:
        return len(self._pending) + sum(len(v) for v in self._prior.values())

    def has_prior(self, client_id) -> bool:
        """True when ops of OURS may still arrive under this (previous
        connection's) client id — such messages need try_prior_ack
        pairing, so they must never ride a remote bulk run."""
        return client_id in self._prior

    def on_submit(self, client_sequence_number: int, contents: Any) -> None:
        self._pending.append(PendingOp(client_sequence_number, contents))

    def on_local_ack(self, client_sequence_number: int) -> PendingOp:
        if not self._pending:
            raise DataCorruptionError(
                f"ack for csn {client_sequence_number} with nothing pending")
        head = self._pending.pop(0)
        if head.client_sequence_number != client_sequence_number:
            raise DataCorruptionError(
                f"out-of-order ack: expected csn "
                f"{head.client_sequence_number}, got {client_sequence_number}")
        return head

    def on_connection_change(self, old_client_id: Optional[str]) -> None:
        """Archive in-flight ops under the id they were submitted with; they
        either arrive sequenced under that id (try_prior_ack) or get
        regenerated at the next connect (drain)."""
        if old_client_id is not None and self._pending:
            self._prior.setdefault(old_client_id, []).extend(self._pending)
            self._pending = []

    def try_prior_ack(self, client_id: str, client_sequence_number: int
                      ) -> Optional[PendingOp]:
        """If (client_id, csn) is the head of a previous connection's
        in-flight queue, this sequenced message is one of OURS: pop it so
        reconnect does not resubmit it, and ack it as local."""
        queue = self._prior.get(client_id)
        if queue and queue[0].client_sequence_number == client_sequence_number:
            op = queue.pop(0)
            if not queue:
                del self._prior[client_id]
            return op
        return None

    def drain(self) -> List[PendingOp]:
        """Take all in-flight ops (reconnect: they are re-generated, not
        replayed verbatim)."""
        out = self._pending
        for queue in self._prior.values():
            out.extend(queue)
        self._pending, self._prior = [], {}
        return out
