"""Copier: persists *raw* (pre-sequencing) ops for debugging/replay
(reference copier/README.md:1-24).

A copy of fluidframework_tpu's server/lambdas/copier.py, host code that
the port keeps as its own.
"""

from __future__ import annotations

from dataclasses import asdict

from ..database import Collection
from ..log import QueuedMessage
from .base import IPartitionLambda, LambdaContext


class CopierLambda(IPartitionLambda):
    def __init__(self, context: LambdaContext, raw_deltas: Collection):
        self.context = context
        self.raw_deltas = raw_deltas

    def handler(self, message: QueuedMessage) -> None:
        boxcar = message.value
        if isinstance(boxcar, dict):
            # Rebalance control records (server/sharding.py handoff/
            # adopt) ride the raw topic as plain dicts — sequencer
            # control plane, not client traffic; nothing to archive.
            self.context.checkpoint(message.offset)
            return
        self.raw_deltas.insert_one({
            "documentId": boxcar.document_id,
            "clientId": boxcar.client_id,
            "offset": message.offset,
            "contents": [asdict(m) for m in boxcar.contents],
        })
        self.context.checkpoint(message.offset)
