"""Lambda SPI, a copy of fluidframework_tpu's server/lambdas/base.py
(reference services-core/src/lambdas.ts:18-73):
IPartitionLambda.handler(message) processes one queued message;
IContext.checkpoint(offset) commits progress; IContext.error signals
recoverable-vs-fatal (restart => replay from last checkpoint)."""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..log import MessageLog, QueuedMessage


class LambdaContext:
    def __init__(self, log: MessageLog, group: str, topic: str,
                 partition: int,
                 on_error: Optional[Callable[[Exception, bool], None]] = None):
        self.log = log
        self.group = group
        self.topic = topic
        self.partition = partition
        self._on_error = on_error
        # Batched cross-partition acks (server/sharding.py AckBatcher):
        # when the hosting tier installs a batcher, checkpoint() NOTES
        # the offset instead of committing it, and the tier flushes a
        # whole pump round's per-partition offsets in one commit_many.
        # Deferring an ack only WIDENS the crash-replay window (at-least-
        # once preserved); None (the default) keeps the eager commit.
        self.ack_batcher = None

    def checkpoint(self, offset: int) -> None:
        if self.ack_batcher is not None:
            self.ack_batcher.note(self.partition, offset)
            return
        self.log.commit(self.group, self.topic, self.partition, offset)

    def error(self, err: Exception, restart: bool) -> None:
        if self._on_error:
            self._on_error(err, restart)
        elif restart:
            raise err


class IPartitionLambda:
    def handler(self, message: QueuedMessage) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Called by the pump after a drain pass. Batching lambdas (the
        device sequencer) accumulate per-message work in handler() and execute it
        here as one device batch — the reference's boxcar/batch moment
        (kafka-service/README.md: process batch N while N+1 queues)."""

    def close(self) -> None:
        pass
