"""Document-router sub-partitioning + consolidated checkpointing
(reference lambdas-driver/src/document-router, kafka-service/README.md
:52-56).

A mirror of tests/test_document_router.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

from fluidframework_tpu_torch.server.document_router import (DocumentContext,
                                                       DocumentRouterLambda)
from fluidframework_tpu_torch.server.lambdas.base import (IPartitionLambda,
                                                    LambdaContext)
from fluidframework_tpu_torch.server.log import MessageLog
from fluidframework_tpu_torch.server.partition import PartitionPump


class RecordingDocLambda(IPartitionLambda):
    """Per-document lambda that checkpoints only when told to."""

    def __init__(self, doc_id: str, ctx: DocumentContext):
        self.doc_id = doc_id
        self.ctx = ctx
        self.seen = []
        self.lazy = False  # when True, don't checkpoint on handle

    def handler(self, message):
        self.seen.append(message.value)
        if not self.lazy:
            self.ctx.checkpoint(message.offset)


class CrashingDocLambda(RecordingDocLambda):
    def handler(self, message):
        if message.value == "boom":
            raise RuntimeError("doc lambda crash")
        super().handler(message)


def make_router(log, factory_cls=RecordingDocLambda, on_error=None):
    log.topic("t", partitions=1)
    context = LambdaContext(log, "g", "t", 0, on_error)
    lambdas = {}

    def factory(doc_id, ctx):
        lambdas[doc_id] = factory_cls(doc_id, ctx)
        return lambdas[doc_id]

    return DocumentRouterLambda(context, factory), lambdas


class TestRouting:
    def test_messages_route_by_document(self):
        log = MessageLog()
        router, lambdas = make_router(log)
        for i, doc in enumerate(["a", "b", "a", "c", "b"]):
            msg = log.send("t", doc, f"{doc}{i}")
            router.handler(msg)
        assert lambdas["a"].seen == ["a0", "a2"]
        assert lambdas["b"].seen == ["b1", "b4"]
        assert lambdas["c"].seen == ["c3"]

    def test_consolidated_checkpoint_held_by_lagging_doc(self):
        log = MessageLog()
        router, lambdas = make_router(log)
        m0 = log.send("t", "slow", "s0")
        router.handler(m0)
        lambdas["slow"].lazy = True          # stops checkpointing now
        m1 = log.send("t", "slow", "s1")
        m2 = log.send("t", "fast", "f0")
        m3 = log.send("t", "fast", "f1")
        for m in (m1, m2, m3):
            router.handler(m)
        # fast is durable through offset 3, but slow is stuck at offset 0:
        # the partition may only commit offset 0.
        assert log.committed("g", "t", 0) == m0.offset + 1
        lambdas["slow"].ctx.checkpoint(m1.offset)
        assert log.committed("g", "t", 0) == m3.offset + 1

    def test_doc_crash_isolated_and_does_not_pin_offset(self):
        log = MessageLog()
        errors = []
        router, lambdas = make_router(
            log, CrashingDocLambda,
            on_error=lambda err, restart: errors.append((err, restart)))
        router.handler(log.send("t", "ok", "v1"))
        router.handler(log.send("t", "bad", "boom"))   # crashes
        m = log.send("t", "ok", "v2")
        router.handler(m)
        router.handler(log.send("t", "bad", "ignored"))  # corrupt: skipped
        assert lambdas["ok"].seen == ["v1", "v2"]
        assert lambdas["bad"].seen == []
        assert len(errors) == 1 and errors[0][1] is False
        assert "bad" in router.corrupt
        # The dead document doesn't pin the partition checkpoint.
        assert log.committed("g", "t", 0) >= m.offset + 1

    def test_reap_idle_documents(self):
        log = MessageLog()
        router, lambdas = make_router(log)
        router.handler(log.send("t", "a", "x"))
        router.handler(log.send("t", "b", "y"))
        assert router.reap_idle() == 2
        assert router.document_ids() == []
        # Routing resumes transparently: a fresh lambda is built.
        router.handler(log.send("t", "a", "z"))
        assert lambdas["a"].seen == ["z"]


class TestPumpIntegration:
    def test_pump_without_autocommit_replays_from_consolidated_offset(self):
        log = MessageLog()
        log.topic("t", partitions=1)
        built = []

        def doc_factory(doc_id, ctx):
            lam = RecordingDocLambda(doc_id, ctx)
            built.append(lam)
            return lam

        pump = PartitionPump(
            log, "g", "t", 0,
            lambda ctx: DocumentRouterLambda(ctx, doc_factory),
            auto_commit=False)
        log.send("t", "a", "a0")
        log.send("t", "a", "a1")
        assert pump.pump() == 2
        a = built[-1]
        assert a.seen == ["a0", "a1"]
        assert log.committed("g", "t", 0) == 2  # router checkpointed
        # Lazy doc: messages processed but not durable -> crash replays them.
        log.send("t", "b", "b0")
        pump.pump()
        b = built[-1]
        b.lazy = True
        log.send("t", "b", "b1")
        log.send("t", "b", "b2")
        pump.pump()
        assert b.seen == ["b0", "b1", "b2"]
        assert log.committed("g", "t", 0) == 3  # held at b's frontier
        pump.restart()  # crash: rebuild lambda, cursor back to committed
        assert pump.pump() == 2  # b1, b2 replay
        b2 = built[-1]
        assert b2.seen == ["b1", "b2"]
        assert log.committed("g", "t", 0) == 5
