"""Remote ordered-log service: lambda host consuming a networked broker
(the reference's every-lambda-connects-to-Kafka deployment shape).

A mirror of tests/test_log_service.py: every assertion of the JAX file, run
through fluidframework_tpu_torch on the CPU (device="cpu" for every
Loader and TpuLocalServer).
"""

import pytest

grpc = pytest.importorskip("grpc")

from fluidframework_tpu_torch.protocol.messages import Boxcar  # noqa: E402
from fluidframework_tpu_torch.server.lambdas.base import (  # noqa: E402
    IPartitionLambda)
from fluidframework_tpu_torch.server.log import MessageLog  # noqa: E402
from fluidframework_tpu_torch.server.log_service import (  # noqa: E402
    LogServiceServer, RemoteMessageLog)
from fluidframework_tpu_torch.server.partition import (  # noqa: E402
    PartitionManager)


class Recorder(IPartitionLambda):
    def __init__(self, ctx):
        self.ctx = ctx
        self.seen = []

    def handler(self, message):
        self.seen.append((message.offset, message.key, message.value))
        self.ctx.checkpoint(message.offset)


class TestRemoteLog:
    def test_send_read_commit_roundtrip(self):
        server = LogServiceServer().start()
        try:
            remote = RemoteMessageLog(server.address)
            remote.topic("t", 1)
            m = remote.send("t", "doc-1", {"n": 1})
            remote.send("t", "doc-1", {"n": 2})
            assert m.offset == 0
            msgs = remote.topic("t").partitions[0].read(0)
            assert [x.value for x in msgs] == [{"n": 1}, {"n": 2}]
            assert remote.committed("g", "t", 0) == 0
            remote.commit("g", "t", 0, 0)
            assert remote.committed("g", "t", 0) == 1
            assert [x.value for x in remote.poll("g", "t")] == [{"n": 2}]
            remote.close()
        finally:
            server.stop()

    def test_partition_manager_over_remote_broker(self):
        """A LambdaRunner-style consumer in 'another process': pumps a
        remote broker, checkpoints offsets remotely, resumes after crash."""
        backing = MessageLog()
        server = LogServiceServer(backing).start()
        try:
            remote = RemoteMessageLog(server.address)
            remote.topic("raw", 1)
            lambdas = []

            def factory(ctx):
                lam = Recorder(ctx)
                lambdas.append(lam)
                return lam

            mgr = PartitionManager(remote, "deli", "raw", factory,
                                   auto_commit=False)
            for i in range(3):
                backing.send("raw", "doc", f"v{i}")  # producer elsewhere
            assert mgr.pump_all() == 3
            assert lambdas[-1].seen[-1][2] == "v2"
            # Offsets live in the broker: a fresh consumer process resumes.
            assert backing.committed("deli", "raw", 0) == 3
            backing.send("raw", "doc", "v3")
            mgr.restart()
            assert mgr.pump_all() == 1
            assert lambdas[-1].seen == [(3, "doc", "v3")]
            remote.close()
        finally:
            server.stop()

    def test_consumer_groups_isolated(self):
        server = LogServiceServer().start()
        try:
            remote = RemoteMessageLog(server.address)
            remote.topic("t", 1)
            remote.send("t", "k", "a")
            remote.commit("scribe", "t", 0, 0)
            assert remote.committed("scribe", "t", 0) == 1
            assert remote.committed("scriptorium", "t", 0) == 0
            remote.close()
        finally:
            server.stop()

    def test_send_to_many_and_read_from_over_wire(self):
        """The batched produce and explicit-offset read both cross the
        wire: one SendToMany RPC acks the whole batch with dense
        offsets, and Read serves arbitrary (cold) offsets — the
        rebalance wrapper's buffered-record recovery path against a
        remote broker."""
        backing = MessageLog()
        server = LogServiceServer(backing).start()
        try:
            remote = RemoteMessageLog(server.address)
            remote.topic("t", 2)
            msgs = remote.send_to_many(
                "t", 1, [(f"k{i}", {"n": i}) for i in range(6)])
            assert [m.offset for m in msgs] == list(range(6))
            assert [m.partition for m in msgs] == [1] * 6
            # Matches a local batched produce on the backing log.
            local = backing.topic("t").partitions[1].read(0, 10)
            assert [x.value for x in local] == [m.value for m in msgs]
            got = remote.read_from("t", 1, 2, limit=3)
            assert [m.value["n"] for m in got] == [2, 3, 4]
            assert [m.offset for m in got] == [2, 3, 4]
            assert remote.read_from("t", 0, 0) == []
            remote.close()
        finally:
            server.stop()

    def test_boxcar_payloads_survive_wire(self):
        server = LogServiceServer().start()
        try:
            remote = RemoteMessageLog(server.address)
            remote.topic("raw", 1)
            car = Boxcar(tenant_id="t", document_id="d", client_id="c",
                         contents=[{"op": 1}, {"op": 2}])
            remote.send("raw", "d", car)
            got = remote.topic("raw").partitions[0].read(0)[0].value
            assert got.document_id == "d" and len(got.contents) == 2
            remote.close()
        finally:
            server.stop()
