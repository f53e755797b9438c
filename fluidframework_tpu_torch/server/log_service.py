"""Remote ordered-log service: the networked broker deployment shape.

Capability parity with the reference's Kafka deployment topology
(docker-compose.yml: every lambda service — deli, scriptorium, scribe,
broadcaster — is a separate process connecting to the broker over the
network through librdkafka): `LogServiceServer` exposes a MessageLog
(pure-Python or the native C++ engine) over gRPC raw-bytes methods, and
`RemoteMessageLog` is a drop-in consumer/producer surface — the same
`topic().partitions[].read()` / `send` / `commit` contract the partition
host and lambdas already use in-process — so a `LambdaRunner` can run in a
different process (or host, over DCN) from the broker.

Payloads are pickled across the wire (a trusted internal link, exactly the
role rdkafka's serialized frames play; the front door speaking to untrusted
clients is alfred's REST/WebSocket + JWT, not this).

A port of fluidframework_tpu's server/log_service.py. Payloads pickle
this package's classes, so a broker of one package carries that
package's messages only. Each remote call has a deadline
(CALL_TIMEOUT_S), which the reference's has not.
"""

from __future__ import annotations

import pickle
import threading
from concurrent import futures
from typing import Dict, List, Optional

from ..telemetry.counters import record_swallow
from .log import MessageLog, QueuedMessage

SERVICE = "fluidframework.LogService"
# Every remote call carries this deadline: a broker that accepts and never
# answers fails the call (and the reconnect policy retries it) instead of
# blocking its caller forever.
CALL_TIMEOUT_S = 30.0


class LogServiceServer:
    def __init__(self, log: Optional[MessageLog] = None, port: int = 0,
                 max_workers: int = 8):
        import grpc
        self.log = log if log is not None else MessageLog()
        service = self

        def method(fn):
            return grpc.unary_unary_rpc_method_handler(fn)

        handlers = {
            f"/{SERVICE}/Send": method(service._send),
            f"/{SERVICE}/SendTo": method(service._send_to),
            f"/{SERVICE}/SendToMany": method(service._send_to_many),
            f"/{SERVICE}/Read": method(service._read),
            f"/{SERVICE}/Commit": method(service._commit),
            f"/{SERVICE}/CommitMany": method(service._commit_many),
            f"/{SERVICE}/Committed": method(service._committed),
            f"/{SERVICE}/Topic": method(service._topic),
        }

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                return handlers.get(details.method)

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self) -> "LogServiceServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    # -- methods (request/response are pickled tuples) ----------------------
    def _send(self, request: bytes, context) -> bytes:
        topic, key, value = pickle.loads(request)
        msg = self.log.send(topic, key, value)
        return pickle.dumps(msg.offset)

    def _send_to(self, request: bytes, context) -> bytes:
        topic, partition, key, value = pickle.loads(request)
        msg = self.log.send_to(topic, partition, key, value)
        return pickle.dumps(msg.offset)

    def _send_to_many(self, request: bytes, context) -> bytes:
        # Batched explicit-partition produce: one RPC for the whole list,
        # and — when the broker engine is the durable log — one group
        # commit (one fsync) covering every record in it.
        topic, partition, items = pickle.loads(request)
        msgs = self.log.send_to_many(topic, partition, items)
        return pickle.dumps([m.offset for m in msgs])

    def _read(self, request: bytes, context) -> bytes:
        topic, partition, offset, limit = pickle.loads(request)
        # read_from (not part.read): on a durable broker opened with
        # replay="committed" it serves offsets below the resident window
        # from the segment files via the sparse index.
        reader = getattr(self.log, "read_from", None)
        if reader is not None:
            msgs = reader(topic, partition, offset, limit)
        else:
            msgs = self.log.topic(topic).partitions[partition].read(
                offset, limit)
        return pickle.dumps([(m.offset, m.key, m.value) for m in msgs])

    def _commit(self, request: bytes, context) -> bytes:
        group, topic, partition, offset = pickle.loads(request)
        self.log.commit(group, topic, partition, offset)
        return pickle.dumps(True)

    def _commit_many(self, request: bytes, context) -> bytes:
        group, topic, offsets = pickle.loads(request)
        self.log.commit_many(group, topic, offsets)
        return pickle.dumps(True)

    def _committed(self, request: bytes, context) -> bytes:
        group, topic, partition = pickle.loads(request)
        return pickle.dumps(self.log.committed(group, topic, partition))

    def _topic(self, request: bytes, context) -> bytes:
        name, partitions = pickle.loads(request)
        topic = self.log.topic(name, partitions)
        return pickle.dumps(len(topic.partitions))


class _RemotePartition:
    def __init__(self, client: "RemoteMessageLog", topic: str, index: int):
        self._client = client
        self.topic = topic
        self.index = index

    def read(self, offset: int, limit: int = 1000) -> List[QueuedMessage]:
        rows = self._client._call("Read",
                                  (self.topic, self.index, offset, limit))
        return [QueuedMessage(self.topic, self.index, off, key, value)
                for off, key, value in rows]


class _RemoteTopic:
    def __init__(self, client: "RemoteMessageLog", name: str,
                 n_partitions: int):
        self.name = name
        self.partitions = [_RemotePartition(client, name, i)
                           for i in range(n_partitions)]


class RemoteMessageLog:
    """MessageLog-compatible client over a LogServiceServer.

    Broker outages (restart, network blip) are handled HERE with a
    bounded-backoff deterministic reconnect: on UNAVAILABLE (or a call
    past its deadline, CALL_TIMEOUT_S) the client
    closes and rebuilds its channel (discarding gRPC's internal
    reconnect backoff state, which can sit in a multi-second wait after
    repeated failures) and retries through a RetryPolicy. Workers no
    longer depend on the container's gRPC channel-backoff timing to
    notice a restarted broker — the class of flake behind the
    tests/test_deployment.py broker-restart test. Retried sends are
    at-least-once (the pipeline dedups by offset/clientSequenceNumber
    downstream, exactly as for a crash-replayed partition)."""

    def __init__(self, address: str, default_partitions: int = 1,
                 reconnect_policy=None):
        import grpc
        self._grpc = grpc
        self._address = address
        self._channel = grpc.insecure_channel(address)
        self.default_partitions = default_partitions
        self._methods = {}
        self._topics = {}
        self._lock = threading.Lock()
        if reconnect_policy is None:
            from ..core.retry import RetryPolicy
            reconnect_policy = RetryPolicy(max_attempts=8,
                                           base_delay_s=0.05,
                                           max_delay_s=2.0)
        self._reconnect = reconnect_policy

    def _rebuild_channel(self) -> None:
        with self._lock:
            try:
                self._channel.close()
            except Exception:  # noqa: BLE001 — dead channel teardown
                record_swallow("log_service.channel_close")
            self._channel = self._grpc.insecure_channel(self._address)
            self._methods.clear()

    def _call(self, name: str, payload):
        from ..core.retry import NonRetryableError

        def once():
            with self._lock:
                stub = self._methods.get(name)
                if stub is None:
                    stub = self._channel.unary_unary(
                        f"/{SERVICE}/{name}",
                        request_serializer=lambda b: b,
                        response_deserializer=lambda b: b)
                    self._methods[name] = stub
            try:
                return pickle.loads(stub(pickle.dumps(payload),
                                         timeout=CALL_TIMEOUT_S))
            except self._grpc.RpcError as err:
                code = err.code() if hasattr(err, "code") else None
                if code in (self._grpc.StatusCode.UNAVAILABLE,
                            self._grpc.StatusCode.DEADLINE_EXCEEDED):
                    # Transport outage: fresh channel, then the policy's
                    # jittered bounded backoff decides the retry cadence.
                    self._rebuild_channel()
                    raise
                raise NonRetryableError(str(err)) from err

        return self._reconnect.run(once)

    # -- MessageLog surface --------------------------------------------------
    def topic(self, name: str, partitions: Optional[int] = None
              ) -> _RemoteTopic:
        known = self._topics.get(name)
        if known is None or (partitions is not None
                             and partitions != len(known.partitions)):
            n = self._call("Topic",
                           (name, partitions or self.default_partitions))
            known = _RemoteTopic(self, name, n)
            self._topics[name] = known
        return known

    def send(self, topic: str, key: str, value) -> QueuedMessage:
        offset = self._call("Send", (topic, key, value))
        return QueuedMessage(topic, 0, offset, key, value)

    def send_to(self, topic: str, partition: int, key: str,
                value) -> QueuedMessage:
        """Produce to an EXPLICIT partition (MessageLog.send_to parity)
        — the sharded ingest tier's md5 document routing must override
        the broker's own key hash."""
        offset = self._call("SendTo", (topic, partition, key, value))
        return QueuedMessage(topic, partition, offset, key, value)

    def send_to_many(self, topic: str, partition: int,
                     items) -> List[QueuedMessage]:
        """Batched explicit-partition produce in ONE round trip — the
        producer-side twin of commit_many. On a durable broker the whole
        list also shares one group commit, so the per-record fsync AND
        the per-record network hop amortize together. At-least-once on
        retry applies to the whole batch (UNAVAILABLE mid-call can
        re-append a prefix; the pipeline dedups downstream exactly as
        for a retried send_to)."""
        items = list(items)
        offsets = self._call("SendToMany", (topic, partition, items))
        return [QueuedMessage(topic, partition, off, key, value)
                for off, (key, value) in zip(offsets, items)]

    def commit_many(self, group: str, topic: str,
                    offsets: Dict[int, int]) -> None:
        """Batched cross-partition ack: ONE round trip commits a whole
        pump round's per-partition offsets (the win that matters on this
        networked deployment shape — N partitions stop costing N gRPC
        calls per checkpoint flush)."""
        self._call("CommitMany", (group, topic, dict(offsets)))

    def poll(self, group: str, topic: str, partition: int = 0,
             limit: int = 1000) -> List[QueuedMessage]:
        start = self.committed(group, topic, partition)
        return self.topic(topic).partitions[partition].read(start, limit)

    def read_from(self, topic: str, partition: int, offset: int,
                  limit: int = 1000) -> List[QueuedMessage]:
        """Group-independent explicit-offset read (MessageLog.read_from
        parity); the broker side serves cold offsets from its segment
        index on a durable engine."""
        rows = self._call("Read", (topic, partition, offset, limit))
        return [QueuedMessage(topic, partition, off, key, value)
                for off, key, value in rows]

    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        self._call("Commit", (group, topic, partition, offset))

    def committed(self, group: str, topic: str, partition: int) -> int:
        return self._call("Committed", (group, topic, partition))

    def close(self) -> None:
        self._channel.close()
