"""The port's copies of the sequencer's leaf modules against the JAX
package: protocol/messages.py, server/wire.py (the wire bytes of a boxcar
must equal JAX's, and every codec must round-trip), server/log.py
(MessageLog produce / poll / commit, subscribe and unsubscribe, the
broker factory) and server/lambdas/base.py (LambdaContext checkpoints,
the ack batcher, errors).
"""

import dataclasses

import pytest

from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu.server import log as jlog
from fluidframework_tpu.server import wire as jwire
from fluidframework_tpu.server.lambdas import base as jbase

from fluidframework_tpu_torch import protocol
from fluidframework_tpu_torch.protocol import messages as tmsg
from fluidframework_tpu_torch.server import log as tlog
from fluidframework_tpu_torch.server import wire as twire
from fluidframework_tpu_torch.server.lambdas import (IPartitionLambda,
                                                     LambdaContext)
from fluidframework_tpu_torch.telemetry import counters


def boxcar(m):
    """The same boxcar built from either package's dataclasses: an op with
    nested contents, unicode and a trace, a system message with data, and
    a no-op."""
    ops = [
        m.DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=m.MessageType.OPERATION,
            contents={"address": "root", "contents": {
                "type": 0, "pos1": 3, "seg": {"text": 'h"é\\llo'}}},
            metadata={"trace": "t:s:1"},
            traces=[m.ITrace("alfred", "start", 1234.5)]),
        m.DocumentMessage(2, 1, m.MessageType.CLIENT_JOIN,
                          data='{"clientId": "c-1"}'),
        m.DocumentMessage(3, 1, m.MessageType.NO_OP),
    ]
    return m.Boxcar("tenant", "doc-7", "c-1", ops)


def test_message_constants_match_jax():
    for name in ("NO_OP", "CLIENT_JOIN", "OPERATION", "SUMMARIZE",
                 "SYSTEM_TYPES", "CONTROL"):
        assert getattr(tmsg.MessageType, name) == \
            getattr(jmsg.MessageType, name)
    for name in ("NACK_BAD_REF_SEQ", "NACK_DUPLICATE", "NACK_TOO_LARGE",
                 "NACK_THROTTLED", "NACK_NOT_WRITER",
                 "NACK_SERVICE_UNAVAILABLE"):
        assert getattr(tmsg, name) == getattr(jmsg, name)
    for cls in ("DocumentMessage", "SequencedDocumentMessage", "Nack",
                "NackContent", "Boxcar", "SignalMessage", "ITrace"):
        assert [f.name for f in dataclasses.fields(getattr(tmsg, cls))] == \
            [f.name for f in dataclasses.fields(getattr(jmsg, cls))]
    assert protocol.Boxcar is tmsg.Boxcar


def test_boxcar_wire_bytes_match_jax_and_round_trip():
    raw = twire.boxcar_to_wire(boxcar(tmsg))
    assert raw == jwire.boxcar_to_wire(boxcar(jmsg))
    back = twire.boxcar_from_wire(raw)
    assert back == boxcar(tmsg)
    assert twire.boxcar_to_wire(back) == raw
    assert dataclasses.asdict(back) == \
        dataclasses.asdict(jwire.boxcar_from_wire(raw))


def test_message_codecs_round_trip_and_match_jax():
    for t_op, j_op in zip(boxcar(tmsg).contents, boxcar(jmsg).contents):
        d = twire.document_message_to_dict(t_op)
        assert d == jwire.document_message_to_dict(j_op)
        assert twire.document_message_from_dict(d) == t_op
        seq = tmsg.SequencedDocumentMessage.from_document_message(
            t_op, "c-1", 17, 9, timestamp=5.0)
        jseq = jmsg.SequencedDocumentMessage.from_document_message(
            j_op, "c-1", 17, 9, timestamp=5.0)
        sd = twire.sequenced_message_to_dict(seq)
        assert sd == jwire.sequenced_message_to_dict(jseq)
        assert twire.sequenced_message_from_dict(sd) == seq
        assert seq.to_json() == jseq.to_json()
        assert twire.delta_rows_to_messages([sd, sd]) == [seq, seq]
        assert tmsg.op_size(t_op) == jmsg.op_size(j_op)
        assert tmsg.op_size_exact(t_op) == jmsg.op_size_exact(j_op)
    nack = tmsg.Nack(boxcar(tmsg).contents[0], 4,
                     tmsg.NackContent(tmsg.NACK_THROTTLED, "slow", 0.5))
    jnack = jmsg.Nack(boxcar(jmsg).contents[0], 4,
                      jmsg.NackContent(jmsg.NACK_THROTTLED, "slow", 0.5))
    assert twire.nack_to_dict(nack) == jwire.nack_to_dict(jnack)
    assert twire.nack_from_dict(twire.nack_to_dict(nack)) == nack
    bare = tmsg.Nack(None, 1, tmsg.NackContent(400))
    assert twire.nack_from_dict(twire.nack_to_dict(bare)) == bare
    one = boxcar(tmsg).contents[0]
    assert tmsg.extract_boxcar(one).contents == [one]
    with pytest.raises(TypeError):
        tmsg.extract_boxcar("not a record")


def drive_log(mod):
    """Produce, poll, commit, subscribe / unsubscribe on one MessageLog:
    returns what a consumer saw."""
    log = mod.MessageLog(default_partitions=4)
    seen = []
    part = log.topic("raw").partition_for("doc-7").index
    log.subscribe("raw", part, seen.append)
    for i in range(3):
        log.send("raw", "doc-7", f"m{i}")
    log.unsubscribe("raw", part, seen.append)
    log.unsubscribe("raw", part, seen.append)   # a second removal is a no-op
    log.send("raw", "doc-7", "after")
    log.send_to_many("deltas", 1, [("a", 1), ("b", 2)])
    log.commit("g", "raw", part, 1)
    log.commit("g", "raw", part, 0)                  # never regresses
    log.commit_many("g", "deltas", {1: 0})
    return (part, [(q.offset, q.value) for q in seen],
            [q.value for q in log.poll("g", "raw", part)],
            [q.value for q in log.poll("g", "deltas", 1)],
            [q.value for q in log.read_from("raw", part, 0, limit=2)],
            log.committed("g", "raw", part),
            log.topic("raw").partitions[part].end_offset)


def test_message_log_matches_jax():
    got = drive_log(tlog)
    assert got == drive_log(jlog)
    assert got[1] == [(0, "m0"), (1, "m1"), (2, "m2")]   # not "after"
    assert got[2] == ["m2", "after"]


def test_make_message_log():
    """native=None (the default) and native=True build the C++ engine and
    use it, as the JAX factory does where its engine builds, and count no
    fallback; native=False pins the pure-Python engine."""
    from fluidframework_tpu_torch.native.oplog import NativeMessageLog
    before = counters.get("swallowed.log.native_fallback")
    log = tlog.make_message_log(2)
    assert isinstance(log, NativeMessageLog)
    assert len(log.topic("raw").partitions) == 2
    assert isinstance(tlog.make_message_log(native=True), NativeMessageLog)
    assert type(tlog.make_message_log(native=False)) is tlog.MessageLog
    assert counters.get("swallowed.log.native_fallback") == before


class _Batcher:
    def __init__(self):
        self.noted = []

    def note(self, partition, offset):
        self.noted.append((partition, offset))


def test_lambda_context_matches_jax():
    for log_mod, base in ((tlog, None), (jlog, jbase)):
        ctx_cls = LambdaContext if base is None else base.LambdaContext
        log = log_mod.MessageLog()
        errors = []
        ctx = ctx_cls(log, "deli", "raw", 0,
                      on_error=lambda e, r: errors.append((str(e), r)))
        ctx.checkpoint(4)
        assert log.committed("deli", "raw", 0) == 5
        ctx.ack_batcher = _Batcher()
        ctx.checkpoint(9)
        assert log.committed("deli", "raw", 0) == 5
        assert ctx.ack_batcher.noted == [(0, 9)]
        ctx.error(ValueError("x"), True)
        assert errors == [("x", True)]
        bare = ctx_cls(log, "deli", "raw", 0)
        bare.error(ValueError("soft"), False)        # not raised
        with pytest.raises(ValueError, match="hard"):
            bare.error(ValueError("hard"), True)
    lam = IPartitionLambda()
    with pytest.raises(NotImplementedError):
        lam.handler(None)
    assert lam.flush() is None and lam.close() is None
