"""The port's telemetry (fluidframework_tpu_torch/telemetry/tracing.py and
counters.py), mirroring the unit tests of tests/test_tracing.py on the
CPU: span and context semantics, the sampling policy, the flight
recorder, wire propagation and the Chrome export, and the trace roots of
the port's MergeTreeClient local edits. The JAX package's message classes
are not ported, so the wire cases stamp a stand-in message with a
`metadata` attribute, and the JSON round trip goes through the message's
dict form. The server-pipeline cases wait for the port's sequencer.
Each section also holds the port's module against the JAX package's on
the same calls where their outputs are comparable.
"""

import dataclasses
import json
import os
import threading
from typing import Any, Optional

import pytest

from fluidframework_tpu.telemetry import counters as jax_counters
from fluidframework_tpu.telemetry import tracing as jax_tracing

from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
from fluidframework_tpu_torch.telemetry import counters, tracing


@dataclasses.dataclass
class Message:
    """A stand-in for protocol.messages.DocumentMessage: the fields the
    tracing helpers read."""
    client_sequence_number: int
    reference_sequence_number: int
    type: str
    metadata: Optional[Any] = None


@pytest.fixture(autouse=True)
def _clean():
    counters.reset()
    tracing.reset()
    yield
    counters.reset()
    tracing.reset()


class TestSpanBasics:
    def test_disabled_is_noop(self):
        assert not tracing.enabled()
        with tracing.span("x", root=True):
            pass
        assert len(tracing.recorder) == 0

    def test_root_span_records_when_sampled(self):
        tracing.configure(sample=1)
        with tracing.span("stage", root=True, detail=7):
            pass
        spans = tracing.recorder.snapshot()
        assert [s["name"] for s in spans] == ["stage"]
        assert spans[0]["attrs"]["detail"] == 7
        assert spans[0]["parent_id"] is None

    def test_nesting_inherits_trace_and_parent(self):
        tracing.configure(sample=1)
        with tracing.span("outer", root=True) as outer:
            with tracing.span("inner"):
                pass
        inner, outer_rec = tracing.recorder.snapshot()
        assert inner["name"] == "inner"
        assert inner["trace_id"] == outer_rec["trace_id"]
        assert inner["parent_id"] == outer.ctx.span_id

    def test_non_root_without_parent_is_silent(self):
        tracing.configure(sample=1)
        with tracing.span("orphan"):
            pass
        assert len(tracing.recorder) == 0

    def test_exception_records_error_span(self):
        tracing.configure(sample=1)
        with pytest.raises(RuntimeError):
            with tracing.span("bad", root=True):
                raise RuntimeError("boom")
        (span,) = tracing.recorder.snapshot()
        assert span["attrs"].get("error") is True

    def test_explicit_end_is_idempotent(self):
        tracing.configure(sample=1)
        sp = tracing.span("once", root=True)
        sp.end()
        sp.end()
        assert len(tracing.recorder) == 1

    def test_hist_feeds_histogram_even_when_disabled(self):
        with tracing.span("s", hist="stage.x"):
            pass
        snap = counters.latency_snapshot()
        assert snap["stage.x"]["count"] == 1
        assert len(tracing.recorder) == 0


class TestSampling:
    def test_one_in_n(self):
        tracing.configure(sample=4)
        roots = [tracing.new_op_trace() for _ in range(16)]
        minted = [r for r in roots if r is not None]
        assert len(minted) == 4

    def test_always_sample_on_slow(self):
        tracing.configure(sample=1000, slow_ms=0.0)
        ctx = tracing.TraceContext("f" * 16, "1", sampled=False)
        with tracing.span("slowpoke", parent=ctx):
            pass
        spans = tracing.recorder.snapshot()
        assert [s["name"] for s in spans] == ["slowpoke"]
        assert spans[0]["sampled"] is False

    def test_fast_unsampled_not_recorded(self):
        tracing.configure(sample=1000, slow_ms=10_000.0)
        ctx = tracing.TraceContext("f" * 16, "1", sampled=False)
        with tracing.span("fast", parent=ctx):
            pass
        assert len(tracing.recorder) == 0


class TestFlightRecorder:
    def test_bounded_overwrites_oldest(self):
        tracing.configure(sample=1, capacity=4)
        for i in range(7):
            with tracing.span(f"s{i}", root=True):
                pass
        names = [s["name"] for s in tracing.recorder.snapshot()]
        assert names == ["s3", "s4", "s5", "s6"]
        assert tracing.recorder.dropped == 3

    def test_drain_clears(self):
        tracing.configure(sample=1)
        with tracing.span("a", root=True):
            pass
        assert len(tracing.recorder.drain()) == 1
        assert tracing.recorder.drain() == []

    def test_concurrent_records(self):
        tracing.configure(sample=1, capacity=4096)

        def work():
            for _ in range(100):
                with tracing.span("t", root=True):
                    pass

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(tracing.recorder) == 400


class TestWirePropagation:
    def test_stamp_and_extract(self):
        tracing.configure(sample=1)
        ctx = tracing.TraceContext("t" * 16, "1", sampled=True)
        msg = Message(1, 0, "op")
        tracing.stamp_message(msg, ctx)
        assert msg.metadata == {"trace": f"{'t' * 16}:1:1"}
        back = tracing.message_context(msg)
        assert back.trace_id == ctx.trace_id
        assert back.span_id == "1"
        assert back.sampled is True

    def test_unsampled_wire_round_trip(self):
        tracing.configure(sample=1)
        ctx = tracing.TraceContext("abc", "9", sampled=False)
        back = tracing.TraceContext.from_wire(ctx.to_wire())
        assert back.sampled is False and back.trace_id == "abc"

    def test_legacy_dict_form_still_parses(self):
        tracing.configure(sample=1)
        back = tracing.TraceContext.from_wire(
            {"traceId": "x", "spanId": "2", "sampled": False})
        assert back.trace_id == "x" and back.sampled is False

    def test_stamp_preserves_existing_metadata(self):
        tracing.configure(sample=1)
        msg = Message(1, 0, "op", metadata={"batch": True})
        tracing.stamp_message(msg, tracing.TraceContext("a", "b"))
        assert msg.metadata["batch"] is True
        assert tracing.message_context(msg).trace_id == "a"

    def test_context_survives_json_round_trip(self):
        tracing.configure(sample=1)
        msg = Message(1, 0, "op")
        tracing.stamp_message(msg, tracing.TraceContext("deadbeef", "7"))
        wire = json.loads(json.dumps(dataclasses.asdict(msg)))
        back = tracing.message_context(Message(**wire))
        assert back is not None and back.trace_id == "deadbeef"

    def test_op_trace_handoff(self):
        tracing.configure(sample=1)
        ctx = tracing.new_op_trace()
        assert ctx is not None
        assert tracing.take_op_trace() is ctx
        assert tracing.take_op_trace() is None

    def test_unsampled_edit_decision_respected_at_submit(self):
        tracing.configure(sample=2)
        minted = 0
        for _ in range(20):
            edit_ctx = tracing.new_op_trace()
            submit_ctx = tracing.ensure_op_context()
            assert (edit_ctx is None) == (submit_ctx is None)
            if submit_ctx is not None:
                assert submit_ctx is edit_ctx
                minted += 1
        assert minted == 10

    def test_wire_form_equals_jax(self):
        """The same context strings as the JAX package's, both ways."""
        for sampled in (True, False):
            ours = tracing.TraceContext("abc", "9", sampled=sampled)
            theirs = jax_tracing.TraceContext("abc", "9", sampled=sampled)
            assert ours.to_wire() == theirs.to_wire()
            back = jax_tracing.TraceContext.from_wire(ours.to_wire())
            assert (back.trace_id, back.span_id, back.sampled) == \
                ("abc", "9", sampled)


class TestChromeExport:
    def test_events_shape(self):
        tracing.configure(sample=1)
        with tracing.span("parent", root=True):
            with tracing.span("child"):
                pass
        out = tracing.chrome_trace()
        assert json.dumps(out)
        assert out["displayTimeUnit"] == "ms"
        by_name = {e["name"]: e for e in out["traceEvents"]}
        assert set(by_name) == {"parent", "child"}
        for e in out["traceEvents"]:
            assert e["ph"] == "X" and e["pid"] == os.getpid()
            assert e["args"]["proc"] == tracing.process_name()
            assert e["dur"] >= 0
        assert (by_name["child"]["args"]["parent_id"]
                == by_name["parent"]["args"]["span_id"])

    def test_export_equals_jax_on_the_same_spans(self):
        spans = [{"name": "a", "ts": 1.0, "dur": 2.0, "tid": 3,
                  "trace_id": "t", "span_id": "1", "parent_id": None,
                  "attrs": {"k": 1}, "sampled": True},
                 {"name": "b", "ts": 2.0, "dur": 0.5, "tid": 3,
                  "trace_id": "t", "span_id": "2", "parent_id": "1",
                  "attrs": {}, "sampled": False}]
        tracing.set_process_name("proc")
        jax_tracing.set_process_name("proc")
        try:
            assert tracing.chrome_trace_json(spans) == \
                jax_tracing.chrome_trace_json(spans)
        finally:
            jax_tracing.set_process_name(None)


class TestCounters:
    def test_histograms_and_gauges_equal_jax(self):
        """observe / latency_snapshot / histogram_export / gauge /
        record_swallow / bounded on the same inputs give the JAX
        package's values (under names no other test uses, so the JAX
        package's process-wide counters need no reset)."""
        stage, fam = "torch_mirror.stage", "torch_mirror.fam"
        for mod in (counters, jax_counters):
            for ms in (0.1, 0.7, 3.0, 3.0, 40.0, 9000.0, 20000.0):
                mod.observe(stage, ms, trace_id=f"t{ms}")
            mod.gauge("torch_mirror.rate", 2.5)
            mod.record_swallow("torch_mirror")
            mod.increment(mod.bounded(fam, "x"))
        assert counters.latency_snapshot()[stage] == \
            jax_counters.latency_snapshot()[stage]
        assert counters.histogram_export()[stage] == \
            jax_counters.histogram_export()[stage]
        assert counters.latency_window(stage) == \
            jax_counters.latency_window(stage)
        for name in ("torch_mirror.rate", "swallowed.torch_mirror",
                     f"{fam}.x"):
            assert counters.get(name) == jax_counters.get(name) > 0
        assert counters.nearest_rank([1, 2], 0.5) == 1
        jax_counters.reset_stage(stage)


class TestClientEditRoots:
    def test_local_edit_mints_trace_and_parks_context(self):
        tracing.configure(sample=1)
        client = MergeTreeClient(client_id=0, device="cpu")
        client.insert_text_local(0, "hello")
        spans = tracing.recorder.snapshot()
        assert [s["name"] for s in spans] == ["client.local_edit"]
        parked = tracing.take_op_trace()
        assert parked is not None
        assert parked.trace_id == spans[0]["trace_id"]

    def test_edits_untraced_when_disabled(self):
        client = MergeTreeClient(client_id=0, device="cpu")
        client.insert_text_local(0, "hello")
        assert len(tracing.recorder) == 0
        assert tracing.take_op_trace() is None
