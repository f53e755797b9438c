"""The port's op-tensor gRPC bridge (fluidframework_tpu_torch/server/
bridge.py) on the CPU: a mirror of tests/test_bridge.py (packed partition
batches through the north-star step, over real gRPC), then the frames
against the JAX bridge's, byte for byte, and the transport-free core.

The JAX file compares a reply with jax's full_step; the mirror compares
it with the port's full_step on the CPU, which tests/test_torch_pipeline.py
holds equal to jax's.
"""

import threading

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from fluidframework_tpu_torch import interop  # noqa: E402
from fluidframework_tpu_torch.mergetree.oppack import PackedOps  # noqa: E402
from fluidframework_tpu_torch.mergetree.state import make_state  # noqa: E402
from fluidframework_tpu_torch.server import ticket_kernel as tk  # noqa: E402
from fluidframework_tpu_torch.server.bridge import (  # noqa: E402
    OpBridge, OpBridgeClient, OpBridgeServer, decode_ops, decode_reply,
    encode_ops, encode_reply)
from fluidframework_tpu_torch.server.pipeline import full_step  # noqa: E402
from fluidframework_tpu_torch.testing.traces import gen_traces  # noqa: E402

DOCS, STEPS = 8, 20


def direct_result(cols):
    ops = interop.packed_ops_from_numpy(cols, device="cpu")
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)
    tstate = tk.make_ticket_state(8, batch=DOCS, device="cpu")
    mstate = make_state(64, 1, batch=DOCS, device="cpu")
    tstate, mstate, ticketed, total = full_step(tstate, mstate, raw, ops)
    return ticketed.seq.numpy(), total.numpy()


class TestFraming:
    def test_roundtrip(self):
        cols = gen_traces(DOCS, STEPS, seed=2)
        b, t, decoded = decode_ops(encode_ops(cols))
        assert (b, t) == (DOCS, STEPS)
        for field in PackedOps._fields:
            np.testing.assert_array_equal(decoded[field],
                                          np.asarray(cols[field], np.int32))


class TestBridge:
    def test_batch_matches_direct_pipeline(self):
        server = OpBridgeServer(capacity=64, device="cpu").start()
        try:
            client = OpBridgeClient(server.address)
            assert client.ping()
            cols = gen_traces(DOCS, STEPS, seed=2)
            reply = client.submit_batch(cols)
            seq_direct, total_direct = direct_result(cols)
            np.testing.assert_array_equal(reply["seq"], seq_direct)
            np.testing.assert_array_equal(reply["totalLen"], total_direct)
            client.close()
        finally:
            server.stop()

    def test_session_state_persists_across_batches(self):
        server = OpBridgeServer(capacity=128, device="cpu").start()
        try:
            client = OpBridgeClient(server.address, session_id="s1")
            first = gen_traces(DOCS, STEPS, seed=3)
            r1 = client.submit_batch(first)
            # Continuation batch: clientSeq/refSeq advance past batch one.
            cont = gen_traces(DOCS, STEPS, seed=4)
            for field in ("seq",):
                cont[field] = cont[field] + STEPS
            cont["ref_seq"] = cont["ref_seq"] + STEPS
            r2 = client.submit_batch(cont)
            # Sequence numbers continue monotonically per document.
            assert (r2["seq"].max(axis=1) > r1["seq"].max(axis=1)).all()
            # Documents kept their content: lengths only grow or shrink from
            # the continued state, never reset to batch-one totals.
            assert (r2["totalLen"] != 0).any()
            client.close()
        finally:
            server.stop()

    def test_isolated_sessions(self):
        server = OpBridgeServer(capacity=64, device="cpu").start()
        try:
            a = OpBridgeClient(server.address, session_id="a")
            b = OpBridgeClient(server.address, session_id="b")
            cols = gen_traces(DOCS, STEPS, seed=5)
            ra = a.submit_batch(cols)
            rb = b.submit_batch(cols)  # same ops, fresh session: same result
            np.testing.assert_array_equal(ra["seq"], rb["seq"])
            np.testing.assert_array_equal(ra["totalLen"], rb["totalLen"])
            a.close()
            b.close()
        finally:
            server.stop()


def _batches(session: int):
    """Three chained batches of one session: each continues the last's
    client and reference sequence numbers."""
    out = []
    for i in range(3):
        cols = gen_traces(DOCS, STEPS, seed=10 * session + i)
        cols["seq"] = cols["seq"] + i * STEPS
        cols["ref_seq"] = cols["ref_seq"] + i * STEPS
        out.append(cols)
    return out


def test_frames_equal_jax_over_grpc():
    """Request and reply frames byte-equal to the JAX bridge's over 3
    batches x 2 sessions (8 x 20, C = 64), both sessions interleaved."""
    from fluidframework_tpu.server import bridge as jax_bridge
    from fluidframework_tpu_torch.server import bridge as port_bridge

    replies = {}
    for name, mod, kw in (("jax", jax_bridge, {}),
                          ("port", port_bridge, {"device": "cpu"})):
        server = mod.OpBridgeServer(capacity=64, **kw).start()
        try:
            clients = [mod.OpBridgeClient(server.address,
                                          session_id=f"s{s}")
                       for s in range(2)]
            raw = []
            for i in range(3):
                for s, client in enumerate(clients):
                    cols = _batches(s)[i]
                    request = encode_ops(cols)
                    assert jax_bridge.encode_ops(cols) == request
                    raw.append(client._submit(
                        request, metadata=(("session-id", f"s{s}"),)))
            for client in clients:
                client.close()
        finally:
            server.stop()
        replies[name] = raw
    assert replies["port"] == replies["jax"]
    assert len({r[:64] for r in replies["port"]}) > 1


def test_submit_equals_chained_direct_step():
    """The transport-free core: each reply of submit() is byte-equal to
    encode_reply of the port's full_step chained by hand, per session,
    with the sessions interleaved (isolated: session 1 never sees session
    0's state)."""
    bridge = OpBridge(capacity=64, device="cpu")
    states = {s: (tk.make_ticket_state(8, batch=DOCS, device="cpu"),
                  make_state(64, 1, batch=DOCS, device="cpu"))
              for s in range(2)}
    for i in range(3):
        for s in range(2):
            cols = _batches(s)[i]
            reply = bridge.submit(f"s{s}", encode_ops(cols))
            raw, ops = bridge.to_device(decode_ops(encode_ops(cols))[2])
            tstate, mstate, ticketed, total = full_step(*states[s], raw,
                                                        ops)
            states[s] = (tstate, mstate)
            assert reply == encode_reply(
                ticketed.seq.numpy(), ticketed.min_seq.numpy(),
                ticketed.nacked.numpy().astype(np.int32), total.numpy())
    assert sorted(bridge.sessions) == [("s0", DOCS), ("s1", DOCS)]
    assert decode_reply(reply)["seq"].shape == (DOCS, STEPS)


def test_failed_step_evicts_its_session():
    """A step that raises evicts its session (JAX's contract, where the
    failed step consumed the donated state): the next request rebuilds
    fresh state, and other sessions are untouched."""
    bridge = OpBridge(capacity=64, device="cpu")
    cols = _batches(0)[0]
    first = bridge.submit("a", encode_ops(cols))
    bridge.submit("b", encode_ops(cols))
    real = bridge._full_step

    def boom(*args):
        raise RuntimeError("launch failed")

    bridge._full_step = boom
    with pytest.raises(RuntimeError, match="launch failed"):
        bridge.submit("a", encode_ops(_batches(0)[1]))
    bridge._full_step = real
    assert sorted(bridge.sessions) == [("b", DOCS)]
    assert bridge.submit("a", encode_ops(cols)) == first


def test_malformed_frame_raises():
    frame = encode_ops(gen_traces(DOCS, STEPS, seed=1))
    with pytest.raises(ValueError, match="does not hold"):
        decode_ops(frame[:-4])
    with pytest.raises(ValueError, match="shape"):
        cols = gen_traces(DOCS, STEPS, seed=1)
        cols["pos1"] = cols["pos1"][:, :3]
        encode_ops(cols)


def test_concurrent_sessions_keep_launch_counts(monkeypatch):
    """Four threads submit to four sessions at once: every reply equals
    the session's serial reply, and a counter bumped inside each step
    loses no update (the steps run one at a time)."""
    serial = {}
    for s in range(4):
        alone = OpBridge(capacity=64, device="cpu")
        serial[s] = [alone.submit("x", encode_ops(c)) for c in _batches(s)]
    bridge = OpBridge(capacity=64, device="cpu")
    calls = {"n": 0}
    real = bridge._full_step

    def counted(*args):
        n = calls["n"]
        out = real(*args)
        calls["n"] = n + 1      # read-modify-write around the step
        return out

    bridge._full_step = counted
    got, errors = {}, []

    def worker(s):
        try:
            got[s] = [bridge.submit(f"s{s}", encode_ops(c))
                      for c in _batches(s)]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == serial
    assert calls["n"] == 12
