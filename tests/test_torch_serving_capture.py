"""The port's bucketed serving entry points (serve_window, serve_burst)
and a ring captured from a real JAX sequencer drive, replayed through the
port's serve_megakernel: bit-identical to the JAX package on the CPU.
Helpers and the generated fleet come from tests/test_torch_serving.py.
"""

import jax.numpy as jnp

from fluidframework_tpu.mergetree.state import DocState as JaxDocState
from fluidframework_tpu.server import lww_kernel as jlk
from fluidframework_tpu.server import serve_step as jss
from fluidframework_tpu.server import ticket_kernel as jtk

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree.oppack import OpKind
from fluidframework_tpu_torch.mergetree.state import DocState
from fluidframework_tpu_torch.server import lww_kernel as tlk
from fluidframework_tpu_torch.server import serve_step as tss
from fluidframework_tpu_torch.server import ticket_kernel as ttk
from fluidframework_tpu_torch.server.serve_step import RingArgs

from test_torch_serving import (_NAMES, Fleet, _jax_tree, assert_tree_equal,
                                jax_megakernel, port_megakernel, to_np)


def test_serve_window_and_burst_match_jax():
    """The bucketed entry points on the same staged columns, with the
    gathered pre-ring views standing in for capacity buckets."""
    f = Fleet(4)
    ring = f.stage()
    views = jax_megakernel(f.tstate, f.pool, f.lww, ring.args)[5]
    a = ring.args

    def jax_states():
        """Fresh JAX copies: the JAX entry points donate their states."""
        return (_jax_tree(f.tstate, jtk.TicketState),
                [_jax_tree(v, JaxDocState) for v in views],
                [_jax_tree(s, jlk.LwwState) for s in f.lww])

    t_views = [interop.doc_state_from_numpy(v._asdict(), "cpu")
               for v in views]
    t_ts = interop.ticket_state_from_numpy(f.tstate._asdict(), "cpu")
    t_lww = [interop.lww_state_from_numpy(s._asdict(), "cpu")
             for s in f.lww]
    t_args = interop.ring_args_from_numpy(a, "cpu")

    def jrun(x):
        return None if x is None else jnp.asarray(x)
    j_ts, j_views, j_lww = jax_states()
    want = to_np(jss.serve_window_keep(
        j_ts, jnp.asarray(a.ticket_xs[0]), j_views,
        [jnp.asarray(m[0]) for m in a.merge_xs], j_lww,
        [jnp.asarray(x[0]) for x in a.lww_xs], False,
        [None if r is None else jnp.asarray(r[0]) for r in a.runs_xs],
        True))
    got = to_np(tss.serve_window(
        t_ts, t_args.ticket_xs[0], t_views,
        [m[0] for m in t_args.merge_xs], t_lww,
        [x[0] for x in t_args.lww_xs],
        [None if r is None else r[0] for r in t_args.runs_xs], stats=True))
    assert_tree_equal(got, want, "serve_window")
    j_ts, j_views, j_lww = jax_states()
    want = to_np(jss.serve_burst(
        j_ts, j_views, j_lww, jnp.asarray(a.ticket_xs),
        [jnp.asarray(m) for m in a.merge_xs],
        [jnp.asarray(x) for x in a.lww_xs], [jrun(r) for r in a.runs_xs],
        False, True))
    got = to_np(tss.serve_burst(t_ts, t_views, t_lww, *t_args[:1],
                                t_args.merge_xs, t_args.lww_xs,
                                t_args.runs_xs, stats=True))
    assert_tree_equal(got, want, "serve_burst")


def _typing_waves():
    """Three documents; document 0 types a burst of cursor-advancing
    one-char inserts at one refSeq (an INSERT_RUN slot once packed)."""
    from fluidframework_tpu.mergetree.client import OP_INSERT
    from fluidframework_tpu.protocol.messages import (Boxcar,
                                                      DocumentMessage,
                                                      MessageType)
    from test_paged_memory import _join

    def ins(csn, ref, pos, text):
        return DocumentMessage(
            client_sequence_number=csn, reference_sequence_number=ref,
            type=MessageType.OPERATION,
            contents={"address": "s", "contents": {
                "address": "t", "contents": {
                    "type": OP_INSERT, "pos1": pos,
                    "seg": {"text": text}}}})

    waves = []
    for w in range(3):
        wave = []
        for d in range(3):
            msgs = [] if w else [_join(f"c{d}")]
            base = 1 + 7 * w if d == 0 else 1 + w
            if d == 0:
                msgs += [ins(7 * w + i + 1, base, 7 * w + i, "abcdefg"[i])
                         for i in range(7)]
            else:
                msgs.append(ins(w + 1, base, 0, "xy"))
            wave.append((d, Boxcar("t", f"m{d}", f"c{d}", msgs)))
        waves.append(wave)
    return waves


def test_captured_sequencer_ring_replays_bit_identical():
    from fluidframework_tpu.server import serve_step as real_ss
    from test_paged_memory import _emit_key, _lam, _qm

    captured = []
    real = real_ss.serve_megakernel

    def record(*args):
        captured.append(to_np(args[:11]) + (args[11], args[12]))
        return real(*args)

    real_ss.serve_megakernel = record
    try:
        emits = []
        lam = _lam(lambda doc, m: emits.append(_emit_key(doc, m)), True)
        off = 0
        for wave in _typing_waves():
            for d, box in wave:
                lam.handler_raw(_qm(off, f"m{d}", box))
                off += 1
            lam.flush()
        lam.drain()
    finally:
        real_ss.serve_megakernel = real
    assert captured, "the paged sequencer dispatched no megakernel ring"
    runs_seen = 0
    for (ts, pool, lww, tx, pids, cts, mns, sqs, mxs, lxs, rxs,
         _fused, stats) in captured:
        runs_seen += sum(int((m[:, 0] == OpKind.INSERT_RUN).sum())
                         for m in mxs)
        ring = RingArgs(tx, pids, cts, mns, sqs, mxs, lxs, rxs)
        ts = ttk.TicketState(*ts)
        pool = DocState(*pool)
        lww = tuple(tlk.LwwState(*s) for s in lww)
        want = jax_megakernel(ts, pool, lww, ring, stats=stats)
        got = port_megakernel(ts, pool, lww, ring, stats=stats)
        for name, g, w in zip(_NAMES, got, want):
            assert_tree_equal(g, w, name)
    assert runs_seen >= 1, "the capture holds no INSERT_RUN slot"
    assert emits
