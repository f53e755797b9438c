"""The port's LWW lanes (fluidframework_tpu_torch/server/lww_kernel.py)
against the JAX package's lww_kernel: the same seeded [B, T] op streams
through `_scan` / `apply_lww_batched`, every field bit for bit, including
slot-table overflow and the argmax-of-nothing rule (first free slot 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.server import lww_kernel as jlk

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.server import lww_kernel as tlk


def _ops(rng, b, t, keys, kinds=(0, 1, 1, 1, 2, 3, 4)):
    return {
        "kind": rng.choice(kinds, (b, t)).astype(np.int32),
        "key": rng.integers(0, keys, (b, t)).astype(np.int32),
        "val": rng.integers(0, 10_000, (b, t)).astype(np.int32),
        "delta": rng.integers(-2**31, 2**31 - 1, (b, t)).astype(np.int32),
        "seq": np.tile(np.arange(1, t + 1, dtype=np.int32), (b, 1)),
    }


def _state_np(capacity, b):
    return {f: np.asarray(v) for f, v in zip(
        jlk.LwwState._fields, jlk.make_lww_state(capacity, batch=b))}


def _compare(state, ops):
    want = jlk.apply_lww_batched(
        jlk.LwwState(**{f: jnp.asarray(v) for f, v in state.items()}),
        jlk.LwwOps(**{f: jnp.asarray(v) for f, v in ops.items()}))
    t_state = interop.lww_state_from_numpy(state, "cpu")
    got = tlk.apply_lww_batched(
        t_state, tlk.LwwOps(**{f: torch.from_numpy(v)
                               for f, v in ops.items()}))
    for f in jlk.LwwState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    return got, t_state


@pytest.mark.parametrize("seed,b,t,capacity,keys", [
    (0, 16, 24, 8, 6),      # roomy tables
    (1, 8, 40, 4, 9),       # more keys than slots: SET overflow
    (2, 32, 12, 64, 48),    # the serving capacity
])
def test_scan_matches_jax(seed, b, t, capacity, keys):
    rng = np.random.default_rng(seed)
    state = _state_np(capacity, b)
    got, before = _compare(state, _ops(rng, b, t, keys))
    if keys > capacity:
        assert got.overflow.any()
    for f in tlk.LwwState._fields:  # the input is not mutated
        np.testing.assert_array_equal(getattr(before, f).numpy(), state[f])


def test_from_a_used_state_and_clears():
    rng = np.random.default_rng(7)
    state = _state_np(8, 6)
    first, _ = _compare(state, _ops(rng, 6, 10, 5, kinds=(1, 1, 4)))
    used = {f: getattr(first, f).numpy() for f in tlk.LwwState._fields}
    _compare(used, _ops(rng, 6, 20, 7, kinds=(0, 1, 2, 3, 4)))


def test_make_and_grow_match_jax():
    ours = tlk.make_lww_state(4, 3, device="cpu")
    theirs = jlk.make_lww_state(4, batch=3)
    for f in tlk.LwwState._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(theirs, f)))
    rng = np.random.default_rng(3)
    got, _ = _compare(_state_np(4, 3), _ops(rng, 3, 9, 6, kinds=(1,)))
    wide = tlk.grow_lane_capacity(got, 8)
    jwide = jlk.grow_lane_capacity(
        jlk.LwwState(**{f: jnp.asarray(getattr(got, f).numpy())
                        for f in tlk.LwwState._fields}), 8)
    for f in tlk.LwwState._fields:
        np.testing.assert_array_equal(getattr(wide, f).numpy(),
                                      np.asarray(getattr(jwide, f)))
    assert tlk.grow_lane_capacity(got, 4) is got


def test_edge_ops_match_jax():
    """Kinds past ADD (no op), NOOPs, seq <= 0 (last_seq keeps its max),
    DELETE of keys no slot holds and SET of the free key -1, on a table
    that starts part full."""
    rng = np.random.default_rng(11)
    b, t, c = 6, 30, 8
    state = _state_np(c, b)
    state["key"] = np.where(rng.random((b, c)) < 0.5,
                            rng.integers(0, 12, (b, c)), -1).astype(np.int32)
    state["val"] = np.where(state["key"] >= 0, 3, -1).astype(np.int32)
    state["last_seq"] = rng.integers(0, 9, b).astype(np.int32)
    ops = _ops(rng, b, t, 16, kinds=(0, 1, 2, 2, 3, 4, 5, 7))
    ops["key"][:, ::7] = -1
    ops["seq"] = rng.integers(-3, 40, (b, t)).astype(np.int32)
    got, _ = _compare(state, ops)
    assert (got.last_seq.numpy() >= state["last_seq"]).all()


def _jax_window(state, cols, plane):
    """The JAX serving window's LWW bucket (fluidframework_tpu/server/
    serve_step.py): the gather, the masks, the apply, the occupancy."""
    lc, seq_bt = jnp.asarray(cols), jnp.asarray(plane)
    seq_g = seq_bt[lc[4], lc[5]]
    ok = (lc[0] != jlk.LwwKind.NOOP) & (seq_g > 0)
    ops = jlk.LwwOps(kind=jnp.where(ok, lc[0], jlk.LwwKind.NOOP), key=lc[1],
                     val=lc[2], delta=lc[3], seq=jnp.where(ok, seq_g, 0))
    out = jlk.apply_lww_batched(
        jlk.LwwState(**{f: jnp.asarray(v) for f, v in state.items()}), ops)
    return out, ops.kind, (out.key >= 0).sum(-1)


def test_window_plain_matches_jax():
    """apply_lww_window_plain (the window's admission, apply and
    occupancy) on staged columns against a ticket plane with unsequenced
    (0) and nacked (-1) entries."""
    rng = np.random.default_rng(5)
    b, t, c, docs, steps = 7, 16, 8, 9, 12
    state = _state_np(c, b)
    ops = _ops(rng, b, t, 10)
    cols = np.stack([ops["kind"], ops["key"], ops["val"], ops["delta"],
                     rng.integers(0, docs, (b, t)),
                     rng.integers(0, steps, (b, t))]).astype(np.int32)
    plane = rng.integers(-1, 30, (docs, steps)).astype(np.int32)
    plane[rng.random((docs, steps)) < 0.3] = 0
    want, want_kinds, want_occ = _jax_window(state, cols, plane)
    got, kinds, occ = tlk.apply_lww_window(
        interop.lww_state_from_numpy(state, "cpu"), torch.from_numpy(cols),
        torch.from_numpy(plane))
    for f in jlk.LwwState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(kinds.numpy(), np.asarray(want_kinds))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    assert occ.dtype == torch.int32
    assert (kinds.numpy() == 0).sum() > (cols[0] == 0).sum()
