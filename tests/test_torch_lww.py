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
