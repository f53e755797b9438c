"""The port's north-star step (fluidframework_tpu_torch/server/pipeline.py)
against the JAX package's make_full_step(fused_apply=False) on the CPU (the
scan apply with the jnp summary, which the JAX package's own tests hold
bit-identical to its fused path), at B=16, T=32, C=64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.state import make_state as jax_make_state
from fluidframework_tpu.server import ticket_kernel as jtk
from fluidframework_tpu.server.pipeline import make_full_step as jax_step

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree.pallas_apply import (
    max_fused_capacity)
from fluidframework_tpu_torch.mergetree.state import make_state
from fluidframework_tpu_torch.server import pipeline
from fluidframework_tpu_torch.server import ticket_kernel as tk
from fluidframework_tpu_torch.testing.traces import gen_traces

from test_torch_fused_apply import jax_to_np

B, T, C = 16, 32, 64


def step_inputs(seed, dup_every=0):
    cols = gen_traces(B, T, seed=seed)
    client_seq = cols["seq"].copy()
    if dup_every:
        client_seq[::dup_every, T // 2] = client_seq[::dup_every, T // 2 - 1]
    raw = {"client": cols["client"], "client_seq": client_seq,
           "ref_seq": cols["ref_seq"]}
    return cols, raw


def run_jax(cols, raw, k):
    step = jax.jit(jax_step(fused_apply=False))
    out = step(jtk.make_ticket_state(k, batch=B),
               jax_make_state(C, 1, batch=B),
               jtk.RawOps(**{f: jnp.asarray(v) for f, v in raw.items()}),
               JaxPackedOps(**{f: jnp.asarray(cols[f])
                               for f in JaxPackedOps._fields}))
    tout, mout, ticketed, total = out
    return (jax_to_np(tout), jax_to_np(mout), jax_to_np(ticketed),
            np.asarray(total))


def run_port(cols, raw, k, plain=False):
    step = pipeline.make_full_step(plain=plain)
    tout, mout, ticketed, total = step(
        tk.make_ticket_state(k, B, device="cpu"),
        make_state(C, 1, batch=B, device="cpu"),
        interop.raw_ops_from_numpy(raw, "cpu"),
        interop.packed_ops_from_numpy(cols, "cpu"))
    return (interop.to_numpy(tout), interop.to_numpy(mout),
            interop.to_numpy(ticketed), total.numpy())


def assert_outputs_equal(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert got[3].dtype == want[3].dtype
    np.testing.assert_array_equal(got[3], want[3])


class TestFullStep:
    @pytest.mark.parametrize("k", [4, 8])
    @pytest.mark.parametrize("seed,dup_every", [(0, 0), (1, 3)])
    def test_matches_jax_full_step(self, k, seed, dup_every):
        cols, raw = step_inputs(seed, dup_every)
        want = run_jax(cols, raw, k)
        got = run_port(cols, raw, k)
        assert_outputs_equal(got, want)
        if dup_every:
            assert (got[2]["seq"] == 0).any()   # dropped ops became NOOPs

    def test_plain_composition_matches(self):
        cols, raw = step_inputs(2, 4)
        assert_outputs_equal(run_port(cols, raw, 8, plain=True),
                             run_port(cols, raw, 8))

    def test_capacity_above_limit_raises(self):
        limit = max_fused_capacity(3, 1)
        cols = gen_traces(1, 2)
        raw = {"client": cols["client"], "client_seq": cols["seq"],
               "ref_seq": cols["ref_seq"]}
        with pytest.raises(ValueError, match=f"max_fused_capacity={limit}"):
            pipeline.full_step(tk.make_ticket_state(4, 1, device="cpu"),
                               make_state(limit + 1, 1, batch=1,
                                          device="cpu"),
                               interop.raw_ops_from_numpy(raw, "cpu"),
                               interop.packed_ops_from_numpy(cols, "cpu"))

    def test_admit_ops_masks_unadmitted(self):
        cols, raw = step_inputs(3, 2)
        ops = interop.packed_ops_from_numpy(cols, "cpu")
        _, ticketed = tk.scan_tickets(
            tk.make_ticket_state(4, B, device="cpu"),
            interop.raw_ops_from_numpy(raw, "cpu"))
        admitted = pipeline.admit_ops(ops, ticketed)
        dropped = (ticketed.seq == 0).numpy()
        assert dropped.any()
        assert (admitted.kind.numpy()[dropped] == 0).all()
        np.testing.assert_array_equal(admitted.seq.numpy()[~dropped],
                                      ticketed.seq.numpy()[~dropped])
