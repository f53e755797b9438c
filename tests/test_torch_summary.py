"""The port's summary length (fluidframework_tpu_torch/mergetree/pallas_ops.py)
against the JAX package: the Pallas kernel in interpret mode and the jnp
reduction, bit for bit, including batches that are not a multiple of the
8-document tile."""

import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.mergetree import kernel
from fluidframework_tpu.mergetree.constants import (DEV_NO_REMOVE,
                                                    DEV_UNASSIGNED)
from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.pallas_ops import (_jnp_summary_lengths,
                                                     summary_lengths as
                                                     jax_summary_lengths)
from fluidframework_tpu.mergetree.state import DocState as JaxDocState
from fluidframework_tpu.mergetree.state import make_state as jax_make_state

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree.pallas_ops import (
    summary_lengths, summary_lengths_plain)
from fluidframework_tpu_torch.testing.traces import gen_traces

from test_torch_fused_apply import jax_to_np


def applied_state(batch, capacity, steps, seed):
    cols = gen_traces(batch, steps, seed=seed)
    ops = JaxPackedOps(**{f: jnp.asarray(cols[f])
                          for f in JaxPackedOps._fields})
    return kernel.apply_ops_batched(jax_make_state(capacity, 1, batch=batch),
                                    ops)


def random_state(seed, batch, capacity):
    """Arbitrary tables: sentinel-heavy seq columns, counts past the live
    rows, negative and large lengths."""
    rng = np.random.default_rng(seed)
    st = jax_to_np(jax_make_state(capacity, 1, batch=batch))
    st["length"] = rng.integers(-5, 1000, (batch, capacity)).astype(np.int32)
    pick = rng.integers(0, 4, (batch, capacity))
    seqs = rng.integers(0, 50, (batch, capacity)).astype(np.int32)
    st["ins_seq"] = np.where(pick == 0, DEV_UNASSIGNED, seqs).astype(np.int32)
    st["rem_seq"] = np.where(pick == 1, DEV_NO_REMOVE,
                             np.where(pick == 2, DEV_UNASSIGNED,
                                      seqs + rng.integers(0, 9)))
    st["rem_seq"] = st["rem_seq"].astype(np.int32)
    st["count"] = rng.integers(0, capacity + 1, batch).astype(np.int32)
    st["seq"] = rng.integers(0, 60, batch).astype(np.int32)
    return st


def both_jax(st_np):
    st = JaxDocState(**{f: jnp.asarray(v) for f, v in st_np.items()})
    return (np.asarray(jax_summary_lengths(st, interpret=True)),
            np.asarray(_jnp_summary_lengths(st)))


class TestSummaryLengths:
    @pytest.mark.parametrize("batch,capacity,steps,seed",
                             [(5, 64, 30, 0), (16, 64, 40, 1),
                              (13, 128, 50, 2)])
    def test_after_apply_matches_jax(self, batch, capacity, steps, seed):
        st_np = jax_to_np(applied_state(batch, capacity, steps, seed))
        interp, ref = both_jax(st_np)
        got = summary_lengths_plain(
            interop.doc_state_from_numpy(st_np, "cpu")).numpy()
        assert got.dtype == np.int32 and got.shape == (batch,)
        np.testing.assert_array_equal(got, interp)
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_tables_match_jax(self, seed):
        st_np = random_state(seed, 11, 96)
        interp, ref = both_jax(st_np)
        got = summary_lengths_plain(
            interop.doc_state_from_numpy(st_np, "cpu")).numpy()
        np.testing.assert_array_equal(got, interp)
        np.testing.assert_array_equal(got, ref)

    def test_cpu_wrapper_runs_plain(self):
        st = interop.doc_state_from_numpy(random_state(5, 9, 40), "cpu")
        before = summary_lengths.launches
        np.testing.assert_array_equal(summary_lengths(st).numpy(),
                                      summary_lengths_plain(st).numpy())
        assert summary_lengths.launches == before  # no kernel on the CPU
