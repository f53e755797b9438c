"""The port's multi-device paths against the JAX package: a mirror of
tests/test_parallel.py.

The port's meshes are lists of `cpu` entries the size of the JAX test's
mesh (one process drives every entry, as JAX's single controller drives
the conftest's 8 virtual devices): mesh construction, placement, the
sequence-parallel prefix sum, and the north-star step under dp x sp
placements equal to the unsharded step and to JAX's. JAX's
test_sp_compile_emits_collectives reads XLA's program text, which the port
has none of; in its place a test counts the explicit collectives and
boundary exchanges the sharded step makes. Every value is int32 or bool:
zero tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.state import make_state as jax_make_state
from fluidframework_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fluidframework_tpu.parallel.mesh import shard_docs as jax_shard_docs
from fluidframework_tpu.parallel.seq_scan import \
    sharded_cumsum as jax_sharded_cumsum
from fluidframework_tpu.server import ticket_kernel as jtk
from fluidframework_tpu.server.pipeline import full_step as jax_full_step
from fluidframework_tpu.server.pipeline import \
    make_full_step as jax_make_full_step

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import fused_sp
from fluidframework_tpu_torch.mergetree.state import make_state
from fluidframework_tpu_torch.parallel import (P, Sharded, gather, make_mesh,
                                               replicate, shard_docs,
                                               sharded_cumsum)
from fluidframework_tpu_torch.parallel.mesh import gather_tree
from fluidframework_tpu_torch.server import pipeline
from fluidframework_tpu_torch.server import ticket_kernel as tk
from fluidframework_tpu_torch.testing.traces import gen_traces


def cpu_mesh(dp, sp):
    return make_mesh(dp=dp, sp=sp, devices=["cpu"] * (dp * sp))


def entries(x: Sharded):
    return [b for row in x.blocks for b in row]


class TestMesh:
    def test_make_mesh_shapes(self):
        mesh = cpu_mesh(4, 2)
        assert mesh.shape == {"dp": 4, "sp": 2} == dict(
            jax_make_mesh(dp=4, sp=2).shape)
        with pytest.raises(ValueError, match=r"dp\(3\) x sp\(3\) != "
                           r"device count 8"):
            make_mesh(dp=3, sp=3, devices=["cpu"] * 8)
        with pytest.raises(ValueError, match=r"dp\(3\) x sp\(3\) != "
                           r"device count 8"):
            jax_make_mesh(dp=3, sp=3)

    def test_shard_docs_placement(self):
        """Leading axis over dp; the capacity axis over sp where it
        divides; per-document scalars over dp only; each entry's block on
        its own device. The specs read as JAX's."""
        mesh = cpu_mesh(4, 2)
        sharded = shard_docs(mesh, make_state(64, 1, batch=8, device="cpu"),
                             seq_sharded=True)
        want = jax.tree_util.tree_map(
            lambda x: x.sharding.spec,
            jax_shard_docs(jax_make_mesh(dp=4, sp=2),
                           jax_make_state(64, 1, batch=8), seq_sharded=True))
        for name in want._fields:
            assert str(getattr(sharded, name).spec) == \
                str(getattr(want, name)), name
        assert sharded.length.spec[:2] == ("dp", "sp")
        assert sharded.count.spec[0] == "dp"
        assert [tuple(b.shape) for b in entries(sharded.length)] == \
            [(2, 32)] * 8
        assert all(b.device == torch.device("cpu")
                   for b in entries(sharded.length))

    def test_replicate(self):
        mesh = cpu_mesh(8, 1)
        tree = replicate(mesh, {"x": torch.arange(16)})
        assert tree["x"].spec == P()
        assert all(torch.equal(b, torch.arange(16))
                   for b in entries(tree["x"]))


class TestShardedCumsum:
    @pytest.mark.parametrize("exclusive", [False, True])
    def test_matches_dense(self, exclusive):
        x = np.random.default_rng(0).integers(0, 9, (4, 128)).astype(
            np.int32)
        out = sharded_cumsum(torch.from_numpy(x), cpu_mesh(2, 4),
                             exclusive=exclusive)
        want = jax_sharded_cumsum(jnp.asarray(x), jax_make_mesh(dp=2, sp=4),
                                  exclusive=exclusive)
        ref = np.cumsum(x, axis=-1) - (x if exclusive else 0)
        np.testing.assert_array_equal(gather(out).numpy(), np.asarray(want))
        np.testing.assert_array_equal(gather(out).numpy(), ref)


def inputs(batch=8, capacity=64, steps=6, seed=13):
    """The port's step inputs and the numpy op columns."""
    cols = gen_traces(batch, steps, seed=seed)
    ops = interop.packed_ops_from_numpy(cols, "cpu")
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)
    return (tk.make_ticket_state(4, batch=batch, device="cpu"),
            make_state(capacity, 1, batch=batch, device="cpu"), raw,
            ops), cols


def jax_step(cols, batch=8, capacity=64, step=jax_full_step):
    ops = JaxPackedOps(**{f: jnp.asarray(cols[f])
                          for f in JaxPackedOps._fields})
    raw = jtk.RawOps(client=ops.client, client_seq=ops.seq,
                     ref_seq=ops.ref_seq)
    return jax.jit(step)(jtk.make_ticket_state(4, batch=batch),
                         jax_make_state(capacity, 1, batch=batch), raw, ops)


def assert_step_equal(got, want):
    """(tstate, mstate, ticketed, total) of the port (sharded or not)
    against JAX's."""
    got = [interop.to_numpy(gather_tree(x)) for x in got[:3]] + \
        [gather(got[3]).numpy()]
    for i in range(3):
        for name in want[i]._fields:
            np.testing.assert_array_equal(
                got[i][name], np.asarray(getattr(want[i], name)),
                err_msg=f"{i}.{name}")
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))


def sharded(mesh, args, seq_sharded):
    ts, ms, raw, ops = args
    return (shard_docs(mesh, ts), shard_docs(mesh, ms,
                                             seq_sharded=seq_sharded),
            shard_docs(mesh, raw), shard_docs(mesh, ops))


class TestShardedPipeline:
    @pytest.mark.parametrize("dp,sp,seq_sharded",
                             [(4, 2, True), (8, 1, False)])
    def test_full_step_sharded_matches_unsharded(self, dp, sp, seq_sharded):
        args, cols = inputs(steps=6, seed=11)
        want = jax_step(cols)
        assert_step_equal(pipeline.full_step(*args), want)
        out = pipeline.full_step(*sharded(cpu_mesh(dp, sp), args,
                                          seq_sharded))
        assert isinstance(out[1].length, Sharded)
        assert_step_equal(out, want)


class TestKernelSequenceParallel:
    """The scan's own sequence-parallel formulation and the step with
    the capacity axis sharded over sp."""

    def test_two_level_cumsum_formulation_is_exact(self):
        args, cols = inputs()
        want = jax_step(cols, step=jax_make_full_step(sp_shards=2))
        assert_step_equal(pipeline.make_full_step(
            sp_shards=2, fused_apply=False)(*args), want)
        assert_step_equal(pipeline.full_step(*args), want)

    def test_sp_sharded_kernel_matches_unsharded(self):
        args, cols = inputs(seed=17)
        want = jax_step(cols)
        out = pipeline.make_full_step(sp_shards=2)(
            *sharded(cpu_mesh(4, 2), args, True))
        assert_step_equal(out, want)

    def test_sp_step_exchanges_between_shards(self):
        """In place of reading XLA's program for collectives: the sharded
        step's explicit schedule. With the capacity over sp=2 every op
        makes one boundary exchange per structural shift (three), more
        collectives than that, and copies between the shards; with the
        capacity whole (dp only) it makes none of them."""
        args, _ = inputs(steps=6)
        mesh = cpu_mesh(4, 2)
        fused_sp.reset_counts()
        placed = sharded(mesh, args, True)
        before = mesh.copies
        pipeline.full_step(*placed)
        f = fused_sp.apply_ops_fused_shardmap
        assert (f.exchanges, f.ops) == (3 * 6, 6)
        assert f.collectives > f.exchanges
        assert mesh.copies > before
        fused_sp.reset_counts()
        pipeline.full_step(*sharded(cpu_mesh(4, 1), args, True))
        assert (f.exchanges, f.collectives) == (0, 0)
