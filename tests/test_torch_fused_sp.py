"""The port's fused apply with the capacity axis sharded
(fluidframework_tpu_torch/mergetree/fused_sp.py) against the JAX package,
bit for bit: a mirror of every case of tests/test_fused_sp.py.

Both forms must equal the JAX scan with the same sp_shards and the JAX
single-shard fused reference: the one-device two-level form
(`apply_ops_fused_sp`) and the explicit form over a mesh
(`apply_ops_fused_shardmap`), whose meshes here are lists of `cpu`
entries the size of the JAX test's mesh (the JAX side runs unsharded: its
own tests hold its sharded runs to these). Every state is int32, int16 or
bool, so the tolerance is zero. Added beside the mirror: the scan apply's
sp_shards formulation changes nothing on one device (and scan_apply
launches its kernel the same way for every sp_shards), the Lanes refactor
leaves apply_ops_fused_plain on the committed golden, the explicit form
refuses a shift as wide as its tile, and it counts one boundary exchange
per structural shift.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel as jk
from fluidframework_tpu.mergetree import pallas_apply as jpa
from fluidframework_tpu.mergetree.host import OpBuilder
from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.oppack import pack_ops as jax_pack_ops
from fluidframework_tpu.mergetree.state import DocState as JaxDocState
from fluidframework_tpu.mergetree.state import make_state as jax_make_state

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.kernels import build
from fluidframework_tpu_torch.mergetree import fused_sp, kernel
from fluidframework_tpu_torch.mergetree import pallas_apply as tpa
from fluidframework_tpu_torch.mergetree.state import make_state
from fluidframework_tpu_torch.parallel.mesh import (gather_tree, make_mesh,
                                                    reset_shard_launches,
                                                    shard_docs,
                                                    shard_launches)
from fluidframework_tpu_torch.server import pipeline
from fluidframework_tpu_torch.server import ticket_kernel as tk
from fluidframework_tpu_torch.testing import golden
from fluidframework_tpu_torch.testing.traces import gen_traces

from test_kernel import build_kernel_ops, random_schedule


def np_of(tup) -> dict:
    """A JAX or port tuple (a port one possibly on a mesh) as numpy."""
    if isinstance(tup[0], torch.Tensor) or hasattr(tup[0], "blocks"):
        return interop.to_numpy(gather_tree(tup))
    return {f: np.asarray(getattr(tup, f)) for f in tup._fields}


def assert_states_equal(got, want):
    got, want = np_of(got), np_of(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def cpu_mesh(dp, sp):
    return make_mesh(dp=dp, sp=sp, devices=["cpu"] * (dp * sp))


class Case:
    """One input in both packages: a fresh state and the op columns."""

    def __init__(self, state_np: dict, cols: dict, runs=None):
        self.state_np, self.cols, self.runs = state_np, cols, runs

    def jax(self):
        from fluidframework_tpu.mergetree.oppack import RunCols
        st = JaxDocState(**{f: jnp.asarray(v)
                            for f, v in self.state_np.items()})
        ops = JaxPackedOps(**{f: jnp.asarray(self.cols[f])
                              for f in JaxPackedOps._fields})
        runs = None if self.runs is None else RunCols(
            *(jnp.asarray(self.runs[f]) for f in RunCols._fields))
        return st, ops, runs

    def port(self):
        runs = None if self.runs is None else \
            interop.run_cols_from_numpy(self.runs, "cpu")
        return (interop.doc_state_from_numpy(self.state_np, "cpu"),
                interop.packed_ops_from_numpy(self.cols, "cpu"), runs)


def fresh(cap, anno, batch):
    return np_of(jax_make_state(cap, anno, batch=batch))


def traces(b, t, cap, seed) -> Case:
    return Case(fresh(cap, 2, b), gen_traces(b, t, seed=seed))


def rich(seed, cap=256, batch=2) -> Case:
    rng = random.Random(seed + 900)
    tuples = random_schedule(rng, n_clients=4, n_ops=40)
    host_ops = build_kernel_ops(OpBuilder(), tuples)
    packed = jax_pack_ops([host_ops, host_ops[: len(host_ops) // 2]][:batch])
    return Case(fresh(cap, 8, batch), np_of(packed))


def run_batch() -> Case:
    """tests/test_fused_sp.py's INSERT_RUN batch: four keystroke traces
    run-packed by the JAX package."""
    from fluidframework_tpu.mergetree.catchup import wire_to_host_ops
    from fluidframework_tpu.mergetree.host import PayloadTable
    from fluidframework_tpu.mergetree.oppack import (pack_run_slots,
                                                     pack_slots)
    from fluidframework_tpu.testing.traces import keystroke_trace

    docs, t_max = [], 0
    for d in range(4):
        builder = OpBuilder(PayloadTable())
        ops = []
        for op, s, r, c, m in keystroke_trace(60, seed=700 + d):
            ops.extend(wire_to_host_ops(builder, op, s, r, c, m))
        slots = pack_run_slots(ops, base_seq=0)
        docs.append(slots)
        t_max = max(t_max, len(slots))
    packed, runs = zip(*(pack_slots(slots, steps=t_max) for slots in docs))
    cols = {f: np.stack([np.asarray(getattr(p, f)) for p in packed])
            for f in JaxPackedOps._fields}
    run_np = {f: np.stack([np.asarray(getattr(r, f)) for r in runs])
              for f in runs[0]._fields}
    return Case(fresh(512, 4, 4), cols, run_np)


def jax_scan(case: Case, sp_shards: int = 1):
    st, ops, runs = case.jax()
    return jk._scan_ops(st, ops, batched=True, sp_shards=sp_shards,
                        runs=runs)


class TestGspmdFusedSp:
    @pytest.mark.parametrize("seed,b,t,cap,sp", [(0, 8, 24, 64, 2),
                                                 (1, 8, 24, 128, 4),
                                                 (2, 16, 16, 64, 8)])
    def test_traces_match_scan_sp_and_fused_ref(self, seed, b, t, cap, sp):
        case = traces(b, t, cap, seed)
        st, ops, _ = case.port()
        out = fused_sp.apply_ops_fused_sp(st, ops, sp)
        assert_states_equal(out, jax_scan(case, sp))
        assert_states_equal(out, jpa.apply_ops_fused_ref(*case.jax()[:2]))

    @pytest.mark.parametrize("seed", range(3))
    def test_rich_schedules_match(self, seed):
        case = rich(seed)
        st, ops, _ = case.port()
        assert_states_equal(fused_sp.apply_ops_fused_sp(st, ops, 4),
                            jax_scan(case))

    def test_overflow_flag_matches(self):
        case = traces(4, 40, 16, 3)  # tiny capacity
        st, ops, _ = case.port()
        out = np_of(fused_sp.apply_ops_fused_sp(st, ops, 2))
        want = np_of(jax_scan(case))
        np.testing.assert_array_equal(out["overflow"], want["overflow"])
        assert want["overflow"].any()


class TestShardmapFusedSp:
    @pytest.mark.parametrize("dp,sp", [(4, 2), (2, 4)])
    def test_traces_match_on_mesh(self, dp, sp):
        case = traces(8, 24, 64, 11)
        st, ops, _ = case.port()
        out = fused_sp.apply_ops_fused_shardmap(st, ops, cpu_mesh(dp, sp))
        assert_states_equal(out, jax_scan(case))

    def test_rich_schedules_match_on_mesh(self):
        case = rich(1)
        st, ops, _ = case.port()
        out = fused_sp.apply_ops_fused_shardmap(st, ops, cpu_mesh(2, 4))
        assert_states_equal(out, jax_scan(case))

    def test_sharded_inputs_execute(self):
        """With the lane planes already placed over the sp axis the
        explicit form takes their blocks as its tiles and still matches,
        and its output keeps that placement."""
        mesh = cpu_mesh(4, 2)
        case = traces(8, 16, 64, 5)
        st, ops, _ = case.port()
        st_s = shard_docs(mesh, st, seq_sharded=True)
        out = fused_sp.apply_ops_fused_shardmap(st_s, shard_docs(mesh, ops),
                                                mesh)
        assert out.length.spec == st_s.length.spec
        assert [b.shape for row in out.length.blocks for b in row] == \
            [(2, 32)] * 8
        assert_states_equal(out, jax_scan(case))

    def test_capacity_divisibility_guard(self):
        st, ops, _ = traces(4, 8, 65, 0).port()
        with pytest.raises(ValueError, match="not divisible"):
            fused_sp.apply_ops_fused_shardmap(st, ops, cpu_mesh(4, 2))

    def test_shift_wider_than_the_tile_is_refused(self):
        """An INSERT_RUN shifts by RUN_K rows: a tile narrower than that
        cannot take the boundary exchange."""
        case = run_batch()
        st, ops, runs = case.port()
        st = st._replace(**{f: getattr(st, f)[:, :64]
                            for f in ("length", "ins_seq", "ins_client",
                                      "local_seq", "rem_seq",
                                      "rem_local_seq", "origin_op",
                                      "origin_off", "rem_clients", "anno")})
        with pytest.raises(ValueError, match="shard tile"):
            fused_sp.apply_ops_fused_shardmap(st, ops, cpu_mesh(1, 16),
                                              runs=runs)

    def test_one_exchange_per_structural_shift(self):
        """The explicit schedule in place of XLA's collectives: two
        boundary splits and the insert shift exchange once each per op
        (three; four with INSERT_RUN columns), whatever the mesh; the
        reductions and scans cross the tiles too."""
        fused_sp.reset_counts()
        st, ops, _ = traces(8, 12, 64, 7).port()
        fused_sp.apply_ops_fused_shardmap(st, ops, cpu_mesh(2, 4))
        f = fused_sp.apply_ops_fused_shardmap
        assert (f.exchanges, f.ops) == (3 * 12, 12)
        assert f.collectives > f.exchanges
        fused_sp.reset_counts()
        case = run_batch()
        fused_sp.apply_ops_fused_shardmap(*case.port()[:2], cpu_mesh(4, 2),
                                          runs=case.port()[2])
        assert f.exchanges == 4 * f.ops > 0


class TestFusedSpInsertRun:
    def test_gspmd_runs_variant_matches_scan(self):
        case = run_batch()
        st, ops, runs = case.port()
        out = fused_sp.apply_ops_fused_sp(st, ops, 4, runs=runs)
        assert_states_equal(out, jax_scan(case))

    def test_shardmap_runs_variant_matches_scan(self):
        case = run_batch()
        st, ops, runs = case.port()
        out = fused_sp.apply_ops_fused_shardmap(st, ops, cpu_mesh(4, 2),
                                                runs=runs)
        assert_states_equal(out, jax_scan(case))


def step_inputs(batch, cap, steps, seed):
    cols = gen_traces(batch, steps, seed=seed)
    ops = interop.packed_ops_from_numpy(cols, "cpu")
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)
    from fluidframework_tpu_torch.mergetree.state import make_state
    return (tk.make_ticket_state(4, batch=batch, device="cpu"),
            make_state(cap, 1, batch=batch, device="cpu"), raw, ops), cols


def jax_step(batch, cap, cols, sp_shards):
    from fluidframework_tpu.server import ticket_kernel as jtk
    from fluidframework_tpu.server.pipeline import make_full_step
    import jax
    ops = JaxPackedOps(**{f: jnp.asarray(cols[f])
                          for f in JaxPackedOps._fields})
    raw = jtk.RawOps(client=ops.client, client_seq=ops.seq,
                     ref_seq=ops.ref_seq)
    return jax.jit(make_full_step(sp_shards=sp_shards))(
        jtk.make_ticket_state(4, batch=batch),
        jax_make_state(cap, 1, batch=batch), raw, ops)


def assert_steps_equal(got, want):
    assert_states_equal(got[1], want[1])
    np.testing.assert_array_equal(np_of(got[2])["seq"],
                                  np.asarray(want[2].seq))
    total = got[3] if isinstance(got[3], torch.Tensor) else \
        gather_tree([got[3]])[0]
    np.testing.assert_array_equal(total.numpy(), np.asarray(want[3]))


class TestPipelineFusedSp:
    def test_full_step_fused_sp_matches_scan_sp(self):
        """make_full_step(sp_shards > 1) with the fused apply and with the
        scan apply are bit-identical, and equal JAX's scan step."""
        args, cols = step_inputs(8, 64, 12, 21)
        scan = pipeline.make_full_step(sp_shards=2, fused_apply=False)(
            *args)
        fsp = pipeline.make_full_step(sp_shards=2, fused_apply=True)(*args)
        assert_steps_equal(scan, jax_step(8, 64, cols, 2))
        assert_steps_equal(fsp, jax_step(8, 64, cols, 2))

    def test_full_step_fused_sp_on_sharded_mesh_inputs(self):
        """The composed step under real dp x sp placements: the capacity
        sharded over sp takes the explicit fused-sp form."""
        mesh = cpu_mesh(4, 2)
        (ts, ms, raw, ops), cols = step_inputs(8, 64, 8, 33)
        out = pipeline.make_full_step(sp_shards=2, fused_apply=True)(
            shard_docs(mesh, ts), shard_docs(mesh, ms, seq_sharded=True),
            shard_docs(mesh, raw), shard_docs(mesh, ops))
        assert out[1].length.spec == ("dp", "sp")
        assert_steps_equal(out, jax_step(8, 64, cols, 2))


class TestFusedSpLongDocument:
    def test_large_capacity_sharded_lane_axis(self):
        """A 4,096-lane capacity axis over sp=8 (512-lane tiles): both
        forms against the JAX single-shard fused reference."""
        case = traces(2, 48, 4096, 19)
        st, ops, _ = case.port()
        ref = jpa.apply_ops_fused_ref(*case.jax()[:2])
        assert_states_equal(fused_sp.apply_ops_fused_sp(st, ops, 8), ref)
        assert_states_equal(fused_sp.apply_ops_fused_shardmap(
            st, ops, cpu_mesh(1, 8), dp_axis="dp"), ref)


class TestScanSpShards:
    @pytest.mark.parametrize("sp", [2, 4, 8])
    def test_scan_sp_shards_is_exact_on_one_device(self, sp):
        """The scan apply's two-level prefix sums equal its one-level ones
        and JAX's _scan_ops with the same sp_shards."""
        case = rich(2)
        st, ops, _ = case.port()
        one = kernel._scan_ops(st, ops, batched=True)
        out = kernel._scan_ops(st, ops, batched=True, sp_shards=sp)
        assert_states_equal(out, one)
        assert_states_equal(out, jax_scan(case, sp))

    def test_scan_apply_launches_unchanged_for_any_sp_shards(self,
                                                             monkeypatch):
        """scan_apply takes sp_shards and hands its kernel the same
        launch (state, ops, runs, geometry) for every value: the two-level
        form is exact integer arithmetic. A value below 1 is refused."""
        seen = []
        monkeypatch.setattr(kernel, "_launch",
                            lambda *a: seen.append(a) or a[0])
        st, ops, _ = traces(4, 8, 64, 1).port()
        for sp in (1, 2, 8):
            kernel.scan_apply(st, ops, None, sp)
        assert all(a[0] is st and a[1] is ops and a[2] is None
                   and a[3] == seen[0][3] for a in seen) and len(seen) == 3
        with pytest.raises(ValueError, match="sp_shards"):
            kernel.scan_apply(st, ops, None, 0)

    def test_local_lanes_keep_the_fused_golden(self):
        """apply_ops_fused_plain, now written against local_lanes, still
        gives the committed JAX golden of the fused apply."""
        g = np.load(golden.GOLDEN_PATH.with_name("fused_apply_golden.npz"))
        state = {f: g[f"apply_in.{f}"] for f in JaxDocState._fields}
        ops = {f: g[f"apply_op.{f}"] for f in JaxPackedOps._fields}
        out = interop.to_numpy(tpa.apply_ops_fused_plain(
            interop.doc_state_from_numpy(state, "cpu"),
            interop.packed_ops_from_numpy(ops, "cpu")))
        for f in JaxDocState._fields:
            np.testing.assert_array_equal(out[f], g[f"apply_out.{f}"],
                                          err_msg=f)


class TestKernelWrappers:
    """The routing of the two wrappers around kernels/csrc/fused_sp.cu
    (the kernel itself runs on the CPU in tests/test_torch_fused_sp_emu.py):
    CPU tensors take the plain forms, CUDA ones the kernel, anything else
    raises; the launch counts and their reset."""

    def test_cpu_tensors_take_the_plain_forms(self, monkeypatch):
        calls = []
        for name in ("apply_ops_fused_sp_plain",
                     "apply_ops_fused_shardmap_plain"):
            real = getattr(fused_sp, name)
            monkeypatch.setattr(
                fused_sp, name,
                lambda *a, _n=name, _f=real, **k: calls.append(_n)
                or _f(*a, **k))
        monkeypatch.setattr(build, "library", lambda: pytest.fail(
            "a CPU tensor reached the kernel library"))
        fused_sp.reset_counts()
        case = traces(4, 12, 64, 3)
        st, ops, _ = case.port()
        assert_states_equal(fused_sp.apply_ops_fused_sp(st, ops, 4),
                            jax_scan(case))
        assert_states_equal(fused_sp.apply_ops_fused_shardmap(
            st, ops, cpu_mesh(2, 2)), jax_scan(case))
        assert calls == ["apply_ops_fused_sp_plain",
                         "apply_ops_fused_shardmap_plain"]
        assert fused_sp.launches == 0

    def test_other_devices_raise(self):
        st_cpu, ops_cpu, _ = traces(2, 4, 64, 0).port()
        st = make_state(64, 2, batch=2, device="meta")
        with pytest.raises(ValueError, match="meta"):
            fused_sp.apply_ops_fused_sp(st, ops_cpu, 2)
        meta = make_mesh(dp=1, sp=2, devices=["meta", "meta"])
        with pytest.raises(ValueError, match="all be CUDA devices"):
            fused_sp.apply_ops_fused_shardmap(st_cpu, ops_cpu, meta)
        mixed = make_mesh(dp=1, sp=2, devices=["cpu", "cuda:0"])
        with pytest.raises(ValueError, match="all be CUDA devices"):
            fused_sp.apply_ops_fused_shardmap(st_cpu, ops_cpu, mixed)

    def test_mesh_row_over_two_cards_raises(self):
        """No cluster spans cards: a dp row whose sp entries lie on two
        CUDA devices is refused before anything is placed."""
        st, ops, _ = traces(2, 4, 64, 0).port()
        mesh = make_mesh(dp=1, sp=2, devices=["cuda:0", "cuda:1"])
        with pytest.raises(ValueError, match="dp row 0 lies on"):
            fused_sp.apply_ops_fused_shardmap(st, ops, mesh)
        assert mesh.copies == 0

    def test_launch_counts_and_reset(self, monkeypatch):
        """The mesh form's kernel path launches once per dp row (counted
        under the row's first shard) with the rule's geometry;
        reset_counts zeroes the count."""
        seen = []

        class Lib:
            @staticmethod
            def fluid_fused_sp(*args):
                seen.append(args[2:])
                return 0

        monkeypatch.setattr(build, "library", lambda: Lib)
        monkeypatch.setattr(build, "stream_handle", lambda: 0)
        fused_sp.reset_counts()
        reset_shard_launches()
        st, ops, _ = traces(4, 6, 96, 1).port()
        fused_sp.launch_shardmap(st, ops, cpu_mesh(2, 4))
        assert fused_sp.launches == 2
        assert shard_launches["fused_sp"] == {0: 1, 4: 1}
        geo = fused_sp.sp_geometry(96, 3, 2, 4)
        assert geo == (4, 24, 32, kernel.shared_table_bytes(96, 3, 2, 4))
        # batch, C, K, A, T, runs, blocks, threads, smem
        assert [s[:-1] for s in seen] == [
            (2, 96, 3, 2, 6, 0, 4, 32, geo.smem_bytes)] * 2
        fused_sp.reset_counts()
        assert fused_sp.launches == 0

    @pytest.mark.card
    def test_cuda_tensors_launch_the_kernels(self):
        """On the card: the mesh form launches fused_sp.cu once per dp
        row, the one-device form scan_apply.cu once, and both equal their
        plain versions (chip_smoke.py phase 23 (c) runs the same checks at
        the main path's shapes)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        case = traces(2, 12, 256, 4)
        st = interop.doc_state_from_numpy(case.state_np, "cuda")
        ops = interop.packed_ops_from_numpy(case.cols, "cuda")
        fused_sp.reset_counts()
        kernel.reset_launches()
        mesh = make_mesh(dp=2, sp=4, devices=["cuda"] * 8)
        got = gather_tree(fused_sp.apply_ops_fused_shardmap(st, ops, mesh))
        assert fused_sp.launches == 2
        assert_states_equal(got, gather_tree(
            fused_sp.apply_ops_fused_shardmap_plain(st, ops, mesh)))
        got = fused_sp.apply_ops_fused_sp(st, ops, 4)
        assert kernel.scan_apply.launches == 1
        assert_states_equal(got, fused_sp.apply_ops_fused_sp_plain(st, ops,
                                                                   4))
