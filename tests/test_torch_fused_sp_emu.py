"""The CUDA source of the fused apply over sp tiles (fluidframework_tpu_torch/
kernels/csrc/fused_sp.cu) run on the CPU against the JAX package, bit for
bit.

fused_sp.cu includes scan_apply.cu (its cluster path's primitives) and,
through it, fused_apply.cu (the per-slot rules); the three are compiled
with the host's C++ compiler against tests/simt/simt_emu.h (each CUDA
thread a coroutine, warp, block and cluster primitives as barriers, the
threads of a cluster's blocks in one shuffled order, each block's shared
memory starting as random words, map_shared_rank a pointer into another
block's). They are reached through the mesh form's kernel path,
fused_sp.launch_shardmap (what apply_ops_fused_shardmap calls for a mesh
of CUDA entries), on a mesh of `cpu` entries: its checks, its tile tables,
one launch per dp row, the tiles read and written where they lie, and its
launch count. (The one-device form, apply_ops_fused_sp, launches
scan_apply.cu for CUDA tensors; tests/test_torch_scan_emu.py runs that
source.)

Held to JAX: the single-shard fused reference (pallas_apply.
apply_ops_fused_ref), JAX's own sp forms where the conftest's eight
virtual devices hold the mesh (apply_ops_fused_shardmap at dp x sp <= 8,
apply_ops_fused_sp), and JAX's scan with INSERT_RUN columns. Shapes: sp in
{1 (a cluster of one block), 2, 3, 4, 8, 16} (16: the non-portable
cluster), dp in {1, 2}, C in {16, 64, 96 (tiles of 24, 32 and 48 slots,
not a multiple of 32), 256} and one document at C = 4,096 over sp = 8;
gen_traces and gpu_conformance's schedules (removes from three clients),
the INSERT_RUN variant, an overflow near C, fuzzed tables with stale
padding (held to the port's plain version), every refusal of the kernel
path and a geometry the entry point refuses (cudaErrorInvalidValue).
Every tile of a dp row must hold the row's scalars. Tolerance: exact
equality (every field is int32 or bool). Only the card (chip_smoke.py
phase 23 (c)) shows that nvcc builds the kernel and what it costs.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import pytest
import torch

from fluidframework_tpu.mergetree import fused_sp as jfused_sp
from fluidframework_tpu.mergetree import pallas_apply as jpa
from fluidframework_tpu.parallel.mesh import make_mesh as jax_make_mesh

from fluidframework_tpu_torch.kernels import build
from fluidframework_tpu_torch.mergetree import fused_sp
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.oppack import pack_ops
from fluidframework_tpu_torch.mergetree.state import DocState
from fluidframework_tpu_torch.parallel.mesh import (Sharded, gather_tree,
                                                    shard_docs)
from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                     gen_fuzz_traces)
from fluidframework_tpu_torch.tools.gpu_conformance import _traces

from test_torch_fused_emu import emu_source
from test_torch_fused_sp import (Case, assert_states_equal, cpu_mesh, fresh,
                                 jax_scan, np_of, run_batch, traces)
from test_torch_scan_emu import scan_emu_source

CSRC = Path(__file__).resolve().parents[1] / "fluidframework_tpu_torch" / \
    "kernels" / "csrc"
EMU_DIR = Path(__file__).resolve().parent / "simt"
INVALID_VALUE = 1  # cudaErrorInvalidValue


def sp_emu_source(text: str) -> str:
    """fused_sp.cu for the emulator: its dynamic shared memory is the
    emulated block's (its includes resolve to the rewritten sources
    beside it)."""
    text, n_smem = re.subn(r"extern __shared__ int smem\[\];",
                           "int* smem = emu_smem;", text)
    assert n_smem == 1, n_smem
    return text


def build_emulated(work: Path) -> ctypes.CDLL:
    """Compile fused_sp.cu, with the emulator's rewrites of the two
    sources it includes beside it, and load it with the entry point's
    ctypes signature as kernels/build.py declares it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    (work / "fused_apply.cu").write_text(
        emu_source((CSRC / "fused_apply.cu").read_text()))
    (work / "scan_apply.cu").write_text(scan_emu_source(
        (CSRC / "scan_apply.cu").read_text(), tkernel.MAX_SHARED_SLOTS))
    src = work / "fused_sp_emu.cpp"
    src.write_text(sp_emu_source((CSRC / "fused_sp.cu").read_text()))
    lib = work / "libfused_sp_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         f"-I{EMU_DIR}", f"-I{work}", str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.fluid_fused_sp.argtypes = [ctypes.POINTER(vp), vp, i32, i32, i32,
                                   i32, i32, i32, i32, i32, i64, vp]
    dll.fluid_fused_sp.restype = i32
    return dll


def use_emulated(monkeypatch, lib) -> None:
    """Route the kernel path to the emulated library, on a null
    stream."""
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("fused_sp_emu"))


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    use_emulated(monkeypatch, emu_lib)
    fused_sp.reset_counts()
    return emu_lib


def launches():
    return fused_sp.launches


def snapshot(tree):
    """Copies of every tensor of a port tree (Sharded blocks too)."""
    out = []
    for leaf in tree:
        if isinstance(leaf, Sharded):
            out.append([b.clone() for row in leaf.blocks for b in row])
        elif leaf is not None:
            out.append([leaf.clone()])
    return out


def assert_unwritten(tree, before) -> None:
    for got, want in zip(snapshot(tree), before):
        for g, w in zip(got, want):
            assert torch.equal(g, w), "the kernel wrote its input"


def assert_row_scalars(out: DocState) -> None:
    """Every tile of a dp row holds the row's copy of each scalar."""
    for name in ("count", "min_seq", "seq", "overflow"):
        for row in getattr(out, name).blocks:
            for b in row[1:]:
                assert torch.equal(b, row[0]), f"{name}: a tile's copy"


def mesh_run(case: Case, dp: int, sp: int, sharded: bool = False):
    """The mesh form through the kernel: one launch per dp row, the input
    left as it was, every tile's scalars written."""
    st, ops, runs = case.port()
    mesh = cpu_mesh(dp, sp)
    if sharded:
        st, ops = shard_docs(mesh, st, seq_sharded=True), \
            shard_docs(mesh, ops)
    before = snapshot((*st, *ops, *(runs or ())))
    n0 = launches()
    out = fused_sp.launch_shardmap(st, ops, mesh, runs=runs)
    assert launches() - n0 == dp
    assert_unwritten((*st, *ops, *(runs or ())), before)
    assert_row_scalars(out)
    return out


def rich_case(b: int, t: int, cap: int, seed: int) -> Case:
    """gpu_conformance's schedule: inserts and removes from three
    clients (phase 23 (c)'s "rich" case)."""
    cols = pack_ops(_traces(b, t, seed))
    return Case(fresh(cap, 2, b), cols)


def jax_ref(case: Case):
    return jpa.apply_ops_fused_ref(*case.jax()[:2])


# (dp, sp, C, B, T, seed, JAX's shard_map too?): tiles of 32, 24 (C =
# 96), 48, 16 (a cluster of 16 blocks), 4 slots (narrower than a run's
# shift, so a plain op's shift stays in the rank below), 32 over three
# ranks, and whole tables (sp = 1: a cluster of one block).
MESH_CASES = [
    (1, 2, 64, 4, 24, 0, True),
    (2, 4, 96, 4, 24, 1, True),
    (1, 8, 256, 2, 32, 2, True),
    (2, 2, 96, 4, 20, 3, False),
    (2, 16, 256, 4, 20, 4, False),
    (1, 16, 64, 2, 16, 5, False),
    (1, 3, 96, 3, 24, 13, True),
    (1, 1, 64, 4, 24, 10, True),
    (2, 1, 100, 4, 24, 11, True),
]


@pytest.mark.parametrize("dp,sp,cap,b,t,seed,jax_mesh", MESH_CASES)
def test_mesh_form_matches_jax(emulated, dp, sp, cap, b, t, seed,
                               jax_mesh):
    case = traces(b, t, cap, seed)
    out = mesh_run(case, dp, sp)
    assert_states_equal(out, jax_ref(case))
    if jax_mesh:
        st, ops, _ = case.jax()
        assert_states_equal(out, jfused_sp.apply_ops_fused_shardmap(
            st, ops, jax_make_mesh(dp=dp, sp=sp,
                                   devices=jax.devices()[:dp * sp])))


@pytest.mark.parametrize("dp,sp,cap,seed", [(1, 4, 64, 7), (2, 8, 256, 8),
                                            (2, 2, 96, 9)])
def test_mesh_form_rich_schedules_match_jax(emulated, dp, sp, cap, seed):
    case = rich_case(4, 28, cap, seed)
    assert_states_equal(mesh_run(case, dp, sp), jax_ref(case))


def test_mesh_form_takes_sharded_inputs(emulated):
    """Tiles already placed over the sp axis are read where they lie, and
    the output keeps that placement."""
    case = traces(4, 16, 64, 12)
    out = mesh_run(case, 2, 2, sharded=True)
    assert out.length.spec == ("dp", "sp")
    assert [b.shape for row in out.length.blocks for b in row] == \
        [(2, 32)] * 4
    assert_states_equal(out, jax_ref(case))


def test_long_document_over_eight_ranks(emulated):
    """One document at C = 4,096 over sp = 8 (512-slot tiles)."""
    case = traces(1, 24, 4096, 19)
    out = mesh_run(case, 1, 8)
    assert_states_equal(out, jax_ref(case))
    assert int(np_of(gather_tree(out))["count"][0]) > 24


@pytest.mark.parametrize("dp,sp", [(2, 4), (1, 8), (1, 1)])
def test_insert_runs_match_jax(emulated, dp, sp):
    """The INSERT_RUN variant (run-packed keystroke traces, C = 512):
    RUN_K-slot shifts across the rank boundaries (and in one block)."""
    case = run_batch()
    out = mesh_run(case, dp, sp)
    assert_states_equal(out, jax_scan(case))
    if sp == 8:
        st, ops, runs = case.jax()
        assert_states_equal(out, jfused_sp.apply_ops_fused_sp(st, ops, sp,
                                                              runs))


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 1)])
def test_overflow_near_capacity_matches_jax(emulated, dp, sp):
    case = traces(4, 40, 16, 3)  # tiny capacity
    want = jax_scan(case)
    assert np_of(want)["overflow"].any()
    assert_states_equal(mesh_run(case, dp, sp), want)


def test_stale_padding_matches_plain(emulated):
    """Fuzzed tables (every other document near full, stale rows past
    count in some) and ops of every kind from four clients, in both forms,
    against the port's plain version (held to JAX by
    tests/test_torch_fused_sp.py): the whole-table sweeps across ranks."""
    tables = fuzz_tables(4, 96, 3, 2, seed=5)
    cols = gen_fuzz_traces(4, 20, seed=5, length=tables["count"] * 2)
    case = Case(tables, cols)
    st, ops, _ = case.port()
    want = fused_sp.apply_ops_fused_sp_plain(st, ops, 4)
    assert bool(want.overflow.any())
    assert_states_equal(mesh_run(case, 2, 4), want)
    assert_states_equal(mesh_run(case, 1, 1), want)


def test_refusals_launch_nothing(emulated):
    """Each refusal of the kernel path raises ValueError before any
    launch."""
    n0 = launches()
    f = fused_sp.launch_shardmap
    st, ops, _ = traces(4, 8, 65, 0).port()
    with pytest.raises(ValueError, match="not divisible"):
        f(st, ops, cpu_mesh(4, 2))
    st, ops, runs = run_batch().port()
    narrow = st._replace(**{f: getattr(st, f)[:, :64].contiguous()
                            for f in ("length", "ins_seq", "ins_client",
                                      "local_seq", "rem_seq",
                                      "rem_local_seq", "origin_op",
                                      "origin_off", "rem_clients", "anno")})
    with pytest.raises(ValueError, match="shard tile 8"):
        f(narrow, ops, cpu_mesh(1, 8), runs=runs)
    st, ops, _ = traces(2, 4, 16, 0).port()
    with pytest.raises(ValueError, match="shift 1 >= shard tile 1"):
        f(st, ops, cpu_mesh(1, 16))
    st, ops, _ = traces(2, 4, 1024, 0).port()
    with pytest.raises(ValueError, match=r"1\.\.16"):
        f(st, ops, cpu_mesh(1, 32))
    st, ops, _ = traces(1, 4, 16_384, 0).port()
    with pytest.raises(ValueError, match="SMEM_LIMIT_BYTES"):
        f(st, ops, cpu_mesh(1, 2))
    st, ops, _ = traces(2, 4, 64, 0).port()
    with pytest.raises(ValueError, match="int32"):
        f(st._replace(length=st.length.to(torch.int64)), ops, cpu_mesh(1, 2))
    assert launches() == n0


def test_entry_point_refuses_other_geometries(emu_lib):
    """The C side checks the host's geometry against its own formulas and
    launches nothing on a mismatch."""
    st, ops, _ = traces(2, 4, 64, 0).port()
    b, c, k, a = 2, 64, st.overlap_slots, st.anno_slots
    n = 4
    geo = fused_sp.sp_geometry(c, k, a, n)
    tile = c // n

    def split(t):
        return [t[:, j * tile:(j + 1) * tile].contiguous() for j in range(n)]

    ins = {name: split(getattr(st, name)) for name in fused_sp._LEAVES}
    outs = {name: [torch.full_like(x, 77) for x in xs]
            for name, xs in ins.items()}
    scal = {name: [torch.empty_like(getattr(st, name)) for _ in range(n)]
            for name in fused_sp._SCALARS}
    table = torch.tensor(
        [x.data_ptr() for name in fused_sp._LEAVES for x in ins[name]]
        + [x.data_ptr() for name in fused_sp._LEAVES for x in outs[name]]
        + [x.data_ptr() for name in fused_sp._SCALARS for x in scal[name]],
        dtype=torch.int64)
    ptrs = [t.data_ptr() for t in (st.count, st.min_seq, st.seq,
                                   st.overflow, *ops)]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)

    def call(**kw):
        g = dict(batch=b, capacity=c, k=k, a=a, blocks=n,
                 threads=geo.threads, smem=geo.smem_bytes,
                 table=table.data_ptr())
        g.update(kw)
        return emu_lib.fluid_fused_sp(
            arr, g["table"], g["batch"], g["capacity"], g["k"], g["a"],
            ops.steps, 0, g["blocks"], g["threads"], g["smem"], None)

    def untouched():
        return all(bool((x == 77).all()) for x in outs["length"])

    bad = [dict(smem=geo.smem_bytes + 4), dict(threads=48),
           dict(threads=1024), dict(blocks=17), dict(blocks=0),
           dict(blocks=3), dict(k=9), dict(a=0), dict(table=None),
           dict(blocks=2)]
    for kw in bad:
        assert call(**kw) == INVALID_VALUE, kw
        assert untouched(), kw  # nothing ran
    assert call() == 0
    assert not untouched()
