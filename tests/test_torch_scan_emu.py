"""The CUDA source of the scan apply (fluidframework_tpu_torch/kernels/
csrc/scan_apply.cu) run on the CPU, every path and both variants, against
the port's plain scan apply, bit for bit.

scan_apply.cu includes fused_apply.cu for the per-slot rules and
apply_one; both sources are compiled with the host's C++ compiler against
tests/simt/simt_emu.h, the SIMT emulator of tests/test_torch_fused_emu.py
(each CUDA thread a coroutine, warp, block and cluster primitives as
barriers, a shuffled thread order over all the blocks of a cluster, each
block's shared memory starting as random words, map_shared_rank as a
pointer into another block's). Device buffers are host memory here, so
the global paths' work buffer and view buffer are too. The cases cover:
the live-row cut on exact padding (empty and near-full tables), the
whole-table branch on stale padding (every fourth fuzzed document), one
block's shared memory, clusters of 2, 4 and 8 blocks (ranks of fewer slots
than a run's 8-slot shift, so shifts cross one or more ranks), the global
path with its view planes in shared memory and, with the limit forced to
0 slots, in the device buffer, and the global_chunked path. Only the card
(chip_smoke.py) shows that nvcc builds the kernels and what they cost.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.state import DocState, make_state
from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                     gen_fuzz_traces,
                                                     gen_run_traces,
                                                     gen_traces)

from test_torch_fused_emu import assert_same, emu_source

CSRC = Path(__file__).resolve().parents[1] / "fluidframework_tpu_torch" / \
    "kernels" / "csrc"
EMU_DIR = Path(__file__).resolve().parent / "simt"
INVALID_VALUE = 1  # cudaErrorInvalidValue


def scan_emu_source(text: str, max_shared_slots: int) -> str:
    """scan_apply.cu for the emulator, with the device-memory paths' view
    limit set to `max_shared_slots` (the real one is out of an emulated
    block's reach)."""
    text = text.replace("#include <cooperative_groups.h>\n", "")
    text, n_smem = re.subn(r"extern __shared__ int smem\[\];",
                           "int* smem = emu_smem;", text)
    text, n_limit = re.subn(
        r"constexpr int kMaxSharedSlots =[^;]*;",
        f"constexpr int kMaxSharedSlots = {max_shared_slots};", text)
    assert (n_smem, n_limit) == (2, 1), (n_smem, n_limit)
    return text


def build_emulated(work: Path, max_shared_slots: int):
    """Compile scan_apply.cu and fused_apply.cu for the emulator in `work`
    and load it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    (work / "fused_apply.cu").write_text(
        emu_source((CSRC / "fused_apply.cu").read_text()))
    src = work / "scan_apply_emu.cpp"
    src.write_text(scan_emu_source((CSRC / "scan_apply.cu").read_text(),
                                   max_shared_slots))
    lib = work / "libscan_apply_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         f"-I{EMU_DIR}", str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.fluid_scan_apply.argtypes = [ctypes.POINTER(vp), i32, i32, i32, i32,
                                     i32, i32, i32, i32, i32,
                                     ctypes.c_longlong, vp]
    dll.fluid_scan_apply.restype = i32
    return dll


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The kernels as built for the card: view planes in shared memory at
    every C an emulated test reaches."""
    return build_emulated(tmp_path_factory.mktemp("scan_emu"),
                          tkernel.MAX_SHARED_SLOTS)


@pytest.fixture(scope="module")
def emu_lib_global(tmp_path_factory):
    """The kernels with the view limit at 0 slots: the global paths keep
    their view planes in the device-memory buffer at every C."""
    return build_emulated(tmp_path_factory.mktemp("scan_emu_global"), 0)


def emu_scan(lib, state, ops, runs, geo, path_code=None, work="auto",
             scratch="auto"):
    """One emulated launch with the wrapper's pointer layout; outputs start
    as junk so that every output element must be written, and the work and
    view buffers as junk so that every plane must be loaded."""
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    out = DocState(*(torch.ones_like(t) if t.dtype == torch.bool
                     else torch.full_like(t, 77) for t in state))
    global_path = geo.path in ("global", "global_chunked")
    wbuf = torch.full((b, 8 + k + a, c), -55, dtype=torch.int32) \
        if (global_path if work == "auto" else work) else None
    sbuf = torch.full((b, 2, c), 99, dtype=torch.int32) \
        if (geo.global_scratch if scratch == "auto" else scratch) else None
    ptrs = [t.data_ptr() for t in (*state, *out, *ops, *(runs or ()))]
    ptrs += [None if x is None else x.data_ptr() for x in (wbuf, sbuf)]
    before = [t.clone() for t in state]
    rc = lib.fluid_scan_apply(
        (ctypes.c_void_p * len(ptrs))(*ptrs), b, c, k, a, ops.steps,
        int(runs is not None),
        tkernel._SCAN_PATHS[geo.path] if path_code is None else path_code,
        geo.blocks, geo.threads, geo.smem_bytes, None)
    for t, t0 in zip(state, before):
        assert torch.equal(t, t0), "the kernel wrote its input"
    return rc, out


def cases(batch, capacity, k, a, steps, seed, fuzz):
    """(state, [(ops, runs)]) for the plain and runs variants: fuzz_tables
    under gen_fuzz_traces, or empty tables under gen_traces /
    gen_run_traces."""
    if fuzz:
        tables = fuzz_tables(batch, capacity, k, a, seed=seed)
        length = tables["count"] * 2
        cols = gen_fuzz_traces(batch, steps, seed=seed, length=length)
        rcols, rruns = gen_fuzz_traces(batch, steps, seed=seed + 100,
                                       runs=True, length=length)
        state = interop.doc_state_from_numpy(tables, "cpu")
    else:
        cols = gen_traces(batch, steps, seed=seed)
        rcols, rruns = gen_run_traces(batch, steps, seed=seed)
        state = make_state(capacity, a, k, batch=batch, device="cpu")
    return state, [(interop.packed_ops_from_numpy(cols, "cpu"), None),
                   (interop.packed_ops_from_numpy(rcols, "cpu"),
                    interop.run_cols_from_numpy(rruns, "cpu"))]


def check_geometries(lib, state, streams, geos, fuzz):
    for ops, runs in streams:
        want = tkernel.scan_ops_plain(state, ops, batched=True, runs=runs)
        for geo in geos:
            rc, got = emu_scan(lib, state, ops, runs, geo)
            assert rc == 0, geo
            assert_same(got, want, f"{geo} runs={runs is not None}")
    if fuzz and state.capacity > 1:  # the fuzz reaches the overflow rules
        assert bool(want.overflow.any())


# (B, C, K, A, T, seed, fuzzed?): one slot, one warp's worth, partly
# filled warps, C = 1,024 / 1,100, the fused apply's limit at K=3, A=1
# (4,141 slots) and past it, K and A at their extremes, and a deep
# annotate ring; each on the path the rule names (smem, or global above
# one block's shared memory).
CASES = [
    (3, 1, 3, 4, 8, 0, True),
    (4, 33, 3, 1, 12, 1, True),
    (4, 96, 3, 1, 16, 9, False),
    (3, 257, 8, 2, 10, 3, True),
    (2, 100, 1, 40, 14, 4, True),
    (2, 1024, 3, 4, 10, 5, True),
    (4, 1100, 3, 1, 10, 6, True),
    (2, 4141, 3, 1, 8, 7, True),
    (2, 4900, 3, 1, 8, 8, True),
]


@pytest.mark.parametrize("batch,capacity,k,a,steps,seed,fuzz", CASES)
def test_emulated_kernel_matches_plain(emu_lib, batch, capacity, k, a,
                                       steps, seed, fuzz):
    state, streams = cases(batch, capacity, k, a, steps, seed, fuzz)
    geo = tkernel.scan_geometry(batch, capacity, k, a)
    check_geometries(emu_lib, state, streams, [geo], fuzz)


# (path, blocks, threads, B, C, K, A, T, seed, fuzzed?): every path at
# few threads (strips of several slots), clusters whose ranks hold fewer
# slots than a run's shift (C = 40 over 8 ranks: 5 slots each) and more,
# near-full and stale-padded fuzz tables, and empty tables where the live
# rows are a small part of C.
PATH_CASES = [
    ("smem", 1, 32, 4, 70, 3, 4, 14, 21, True),
    ("smem", 1, 64, 2, 300, 3, 1, 24, 22, False),
    ("global", 1, 32, 4, 70, 3, 4, 14, 23, True),
    ("global", 1, 96, 2, 300, 3, 1, 24, 24, False),
    ("global_chunked", 1, None, 4, 70, 3, 4, 14, 25, True),
    ("cluster", 2, 32, 4, 70, 3, 4, 14, 26, True),
    ("cluster", 2, 64, 2, 300, 3, 1, 24, 27, False),
    ("cluster", 4, 32, 4, 40, 3, 2, 14, 28, True),
    ("cluster", 4, 32, 4, 130, 8, 1, 12, 29, True),
    ("cluster", 8, 32, 4, 40, 3, 4, 14, 30, True),
    ("cluster", 8, 32, 2, 200, 1, 3, 20, 31, False),
]


@pytest.mark.parametrize(
    "path,blocks,threads,batch,capacity,k,a,steps,seed,fuzz", PATH_CASES)
def test_emulated_paths_match_plain(emu_lib, path, blocks, threads, batch,
                                    capacity, k, a, steps, seed, fuzz):
    state, streams = cases(batch, capacity, k, a, steps, seed, fuzz)
    geo = tkernel._forced_geometry(path, capacity, k, a,
                                   blocks=blocks if path == "cluster"
                                   else None, threads=threads)
    check_geometries(emu_lib, state, streams, [geo], fuzz)


@pytest.mark.parametrize("capacity", [40, 1100])
def test_emulated_kernel_device_memory_scratch(emu_lib_global, capacity):
    """The global paths' view planes in the device-memory buffer (the
    paths of C > MAX_SHARED_SLOTS on the card)."""
    state, streams = cases(4 if capacity < 100 else 2, capacity, 3, 4, 8,
                           11, True)
    geos = []
    for path in ("global", "global_chunked"):
        geo = tkernel._forced_geometry(path, capacity, 3, 4)
        geos.append(geo._replace(
            smem_bytes=geo.smem_bytes - 2 * capacity * 4,
            global_scratch=True))
    check_geometries(emu_lib_global, state, streams, geos, True)


def test_emulated_kernel_refuses_other_geometries(emu_lib):
    """The C side checks the host's geometry against its own formulas and
    launches nothing on a mismatch."""
    state, ((ops, _runs), _) = cases(2, 64, 3, 1, 4, 0, True)
    smem = tkernel._forced_geometry("smem", 64, 3, 1)
    chunked = tkernel._forced_geometry("global_chunked", 64, 3, 1)
    glob = tkernel._forced_geometry("global", 64, 3, 1)
    cl = tkernel._forced_geometry("cluster", 64, 3, 1, blocks=4)
    bad = [(chunked._replace(threads=32), {}),
           (chunked._replace(smem_bytes=chunked.smem_bytes + 4), {}),
           (chunked, dict(scratch=True)),
           (glob._replace(threads=48), {}),
           (glob._replace(threads=544), {}),
           (glob, dict(work=False)),
           (smem._replace(smem_bytes=smem.smem_bytes - 4), {}),
           (smem._replace(blocks=2), {}),
           (smem, dict(work=True)),
           (cl._replace(blocks=1), {}),
           (cl._replace(blocks=32), {}),
           (cl._replace(smem_bytes=smem.smem_bytes), {}),
           (smem, dict(path_code=7))]  # no such path
    for geo, kwargs in bad:
        rc, got = emu_scan(emu_lib, state, ops, None, geo, **kwargs)
        assert rc == INVALID_VALUE, (geo, kwargs)
        assert bool((got.length == 77).all()), geo  # nothing ran
    wide = make_state(4, 1, 9, batch=1, device="cpu")  # K = 9 > 8
    ops1 = interop.packed_ops_from_numpy(gen_traces(1, 2), "cpu")
    ptrs = [t.data_ptr() for t in (*wide, *wide, *ops1)]
    rc = emu_lib.fluid_scan_apply(
        (ctypes.c_void_p * (len(ptrs) + 2))(*ptrs, None, None), 1, 4, 9, 1,
        2, 0, tkernel._SCAN_PATHS["smem"], 1, 32,
        tkernel.shared_table_bytes(4, 9, 1, 1), None)
    assert rc == INVALID_VALUE
    with pytest.raises(ValueError, match="1 <= K <= 8"):
        tkernel.scan_geometry(1, 4, 9, 1)
    with pytest.raises(ValueError, match="cannot hold"):
        tkernel._forced_geometry("smem", 4096, 3, 4)
