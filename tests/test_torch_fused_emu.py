"""The CUDA source of the fused apply (fluidframework_tpu_torch/kernels/
csrc/fused_apply.cu) run on the CPU, both paths and all four variants,
against the port's plain version, bit for bit.

The source is compiled with the host's C++ compiler against
tests/simt/simt_emu.h, a SIMT emulator that runs each CUDA thread as a
coroutine (warp and block primitives are barriers; the threads between
them run in a shuffled order; shared memory starts as random words;
cp.async copies land at their wait). This checks the kernel's logic, its
barriers and its launch-geometry checks where there is no card; only the
card (chip_smoke.py) can show that nvcc builds it and what it costs. The
plain version itself is held against the JAX package by
tests/test_torch_fused_apply.py, on the same fuzzed tables and streams.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import pallas_apply as tpa
from fluidframework_tpu_torch.mergetree.state import DocState, make_state
from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                     gen_fuzz_traces,
                                                     gen_run_traces,
                                                     gen_traces)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "fluidframework_tpu_torch" / "kernels" / "csrc" / \
    "fused_apply.cu"
EMU_DIR = Path(__file__).resolve().parent / "simt"
INVALID_VALUE = 1  # cudaErrorInvalidValue


def emu_source(text: str) -> str:
    """fused_apply.cu with the CUDA runtime swapped for the emulator."""
    text = text.replace("#include <cuda_runtime.h>", '#include "simt_emu.h"')
    text = text.replace("#include <cuda_pipeline.h>\n", "")
    text, n_smem = re.subn(r"extern __shared__ int smem\[\];",
                           "int* smem = emu_smem;", text)
    text, n_launch = re.subn(
        r"(\w+)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\((\w+)\);",
        r"emu_launch(\1, \2, \3, \4, \6);", text)
    assert (n_smem, n_launch) == (2, 1), (n_smem, n_launch)
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    work = tmp_path_factory.mktemp("fused_emu")
    src = work / "fused_apply_emu.cpp"
    src.write_text(emu_source(SOURCE.read_text()))
    lib = work / "libfused_apply_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         f"-I{EMU_DIR}", str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.fluid_fused_apply.argtypes = [ctypes.POINTER(vp), i32, i32, i32, i32,
                                      i32, i32, i32, i32, i32, i32,
                                      ctypes.c_longlong, vp]
    dll.fluid_fused_apply.restype = i32
    return dll


def emu_apply(lib, state, ops, runs, extract, geo, path_code=None):
    """One emulated launch with the wrapper's pointer layout; outputs start
    as junk so that every output element must be written."""
    b, c = state.length.shape
    out = DocState(*(torch.ones_like(t) if t.dtype == torch.bool
                     else torch.full_like(t, 77) for t in state))
    narrow = (torch.full((b,), 5, dtype=torch.int16),
              *(torch.full((b,), 5, dtype=torch.int32) for _ in range(3))) \
        if extract else ()
    ptrs = [t.data_ptr() for t in (*state, *out, *ops, *(runs or ()),
                                   *narrow)]
    rc = lib.fluid_fused_apply(
        (ctypes.c_void_p * len(ptrs))(*ptrs), b, c, state.overlap_slots,
        state.anno_slots, ops.steps, int(runs is not None), int(extract),
        tpa._PATHS[geo.path] if path_code is None else path_code,
        geo.docs_per_block, geo.threads,
        geo.smem_bytes, None)
    return rc, ((out, narrow) if extract else out)


def assert_same(got, want, what):
    if hasattr(want, "_fields"):
        for name, g, w in zip(want._fields, got, want):
            assert torch.equal(g, w), f"{what}: {name}"
    elif isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        assert torch.equal(got, want), what


def geometries(batch, capacity, k, a, warp_docs):
    """The block path, and the warp path at each of `warp_docs` documents
    per block (any W the kernel takes, not only the one the rule picks)."""
    geos = [tpa._forced_geometry("block", capacity, k, a)]
    if capacity <= tpa.WARP_MAX_CAPACITY:
        geos += [tpa._warp_geometry(capacity, k, a, docs_per_block=w)
                 for w in warp_docs]
    return geos


def cases(batch, capacity, k, a, steps, seed, fuzz):
    """(state, [(ops, runs)]) for the plain and runs variants: fuzz_tables
    under gen_fuzz_traces, or empty tables under gen_traces /
    gen_run_traces (the main paths' generators)."""
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


# (B, C, K, A, T, seed, fuzzed?, warp documents per block): one row, the
# row boundary, a run's 8-slot shift across lanes and rows (C = 64: two
# rows), partly empty last blocks, the warp path's top capacity, K and A at
# their extremes, and the block path's thread chunks (C > 1024).
CASES = [
    (5, 1, 3, 4, 10, 2, True, (1,)),
    (9, 33, 3, 1, 12, 1, True, (1, 2)),
    (9, 64, 3, 4, 14, 0, True, (1, 4)),
    (13, 100, 3, 4, 12, 4, True, (1, 4, 8)),
    (7, 257, 3, 4, 12, 3, True, (1, 2)),
    (5, 512, 3, 4, 10, 6, True, (1,)),
    (10, 40, 8, 1, 12, 7, True, (2,)),
    (10, 70, 1, 8, 12, 8, True, (4,)),
    (6, 96, 3, 1, 20, 9, False, (1, 2)),
    (3, 1100, 3, 1, 8, 5, True, ()),
]


@pytest.mark.parametrize("batch,capacity,k,a,steps,seed,fuzz,warp_docs",
                         CASES)
def test_emulated_kernel_matches_plain(emu_lib, batch, capacity, k, a,
                                       steps, seed, fuzz, warp_docs):
    state, streams = cases(batch, capacity, k, a, steps, seed, fuzz)
    wants = {(runs is not None, ex): tpa.apply_ops_fused_plain(
        state, ops, runs=runs, extract=ex)
        for ops, runs in streams for ex in (False, True)}
    if fuzz:  # the fuzz reaches the overflow rules
        assert bool(wants[(False, False)].overflow.any())
    for geo in geometries(batch, capacity, k, a, warp_docs):
        for ops, runs in streams:
            for ex in (False, True):
                rc, got = emu_apply(emu_lib, state, ops, runs, ex, geo)
                assert rc == 0, geo
                assert_same(got, wants[(runs is not None, ex)],
                            f"{geo} runs={runs is not None} extract={ex}")


def test_emulated_kernel_refuses_other_geometries(emu_lib):
    """The C side checks the host's geometry against its own formulas and
    launches nothing on a mismatch."""
    state, ((ops, _runs), _) = cases(4, 64, 3, 1, 4, 0, True)
    warp = tpa._forced_geometry("warp", 64, 3, 1)
    block = tpa._forced_geometry("block", 64, 3, 1)
    bad = [(warp._replace(smem_bytes=warp.smem_bytes + 4), None),
           (warp._replace(threads=64), None),
           (warp._replace(docs_per_block=tpa.MAX_DOCS_PER_BLOCK + 1,
                          threads=32 * (tpa.MAX_DOCS_PER_BLOCK + 1)), None),
           (block._replace(threads=32), None),
           (block._replace(smem_bytes=warp.smem_bytes), None),
           (block, 7)]  # no such path
    for geo, code in bad:
        rc, got = emu_apply(emu_lib, state, ops, None, False, geo, code)
        assert rc == INVALID_VALUE, (geo, code)
        assert bool((got.length == 77).all()), geo  # nothing ran
    # the warp path stops at C = 512
    state600 = make_state(600, 1, batch=1, device="cpu")
    ops600 = interop.packed_ops_from_numpy(gen_traces(1, 2), "cpu")
    per_doc = (8 + 3 + 1) * 608 * 4
    rc, _ = emu_apply(emu_lib, state600, ops600, None, False,
                      tpa.Geometry("warp", 1, 32, per_doc))
    assert rc == INVALID_VALUE
