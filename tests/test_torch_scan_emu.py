"""The CUDA source of the scan apply (fluidframework_tpu_torch/kernels/
csrc/scan_apply.cu) run on the CPU, both variants, against the port's
plain scan apply, bit for bit.

scan_apply.cu includes fused_apply.cu for the per-slot rules and the
block path's primitives; both sources are compiled with the host's C++
compiler against tests/simt/simt_emu.h, the SIMT emulator of
tests/test_torch_fused_emu.py (each CUDA thread a coroutine, warp and block
primitives as barriers, a shuffled thread order, shared memory starting
as random words). Device buffers are host memory here, so the table's
work buffer and the prefix-sum scratch are too. The capacities cross the
512-thread chunk loop and the fused apply's 4,141-slot limit; the
shared-memory scratch limit (28,992 slots) is crossed by forcing the
device-memory scratch at a small C. Only the card (chip_smoke.py) shows
that nvcc builds the kernel and what it costs.
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
    """scan_apply.cu for the emulator, with the shared-memory scratch limit
    set to `max_shared_slots` (the real one is out of an emulated block's
    reach)."""
    text = text.replace("#include <cuda_runtime.h>", '#include "simt_emu.h"')
    text, n_smem = re.subn(r"extern __shared__ int smem\[\];",
                           "int* smem = emu_smem;", text)
    text, n_launch = re.subn(
        r"(\w+)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\((\w+)\);",
        r"emu_launch(\1, \2, \3, \4, \6);", text)
    text, n_limit = re.subn(
        r"constexpr int kMaxSharedSlots =[^;]*;",
        f"constexpr int kMaxSharedSlots = {max_shared_slots};", text)
    assert (n_smem, n_launch, n_limit) == (1, 1, 1), \
        (n_smem, n_launch, n_limit)
    return text


def _build(tmp_path_factory, name, max_shared_slots):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    work = tmp_path_factory.mktemp(name)
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
                                     i32, i32, i32, ctypes.c_longlong, vp]
    dll.fluid_scan_apply.restype = i32
    return dll


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The kernel as built for the card: shared-memory scratch at every C
    an emulated test reaches."""
    return _build(tmp_path_factory, "scan_emu", tkernel.MAX_SHARED_SLOTS)


@pytest.fixture(scope="module")
def emu_lib_global(tmp_path_factory):
    """The kernel with its shared-memory limit at 0 slots: the prefix-sum
    and visibility planes always in the device-memory scratch buffer."""
    return _build(tmp_path_factory, "scan_emu_global", 0)


def emu_scan(lib, state, ops, runs, global_scratch=False, threads=None,
             smem=None, scratch="auto"):
    """One emulated launch with the wrapper's pointer layout; outputs start
    as junk so that every output element must be written, and the work
    buffer as junk so that every plane must be loaded."""
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    out = DocState(*(torch.ones_like(t) if t.dtype == torch.bool
                     else torch.full_like(t, 77) for t in state))
    work = torch.full((b, 8 + k + a, c), -55, dtype=torch.int32)
    geo = tkernel.scan_geometry(c, k, a)
    if global_scratch:
        geo = geo._replace(smem_bytes=128 * 4, global_scratch=True)
    buf = torch.full((b, 2, c), 99, dtype=torch.int32) \
        if (geo.global_scratch if scratch == "auto" else scratch) else None
    ptrs = [t.data_ptr() for t in (*state, *out, *ops, *(runs or ()),
                                   work)]
    ptrs.append(buf.data_ptr() if buf is not None else None)
    before = [t.clone() for t in state]
    rc = lib.fluid_scan_apply(
        (ctypes.c_void_p * len(ptrs))(*ptrs), b, c, k, a, ops.steps,
        int(runs is not None), geo.threads if threads is None else threads,
        geo.smem_bytes if smem is None else smem, None)
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


# (B, C, K, A, T, seed, fuzzed?): one slot, one warp's worth, partly
# filled warps, the block's chunk loop (C = 1,024 / 1,100), the fused
# apply's limit at K=3, A=1 (4,141 slots) and past it, K and A at their
# extremes, and a deep annotate ring.
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
    for ops, runs in streams:
        want = tkernel.scan_ops_plain(state, ops, batched=True, runs=runs)
        rc, got = emu_scan(emu_lib, state, ops, runs)
        assert rc == 0
        assert_same(got, want, f"C={capacity} runs={runs is not None}")
    if fuzz and capacity > 1:  # the fuzz reaches the overflow rules
        assert bool(want.overflow.any())


@pytest.mark.parametrize("capacity", [40, 1100])
def test_emulated_kernel_device_memory_scratch(emu_lib_global, capacity):
    """The prefix-sum and visibility planes in the device-memory scratch
    buffer (the path of C > 28,992 on the card)."""
    state, streams = cases(2, capacity, 3, 4, 8, 11, True)
    for ops, runs in streams:
        want = tkernel.scan_ops_plain(state, ops, batched=True, runs=runs)
        rc, got = emu_scan(emu_lib_global, state, ops, runs,
                           global_scratch=True)
        assert rc == 0
        assert_same(got, want, f"C={capacity} runs={runs is not None}")


def test_emulated_kernel_refuses_other_geometries(emu_lib):
    """The C side checks the host's geometry against its own formulas and
    launches nothing on a mismatch."""
    state, ((ops, _runs), _) = cases(2, 64, 3, 1, 4, 0, True)
    geo = tkernel.scan_geometry(64, 3, 1)
    for kwargs in (dict(threads=32), dict(smem=geo.smem_bytes + 4),
                   dict(scratch=True)):
        rc, got = emu_scan(emu_lib, state, ops, None, **kwargs)
        assert rc == INVALID_VALUE, kwargs
        assert bool((got.length == 77).all()), kwargs  # nothing ran
    wide = make_state(4, 1, 9, batch=1, device="cpu")  # K = 9 > 8
    ops1 = interop.packed_ops_from_numpy(gen_traces(1, 2), "cpu")
    ptrs = [t.data_ptr() for t in (*wide, *wide, *ops1, wide.length)]
    rc = emu_lib.fluid_scan_apply(
        (ctypes.c_void_p * (len(ptrs) + 1))(*ptrs, None), 1, 4, 9, 1, 2, 0,
        32, 128 * 4 + 2 * 4 * 4, None)
    assert rc == INVALID_VALUE
    with pytest.raises(ValueError, match="1 <= K <= 8"):
        tkernel.scan_geometry(4, 9, 1)
