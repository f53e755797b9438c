"""The CUDA source of the summary length (fluidframework_tpu_torch/kernels/
csrc/summary_len.cu) run on the CPU against the JAX package's Pallas
kernel in interpret mode, bit for bit: summary_len_kernel, with its
16-byte and scalar loops, at C = 1, 3, 4, 33 and 256, on 16-byte-aligned rows and on rows one int32
off (the scalar loop), with more documents than the emulated card's
persistent grid has warps (each warp walks several documents).

The source is compiled with the host's C++ compiler against
tests/simt/simt_emu.h, the SIMT emulator of tests/test_torch_fused_emu.py;
its card has two SMs of one block each. Only the card (chip_smoke.py)
shows that nvcc builds the kernels and what they cost.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree.pallas_ops import _pallas_summary_lengths
from fluidframework_tpu.mergetree.state import DocState as JaxDocState

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import pallas_ops

from test_torch_summary import applied_state, random_state
from test_torch_fused_apply import jax_to_np

SOURCE = Path(__file__).resolve().parents[1] / "fluidframework_tpu_torch" / \
    "kernels" / "csrc" / "summary_len.cu"
EMU_DIR = Path(__file__).resolve().parent / "simt"
PLANES = ("length", "ins_seq", "rem_seq", "count", "seq")
ENTRIES = ("fluid_summary_len",)


def summary_emu_source(text: str) -> str:
    """summary_len.cu with the CUDA runtime swapped for the emulator."""
    text = text.replace("#include <cuda_runtime.h>", '#include "simt_emu.h"')

    def launch(m):
        grid, threads, smem = (x.strip() for x in m[2].split(",")[:3])
        return f"emu_launch({m[1]}, {grid}, {threads}, {smem}, {m[3]});"
    text, n = re.subn(r"(\w+)<<<(.*?)>>>\((\w+)\);", launch, text,
                      flags=re.S)
    assert n == 1, n
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    work = tmp_path_factory.mktemp("summary_emu")
    src = work / "summary_len_emu.cpp"
    src.write_text(summary_emu_source(SOURCE.read_text()))
    lib = work / "libsummary_len_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         f"-I{EMU_DIR}", str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for entry in ENTRIES:
        fn = getattr(dll, entry)
        fn.argtypes = [vp] * 6 + [i32, i32, vp]
        fn.restype = i32
    return dll


def placed(x: np.ndarray, offset: int) -> np.ndarray:
    """A C-contiguous copy of x whose data starts `offset` int32 past a
    64-byte boundary."""
    buf = np.empty(x.size + 16 + offset, np.int32)
    start = (-buf.ctypes.data // 4) % 16 + offset
    out = buf[start:start + x.size].reshape(x.shape)
    out[...] = x
    return out


def emu_lengths(lib, entry: str, st: dict, offset: int) -> np.ndarray:
    b, c = st["length"].shape
    planes = [placed(st[f], offset if f in PLANES[:3] else 0)
              for f in PLANES]
    out = np.full(b, -77, np.int32)
    rc = getattr(lib, entry)(*(p.ctypes.data for p in planes),
                             out.ctypes.data, b, c, None)
    assert rc == 0
    return out


def jax_lengths(st: dict) -> np.ndarray:
    js = JaxDocState(**{f: jnp.asarray(v) for f, v in st.items()})
    return np.asarray(_pallas_summary_lengths(js, interpret=True))


@pytest.mark.parametrize("capacity", [1, 3, 4, 33, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_kernels_match_jax(emu_lib, capacity, seed):
    st = random_state(10 * capacity + seed, 37, capacity)
    want = jax_lengths(st)
    plain = pallas_ops.summary_lengths_plain(
        interop.doc_state_from_numpy(st, "cpu")).numpy()
    np.testing.assert_array_equal(plain, want)
    for entry in ENTRIES:
        for offset in (0, 1):  # aligned rows, then rows one int32 off
            got = emu_lengths(emu_lib, entry, st, offset)
            np.testing.assert_array_equal(
                got, want, err_msg=f"{entry} C={capacity} offset {offset}")


def test_emulated_kernels_after_apply_match_jax(emu_lib):
    """A table the apply built (runs of removed and pending segments)."""
    st = jax_to_np(applied_state(20, 64, 50, 3))
    want = jax_lengths(st)
    for entry in ENTRIES:
        np.testing.assert_array_equal(
            emu_lengths(emu_lib, entry, st, 0), want, err_msg=entry)


def test_cpu_tensors_take_the_plain_version():
    """summary_lengths on CPU tensors runs the plain version and counts
    no launch; the launch path refuses CPU tensors."""
    st = interop.doc_state_from_numpy(random_state(5, 9, 33), "cpu")
    pallas_ops.summary_lengths.launches = 0
    got = pallas_ops.summary_lengths(st)
    assert torch.equal(got, pallas_ops.summary_lengths_plain(st))
    assert pallas_ops.summary_lengths.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        pallas_ops._launch(st, "fluid_summary_len", "summary_lengths")
