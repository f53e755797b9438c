"""The CUDA sources of zamboni (fluidframework_tpu_torch/kernels/csrc/
zamboni.cu: compaction, the fused compaction + extraction, extraction)
and of the narrow wire (kernels/csrc/narrow_pack.cu) run on the CPU
against the JAX package's functions, bit for bit.

Both sources are compiled with the host's C++ compiler against
tests/simt/simt_emu.h (each CUDA thread a coroutine, warp votes and block
barriers as exchanges, the threads between them in a shuffled order,
shared memory starting as random words) and reached through the port's
own entry points (kernel.compact, compact_batched, extract_visible_batched,
compact_extract_batched, compact_pages, compact_extract_paged,
fetch_extracted) on CPU tensors that the wrappers take as the card's: their
checks, their pointer layouts and their launch counts. Inputs are seeded
numpy tables (tests/test_torch_extract.py's fuzz_state, whose every fourth
document holds stale rows past its count) at B in {1, 3, 5}, C in {8, 64,
300, 1,100} (a tile loop of up to five 256-row tiles, widths that are not
a multiple of 32), K = 3, A in {1, 4}, and one document at C = 4,096 (the
catch-up fold's shape); edge tables (count 0, count = C, every row
removed, pending removes beside the remove sentinels, an out-of-range
delta, clamped values) and a batch of zero documents. Tolerance: exact
equality (every field is int32, int16 or bool). Only the card
(chip_smoke.py phase 14) shows that nvcc builds the kernels and what they
cost.
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

from fluidframework_tpu.mergetree import kernel as jkernel

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.kernels import build
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.constants import (DEV_NO_REMOVE,
                                                          DEV_UNASSIGNED)
from fluidframework_tpu_torch.mergetree.state import DocState, make_state

from test_torch_extract import fetch_both, fuzz_state, wide_span_arrays
from test_torch_paged_ops import (assert_tree_equal, jax_state, paged_case,
                                  port_state, to_np)

CSRC = Path(__file__).resolve().parents[1] / "fluidframework_tpu_torch" / \
    "kernels" / "csrc"
EMU_DIR = Path(__file__).resolve().parent / "simt"
SOURCES = ("zamboni.cu", "narrow_pack.cu")
INVALID_VALUE = 1  # cudaErrorInvalidValue


def emu_source(text: str) -> str:
    """A kernel source with the CUDA runtime swapped for the emulator, its
    dynamic shared memory for the emulated block's, and its one launch
    for emu_launch."""
    text = text.replace("#include <cuda_runtime.h>", '#include "simt_emu.h"')
    text = text.replace("#include <cooperative_groups.h>\n", "")
    text, n_smem = re.subn(r"extern __shared__ int smem\[\];",
                           "int* smem = emu_smem;", text)
    text, n = re.subn(r"([\w<>]+)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>"
                      r"\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \6);", text)
    assert n == 1 and n_smem in (1, 2), (n_smem, n)
    return text


def build_emulated(work: Path) -> ctypes.CDLL:
    """One shared library of both sources under the emulator, with the
    entry points' ctypes signatures as kernels/build.py declares them."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    cpps = []
    for name in SOURCES:
        cpp = work / (Path(name).stem + "_emu.cpp")
        cpp.write_text(emu_source((CSRC / name).read_text()))
        cpps.append(str(cpp))
    lib = work / "libzamboni_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fno-strict-aliasing", "-fPIC",
         "-shared", "-w",
         f"-I{EMU_DIR}", *cpps, "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    ptrs = ctypes.POINTER(vp)
    dll.fluid_zamboni.argtypes = [ptrs, i32, i32, i32, i32, i32, i32, i32,
                                  i32, i32, vp]
    dll.fluid_zamboni.restype = i32
    dll.fluid_narrow_pack.argtypes = [ptrs, i32, i32, i32, i32, vp]
    dll.fluid_narrow_pack.restype = i32
    return dll


def use_emulated(monkeypatch, lib) -> None:
    """Route the zamboni and narrow-pack wrappers to the emulated library:
    the library, a null stream, and CPU tensors taken as the card's."""
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    monkeypatch.setattr(tkernel, "_on_card", lambda _device: True)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("zamboni_emu"))


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    use_emulated(monkeypatch, emu_lib)
    return emu_lib


def launches() -> dict:
    return {**tkernel.zamboni.mode_launches,
            "narrow_pack": tkernel.narrow_pack.launches}


def launched(before: dict) -> dict:
    return {k: n - before[k] for k, n in launches().items()
            if n != before[k]}


def run_port(fn, arrays, *args, **kwargs):
    """The port's function on the state, checking that its input was not
    written."""
    state = port_state(arrays)
    copies = [x.clone() for x in state]
    out = fn(state, *args, **kwargs)
    for x, x0 in zip(state, copies):
        assert torch.equal(x, x0), "the kernel wrote its input"
    return to_np(out)


def check_batched(arrays, what: str) -> None:
    """compact_batched, extract_visible_batched and
    compact_extract_batched(stats=False/True) through the kernel against
    JAX, each one launch in its mode; compact of document 0 too."""
    b = arrays["length"].shape[0]
    js = jax_state(arrays)
    cases = [("compact_batched", {}, "compact"),
             ("extract_visible_batched", {}, "extract"),
             ("compact_extract_batched", {"stats": False},
              "compact_extract"),
             ("compact_extract_batched", {"stats": True},
              "compact_extract")]
    for name, kwargs, mode in cases:
        before = launches()
        got = run_port(getattr(tkernel, name), arrays, **kwargs)
        assert launched(before) == ({mode: 1} if b else {}), (what, name)
        want = to_np(getattr(jkernel, name)(js, **kwargs))
        assert_tree_equal(got, want, f"{what}: {name}{kwargs}")
    if b:
        one = {f: v[0] for f, v in arrays.items()}
        got = run_port(tkernel.compact, one)
        assert_tree_equal(got, to_np(jkernel.compact(jax_state(one))),
                          f"{what}: compact of document 0")


@pytest.mark.parametrize("b,c,a", [(1, 1100, 1), (3, 300, 4), (5, 64, 1),
                                   (5, 8, 4), (3, 8, 1), (1, 64, 4),
                                   (5, 300, 1)])
def test_batched_match_jax(emulated, b, c, a):
    arrays = fuzz_state(b * 100 + c + a, b, c, 3, a)
    check_batched(arrays, f"B={b} C={c} A={a}")


def test_single_wide_document_matches_jax(emulated):
    """One document at C = 4,096 (the catch-up fold's compaction): the
    running base crosses sixteen tiles."""
    arrays = fuzz_state(41, 2, 4096, 3, 1)
    one = {f: v[1] for f, v in arrays.items()}
    assert one["count"] > 3000
    before = launches()
    got = run_port(tkernel.compact, one)
    assert launched(before) == {"compact": 1}
    assert_tree_equal(got, to_np(jkernel.compact(jax_state(one))),
                      "compact at C=4096")


def edge_arrays(c: int = 40, a: int = 2):
    """Five documents: count 0; count = C with nothing removed; every row
    removed at or before min_seq; pending removes (DEV_UNASSIGNED) and
    never-removed rows (DEV_NO_REMOVE) under a min_seq just below the
    sentinels, beside real removes it frees; a count past C."""
    arrays = fuzz_state(7, 5, c, 3, a)
    arrays["count"][:] = [0, c, c, c, c + 9]
    arrays["rem_seq"][1] = DEV_NO_REMOVE
    arrays["rem_seq"][2] = np.arange(c, dtype=np.int32) % 5
    arrays["min_seq"][2] = 4
    rem = np.full(c, DEV_NO_REMOVE, np.int32)
    rem[::3] = DEV_UNASSIGNED
    rem[1::7] = 1 << 20
    arrays["rem_seq"][3] = rem
    arrays["min_seq"][3] = DEV_NO_REMOVE - 1
    arrays["min_seq"][4] = 3
    return arrays


def test_edge_tables_match_jax(emulated):
    arrays = edge_arrays()
    check_batched(arrays, "edges")
    comp = to_np(tkernel.compact_batched(port_state(arrays)))
    counts = comp[DocState._fields.index("count")]
    c = arrays["length"].shape[1]
    assert counts[0] == 0 and counts[1] == c and counts[2] == 0
    assert 0 < counts[3] < c   # the sentinels stay, the real removes go


def test_zero_document_batch(emulated):
    """B = 0 launches nothing and gives JAX's empty outputs."""
    arrays = interop.to_numpy(make_state(16, 2, batch=0, device="cpu"))
    check_batched(arrays, "B=0")
    t_packed = tkernel.compact_extract_batched(port_state(arrays))[1]
    j_packed = jkernel.compact_extract_batched(jax_state(arrays))[1]
    before = launches()
    for narrow in (True, False):
        out, _ = fetch_both(t_packed, j_packed, narrow)
        assert out[0].shape == (0, 16)
    assert launched(before) == {}


@pytest.mark.parametrize("seed", [0, 3])
def test_paged_forms_match_jax(emulated, seed):
    """compact_pages and compact_extract_paged (and their _keep twins)
    run the kernel on the gathered view, one launch each."""
    pool, pids, counts, mins, seqs = paged_case(seed)
    args = (pids, counts, mins + 4, seqs)

    def port(name):
        before = launches()
        out = getattr(tkernel, name)(port_state(pool),
                                     *(torch.from_numpy(x) for x in args))
        return to_np(out), launched(before)

    for name, mode in (("compact_pages_keep", "compact"),
                       ("compact_pages", "compact"),
                       ("compact_extract_paged_keep", "compact_extract"),
                       ("compact_extract_paged", "compact_extract")):
        got, n = port(name)
        assert n == {mode: 1}, (name, n)
        want = to_np(getattr(jkernel, name.replace("_keep", "") + "_keep")(
            jax_state(pool), *(jnp.asarray(x) for x in args)))
        assert_tree_equal(got, want, name)


def fetch_pair(arrays, fn_name):
    """The packed rows of the same state through the emulated kernel and
    through JAX."""
    t_out = getattr(tkernel, fn_name)(port_state(arrays))
    j_out = getattr(jkernel, fn_name)(jax_state(arrays))
    if fn_name == "compact_extract_batched":
        t_out, j_out = t_out[1], j_out[1]
    return t_out, j_out


@pytest.mark.parametrize("fn_name", ["extract_visible_batched",
                                     "compact_extract_batched"])
def test_fetch_both_forms_with_refetch(emulated, fn_name):
    """fetch_extracted narrow and wide on the kernel's packed rows, the
    narrow form through narrow_pack.cu: document 0 escapes int16 and is
    refetched exactly, as in JAX (same bytes, same counters)."""
    t_packed, j_packed = fetch_pair(wide_span_arrays(), fn_name)
    before = launches()
    narrow, d = fetch_both(t_packed, j_packed, True)
    assert launched(before) == {"narrow_pack": 1}
    assert d["summarize.wire_refetch"] == 1
    wide, _ = fetch_both(t_packed, j_packed, False)
    assert launched(before) == {"narrow_pack": 1}
    assert narrow[4][0, 3] == DEV_UNASSIGNED
    assert narrow[6][0, 2] == DEV_UNASSIGNED


def clamp_arrays():
    """Packed-row inputs for the narrow pack's corners: values past the
    int16 range both ways (clamped, ok = 0), annotate ids whose least is
    at or above the 1 << 30 sentinel (base 0), a pending insert and a
    pending remove, and a document whose rows are all pending (every base
    0)."""
    arrays = fuzz_state(5, 4, 64, 3, 4)
    arrays["count"][:] = [10, 12, 64, 5]
    arrays["rem_seq"][:] = DEV_NO_REMOVE
    arrays["min_seq"][:] = 0
    arrays["length"][0, 3] = 40000
    arrays["ins_client"][0, 4] = -40000
    arrays["anno"][1] = -1
    arrays["anno"][1, :6, 0] = (1 << 30) + np.arange(6)
    arrays["ins_seq"][2, 5] = DEV_UNASSIGNED
    arrays["rem_seq"][2, 7] = DEV_UNASSIGNED
    arrays["rem_seq"][2, 9] = 70000
    arrays["rem_seq"][2, 10] = 3
    arrays["ins_seq"][3] = DEV_UNASSIGNED
    arrays["rem_seq"][3] = DEV_UNASSIGNED
    arrays["anno"][3] = -1
    return arrays


@pytest.mark.parametrize("mx", [1, 32, 37, 64])
def test_narrow_pack_matches_jax(emulated, mx):
    """narrow_pack.cu at several slice widths against JAX's _narrow_pack
    on the packed rows of fuzzed and corner tables."""
    for arrays in (fuzz_state(mx, 5, 64, 3, 4), clamp_arrays()):
        t_packed, j_packed = fetch_pair(arrays, "extract_visible_batched")
        before = launches()
        got = to_np(tkernel.narrow_pack(t_packed, mx))
        assert launched(before) == {"narrow_pack": 1}
        want = to_np(jkernel._narrow_pack(j_packed, mx))
        assert_tree_equal(got, want, f"narrow_pack mx={mx}")
        assert_tree_equal(got, to_np(tkernel.narrow_pack_plain(
            tuple(x.clone() for x in t_packed), mx)),
            f"narrow_pack_plain mx={mx}")


def test_wrappers_refuse_what_the_kernels_do_not_take(emulated):
    """A wrong dtype, a strided plane, an unknown mode and a width out of
    range raise ValueError before any launch."""
    arrays = fuzz_state(2, 3, 64, 3, 1)
    before = launches()
    state = port_state(arrays)
    with pytest.raises(ValueError, match="int32"):
        tkernel.compact_batched(state._replace(length=state.length.long()))
    wide = torch.zeros((3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.extract_visible_batched(
            state._replace(ins_seq=wide[:, ::2]))
    with pytest.raises(ValueError, match="unknown mode"):
        tkernel.zamboni(state, "sweep")
    packed = tkernel.extract_visible_batched(state)
    with pytest.raises(ValueError, match="outside"):
        tkernel.narrow_pack(packed, 65)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.narrow_pack(packed[:2] + (packed[2].t().contiguous().t(),)
                            + packed[3:], 32)
    assert launched(before) == {"extract": 1}


def test_cuda_entry_points_refuse_bad_shapes(emu_lib):
    """B or C below 1, K below 1, an unknown mode and a width outside 1..C
    launch nothing (zamboni on a geometry it takes: the warp path, four
    documents a block)."""
    buf = np.zeros(64, np.int32)
    p = buf.ctypes.data

    def zamboni(mode, b, c, k, a):
        return emu_lib.fluid_zamboni((ctypes.c_void_p * 33)(*[p] * 33),
                                     mode, b, c, k, a, 0, 1, 128, 4, None)

    def narrow(b, c, mx, a):
        return emu_lib.fluid_narrow_pack((ctypes.c_void_p * 13)(*[p] * 13),
                                         b, c, mx, a, None)
    assert zamboni(0, 0, 4, 3, 1) == INVALID_VALUE
    assert zamboni(1, 2, 0, 3, 1) == INVALID_VALUE
    assert zamboni(2, 2, 4, 0, 1) == INVALID_VALUE
    assert zamboni(3, 2, 4, 3, 1) == INVALID_VALUE
    assert narrow(0, 4, 1, 1) == INVALID_VALUE
    assert narrow(2, 4, 5, 1) == INVALID_VALUE
    assert narrow(2, 4, 0, 1) == INVALID_VALUE
    assert (buf == 0).all()


def test_off_card_tensors_raise_without_the_library(monkeypatch):
    """A tensor that is neither on the CPU nor on the card (the meta
    device) raises ValueError and never reaches the library; CPU tensors
    take the plain versions and launch nothing."""
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(build, "library", no_library)
    state = make_state(8, 1, batch=2, device="meta")
    for fn in (tkernel.compact_batched, tkernel.extract_visible_batched,
               tkernel.compact_extract_batched):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(state)
    before = launches()
    cpu = port_state(fuzz_state(3, 2, 16, 3, 1))
    packed = tkernel.compact_extract_batched(cpu)[1]
    tkernel.narrow_pack(packed, 16)
    tkernel.compact(DocState(*(x[0] for x in cpu)))
    assert launched(before) == {}
