"""The CUDA source of the LWW lane scan (fluidframework_tpu_torch/kernels/
csrc/lww_scan.cu) run on the CPU against the JAX package's
apply_lww_batched, bit for bit.

The source is compiled with the host's C++ compiler against
tests/simt/simt_emu.h (each CUDA thread a coroutine, warp votes and
shuffles as barriers, the threads between them in a shuffled order) and
driven through the port's own wrapper (lww_kernel._launch: its checks, its
pointer layout and its launch count) on CPU tensors. The ops cover SET on a
full table (overflow), SET of a present key, DELETE of a present and of an
absent key, CLEAR, negative ADD, NOOP, kinds past ADD and seq <= 0, on
tables that start part full, at C = 8, 64 and 1,024 with B = 4 (one block)
and 5 (a partly empty second block) and T = 40 (two 32-step load chunks),
and at C = 16,384 with B = 1, T = 4. The admit mode (the serving window's
LWW bucket) is held to the JAX window's expressions on the same staged
columns. Only the card (chip_smoke.py) shows that nvcc builds the kernel
and what it costs.
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

from fluidframework_tpu.server import lww_kernel as jlk

from fluidframework_tpu_torch.kernels import build
from fluidframework_tpu_torch.server import lww_kernel as lk

CSRC = Path(__file__).resolve().parents[1] / "fluidframework_tpu_torch" / \
    "kernels" / "csrc"
EMU_DIR = Path(__file__).resolve().parent / "simt"
INVALID_VALUE = 1  # cudaErrorInvalidValue


def emu_source(text: str) -> str:
    """A kernel source with the CUDA runtime swapped for the emulator and
    its one launch for emu_launch."""
    text = text.replace("#include <cuda_runtime.h>", '#include "simt_emu.h"')
    text, n = re.subn(r"([\w<>]+)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>"
                      r"\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \6);", text)
    assert n == 1, n
    return text


def build_emulated(work: Path, sources) -> ctypes.CDLL:
    """One shared library of the given csrc/ sources under the emulator,
    with the entry points' ctypes signatures as kernels/build.py declares
    them."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    cpps = []
    for name in sources:
        cpp = work / (Path(name).stem + "_emu.cpp")
        cpp.write_text(emu_source((CSRC / name).read_text()))
        cpps.append(str(cpp))
    lib = work / "libwindow_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         f"-I{EMU_DIR}", *cpps, "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    ptrs = ctypes.POINTER(vp)
    if "lww_scan.cu" in sources:
        dll.fluid_lww_scan.argtypes = [ptrs, i32, i32, i32, i32, i32, vp]
        dll.fluid_lww_scan.restype = i32
    if "window_admit.cu" in sources:
        dll.fluid_window_admit.argtypes = [ptrs, i32, i32, i32, i32, i32,
                                           vp]
        dll.fluid_window_admit.restype = i32
    if "window_pack.cu" in sources:
        dll.fluid_window_pack_scratch_words.argtypes = []
        dll.fluid_window_pack_scratch_words.restype = i32
        dll.fluid_window_pack.argtypes = [ptrs, ctypes.POINTER(i32), i32,
                                          i32, i32, i32, i32, i32, vp]
        dll.fluid_window_pack.restype = i32
    return dll


def use_emulated(monkeypatch, lib, *modules) -> None:
    """Route the wrappers' launches to the emulated library: the library,
    a null stream, and CPU tensors accepted as the card's."""
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    for module in modules:
        monkeypatch.setattr(module, "_on_card", lambda _device: True)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("lww_emu"),
                          ["lww_scan.cu"])


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    use_emulated(monkeypatch, emu_lib, lk)
    return emu_lib


def random_state(rng, b, c, fill=0.5):
    """Tables part full (keys 0..2C-1, some slots free)."""
    key = rng.integers(0, 2 * c, (b, c)).astype(np.int32)
    key[rng.random((b, c)) > fill] = -1
    val = np.where(key >= 0, rng.integers(0, 1000, (b, c)), -1)
    return {"key": key, "val": val.astype(np.int32),
            "seq": rng.integers(0, 50, (b, c)).astype(np.int32),
            "counter": rng.integers(-5, 5, b).astype(np.int32),
            "last_seq": rng.integers(0, 20, b).astype(np.int32),
            "overflow": rng.random(b) < 0.2}


KINDS = (0, 1, 1, 1, 2, 2, 3, 4, 4, 5)
SET_HEAVY = (0, 1, 1, 1, 1, 1, 1, 2, 4, 5)


def random_ops(rng, b, t, c, state, kinds=KINDS):
    """Kinds 0-5 (by default one CLEAR in ten); keys mostly from the table
    (hits), some absent; seq from -3 up (seq <= 0 on some); deltas of both
    signs."""
    present = state["key"][state["key"] >= 0]
    pool = np.concatenate([present, rng.integers(2 * c, 3 * c, 8)])
    return {"kind": rng.choice(kinds, (b, t)).astype(np.int32),
            "key": rng.choice(pool, (b, t)).astype(np.int32),
            "val": rng.integers(0, 1000, (b, t)).astype(np.int32),
            "delta": rng.integers(-9, 9, (b, t)).astype(np.int32),
            "seq": rng.integers(-3, 100, (b, t)).astype(np.int32)}


def jax_apply(state, ops):
    out = jlk.apply_lww_batched(
        jlk.LwwState(**{f: jnp.asarray(v) for f, v in state.items()}),
        jlk.LwwOps(**{f: jnp.asarray(v) for f, v in ops.items()}))
    return {f: np.asarray(v) for f, v in zip(jlk.LwwState._fields, out)}


def port_state(state):
    return lk.LwwState(*(torch.from_numpy(np.ascontiguousarray(state[f]))
                         for f in lk.LwwState._fields))


def port_ops(ops):
    return lk.LwwOps(*(torch.from_numpy(np.ascontiguousarray(ops[f]))
                       for f in lk.LwwOps._fields))


def assert_state(got: lk.LwwState, want: dict, what: str):
    for f in lk.LwwState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f"{what}: {f}")


def launch(state, ops):
    before = lk.apply_lww_batched.launches
    st, so = port_state(state), port_ops(ops)
    copies = [x.clone() for x in (*st, *so)]
    out, kinds, occ = lk._launch(st, so)
    assert kinds is None and occ is None
    assert lk.apply_lww_batched.launches == before + 1
    for x, x0 in zip((*st, *so), copies):
        assert torch.equal(x, x0), "the kernel wrote its input"
    return out


@pytest.mark.parametrize("b", [4, 5])
@pytest.mark.parametrize("c", [8, 64, 1024])
def test_emulated_scan_matches_jax(emulated, c, b):
    rng = np.random.default_rng(c * 10 + b)
    t = 40
    state = random_state(rng, b, c)
    ops = random_ops(rng, b, t, c, state,
                     SET_HEAVY if c == 8 else KINDS)
    want = jax_apply(state, ops)
    assert_state(launch(state, ops), want, f"C={c} B={b}")
    if c == 8:
        # Eight slots, no CLEAR and up to 24 distinct keys: some SET
        # found no slot.
        assert want["overflow"].sum() > state["overflow"].sum()


def test_emulated_scan_largest_bucket(emulated):
    """C = 16,384 (the lane store's last bucket), B = 1, T = 4: a SET of
    a key in the last strip, a SET of a new key (the first free slot, in
    the last strip too), a DELETE and a CLEAR."""
    c = 16384
    state = {"key": np.arange(c, dtype=np.int32)[None],
             "val": np.arange(c, dtype=np.int32)[None],
             "seq": np.ones((1, c), np.int32),
             "counter": np.zeros(1, np.int32),
             "last_seq": np.zeros(1, np.int32),
             "overflow": np.zeros(1, bool)}
    state["key"][0, c - 3] = -1
    for kinds in ([1, 1, 2, 4], [1, 2, 3, 1]):
        ops = {"kind": np.array([kinds], np.int32),
               "key": np.array([[c - 1, c + 7, 5, 9]], np.int32),
               "val": np.array([[70, 71, 72, 73]], np.int32),
               "delta": np.array([[0, 0, 0, -4]], np.int32),
               "seq": np.array([[10, 11, 12, 13]], np.int32)}
        want = jax_apply(state, ops)
        assert_state(launch(state, ops), want, f"C=16384 {kinds}")


def test_emulated_scan_full_table_and_edges(emulated):
    """A full table: SET of a new key overflows, SET of a present key and
    DELETE of an absent key do not; CLEAR then SET reuses slot 0; ops past
    the kinds and NOOPs leave last_seq alone."""
    c, b = 8, 2
    state = {"key": np.tile(np.arange(c, dtype=np.int32), (b, 1)),
             "val": np.tile(np.arange(c, dtype=np.int32), (b, 1)),
             "seq": np.zeros((b, c), np.int32),
             "counter": np.array([3, -3], np.int32),
             "last_seq": np.array([5, 5], np.int32),
             "overflow": np.zeros(b, bool)}
    ops = {"kind": np.array([[1, 1, 2, 0, 7, 4], [2, 3, 1, 1, 4, 0]],
                            np.int32),
           "key": np.array([[99, 3, 42, 1, 1, 0], [3, 0, 50, 51, 0, 0]],
                           np.int32),
           "val": np.array([[1, 2, 3, 4, 5, 6]] * 2, np.int32),
           "delta": np.array([[0, 0, 0, 0, 0, -7], [0, 0, 0, 0, -2, 0]],
                             np.int32),
           "seq": np.array([[0, -2, 4, 90, 91, 6], [1, 2, 3, -1, 8, 99]],
                           np.int32)}
    want = jax_apply(state, ops)
    assert want["overflow"].tolist() == [True, False]
    assert_state(launch(state, ops), want, "edges")


def jax_window(state, cols, plane):
    """The JAX serving window's LWW bucket on the same inputs
    (fluidframework_tpu/server/serve_step.py): the gather, the masks, the
    apply and the occupancy."""
    lc, seq_bt = jnp.asarray(cols), jnp.asarray(plane)
    seq_g = seq_bt[lc[4], lc[5]]
    ok = (lc[0] != jlk.LwwKind.NOOP) & (seq_g > 0)
    ops = jlk.LwwOps(kind=jnp.where(ok, lc[0], jlk.LwwKind.NOOP),
                     key=lc[1], val=lc[2], delta=lc[3],
                     seq=jnp.where(ok, seq_g, 0))
    out = jlk.apply_lww_batched(
        jlk.LwwState(**{f: jnp.asarray(v) for f, v in state.items()}), ops)
    return ({f: np.asarray(v) for f, v in zip(jlk.LwwState._fields, out)},
            np.asarray(ops.kind), np.asarray((out.key >= 0).sum(-1)))


@pytest.mark.parametrize("c", [8, 64])
def test_emulated_window_mode_matches_jax(emulated, c):
    """The admit mode on staged [6, B, T] columns and a [docs, T] ticket
    plane with unsequenced (0) and nacked (-1 free) entries, negative
    indices (JAX counts them from the end) and indices past the plane
    (JAX clamps them)."""
    rng = np.random.default_rng(c)
    b, t, docs, width = 5, 36, 7, 20
    state = random_state(rng, b, c)
    ops = random_ops(rng, b, t, c, state)
    cols = np.stack([ops["kind"], ops["key"], ops["val"], ops["delta"],
                     rng.integers(-docs, docs + 2, (b, t)),
                     rng.integers(-width, width + 3, (b, t))]
                    ).astype(np.int32)
    plane = rng.integers(-1, 60, (docs, width)).astype(np.int32)
    plane[rng.random((docs, width)) < 0.3] = 0
    want, want_kinds, want_occ = jax_window(state, cols, plane)
    before = lk.apply_lww_batched.launches
    out, kinds, occ = lk._launch(port_state(state), None,
                                 torch.from_numpy(cols),
                                 torch.from_numpy(plane))
    assert lk.apply_lww_batched.launches == before + 1
    assert_state(out, want, f"window C={c}")
    np.testing.assert_array_equal(kinds.numpy(), want_kinds)
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    # In range, the plain version is the same function.
    cols_in = cols.copy()
    cols_in[4] %= docs
    cols_in[5] %= width
    want, want_kinds, want_occ = jax_window(state, cols_in, plane)
    plain = lk.apply_lww_window_plain(port_state(state),
                                      torch.from_numpy(cols_in),
                                      torch.from_numpy(plane))
    assert_state(plain[0], want, "plain window")
    np.testing.assert_array_equal(plain[1].numpy(), want_kinds)
    np.testing.assert_array_equal(plain[2].numpy(), want_occ)


def test_emulated_kernel_refuses_what_it_does_not_take(emu_lib):
    """B or C below 1, T below 0 and an empty plane in the admit mode
    launch nothing."""
    buf = np.zeros(64, np.int32)
    p = buf.ctypes.data

    def call(b, c, t, rows, cols, plane):
        ptrs = [p] * 13 + [plane] + [p] * 8
        return emu_lib.fluid_lww_scan((ctypes.c_void_p * 22)(*ptrs), b, c,
                                      t, rows, cols, None)
    assert call(0, 4, 2, 0, 0, None) == INVALID_VALUE
    assert call(2, 0, 2, 0, 0, None) == INVALID_VALUE
    assert call(2, 4, -1, 0, 0, None) == INVALID_VALUE
    assert call(2, 4, 2, 0, 3, p) == INVALID_VALUE
    assert (buf == 0).all()
