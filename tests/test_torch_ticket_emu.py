"""The CUDA source of the deli ticket scan (fluidframework_tpu_torch/kernels/
csrc/ticket_scan.cu) run on the CPU against the JAX package's
_scan_tickets, bit for bit.

The source is compiled with the host's C++ compiler against
tests/simt/simt_emu.h, the SIMT emulator of tests/test_torch_fused_emu.py
(each CUDA thread a coroutine, warp votes, shuffles and reductions as
barriers, the threads between them in a shuffled order). The inputs are
tests/test_torch_ticket.py's raw_trace messages (joins, leaves,
duplicates, stale refs, SYSTEM messages, unknown clients, more clients
than slots) with and without a kind column and require_join on and off,
at K = 1, 3, 8, 32 and 40 (two table registers a lane), T across the
32-step load chunks, B of one and two blocks (a partly empty last block),
and a second window that continues the first one's state. Only the card
(chip_smoke.py) shows that nvcc builds the kernel and what it costs.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.server import ticket_kernel as jtk

from fluidframework_tpu_torch.server import ticket_kernel as tk

from test_torch_fused_apply import jax_to_np
from test_torch_ticket import jax_raw, raw_trace

SOURCE = Path(__file__).resolve().parents[1] / "fluidframework_tpu_torch" / \
    "kernels" / "csrc" / "ticket_scan.cu"
EMU_DIR = Path(__file__).resolve().parent / "simt"
INVALID_VALUE = 1  # cudaErrorInvalidValue
JUNK = 0xAA  # every output byte starts as this: each must be written


def ticket_emu_source(text: str) -> str:
    """ticket_scan.cu with the CUDA runtime swapped for the emulator."""
    text = text.replace("#include <cuda_runtime.h>", '#include "simt_emu.h"')
    text, n = re.subn(r"([\w<>]+)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>"
                      r"\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \6);", text)
    assert n == 1, n
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    work = tmp_path_factory.mktemp("ticket_emu")
    src = work / "ticket_scan_emu.cpp"
    src.write_text(ticket_emu_source(SOURCE.read_text()))
    lib = work / "libticket_scan_emu.so"
    done = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         f"-I{EMU_DIR}", str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.fluid_ticket_scan.argtypes = [ctypes.POINTER(vp), i32, i32, i32, i32,
                                      vp]
    dll.fluid_ticket_scan.restype = i32
    return dll


def emu_scan(lib, state: dict, raw: dict, require_join: bool):
    """One emulated launch with the wrapper's pointer layout: (rc, new
    state, outputs) as numpy, the bools as their bytes."""
    b, k = state["client_ids"].shape
    t = raw["client"].shape[1]
    ins = [np.ascontiguousarray(state[f]) for f in tk.TicketState._fields]
    cols = [np.ascontiguousarray(raw[f])
            for f in ("client", "client_seq", "ref_seq")]
    kind = raw.get("kind")
    cols.append(None if kind is None else np.ascontiguousarray(kind))
    before = [x.copy() for x in ins + cols if x is not None]
    new = {f: np.full(x.shape, JUNK, np.uint8 if x.dtype == np.bool_
                      else np.int32)
           for f, x in zip(tk.TicketState._fields, ins)}
    out = {f: np.full((b, t), JUNK, np.int32 if f in ("seq", "min_seq")
                      else np.uint8) for f in tk.Ticketed._fields}
    ptrs = [x.ctypes.data for x in ins]
    ptrs += [None if x is None else x.ctypes.data for x in cols]
    ptrs += [x.ctypes.data for x in new.values()]
    ptrs += [x.ctypes.data for x in out.values()]
    rc = lib.fluid_ticket_scan((ctypes.c_void_p * len(ptrs))(*ptrs), b, t,
                               k, int(require_join), None)
    for x, x0 in zip([x for x in ins + cols if x is not None], before):
        np.testing.assert_array_equal(x, x0, "the kernel wrote its input")
    return rc, new, out


def jax_scan(state: dict, raw: dict, require_join: bool):
    jstate = jtk.TicketState(**{f: jnp.asarray(v) for f, v in state.items()})
    jst, jout = jtk._scan_tickets(jstate, jax_raw(raw), batched=True,
                                  require_join=require_join)
    return jax_to_np(jst), jax_to_np(jout)


def assert_same(got: dict, want: dict, what: str):
    for name, w in want.items():
        g = got[name]
        if w.dtype == np.bool_:
            w = w.astype(np.uint8)  # unwritten bytes stay JUNK
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def fresh_state(k: int, b: int) -> dict:
    return jax_to_np(jtk.make_ticket_state(k, batch=b))


def rows(d: dict, n: int) -> dict:
    return {f: v[:n] for f, v in d.items()}


MODES = [(False, False), (False, True), (True, False), (True, True)]


# Each K under every contract (kind column, require_join): seven
# documents (a partly empty block), T = 33 (two load chunks), then a
# second window of 33 messages from the first one's state.
@pytest.mark.parametrize("with_kind,require_join", MODES)
@pytest.mark.parametrize("k", [1, 3, 8, 32, 40])
def test_emulated_kernel_matches_jax(emu_lib, k, with_kind, require_join):
    b, t = 7, 33
    state = fresh_state(k, b)
    for window in range(2):
        raw = raw_trace(100 * k + 10 * window + 2 * with_kind + require_join,
                        b, t, n_clients=k + 3, with_kind=with_kind)
        want_state, want_out = jax_scan(state, raw, require_join)
        rc, got_state, got_out = emu_scan(emu_lib, state, raw, require_join)
        assert rc == 0
        what = f"K={k} kind={with_kind} require_join={require_join} " \
            f"window {window}"
        assert_same(got_state, want_state, what)
        assert_same(got_out, want_out, what)
        state = want_state
    if require_join:
        assert want_out["not_joined"].any()
    else:
        assert (want_out["seq"] > 0).any()


# The T edges (one step, one chunk less one, one chunk, one chunk and
# one, several chunks) and B of one document and of two blocks, against
# the same JAX run (documents are independent, so the first rows of a
# batch are a smaller batch).
@pytest.mark.parametrize("t", [1, 31, 32, 100, 256])
def test_emulated_kernel_step_and_batch_edges(emu_lib, t):
    k, b = 8, 16
    raw = raw_trace(500 + t, b, t, n_clients=k + 2, with_kind=True)
    state = fresh_state(k, b)
    want_state, want_out = jax_scan(state, raw, True)
    for n in (1, b):
        rc, got_state, got_out = emu_scan(emu_lib, rows(state, n),
                                          rows(raw, n), True)
        assert rc == 0
        assert_same(got_state, rows(want_state, n), f"T={t} B={n}")
        assert_same(got_out, rows(want_out, n), f"T={t} B={n}")


def test_emulated_kernel_fills_the_second_register(emu_lib):
    """K = 40 without a kind column: auto-joins fill slots 32-39 (the
    second register of each lane), and the clients past them nack."""
    k, b, t = 40, 3, 256
    raw = raw_trace(77, b, t, n_clients=k + 3, with_kind=False)
    state = fresh_state(k, b)
    want_state, want_out = jax_scan(state, raw, False)
    assert (want_state["client_ids"][:, 32:] >= 0).all()
    assert want_out["not_joined"].any()
    rc, got_state, got_out = emu_scan(emu_lib, state, raw, False)
    assert rc == 0
    assert_same(got_state, want_state, "K=40")
    assert_same(got_out, want_out, "K=40")


def test_emulated_kernel_full_table_overflows(emu_lib):
    """Six distinct joiners into a four-slot table: the joins past the
    fourth still take a seq and set overflow."""
    b, t = 3, 12
    raw = {"client": np.tile(np.arange(12, dtype=np.int32) % 6, (b, 1)),
           "client_seq": np.tile(np.arange(1, t + 1, dtype=np.int32),
                                 (b, 1)),
           "ref_seq": np.zeros((b, t), np.int32),
           "kind": np.full((b, t), 2, np.int32)}
    state = fresh_state(4, b)
    want_state, want_out = jax_scan(state, raw, True)
    assert want_state["overflow"].all()
    rc, got_state, got_out = emu_scan(emu_lib, state, raw, True)
    assert rc == 0
    assert_same(got_state, want_state, "overflow")
    assert_same(got_out, want_out, "overflow")


def test_emulated_kernel_refuses_what_it_does_not_take(emu_lib):
    """K outside 1..128, and B or T below 1, launch nothing."""
    raw = raw_trace(3, 2, 4, n_clients=4, with_kind=False)
    for k in (0, tk.MAX_KERNEL_SLOTS + 1):
        rc, _new, out = emu_scan(emu_lib, fresh_state(k, 2), raw, False)
        assert rc == INVALID_VALUE, k
        assert (out["seq"] == JUNK).all(), k
    rc, _new, _out = emu_scan(emu_lib, fresh_state(4, 0), rows(raw, 0),
                              False)
    assert rc == INVALID_VALUE
    rc, _new, _out = emu_scan(emu_lib, fresh_state(4, 2),
                              {f: v[:, :0] for f, v in raw.items()}, False)
    assert rc == INVALID_VALUE
