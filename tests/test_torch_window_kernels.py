"""Where the serving window's three new kernel wrappers send a call.

lww_kernel.apply_lww_batched / apply_lww_window (kernels/csrc/
lww_scan.cu), serve_step.admit_merge_ops (window_admit.cu) and
serve_step._pack_window (window_pack.cu):

- a CPU tensor runs the plain version (and launches nothing);
- a CUDA tensor launches the kernel (the launch count rises by one; the
  card test is marked `card` and skips without one: the emulator tests,
  tests/test_torch_lww_emu.py and tests/test_torch_window_emu.py, drive
  the same launches on the CPU);
- a tensor on any other device, or a shape the kernel does not take,
  raises ValueError before anything is built or launched (meta tensors
  stand in for the other device here).
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.kernels import build
from fluidframework_tpu_torch.server import lww_kernel as lk
from fluidframework_tpu_torch.server import serve_step as tss
from fluidframework_tpu_torch.server import ticket_kernel as tk
from fluidframework_tpu_torch.testing.serving import SMALL_RING, ServingFleet


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything reaches the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "library", refuse)


def lww_inputs(device, b=3, c=8, t=5, seed=0):
    rng = np.random.default_rng(seed)
    state = lk.make_lww_state(c, b, device="cpu")
    ops = lk.LwwOps(*(torch.from_numpy(rng.integers(0, 5, (b, t))
                                       .astype(np.int32))
                      for _ in lk.LwwOps._fields))
    cols = torch.from_numpy(rng.integers(0, 5, (6, b, t)).astype(np.int32))
    plane = torch.from_numpy(rng.integers(-1, 9, (5, 5)).astype(np.int32))
    return (lk.LwwState(*(x.to(device) for x in state)),
            lk.LwwOps(*(x.to(device) for x in ops)), cols.to(device),
            plane.to(device))


def window_inputs(device):
    """One SMALL_RING window's admission and pack inputs on `device`."""
    rng = np.random.default_rng(3)
    lanes, tm, docs, steps = 4, 6, 5, 7
    mc = rng.integers(0, 5, (12, lanes, tm)).astype(np.int32)
    mc[10] %= docs
    mc[11] %= steps
    seq = rng.integers(-1, 20, (docs, steps)).astype(np.int32)
    msn = rng.integers(0, 9, (docs, steps)).astype(np.int32)
    tstate = tk.make_ticket_state(4, docs, device="cpu")
    ticketed = tk.Ticketed(torch.from_numpy(seq), torch.from_numpy(msn),
                           torch.from_numpy(seq < 0),
                           torch.from_numpy(seq == -1),
                           torch.zeros((docs, steps), dtype=torch.bool))
    over = torch.from_numpy(rng.random(lanes) < 0.5)
    count = torch.from_numpy(rng.integers(0, 9, lanes).astype(np.int32))
    kinds = torch.from_numpy(mc[0].copy())
    sums = [(over, count, kinds)]
    move = (lambda x: x.to(device))
    return (tuple(map(move, (torch.from_numpy(seq), torch.from_numpy(msn),
                             torch.from_numpy(mc)))),
            tk.TicketState(*map(move, tstate)),
            tk.Ticketed(*map(move, ticketed)),
            [tuple(map(move, x)) for x in sums])


def test_cpu_tensors_run_the_plain_versions(no_build):
    state, ops, cols, plane = lww_inputs("cpu")
    before = lk.apply_lww_batched.launches
    got = lk.apply_lww_batched(state, ops)
    want = lk.apply_lww_batched_plain(state, ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cols[4] %= 5
    got = lk.apply_lww_window(state, cols, plane)
    want = lk.apply_lww_window_plain(state, cols, plane)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[2].dtype == torch.int32
    assert lk.apply_lww_batched.launches == before

    (seq, msn, mc), tstate, ticketed, sums = window_inputs("cpu")
    before = tss.admit_merge_ops.launches, tss._pack_window.launches
    got = tss.admit_merge_ops(seq, msn, mc, None)
    want = tss.admit_merge_ops_plain(seq, msn, mc, None)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    flat = tss._pack_window(tstate, ticketed, sums, [None], [], True, True,
                            False)
    assert torch.equal(flat, tss._pack_window_plain(
        tstate, ticketed, sums, [None], [], True, True, False))
    assert (tss.admit_merge_ops.launches, tss._pack_window.launches) == \
        before


def test_other_devices_raise(no_build):
    state, ops, cols, plane = lww_inputs("meta")
    with pytest.raises(ValueError, match="not the CUDA device"):
        lk.apply_lww_batched(state, ops)
    with pytest.raises(ValueError, match="not the CUDA device"):
        lk.apply_lww_window(state, cols, plane)
    (seq, msn, mc), tstate, ticketed, sums = window_inputs("meta")
    with pytest.raises(ValueError, match="not the CUDA device"):
        tss.admit_merge_ops(seq, msn, mc, None)
    with pytest.raises(ValueError, match="not the CUDA device"):
        tss._pack_window(tstate, ticketed, sums, [None], [], False, True,
                         False)


def test_shapes_the_kernels_do_not_take_raise(no_build):
    state, ops, cols, plane = lww_inputs("meta")
    empty = lk.LwwState(*(x[:0] for x in state))
    with pytest.raises(ValueError, match="B >= 1"):
        lk.apply_lww_batched(empty, lk.LwwOps(*(x[:0] for x in ops)))
    with pytest.raises(ValueError, match="int32"):
        lk.apply_lww_batched(state, ops._replace(
            kind=ops.kind.to(torch.int64)))
    with pytest.raises(ValueError, match="ticket plane"):
        lk.apply_lww_window(state, cols, plane[:0])
    (seq, msn, mc), tstate, ticketed, sums = window_inputs("meta")
    with pytest.raises(ValueError, match="shape"):
        tss.admit_merge_ops(seq, msn, mc[:11], None)
    with pytest.raises(ValueError, match="at most"):
        tss._pack_window(tstate, ticketed, sums * 33, [None] * 33, [],
                         False, True, False)
    with pytest.raises(ValueError, match="count"):
        over, count, kinds = sums[0]
        tss._pack_window(tstate, ticketed,
                         [(over, count.to(torch.int64), kinds)], [None], [],
                         False, True, False)


@pytest.mark.card
def test_cuda_tensors_launch_the_kernels():
    """On the card: each wrapper launches its kernel once and equals its
    plain version (chip_smoke.py runs the same checks at the main path's
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state, ops, cols, plane = lww_inputs("cuda")
    cols[4] %= 5
    before = lk.apply_lww_batched.launches
    got = lk.apply_lww_batched(state, ops)
    want = lk.apply_lww_batched_plain(state, ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = lk.apply_lww_window(state, cols, plane)
    want = lk.apply_lww_window_plain(state, cols, plane)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    assert lk.apply_lww_batched.launches == before + 2
    (seq, msn, mc), tstate, ticketed, sums = window_inputs("cuda")
    before = tss.admit_merge_ops.launches, tss._pack_window.launches
    got = tss.admit_merge_ops(seq, msn, mc, None)
    want = tss.admit_merge_ops_plain(seq, msn, mc, None)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    flat = tss._pack_window(tstate, ticketed, sums, [None], [], True, True,
                            False)
    assert torch.equal(flat, tss._pack_window_plain(
        tstate, ticketed, sums, [None], [], True, True, False))
    assert (tss.admit_merge_ops.launches, tss._pack_window.launches) == \
        (before[0] + 1, before[1] + 1)


def test_the_ring_window_takes_the_kernels_count_on_the_cpu(no_build):
    """A SMALL_RING ring on CPU tensors launches none of the three."""
    from test_torch_serving import Fleet, port_megakernel
    f = Fleet(1)
    ring = f.stage()
    counts = (lk.apply_lww_batched.launches, tss.admit_merge_ops.launches,
              tss._pack_window.launches)
    port_megakernel(f.tstate, f.pool, f.lww, ring.args, stats=True)
    assert (lk.apply_lww_batched.launches, tss.admit_merge_ops.launches,
            tss._pack_window.launches) == counts
    assert ServingFleet(SMALL_RING, seed=1).lww_lanes > 0
