"""The port's merge-tree kernel (fluidframework_tpu_torch/mergetree/
kernel.py) against the JAX package's mergetree/kernel.py on the CPU, bit
for bit: the scan apply (apply_ops, apply_ops_keep with runs=,
apply_ops_batched, apply_ops_batched_keep) on one document and on a batch,
on both sides of the fused apply's 4,141-slot limit, compaction
(compact, compact_batched), apply_if_any, visible_mask and doc_length.

Inputs: fuzz_tables under gen_fuzz_traces (every op kind, pending ops and
acks, stale padding, near-full tables that trip the capacity gate, the
annotate ring and the overlap slots), and hand-built streams for the
annotate-ring overflow. On the CPU the port runs its plain PyTorch scan;
the same function is held against the fused apply's plain version where
both apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel as jk
from fluidframework_tpu.mergetree.oppack import PackedOps as JaxPackedOps
from fluidframework_tpu.mergetree.oppack import RunCols as JaxRunCols
from fluidframework_tpu.mergetree.state import DocState as JaxDocState
from fluidframework_tpu.mergetree.state import make_state as jax_make_state
from fluidframework_tpu.mergetree.state import \
    state_from_numpy as jax_state_from_numpy

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import kernel
from fluidframework_tpu_torch.mergetree import pallas_apply as tpa
from fluidframework_tpu_torch.mergetree.oppack import (HostOp, OpKind,
                                                       pack_single)
from fluidframework_tpu_torch.mergetree.state import (
    DocState, batched_state_from_numpy, make_state, state_from_numpy)
from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                     gen_fuzz_traces)

from test_torch_fused_apply import jax_to_np


def jax_tuple(cls, arrays):
    return cls(**{f: jnp.asarray(arrays[f]) for f in cls._fields})


def assert_equal_np(got: dict, want: dict, what=""):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, f"{what} {name}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def doc_of(arrays: dict, d: int) -> dict:
    return {f: np.asarray(v)[d] for f, v in arrays.items()}


def fuzz_case(batch, capacity, k, a, steps, seed):
    """(tables, plain op columns, (run op columns, run columns)), numpy."""
    tables = fuzz_tables(batch, capacity, k, a, seed=seed)
    length = tables["count"] * 2
    cols = gen_fuzz_traces(batch, steps, seed=seed, length=length)
    rcols, rruns = gen_fuzz_traces(batch, steps, seed=seed + 100, runs=True,
                                   length=length)
    return tables, cols, (rcols, rruns)


# (B, C, K, A, T, seed): small tables with a deep ring, K=1 / A=1
# extremes, and capacities above the fused apply's limit (4,141 at K=3,
# A=1) where only the scan runs.
CASES = [
    (4, 64, 3, 4, 24, 0),
    (4, 40, 1, 1, 24, 1),
    (2, 4160, 3, 1, 12, 2),
]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "B{}-C{}-K{}-A{}-T{}".format(*c[:5]))
def case(request):
    return fuzz_case(*request.param)


class TestScanApply:
    def test_batched_matches_jax(self, case):
        tables, cols, (rcols, rruns) = case
        state = interop.doc_state_from_numpy(tables, "cpu")
        want = jax_to_np(jk.apply_ops_batched_keep(
            jax_tuple(JaxDocState, tables), jax_tuple(JaxPackedOps, cols)))
        for fn in (kernel.apply_ops_batched, kernel.apply_ops_batched_keep):
            got = fn(state, interop.packed_ops_from_numpy(cols, "cpu"))
            assert_equal_np(interop.to_numpy(got), want, fn.__name__)
        assert want["overflow"].any()  # the capacity gate and rings trip
        want_runs = jax_to_np(jk._scan_ops(
            jax_tuple(JaxDocState, tables), jax_tuple(JaxPackedOps, rcols),
            batched=True, runs=jax_tuple(JaxRunCols, rruns)))
        got = kernel.apply_ops_batched_keep(
            state, interop.packed_ops_from_numpy(rcols, "cpu"),
            runs=interop.run_cols_from_numpy(rruns, "cpu"))
        assert_equal_np(interop.to_numpy(got), want_runs, "runs")
        # the input survives
        assert_equal_np(interop.to_numpy(state), tables, "input")

    def test_single_document_matches_jax(self, case):
        tables, cols, (rcols, rruns) = case
        for d in (1, len(tables["count"]) - 1):  # near-full; stale padding
            st_np = doc_of(tables, d)
            want = jax_to_np(jk.apply_ops(jax_tuple(JaxDocState, st_np),
                                          jax_tuple(JaxPackedOps,
                                                    doc_of(cols, d))))
            got = kernel.apply_ops(
                interop.doc_state_from_numpy(st_np, "cpu"),
                interop.packed_ops_from_numpy(doc_of(cols, d), "cpu"))
            assert_equal_np(interop.to_numpy(got), want, f"doc {d}")
            want = jax_to_np(jk.apply_ops_keep(
                jax_tuple(JaxDocState, st_np),
                jax_tuple(JaxPackedOps, doc_of(rcols, d)),
                jax_tuple(JaxRunCols, doc_of(rruns, d))))
            got = kernel.apply_ops_keep(
                interop.doc_state_from_numpy(st_np, "cpu"),
                interop.packed_ops_from_numpy(doc_of(rcols, d), "cpu"),
                interop.run_cols_from_numpy(doc_of(rruns, d), "cpu"))
            assert_equal_np(interop.to_numpy(got), want, f"doc {d} runs")
            assert got.length.shape == (st_np["length"].shape[0],)

    @pytest.mark.parametrize("params", [c for c in CASES
                                        if c[1] <= tpa.max_fused_capacity(
                                            c[2], c[3])])
    def test_scan_equals_fused_plain(self, params):
        """Where both apply, kernel.py's formulation and the fused apply's
        compute the same function (as the JAX package holds its fused and
        scan versions)."""
        tables, cols, (rcols, rruns) = fuzz_case(*params)
        state = interop.doc_state_from_numpy(tables, "cpu")
        for ops_np, runs_np in ((cols, None), (rcols, rruns)):
            ops = interop.packed_ops_from_numpy(ops_np, "cpu")
            runs = None if runs_np is None else \
                interop.run_cols_from_numpy(runs_np, "cpu")
            assert_equal_np(
                interop.to_numpy(kernel.scan_ops_plain(state, ops, True,
                                                       runs)),
                interop.to_numpy(tpa.apply_ops_fused_plain(state, ops,
                                                           runs)))


def test_annotate_ring_overflow_matches_jax():
    """A=2: the third annotate over one segment finds its ring full and
    flags overflow; the ring keeps the newest ids."""
    stream = [HostOp(OpKind.INSERT, 1, 0, 1, pos1=0, op_id=0, new_len=8)]
    for i in range(3):
        stream.append(HostOp(OpKind.ANNOTATE, 2 + i, 1 + i, 1, pos1=2,
                             pos2=6, op_id=10 + i, msn=i))
    cols = pack_single(stream, steps=6)
    st = jax_to_np(jax_make_state(16, 2))
    want = jax_to_np(jk.apply_ops_keep(jax_tuple(JaxDocState, st),
                                       jax_tuple(JaxPackedOps, cols)))
    got = interop.to_numpy(kernel.apply_ops_keep(
        make_state(16, 2, device="cpu"),
        interop.packed_ops_from_numpy(cols, "cpu")))
    assert_equal_np(got, want)
    assert bool(got["overflow"]) and (got["anno"][:got["count"]] ==
                                      12).any()


class TestCompaction:
    def test_compact_matches_jax(self, case):
        tables, cols, _runs = case
        applied = jax_to_np(jk.apply_ops_batched_keep(
            jax_tuple(JaxDocState, tables), jax_tuple(JaxPackedOps, cols)))
        applied["min_seq"] = np.full_like(applied["min_seq"], 5)
        want = jax_to_np(jk.compact_batched(jax_tuple(JaxDocState,
                                                      applied)))
        got = kernel.compact_batched(
            interop.doc_state_from_numpy(applied, "cpu"))
        assert_equal_np(interop.to_numpy(got), want, "batched")
        assert (want["count"] < applied["count"]).any()  # rows freed
        for d in range(len(applied["count"])):
            want1 = jax_to_np(jk.compact(jax_tuple(JaxDocState,
                                                   doc_of(applied, d))))
            got1 = kernel.compact(
                interop.doc_state_from_numpy(doc_of(applied, d), "cpu"))
            assert_equal_np(interop.to_numpy(got1), want1, f"doc {d}")


class TestQueries:
    def test_visible_mask_and_doc_length_match_jax(self, case):
        tables, cols, _runs = case
        applied = jax_to_np(jk.apply_ops_batched_keep(
            jax_tuple(JaxDocState, tables), jax_tuple(JaxPackedOps, cols)))
        batch = interop.doc_state_from_numpy(applied, "cpu")
        b = len(applied["count"])
        for ref, client in ((3, 0), (8, 1), (2**31 - 1, 2), (0, -2)):
            masks, lengths = [], []
            for d in range(b):
                one = jax_tuple(JaxDocState, doc_of(applied, d))
                masks.append(np.asarray(jk.visible_mask(one, ref, client)))
                lengths.append(np.asarray(jk.doc_length(one, ref, client)))
                single = interop.doc_state_from_numpy(doc_of(applied, d),
                                                      "cpu")
                np.testing.assert_array_equal(
                    kernel.visible_mask(single, ref, client).numpy(),
                    masks[-1])
                got_len = kernel.doc_length(single, ref, client)
                assert got_len.dtype == torch.int32 and got_len.dim() == 0
                assert int(got_len) == int(lengths[-1])
            np.testing.assert_array_equal(
                kernel.visible_mask(batch, ref, client).numpy(),
                np.stack(masks))
            np.testing.assert_array_equal(
                kernel.doc_length(batch, torch.full((b,), ref),
                                  torch.full((b,), client)).numpy(),
                np.stack(lengths))


def test_apply_if_any_matches_jax():
    tables, cols, _runs = fuzz_case(3, 48, 3, 4, 10, 5)
    ops_j = jax_tuple(JaxPackedOps, cols)
    ops_t = interop.packed_ops_from_numpy(cols, "cpu")
    state = interop.doc_state_from_numpy(tables, "cpu")
    for active in (True, False):
        want = jax_to_np(jax.jit(lambda s, on: jk.apply_if_any(
            lambda x: jk._scan_ops(x, ops_j, batched=True), s, on))(
                jax_tuple(JaxDocState, tables), jnp.asarray(active)))
        got = kernel.apply_if_any(
            lambda x: kernel.apply_ops_batched_keep(x, ops_t), state,
            torch.tensor(active))
        assert_equal_np(interop.to_numpy(got), want, f"active={active}")


def test_state_from_numpy_matches_jax():
    """Single-document and batched seeding from host columns: the rows
    given, make_state's padding after them, overlap removers and a
    pending-annotate ring."""
    rng = np.random.default_rng(3)
    docs = []
    for n in (0, 5, 9):
        cols = {f: rng.integers(0, 50, n).astype(np.int32)
                for f in ("length", "ins_seq", "ins_client", "rem_seq",
                          "local_seq", "rem_local_seq", "origin_op",
                          "origin_off")}
        cols["rem_client"] = rng.integers(-1, 4, n).astype(np.int32)
        if n:
            cols["rem_overlap"] = rng.integers(-1, 4, (n, 2)).astype(
                np.int32)
            cols["anno"] = rng.integers(-1, 9, (n, 8)).astype(np.int32)
        docs.append(cols)
    wants = [jax_to_np(jax_state_from_numpy(c, 12, anno_slots=8))
             for c in docs]
    for cols, want in zip(docs, wants):
        assert_equal_np(interop.to_numpy(
            state_from_numpy(cols, 12, anno_slots=8, device="cpu")), want)
    got = interop.to_numpy(batched_state_from_numpy(docs, 12, anno_slots=8,
                                                    device="cpu"))
    assert_equal_np(got, {f: np.stack([w[f] for w in wants])
                          for f in DocState._fields})
    with pytest.raises(ValueError, match="exceed capacity"):
        state_from_numpy(docs[2], 8, device="cpu")
