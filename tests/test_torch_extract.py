"""The port's summary extraction and narrow device-to-host wire
(fluidframework_tpu_torch/mergetree/kernel.py extract_visible_batched,
compact_extract_batched, compact_extract_paged(_keep), gather_rows_pow2,
fetch_extracted) against the JAX package's on the CPU, bit for bit.

The classes mirror tests/test_narrow_wire.py's kernel-level ones; every
case also feeds the same numpy state to the JAX function and compares the
outputs (packed arrays, compacted state, the stats plane) and the counter
deltas (summarize.bytes_d2h, summarize.wire_refetch). A fuzzed grid over
fuzz_tables x gen_fuzz_traces and a paged pool cover the rest.
Tolerance: exact equality (every field is int32, int16 or bool).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel as jkernel
from fluidframework_tpu.telemetry import counters as jcounters

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.constants import (DEV_NO_REMOVE,
                                                          DEV_UNASSIGNED)
from fluidframework_tpu_torch.mergetree.state import (DocState, make_state,
                                                      state_from_numpy)
from fluidframework_tpu_torch.telemetry import counters as tcounters
from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                     gen_fuzz_traces,
                                                     gen_traces)

from test_torch_paged_ops import (assert_tree_equal, jax_state, paged_case,
                                  port_state, to_np)

WIRE_COUNTERS = ("summarize.bytes_d2h", "summarize.wire_refetch")
_STATES = {}


def traced_state(docs=32, n_ops=16, capacity=64, seed=11, anno_slots=2):
    """A batch driven by gen_traces (insert / remove mix) through the
    port's plain scan, with min_seq raised so zamboni has rows to free:
    a numpy dict in DocState field order (cached per argument tuple)."""
    key = (docs, n_ops, capacity, seed, anno_slots)
    if key not in _STATES:
        ops = interop.packed_ops_from_numpy(gen_traces(docs, n_ops, seed=seed),
                                            "cpu")
        st = tkernel.apply_ops_batched_keep(
            make_state(capacity, anno_slots, batch=docs, device="cpu"), ops)
        rng = np.random.default_rng(seed)
        st = st._replace(min_seq=torch.from_numpy(
            rng.integers(0, n_ops, docs).astype(np.int32)))
        _STATES[key] = interop.to_numpy(st)
    return _STATES[key]


def both(fn_name, arrays, *args, **kwargs):
    """(port output, JAX output) of kernel.<fn_name> on the same state, as
    numpy trees."""
    got = getattr(tkernel, fn_name)(port_state(arrays), *args, **kwargs)
    want = getattr(jkernel, fn_name)(jax_state(arrays), *args, **kwargs)
    return to_np(got), to_np(want)


def fetch_both(t_packed, j_packed, narrow):
    """Port and JAX fetch_extracted of the same packed rows, with each
    one's counter deltas."""
    t0 = {c: tcounters.get(c) for c in WIRE_COUNTERS}
    got = tkernel.fetch_extracted(t_packed, narrow=narrow)
    t_delta = {c: tcounters.get(c) - t0[c] for c in WIRE_COUNTERS}
    j0 = {c: jcounters.get(c) for c in WIRE_COUNTERS}
    want = jkernel.fetch_extracted(j_packed, narrow=narrow)
    j_delta = {c: jcounters.get(c) - j0[c] for c in WIRE_COUNTERS}
    assert t_delta == j_delta, (t_delta, j_delta)
    assert_tree_equal(got, want, f"fetch narrow={narrow}")
    return got, t_delta


def packed_pair(arrays, fn_name="compact_extract_batched"):
    """The packed rows of the same state from the port and from JAX."""
    t_out = getattr(tkernel, fn_name)(port_state(arrays))
    j_out = getattr(jkernel, fn_name)(jax_state(arrays))
    if fn_name == "compact_extract_batched":
        t_out, j_out = t_out[1], j_out[1]
    return t_out, j_out


def rows_equal(a_packed, b_packed):
    """Per-document live-row equality of two fetched extraction tuples."""
    counts = np.asarray(a_packed[-1])
    assert np.array_equal(counts, np.asarray(b_packed[-1]))
    for i, (a, b) in enumerate(zip(a_packed[:-1], b_packed[:-1])):
        for d in range(len(counts)):
            n = counts[d]
            assert np.array_equal(a[d, :n], b[d, :n]), (i, d)


class TestFusedCompactExtract:
    def test_compact_state_bit_identical(self):
        arrays = traced_state()
        got, want = both("compact_extract_batched", arrays, stats=True)
        assert_tree_equal(got, want, "compact_extract_batched(stats=True)")
        plain = to_np(tkernel.compact_batched(port_state(arrays)))
        assert_tree_equal(got[0], plain, "fused vs compact_batched")
        assert got[0][DocState._fields.index("count")].sum() < \
            got[2].sum()   # zamboni freed rows: the stats plane shows them
        np.testing.assert_array_equal(got[2], arrays["count"])

    def test_extract_equals_uncompacted_extract(self):
        """Extracting after zamboni gives the same live rows as extracting
        the uncompacted state (extraction's keep-mask is compaction's)."""
        arrays = traced_state(seed=11)
        got, want = both("extract_visible_batched", arrays)
        assert_tree_equal(got, want, "extract_visible_batched")
        fused_t, fused_j = packed_pair(arrays)
        plain_t, plain_j = packed_pair(arrays, "extract_visible_batched")
        rows_equal(fetch_both(plain_t, plain_j, False)[0],
                   fetch_both(fused_t, fused_j, False)[0])

    def test_extract_after_explicit_compact_matches(self):
        arrays = traced_state(seed=11)
        compacted = interop.to_numpy(
            tkernel.compact_batched(port_state(arrays)))
        a_t, a_j = packed_pair(arrays, "extract_visible_batched")
        b_t, b_j = packed_pair(compacted, "extract_visible_batched")
        rows_equal(fetch_both(a_t, a_j, False)[0],
                   fetch_both(b_t, b_j, False)[0])


def wide_span_arrays():
    """Document 0's seq span exceeds int16 (forces the exact-plane
    refetch) and holds pending, removed-pending and never-removed rows;
    document 1 stays narrow; document 2 is empty. A numpy dict."""
    cols = {
        "length": np.array([3, 4, 5, 2], np.int32),
        "ins_seq": np.array([1, 100000, 5, DEV_UNASSIGNED], np.int32),
        "ins_client": np.array([0, 1, 2, 3], np.int32),
        "rem_seq": np.array(
            [DEV_NO_REMOVE, 99999, DEV_UNASSIGNED, DEV_NO_REMOVE],
            np.int32),
        "origin_op": np.array([7, 8, 9, 10], np.int32),
        "origin_off": np.array([0, 1, 2, 3], np.int32),
        "rem_client": np.array([-1, 4, 5, -1], np.int32),
    }
    row = interop.to_numpy(state_from_numpy(cols, 16, anno_slots=2,
                                            device="cpu"))
    row["seq"] = np.int32(100000)
    row2 = interop.to_numpy(state_from_numpy(
        {"length": np.array([2], np.int32),
         "ins_seq": np.array([3], np.int32),
         "ins_client": np.array([0], np.int32),
         "origin_op": np.array([1], np.int32)}, 16, anno_slots=2,
        device="cpu"))
    empty = interop.to_numpy(make_state(16, 2, device="cpu"))
    return {f: np.stack([row[f], row2[f], empty[f]])
            for f in DocState._fields}


class TestNarrowWire:
    def test_narrow_decode_bit_identical(self):
        t_packed, j_packed = packed_pair(traced_state(seed=11))
        narrow, d = fetch_both(t_packed, j_packed, True)
        wide, _ = fetch_both(t_packed, j_packed, False)
        rows_equal(narrow, wide)
        assert d["summarize.wire_refetch"] == 0

    def test_byte_drop_at_least_40pct(self):
        t_packed, j_packed = packed_pair(traced_state(seed=11))
        _, narrow = fetch_both(t_packed, j_packed, True)
        _, wide = fetch_both(t_packed, j_packed, False)
        n_bytes = narrow["summarize.bytes_d2h"]
        w_bytes = wide["summarize.bytes_d2h"]
        assert n_bytes > 0 and w_bytes > 0
        assert n_bytes <= 0.6 * w_bytes, (n_bytes, w_bytes)

    def test_overflow_doc_refetches_exact_planes(self):
        t_packed, j_packed = packed_pair(wide_span_arrays(),
                                         "extract_visible_batched")
        before = to_np(t_packed)
        narrow, d = fetch_both(t_packed, j_packed, True)
        assert d["summarize.wire_refetch"] == 1
        rows_equal(narrow, fetch_both(t_packed, j_packed, False)[0])
        # The refetch patches host copies, never the caller's tensors.
        assert_tree_equal(to_np(t_packed), before, "packed after refetch")
        narrow[0][0, 0] = -7
        assert int(t_packed[0][0, 0]) == before[0][0, 0]

    def test_pending_and_sentinel_rows_round_trip(self):
        """DEV_UNASSIGNED / DEV_NO_REMOVE survive the narrow encode exactly
        (they are codes, not deltas); the empty document decodes to
        nothing."""
        t_packed, j_packed = packed_pair(wide_span_arrays(),
                                         "extract_visible_batched")
        narrow, _ = fetch_both(t_packed, j_packed, True)
        (op32, off, length, anno, ins_seq, ins_client, rem_seq,
         rem_client, counts) = narrow
        assert counts.tolist() == [4, 1, 0]
        assert ins_seq[0, 3] == DEV_UNASSIGNED
        assert rem_seq[0, 0] == DEV_NO_REMOVE
        assert rem_seq[0, 2] == DEV_UNASSIGNED
        assert rem_seq[1, 0] == DEV_NO_REMOVE and rem_client[1, 0] == -1
        assert op32.shape == (3, 16)   # 4 live rows bucket to 32, capped


class TestGatherRowsPow2:
    def test_padding_and_rows(self):
        arrays = traced_state(seed=11)
        sub, n = tkernel.gather_rows_pow2(port_state(arrays), [1, 4, 7])
        j_sub, j_n = jkernel.gather_rows_pow2(jax_state(arrays), [1, 4, 7])
        assert n == j_n == 3
        assert sub.length.shape[0] == 4
        assert_tree_equal(to_np(sub), to_np(j_sub), "gather_rows_pow2")
        for j, row in enumerate((1, 4, 7, 0)):   # padding repeats row 0
            for name, got in zip(DocState._fields, to_np(sub)):
                np.testing.assert_array_equal(got[j], arrays[name][row],
                                              err_msg=name)
        empty, n0 = tkernel.gather_rows_pow2(port_state(arrays), [])
        assert n0 == 0 and empty.length.shape[0] == 1

    def test_no_retrace_across_dirty_counts(self):
        """Distinct dirty counts under one pow2 bucket share a signature;
        crossing buckets compiles once per bucket, never a retrace per
        count."""
        state = port_state(traced_state(seed=11))
        for n in (1, 2, 4, 8):   # warm every bucket this test touches
            tkernel.gather_rows_pow2(state, list(range(n)))
        before = tcounters.get("kernel.extract_gather.retraces")
        for n in (3, 5, 6, 7, 2, 1, 4, 8, 5, 3):
            _sub, got_n = tkernel.gather_rows_pow2(state, list(range(n)))
            assert got_n == n
        assert tcounters.get("kernel.extract_gather.retraces") == before


# ---------------------------------------------------------------------------
# fuzzed tables, edge batches, the paged form
# ---------------------------------------------------------------------------

def fuzz_state(seed, b, c, k, a, steps=20):
    """fuzz_tables rows through gen_fuzz_traces ops (the port's plain scan)
    with a random min_seq: a numpy dict."""
    tables = fuzz_tables(b, c, k, a, seed=seed, free=max(c // 4, 2))
    ops = gen_fuzz_traces(b, steps, seed=seed,
                          length=np.maximum(tables["count"], 1))
    st = tkernel.apply_ops_batched_keep(
        interop.doc_state_from_numpy(tables, "cpu"),
        interop.packed_ops_from_numpy(ops, "cpu"))
    out = interop.to_numpy(st)
    rng = np.random.default_rng(seed + 100)
    out["min_seq"] = rng.integers(0, 12, b).astype(np.int32)
    return out


@pytest.mark.parametrize("k,a,c", [(3, 1, 8), (1, 3, 33), (5, 8, 100),
                                   (8, 2, 200)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzed_tables_match_jax(seed, k, a, c):
    arrays = fuzz_state(seed, 7, c, k, a)
    got, want = both("compact_extract_batched", arrays, stats=True)
    assert_tree_equal(got, want, "compact_extract_batched")
    got_x, want_x = both("extract_visible_batched", arrays)
    assert_tree_equal(got_x, want_x, "extract_visible_batched")
    t_packed, j_packed = packed_pair(arrays)
    narrow, _ = fetch_both(t_packed, j_packed, True)
    wide, _ = fetch_both(t_packed, j_packed, False)
    rows_equal(narrow, wide)
    sub, n = tkernel.gather_rows_pow2(port_state(arrays), [5, 0, 3])
    j_sub, _ = jkernel.gather_rows_pow2(jax_state(arrays), [5, 0, 3])
    assert_tree_equal(to_np(sub), to_np(j_sub), "gather_rows_pow2")


@pytest.mark.parametrize("case", ["empty_batch", "full_capacity"])
def test_edge_batches_match_jax(case):
    """B = 0 (the slice width falls back to 1, bucketed to 32 and capped
    at C) and documents whose live rows fill the capacity (the bucket of
    64 capped at C = 40)."""
    if case == "empty_batch":
        arrays = interop.to_numpy(make_state(16, 2, batch=0, device="cpu"))
    else:
        arrays = fuzz_tables(6, 40, 3, 2, seed=9, free=0)
        arrays["count"][1::2] = 40
        arrays["rem_seq"][1] = DEV_NO_REMOVE   # nothing for zamboni
    got, want = both("compact_extract_batched", arrays, stats=True)
    assert_tree_equal(got, want, "compact_extract_batched")
    t_packed, j_packed = packed_pair(arrays)
    for narrow in (True, False):
        out, d = fetch_both(t_packed, j_packed, narrow)
        if case == "empty_batch":
            assert out[0].shape == (0, 16)
        else:
            assert out[0].shape == (6, 40) and out[-1][1] == 40


@pytest.mark.parametrize("seed", [0, 3])
def test_compact_extract_paged_matches_jax(seed):
    pool, pids, counts, mins, seqs = paged_case(seed)
    mins = mins + 4
    args = (pids, counts, mins, seqs)
    want = to_np(jkernel.compact_extract_paged_keep(
        jax_state(pool), *(jnp.asarray(x) for x in args)))
    got = to_np(tkernel.compact_extract_paged_keep(
        port_state(pool), *(torch.from_numpy(x) for x in args)))
    assert_tree_equal(got, want, "compact_extract_paged_keep")
    t_pool = port_state(pool)
    out = tkernel.compact_extract_paged(
        t_pool, *(torch.from_numpy(x) for x in args))
    assert out[0] is t_pool
    assert_tree_equal(to_np(out), want, "compact_extract_paged")
    # the paged packed rows equal compact_pages + extraction of the view
    ref = tkernel.compact_pages_keep(port_state(pool),
                                     *(torch.from_numpy(x) for x in args))
    view = tkernel.gather_pages(ref[0], torch.from_numpy(pids), ref[2],
                                torch.from_numpy(mins),
                                torch.from_numpy(seqs))
    assert_tree_equal(to_np(tkernel.extract_visible_batched(view)),
                      want[3], "paged packed vs compact_pages + extract")
