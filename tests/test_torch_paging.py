"""The port's paged lane memory (fluidframework_tpu_torch/mergetree/paging.py
and kernel.gather_pages / scatter_pages) against the JAX package: the
allocator's refcount and double-free rules (the template is
tests/test_paged_memory.py), store growth and release, and gather/scatter
by page id, padding ids included, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import kernel as jkernel
from fluidframework_tpu.mergetree import paging as jpaging
from fluidframework_tpu.mergetree.state import DocState as JaxDocState

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import kernel as tkernel
from fluidframework_tpu_torch.mergetree.constants import PAGE_ROWS
from fluidframework_tpu_torch.mergetree.paging import (
    BLANK_PAGE, PageAllocator, PagedMergeStore, pages_for, pow2_pages)
from fluidframework_tpu_torch.mergetree.state import DocState, make_state


class TestPageAllocator:
    def test_alloc_free_and_reuse(self):
        a = PageAllocator(8)
        pids = [a.alloc() for _ in range(4)]
        assert len(set(pids)) == 4 and BLANK_PAGE not in pids
        assert a.pages_in_use == 4
        assert a.release(pids[1]) is True
        assert a.pages_in_use == 3
        assert a.alloc() == pids[1]  # the free list hands it back first

    def test_double_free_raises(self):
        a = PageAllocator(4)
        pid = a.alloc()
        assert a.release(pid)
        with pytest.raises(ValueError, match="double free"):
            a.release(pid)

    def test_blank_and_out_of_range_ids_refuse(self):
        a = PageAllocator(4)
        for bad in (BLANK_PAGE, 99):
            with pytest.raises(ValueError):
                a.release(bad)
        with pytest.raises(ValueError):
            a.retain(0)

    def test_refcounted_share_frees_on_last_release(self):
        a = PageAllocator(4)
        pid = a.alloc()
        a.retain(pid)
        assert a.release(pid) is False
        assert a.pages_in_use == 1
        assert a.release(pid) is True
        with pytest.raises(ValueError, match="double free"):
            a.release(pid)

    def test_grow_extends_free_list(self):
        a = PageAllocator(4)
        got = {a.alloc() for _ in range(3)}
        with pytest.raises(IndexError):
            a.alloc()
        a.grow(8)
        more = {a.alloc() for _ in range(4)}
        assert not (got & more)
        assert a.pages_in_use == 7

    def test_same_sequence_as_jax_allocator(self):
        """Alloc / release / grow in one order: the same page ids and
        refcounts as the JAX allocator."""
        ours, theirs = PageAllocator(6), jpaging.PageAllocator(6)
        log = []
        for alloc in (ours, theirs):
            got = [alloc.alloc() for _ in range(4)]
            alloc.release(got[2])
            alloc.grow(12)
            got += alloc.alloc_many(6)
            log.append((got, alloc.refcount.tolist(), alloc.pages_free))
        assert log[0] == log[1]

    def test_page_bucket_helpers(self):
        assert [pow2_pages(n) for n in (1, 2, 3, 5, 9)] == [1, 2, 4, 8, 16]
        assert [pages_for(r) for r in (0, 1, 64, 65)] == [1, 1, 1, 2]
        assert PAGE_ROWS == 64


class TestPagedStore:
    def test_growth_appends_pages_without_moving(self):
        pg = PagedMergeStore(page_rows=8, pages=8, device="cpu")
        key = ("d",)
        pg.ensure_rows(key, 5)
        first = list(pg.tables[key])
        pg.ensure_rows(key, 30)
        assert pg.tables[key][:len(first)] == first
        assert len(pg.tables[key]) == pages_for(30, 8) == 4

    def test_pool_doubles_and_keeps_rows(self):
        pg = PagedMergeStore(page_rows=8, pages=4, device="cpu")
        pg.ensure_rows(("a",), 8)
        pid = pg.tables[("a",)][0]
        pg.pool.length[pid] = 7
        pg.ensure_rows(("k",), 8 * 10)
        assert pg.allocator.capacity >= 16 and pg.pool_grows >= 1
        assert pg.pool.length.shape == (pg.allocator.capacity, 8)
        assert bool((pg.pool.length[pid] == 7).all())

    def test_release_trailing_frees_and_blanks(self):
        pg = PagedMergeStore(page_rows=8, pages=8, device="cpu")
        key = ("d",)
        pg.ensure_rows(key, 32)
        dead = pg.tables[key][1:]
        for pid in pg.tables[key]:
            pg.pool.length[pid] = 3
            pg.pool.anno[pid] = 5
        pg.counts[key] = 3
        pg.release_trailing(key)
        assert len(pg.tables[key]) == 1
        assert pg.allocator.pages_in_use == 1
        blank = make_state(8, 4, device="cpu")
        for pid in dead:
            assert bool((pg.pool.length[pid] == blank.length).all())
            assert bool((pg.pool.anno[pid] == blank.anno).all())
        pg.free_all(key)
        assert pg.allocator.pages_in_use == 0 and key not in pg.counts

    def test_staging_planes_and_scalar_adoption(self):
        pg = PagedMergeStore(page_rows=8, pages=8, device="cpu")
        keys = [("a",), ("b",)]
        pg.ensure_rows(keys[0], 20)
        pg.ensure_rows(keys[1], 4)
        plane = pg.page_ids_array(keys, 4)
        assert plane.dtype == np.int32 and plane.shape == (2, 4)
        assert (plane[1, 1:] == -1).all()
        pg.adopt_scalars(keys, [17, 2], [3, 1], [9, 4])
        counts, mins, seqs = pg.scalars_arrays(keys)
        assert counts.tolist() == [17, 2] and seqs.tolist() == [9, 4]
        with pytest.raises(AssertionError, match="spilled"):
            pg.adopt_scalars(keys, [25, 2], [0, 0], [0, 0])


def _random_pool(rng, n_pages, rows, k=3, a=2):
    """Arbitrary page contents, except page 0, which stays blank."""
    st = {f: np.asarray(v) for f, v in zip(
        DocState._fields, make_state(rows, a, k, batch=n_pages,
                                     device="cpu"))}
    for f in ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
              "rem_local_seq", "origin_op", "origin_off"):
        st[f] = rng.integers(-5, 1000, (n_pages, rows)).astype(np.int32)
    st["rem_clients"] = rng.integers(-1, 6, (n_pages, rows, k)) \
        .astype(np.int32)
    st["anno"] = rng.integers(-1, 50, (n_pages, rows, a)).astype(np.int32)
    blank = make_state(rows, a, k, device="cpu")
    for f in ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
              "rem_local_seq", "origin_op", "origin_off", "rem_clients",
              "anno"):
        st[f][0] = getattr(blank, f).numpy()
    return st


def _jax(st):
    return JaxDocState(**{f: jnp.asarray(v) for f, v in st.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_scatter_match_jax_with_padding(seed):
    rng = np.random.default_rng(seed)
    n_pages, rows, b, p = 24, 8, 5, 4
    pool = _random_pool(rng, n_pages, rows)
    perm = rng.permutation(np.arange(1, n_pages))[:b * p]
    pids = perm.reshape(b, p).astype(np.int32)
    pids[1, 2:] = -1          # short tables
    pids[3, 1:] = -1
    pids[4, :] = -1           # an all-padding row (a padded lane)
    counts = rng.integers(0, rows * p, b).astype(np.int32)
    mins = rng.integers(0, 9, b).astype(np.int32)
    seqs = rng.integers(9, 20, b).astype(np.int32)

    want = jkernel.gather_pages(_jax(pool), jnp.asarray(pids),
                                jnp.asarray(counts), jnp.asarray(mins),
                                jnp.asarray(seqs))
    t_pool = interop.page_pool_from_numpy(pool, "cpu")
    got = tkernel.gather_pages(t_pool, torch.from_numpy(pids),
                               torch.from_numpy(counts),
                               torch.from_numpy(mins),
                               torch.from_numpy(seqs))
    for f in DocState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)

    # A modified view (every lane, the padding pages' lanes too) goes back.
    view = {f: np.asarray(getattr(want, f)) for f in DocState._fields}
    for f in ("length", "ins_seq", "origin_op"):
        view[f] = rng.integers(0, 500, view[f].shape).astype(np.int32)
    view["anno"] = rng.integers(-1, 9, view["anno"].shape).astype(np.int32)
    j_out = jkernel.scatter_pages(_jax(pool), jnp.asarray(pids),
                                  _jax(view))
    t_view = interop.doc_state_from_numpy(view, "cpu")
    t_out = tkernel.scatter_pages(t_pool, torch.from_numpy(pids), t_view)
    assert t_out.length.data_ptr() == t_pool.length.data_ptr()  # in place
    for f in DocState._fields:
        np.testing.assert_array_equal(getattr(t_out, f).numpy(),
                                      np.asarray(getattr(j_out, f)),
                                      err_msg=f)
    # The blank page was a redirect target and is blank again.
    np.testing.assert_array_equal(t_out.length[BLANK_PAGE].numpy(),
                                  pool["length"][0])
