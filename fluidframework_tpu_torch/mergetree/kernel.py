"""Paged gather and scatter of segment tables (a subset of
fluidframework_tpu's mergetree/kernel.py).

A page pool is a DocState whose batch axis is pages and whose capacity
axis is PAGE_ROWS (mergetree/paging.py). `gather_pages` materializes a
batch of documents from their page tables as a [B, P * PAGE_ROWS] view,
the shape the fused apply takes; `scatter_pages` writes a view back. In
JAX both are XLA gathers and scatters, not Pallas kernels, so plain torch
indexing is the port. The rest of kernel.py (the scan apply, compaction,
extraction) is not ported yet.
"""

from __future__ import annotations

import torch

from .paging import BLANK_PAGE
from .state import DocState

_ROW_FIELDS = ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
               "rem_local_seq", "rem_clients", "origin_op", "origin_off",
               "anno")


def gather_pages(pool: DocState, page_ids: torch.Tensor, counts: torch.Tensor,
                 min_seqs: torch.Tensor, seqs: torch.Tensor) -> DocState:
    """[B, P] int32 page tables (-1 pads a short table and gathers the
    blank page 0) -> a [B, P * PAGE_ROWS, ...] DocState view with the
    per-document scalars given and a fresh overflow plane."""
    gidx = torch.clamp(page_ids, min=0).to(torch.int64)
    b, p = page_ids.shape
    r = pool.capacity

    def g(col):
        x = col[gidx]  # [B, P, R, ...]
        return x.reshape((b, p * r) + tuple(x.shape[3:]))

    return DocState(
        **{name: g(getattr(pool, name)) for name in _ROW_FIELDS},
        count=counts, min_seq=min_seqs, seq=seqs,
        overflow=torch.zeros((b,), dtype=torch.bool, device=counts.device))


def scatter_pages(pool: DocState, page_ids: torch.Tensor,
                  view: DocState) -> DocState:
    """Write a [B, P * PAGE_ROWS, ...] view back into its pages, IN PLACE
    on `pool`'s row tensors, and return `pool`.

    JAX drops the rows of padding ids (-1) with mode="drop"; torch has no
    such mode, so they are redirected to the blank page and page 0 is
    restored from a copy taken before the scatter: the result equals the
    JAX scatter whenever no real table entry is page 0, which the page
    allocator guarantees. Each real page has one owner, so the scatter is
    collision-free."""
    b, p = page_ids.shape
    r = pool.capacity
    dst = torch.where(page_ids >= 0, page_ids,
                      BLANK_PAGE).to(torch.int64).reshape(-1)
    for name in _ROW_FIELDS:
        col = getattr(pool, name)
        blank = col[BLANK_PAGE].clone()
        v = getattr(view, name)
        col[dst] = v.reshape((b * p, r) + tuple(v.shape[2:]))
        col[BLANK_PAGE] = blank
    return pool
