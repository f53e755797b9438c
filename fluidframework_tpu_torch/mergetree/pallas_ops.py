"""Per-document visible length at the acked perspective.

Counterpart of fluidframework_tpu's mergetree/pallas_ops.py. At the acked
perspective (ref_seq = state.seq) only (ins_seq, rem_seq, count) decide
visibility, so the pass reads three [B, C] planes once and writes [B].
`summary_lengths` runs the CUDA kernel (kernels/csrc/summary_len.cu) for
CUDA tensors and `summary_lengths_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..parallel.mesh import note_launch
from .state import DocState


def summary_lengths_plain(state: DocState) -> torch.Tensor:
    """Plain PyTorch version: int32 [B]."""
    lanes = torch.arange(state.length.shape[-1], device=state.length.device)
    seq = state.seq[:, None]
    vis = ((lanes < state.count[:, None]) & (state.ins_seq <= seq)
           & ~(state.rem_seq <= seq))
    return torch.where(vis, state.length, 0).sum(dim=1, dtype=torch.int32)


def _launch(state: DocState, entry: str, what: str) -> torch.Tensor:
    """One launch of the library's `entry` over a CUDA DocState."""
    planes = (state.length, state.ins_seq, state.rem_seq, state.count,
              state.seq)
    for t in planes:
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous int32 CUDA tensors")
    batch, capacity = state.length.shape
    lib = build.library()
    out = torch.empty(batch, dtype=torch.int32, device=state.length.device)
    build.check(getattr(lib, entry)(
        *(ctypes.c_void_p(t.data_ptr()) for t in planes),
        ctypes.c_void_p(out.data_ptr()), batch, capacity,
        ctypes.c_void_p(build.stream_handle())), what)
    return out


def summary_lengths(state: DocState) -> torch.Tensor:
    """Per-document visible length of a batched DocState, int32 [B]."""
    if state.length.device.type == "cpu":
        return summary_lengths_plain(state)
    out = _launch(state, "fluid_summary_len", "summary_lengths")
    summary_lengths.launches += 1
    note_launch("summary_len")
    return out


summary_lengths.launches = 0
