"""Hand-written CUDA kernels (csrc/*.cu) for Hopper and their build.

`selftest` is the first launch of the library: `o = 2 * x` on int32, the
counterpart of the `o = x * 2` lowering probe of fluidframework_tpu's
mergetree/pallas_ops.py. It checks that the library builds and launches;
no fallback hangs on it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def selftest_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def selftest(x: torch.Tensor) -> torch.Tensor:
    """2 * x (int32). The CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.dtype != torch.int32:
        raise TypeError(f"selftest takes int32, got {x.dtype}")
    if x.device.type == "cpu":
        return selftest_plain(x)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("selftest takes a contiguous CUDA or CPU tensor")
    lib = build.library()
    out = torch.empty_like(x)
    selftest.launches += 1
    build.check(lib.fluid_selftest(ctypes.c_void_p(x.data_ptr()),
                                   ctypes.c_void_p(out.data_ptr()),
                                   x.numel(),
                                   ctypes.c_void_p(build.stream_handle())),
                "selftest")
    return out


selftest.launches = 0
