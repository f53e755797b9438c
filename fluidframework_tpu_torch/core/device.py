"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is "cuda", and asking for it without a CUDA device raises
instead of quietly handing back CPU tensors. The CPU is used only when the
caller names it (the conformance tests pass device="cpu").
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch.device to place new tensors on.

    None means "cuda". A CUDA device is checked for availability and raises
    RuntimeError when there is none."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: fluidframework_tpu_torch runs on the "
            "card by default; pass device='cpu' to use the plain PyTorch "
            "versions")
    return dev
