"""Cost-model routing for single-lane bulk catch-up: scalar vs device.

A port of fluidframework_tpu's mergetree/costmodel.py with H100 figures.
A client catch-up is one document (B = 1), so the device path's only
lever over the scalar oracle is its per-op cost, which does not grow with
the document, while the scalar path's per-op position walk grows with the
live segments; the device path pays a floor per chunk (host packing, the
launch, the overflow read, the fold):

    scalar_s = tail_len * (SCALAR_BASE_S + SCALAR_PER_SEG_S * live_segments)
    device_s = ceil(tail_len / CHUNK_T) * DEVICE_CHUNK_S
               + tail_len * DEVICE_PER_OP_S

and the device path is taken when scalar_s > HYSTERESIS * device_s.

Both sides are fitted by chip_smoke.py phase 13 on the card machine's host
and its H100 (PERF.md §5): the scalar side from the port's
MergeTreeClient.apply_msg replaying keystroke_trace(100_000, seed=12) op
by op (time per op against the live segments at several points of the
trace), the device side from catchup.device_apply_tail's wall on prefixes
of the same trace (a least-squares fit of the wall to the formula above).
The device-side catch-up is host-bound (PERF.md §5: idle share 0.889), so
its kernel times alone would understate it.

Only the card routes to the device: `backend` is a torch device type
("cuda" when None, the port's default), and any other backend ("cpu")
returns False, as the JAX model does off the TPU: the plain PyTorch scan
at B = 1 is not a device path.

Override: FLUID_TPU_FORCE_BULK=1 forces the device path (tests exercise
kernel correctness regardless of backend), =0 forces scalar.
"""

from __future__ import annotations

import os

# Scalar per-op cost ~= SCALAR_BASE_S + SCALAR_PER_SEG_S * live_segments:
# chip_smoke.py phase 13 on the host of an NVIDIA H100 80GB HBM3 (700 W)
# machine, the port's oracle replaying the first 77,500 ops of
# keystroke_trace(100_000, seed=12) (87 -> 1,788 live segments, 155 ->
# 1,335 us per op); the free linear fit's base came out below 0, so the
# fit is through the origin.
SCALAR_BASE_S = 0.0
SCALAR_PER_SEG_S = 8.316e-07

# Device path ~= per-chunk floor + per-op cost: chip_smoke.py phase 13,
# catchup.device_apply_tail's wall on 64 .. 100,000-op prefixes of the
# same trace on that NVIDIA H100 80GB HBM3 (700 W), fitted (relative
# least squares) to ceil(tail_len / CHUNK_T) chunks + tail_len ops.
DEVICE_CHUNK_S = 3.423e-3
DEVICE_PER_OP_S = 9.561e-06
HYSTERESIS = 1.2        # prefer scalar near the line (misroute is cheap
#                         scalar-side, expensive device-side)


def device_bulk_wins(tail_len: int, live_segments: int,
                     backend: str | None = None) -> bool:
    """Should this single-lane tail ride the device kernel?

    backend is a torch device type; None means "cuda". Pass it explicitly
    in tests to keep the model a pure function."""
    force = os.environ.get("FLUID_TPU_FORCE_BULK")
    if force == "1":
        return True
    if force == "0":
        return False
    if backend is None:
        backend = "cuda"
    if backend != "cuda":
        return False
    from .catchup import CHUNK_T
    scalar_s = tail_len * (SCALAR_BASE_S
                           + SCALAR_PER_SEG_S * live_segments)
    chunks = -(-tail_len // CHUNK_T)
    device_s = chunks * DEVICE_CHUNK_S + tail_len * DEVICE_PER_OP_S
    return scalar_s > device_s * HYSTERESIS
