"""The committed golden inputs and JAX outputs (golden/fused_apply_golden.npz).

The file holds, as numpy arrays keyed "<section>.<field>":
  apply_in / apply_op / apply_out   a rich-schedule batch (annotates,
      overlapping removes, pending local ops and acks, a capacity-overflow
      doc and an overlap-overflow doc): DocState in, PackedOps, and the
      JAX package's apply_ops_fused_ref output;
  step_tin / step_min / step_raw / step_op   inputs of one small north-star
      step (with duplicate clientSeqs, so some ops are dropped);
  step_tout / step_mout / step_ticketed / step_total   the JAX package's
      full_step outputs.
tests/test_torch_golden.py regenerates it from the JAX package and requires
equality, so the values cannot drift; chip_smoke.py holds the CUDA kernels
against it on a machine without JAX.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().parent / "golden" / \
    "fused_apply_golden.npz"


def load(path: Path = GOLDEN_PATH) -> Dict[str, Dict[str, np.ndarray]]:
    """{section: {field: array}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            section, field = key.split(".", 1)
            out.setdefault(section, {})[field] = data[key]
    return out


def save(sections: Dict[str, Dict[str, np.ndarray]],
         path: Path = GOLDEN_PATH) -> None:
    flat = {f"{section}.{field}": np.asarray(arr)
            for section, fields in sections.items()
            for field, arr in fields.items()}
    np.savez_compressed(path, **flat)
