"""The committed golden inputs and JAX outputs (golden/*.npz).

golden/fused_apply_golden.npz holds, as numpy arrays keyed
"<section>.<field>":
  apply_in / apply_op / apply_out   a rich-schedule batch (annotates,
      overlapping removes, pending local ops and acks, a capacity-overflow
      doc and an overlap-overflow doc): DocState in, PackedOps, and the
      JAX package's apply_ops_fused_ref output;
  step_tin / step_min / step_raw / step_op   inputs of one small north-star
      step (with duplicate clientSeqs, so some ops are dropped);
  step_tout / step_mout / step_ticketed / step_total   the JAX package's
      full_step outputs.
golden/serve_megakernel_golden.npz (SERVE_GOLDEN_PATH) holds one small
staged serving ring (testing/serving.py SMALL_RING, page groups of 16-row
pages, INSERT_RUN slots, a mispredicted run, nacks, LWW lanes) and the JAX
package's serve_megakernel_keep outputs with stats on:
  tstate_in / pool_in / lww_in_<i>   the states before the ring;
  ring                               serving.ring_to_arrays of its args;
  tstate_out / pool_out / lww_out_<i> / wire (flat16_k, msn_k) /
  pre_<g>                            the JAX outputs.
tests/test_torch_golden.py regenerates both files from the JAX package and
requires equality, so the values cannot drift; chip_smoke.py holds the CUDA
kernels against them on a machine without JAX.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().parent / "golden" / \
    "fused_apply_golden.npz"
SERVE_GOLDEN_PATH = GOLDEN_PATH.with_name("serve_megakernel_golden.npz")


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
