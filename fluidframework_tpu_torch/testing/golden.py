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
golden/catchup_golden.json (CATCHUP_GOLDEN_PATH) holds the JAX package's
bulk catch-up (mergetree/catchup.device_apply_tail from no entries) of two
keystroke traces (testing/traces.keystroke_trace, seed 12, one client):
  small   the 3,000-op prefix: its snapshot entries in full;
  full    the 100,000-op trace: entries_digest of its entries (count,
          visible length, sha256 of the canonical JSON, sha256 of the
          visible text).
tests/test_torch_golden.py regenerates the files from the JAX package and
requires equality, so the values cannot drift; chip_smoke.py holds the CUDA
kernels against them on a machine without JAX.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().parent / "golden" / \
    "fused_apply_golden.npz"
SERVE_GOLDEN_PATH = GOLDEN_PATH.with_name("serve_megakernel_golden.npz")
CATCHUP_GOLDEN_PATH = GOLDEN_PATH.with_name("catchup_golden.json")
# The keystroke traces of the catch-up golden: (n_ops, seed, n_clients).
CATCHUP_SMALL = (3000, 12, 1)
CATCHUP_FULL = (100_000, 12, 1)


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


def entries_text(entries: List[dict]) -> str:
    """The visible text of snapshot entries at the local view: removed
    rows (acked or pending) are left out, a marker is U+FFFC."""
    from ..mergetree.constants import SEG_MARKER
    return "".join("\ufffc" if e.get("kind") == SEG_MARKER else e["text"]
                   for e in entries if e.get("removedSeq") is None
                   and e.get("removedLocalSeq") is None)


def canonical_entries(entries: List[dict]) -> str:
    """Entries as canonical JSON (payloads wire-encoded, keys sorted, no
    spaces)."""
    from ..mergetree.runs import encode_entry_payloads
    return json.dumps(encode_entry_payloads(entries), sort_keys=True,
                      separators=(",", ":"))


def entries_digest(entries: List[dict]) -> Dict[str, object]:
    """{count, visible_length, entries_sha256, text_sha256} of snapshot
    entries."""
    text = entries_text(entries)
    return {"count": len(entries), "visible_length": len(text),
            "entries_sha256": hashlib.sha256(
                canonical_entries(entries).encode()).hexdigest(),
            "text_sha256": hashlib.sha256(text.encode()).hexdigest()}


def load_catchup(path: Path = CATCHUP_GOLDEN_PATH) -> dict:
    """{"small": {"trace", "entries"}, "full": {"trace", "digest"}}, the
    small entries decoded back to the port's payload types."""
    from ..mergetree.runs import decode_entry_payloads
    with open(path) as f:
        data = json.load(f)
    data["small"]["entries"] = decode_entry_payloads(
        data["small"]["entries"])
    return data


def save_catchup(data: dict, path: Path = CATCHUP_GOLDEN_PATH) -> None:
    from ..mergetree.runs import encode_entry_payloads
    out = {"small": dict(data["small"]), "full": dict(data["full"])}
    out["small"]["entries"] = encode_entry_payloads(
        out["small"]["entries"])
    with open(path, "w") as f:
        json.dump(out, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
