"""Synthetic editing traces for the north-star step.

A copy of the repository's `bench.py gen_traces`: the same numpy generator
with the same seed behaviour, so the port and the JAX package replay
identical op columns.
"""

from __future__ import annotations

import numpy as np


def gen_traces(n_docs: int, n_ops: int, seed: int = 0):
    """Vectorized synthetic editing traces: per-doc sequential ops (the
    ProseMirror/Monaco replay shape): 70% insert (1-8 chars), 30% remove,
    positions uniform over the current doc length (tracked arithmetically).
    Returns numpy op columns [B, T] in mergetree.oppack layout."""
    rng = np.random.default_rng(seed)
    b, t = n_docs, n_ops
    kind = np.where(rng.random((b, t)) < 0.7, 1, 2).astype(np.int32)
    ins_len = rng.integers(1, 9, (b, t), dtype=np.int32)
    frac_pos = rng.random((b, t))
    frac_end = rng.random((b, t))

    pos1 = np.zeros((b, t), np.int32)
    pos2 = np.zeros((b, t), np.int32)
    lengths = np.zeros(b, np.int64)
    for j in range(t):
        kj = kind[:, j].copy()
        # Removes on empty docs become inserts.
        kj[(kj == 2) & (lengths < 2)] = 1
        kind[:, j] = kj
        is_ins = kj == 1
        p = (frac_pos[:, j] * (lengths + 1)).astype(np.int64)
        p = np.minimum(p, lengths)
        # Remove [p, e): p < length, e in (p, min(len, p+16)]
        pr = np.minimum(p, lengths - 1)
        pr[pr < 0] = 0
        span = np.minimum(lengths - pr, 16)
        e = pr + 1 + (frac_end[:, j] * span).astype(np.int64)
        e = np.minimum(e, lengths)
        e = np.maximum(e, pr + 1)
        pos1[:, j] = np.where(is_ins, p, pr).astype(np.int32)
        pos2[:, j] = np.where(is_ins, 0, e).astype(np.int32)
        lengths = np.where(is_ins, lengths + ins_len[:, j], lengths - (e - pr))
    seq = np.tile(np.arange(1, t + 1, dtype=np.int32), (b, 1))
    return {
        "kind": kind, "seq": seq, "ref_seq": seq - 1,
        "client": np.ones((b, t), np.int32),
        "pos1": pos1, "pos2": pos2,
        "op_id": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        "new_len": np.where(kind == 1, ins_len, 0).astype(np.int32),
        "local_seq": np.zeros((b, t), np.int32),
        "msn": seq - 1,
    }
