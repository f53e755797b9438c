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


def gen_run_traces(n_docs: int, n_ops: int, seed: int = 0,
                   burst: float = 0.3):
    """gen_traces with typing bursts: each step is, with probability
    `burst`, an INSERT_RUN of 5..8 cursor-advancing members of 1-3 chars
    (one seq per member), else a 70/30 insert/remove as in gen_traces. One
    client, every op at the latest perspective. Returns (numpy op columns
    [B, T], numpy run columns [B, T, RUN_K] keyed by RunCols field)."""
    from ..mergetree.oppack import RUN_K, RUN_MIN, OpKind

    rng = np.random.default_rng(seed)
    b, t = n_docs, n_ops
    cols = {f: np.zeros((b, t), np.int32)
            for f in ("kind", "seq", "ref_seq", "client", "pos1", "pos2",
                      "op_id", "new_len", "local_seq", "msn")}
    runs = {"length": np.zeros((b, t, RUN_K), np.int32),
            "seq": np.zeros((b, t, RUN_K), np.int32),
            "op_id": np.full((b, t, RUN_K), -1, np.int32)}
    lengths = np.zeros(b, np.int64)
    seq = np.zeros(b, np.int64)
    member = np.arange(RUN_K)
    for j in range(t):
        is_run = rng.random(b) < burst
        is_ins = ~is_run & ((rng.random(b) < 0.7) | (lengths < 2))
        is_rem = ~is_run & ~is_ins
        p = np.minimum((rng.random(b) * (lengths + 1)).astype(np.int64),
                       lengths)
        pr = np.clip(p, 0, np.maximum(lengths - 1, 0))
        span = np.minimum(lengths - pr, 16)
        e = np.maximum(np.minimum(
            pr + 1 + (rng.random(b) * span).astype(np.int64), lengths),
            pr + 1)
        ins_len = rng.integers(1, 9, b)
        n_mem = rng.integers(RUN_MIN, RUN_K + 1, b)
        live = member[None, :] < n_mem[:, None]
        mem_len = np.where(live, rng.integers(1, 4, (b, RUN_K)), 0)
        total = mem_len.sum(axis=1)
        step_seq = seq + np.where(is_run, n_mem, 1)
        kind = np.where(is_run, OpKind.INSERT_RUN,
                        np.where(is_ins, OpKind.INSERT, OpKind.REMOVE))
        cols["kind"][:, j] = kind
        cols["seq"][:, j] = step_seq
        cols["ref_seq"][:, j] = seq
        cols["msn"][:, j] = seq
        cols["client"][:, j] = 1
        cols["pos1"][:, j] = np.where(is_rem, pr, p)
        cols["pos2"][:, j] = np.where(is_rem, e, 0)
        cols["op_id"][:, j] = np.where(is_run, -1, j)
        cols["new_len"][:, j] = np.where(is_run, total,
                                         np.where(is_ins, ins_len, 0))
        runs["length"][:, j] = np.where(is_run[:, None], mem_len, 0)
        runs["seq"][:, j] = np.where(is_run[:, None] & live,
                                     seq[:, None] + 1 + member, 0)
        runs["op_id"][:, j] = np.where(is_run[:, None] & live,
                                       1000 + j * RUN_K + member, -1)
        lengths = lengths + np.where(is_run, total,
                                     np.where(is_ins, ins_len, -(e - pr)))
        seq = step_seq
    return cols, runs
