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


def gen_fuzz_traces(n_docs: int, n_ops: int, seed: int = 0,
                    runs: bool = False, base_seq: int = 8,
                    length: int = 64):
    """Op columns that reach every rule of the fused apply, for holding a
    kernel against its plain version (they are not a replayable edit history):
    every op kind from four clients, pending local inserts, removes and
    annotates (seq DEV_UNASSIGNED) with acks of their local seqs (and of
    local seq 0, which make_state's padding matches), stale
    perspectives, positions in the first half of a document of about
    `length` chars (an int or a [B] array) and 5% of them past its end (so
    some inserts find no tie-break slot), ranges of 1..16, and with
    runs=True INSERT_RUN steps of 1..8 members, some of them dead (length
    0) padding. Sequence numbers start after `base_seq`. Returns numpy
    [B, T] columns, or (columns, run columns [B, T, RUN_K]) with runs."""
    from ..mergetree.constants import DEV_UNASSIGNED
    from ..mergetree.oppack import RUN_K, OpKind

    rng = np.random.default_rng(seed)
    b, t = n_docs, n_ops
    kinds = [OpKind.INSERT, OpKind.REMOVE, OpKind.ANNOTATE,
             OpKind.ACK_INSERT, OpKind.ACK_REMOVE, OpKind.NOOP]
    weights = [0.33, 0.2, 0.15, 0.1, 0.08, 0.04]
    if runs:
        kinds.append(OpKind.INSERT_RUN)
        weights.append(0.1)
    weights = np.asarray(weights) / sum(weights)
    kind = rng.choice(kinds, (b, t), p=weights).astype(np.int32)
    local = rng.random((b, t)) < 0.3
    is_ack = (kind == OpKind.ACK_INSERT) | (kind == OpKind.ACK_REMOVE)
    local &= (kind != OpKind.INSERT_RUN) & ~is_ack & (kind != OpKind.NOOP)
    sequenced = ~local
    seq = base_seq + np.cumsum(sequenced, axis=1, dtype=np.int64)
    local_seq = np.cumsum(local, axis=1, dtype=np.int64)
    ack_target = (rng.random((b, t)) * (local_seq + 1)).astype(np.int64)
    lag = rng.integers(0, 5, (b, t))
    ref = np.maximum(seq - 1 - lag, 0)
    grown = np.cumsum(kind == OpKind.INSERT, axis=1) - \
        (kind == OpKind.INSERT)
    est = np.reshape(length, (-1, 1)) + 2 * grown
    past = rng.random((b, t)) < 0.05
    pos1 = np.where(past, est + rng.integers(0, 5, (b, t)),
                    (rng.random((b, t)) * (est // 2 + 1)).astype(np.int64))
    pos2 = pos1 + rng.integers(1, 17, (b, t))
    cols = {
        "kind": kind,
        "seq": np.where(local, DEV_UNASSIGNED, seq),
        "ref_seq": np.where(local, seq, ref),
        "client": np.where(local | is_ack, 1, rng.integers(0, 4, (b, t))),
        "pos1": pos1,
        "pos2": np.where(kind == OpKind.INSERT, 0, pos2),
        "op_id": rng.integers(0, 1000, (b, t)),
        "new_len": np.where(kind == OpKind.INSERT,
                            rng.integers(1, 9, (b, t)), 0),
        "local_seq": np.where(local, local_seq,
                              np.where(is_ack, ack_target, 0)),
        "msn": ref,
    }
    cols = {f: v.astype(np.int32) for f, v in cols.items()}
    if not runs:
        return cols
    is_run = kind == OpKind.INSERT_RUN
    n_mem = rng.integers(1, RUN_K + 1, (b, t))
    member = np.arange(RUN_K)
    live = is_run[..., None] & (member < n_mem[..., None]) & \
        (rng.random((b, t, RUN_K)) < 0.9)
    run_cols = {
        "length": np.where(live, rng.integers(1, 4, (b, t, RUN_K)), 0),
        "seq": np.where(live, seq[..., None] + member, 0),
        "op_id": np.where(is_run[..., None],
                          rng.integers(0, 1000, (b, t, RUN_K)), -1),
    }
    cols["new_len"] = np.where(is_run, run_cols["length"].sum(-1),
                               cols["new_len"]).astype(np.int32)
    cols["op_id"] = np.where(is_run, -1, cols["op_id"]).astype(np.int32)
    return cols, {f: v.astype(np.int32) for f, v in run_cols.items()}


def fuzz_tables(n_docs: int, capacity: int, k_slots: int, a_slots: int,
                seed: int = 0, free: int = 12):
    """Starting tables for gen_fuzz_traces: every other document is empty,
    the rest hold capacity - free .. capacity rows (so the capacity gates
    trip) of 1..4 chars at seqs 0..8 from clients 0..3, some pending
    (local seqs 1..3), some removed or pending removal with overlap
    clients, some annotated. The padding past count is make_state's but
    for every fourth document, whose padding holds such rows too (stale
    rows, as a reused page may hold). Returns a numpy dict in DocState
    field order."""
    from ..mergetree.constants import DEV_NO_REMOVE, DEV_UNASSIGNED

    rng = np.random.default_rng(seed)
    b, c, k, a = n_docs, capacity, k_slots, a_slots
    count = np.where(np.arange(b) % 2 == 1,
                     rng.integers(max(c - free, 0), c + 1, b), 0)
    row = (np.arange(c)[None, :] < count[:, None]) | \
        (np.arange(b) % 4 == 3)[:, None]

    def rows(values, pad):
        return np.where(row, values, pad).astype(np.int32)

    pend = rng.random((b, c)) < 0.15
    removed = rng.random((b, c))
    rem_seq = np.where(removed < 0.2, rng.integers(1, 9, (b, c)),
                       np.where(removed < 0.3, DEV_UNASSIGNED, DEV_NO_REMOVE))
    rc = np.where(rng.random((b, c, k)) < 0.5,
                  rng.integers(0, 4, (b, c, k)), -1)
    rc = np.where((rem_seq != DEV_NO_REMOVE)[..., None], rc, -1)
    anno = np.where(rng.random((b, c, a)) < 0.3,
                    rng.integers(0, 1000, (b, c, a)), -1)
    return {
        "length": rows(rng.integers(1, 5, (b, c)), 0),
        "ins_seq": rows(np.where(pend, DEV_UNASSIGNED,
                                 rng.integers(0, 9, (b, c))), DEV_UNASSIGNED),
        "ins_client": rows(np.where(pend, 1, rng.integers(0, 4, (b, c))), -1),
        "local_seq": rows(np.where(pend, rng.integers(1, 4, (b, c)), 0), 0),
        "rem_seq": rows(rem_seq, DEV_NO_REMOVE),
        "rem_local_seq": rows(np.where(rem_seq == DEV_UNASSIGNED,
                                       rng.integers(1, 4, (b, c)), 0), 0),
        "rem_clients": np.where(row[..., None], rc, -1).astype(np.int32),
        "origin_op": rows(rng.integers(0, 1000, (b, c)), -1),
        "origin_off": rows(rng.integers(0, 4, (b, c)), 0),
        "anno": np.where(row[..., None], anno, -1).astype(np.int32),
        "count": count.astype(np.int32),
        "min_seq": np.zeros(b, np.int32),
        "seq": np.full(b, 8, np.int32),
        "overflow": np.zeros(b, bool),
    }
