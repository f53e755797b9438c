"""Synthetic editing traces.

`gen_traces` is a copy of the repository's `bench.py gen_traces`, and
`keystroke_trace`, `matrix_storm` and `directory_merge_script` of
fluidframework_tpu's testing/traces.py: the same
generators with the same seed behaviour, so the port and the JAX package
replay identical ops. The rest are the port's own generators for holding
its kernels against their plain versions.
"""

from __future__ import annotations

import random
from typing import List, Tuple

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
    pad = ~((np.arange(c)[None, :] < count[:, None]) |
            (np.arange(b) % 4 == 3)[:, None])

    # The planes are written in place, as int32, from the draws in their
    # order: the tables of phase 10 of chip_smoke.py reach 10^9 slots.
    def rows(values, fill):
        out = values.astype(np.int32)
        out[pad] = fill
        return out

    def drawn(shape, lo, hi, p):
        """integers(lo, hi) where a uniform draw (taken first) is < p,
        else -1, as int32."""
        keep = rng.random(shape) < p
        out = rng.integers(lo, hi, shape).astype(np.int32)
        np.copyto(out, -1, where=~keep)
        return out

    pend = rng.random((b, c)) < 0.15
    removed = rng.random((b, c))
    rem_seq = np.where(removed < 0.2, rng.integers(1, 9, (b, c)),
                       np.where(removed < 0.3, DEV_UNASSIGNED, DEV_NO_REMOVE))
    rc = drawn((b, c, k), 0, 4, 0.5)
    rc[(rem_seq == DEV_NO_REMOVE) | pad] = -1
    anno = drawn((b, c, a), 0, 1000, 0.3)
    anno[pad] = -1
    return {
        "length": rows(rng.integers(1, 5, (b, c)), 0),
        "ins_seq": rows(np.where(pend, DEV_UNASSIGNED,
                                 rng.integers(0, 9, (b, c))), DEV_UNASSIGNED),
        "ins_client": rows(np.where(pend, 1, rng.integers(0, 4, (b, c))), -1),
        "local_seq": rows(np.where(pend, rng.integers(1, 4, (b, c)), 0), 0),
        "rem_seq": rows(rem_seq, DEV_NO_REMOVE),
        "rem_local_seq": rows(np.where(rem_seq == DEV_UNASSIGNED,
                                       rng.integers(1, 4, (b, c)), 0), 0),
        "rem_clients": rc,
        "origin_op": rows(rng.integers(0, 1000, (b, c)), -1),
        "origin_off": rows(rng.integers(0, 4, (b, c)), 0),
        "anno": anno,
        "count": count.astype(np.int32),
        "min_seq": np.zeros(b, np.int32),
        "seq": np.full(b, 8, np.int32),
        "overflow": np.zeros(b, bool),
    }


# Wire op types (mergetree/client.py, reference ops.ts:29).
OP_INSERT, OP_REMOVE, OP_ANNOTATE = 0, 1, 2

WORDS = ("the quick brown fox jumps over a lazy dog while typing "
         "structured paragraphs of filler prose for replay traces").split()


def raw_ticket_trace(seed: int, b: int, t: int, n_clients: int,
                     with_kind: bool) -> dict:
    """Unsequenced messages for the deli ticketing ([B, T] int32 numpy
    columns client, client_seq, ref_seq and, with_kind, kind): up to
    n_clients clients per document (more than the table's slots overflow
    it), increasing clientSeqs with ~15% repeats (duplicates), refSeqs
    that lag or run stale, NOOP gaps (client -1), and (with_kind) JOIN,
    LEAVE and SYSTEM messages beside the OPs."""
    rng = np.random.default_rng(seed)
    client = rng.integers(-1, n_clients, (b, t)).astype(np.int32)
    step = (rng.random((b, t)) > 0.15).astype(np.int32)
    client_seq = np.cumsum(step, axis=1).astype(np.int32)
    lag = rng.integers(0, 6, (b, t))
    ref_seq = np.maximum(np.arange(t)[None, :] - lag, 0).astype(np.int32)
    out = {"client": client, "client_seq": client_seq, "ref_seq": ref_seq}
    if with_kind:
        kind = rng.choice(np.array([0, 1, 2, 3, 4], np.int32), (b, t),
                          p=[0.05, 0.6, 0.2, 0.1, 0.05])
        out["kind"] = kind.astype(np.int32)
    return out


def keystroke_trace(n_ops: int, seed: int = 0, n_clients: int = 1,
                    window: int = 128) -> List[Tuple[dict, int, int, int,
                                                     int]]:
    """A sequenced single-document editing trace:
    [(wire_op, seq, ref_seq, client_ordinal, msn)].

    Emission model (per op, roughly matching captured editor sessions):
      74% keystroke insert (1 char at the cursor; bursts extend words)
      10% backspace (remove 1 char before the cursor)
       6% word/selection delete (remove 2-24 chars near the cursor)
       4% paste (insert 20-200 chars at the cursor)
       4% format sweep (annotate 5-80 chars near the cursor)
       2% cursor jump (no op emitted; moves the locality anchor)

    Multi-client mode interleaves independent cursors with a shared
    sequencing order and per-client ref_seq lag, the concurrent-editor
    shape of the service-load profiles."""
    rng = random.Random(seed)
    length = 0
    cursors = [0] * n_clients
    out: List[Tuple[dict, int, int, int, int]] = []
    seq = 0
    burst_left = 0
    burst_client = 0
    while len(out) < n_ops:
        if burst_left > 0:
            c = burst_client
            burst_left -= 1
            roll = 0.0  # keystroke continues the burst
        else:
            c = rng.randrange(n_clients)
            roll = rng.random()
            if roll >= 0.98:  # cursor jump: move anchor, no op
                cursors[c] = rng.randrange(length + 1) if length else 0
                continue
            if roll < 0.74:  # start a word burst
                burst_left = rng.randrange(2, 9)
                burst_client = c
        cur = min(cursors[c], length)
        if roll < 0.74:  # keystroke
            word = rng.choice(WORDS)
            ch = word[rng.randrange(len(word))] if rng.random() < 0.85 \
                else " "
            op = {"type": OP_INSERT, "pos1": cur, "seg": {"text": ch}}
            length += 1
            cursors[c] = cur + 1
        elif roll < 0.84:  # backspace
            if cur == 0 or length == 0:
                burst_left = 0
                continue
            op = {"type": OP_REMOVE, "pos1": cur - 1, "pos2": cur}
            length -= 1
            cursors[c] = cur - 1
        elif roll < 0.90:  # word/selection delete
            if length < 4:
                continue
            span = min(rng.randrange(2, 25), length)
            start = max(0, min(cur - span // 2, length - span))
            op = {"type": OP_REMOVE, "pos1": start, "pos2": start + span}
            length -= span
            cursors[c] = start
        elif roll < 0.94:  # paste
            n = rng.randrange(20, 201)
            text = " ".join(rng.choice(WORDS)
                            for _ in range(max(1, n // 6)))[:n]
            op = {"type": OP_INSERT, "pos1": cur, "seg": {"text": text}}
            length += len(text)
            cursors[c] = cur + len(text)
        else:  # format sweep
            if length < 2:
                continue
            span = min(rng.randrange(5, 81), length)
            start = max(0, min(cur - span // 2, length - span))
            op = {"type": OP_ANNOTATE, "pos1": start, "pos2": start + span,
                  "props": {"fmt": rng.randrange(4)}}
        seq += 1
        # Concurrent editors lag each other by a small ref_seq window.
        lag = 0 if n_clients == 1 else rng.randrange(0, 4)
        out.append((op, seq, max(0, seq - 1 - lag), 1 + c,
                    max(0, seq - window)))
    return out


def matrix_storm(rows: int, cols: int, n_ops: int, seed: int = 0):
    """Spreadsheet op storm for a rows×cols SharedMatrix (BASELINE config
    #3): 6% row inserts, 4% col inserts, 2% row/col removes, 88% cell
    sets with row/col locality (edits cluster around a moving active
    cell, the way spreadsheet sessions behave).

    Yields ("insert_rows"|"insert_cols"|"remove_rows"|"remove_cols"|
    "set", args...) host commands for a driver loop; the dimensions are
    tracked so every command is valid at emission time."""
    rng = random.Random(seed)
    r, c = rows, cols
    active_r, active_c = 0, 0
    out = []
    for i in range(n_ops):
        roll = rng.random()
        if roll < 0.06:
            at = rng.randrange(r + 1)
            out.append(("insert_rows", at, 1))
            r += 1
        elif roll < 0.10:
            at = rng.randrange(c + 1)
            out.append(("insert_cols", at, 1))
            c += 1
        elif roll < 0.11 and r > 8:
            at = rng.randrange(r - 1)
            out.append(("remove_rows", at, 1))
            r -= 1
        elif roll < 0.12 and c > 8:
            at = rng.randrange(c - 1)
            out.append(("remove_cols", at, 1))
            c -= 1
        else:
            if rng.random() < 0.8:  # locality: stay near the active cell
                active_r = min(max(active_r + rng.randrange(-2, 3), 0),
                               r - 1)
                active_c = min(max(active_c + rng.randrange(-2, 3), 0),
                               c - 1)
            else:  # jump
                active_r, active_c = rng.randrange(r), rng.randrange(c)
            out.append(("set", active_r, active_c, i))
    return out


def directory_merge_script(n_ops: int, n_clients: int = 4, depth: int = 3,
                           fanout: int = 5, seed: int = 0):
    """Nested-subtree merge workload for SharedDirectory (BASELINE config
    #4): concurrent editors write keys into a tree of subdirectories
    (depth×fanout), with per-client working-directory locality, subtree
    creation, key deletes, and occasional whole-subtree clears.

    Returns [(client, path_tuple, command, *args)]."""
    rng = random.Random(seed)
    paths = [()]
    last = [()]
    for _ in range(depth):
        last = [p + (f"d{i}",) for p in last for i in range(fanout)]
        paths += last
    homes = [rng.choice(paths) for _ in range(n_clients)]
    out = []
    for i in range(n_ops):
        c = rng.randrange(n_clients)
        if rng.random() < 0.85:  # work near home
            path = homes[c]
        else:
            path = rng.choice(paths)
            homes[c] = path
        roll = rng.random()
        if roll < 0.80:
            out.append((c, path, "set", f"k{rng.randrange(32)}", i))
        elif roll < 0.90:
            out.append((c, path, "delete", f"k{rng.randrange(32)}"))
        elif roll < 0.97:
            sub = f"s{rng.randrange(8)}"
            out.append((c, path, "set_subdir_key", sub,
                        f"k{rng.randrange(8)}", i))
        else:
            out.append((c, path, "clear"))
    return out


def summary_stream(builder, seed: int, n_ops: int, seq_gap: int = 0,
                   gap_at: int = 4) -> list:
    """One document's HostOp stream for the summarize path's tests and
    golden, built through `builder` (an OpBuilder of either package: only
    its methods are called, so two builders given the same seeds assign the
    same op ids): a local client (1) with pending text and marker inserts,
    removes and annotates (seq DEV_UNASSIGNED) and acks of the oldest,
    remote inserts (some with props, some markers), removes and annotates
    from clients 2 and 3 at lagging perspectives, and an msn trailing the
    seq by 6, so removes below it are zambonied and removes above it stay
    in the collab window. With seq_gap the first sequenced op from index
    gap_at on is sequenced seq_gap later, so the document's live seqs can
    span more than int16.
    Positions are valid at each op's own perspective (tracked with the
    scalar oracle)."""
    from ..mergetree.constants import DEV_UNASSIGNED, UNASSIGNED_SEQ
    from ..mergetree.oracle import MergeTreeOracle

    rng = random.Random(seed)
    tree = MergeTreeOracle(local_client=1)
    ops, pending = [], []
    for i in range(n_ops):
        cur = tree.current_seq
        nxt = cur + 1 + (seq_gap if i >= gap_at else 0)
        msn = max(0, cur - 6)
        choice = rng.random()
        if pending and choice < 0.2:
            seq_gap = seq_gap if i < gap_at else 0
            kind, local = pending.pop(0)
            tree.ack(nxt)
            ack = {"insert": builder.ack_insert, "remove": builder.ack_remove,
                   "annotate": builder.ack_annotate}[kind]
            ops.append(ack(local, nxt, msn=msn))
            continue
        local_op = choice < 0.45
        client = 1 if local_op else rng.choice((2, 3))
        ref = cur if local_op else rng.randint(max(0, cur - 3), cur)
        seq = UNASSIGNED_SEQ if local_op else nxt
        dev_seq = DEV_UNASSIGNED if local_op else nxt
        op_msn = 0 if local_op else msn
        length = tree.get_length() if local_op else \
            tree.get_length(ref_seq=ref, client=client)
        roll = rng.random()
        if length == 0 or roll < 0.45:
            pos = rng.randint(0, length)
            props = {"b": rng.randint(0, 2)} if rng.random() < 0.3 else None
            if rng.random() < 0.15:
                tree.insert_marker(pos, ref, client, seq, props)
                op = builder.insert_marker(pos, ref, client, dev_seq, props,
                                           msn=op_msn)
            else:
                text = "".join(rng.choice("abcxyz")
                               for _ in range(rng.randint(1, 4)))
                tree.insert_text(pos, text, ref, client, seq, props)
                op = builder.insert_text(pos, text, ref, client, dev_seq,
                                         props, msn=op_msn)
            kind = "insert"
        else:
            start = rng.randint(0, length - 1)
            end = rng.randint(start + 1, min(length, start + 4))
            if roll < 0.8:
                tree.remove_range(start, end, ref, client, seq)
                op = builder.remove(start, end, ref, client, dev_seq,
                                    msn=op_msn)
                kind = "remove"
            else:
                props = {rng.choice("kq"): rng.choice((1, 2, None))}
                tree.annotate_range(start, end, props, ref, client, seq)
                op = builder.annotate(start, end, props, ref, client,
                                      dev_seq, msn=op_msn)
                kind = "annotate"
        if local_op:
            pending.append((kind, op.op_id if kind == "annotate"
                            else op.local_seq))
        else:
            seq_gap = seq_gap if i < gap_at else 0
            tree.update_seq(nxt)
        ops.append(op)
    return ops


def gen_traces_payloads(n_ops: int):
    """A payload table for gen_traces' ops (op id t of every document is
    op t): each id holds eight characters, of which an insert's new_len
    (1..8) is a prefix, so snapshot assembly can resolve the text."""
    from ..mergetree.constants import SEG_TEXT
    from ..mergetree.host import PayloadTable
    table = PayloadTable()
    for t in range(n_ops):
        table.add_insert(SEG_TEXT, "".join(chr(97 + (t + i) % 26)
                                           for i in range(8)))
    return table
