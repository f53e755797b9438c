"""A seeded generator of staged serving rings for the paged megakernel.

The sequencer of the JAX package (server/tpu_sequencer.py) stages each
fast window as ticket columns for every document lane plus, per page
group, merge columns and INSERT_RUN member columns, and per LWW bucket LWW
columns; a ring stacks K windows. `ServingFleet` builds exactly that
layout from a seed, numpy only, so the same ring can run through the JAX
package's serve_megakernel_keep and the port's serve_megakernel:

  ticket_xs [K, 4, B, T]            kind, client, cseq, refseq
  merge_xs  per group [K, 12, n_pad, Tm]   10 PackedOps columns, doc lane,
                                     ticket step (seq/msn left 0: the
                                     device takes them from the ticket)
  runs_xs   per group [K, 4, n_pad, Tm, RUN_K] or None   member length,
                                     op_id, doc lane, ticket step
  lww_xs    per bucket [K, 6, lanes, Tm]     kind, key, val, delta, doc
                                     lane, ticket step

The fleet: documents in classes of (count, merge ops per window, clients,
typing-burst probability, pre-seeded rows); one SharedString per document,
and one SharedMap (capacity `lww_capacity` keys) on the first `lww_docs`
documents. A class with `rows` > 0 is a hot document class: long-lived
shared documents whose `rows` live segments (1-4 characters each, visible
to every client) are written into the store before the first ring, so
that staging puts them in a page group of their own, above the fused
apply's capacity when `rows` is large. Window 0 of the first ring carries one JOIN per client (the
serving contract is require_join). The op mix is inserts, removes and
annotates, typing bursts of cursor-advancing inserts by one client at one
refSeq (packed into INSERT_RUN slots of RUN_MIN..RUN_K members as the
sequencer packs them), acks (the serving path sequences every op, so none
reaches the apply as pending-local; an ack exercises the ack phase), and
at small rates duplicate clientSeqs (dropped by the ticket pass), stale
and un-joined messages (nacked), and a duplicate inside a run (a
mispredicted run: the slot is voided and its lane flagged).

The generator tracks each document's visible length and simulates the
ticket pass, so every applied op is valid at its perspective: the only
lanes that may end with overflow set are those of mispredicted runs
(`StagedRing.expected_overflow`). Annotates are capped at the annotate
ring depth per document, so the ring cannot overflow either.

Pages follow the sequencer's rule: before a ring is staged, each document
grows to `count + 2 x ops` rows (`PagedMergeStore.ensure_rows`), and
documents group by their pow2 page count. Call `stage_ring(store)`, run
the ring, then `adopt_ring(store, ring, flat16_k)` to take the post
scalars before the next ring.

Between rings a store can also take per-document op streams directly, as
the JAX sequencer's MergeLaneStore._apply_paged applies a backlog:
`ServingFleet.backlog` generates sequenced streams valid at each
document's current length, and `stage_paged_groups` groups them by pow2
page count and packs each group for one apply_ops_paged (streams that fit
one T bucket) or one serve_paged_burst (K chunks at the widest T, K padded
to a power of two with all-NOOP chunks).
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..mergetree.constants import DEFAULT_T_BUCKETS
from ..mergetree.oppack import RUN_K, RUN_MIN, HostOp, OpKind, pack_ops
from ..mergetree.paging import pow2_pages
from ..mergetree.state import DEFAULT_ANNO_SLOTS
from ..server.lww_kernel import LwwKind
from ..server.serve_step import RingArgs, flat16_layout, paged_scalars_of
from ..server.ticket_kernel import MsgKind

TICKET_CLIENTS = 8      # ticket table width (the north-star's K)
LWW_OPS = 2             # LWW ops per SharedMap document per window


class DocClass(NamedTuple):
    count: int           # documents of this class
    ops: int             # merge ops per document per window
    clients: int         # clients that join each document
    burst: float         # probability that an op starts a typing burst
    rows: int = 0        # live rows pre-seeded before the first ring


class FleetSpec(NamedTuple):
    classes: Tuple[DocClass, ...]
    lww_docs: int          # documents (the first ones) with a SharedMap
    windows: int           # K, windows per ring
    steps: int             # T, ticket steps per window
    lww_capacity: int = 64
    dup_rate: float = 0.001
    nack_rate: float = 0.001
    mispredict_rate: float = 0.01   # per single-slot run

    @property
    def docs(self) -> int:
        return sum(c.count for c in self.classes)


# One serving ring of a 10,000-document partition: the sequencer's
# defaults (PAGE_ROWS 64, K=3, A=4, RUN_K 8, T from DEFAULT_T_BUCKETS, a
# ring depth from the burst grid) over the north-star fleet, with the
# keystroke / storm mix of the JAX bench's ragged megakernel fleet.
FULL_RING = FleetSpec(
    classes=(DocClass(9000, 2, 1, 0.0), DocClass(900, 8, 2, 0.3),
             DocClass(100, 16, 3, 0.8)),
    lww_docs=1000, windows=8, steps=16)

# A few documents in three classes, K=2: the CPU tests' size. T is 16
# because an INSERT_RUN slot needs RUN_MIN = 5 messages in one window.
SMALL_RING = FleetSpec(
    classes=(DocClass(5, 2, 2, 0.0), DocClass(2, 6, 2, 0.4),
             DocClass(1, 12, 2, 1.0)),
    lww_docs=3, windows=2, steps=16, lww_capacity=8, dup_rate=0.08,
    nack_rate=0.08, mispredict_rate=0.5)

# FULL_RING plus 64 hot documents of 3,500 live rows each: with 64-row
# pages they grow to count + 2 x ops <= 4,096 rows, a 64-page group
# (C = 4,096) above max_fused_capacity(3, 4) = 3,410 slots, so one ring
# launches the fused apply for the small groups and the scan apply for
# the hot group.
HOT_RING = FULL_RING._replace(
    classes=FULL_RING.classes + (DocClass(64, 16, 3, 0.8, rows=3500),))

# SMALL_RING plus one hot document of 1,900 rows: a 32-page group
# (C = 2,048 with 64-row pages), above max_fused_capacity(8, 16) = 1,705
# slots, the CPU tests' size of HOT_RING.
SMALL_HOT_RING = SMALL_RING._replace(
    classes=SMALL_RING.classes + (DocClass(1, 12, 2, 1.0, rows=1900),))


class StagedRing(NamedTuple):
    args: RingArgs                 # numpy arrays, serve_megakernel order
    keys: Tuple[List[tuple], ...]  # per group, the documents' store keys
    expected_overflow: Tuple[np.ndarray, ...]  # per group bool [n_pad]
    merge_lanes: Tuple[int, ...]   # per group n_pad
    lww_lanes: Tuple[int, ...]
    counts: Dict[str, int]         # messages / ops / run slots staged


def _bucket(n: int) -> int:
    for t in DEFAULT_T_BUCKETS:
        if n <= t:
            return t
    return -(-n // DEFAULT_T_BUCKETS[-1]) * DEFAULT_T_BUCKETS[-1]


class _Doc:
    """One document's generator state: its ticket table (a copy of the
    ticket pass's rules), visible length and annotate count."""

    def __init__(self, lane: int, cls: DocClass, capacity: int):
        self.lane = lane
        self.cls = cls
        self.capacity = capacity
        self.next_seq = 1
        self.min_seq = 0
        self.table: Dict[int, List[int]] = {}  # client -> [ref, cseq]
        self.cseq = [0] * (cls.clients + 1)    # next cseq per client
        self.length = 0
        self.annos = 0

    @property
    def seq(self) -> int:
        """The last assigned sequence number."""
        return self.next_seq - 1

    def ticket(self, kind: int, client: int, cseq: int, ref: int) -> int:
        """server/ticket_kernel._ticket_one with require_join for one
        message; returns its seq (0 = not sequenced)."""
        ticketed = False
        if kind == MsgKind.JOIN:
            if client in self.table or len(self.table) < self.capacity:
                self.table[client] = [self.next_seq - 1, 0]
            ticketed = True
        elif kind == MsgKind.OP:
            row = self.table.get(client)
            dup = row is not None and cseq <= row[1]
            nacked = (ref < self.min_seq and not dup) or row is None
            if not dup and not nacked:
                row[0], row[1] = ref, cseq
                ticketed = True
        if not ticketed:
            return 0
        seq = self.next_seq
        refs = [r for r, _ in self.table.values()]
        msn = self.min_seq if not refs else max(self.min_seq, min(refs))
        self.min_seq = min(msn, self.next_seq - 1)
        self.next_seq += 1
        return seq


class ServingFleet:
    """Generates the rings of one fleet, one after another, from a seed."""

    def __init__(self, spec: FleetSpec, seed: int = 0):
        self.spec = spec
        self.rng = random.Random(seed)
        self.docs: List[_Doc] = []
        for cls in spec.classes:
            for _ in range(cls.count):
                self.docs.append(_Doc(len(self.docs), cls, TICKET_CLIENTS))
        self.rings = 0
        self.next_op_id = 0
        self.next_val = 0
        self.seeded: Dict[int, np.ndarray] = {}  # lane -> row lengths
        for doc in self.docs:
            if doc.cls.rows:
                lengths = np.asarray([self.rng.randint(1, 4)
                                      for _ in range(doc.cls.rows)],
                                     np.int32)
                self.seeded[doc.lane] = lengths
                doc.length = int(lengths.sum())

    @property
    def lww_lanes(self) -> int:
        return pow2_pages(self.spec.lww_docs) if self.spec.lww_docs else 0

    # -- per-window message generation -----------------------------------
    def _merge_op(self, doc: _Doc) -> tuple:
        """(kind, pos1, pos2, new_len, local_seq) of one plain op, valid
        at the document's current length."""
        r = self.rng.random()
        if doc.length == 0 or r < 0.6:
            if doc.cls.burst == 0.0 and self.rng.random() < 0.8:
                pos = doc.length                      # typing at the end
            else:
                pos = self.rng.randint(0, doc.length)
            return OpKind.INSERT, pos, 0, self.rng.randint(1, 4), 0
        if r < 0.96 or doc.annos >= DEFAULT_ANNO_SLOTS:
            if r < 0.94 or doc.annos >= DEFAULT_ANNO_SLOTS:
                kind = OpKind.REMOVE
            else:
                kind = OpKind.ANNOTATE
                doc.annos += 1
            p = self.rng.randint(0, doc.length - 1)
            e = self.rng.randint(p + 1, min(doc.length, p + 8))
            return kind, p, e, 0, 0
        kind = OpKind.ACK_INSERT if r < 0.98 else OpKind.ACK_REMOVE
        return kind, 0, 0, 0, self.rng.randint(0, 2)

    def _window(self, doc: _Doc, first: bool):
        """One window of one document: a list of messages in ticket order,
        each (kind, client, cseq, ref, payload), payload one of
        ("merge", op tuple), ("run", [member op tuples], voided),
        ("lww", lww tuple) or None; and its merge op count."""
        spec, rng = self.spec, self.rng
        msgs = []
        if first:
            for c in range(doc.cls.clients):
                doc.ticket(MsgKind.JOIN, c, 0, 0)
                msgs.append((MsgKind.JOIN, c, 0, 0, None))
        budget = spec.steps - len(msgs)
        n_lww = LWW_OPS if doc.lane < spec.lww_docs else 0
        n_merge = max(0, min(doc.cls.ops, budget - n_lww))
        extra = budget - n_merge - n_lww   # room for duplicates and nacks
        merge_ops = 0
        while n_merge + n_lww > 0:
            if n_lww and rng.random() < n_lww / (n_merge + n_lww):
                msgs.append(self._lww_msg(doc))
                n_lww -= 1
                continue
            client = rng.randrange(doc.cls.clients)
            if n_merge >= RUN_MIN and rng.random() < doc.cls.burst:
                size = rng.randint(RUN_MIN, min(n_merge, 2 * RUN_K))
                msgs.extend(self._burst(doc, client, size))
                merge_ops += size
                n_merge -= size
                continue
            msg = self._plain_msg(doc, client)
            msgs.append(msg)
            merge_ops += 1
            n_merge -= 1
            if extra > 0 and rng.random() < spec.dup_rate:
                # a redelivered message: same clientSeq, dropped
                extra -= 1
                merge_ops += 1
                doc.ticket(MsgKind.OP, client, msg[2], msg[3])
                msgs.append(msg)
            if extra > 0 and rng.random() < spec.nack_rate:
                extra -= 1
                merge_ops += 1
                msgs.append(self._nacked_msg(doc))
        return msgs, merge_ops

    def _plain_msg(self, doc: _Doc, client: int):
        op = self._merge_op(doc)
        cseq = self._next_cseq(doc, client)
        ref = doc.seq
        op_id = self._op_id()
        if doc.ticket(MsgKind.OP, client, cseq, ref):
            self._track(doc, op)
        return (MsgKind.OP, client, cseq, ref, ("merge", op + (op_id,)))

    def _nacked_msg(self, doc: _Doc):
        """A stale refSeq (when the MSN has moved) or a client that never
        joined: nacked by the ticket pass, so its op never applies."""
        op = (OpKind.INSERT, 0, 0, 1, 0, self._op_id())
        if doc.min_seq > 0 and self.rng.random() < 0.5:
            client = 0
            cseq, ref = self._next_cseq(doc, client), doc.min_seq - 1
        else:
            client = doc.cls.clients            # never joins
            cseq, ref = self._next_cseq(doc, client), doc.seq
        assert doc.ticket(MsgKind.OP, client, cseq, ref) == 0
        return (MsgKind.OP, client, cseq, ref, ("merge", op))

    def _burst(self, doc: _Doc, client: int, size: int):
        """A typing burst: `size` cursor-advancing inserts by one client at
        one refSeq, packed as the sequencer packs them (slots of RUN_K, a
        remainder below RUN_MIN stays plain). A single-slot burst may carry
        a duplicate clientSeq: the mispredicted run."""
        ref = doc.seq
        pos = self.rng.randint(0, doc.length)
        members = []
        for _ in range(size):
            n = self.rng.randint(1, 2)
            members.append((OpKind.INSERT, pos, 0, n, 0, self._op_id()))
            pos += n
        bad = -1
        if size <= RUN_K and self.rng.random() < self.spec.mispredict_rate:
            bad = self.rng.randint(1, size - 1)
        msgs = []
        for j in range(0, size, RUN_K):
            chunk = members[j:j + RUN_K]
            seqs, cseqs = [], []
            for m in range(len(chunk)):
                if j + m == bad:   # reuses its predecessor's clientSeq
                    cseq = doc.cseq[client]
                else:
                    cseq = self._next_cseq(doc, client)
                cseqs.append(cseq)
                seqs.append(doc.ticket(MsgKind.OP, client, cseq, ref))
            if len(chunk) >= RUN_MIN:
                voided = not all(seqs)
                if not voided:
                    for op in chunk:
                        self._track(doc, op)
                for m, op in enumerate(chunk):
                    msgs.append((MsgKind.OP, client, cseqs[m], ref,
                                 ("run", chunk, voided) if m == 0 else
                                 ("member",)))
            else:
                for m, op in enumerate(chunk):
                    if seqs[m]:
                        self._track(doc, op)
                    msgs.append((MsgKind.OP, client, cseqs[m], ref,
                                 ("merge", op)))
        return msgs

    def _lww_msg(self, doc: _Doc):
        rng = self.rng
        client = rng.randrange(doc.cls.clients)
        r = rng.random()
        if r < 0.6:
            kind = LwwKind.SET
        elif r < 0.8:
            kind = LwwKind.DELETE
        elif r < 0.98:
            kind = LwwKind.ADD
        else:
            kind = LwwKind.CLEAR
        key = rng.randrange(max(1, self.spec.lww_capacity * 3 // 4))
        self.next_val += 1
        op = (kind, key, self.next_val, rng.randint(-5, 9))
        cseq, ref = self._next_cseq(doc, client), doc.seq
        doc.ticket(MsgKind.OP, client, cseq, ref)
        return (MsgKind.OP, client, cseq, ref, ("lww", op))

    def _next_cseq(self, doc: _Doc, client: int) -> int:
        doc.cseq[client] += 1
        return doc.cseq[client]

    def _op_id(self) -> int:
        self.next_op_id += 1
        return self.next_op_id

    @staticmethod
    def _track(doc: _Doc, op: tuple) -> None:
        """The visible length after an applied op (positions are valid, so
        an insert lands and a remove takes pos2 - pos1)."""
        kind, p1, p2, new_len = op[:4]
        if kind == OpKind.INSERT:
            doc.length += new_len
        elif kind == OpKind.REMOVE:
            doc.length -= p2 - p1

    # -- staging ------------------------------------------------------------
    def seed_store(self, store) -> None:
        """Write each hot document's pre-seeded rows into `store`
        (PagedMergeStore.put_row): `rows` segments at seq 0 (visible to
        every client, not removed), each with its own op id. stage_ring
        calls it before the first ring."""
        from ..mergetree.paging import pages_for
        from ..mergetree.state import make_state
        for lane, lengths in self.seeded.items():
            n = len(lengths)
            row = make_state(pages_for(n, store.page_rows) * store.page_rows,
                             store.anno_slots, store.overlap_slots,
                             device=store.device)
            first = self.next_op_id + 1
            self.next_op_id += n
            row.length[:n] = torch.from_numpy(lengths)
            row.ins_seq[:n] = 0
            row.ins_client[:n] = 0
            row.origin_op[:n] = torch.arange(first, first + n,
                                             dtype=torch.int32)
            store.put_row((lane,), row, n)

    def stage_ring(self, store) -> StagedRing:
        """Generate the next ring and stage it against `store` (a
        PagedMergeStore whose host counts are current): pre-grow every
        document, group by pow2 page count, and pack the columns. The
        first ring seeds the hot documents first (seed_store)."""
        spec = self.spec
        k_n, b, t_n = spec.windows, spec.docs, spec.steps
        first_ring = self.rings == 0
        if first_ring:
            self.seed_store(store)
        self.rings += 1
        ticket = np.zeros((k_n, 4, b, t_n), np.int32)
        per_doc = [[] for _ in range(b)]   # per doc: per window merge slots
        lww_rows = []
        n_msgs = n_merge = n_slots = 0
        voided_docs = set()
        for w in range(k_n):
            for doc in self.docs:
                msgs, merge_ops = self._window(doc, first_ring and w == 0)
                n_merge += merge_ops
                slots = []
                for t, (kind, client, cseq, ref, payload) in \
                        enumerate(msgs):
                    ticket[w, :, doc.lane, t] = (kind, client, cseq, ref)
                    n_msgs += 1
                    if payload is None:
                        continue
                    tag = payload[0]
                    if tag == "merge":
                        slots.append(("op", payload[1], client, ref, t))
                    elif tag == "run":
                        chunk, voided = payload[1], payload[2]
                        slots.append(("run", chunk, client, ref,
                                      list(range(t, t + len(chunk)))))
                        n_slots += 1
                        if voided:
                            voided_docs.add(doc.lane)
                    elif tag == "lww":
                        lww_rows.append((w, doc.lane, t) + payload[1])
                per_doc[doc.lane].append(slots)

        # pages: count + 2 x ops, then the pow2 page-count groups
        ops_of = [sum(1 if s[0] == "op" else len(s[1]) for ws in per_doc[d]
                      for s in ws) for d in range(b)]
        by_p2: Dict[int, List[int]] = {}
        for d in range(b):
            key = (d,)
            store.ensure_rows(key, store.counts.get(key, 0) + 2 * ops_of[d])
            by_p2.setdefault(pow2_pages(len(store.tables[key])),
                             []).append(d)
        groups = sorted(by_p2.items())
        page_ids, counts, mins, seqs, merge_xs, runs_xs = [], [], [], [], \
            [], []
        keys, expected, lanes = [], [], []
        for p2, docs in groups:
            n_pad = pow2_pages(len(docs))
            gkeys = [(d,) for d in docs]
            pids = np.full((n_pad, p2), -1, np.int32)
            pids[:len(docs)] = store.page_ids_array(gkeys, p2)
            sc = [np.zeros(n_pad, np.int32) for _ in range(3)]
            for arr, got in zip(sc, store.scalars_arrays(gkeys)):
                arr[:len(docs)] = got
            tm = _bucket(max(max((len(ws) for ws in per_doc[d]), default=1)
                             for d in docs))
            mx = np.zeros((k_n, 12, n_pad, tm), np.int32)
            has_runs = any(s[0] == "run" for d in docs for ws in per_doc[d]
                           for s in ws)
            rx = np.zeros((k_n, 4, n_pad, tm, RUN_K), np.int32) \
                if has_runs else None
            for lane, d in enumerate(docs):
                for w, ws in enumerate(per_doc[d]):
                    for j, slot in enumerate(ws):
                        self._stage_slot(mx[w, :, lane, j],
                                         None if rx is None else
                                         rx[w, :, lane, j], slot, d)
            exp = np.zeros(n_pad, bool)
            exp[:len(docs)] = [d in voided_docs for d in docs]
            page_ids.append(pids)
            counts.append(sc[0])
            mins.append(sc[1])
            seqs.append(sc[2])
            merge_xs.append(mx)
            runs_xs.append(rx)
            keys.append(gkeys)
            expected.append(exp)
            lanes.append(n_pad)

        lww_xs = []
        if spec.lww_docs:
            fill: Dict[tuple, int] = {}
            for w, d, *_rest in lww_rows:
                fill[(w, d)] = fill.get((w, d), 0) + 1
            lx = np.zeros((k_n, 6, self.lww_lanes,
                           _bucket(max(fill.values(), default=1))),
                          np.int32)
            lx[:, 1] = -1
            lx[:, 2] = -1
            fill.clear()
            for w, d, t, kind, key, val, delta in lww_rows:
                j = fill.get((w, d), 0)
                fill[(w, d)] = j + 1
                lx[w, :, d, j] = (kind, key, val, delta, d, t)
            lww_xs.append(lx)
        args = RingArgs(ticket_xs=ticket, page_ids=tuple(page_ids),
                        counts=tuple(counts), min_seqs=tuple(mins),
                        seqs=tuple(seqs), merge_xs=tuple(merge_xs),
                        lww_xs=tuple(lww_xs), runs_xs=tuple(runs_xs))
        return StagedRing(
            args=args, keys=tuple(keys), expected_overflow=tuple(expected),
            merge_lanes=tuple(lanes),
            lww_lanes=(self.lww_lanes,) if spec.lww_docs else (),
            counts={"messages": n_msgs, "merge_ops": n_merge,
                    "run_slots": n_slots, "lww_ops": len(lww_rows),
                    "mispredicted_docs": len(voided_docs)})

    def backlog(self, ops_of) -> Dict[tuple, List[HostOp]]:
        """Per-document sequenced op streams (HostOps keyed as the rings
        key documents), `ops_of(doc_class)` ops for each document: 70%
        inserts of 1-4 characters (typing at the end for a class without
        bursts, else anywhere), 30% removes of 1-8 characters, each from
        one of the document's clients at refSeq = seq - 1, with the
        collaboration window 8 ops behind (msn = seq - 8). The sequence
        numbers continue each document's ticketing, and every op is valid
        at the document's length, which the stream advances."""
        rng = self.rng
        out: Dict[tuple, List[HostOp]] = {}
        for doc in self.docs:
            n = ops_of(doc.cls)
            if not n:
                continue
            ops = []
            for _ in range(n):
                seq = doc.next_seq
                doc.next_seq += 1
                client = rng.randrange(doc.cls.clients)
                msn = max(0, seq - 8)
                if doc.length == 0 or rng.random() < 0.7:
                    pos = doc.length if doc.cls.burst == 0.0 and \
                        rng.random() < 0.8 else rng.randint(0, doc.length)
                    n_chars = rng.randint(1, 4)
                    ops.append(HostOp(OpKind.INSERT, seq, seq - 1, client,
                                      pos, 0, self._op_id(), n_chars, 0,
                                      msn))
                    doc.length += n_chars
                else:
                    p = rng.randint(0, doc.length - 1)
                    e = rng.randint(p + 1, min(doc.length, p + 8))
                    ops.append(HostOp(OpKind.REMOVE, seq, seq - 1, client,
                                      p, e, 0, 0, 0, msn))
                    doc.length -= e - p
            out[(doc.lane,)] = ops
        return out

    @staticmethod
    def _stage_slot(col, run, slot, d: int) -> None:
        """One merge slot's 12 columns (and RUN_K member columns)."""
        tag, op, client, ref, t = slot
        if tag == "op":
            kind, p1, p2, new_len, local_seq, op_id = op
            col[:] = (kind, 0, ref, client, p1, p2, op_id, new_len,
                      local_seq, 0, d, t)
            return
        members = op
        col[:] = (OpKind.INSERT_RUN, 0, ref, client, members[0][1], 0, -1,
                  sum(m[3] for m in members), 0, 0, d, t[-1])
        for sub, m in enumerate(members):
            run[:, sub] = (m[3], m[5], d, t[sub])


def adopt_ring(store, ring: StagedRing, flat16_last, stats: bool = False
               ) -> None:
    """Adopt the post-ring scalars of every document (the paged tail of
    the ring's last window, a numpy int16 vector) into the store, then
    free the pages wholly past each document's rows, as the sequencer
    does after every apply."""
    b, t = ring.args.ticket_xs.shape[2:]
    layout = flat16_layout(b, t, ring.merge_lanes, ring.lww_lanes,
                           paged_scalars=True, stats=stats)
    for keys, (cnt, mn, sq) in zip(
            ring.keys, paged_scalars_of(flat16_last, layout,
                                        ring.merge_lanes)):
        store.adopt_scalars(keys, cnt, mn, sq)
        store.release_trailing_many(keys)


class PagedGroup(NamedTuple):
    """One page group of a backlog, staged for one paged dispatch."""
    keys: List[tuple]        # the documents, in lane order
    page_ids: np.ndarray     # [n_pad, p2] int32, -1 = padding
    counts: np.ndarray       # [n_pad] int32 (padding lanes 0)
    min_seqs: np.ndarray
    seqs: np.ndarray
    ops: Dict[str, np.ndarray]   # PackedOps columns [n_pad, T], or
    #                              [K, n_pad, T] for a burst
    burst: bool              # serve_paged_burst (else apply_ops_paged)
    n_ops: int               # ops staged (padding excluded)


def stage_paged_groups(store, streams: Dict[tuple, List[HostOp]]
                       ) -> List[PagedGroup]:
    """Group per-document streams as the JAX sequencer's
    MergeLaneStore._apply_paged does: grow each document to count + 2 x
    ops rows, group by pow2 page count, pad each group's lanes to a power
    of two (page id -1, zero scalars, empty streams), take T from the
    bucket grid for the longest stream (at most the widest bucket), and
    stack K = ceil(longest / T) chunks, K padded to a power of two, when
    one T does not hold it. Groups come in ascending page count."""
    by_p2: Dict[int, List[tuple]] = {}
    for key, ops in streams.items():
        if not ops:
            continue
        store.ensure_rows(key, store.counts.get(key, 0) + 2 * len(ops))
        by_p2.setdefault(pow2_pages(len(store.tables[key])), []).append(key)
    groups = []
    for p2, keys in sorted(by_p2.items()):
        n, n_pad = len(keys), pow2_pages(len(keys))
        pids = np.full((n_pad, p2), -1, np.int32)
        pids[:n] = store.page_ids_array(keys, p2)
        sc = [np.zeros(n_pad, np.int32) for _ in range(3)]
        for arr, got in zip(sc, store.scalars_arrays(keys)):
            arr[:n] = got
        pad = [streams[k] for k in keys] + [[] for _ in range(n_pad - n)]
        longest = max(len(s) for s in pad)
        t = _bucket(min(longest, DEFAULT_T_BUCKETS[-1]))
        k_chunks = -(-longest // t)
        if k_chunks == 1:
            ops = pack_ops(pad, steps=t)
        else:
            chunks = [pack_ops([s[c * t:(c + 1) * t] for s in pad], steps=t)
                      for c in range(pow2_pages(k_chunks))]
            ops = {f: np.stack([c[f] for c in chunks]) for f in chunks[0]}
        groups.append(PagedGroup(keys, pids, sc[0], sc[1], sc[2], ops,
                                 k_chunks > 1, sum(len(s) for s in pad)))
    return groups


def adopt_paged_group(store, group: PagedGroup, counts, min_seqs,
                      seqs) -> None:
    """Take a paged dispatch's post scalars (numpy [n_pad]) into the store
    and free the pages wholly past each document's rows."""
    n = len(group.keys)
    store.adopt_scalars(group.keys, counts[:n], min_seqs[:n], seqs[:n])
    store.release_trailing_many(group.keys)


def ring_to_arrays(args: RingArgs) -> Dict[str, np.ndarray]:
    """A staged ring as a flat {name: array} dict (per-group entries
    suffixed _<g>; an absent runs_xs entry is left out)."""
    out = {"ticket_xs": np.asarray(args.ticket_xs)}
    for name in RingArgs._fields[1:]:
        for i, x in enumerate(getattr(args, name)):
            if x is not None:
                out[f"{name}_{i}"] = np.asarray(x)
    return out


def ring_from_arrays(arrays: Dict[str, np.ndarray]) -> RingArgs:
    """The inverse of ring_to_arrays."""
    groups = sum(1 for k in arrays if k.startswith("page_ids_"))
    buckets = sum(1 for k in arrays if k.startswith("lww_xs_"))
    fields = {"ticket_xs": arrays["ticket_xs"]}
    for name in RingArgs._fields[1:]:
        n = buckets if name == "lww_xs" else groups
        fields[name] = tuple(arrays.get(f"{name}_{i}") for i in range(n))
    return RingArgs(**fields)
