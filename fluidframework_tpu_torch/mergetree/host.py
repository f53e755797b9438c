"""Host glue for the device kernel: payload tables, state extraction and
snapshot assembly (a copy of fluidframework_tpu's mergetree/host.py; the
assembly functions read kernel.fetch_extracted's numpy arrays).

Device arrays hold only integers (SURVEY.md §7: "device holds offsets/lengths
into a host rope, not characters"). The host keeps:
- an op payload table: op_id -> inserted text / marker / annotate pset;
- client id interning (wire client ids are strings);
and reconstructs text and per-segment properties from (origin_op,
origin_off, length) plus each segment's annotate op-id ring.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .constants import DEV_UNASSIGNED, NON_COLLAB_CLIENT, SEG_MARKER, SEG_TEXT
from .oppack import HostOp, OpKind
from .state import DocState

GOD_CLIENT = NON_COLLAB_CLIENT  # sees exactly the acked state (ids are >= 0)

PENDING_ORDER_BASE = 2**40  # pending annotates resolve after all acked ones


@dataclass
class InsertPayload:
    kind: int  # SEG_TEXT | SEG_MARKER
    text: str = ""
    props: Optional[dict] = None


@dataclass
class AnnotatePayload:
    props: Dict[str, Any]
    seq: int  # updated on ack; pending = DEV_UNASSIGNED
    local_seq: int = 0  # pending local annotate's localSeq (round-trips
    # through bulk catch-up so pending groups rebuild after adoption)


_UNSET = object()  # lazy-cache sentinel (cached values include None)


class MergeArenaBlock:
    """One flush's merge payloads in columnar form (the native wire pump's
    output, server/pump.py): text lives as byte slices of a shared arena,
    props as raw JSON spans of the retained wire buffers. Payload OBJECTS
    materialize lazily (and are cached) only when extraction touches a
    segment — the admitted fast path never builds one.

    Column arrays are indexed by block-local op index; `seqs` (annotate
    LWW order) is assigned after the window's ticket results arrive."""

    __slots__ = ("base", "kinds", "marker", "textoff", "textlen", "arena",
                 "bufs", "pbuf", "pstart", "pend", "seqs", "_cache",
                 "lane_ids", "_ascii_text")

    # kinds codes (block-local)
    K_TEXT, K_MARKER, K_ANNOTATE, K_NONE, K_RUN, K_ITEMS = \
        0, 1, 2, 3, 4, 5

    def __init__(self, kinds, textoff, textlen, arena, bufs, pbuf, pstart,
                 pend):
        self.base = -1  # assigned by PayloadTable.add_block
        self.kinds = kinds
        self.textoff = textoff
        self.textlen = textlen
        self.arena = arena
        self.bufs = bufs
        self.pbuf = pbuf
        self.pstart = pstart
        self.pend = pend
        self.seqs = None  # [n] int32, annotate seq — set post-ticketing
        self._cache: Dict[int, Any] = {}
        self._ascii_text = _UNSET  # fast_text lazy tri-state

    def __len__(self) -> int:
        return len(self.kinds)

    def _props(self, i: int) -> Optional[dict]:
        s = int(self.pstart[i])
        if s < 0:
            return None
        raw = self.bufs[int(self.pbuf[i])][s:int(self.pend[i])]
        import json as _json
        decoded = _json.loads(raw)
        return decoded if isinstance(decoded, dict) else None

    def fast_text(self, op_id: int):
        """Whole-payload text for a plain props-free K_TEXT row via a
        ONE-SHOT decode of the shared arena — the serving fold touches
        every row of a lane once (then frees the ids), so resolve()'s
        per-row decode + object construct + cache never amortizes there.
        Returns None when the row needs the generic resolve (non-text
        kind, props present, or a non-ASCII arena where byte offsets
        stop being char offsets)."""
        i = op_id - self.base
        if int(self.kinds[i]) != self.K_TEXT or int(self.pstart[i]) >= 0:
            return None
        text_all = self._ascii_text
        if text_all is _UNSET:
            decoded = self.arena.decode("utf-8")
            text_all = decoded if len(decoded) == len(self.arena) else None
            self._ascii_text = text_all
        if text_all is None:
            return None
        off = int(self.textoff[i])
        return text_all[off:off + int(self.textlen[i])]

    def resolve(self, op_id: int):
        i = op_id - self.base
        hit = self._cache.get(i)
        if hit is not None:
            return hit
        kind = int(self.kinds[i])
        if kind == self.K_ANNOTATE:
            seq = int(self.seqs[i]) if self.seqs is not None else 0
            out = AnnotatePayload(self._props(i) or {}, seq)
        elif kind == self.K_MARKER:
            out = InsertPayload(SEG_MARKER, "", self._props(i))
        elif kind == self.K_TEXT:
            off = int(self.textoff[i])
            text = self.arena[off:off + int(self.textlen[i])].decode(
                "utf-8")
            out = InsertPayload(SEG_TEXT, text, self._props(i))
        elif kind == self.K_ITEMS:
            # Item-sequence insert: the raw wire span holds the value
            # array (sharedSequence SubSequence).
            import json as _json

            from .oracle import Items
            s = int(self.pstart[i])
            raw = self.bufs[int(self.pbuf[i])][s:int(self.pend[i])]
            out = InsertPayload(SEG_TEXT, Items(_json.loads(raw)), None)
        elif kind == self.K_RUN:
            # Matrix-axis stable-id run: the raw wire span holds the
            # encoded [nonce, counter, start, length] array.
            import json as _json

            from .runs import Run
            s = int(self.pstart[i])
            raw = self.bufs[int(self.pbuf[i])][s:int(self.pend[i])]
            out = InsertPayload(SEG_TEXT, Run.decode(_json.loads(raw)),
                                None)
        else:  # K_NONE: a remove's placeholder id — never referenced by
            # device state, but resolve defensively.
            out = InsertPayload(SEG_TEXT, "", None)
        self._cache[i] = out
        return out


@dataclass
class PayloadTable:
    """Global op_id -> payload registry shared by a batch of documents.

    Freed slots recycle through a free-list: the serving fold
    (tpu_sequencer MergeLaneStore) re-seeds a lane's payloads on every
    fold, and without reuse a long-lived document would retain
    O(doc_size x folds) superseded folded-run strings. Block
    registration (add_block) always appends — block ids must stay
    contiguous."""

    entries: List[Any] = field(default_factory=list)
    free_ids: List[int] = field(default_factory=list)

    def _add(self, payload) -> int:
        if self.free_ids:
            i = self.free_ids.pop()
            self.entries[i] = payload
            return i
        self.entries.append(payload)
        return len(self.entries) - 1

    def add_insert(self, kind: int, text: str = "",
                   props: Optional[dict] = None) -> int:
        return self._add(InsertPayload(kind, text, props))

    def add_annotate(self, props: Dict[str, Any], seq: int,
                     local_seq: int = 0) -> int:
        return self._add(AnnotatePayload(dict(props), seq, local_seq))

    def free(self, op_id: int) -> None:
        """Release a payload the caller proved unreferenced (e.g. a
        superseded fold generation). A stale read after free returns
        None and crashes loudly rather than resolving wrong content.
        Double-free crashes loudly too: a duplicate entry in free_ids
        would let _add hand ONE slot to TWO payloads — silent cross-lane
        text corruption, the worst possible failure mode for the
        fold-generation/block-ref id-ownership dance."""
        if self.entries[op_id] is None:  # not assert: must survive -O
            raise ValueError(f"double free of payload op_id {op_id}")
        self.entries[op_id] = None
        self.free_ids.append(op_id)

    def add_block(self, block: MergeArenaBlock) -> int:
        """Register a whole flush's payloads at once; returns the base
        op_id (block-local index i maps to op_id base + i)."""
        import itertools
        base = len(self.entries)
        block.base = base
        self.entries.extend(itertools.repeat(block, len(block)))
        return base

    def get(self, op_id: int):
        e = self.entries[op_id]
        if type(e) is MergeArenaBlock:
            return e.resolve(op_id)
        return e


class OpBuilder:
    """Builds HostOp streams for one document against a shared payload table."""

    def __init__(self, payloads: Optional[PayloadTable] = None):
        self.payloads = payloads if payloads is not None else PayloadTable()
        self.local_seq = 0

    def insert_text(self, pos: int, text: str, ref_seq: int, client: int,
                    seq: int, props: Optional[dict] = None,
                    msn: int = 0) -> HostOp:
        op_id = self.payloads.add_insert(SEG_TEXT, text, props)
        return self._insert(pos, len(text), op_id, ref_seq, client, seq, msn)

    def insert_marker(self, pos: int, ref_seq: int, client: int, seq: int,
                      props: Optional[dict] = None, msn: int = 0) -> HostOp:
        op_id = self.payloads.add_insert(SEG_MARKER, "", props)
        return self._insert(pos, 1, op_id, ref_seq, client, seq, msn)

    def _insert(self, pos, length, op_id, ref_seq, client, seq, msn) -> HostOp:
        local = 0
        if seq == DEV_UNASSIGNED:
            self.local_seq += 1
            local = self.local_seq
        return HostOp(kind=OpKind.INSERT, seq=seq, ref_seq=ref_seq,
                      client=client, pos1=pos, op_id=op_id, new_len=length,
                      local_seq=local, msn=msn)

    def remove(self, start: int, end: int, ref_seq: int, client: int,
               seq: int, msn: int = 0) -> HostOp:
        local = 0
        if seq == DEV_UNASSIGNED:
            self.local_seq += 1
            local = self.local_seq
        return HostOp(kind=OpKind.REMOVE, seq=seq, ref_seq=ref_seq,
                      client=client, pos1=start, pos2=end, local_seq=local,
                      msn=msn)

    def annotate(self, start: int, end: int, props: Dict[str, Any],
                 ref_seq: int, client: int, seq: int, msn: int = 0) -> HostOp:
        op_id = self.payloads.add_annotate(props, seq)
        local = 0
        if seq == DEV_UNASSIGNED:
            self.local_seq += 1
            local = self.local_seq
        return HostOp(kind=OpKind.ANNOTATE, seq=seq, ref_seq=ref_seq,
                      client=client, pos1=start, pos2=end, op_id=op_id,
                      local_seq=local, msn=msn)

    def ack_insert(self, local_seq: int, seq: int, msn: int = 0) -> HostOp:
        return HostOp(kind=OpKind.ACK_INSERT, seq=seq, ref_seq=0, client=-1,
                      local_seq=local_seq, msn=msn)

    def ack_remove(self, local_seq: int, seq: int, msn: int = 0) -> HostOp:
        return HostOp(kind=OpKind.ACK_REMOVE, seq=seq, ref_seq=0, client=-1,
                      local_seq=local_seq, msn=msn)

    def ack_annotate(self, op_id: int, seq: int, msn: int = 0) -> HostOp:
        """Annotate acks only stamp the payload's seq (LWW order); device
        state is unchanged, so the op is a device NOOP carrying the msn."""
        payload = self.payloads.get(op_id)
        payload.seq = seq
        return HostOp(kind=OpKind.NOOP, seq=seq, ref_seq=0, client=-1, msn=msn)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _to_host(state: DocState, doc: Optional[int]) -> dict:
    """One document's columns as host numpy arrays and its scalars as
    Python ints (one device-to-host copy per field)."""
    cols = {}
    for name in ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
                 "rem_local_seq", "rem_clients", "origin_op", "origin_off",
                 "anno"):
        arr = getattr(state, name).cpu().numpy()
        cols[name] = arr[doc] if doc is not None else arr
    for name in ("count", "min_seq", "seq", "overflow"):
        val = getattr(state, name).cpu().numpy()
        cols[name] = int(val[doc]) if doc is not None else int(val)
    return cols


def _visible_host(cols: dict, ref_seq: int, client: int) -> np.ndarray:
    n = cols["count"]
    ins_seq = cols["ins_seq"][:n]
    ins_client = cols["ins_client"][:n]
    rem_seq = cols["rem_seq"][:n]
    rem_clients = cols["rem_clients"][:n]
    inserted = (ins_seq <= ref_seq) | (ins_client == client)
    removed = (rem_seq <= ref_seq) | (rem_clients == client).any(axis=-1)
    return inserted & ~removed


class NonTextPayload(TypeError):
    """extract_text hit a non-str payload slice (items/run lane): the
    lane is not a text channel. A dedicated type so callers can treat
    it as "not text" WITHOUT masking unrelated TypeErrors as such."""


def extract_text(state: DocState, payloads: PayloadTable,
                 ref_seq: Optional[int] = None, client: int = GOD_CLIENT,
                 doc: Optional[int] = None,
                 marker_char: str = "￼") -> str:
    """Document text at a perspective (defaults: latest acked, god view).
    Raises NonTextPayload when the lane holds non-str payloads."""
    cols = _to_host(state, doc)
    if ref_seq is None:
        ref_seq = cols["seq"]
    vis = _visible_host(cols, ref_seq, client)
    n = cols["count"]
    parts = []
    for i in range(n):
        if not vis[i]:
            continue
        payload = payloads.get(int(cols["origin_op"][i]))
        if payload.kind == SEG_MARKER:
            parts.append(marker_char)
        else:
            off = int(cols["origin_off"][i])
            part = payload.text[off:off + int(cols["length"][i])]
            if not isinstance(part, str):
                raise NonTextPayload(type(part).__name__)
            parts.append(part)
    return "".join(parts)


def extract_segments(state: DocState, payloads: PayloadTable,
                     ref_seq: Optional[int] = None, client: int = GOD_CLIENT,
                     doc: Optional[int] = None) -> List[Tuple[str, Optional[dict]]]:
    """Visible (text, resolved props) pairs in order, for conformance checks
    and summaries. Props resolve per key by annotate seq order (pending local
    annotates count as newest, preserving pending-shadow semantics)."""
    cols = _to_host(state, doc)
    if ref_seq is None:
        ref_seq = cols["seq"]
    vis = _visible_host(cols, ref_seq, client)
    out = []
    for i in range(cols["count"]):
        if not vis[i]:
            continue
        payload = payloads.get(int(cols["origin_op"][i]))
        if payload.kind == SEG_MARKER:
            text = "￼"
        else:
            off = int(cols["origin_off"][i])
            text = payload.text[off:off + int(cols["length"][i])]
        props = dict(payload.props) if payload.props else {}
        # Collect the annotate ring (newest first); order by effective seq
        # (pending local annotates rank after everything acked, in
        # submission order, which is their op_id creation order — only own
        # pendings can coexist on a replica).
        chain = []
        for op_id in cols["anno"][i]:
            op_id = int(op_id)
            if op_id < 0:
                continue
            ann = payloads.get(op_id)
            seq = ann.seq
            if seq == DEV_UNASSIGNED:
                seq = PENDING_ORDER_BASE + op_id
            chain.append((seq, ann.props))
        chain.sort(key=lambda kv: kv[0])  # ascending: later seq wins per key
        for _, pset in chain:
            for key, value in pset.items():
                if value is None:
                    props.pop(key, None)
                else:
                    props[key] = value
        out.append((text, props or None))
    return out


def assemble_entries(packed, payloads: PayloadTable, doc: int,
                     min_seq: int = 0) -> List[dict]:
    """Full-fidelity snapshot entries for one document from the batched
    device extraction (kernel.extract_visible_batched output): only the
    live rows are touched — the device already did the mask + prefix-sum
    packing. Entries keep contended insert/remove metadata above min_seq
    (oracle.snapshot_segments format), so the snapshot loads mid-window."""
    from .constants import DEV_NO_REMOVE

    (origin_op, origin_off, length, anno, ins_seq, ins_client,
     rem_seq, rem_client, counts) = packed
    out: List[dict] = []
    for i in range(int(counts[doc])):
        payload = payloads.get(int(origin_op[doc, i]))
        entry: Dict[str, Any] = {"kind": payload.kind}
        if payload.kind == SEG_MARKER:
            entry["text"] = ""
        else:
            off = int(origin_off[doc, i])
            entry["text"] = payload.text[off:off + int(length[doc, i])]
        props = dict(payload.props) if payload.props else {}
        chain = []
        for op_id in anno[doc, i]:
            op_id = int(op_id)
            if op_id < 0:
                continue
            ann = payloads.get(op_id)
            seq = ann.seq
            if seq == DEV_UNASSIGNED:
                seq = PENDING_ORDER_BASE + op_id
            chain.append((seq, ann.props))
        chain.sort(key=lambda kv: kv[0])
        for _, pset in chain:
            for key, value in pset.items():
                if value is None:
                    props.pop(key, None)
                else:
                    props[key] = value
        if props:
            entry["props"] = props
        if int(ins_seq[doc, i]) > min_seq:
            entry["seq"] = int(ins_seq[doc, i])
            entry["client"] = int(ins_client[doc, i])
        if int(rem_seq[doc, i]) != DEV_NO_REMOVE:
            entry["removedSeq"] = int(rem_seq[doc, i])
            entry["removedClient"] = int(rem_client[doc, i])
        out.append(entry)
    return out


def assemble_snapshot(packed, payloads: PayloadTable, doc: int,
                      min_seq: int, seq: int,
                      chunk_chars: int = 10000) -> dict:
    """One document's chunked snapshot dict {"header", "chunks"} from a
    batched device extraction — the host half of a summarize pass
    (assemble_entries + chunk_entries + the SnapshotV1-shaped header,
    snapshotV1.ts:33-40). Chunks arrive wire-encoded (JSON-safe): Items
    and Run payloads encode via runs.encode_entry_payloads so the
    materialized-snapshot writer can json.dumps them directly. The
    summarize blob cache (server MergeLaneStore) stores exactly this
    dict per (lane, summarize epoch)."""
    from .constants import SEG_MARKER
    from .runs import encode_entry_payloads

    entries = assemble_entries(packed, payloads, doc, min_seq=min_seq)
    total = sum((1 if e["kind"] == SEG_MARKER else len(e["text"]))
                for e in entries if e.get("removedSeq") is None)
    chunks = [encode_entry_payloads(c)
              for c in chunk_entries(entries, chunk_chars)]
    return {
        "header": {
            "sequenceNumber": seq,
            "minimumSequenceNumber": min_seq,
            "totalLength": total,
            "chunkCount": len(chunks),
        },
        "chunks": chunks,
    }


def chunk_entries(entries: List[dict], chunk_chars: int = 10000
                  ) -> List[List[dict]]:
    """Split snapshot entries into body chunks of ~chunk_chars characters
    (reference SnapshotV1 header + 10k-char chunks, snapshotV1.ts:33-40)."""
    chunks: List[List[dict]] = []
    cur: List[dict] = []
    size = 0
    for e in entries:
        cur.append(e)
        size += max(1, len(e.get("text") or ""))
        if size >= chunk_chars:
            chunks.append(cur)
            cur = []
            size = 0
    if cur or not chunks:
        chunks.append(cur)
    return chunks


def flatten_snapshot_content(snap: dict) -> List[Tuple[str, tuple]]:
    """Flatten an assembled snapshot (assemble_snapshot's {"header",
    "chunks"} dict) to its per-char (char, resolved props) stream of
    VISIBLE content. Segmentation is an engine-internal artifact — the
    bucketed store's folds coalesce acked rows, the paged store's
    zamboni runs on its own page-granular cadence — so two conformant
    engines may chunk the same document differently while the flattened
    content must match to the character (the cross-engine bar
    `bench.py paged-smoke` and the paged conformance tests apply, the
    same normalization tests/test_kernel.py's flatten_runs uses against
    the oracle)."""
    out: List[Tuple[str, tuple]] = []
    for chunk in snap["chunks"]:
        for e in chunk:
            if e.get("removedSeq") is not None:
                continue
            text = e.get("text") or ("￼" if e.get("kind") != SEG_TEXT
                                     else "")
            props = tuple(sorted((e.get("props") or {}).items()))
            out.extend((ch, props) for ch in text)
    return out
