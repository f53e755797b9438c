"""Scalar merge-tree engine: the semantic oracle + single-threaded baseline
(a copy of fluidframework_tpu's mergetree/oracle.py; pure host Python).

Mirrors the reference merge-tree's *semantics* (not its B-tree design):
a flat list of segments in document order, each carrying insert/remove
metadata versioned by (sequenceNumber, clientId), so any perspective
(refSeq, clientId) sees a consistent view.

Reference semantics implemented (file:line cites into the reference
FluidFramework repository):
- visibility: a segment is visible at (refSeq, clientId) iff inserted
  (ins_seq <= refSeq or own client) and not removed (rem_seq <= refSeq or
  removed by own client, incl. overlap clients) —
  packages/dds/merge-tree/src/mergeTree.ts:1586,1684.
- insert tie-breaking at a boundary: skip tombstones removed at-or-before
  refSeq, land before the first other invisible acked segment ("newer
  segments come before older"), remote inserts skip unacked local segments
  — mergeTree.ts:2248-2276 (breakTie), :2345 (insertingWalk).
- overlapping removes: earliest acked remove wins; a pending local remove is
  overwritten by a remote remove; overlap clients are recorded for
  visibility — mergeTree.ts markRangeRemoved (:2607).
- pending ops + ack: local ops enqueue segment groups; acks dequeue FIFO and
  assign sequence numbers — mergeTree.ts:1893 (ackPendingSegment), :1921.
- annotate: per-key LWW with pending-local shadowing of remote writes
  (PropertiesManager semantics, null deletes a key).
- zamboni: once minSeq passes, removed segments are freed and adjacent
  compatible segments coalesce — mergeTree.ts:1422 (zamboni), :1289 (scour).

The walk is O(n) per op; that is fine for the oracle's role (conformance +
baseline measurement). The device kernels replace the walk with masked
prefix sums over the same state, batched over documents.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .constants import (
    SEG_MARKER,
    SEG_TEXT,
    TEXT_SEGMENT_GRANULARITY,
    UNASSIGNED_SEQ,
    UNIVERSAL_SEQ,
)


@dataclass
class Segment:
    kind: int  # SEG_TEXT | SEG_MARKER
    text: str = ""  # text payload (markers: empty, length 1)
    ins_seq: int = UNIVERSAL_SEQ
    ins_client: int = -1
    local_seq: Optional[int] = None  # set while insert pending
    rem_seq: Optional[int] = None    # None = not removed; UNASSIGNED_SEQ = pending
    rem_client: Optional[int] = None
    rem_local_seq: Optional[int] = None
    rem_overlap: List[int] = field(default_factory=list)
    props: Optional[Dict[str, Any]] = None
    pending_props: Optional[Dict[str, int]] = None  # key -> pending local count
    uid: int = 0
    # Local references anchored on this segment (reference
    # merge-tree/src/localReference.ts; populated lazily).
    local_refs: Optional[List["LocalReference"]] = None

    @property
    def length(self) -> int:
        return 1 if self.kind == SEG_MARKER else len(self.text)

    def clone_meta_for_split(self, uid: int, text: str) -> "Segment":
        return Segment(
            kind=self.kind,
            text=text,
            ins_seq=self.ins_seq,
            ins_client=self.ins_client,
            local_seq=self.local_seq,
            rem_seq=self.rem_seq,
            rem_client=self.rem_client,
            rem_local_seq=self.rem_local_seq,
            rem_overlap=list(self.rem_overlap),
            props=dict(self.props) if self.props else None,
            pending_props=dict(self.pending_props) if self.pending_props else None,
            uid=uid,
        )


class Items:
    """A sliceable run of JSON values: the segment payload for the
    item-sequence DDSes (reference sequence/src/sharedSequence.ts
    SubSequence<T> — SharedNumberSequence / SharedObjectSequence carry
    arrays of values instead of text)."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = tuple(values)

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Items(self.values[key])
        return self.values[key]

    def __eq__(self, other) -> bool:
        return isinstance(other, Items) and self.values == other.values

    def __repr__(self) -> str:
        return f"Items({list(self.values)!r})"

    def encode(self) -> list:
        return list(self.values)


# Reference-type flags (reference merge-tree/src/ops.ts ReferenceType).
REF_SIMPLE = 0
REF_SLIDE_ON_REMOVE = 1
REF_STAY_ON_REMOVE = 2


@dataclass
class LocalReference:
    """A position anchored to (segment, offset) that tracks edits
    (reference localReference.ts:362 LoC). Detached refs (segment=None)
    pin to end-of-document."""

    segment: Optional[Segment]
    offset: int = 0
    ref_type: int = REF_SLIDE_ON_REMOVE
    properties: Optional[Dict[str, Any]] = None


class MergeTreeOracle:
    """One document's segment state, host-side, scalar."""

    def __init__(self, local_client: int = -1,
                 granularity: int = TEXT_SEGMENT_GRANULARITY):
        self.segments: List[Segment] = []
        self.local_client = local_client
        self.min_seq = 0
        self.current_seq = 0
        self.local_seq_counter = 0
        self.granularity = granularity
        self._uid_counter = 0
        # FIFO of pending local op segment groups (reference pendingSegments).
        self.pending_groups: List[Tuple[str, List[Segment], dict]] = []
        # Local-perspective visible length, maintained incrementally (the
        # reference's root partial-lengths cache role for the hot
        # getLength() call): at the local perspective a segment is visible
        # iff rem_seq is None — all acked inserts are <= current_seq (the
        # caller advances seq before applying), own pending inserts are
        # visible, and foreign pending segments never exist in a replica.
        self._local_len = 0

    # ------------------------------------------------------------------
    # visibility
    # ------------------------------------------------------------------
    def _inserted_at(self, seg: Segment, ref_seq: int, client: int,
                     local_seq: Optional[int] = None) -> bool:
        if seg.ins_seq != UNASSIGNED_SEQ and seg.ins_seq <= ref_seq:
            return True
        if seg.ins_client == client:
            if local_seq is not None and seg.local_seq is not None:
                return seg.local_seq <= local_seq
            return True
        return False

    def _removed_at(self, seg: Segment, ref_seq: int, client: int,
                    local_seq: Optional[int] = None) -> bool:
        if seg.rem_seq is None:
            return False
        if seg.rem_seq != UNASSIGNED_SEQ and seg.rem_seq <= ref_seq:
            return True
        if seg.rem_client == client or client in seg.rem_overlap:
            if local_seq is not None and seg.rem_local_seq is not None:
                return seg.rem_local_seq <= local_seq
            return True
        return False

    def visible_length(self, seg: Segment, ref_seq: int, client: int,
                       local_seq: Optional[int] = None) -> int:
        # _inserted_at/_removed_at inlined: this predicate dominates every
        # walk (profile: ~5M calls per 2k-op session before inlining).
        ins = seg.ins_seq
        if not (ins != UNASSIGNED_SEQ and ins <= ref_seq):
            if seg.ins_client != client:
                return 0
            if local_seq is not None and seg.local_seq is not None \
                    and seg.local_seq > local_seq:
                return 0
        rem = seg.rem_seq
        if rem is not None:
            if rem != UNASSIGNED_SEQ and rem <= ref_seq:
                return 0
            if seg.rem_client == client or client in seg.rem_overlap:
                if local_seq is None or seg.rem_local_seq is None \
                        or seg.rem_local_seq <= local_seq:
                    return 0
        text = seg.text
        return len(text) if seg.kind == SEG_TEXT else 1

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def get_length(self, ref_seq: Optional[int] = None,
                   client: Optional[int] = None) -> int:
        if ref_seq is None and client is None:
            return self._local_len  # O(1) hot path (local perspective)
        ref_seq = self.current_seq if ref_seq is None else ref_seq
        client = self.local_client if client is None else client
        return sum(self.visible_length(s, ref_seq, client) for s in self.segments)

    def verify_local_length(self) -> None:
        """Self-check mode (reference PartialSequenceLengths.options.verify,
        partialLengths.ts:64-67): the incremental counter must equal the
        full local-perspective reduction."""
        actual = sum(self.visible_length(s, self.current_seq,
                                         self.local_client)
                     for s in self.segments)
        if actual != self._local_len:
            raise AssertionError(
                f"local length cache {self._local_len} != walked {actual}")

    def get_text(self, ref_seq: Optional[int] = None,
                 client: Optional[int] = None) -> str:
        ref_seq = self.current_seq if ref_seq is None else ref_seq
        client = self.local_client if client is None else client
        parts = []
        for s in self.segments:
            if self.visible_length(s, ref_seq, client) > 0:
                parts.append(s.text if s.kind == SEG_TEXT else "￼")
        return "".join(parts)

    def get_containing_segment(self, pos: int, ref_seq: int, client: int
                               ) -> Tuple[Optional[int], int]:
        """(segment index, offset) of the visible position at a perspective."""
        acc = 0
        for i, s in enumerate(self.segments):
            vlen = self.visible_length(s, ref_seq, client)
            if acc + vlen > pos:
                return i, pos - acc
            acc += vlen
        return None, 0

    def get_position(self, seg_index: int, ref_seq: int, client: int) -> int:
        return sum(self.visible_length(self.segments[i], ref_seq, client)
                   for i in range(seg_index))

    # ------------------------------------------------------------------
    # pending groups
    # ------------------------------------------------------------------
    def _new_pending_group(self, kind: str, **extra) -> List[Segment]:
        """Allocate the next localSeq and enqueue a pending op group carrying
        it (the regenerate position cap depends on this metadata)."""
        self.local_seq_counter += 1
        group: List[Segment] = []
        extra["local_seq"] = self.local_seq_counter
        self.pending_groups.append((kind, group, extra))
        return group

    # ------------------------------------------------------------------
    # splitting
    # ------------------------------------------------------------------
    def _next_uid(self) -> int:
        self._uid_counter += 1
        return self._uid_counter

    def _split(self, index: int, offset: int) -> None:
        """Split segments[index] at payload offset (0 < offset < length).
        Works for any sliceable payload (str text, matrix permutation runs)."""
        seg = self.segments[index]
        assert 0 < offset < seg.length and seg.kind != SEG_MARKER
        right = seg.clone_meta_for_split(self._next_uid(), seg.text[offset:])
        seg.text = seg.text[:offset]
        self.segments.insert(index + 1, right)
        # A pending segment group must track both halves (reference: split
        # segments join the parent's segment groups).
        for _, group, _ in self.pending_groups:
            if seg in group:
                group.insert(group.index(seg) + 1, right)
        # Local refs at/past the split point move to the right half.
        if seg.local_refs:
            stay, move = [], []
            for ref in seg.local_refs:
                (move if ref.offset >= offset else stay).append(ref)
            seg.local_refs = stay or None
            for ref in move:
                ref.segment = right
                ref.offset -= offset
            if move:
                right.local_refs = move

    def _ensure_boundary(self, pos: int, ref_seq: int, client: int) -> None:
        idx, off = self.get_containing_segment(pos, ref_seq, client)
        if idx is not None and off > 0:
            self._split(idx, off)

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def _find_insert_index(self, pos: int, ref_seq: int, client: int
                           ) -> Tuple[int, int]:
        """Walk in document order accumulating visible lengths; apply the
        reference breakTie discipline at the boundary (mergeTree.ts:2248).

        Returns (segment index, offset): offset > 0 means the insert lands
        strictly inside that segment (caller splits); offset == 0 means
        insert immediately before that index.
        """
        local = client == self.local_client
        acc = 0
        i = 0
        n = len(self.segments)
        # Advance to the boundary at pos (or into the containing segment).
        while i < n and acc < pos:
            vlen = self.visible_length(self.segments[i], ref_seq, client)
            if acc + vlen > pos:
                return i, pos - acc  # strictly inside segment i
            acc += vlen
            i += 1
        if acc < pos:
            raise IndexError(f"insert pos {pos} beyond visible length {acc}")
        # Boundary: scan the run of invisible segments applying breakTie.
        while i < n:
            seg = self.segments[i]
            vlen = self.visible_length(seg, ref_seq, client)
            if vlen > 0:
                return i, 0  # insert before the next visible segment
            # Tombstone removed at-or-before refSeq: skip over it.
            if seg.rem_seq is not None and seg.rem_seq != UNASSIGNED_SEQ \
                    and seg.rem_seq <= ref_seq:
                i += 1
                continue
            if local:
                return i, 0  # local change sees everything: land here
            if seg.ins_seq != UNASSIGNED_SEQ:
                return i, 0  # newer (this op) goes before older concurrent
            i += 1  # unacked pending segment of another client: skip
        return n, 0

    def insert(self, pos: int, seg: Segment, ref_seq: int, client: int,
               seq: int) -> Segment:
        """Insert one segment at pos under perspective (ref_seq, client).

        seq == UNASSIGNED_SEQ means a pending local op (enqueues a pending
        group); otherwise a sequenced op being applied.
        """
        idx, off = self._find_insert_index(pos, ref_seq, client)
        if off > 0:
            self._split(idx, off)
            idx += 1
        seg.ins_seq = seq
        seg.ins_client = client
        seg.uid = self._next_uid()
        if seq == UNASSIGNED_SEQ:
            self._new_pending_group("insert").append(seg)
            seg.local_seq = self.local_seq_counter
        self.segments.insert(idx, seg)
        self._local_len += seg.length  # new segments are never removed
        return seg

    def insert_text(self, pos: int, text: str, ref_seq: int, client: int,
                    seq: int, props: Optional[dict] = None) -> Segment:
        seg = Segment(kind=SEG_TEXT, text=text,
                      props=dict(props) if props else None)
        return self.insert(pos, seg, ref_seq, client, seq)

    def insert_marker(self, pos: int, ref_seq: int, client: int, seq: int,
                      props: Optional[dict] = None) -> Segment:
        seg = Segment(kind=SEG_MARKER, props=dict(props) if props else None)
        return self.insert(pos, seg, ref_seq, client, seq)

    def insert_items(self, pos: int, values, ref_seq: int, client: int,
                     seq: int, props: Optional[dict] = None) -> Segment:
        seg = Segment(kind=SEG_TEXT, text=Items(values),
                      props=dict(props) if props else None)
        return self.insert(pos, seg, ref_seq, client, seq)

    # ------------------------------------------------------------------
    # remove
    # ------------------------------------------------------------------
    def remove_range(self, start: int, end: int, ref_seq: int, client: int,
                     seq: int) -> None:
        """Mark [start, end) removed under perspective (ref_seq, client)
        (reference markRangeRemoved, mergeTree.ts:2607)."""
        if end <= start:
            return
        self._ensure_boundary(start, ref_seq, client)
        self._ensure_boundary(end, ref_seq, client)
        pending_group: Optional[List[Segment]] = None
        acc = 0
        for seg in list(self.segments):
            vlen = self.visible_length(seg, ref_seq, client)
            if vlen == 0:
                continue
            seg_start, seg_end = acc, acc + vlen
            acc = seg_end
            if seg_end <= start:
                continue
            if seg_start >= end:
                break
            # Fully covered (boundaries were pre-split).
            if seg.rem_seq is not None:
                # Overlapping remove.
                if seg.rem_seq == UNASSIGNED_SEQ:
                    # Pending local remove overwritten by this acked remove
                    # ("replace because comes later", mergeTree.ts:2627).
                    prior_client = seg.rem_client
                    seg.rem_seq = seq
                    seg.rem_client = client
                    seg.rem_local_seq = None
                    if prior_client is not None and prior_client != client \
                            and prior_client not in seg.rem_overlap:
                        seg.rem_overlap.append(prior_client)
                else:
                    # Keep the earlier sequence number; record overlap client.
                    if client not in seg.rem_overlap and client != seg.rem_client:
                        seg.rem_overlap.append(client)
            else:
                seg.rem_seq = seq
                seg.rem_client = client
                self._local_len -= seg.length  # None -> removed transition
                if seq == UNASSIGNED_SEQ:
                    if pending_group is None:
                        pending_group = self._new_pending_group("remove")
                    seg.rem_local_seq = self.local_seq_counter
                    pending_group.append(seg)

    # ------------------------------------------------------------------
    # annotate
    # ------------------------------------------------------------------
    def get_range_property_deltas(self, start: int, end: int,
                                  keys) -> List[Tuple[int, int, dict]]:
        """Per-span snapshot of the CURRENT values of `keys` over visible
        [start, end) — captured before an annotate so undo can restore them
        (reference: propertyDeltas on the merge-tree delta event)."""
        out: List[Tuple[int, int, dict]] = []
        acc = 0
        for seg in self.segments:
            vlen = self.visible_length(seg, self.current_seq,
                                       self.local_client)
            if vlen == 0:
                continue
            seg_start, seg_end = acc, acc + vlen
            acc = seg_end
            if seg_end <= start:
                continue
            if seg_start >= end:
                break
            old = {k: (seg.props or {}).get(k) for k in keys}
            span = (max(seg_start, start), min(seg_end, end), old)
            if out and out[-1][1] == span[0] and out[-1][2] == span[2]:
                out[-1] = (out[-1][0], span[1], out[-1][2])  # merge runs
            else:
                out.append(span)
        return out

    def annotate_range(self, start: int, end: int, props: Dict[str, Any],
                       ref_seq: int, client: int, seq: int) -> None:
        """Set properties on visible segments in [start, end); per-key LWW
        with pending-local shadowing (reference annotateRange + Properties-
        Manager; null value deletes the key)."""
        if end <= start:
            return
        self._ensure_boundary(start, ref_seq, client)
        self._ensure_boundary(end, ref_seq, client)
        local_pending = seq == UNASSIGNED_SEQ
        pending_group: Optional[List[Segment]] = None
        acc = 0
        for seg in self.segments:
            vlen = self.visible_length(seg, ref_seq, client)
            if vlen == 0:
                continue
            seg_start, seg_end = acc, acc + vlen
            acc = seg_end
            if seg_end <= start:
                continue
            if seg_start >= end:
                break
            self._apply_props(seg, props, local_pending,
                              remote=(client != self.local_client))
            if local_pending:
                if pending_group is None:
                    pending_group = self._new_pending_group(
                        "annotate", props=props)
                pending_group.append(seg)

    def _apply_props(self, seg: Segment, props: Dict[str, Any],
                     local_pending: bool, remote: bool) -> None:
        if seg.props is None:
            seg.props = {}
        if local_pending and seg.pending_props is None:
            seg.pending_props = {}
        for key, value in props.items():
            if remote and seg.pending_props and seg.pending_props.get(key, 0) > 0:
                continue  # pending local write shadows remote ones until ack
            if local_pending:
                seg.pending_props[key] = seg.pending_props.get(key, 0) + 1
            if value is None:
                seg.props.pop(key, None)
            else:
                seg.props[key] = value
        if not seg.props:
            seg.props = None

    # ------------------------------------------------------------------
    # ack / sequenced bookkeeping
    # ------------------------------------------------------------------
    def ack(self, seq: int) -> None:
        """Ack the oldest pending local op group (reference
        ackPendingSegment, mergeTree.ts:1893)."""
        if not self.pending_groups:
            raise ValueError("ack with no pending ops")
        kind, group, extra = self.pending_groups.pop(0)
        for seg in group:
            if kind == "insert":
                if seg.ins_seq == UNASSIGNED_SEQ:
                    seg.ins_seq = seq
                    seg.local_seq = None
            elif kind == "remove":
                if seg.rem_seq == UNASSIGNED_SEQ:
                    seg.rem_seq = seq
                    seg.rem_local_seq = None
                # else: an earlier remote remove won; keep its seq.
            elif kind == "annotate":
                if seg.pending_props:
                    for key in extra["props"]:
                        if seg.pending_props.get(key, 0) > 0:
                            seg.pending_props[key] -= 1
        self.update_seq(seq)

    def update_seq(self, seq: int) -> None:
        if seq > self.current_seq:
            self.current_seq = seq

    # ------------------------------------------------------------------
    # collab window / zamboni
    # ------------------------------------------------------------------
    def set_min_seq(self, min_seq: int) -> None:
        if min_seq < self.min_seq:
            raise ValueError(f"minSeq moved backwards: {min_seq} < {self.min_seq}")
        self.min_seq = min_seq
        self.zamboni()

    def zamboni(self) -> None:
        """Free segments removed at-or-before minSeq and coalesce adjacent
        fully-acked compatible text segments (reference mergeTree.ts:1422,
        scour/pack :1289-:1468)."""
        out: List[Segment] = []
        pending_slide: List[LocalReference] = []
        for seg in self.segments:
            if seg.rem_seq is not None and seg.rem_seq != UNASSIGNED_SEQ \
                    and seg.rem_seq <= self.min_seq:
                # Tombstone out of the collab window: free it. SlideOnRemove
                # refs move to the next surviving segment's start; simple
                # refs detach to end-of-doc (localReference.ts slide).
                for ref in seg.local_refs or []:
                    if ref.ref_type == REF_SLIDE_ON_REMOVE:
                        pending_slide.append(ref)
                    else:
                        ref.segment = None
                        ref.offset = 0
                continue
            prev = out[-1] if out else None
            if prev is not None and self._can_append(prev, seg):
                join = len(prev.text)
                for ref in pending_slide:  # slid refs land at the join point
                    ref.segment = prev
                    ref.offset = join
                for ref in seg.local_refs or []:
                    ref.segment = prev
                    ref.offset += join
                moved = pending_slide + list(seg.local_refs or [])
                pending_slide = []
                if moved:
                    prev.local_refs = (prev.local_refs or []) + moved
                prev.text += seg.text
            else:
                out.append(seg)
                for ref in pending_slide:
                    ref.segment = seg
                    ref.offset = 0
                if pending_slide:
                    seg.local_refs = (seg.local_refs or []) + pending_slide
                    pending_slide = []
        for ref in pending_slide:  # removed the tail: pin to end-of-doc
            ref.segment = None
            ref.offset = 0
        self.segments = out

    def _can_append(self, a: Segment, b: Segment) -> bool:
        return (
            a.kind == SEG_TEXT and b.kind == SEG_TEXT
            and isinstance(a.text, str) and isinstance(b.text, str)
            and a.rem_seq is None and b.rem_seq is None
            and a.ins_seq != UNASSIGNED_SEQ and b.ins_seq != UNASSIGNED_SEQ
            and a.ins_seq <= self.min_seq and b.ins_seq <= self.min_seq
            and a.props == b.props
            and a.pending_props in (None, {}) and b.pending_props in (None, {})
            and a.length + b.length <= self.granularity
        )

    # ------------------------------------------------------------------
    # local references (reference localReference.ts; client.ts
    # createLocalReferencePosition / localReferencePositionToPosition)
    # ------------------------------------------------------------------
    def create_local_reference(self, pos: int,
                               ref_type: int = REF_SLIDE_ON_REMOVE,
                               properties: Optional[Dict[str, Any]] = None,
                               ref_seq: Optional[int] = None,
                               client: Optional[int] = None
                               ) -> LocalReference:
        """Anchor a reference at `pos` under the given perspective
        (defaults: current seq, local client)."""
        ref_seq = self.current_seq if ref_seq is None else ref_seq
        client = self.local_client if client is None else client
        idx, off = self.get_containing_segment(pos, ref_seq, client)
        ref = LocalReference(segment=None, offset=0, ref_type=ref_type,
                             properties=properties)
        if idx is not None:
            seg = self.segments[idx]
            ref.segment = seg
            ref.offset = off
            seg.local_refs = (seg.local_refs or []) + [ref]
        return ref  # segment=None: end-of-document pin

    def local_reference_position(self, ref: LocalReference,
                                 ref_seq: Optional[int] = None,
                                 client: Optional[int] = None) -> int:
        """Current position of the reference. A ref on a removed-but-
        unzambonied segment resolves to the tombstone's slot (= position of
        the next visible content); a detached ref resolves to doc end."""
        ref_seq = self.current_seq if ref_seq is None else ref_seq
        client = self.local_client if client is None else client
        if ref.segment is None:
            return self.get_length(ref_seq, client)
        try:
            idx = self.segments.index(ref.segment)
        except ValueError:
            return self.get_length(ref_seq, client)
        pos = self.get_position(idx, ref_seq, client)
        if self.visible_length(ref.segment, ref_seq, client) > 0:
            pos += ref.offset
        return pos

    def remove_local_reference(self, ref: LocalReference) -> None:
        if ref.segment is not None and ref.segment.local_refs:
            try:
                ref.segment.local_refs.remove(ref)
            except ValueError:
                pass
        ref.segment = None

    # ------------------------------------------------------------------
    # snapshot
    # ------------------------------------------------------------------
    def snapshot_segments(self) -> List[dict]:
        """Segments serialized at the minSeq perspective: everything visible
        at minSeq plus still-contended metadata (reference snapshotV1.ts:33)."""
        self.zamboni()
        out = []
        for seg in self.segments:
            if seg.local_seq is not None:
                continue  # pending local inserts are not part of a snapshot
            entry: Dict[str, Any] = {"kind": seg.kind, "text": seg.text}
            if seg.props:
                entry["props"] = dict(seg.props)
            if seg.ins_seq > self.min_seq:
                entry["seq"] = seg.ins_seq
                entry["client"] = seg.ins_client
            if seg.rem_seq is not None and seg.rem_seq != UNASSIGNED_SEQ:
                entry["removedSeq"] = seg.rem_seq
                entry["removedClient"] = seg.rem_client
                if seg.rem_overlap:
                    # Overlap removers matter to in-window consumers (an
                    # op from a second remover at a ref below the first
                    # remove's seq must still see the segment as gone);
                    # without them a reseeded tree diverges.
                    entry["removedOverlapClients"] = list(seg.rem_overlap)
            out.append(entry)
        return out

    def collab_segments(self) -> List[dict]:
        """snapshot_segments INCLUDING pending local state: pending inserts
        carry "localSeq", pending removes "removedLocalSeq" — the
        full-fidelity serialization bulk catch-up uses to round-trip a tree
        with in-flight local ops (load_segments restores both)."""
        self.zamboni()
        # Pending local annotates serialize per segment as
        # [{"localSeq", "props"}] (ascending localSeq): the bulk
        # catch-up kernel models them as DEV_UNASSIGNED ring entries and
        # round-trips them back, so pending groups and per-key shadow
        # counters rebuild after adoption.
        pending_anno: Dict[int, List[dict]] = {}
        for kind, group, extra in self.pending_groups:
            if kind != "annotate":
                continue
            for seg in group:
                pending_anno.setdefault(id(seg), []).append(
                    {"localSeq": extra["local_seq"],
                     "props": dict(extra["props"])})
        out = []
        for seg in self.segments:
            entry: Dict[str, Any] = {"kind": seg.kind, "text": seg.text}
            if seg.props:
                entry["props"] = dict(seg.props)
            if seg.ins_seq == UNASSIGNED_SEQ:
                entry["localSeq"] = seg.local_seq
                entry["client"] = seg.ins_client
            elif seg.ins_seq > self.min_seq:
                entry["seq"] = seg.ins_seq
                entry["client"] = seg.ins_client
            if seg.rem_seq is not None:
                if seg.rem_seq == UNASSIGNED_SEQ:
                    entry["removedLocalSeq"] = seg.rem_local_seq
                    entry["removedClient"] = seg.rem_client
                else:
                    entry["removedSeq"] = seg.rem_seq
                    entry["removedClient"] = seg.rem_client
                if seg.rem_overlap:
                    entry["removedOverlapClients"] = list(seg.rem_overlap)
            if id(seg) in pending_anno:
                entry["pendingAnnotates"] = sorted(
                    pending_anno[id(seg)], key=lambda a: a["localSeq"])
            out.append(entry)
        return out

    @staticmethod
    def load_segments(entries: List[dict], local_client: int = -1,
                      min_seq: int = 0, current_seq: int = 0
                      ) -> "MergeTreeOracle":
        tree = MergeTreeOracle(local_client=local_client)
        tree.min_seq = min_seq
        tree.current_seq = current_seq
        max_local = 0
        for e in entries:
            pending_ins = e.get("localSeq") is not None
            pending_rem = e.get("removedLocalSeq") is not None
            seg = Segment(
                kind=e.get("kind", SEG_TEXT),
                text=e.get("text", ""),
                ins_seq=(UNASSIGNED_SEQ if pending_ins
                         else e.get("seq", UNIVERSAL_SEQ)),
                ins_client=e.get("client", -1),
                rem_seq=(UNASSIGNED_SEQ if pending_rem
                         else e.get("removedSeq")),
                rem_client=e.get("removedClient"),
                rem_overlap=list(e.get("removedOverlapClients", [])),
                props=dict(e["props"]) if e.get("props") else None,
                uid=tree._next_uid(),
            )
            if pending_ins:
                seg.local_seq = e["localSeq"]
                max_local = max(max_local, seg.local_seq)
            if pending_rem:
                seg.rem_local_seq = e["removedLocalSeq"]
                max_local = max(max_local, seg.rem_local_seq)
            for pa in e.get("pendingAnnotates", []):
                # Restore the per-key shadow counters (props values are
                # already baked into entry["props"]).
                if seg.pending_props is None:
                    seg.pending_props = {}
                for key in pa["props"]:
                    seg.pending_props[key] = \
                        seg.pending_props.get(key, 0) + 1
                max_local = max(max_local, pa["localSeq"])
            tree.segments.append(seg)
            if seg.rem_seq is None:
                tree._local_len += seg.length
        tree.local_seq_counter = max(tree.local_seq_counter, max_local)
        return tree
