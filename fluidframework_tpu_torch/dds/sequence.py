"""SharedSegmentSequence + SharedString over the merge-tree client (a port
of fluidframework_tpu's dds/sequence.py).

Capability parity with reference packages/dds/sequence/src/{sequence.ts:51,
sharedString.ts:36}: text insert/remove/annotate, markers, position queries,
delta events, snapshot (header + chunked body, snapshotV1.ts:33-40), and
reconnect resubmission delegated to the merge-tree client's pending-op
rewrite (client.ts:863).

A bulk catch-up (`process_bulk_core`) routes each merge run with the
channel's own device type and, when the device wins, applies it through
MergeTreeClient.apply_bulk on that device: the scan-apply kernel on the
card, the plain PyTorch scan on the CPU.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, Iterator, List, Optional

from ..core.errors import CapacityExceeded
from ..core.events import TypedEventEmitter
from ..mergetree.client import MergeTreeClient
from ..mergetree.constants import SEG_MARKER, SNAPSHOT_CHUNK_SIZE
from ..mergetree.costmodel import device_bulk_wins
from ..mergetree.oracle import REF_SLIDE_ON_REMOVE, LocalReference
from ..protocol.summary import SummaryTree
from .shared_object import SharedObject

_interval_uid = itertools.count(1)


class SequenceInterval:
    """An [start, end] position pair anchored by local references
    (reference sequence/src/intervalCollection.ts SequenceInterval)."""

    def __init__(self, interval_id: str, start_ref: LocalReference,
                 end_ref: LocalReference,
                 properties: Optional[dict] = None):
        self.interval_id = interval_id
        self.start_ref = start_ref
        self.end_ref = end_ref
        self.properties = dict(properties or {})


class IntervalCollection(TypedEventEmitter):
    """A labeled set of intervals over one sequence, kept consistent via
    interval ops on the sequence's op stream (reference
    intervalCollection.ts:264-274; events addInterval/deleteInterval/
    changeInterval). Queries resolve through the live local references, so
    interval positions track concurrent edits."""

    def __init__(self, label: str, sequence: "SharedSegmentSequence"):
        super().__init__()
        self.label = label
        self.sequence = sequence
        self.intervals: Dict[str, SequenceInterval] = {}
        # Pending-local shadows (reference intervalCollection pendingChange
        # tracking): a remote change on an interval with an in-flight local
        # change is ignored — the sequencer orders the local one later, so
        # every replica converges on it. Counters survive interval deletion
        # (late acks must still retire them).
        self._pending_changes: Dict[str, int] = {}
        self._pending_prop_keys: Dict[str, Dict[str, int]] = {}

    # -- local mutations ---------------------------------------------------
    def add(self, start: int, end: int,
            properties: Optional[dict] = None) -> SequenceInterval:
        iid = f"iv-{self.sequence.local_client_id}-{next(_interval_uid)}"
        interval = self._attach(iid, start, end, properties)
        self.sequence._submit_interval_op(self.label, {
            "opName": "add", "intervalId": iid, "start": start, "end": end,
            "properties": dict(properties or {})})
        self.emit("addInterval", interval, True)
        return interval

    def remove_interval_by_id(self, interval_id: str) -> None:
        interval = self.intervals.pop(interval_id, None)
        if interval is None:
            return
        self._detach(interval)
        self.sequence._submit_interval_op(self.label, {
            "opName": "delete", "intervalId": interval_id})
        self.emit("deleteInterval", interval, True)

    def change(self, interval_id: str, start: int, end: int) -> None:
        interval = self.intervals.get(interval_id)
        if interval is None:
            return
        self._reanchor(interval, start, end)
        if self.sequence.attached:
            # Detached submits are dropped (state ships in the attach
            # summary) — no ack will ever retire a counter taken here.
            self._pending_changes[interval_id] = \
                self._pending_changes.get(interval_id, 0) + 1
        self.sequence._submit_interval_op(self.label, {
            "opName": "change", "intervalId": interval_id,
            "start": start, "end": end})
        self.emit("changeInterval", interval, True)

    def change_properties(self, interval_id: str, props: dict) -> None:
        interval = self.intervals.get(interval_id)
        if interval is None:
            return
        interval.properties.update(props)
        if self.sequence.attached:
            pending = self._pending_prop_keys.setdefault(interval_id, {})
            for key in props:
                pending[key] = pending.get(key, 0) + 1
        self.sequence._submit_interval_op(self.label, {
            "opName": "changeProperties", "intervalId": interval_id,
            "properties": props})
        self.emit("changeInterval", interval, True)

    # -- queries -----------------------------------------------------------
    def get_interval_by_id(self, interval_id: str
                           ) -> Optional[SequenceInterval]:
        return self.intervals.get(interval_id)

    def endpoints(self, interval: SequenceInterval) -> tuple:
        tree = self.sequence.client.tree
        return (tree.local_reference_position(interval.start_ref),
                tree.local_reference_position(interval.end_ref))

    def find_overlapping_intervals(self, start: int, end: int
                                   ) -> List[SequenceInterval]:
        out = []
        for interval in self.intervals.values():
            s, e = self.endpoints(interval)
            if not (e < start or s > end):
                out.append(interval)
        out.sort(key=lambda iv: self.endpoints(iv))
        return out

    def __iter__(self) -> Iterator[SequenceInterval]:
        return iter(sorted(self.intervals.values(),
                           key=lambda iv: self.endpoints(iv)))

    def __len__(self) -> int:
        return len(self.intervals)

    # -- op application ----------------------------------------------------
    def _process(self, op: dict, local: bool, ref_seq: int,
                 client_ordinal: int) -> None:
        name = op["opName"]
        iid = op["intervalId"]
        if local:
            # Ack: state applied at submit; retire the pending shadow.
            if name == "change":
                n = self._pending_changes.get(iid, 0)
                if n > 1:
                    self._pending_changes[iid] = n - 1
                else:
                    self._pending_changes.pop(iid, None)
            elif name == "changeProperties":
                pending = self._pending_prop_keys.get(iid)
                if pending:
                    for key in op.get("properties", {}):
                        n = pending.get(key, 0)
                        if n > 1:
                            pending[key] = n - 1
                        else:
                            pending.pop(key, None)
                    if not pending:
                        self._pending_prop_keys.pop(iid, None)
            return
        if name == "add":
            interval = self._attach(iid, op["start"], op["end"],
                                    op.get("properties"),
                                    ref_seq=ref_seq, client=client_ordinal)
            self.emit("addInterval", interval, False)
        elif name == "delete":
            interval = self.intervals.pop(iid, None)
            if interval is not None:
                self._detach(interval)
                self.emit("deleteInterval", interval, False)
        elif name == "change":
            interval = self.intervals.get(iid)
            if interval is not None and \
                    not self._pending_changes.get(iid):
                self._reanchor(interval, op["start"], op["end"],
                               ref_seq=ref_seq, client=client_ordinal)
                self.emit("changeInterval", interval, False)
        elif name == "changeProperties":
            interval = self.intervals.get(iid)
            if interval is not None:
                pending = self._pending_prop_keys.get(iid, {})
                applied = {k: v for k, v in op["properties"].items()
                           if not pending.get(k)}
                if applied:
                    interval.properties.update(applied)
                    self.emit("changeInterval", interval, False)

    # -- internals ---------------------------------------------------------
    def _attach(self, iid: str, start: int, end: int,
                properties: Optional[dict],
                ref_seq: Optional[int] = None,
                client: Optional[int] = None) -> SequenceInterval:
        tree = self.sequence.client.tree
        interval = SequenceInterval(
            iid,
            tree.create_local_reference(start, REF_SLIDE_ON_REMOVE,
                                        ref_seq=ref_seq, client=client),
            tree.create_local_reference(end, REF_SLIDE_ON_REMOVE,
                                        ref_seq=ref_seq, client=client),
            properties)
        self.intervals[iid] = interval
        return interval

    def _detach(self, interval: SequenceInterval) -> None:
        tree = self.sequence.client.tree
        tree.remove_local_reference(interval.start_ref)
        tree.remove_local_reference(interval.end_ref)

    def _reanchor(self, interval: SequenceInterval, start: int, end: int,
                  ref_seq: Optional[int] = None,
                  client: Optional[int] = None) -> None:
        tree = self.sequence.client.tree
        self._detach(interval)
        interval.start_ref = tree.create_local_reference(
            start, REF_SLIDE_ON_REMOVE, ref_seq=ref_seq, client=client)
        interval.end_ref = tree.create_local_reference(
            end, REF_SLIDE_ON_REMOVE, ref_seq=ref_seq, client=client)


class _ShapeCheckBuilder:
    """Payload-free OpBuilder stand-in: wire_to_host_ops drives it for
    PREVALIDATION only — every shape branch still runs (so Unmodelable
    raises exactly as in the real conversion) but nothing is built or
    retained."""

    def _noop(self, *args, **kwargs):
        return None

    insert_text = insert_marker = remove = annotate = _noop


class SharedSegmentSequence(SharedObject):
    TYPE = "https://graph.microsoft.com/types/mergeTree"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        # Lazy snapshot load (reference sequence.ts:489,664): when set,
        # body chunks have NOT been parsed — (tree, header) pending.
        self._lazy = None
        self._lazy_len = 0
        self._lazy_ordinal: Optional[int] = None
        self._deferred_remote: List[tuple] = []
        self.client = MergeTreeClient(client_id=self.local_client_id)
        self.client.on("delta", lambda args, local:
                       self.emit("sequenceDelta", args, local))
        self._interval_collections: Dict[str, IntervalCollection] = {}
        self.bulk_catchup_count = 0  # device bulk applies (telemetry/tests)
        # In-flight interval ops by uid (resubmitted verbatim on reconnect;
        # interval ops carry ids, not positions needing rewrite).
        self._pending_interval_ops: Dict[int, dict] = {}
        self._interval_op_uid = itertools.count(1)

    def bind_to_runtime(self, runtime) -> None:
        super().bind_to_runtime(runtime)
        # Adopt the runtime's client ordinal (retags pending segments too).
        self.client.update_client_id(runtime.client_ordinal)

    # -- lazy body ---------------------------------------------------------
    @property
    def client(self) -> MergeTreeClient:
        """Anything touching merge-tree state materializes a pending lazy
        body first; header-only queries (get_length) never come here."""
        if self._lazy is not None:
            self._materialize_body()
        return self._client

    @client.setter
    def client(self, value: MergeTreeClient) -> None:
        self._client = value

    def _materialize_body(self) -> None:
        tree, header = self._lazy
        self._lazy = None
        segments: List[dict] = []
        for i in range(header["chunkCount"]):
            segments.extend(json.loads(tree.entries[f"body_{i}"].content))
        segments = self._decode_snapshot_segments(segments)
        self._client = MergeTreeClient.load(
            {"segments": segments, "seq": header["seq"],
             "minSeq": header["minSeq"]},
            client_id=self.local_client_id)
        self._client.on("delta", lambda args, local:
                        self.emit("sequenceDelta", args, local))
        if self._lazy_ordinal is not None:
            self._client.update_client_id(self._lazy_ordinal)
            self._lazy_ordinal = None
        if "intervals" in tree.entries:
            payload = json.loads(tree.entries["intervals"].content)
            for label, entries in payload.items():
                coll = self.get_interval_collection(label)
                for entry in entries:
                    coll._attach(entry["intervalId"], entry["start"],
                                 entry["end"], entry.get("properties"))
        # Ops deferred while the body was pending replay in order.
        deferred, self._deferred_remote = self._deferred_remote, []
        for contents, seq, ref_seq, ordinal, min_seq in deferred:
            self._client.apply_msg(contents, seq, ref_seq, ordinal,
                                   min_seq=min_seq)

    @staticmethod
    def _op_contains_remove(contents) -> bool:
        if not isinstance(contents, dict):
            return True  # unknown shape: treat as removing (conservative)
        t = contents.get("type")
        if t == 1:
            return True
        if t == 3:
            return any(SharedSegmentSequence._op_contains_remove(sub)
                       for sub in contents.get("ops", []))
        return t not in (0, 2)

    def _op_len_delta(self, contents, ref_seq=None,
                      ordinal=None) -> Optional[int]:
        """Visible-length delta of a wire op, computable WITHOUT the body
        (None = shape unknown: materialize instead of deferring).

        Removes defer only when provably whole: if the remover saw the
        snapshot and every other client's deferred remove
        (ref_seq >= their seqs), its visible range [pos1, pos2) is
        entirely live text — concurrent unseen inserts land inside the
        range but survive a merge-tree remove — so the length shrinks by
        exactly pos2-pos1. Otherwise the range may overlap an
        already-removed span (which only the body knows), so materialize."""
        if not isinstance(contents, dict):
            return None
        t = contents.get("type")
        if t == 0:  # insert
            seg = contents.get("seg") or {}
            if seg.get("marker"):
                return 1
            if isinstance(seg.get("text"), str):
                return len(seg["text"])
            if isinstance(seg.get("items"), list):
                return len(seg["items"])
            return None
        if t == 1:  # remove
            if ref_seq is None or self._lazy is None:
                return None
            if ref_seq < int(self._lazy[1].get("seq", 0)):
                return None  # may overlap removes baked into the snapshot
            # Deferrals append in ascending seq order: walk the unseen
            # suffix only (seq > ref_seq) so absorbing a long catch-up
            # tail stays O(tail x window), not O(tail^2).
            for _c, s2, _r, o2, _m in reversed(self._deferred_remote):
                if s2 <= ref_seq:
                    break
                if o2 != ordinal and self._op_contains_remove(_c):
                    return None  # unseen concurrent remove: overlap unknown
            p1, p2 = contents.get("pos1"), contents.get("pos2")
            if not isinstance(p1, int) or not isinstance(p2, int) or \
                    p2 < p1 or isinstance(p1, bool) or isinstance(p2, bool):
                return None
            return p1 - p2
        if t == 2:  # annotate
            return 0
        if t == 3:  # group
            total = 0
            for sub in contents.get("ops", []):
                d = self._op_len_delta(sub, ref_seq, ordinal)
                if d is None:
                    return None
                total += d
            return total
        return None

    # -- queries -----------------------------------------------------------
    def get_length(self) -> int:
        if self._lazy is not None:
            # Header-only: totalLength adjusted by deferred remote ops.
            return self._lazy_len
        return self._client.get_length()

    # -- lifecycle ---------------------------------------------------------
    def adopt_client_ordinal(self, ordinal: int) -> None:
        if self._lazy is not None:
            self._lazy_ordinal = ordinal  # applied at materialization
            return
        self.client.update_client_id(ordinal)

    # -- read-path catch-up adoption (docs/read_path.md) -------------------
    def can_adopt_catchup(self) -> bool:
        """Whether this channel's state may be REPLACED wholesale by a
        server catch-up artifact: nothing local may be live — no pending
        (unacked) edits, no interval collections (their anchors are live
        local references that do not survive a state swap), no in-flight
        interval ops. A lazy, untouched body trivially qualifies."""
        if self._interval_collections or self._pending_interval_ops:
            return False
        if self._lazy is not None:
            return True  # fresh from snapshot: no local state can exist
        tree = self._client.tree
        return not tree.pending_groups \
            and not any(seg.local_refs for seg in tree.segments)

    def adopt_catchup_core(self, entries: List[dict], seq: int,
                           min_seq: int, total_length: int) -> None:
        """Swap in server-materialized snapshot entries at `seq` — the
        delta half of `summary + delta` catch-up. The swap re-enters the
        ordinary lazy-load path (a synthetic header + one body chunk in
        the summarize_core wire format), so payload decoding, ordinal
        adoption, and the delta-event wiring are EXACTLY the fresh-load
        code — no second deserialization path to keep conformant. Any
        remote ops deferred against the previous lazy body are covered
        by the artifact (their seqs are <= `seq`) and drop."""
        if not self.can_adopt_catchup():
            raise ValueError("channel has live local state")
        if self._lazy is None:
            # Preserve the materialized body's ordinal adoption across
            # the swap (bind_to_runtime/adopt_client_ordinal already ran).
            ordinal = self._client.client_id
            if ordinal is not None and ordinal >= 0:
                self._lazy_ordinal = ordinal
        tree = SummaryTree()
        tree.add_blob("header", json.dumps({
            "seq": seq, "minSeq": min_seq, "chunkCount": 1,
            "totalLength": total_length}))
        tree.add_blob("body_0", json.dumps(entries))
        self._client = None
        self._deferred_remote = []
        self._lazy = (tree, json.loads(tree.entries["header"].content))
        self._lazy_len = int(total_length)
        self.change_epoch += 1  # adopted state is NOT durably summarized

    def connect(self) -> None:
        # A lazily-loaded channel is fresh from a snapshot: it cannot have
        # detached edits, so the pending-groups probe must not defeat the
        # lazy body by touching merge-tree state.
        if self._lazy is None and not self.attached and \
                self._client.tree.pending_groups:
            # Detached edits fold into the attach summary, not ops.
            self._client.commit_detached()
        super().connect()

    # -- local references (client.ts createLocalReferencePosition) --------
    def create_local_reference_position(
            self, pos: int, ref_type: int = REF_SLIDE_ON_REMOVE,
            properties: Optional[dict] = None) -> LocalReference:
        return self.client.tree.create_local_reference(pos, ref_type,
                                                       properties)

    def local_reference_to_position(self, ref: LocalReference) -> int:
        return self.client.tree.local_reference_position(ref)

    def remove_local_reference_position(self, ref: LocalReference) -> None:
        self.client.tree.remove_local_reference(ref)

    # -- interval collections ---------------------------------------------
    def get_interval_collection(self, label: str) -> IntervalCollection:
        if label not in self._interval_collections:
            self._interval_collections[label] = IntervalCollection(label,
                                                                   self)
        return self._interval_collections[label]

    def _submit_interval_op(self, label: str, op: dict) -> None:
        uid = next(self._interval_op_uid)
        contents = {"type": "intervalCollection", "label": label,
                    "uid": uid, "op": op}
        self._pending_interval_ops[uid] = contents
        self.submit_local_message(contents)

    # -- channel plumbing --------------------------------------------------
    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        if self._lazy is not None and not local:
            # Body still pending: queue remote ops whose length effect is
            # computable from the wire shape (reference: incoming ops are
            # deferred until the needed body chunk arrives,
            # sequence.ts:664); anything else materializes first.
            delta = self._op_len_delta(contents, ref_seq, client_ordinal)
            if delta is not None:
                self._deferred_remote.append(
                    (contents, seq, ref_seq, client_ordinal, min_seq))
                self._lazy_len += delta
                self.change_epoch += 1  # deferred != unchanged
                return
        if isinstance(contents, dict) and \
                contents.get("type") == "intervalCollection":
            if local:
                self._pending_interval_ops.pop(contents.get("uid"), None)
            self.get_interval_collection(contents["label"])._process(
                contents["op"], local, ref_seq, client_ordinal)
            self.client.tree.update_seq(seq)
            if min_seq is not None and min_seq > self.client.tree.min_seq:
                self.client.tree.set_min_seq(min_seq)
            return
        self.client.apply_msg(contents, seq, ref_seq, client_ordinal,
                              min_seq=min_seq)

    def process_bulk_core(self, batch) -> None:
        """Device bulk catch-up: apply a run of remote sequenced ops
        [(contents, seq, ref_seq, client_ordinal, min_seq)] through the
        merge-tree kernel (mergetree/catchup.py; reference
        deltaManager.ts:1380-1401 catch-up, vectorized).

        Interval ops never touch segment state, so the batch SPLITS at
        them: merge runs ride the kernel, interval ops apply host-side
        between runs at their own (ref_seq, client) perspectives — the
        reference's shape-agnostic catch-up without giving up the device
        path for the whole tail. Merge runs executed while live local
        references exist (interval anchors created earlier in this very
        batch, or pre-existing) go scalar per-op instead: references
        slide per-op and do not survive the kernel round trip.

        Raises Unmodelable/ValueError — with channel state UNTOUCHED —
        only from prevalidation (own sequenced merge ops, unmodelable
        shapes); once application starts, the capacity ceiling finishes
        the run scalar rather than raising. A kernel's refusal, build or
        launch failure raises RuntimeError: it never replays scalar."""
        from ..mergetree.catchup import Unmodelable, wire_to_host_ops

        def is_interval(contents) -> bool:
            return isinstance(contents, dict) and \
                contents.get("type") == "intervalCollection"

        if self._lazy is not None:
            # Lazy body pending: absorb the run as deferrals so the doc
            # STAYS lazy through catch-up (touching self.client below
            # would materialize just to probe preconditions; a fresh
            # snapshot load has no local refs or pendings, so those
            # probes are vacuous while lazy). All-or-nothing: on any
            # non-deferrable op (incl. interval ops, which need live
            # anchors) the tentative deferrals roll back, the body
            # materializes, and the run-splitting path below takes over.
            mark = len(self._deferred_remote)
            len0, ok = self._lazy_len, True
            for contents, seq, ref_seq, ordinal, min_seq in batch:
                if is_interval(contents):
                    ok = False
                    break
                d = self._op_len_delta(contents, ref_seq, ordinal)
                if d is None:
                    ok = False
                    break
                self._deferred_remote.append(
                    (contents, seq, ref_seq, ordinal, min_seq))
                self._lazy_len += d
            if ok:
                self.change_epoch += 1
                self.bulk_catchup_count += 1  # whole run absorbed lazily
                return
            del self._deferred_remote[mark:]
            self._lazy_len = len0

        # --- split into alternating merge runs / interval ops ------------
        runs: List[tuple] = []
        for item in batch:
            if is_interval(item[0]):
                runs.append(("interval", item))
            else:
                if not runs or runs[-1][0] != "merge":
                    runs.append(("merge", []))
                runs[-1][1].append(item)

        # --- prevalidation (the all-or-nothing contract) ------------------
        my_ordinal = self.client.client_id
        shape_check = _ShapeCheckBuilder()
        for kind, data in runs:
            if kind != "merge":
                continue
            for contents, seq, ref_seq, ordinal, min_seq in data:
                if ordinal == my_ordinal:
                    raise Unmodelable(
                        "own sequenced ops in tail need ack pairing")
                # Payload-free shape check — raises Unmodelable on
                # content the kernel cannot represent, BEFORE any state
                # changes (the real conversion happens once, inside
                # apply_bulk).
                wire_to_host_ops(shape_check, contents, seq, ref_seq,
                                 ordinal, min_seq or 0, allow_items=True)

        # --- apply --------------------------------------------------------
        # Past this point nothing may raise Unmodelable/ValueError: the
        # container's scalar fallback assumes channel state is untouched,
        # and earlier runs HAVE applied — an escaping error would
        # double-apply the batch. Unexpected errors surface as
        # RuntimeError, which the fallback does not catch.
        kernel_used = False
        try:
            for kind, data in runs:
                if kind == "interval":
                    contents, seq, ref_seq, ordinal, min_seq = data
                    local = ordinal == my_ordinal
                    if local:
                        self._pending_interval_ops.pop(
                            contents.get("uid"), None)
                    self.get_interval_collection(
                        contents["label"])._process(
                        contents["op"], local, ref_seq, ordinal)
                    self.client.tree.update_seq(seq)
                    if min_seq is not None and \
                            min_seq > self.client.tree.min_seq:
                        self.client.tree.set_min_seq(min_seq)
                    continue
                # Route per run: the device path must actually win for
                # this (backend, tail length, live segments) — the B=1
                # kernel loses to scalar on CPU and under the TPU
                # dispatch floor for short tails (mergetree/costmodel.py,
                # round-4 verdict's 4x single-doc pessimization).
                device = self.device
                scalar = (any(seg.local_refs
                              for seg in self.client.tree.segments)
                          or not device_bulk_wins(
                              len(data),
                              len(self.client.tree.segments),
                              backend=device.type))
                if not scalar:
                    try:
                        self.client.apply_bulk(data, device)
                        kernel_used = True
                        continue
                    except (Unmodelable, CapacityExceeded):
                        # apply_bulk left the channel untouched: content
                        # its own check rejects, or the capacity ceiling.
                        # Finish this run per-op.
                        scalar = True
                for contents, seq, ref_seq, ordinal, min_seq in data:
                    self.client.apply_msg(contents, seq, ref_seq, ordinal,
                                          min_seq=min_seq)
        except (Unmodelable, ValueError) as err:
            raise RuntimeError(
                f"bulk catch-up failed mid-application: {err}") from err
        if kernel_used:
            self.bulk_catchup_count += 1

    def resubmit_pending(self) -> List[Any]:
        if self._lazy is not None:
            # Lazily loaded = fresh from snapshot: no merge-tree pendings
            # can exist, and the probe must not materialize the body.
            return list(self._pending_interval_ops.values())
        return (self.client.regenerate_pending_ops()
                + list(self._pending_interval_ops.values()))

    def summarize_core(self) -> SummaryTree:
        """Chunked snapshot: header with collab window + body chunks of
        bounded size (reference snapshotV1.ts chunking, chunkSize=10000)."""
        snap = self.client.snapshot()
        # Measured BEFORE encoding: _encode_snapshot_segments mutates
        # payloads in place (Items -> {"items": [...]}).
        total = sum(self._segment_visible_len(seg)
                    for seg in snap["segments"]
                    if seg.get("removedSeq") is None)
        segments = self._encode_snapshot_segments(snap["segments"])
        chunks: List[List[dict]] = [[]]
        size = 0
        for seg in segments:
            payload = seg.get("text", "")
            seg_size = (len(payload) if isinstance(payload, str)
                        else len(json.dumps(payload))) + 1
            if size + seg_size > SNAPSHOT_CHUNK_SIZE and chunks[-1]:
                chunks.append([])
                size = 0
            chunks[-1].append(seg)
            size += seg_size
        tree = SummaryTree()
        tree.add_blob("header", json.dumps({
            "seq": snap["seq"],
            "minSeq": snap["minSeq"],
            "chunkCount": len(chunks),
            # Enables header-only get_length on lazy load.
            "totalLength": total,
        }))
        for i, chunk in enumerate(chunks):
            tree.add_blob(f"body_{i}", json.dumps(chunk))
        if any(self._interval_collections.values()):
            # Interval positions serialize resolved at the snapshot
            # perspective (reference: intervalCollection valuetype snapshot).
            payload = {}
            for label, coll in self._interval_collections.items():
                payload[label] = [
                    {"intervalId": iv.interval_id,
                     "start": coll.endpoints(iv)[0],
                     "end": coll.endpoints(iv)[1],
                     "properties": iv.properties}
                    for iv in coll]
            tree.add_blob("intervals", json.dumps(payload))
        return tree

    def _segment_visible_len(self, seg: dict) -> int:
        """Visible-length contribution of a DECODED snapshot segment
        (header totalLength; item sequences count items, not payload
        encoding)."""
        if seg.get("kind") == SEG_MARKER:
            return 1
        return len(seg.get("text", ""))

    def _encode_snapshot_segments(self, segments: List[dict]) -> List[dict]:
        """Hook: make segment payloads JSON-safe (item sequences override)."""
        return segments

    def _decode_snapshot_segments(self, segments: List[dict]) -> List[dict]:
        return segments

    def load_core(self, tree: SummaryTree) -> None:
        header = json.loads(tree.entries["header"].content)
        if "totalLength" in header and "intervals" not in tree.entries:
            # Header-first lazy load: body chunks parse (and, with a lazy
            # storage tree, transfer) only when merge-tree state is first
            # touched; catch-up memory stays proportional to the header.
            # Interval-bearing snapshots load eagerly — interval anchors
            # resolve against live segments.
            self._lazy = (tree, header)
            self._lazy_len = int(header["totalLength"])
            return
        # Legacy snapshot (no totalLength): eager load.
        self._lazy = (tree, header)
        self._materialize_body()


class SharedItemsSequence(SharedSegmentSequence):
    """Sequence of JSON values over the merge-tree engine (reference
    sequence/src/sharedSequence.ts SharedSequence<T>: insert :64,
    remove :45, getItems :90 over SubSequence segments)."""

    def insert_range(self, pos: int, values, props: Optional[dict] = None
                     ) -> None:
        values = list(values)  # one-shot iterables are consumed repeatedly
        if not values:
            return
        self.submit_local_message(
            self.client.insert_items_local(pos, values, props))

    def remove_range(self, start: int, end: int) -> None:
        self.submit_local_message(self.client.remove_range_local(start, end))

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        self.submit_local_message(
            self.client.annotate_range_local(start, end, props))

    def get_item_count(self) -> int:
        return self.get_length()

    def get_items(self, start: int = 0, end: Optional[int] = None) -> list:
        from ..mergetree.oracle import Items
        tree = self.client.tree
        out: list = []
        for seg in tree.segments:
            if tree.visible_length(seg, tree.current_seq,
                                   self.client.client_id) > 0:
                if isinstance(seg.text, Items):
                    out.extend(seg.text.values)
        return out[start:end]

    def _segment_visible_len(self, seg: dict) -> int:
        from ..mergetree.oracle import Items
        text = seg.get("text")
        if isinstance(text, Items):
            return len(text.values)
        if isinstance(text, dict) and "items" in text:
            return len(text["items"])
        return super()._segment_visible_len(seg)

    # Items payloads are not JSON until wrapped; ONE codec owns the
    # {"items": [...]} wire shape (mergetree/runs.py — shared with the
    # server lane extraction, so client and server snapshots can never
    # drift apart).
    def _encode_snapshot_segments(self, segments: List[dict]) -> List[dict]:
        from ..mergetree.runs import encode_entry_payloads
        return encode_entry_payloads(segments)

    def _decode_snapshot_segments(self, segments: List[dict]) -> List[dict]:
        from ..mergetree.runs import decode_entry_payloads
        return decode_entry_payloads(segments)


class SharedNumberSequence(SharedItemsSequence):
    """Reference sequence/src/sharedNumberSequence.ts: sequence of numbers."""

    TYPE = "https://graph.microsoft.com/types/mergeTree/numberSequence"


class SharedObjectSequence(SharedItemsSequence):
    """Reference sequence/src/sharedObjectSequence.ts: sequence of
    serializable values."""

    TYPE = "https://graph.microsoft.com/types/mergeTree/objectSequence"


class SharedString(SharedSegmentSequence):
    """Reference sharedString.ts:36 API: collaborative rich text."""

    TYPE = "https://graph.microsoft.com/types/mergeTree/string"

    def insert_text(self, pos: int, text: str,
                    props: Optional[dict] = None) -> None:
        self.submit_local_message(
            self.client.insert_text_local(pos, text, props))

    def insert_marker(self, pos: int, props: Optional[dict] = None) -> None:
        self.submit_local_message(self.client.insert_marker_local(pos, props))

    def remove_text(self, start: int, end: int) -> None:
        self.submit_local_message(self.client.remove_range_local(start, end))

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        self.submit_local_message(
            self.client.annotate_range_local(start, end, props))

    def replace_text(self, start: int, end: int, text: str,
                     props: Optional[dict] = None) -> None:
        # Insert-then-remove in one turn (reference groupOperation shape).
        self.insert_text(end, text, props)
        self.remove_text(start, end)

    def get_text(self) -> str:
        return self.client.get_text()

    # -- marker queries (reference mergeTree getMarkerFromId /
    #    searchForMarker via tile labels) -----------------------------------
    def _visible_markers(self):
        """Yield (position, props) per visible marker, ascending."""
        from ..mergetree.constants import SEG_MARKER
        tree = self.client.tree
        acc = 0
        for seg in tree.segments:
            vlen = tree.visible_length(seg, tree.current_seq,
                                       self.client.client_id)
            if vlen == 0:
                continue
            if seg.kind == SEG_MARKER:
                yield acc, (seg.props or {})
            acc += vlen

    def get_marker_from_id(self, marker_id: str) -> Optional[tuple]:
        """(position, props) of the visible marker whose props carry
        {"markerId": marker_id} (reference reservedMarkerIdKey), or None."""
        for pos, props in self._visible_markers():
            if props.get("markerId") == marker_id:
                return pos, props
        return None

    def search_for_marker(self, start_pos: int, label: str,
                          forwards: bool = True) -> Optional[tuple]:
        """Nearest visible marker at/after (forwards) or at/before
        (backwards) start_pos whose {"tileLabels": [...]} props contain
        `label` (reference searchForMarker over tile labels). Returns
        (position, props) or None."""
        best = None
        for pos, props in self._visible_markers():
            if label not in (props.get("tileLabels") or []):
                continue
            if forwards:
                if pos >= start_pos:
                    return pos, props
            elif pos <= start_pos:
                best = (pos, props)  # keep scanning: last one wins
            else:
                break
        return best
