"""Merge-tree Client: one replica's engine + pending-op lifecycle (a port
of fluidframework_tpu's mergetree/client.py).

Capability parity with reference packages/dds/merge-tree/src/client.ts:42 —
local edits (insertSegmentLocal :201), applying sequenced messages
(applyMsg :805, applyRemoteOp :776), acking own ops, minSeq-driven zamboni,
and reconnect resubmission (regeneratePendingOp :863,
findReconnectionPostition :682): pending ops are rewritten against the
current view before resubmit, dropping segments already removed remotely.

The interactive path runs on the scalar oracle (single-op latency); bulk
catch-up (`apply_bulk`) runs the op tail through mergetree/catchup.py's
device_apply_tail, whose chunks launch the scan-apply kernel on the card
(kernels/csrc/scan_apply.cu) and run the plain PyTorch scan on the CPU.
The client takes `device=`, which only `apply_bulk` uses (unless its
caller names another): None means "cuda", and the tests pass "cpu". Everything else is the JAX client's code
unchanged.

Wire op shape mirrors reference ops.ts (IMergeTreeInsertMsg/RemoveMsg/
AnnotateMsg/GroupMsg): {"type": 0|1|2|3, "pos1", "pos2", "seg", "props"}.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.events import TypedEventEmitter
from ..telemetry import tracing
from .constants import SEG_MARKER, SEG_TEXT, UNASSIGNED_SEQ
from .oracle import Items, MergeTreeOracle, Segment

# MergeTreeDeltaType (reference ops.ts:29)
OP_INSERT = 0
OP_REMOVE = 1
OP_ANNOTATE = 2
OP_GROUP = 3


def make_insert_op(pos: int, seg: dict) -> dict:
    return {"type": OP_INSERT, "pos1": pos, "seg": seg}

def make_remove_op(start: int, end: int) -> dict:
    return {"type": OP_REMOVE, "pos1": start, "pos2": end}

def make_annotate_op(start: int, end: int, props: dict) -> dict:
    return {"type": OP_ANNOTATE, "pos1": start, "pos2": end, "props": props}

def make_group_op(ops: List[dict]) -> dict:
    return {"type": OP_GROUP, "ops": ops}


def text_seg(text: str, props: Optional[dict] = None) -> dict:
    seg: Dict[str, Any] = {"text": text}
    if props:
        seg["props"] = props
    return seg


def marker_seg(props: Optional[dict] = None) -> dict:
    seg: Dict[str, Any] = {"marker": True}
    if props:
        seg["props"] = props
    return seg


def items_seg(values, props: Optional[dict] = None) -> dict:
    seg: Dict[str, Any] = {"items": list(values)}
    if props:
        seg["props"] = props
    return seg


class MergeTreeClient(TypedEventEmitter):
    """Events: "delta" (op_args, is_local) fired on every applied change."""

    def __init__(self, client_id: int = -1, device=None):
        super().__init__()
        self.tree = MergeTreeOracle(local_client=client_id)
        self.client_id = client_id
        self.device = device

    # -- queries -----------------------------------------------------------
    @property
    def current_seq(self) -> int:
        return self.tree.current_seq

    def get_length(self) -> int:
        return self.tree.get_length()

    def get_text(self) -> str:
        return self.tree.get_text()

    # -- local edits (return the wire op to submit) ------------------------
    # Each local edit is where an op's TRACE is born: new_op_trace() head-
    # samples a root context, the edit itself records as its first span,
    # and the context parks thread-locally until the driver submit that
    # ships the op adopts it onto the wire (telemetry/tracing.py).
    def insert_text_local(self, pos: int, text: str,
                          props: Optional[dict] = None) -> dict:
        with tracing.span("client.local_edit",
                          parent=tracing.new_op_trace(), op="insertText"):
            self.tree.insert_text(pos, text, self.tree.current_seq,
                                  self.client_id, UNASSIGNED_SEQ,
                                  props=props)
            self.emit("delta", {"op": "insert", "pos": pos, "text": text},
                      True)
            return make_insert_op(pos, text_seg(text, props))

    def insert_marker_local(self, pos: int,
                            props: Optional[dict] = None) -> dict:
        with tracing.span("client.local_edit",
                          parent=tracing.new_op_trace(), op="insertMarker"):
            self.tree.insert_marker(pos, self.tree.current_seq,
                                    self.client_id, UNASSIGNED_SEQ,
                                    props=props)
            self.emit("delta", {"op": "insertMarker", "pos": pos}, True)
            return make_insert_op(pos, marker_seg(props))

    def insert_items_local(self, pos: int, values,
                           props: Optional[dict] = None) -> dict:
        with tracing.span("client.local_edit",
                          parent=tracing.new_op_trace(), op="insertItems"):
            self.tree.insert_items(pos, values, self.tree.current_seq,
                                   self.client_id, UNASSIGNED_SEQ,
                                   props=props)
            self.emit("delta", {"op": "insert", "pos": pos,
                                "items": list(values)}, True)
            return make_insert_op(pos, items_seg(values, props))

    def remove_range_local(self, start: int, end: int) -> dict:
        with tracing.span("client.local_edit",
                          parent=tracing.new_op_trace(), op="remove"):
            # Capture removed content before applying so undo can reinsert
            # it (text payloads only; permutation vectors carry non-str
            # runs).
            try:
                removed = self.get_text()[start:end]
            except TypeError:
                removed = None
            self.tree.remove_range(start, end, self.tree.current_seq,
                                   self.client_id, UNASSIGNED_SEQ)
            args = {"op": "remove", "start": start, "end": end}
            if isinstance(removed, str):
                args["text"] = removed
            self.emit("delta", args, True)
            return make_remove_op(start, end)

    def annotate_range_local(self, start: int, end: int, props: dict) -> dict:
        with tracing.span("client.local_edit",
                          parent=tracing.new_op_trace(), op="annotate"):
            # Per-span previous values (undo restores them; null deletes).
            deltas = self.tree.get_range_property_deltas(start, end,
                                                         props.keys())
            self.tree.annotate_range(start, end, props,
                                     self.tree.current_seq, self.client_id,
                                     UNASSIGNED_SEQ)
            self.emit("delta", {"op": "annotate", "start": start,
                                "end": end, "props": props,
                                "propertyDeltas": deltas}, True)
            return make_annotate_op(start, end, props)

    # -- sequenced message application ------------------------------------
    def apply_msg(self, op: dict, seq: int, ref_seq: int, client: int,
                  min_seq: Optional[int] = None) -> None:
        """Apply one sequenced merge-tree op (reference client.ts:805).

        current_seq advances BEFORE the apply: every apply path positions by
        the op's explicit (ref_seq, client) perspective, and listeners of
        the resulting "delta" event must see the op's effect when they read
        the tree (a remote insert stamped ins_seq=seq would be invisible
        under the old current_seq)."""
        self.tree.update_seq(seq)
        if client == self.client_id:
            self._ack_op(op, seq)
        else:
            self._apply_remote(op, seq, ref_seq, client)
        if min_seq is not None and min_seq > self.tree.min_seq:
            self.tree.set_min_seq(min_seq)

    def _apply_remote(self, op: dict, seq: int, ref_seq: int, client: int):
        t = op["type"]
        if t == OP_GROUP:
            for sub in op["ops"]:
                self._apply_remote(sub, seq, ref_seq, client)
        elif t == OP_INSERT:
            seg = op["seg"]
            if seg.get("marker"):
                self.tree.insert_marker(op["pos1"], ref_seq, client, seq,
                                        props=seg.get("props"))
            elif "items" in seg:
                self.tree.insert_items(op["pos1"], seg["items"], ref_seq,
                                       client, seq, props=seg.get("props"))
            else:
                self.tree.insert_text(op["pos1"], seg["text"], ref_seq, client,
                                      seq, props=seg.get("props"))
            self.emit("delta", {"op": "insert", "pos": op["pos1"],
                                "seg": seg, "seq": seq}, False)
        elif t == OP_REMOVE:
            self.tree.remove_range(op["pos1"], op["pos2"], ref_seq, client, seq)
            self.emit("delta", {"op": "remove", "start": op["pos1"],
                                "end": op["pos2"], "seq": seq}, False)
        elif t == OP_ANNOTATE:
            self.tree.annotate_range(op["pos1"], op["pos2"], op["props"],
                                     ref_seq, client, seq)
            self.emit("delta", {"op": "annotate", "seq": seq}, False)

    def _ack_op(self, op: dict, seq: int) -> None:
        if op["type"] == OP_GROUP:
            for _ in op["ops"]:
                self.tree.ack(seq)
        else:
            self.tree.ack(seq)

    # -- device bulk catch-up ---------------------------------------------
    def apply_bulk(self, tail: List[tuple], device=None) -> None:
        """Apply a large sequenced-op tail through the device kernel and
        adopt the result (the bulk half of reference deltaManager.ts:1380
        catch-up; engine in mergetree/catchup.py).

        tail: [(wire_op_dict, seq, ref_seq, client_ordinal, msn)], strictly
        ordered, all remote; the chunks run on `device`, None meaning the
        client's own (a channel passes its data store's). Raises
        catchup.Unmodelable (caller falls back to per-op apply_msg) when
        the tail or current state contains content the kernel cannot
        represent, and core.errors.CapacityExceeded when the table
        outgrows the largest capacity; the kernel's refusal and a chunk
        that overflows after escalation are RuntimeErrors. State is
        untouched on any raise. Pending local inserts/removes ride
        along (the kernel models DEV_UNASSIGNED segments; remote
        perspectives never see them), and pending ANNOTATES ride as
        DEV_UNASSIGNED ring entries (collab_segments pendingAnnotates) —
        all pending groups rebuild from the round-tripped localSeq tags."""
        from ..core.errors import CapacityExceeded
        from .catchup import (EscalationExhausted, Unmodelable,
                              device_apply_tail)

        pending = self.tree.pending_groups
        if not tail:
            return
        if any(cl == self.client_id for _, _, _, cl, _ in tail):
            # An op of OURS sequenced into the tail is an ack, not a fresh
            # remote op — it needs scalar pending-group pairing.
            raise Unmodelable("own sequenced ops in tail need ack pairing")
        entries = (self.tree.collab_segments() if pending
                   else self.tree.snapshot_segments())
        try:
            new_entries = device_apply_tail(
                entries, tail, min_seq=self.tree.min_seq,
                current_seq=self.tree.current_seq,
                device=self.device if device is None else device)
        except CapacityExceeded:
            raise  # the capacity ceiling: callers finish the tail per-op
        except EscalationExhausted as err:
            # The scan kept reporting overflow on a tail that fits this
            # client's state: a kernel fault, not a scalar fallback.
            raise RuntimeError(
                f"bulk catch-up failed on the kernel: {err}") from err
        except ValueError as err:
            # The scan-apply wrapper refuses a shape, a dtype or a tensor
            # off the card with a ValueError. It must not look like the
            # capacity ceiling to a caller's scalar fallback.
            raise RuntimeError(
                f"bulk catch-up refused by the kernel: {err}") from err
        last_seq = tail[-1][1]
        last_msn = tail[-1][4]
        tree = MergeTreeOracle.load_segments(
            new_entries, local_client=self.client_id,
            min_seq=max(self.tree.min_seq, last_msn), current_seq=last_seq)
        if pending:
            tree.local_seq_counter = max(self.tree.local_seq_counter,
                                         tree.local_seq_counter)
            # Rebuild the pending groups from the round-tripped localSeq
            # tags, preserving the ORIGINAL group order and extras — a
            # still-in-flight ack pairs FIFO, so a group whose pending
            # remove a remote remove overwrote mid-tail must keep its
            # slot (as an empty group: ack and regenerate both no-op over
            # it, matching the scalar path's "a remote remove won").
            by_key: dict = {}
            for seg, entry in zip(tree.segments, new_entries):
                if seg.ins_seq == UNASSIGNED_SEQ and seg.local_seq:
                    by_key.setdefault(
                        ("insert", seg.local_seq), []).append(seg)
                if seg.rem_seq == UNASSIGNED_SEQ and seg.rem_local_seq:
                    by_key.setdefault(
                        ("remove", seg.rem_local_seq), []).append(seg)
                for pa in entry.get("pendingAnnotates", []):
                    by_key.setdefault(
                        ("annotate", pa["localSeq"]), []).append(seg)
            tree.pending_groups = [
                (kind, by_key.get((kind, extra["local_seq"]), []), extra)
                for kind, group, extra in pending]
            # The kernel places the tail's inserts as the replicas do;
            # the pending inserts then move where the replicas will put
            # them (MergeTreeOracle._rebase_pending_inserts).
            tree._rebase_pending_inserts()
        self.tree = tree
        self.emit("delta", {"op": "bulkCatchUp", "count": len(tail),
                            "seq": last_seq}, False)

    # -- reconnect ---------------------------------------------------------
    def regenerate_pending_ops(self) -> List[dict]:
        """Rewrite all pending local ops against the current view for
        resubmission after reconnect (reference client.ts:863
        regeneratePendingOp + findReconnectionPostition :682).

        Position math uses the op's original localSeq as a perspective cap:
        pending edits with a *smaller* localSeq count (they will be
        resubmitted first and thus precede this op at the server), later
        ones do not. Two passes: compute every position against the original
        localSeqs, then renumber/replace the pending groups so subsequent
        acks pair with the regenerated ops.
        """
        tree = self.tree
        old_groups = tree.pending_groups
        # Pass 1: positions at the original localSeq perspectives.
        plans = []  # (kind, [(seg, pos)], extra)
        for kind, group, extra in old_groups:
            cap = extra.get("local_seq", tree.local_seq_counter)
            entries = []
            for seg in group:
                if kind == "insert" and (
                        seg.local_seq is None or seg.ins_seq != UNASSIGNED_SEQ):
                    continue  # already acked
                if kind == "remove" and seg.rem_seq != UNASSIGNED_SEQ:
                    continue  # a remote remove won while we were offline
                if kind == "annotate" and seg.rem_seq is not None \
                        and seg.rem_seq != UNASSIGNED_SEQ:
                    self._drop_pending_props(seg, extra["props"])
                    continue
                entries.append((seg, self._pending_segment_position(seg, cap)))
            plans.append((kind, entries, extra))
        # Pass 2: rebuild groups in order with fresh localSeqs + emit ops.
        tree.pending_groups = []
        new_ops: List[dict] = []
        for kind, entries, extra in plans:
            for seg, pos in entries:
                tree.local_seq_counter += 1
                new_local = tree.local_seq_counter
                if kind == "insert":
                    seg.local_seq = new_local
                    tree.pending_groups.append(
                        ("insert", [seg], {"local_seq": new_local,
                                           "ref_seq": tree.current_seq}))
                    if seg.kind == SEG_MARKER:
                        new_ops.append(make_insert_op(pos, marker_seg(seg.props)))
                    elif isinstance(seg.text, Items):
                        new_ops.append(make_insert_op(
                            pos, items_seg(seg.text.values, seg.props)))
                    else:
                        new_ops.append(make_insert_op(
                            pos, text_seg(seg.text, seg.props)))
                elif kind == "remove":
                    seg.rem_local_seq = new_local
                    tree.pending_groups.append(
                        ("remove", [seg], {"local_seq": new_local}))
                    new_ops.append(make_remove_op(pos, pos + seg.length))
                else:
                    tree.pending_groups.append(
                        ("annotate", [seg],
                         {"props": extra["props"], "local_seq": new_local}))
                    new_ops.append(make_annotate_op(
                        pos, pos + seg.length, extra["props"]))
        return new_ops

    def _pending_segment_position(self, seg: Segment, local_seq_cap: int) -> int:
        idx = self.tree.segments.index(seg)
        tree = self.tree
        return sum(
            tree.visible_length(tree.segments[i], tree.current_seq,
                                self.client_id, local_seq=local_seq_cap)
            for i in range(idx))

    def _drop_pending_props(self, seg: Segment, props: dict) -> None:
        if seg.pending_props:
            for key in props:
                if seg.pending_props.get(key, 0) > 0:
                    seg.pending_props[key] -= 1

    # -- identity / lifecycle ---------------------------------------------
    def update_client_id(self, new_id: int) -> None:
        """Adopt a new client ordinal (join/reconnect): pending segments are
        re-tagged so own-client visibility keeps holding (reference
        startOrUpdateCollaboration semantics)."""
        old = self.client_id
        if new_id == old:
            return
        self.client_id = new_id
        tree = self.tree
        tree.local_client = new_id
        for seg in tree.segments:
            if seg.ins_client == old and seg.ins_seq == UNASSIGNED_SEQ:
                seg.ins_client = new_id
            if seg.rem_client == old and seg.rem_seq == UNASSIGNED_SEQ:
                seg.rem_client = new_id
            if old in seg.rem_overlap:
                seg.rem_overlap = [new_id if c == old else c
                                   for c in seg.rem_overlap]

    def commit_detached(self) -> None:
        """Fold pending local edits into base (universal) state — used when a
        detached container attaches: its offline edits become part of the
        attach summary rather than ops."""
        tree = self.tree
        for seg in tree.segments:
            if seg.ins_seq == UNASSIGNED_SEQ:
                seg.ins_seq = 0
                seg.local_seq = None
            if seg.rem_seq == UNASSIGNED_SEQ:
                seg.rem_seq = 0
                seg.rem_local_seq = None
            seg.pending_props = None
        tree.pending_groups = []
        tree.zamboni()

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "segments": self.tree.snapshot_segments(),
            "seq": self.tree.current_seq,
            "minSeq": self.tree.min_seq,
        }

    @staticmethod
    def load(snap: dict, client_id: int = -1,
             device=None) -> "MergeTreeClient":
        client = MergeTreeClient(client_id, device=device)
        client.tree = MergeTreeOracle.load_segments(
            snap["segments"], local_client=client_id,
            min_seq=snap.get("minSeq", 0), current_seq=snap.get("seq", 0))
        return client
