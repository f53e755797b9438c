"""Replay tool: offline op replay + snapshot determinism validation.

Capability parity with reference packages/tools/replay-tool
(`replayMessages.ts`, 1064 LoC) and the snapshot-regression rig built on it
(packages/test/snapshots `replayMultipleFiles.ts`): load a captured
document (summary + op log), replay the ops through a real container,
generate summaries at a chosen frequency, and cross-validate determinism —
(a) two independent replays must produce byte-identical summaries at every
snapshot point, and (b) a container *loaded from* a generated mid-stream
summary and fed the remaining ops must agree with the straight-through
replay (the reference's storage-vs-incremental check).

A port of fluidframework_tpu's tools/replay_tool.py. Every container the
tool loads runs on `device` (None means "cuda", which raises without
CUDA): a straight load of a tail of 64 ops or more on a sequence with no
local references catches up through the scan-apply kernel
(kernels/csrc/scan_apply.cu). As in the reference, a failure inside the
storage check is recorded as a mismatch, not raised: the tool reports, so
a caller must require `deterministic`.

Unlike the reference, the tool loads its containers read-only
(CLIENT_DETAILS): the replay connection refuses every submit, and a
container that is not read-only submits a NO_OP heartbeat after 25
remote ops (DeltaManager.noop_threshold), so the reference's tool raises
PermissionError at the first snapshot point of a forward of 25 ops or
more, and records it as a mismatch inside the storage check.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.device import resolve_device
from ..loader.container import Container
from ..loader.drivers.file import FileDocumentCapture
from ..loader.drivers.replay import ReplayController, ReplayDocumentService
from ..protocol.messages import SequencedDocumentMessage
from ..protocol.summary import (SummaryTree, SummaryType,
                                summary_tree_to_dict)


# The replay connection is read-only: a read-only container never submits.
CLIENT_DETAILS = {"mode": "read"}


def canonical_summary(summary: SummaryTree) -> str:
    """Byte-stable serialization for comparison (sorted keys), with each
    sequence's acknowledged text coalesced (coalesce_sequences)."""
    return json.dumps(coalesce_sequences(summary_tree_to_dict(summary)),
                      sort_keys=True)


def _joinable(a, b) -> bool:
    """Two adjacent text segments that differ in their text alone (the
    same insert and removal stamps and properties)."""
    return isinstance(a, dict) and isinstance(b, dict) and \
        a.get("kind") == b.get("kind") == 0 and \
        isinstance(a.get("text"), str) and isinstance(b.get("text"), str) \
        and {k: v for k, v in a.items() if k != "text"} == \
        {k: v for k, v in b.items() if k != "text"}


def coalesce_sequences(node: dict) -> dict:
    """A summary tree in dict form with each sequence channel's body
    chunks replaced by one "segments" list in which adjacent text segments
    that differ in their text alone are joined: such a pair and its join
    are the same content to every client. The per-op replay and the bulk
    catch-up (MergeTreeClient.apply_bulk) reach the same text with
    different segment boundaries, so without this a storage check compares
    boundaries, not content (the JAX package's tool compares the raw
    bytes: ROADMAP Queue 3)."""
    if node.get("type") != SummaryType.TREE:
        return node
    entries = node["entries"]
    header = entries.get("header")
    if header is not None and header.get("type") == SummaryType.BLOB:
        try:
            head = json.loads(header["content"])
        except (TypeError, ValueError):
            head = None
        if isinstance(head, dict) and "chunkCount" in head and \
                "totalLength" in head:
            merged: list = []
            for i in range(head["chunkCount"]):
                for seg in json.loads(entries[f"body_{i}"]["content"]):
                    if merged and _joinable(merged[-1], seg):
                        merged[-1]["text"] += seg["text"]
                    else:
                        merged.append(seg)
            rest = {k: v for k, v in entries.items() if k != "header"
                    and not k.startswith("body_")}
            head = {k: v for k, v in head.items() if k != "chunkCount"}
            return {**node, "entries": {**rest, "header": head,
                                        "segments": merged}}
    return {**node, "entries": {k: coalesce_sequences(v)
                                for k, v in entries.items()}}


@dataclass
class ReplayArgs:
    """Knobs mirroring the reference's ReplayArgs (from/to/snapFreq/
    validate)."""

    from_seq: int = 0
    to_seq: Optional[int] = None
    snap_freq: Optional[int] = None   # snapshot every N ops; None = end only
    validate_storage: bool = True     # check (b): load-from-snapshot replay
    write_dir: Optional[str] = None   # persist generated snapshots


@dataclass
class SnapshotPoint:
    sequence_number: int
    summary: SummaryTree
    canonical: str


@dataclass
class ReplayResult:
    snapshots: List[SnapshotPoint] = field(default_factory=list)
    mismatches: List[str] = field(default_factory=list)
    final_seq: int = 0

    @property
    def deterministic(self) -> bool:
        return not self.mismatches


class ReplayTool:
    def __init__(self, summary: SummaryTree,
                 ops: List[SequencedDocumentMessage], device=None):
        self.summary = summary
        self.ops = ops
        self.device = resolve_device(device)

    @staticmethod
    def from_capture(directory: str, device=None) -> "ReplayTool":
        capture = FileDocumentCapture(directory)
        summary = capture.read_summary()
        if summary is None:
            raise FileNotFoundError(f"no summary in {directory}")
        return ReplayTool(summary, capture.read_ops(), device=device)

    # -- core replay -------------------------------------------------------
    def _open(self, replay_to: int) -> tuple:
        controller = ReplayController(replay_to=replay_to)
        service = ReplayDocumentService(self.summary, self.ops, controller)
        container = Container.load("replay", service,
                                   client_details=CLIENT_DETAILS,
                                   device=self.device)
        return container, controller

    def run(self, args: Optional[ReplayArgs] = None) -> ReplayResult:
        args = args or ReplayArgs()
        result = ReplayResult()
        last = self.ops[-1].sequence_number if self.ops else 0
        end = min(args.to_seq, last) if args.to_seq is not None else last

        # Snapshot points: every snap_freq ops, plus the end.
        points: List[int] = []
        if args.snap_freq:
            seq = args.from_seq + args.snap_freq
            while seq < end:
                points.append(seq)
                seq += args.snap_freq
        points.append(end)

        container, controller = self._open(replay_to=args.from_seq)
        shadow, shadow_ctl = self._open(replay_to=args.from_seq)
        for point in points:
            controller.forward(point)
            shadow_ctl.forward(point)
            summary = container._assemble_summary()
            canonical = canonical_summary(summary)
            result.snapshots.append(SnapshotPoint(point, summary, canonical))
            # (a) Replay-vs-replay determinism.
            if canonical_summary(shadow._assemble_summary()) != canonical:
                result.mismatches.append(
                    f"replay divergence at seq {point}")
            # (b) Storage check: load from this summary + op tail.
            if args.validate_storage:
                self._validate_from_snapshot(summary, point, end,
                                             result)
        result.final_seq = end
        if args.write_dir:
            for snap in result.snapshots:
                capture = FileDocumentCapture(
                    f"{args.write_dir}/snapshot_{snap.sequence_number}")
                capture.write_summary(snap.summary)
        return result

    def _validate_from_snapshot(self, summary: SummaryTree, at_seq: int,
                                end: int, result: ReplayResult) -> None:
        controller = ReplayController(replay_to=at_seq)
        tail = [m for m in self.ops if m.sequence_number > at_seq
                and m.sequence_number <= end]
        service = ReplayDocumentService(summary, tail, controller)
        try:
            container = Container.load("replay-check", service,
                                       client_details=CLIENT_DETAILS,
                                       device=self.device)
            controller.forward(end)
            reference_ctl: ReplayController
            straight, reference_ctl = self._open(replay_to=end)
            if (canonical_summary(container._assemble_summary())
                    != canonical_summary(straight._assemble_summary())):
                result.mismatches.append(
                    f"storage replay divergence from snapshot at {at_seq}")
        except Exception as exc:  # noqa: BLE001 — report, don't abort tool
            result.mismatches.append(
                f"storage replay failed from snapshot at {at_seq}: {exc!r}")
