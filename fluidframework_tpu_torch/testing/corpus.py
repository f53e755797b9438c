"""Recorded-session corpora: capture, pin, replay.

The reference regression-tests against CAPTURED op logs, replaying them
and byte-comparing snapshots across versions (reference
packages/test/snapshots/src/replayMultipleFiles.ts:1, LFS corpus per its
README). This module is the TPU-native equivalent without external
data: multi-client sessions drive the REAL alfred websocket + REST
stack (server/tinylicious.py -> LocalServer lambda pipeline), the
sequenced op log is fetched back through alfred's own /deltas catch-up
route, checked in under tests/corpus/, and replayed channel-level with
pinned end-state digests — any cross-version drift in sequencing or op
application semantics breaks the pin.

Corpus file format (gzip JSON lines):
  line 0: header {"doc", "workload", "seed", "channel_type", ...}
  line 1..n: alfred /deltas rows (scriptorium delta records) in seq order

A port of fluidframework_tpu's testing/corpus.py; the capture side is
testing/record_corpus.py over the port's alfred and tinylicious, and
writes only outside tests/corpus/. It reads the same checked-in corpora
under tests/corpus/ and their pins. A replay channel runs on `device` (None means "cuda", which raises
without CUDA): a bare channel takes its device from a runtime, so
make_channel binds it to a detached ContainerRuntime on that device.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from typing import Any, Dict, List, Tuple

CORPUS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "corpus")

# MessageType values the replayer handles (protocol/messages.py); all
# other row types (leaves, noops, summary acks) only advance sequence
# numbers, which ride in on the next op row's seq.
_OP = "op"
_JOIN = "join"


def write_corpus(path: str, header: dict, rows: List[dict]) -> None:
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")


def read_corpus(path: str) -> Tuple[dict, List[dict]]:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        lines = [line for line in f if line.strip()]
    return json.loads(lines[0]), [json.loads(ln) for ln in lines[1:]]


def make_channel(channel_type: str, device=None):
    """A fresh replica channel of the corpus's type, bound to a detached
    runtime on `device`."""
    if channel_type == "sequence":
        from ..dds.sequence import SharedString as cls
    elif channel_type == "items":
        from ..dds.sequence import SharedNumberSequence as cls
    elif channel_type == "matrix":
        from ..dds.matrix import SharedMatrix as cls
    elif channel_type == "directory":
        from ..dds.directory import SharedDirectory as cls
    else:
        raise ValueError(f"unknown corpus channel type {channel_type!r}")
    from ..runtime.container_runtime import ContainerRuntime
    store = ContainerRuntime(device=device).create_datastore("corpus")
    return store.create_channel("replay", cls.TYPE)


def channel_state(channel_type: str, channel) -> Any:
    """Canonical end state for digesting/pinning."""
    if channel_type == "sequence":
        return {
            "text": channel.get_text(),
            "segments": [
                {k: v for k, v in e.items() if k != "text"}
                | {"text": e.get("text", "")}
                for e in channel.client.tree.snapshot_segments()],
        }
    if channel_type == "items":
        return channel.get_items()
    if channel_type == "matrix":
        return channel.extract()
    if channel_type == "directory":
        return channel.root.to_dict()
    raise ValueError(channel_type)


def digest(state: Any) -> str:
    return hashlib.sha256(
        json.dumps(state, sort_keys=True, default=str)
        .encode("utf-8")).hexdigest()


def channel_ops(header: dict, rows: List[dict],
                channel_address: str | None = None):
    """The canonical row walk: yields (contents, seq, ref_seq, ordinal,
    min_seq) for the channel's op rows, interning quorum ordinals from
    join rows exactly as a catching-up replica would. Every consumer of
    a corpus (replay, bulk conformance, bench) shares this one filter so
    op subsets can never drift apart."""
    channel_address = channel_address or header.get("channel", "text")
    ordinals: Dict[str, int] = {}

    def ordinal(client_id) -> int:
        if client_id is None:
            return -1
        if client_id not in ordinals:
            ordinals[client_id] = len(ordinals)
        return ordinals[client_id]

    for row in rows:
        mtype = row.get("type")
        if mtype == _JOIN:
            data = row.get("data")
            try:
                detail = json.loads(data) if isinstance(data, str) else data
                ordinal(detail.get("clientId"))
            except (ValueError, AttributeError):
                pass
            continue
        if mtype != _OP:
            continue
        contents = row.get("contents")
        if isinstance(contents, str):
            contents = json.loads(contents)
        if not isinstance(contents, dict):
            continue
        envelope = contents.get("contents")
        if not isinstance(envelope, dict) or \
                envelope.get("address") != channel_address:
            continue
        yield (envelope.get("contents"), row["sequence_number"],
               row["reference_sequence_number"],
               ordinal(row.get("client_id")),
               row.get("minimum_sequence_number"))


def apply_ops(channel, ops) -> None:
    """Apply materialized channel_ops tuples remote-side — the ONE
    corpus apply loop (replay and the bench's timed region share it)."""
    for contents, seq, ref_seq, ordinal, min_seq in ops:
        channel.process_core(contents, False, seq, ref_seq, ordinal,
                             min_seq)


def replay(header: dict, rows: List[dict],
           channel_address: str | None = None, device=None):
    """Replay a recorded log into a fresh replica channel on `device`:
    sequenced messages apply remote-side exactly as a catching-up client
    would. Returns the channel."""
    channel = make_channel(header["channel_type"], device)
    apply_ops(channel, channel_ops(header, rows, channel_address))
    return channel


def channel_digest(channel_type: str, channel) -> str:
    return digest(channel_state(channel_type, channel))


def replay_digest(path: str, channel_address: str | None = None,
                  device=None) -> str:
    header, rows = read_corpus(path)
    channel = replay(header, rows, channel_address, device)
    return channel_digest(header["channel_type"], channel)


def load_pins() -> dict:
    with open(os.path.join(CORPUS_DIR, "pins.json")) as f:
        return json.load(f)
