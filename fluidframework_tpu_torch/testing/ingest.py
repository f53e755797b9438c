"""Seeded partition traffic as raw wire bytes, for the sequencer lambda.

Every builder returns waves: lists of frames (offset, document id, bytes),
each frame one serialized boxcar in the raw log's encoding (the JSON of
server/wire.boxcar_to_wire: tenantId, documentId, clientId, then the
messages). The same bytes feed either package's lambda: `handler_raw`
directly, or `handler` after that package's own `boxcar_from_wire`.
Only json and random are used, so the traffic does not depend on torch.

- `serving_waves`: the serving-ingest fleet. Every document typed by one
  client, `ops_per_doc` single-position inserts per wave, each boxcar on
  one refSeq (the client typed the burst without processing anything in
  between), refs advancing per wave.
- `storm_waves`: the ragged fleet. One storm document typing 128-op waves
  atop 63 keystroke documents typing two ops a wave.
- `summary_waves`: the async-summary overlap. One client per document,
  then waves of one-character inserts on random documents, each marked to
  flush after it or not; the caller starts an async summary after each
  wave while the next wave sequences.
- `mixed_waves`: every family the lambda materializes (SharedString
  text, markers, removes and annotates; SharedMap sets, deletes and
  clears; SharedCell; SharedCounter; SharedMatrix axes and cells;
  SharedDirectory storage and subdirectories), with joins and leaves and
  the messages the sequencer refuses: stale refSeqs (nacked), duplicate
  clientSeqs (dropped), writers that never joined (nacked), and, when
  asked, undecodable frames. A per-document model of the deli keeps every
  well-formed op admitted and every position inside the text its client
  sees.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Tuple

Frame = Tuple[int, str, bytes]

OP_INSERT, OP_REMOVE, OP_ANNOTATE = 0, 1, 2
OPERATION = "op"
CLIENT_JOIN = "join"
CLIENT_LEAVE = "leave"


def message(csn: int, ref: int, type_: str = OPERATION, contents=None,
            data: Optional[str] = None) -> dict:
    """One message in the wire form of a DocumentMessage."""
    return {"client_sequence_number": csn,
            "reference_sequence_number": ref, "type": type_,
            "contents": contents, "metadata": None,
            "server_metadata": None, "traces": [], "data": data}


def join(client_id: str) -> dict:
    return message(0, -1, CLIENT_JOIN,
                   data=json.dumps({"clientId": client_id, "detail": {}}))


def leave(client_id: str) -> dict:
    return message(0, -1, CLIENT_LEAVE,
                   data=json.dumps({"clientId": client_id}))


def channel_op(csn: int, ref: int, channel: str, op,
               store: str = "s") -> dict:
    """A channel op addressed to (store, channel)."""
    return message(csn, ref, contents={
        "address": store, "contents": {"address": channel,
                                       "contents": op}})


def boxcar(tenant: str, doc: str, client: Optional[str],
           messages: List[dict]) -> bytes:
    return json.dumps({"tenantId": tenant, "documentId": doc,
                       "clientId": client,
                       "contents": messages}).encode("utf-8")


def summary_waves(docs: int, waves: int, ops_per_wave: int,
                  seed: int = 909_090, flush_p: float = 0.4):
    """(joins, waves): the join frames of documents d0..d{docs-1} (client
    c-<doc>), and `waves` lists of (frame, flush) pairs: `ops_per_wave`
    one-character inserts at position 0 of a random document, each
    followed by a flush with probability `flush_p`."""
    rng = random.Random(seed)
    names = [f"d{i}" for i in range(docs)]
    off = 0
    joins: List[Frame] = []
    for doc in names:
        joins.append((off, doc, boxcar("t", doc, f"c-{doc}",
                                       [join(f"c-{doc}")])))
        off += 1
    out = []
    csn = dict.fromkeys(names, 0)
    for _ in range(waves):
        wave = []
        for _ in range(ops_per_wave):
            doc = rng.choice(names)
            csn[doc] += 1
            op = {"type": OP_INSERT, "pos1": 0,
                  "seg": {"text": chr(97 + off % 26)}}
            frame = (off, doc, boxcar("t", doc, f"c-{doc}", [
                channel_op(csn[doc], 0, "t", op)]))
            off += 1
            wave.append((frame, rng.random() < flush_p))
        out.append(wave)
    return joins, out


def warm_waves(ops_per_doc: int) -> int:
    """Waves that carry every document past 256 rows a lane plus slack,
    so the fleet's capacity promotions and first fold land before the
    measured waves."""
    return max(3, -(-256 // max(1, ops_per_doc)) + 2)


def serving_waves(docs: int, ops_per_doc: int, waves: int,
                  start: int = 0) -> List[List[Frame]]:
    """Waves start .. start + waves - 1 of the serving-ingest fleet
    (documents d0.., clients c0..; wave 0 opens with each client's
    join). Each frame is written from the JSON of its messages'
    templates: the bytes of `boxcar` over `channel_op` messages
    (serving_waves_plain), without a json.dumps a message."""
    typed = {n: _message_template(channel_op(
        _CSN, _REF, "t", {"type": OP_INSERT, "pos1": 0,
                          "seg": {"text": "x" * n}})) for n in (1, 2, 3)}
    out = []
    for wave in range(start, start + waves):
        rng = random.Random(17 + wave)
        frames = []
        base = wave * ops_per_doc
        for d in range(docs):
            doc, client = f"d{d}", f"c{d}"
            msgs = [json.dumps(join(client))] if wave == 0 else []
            for i in range(ops_per_doc):
                msgs.append(typed[rng.randrange(1, 4)] % (base + i + 1,
                                                          base))
            head = json.dumps({"tenantId": "b", "documentId": doc,
                               "clientId": client, "contents": []})[:-2]
            frames.append((wave * docs + d, doc, (
                head + ", ".join(msgs) + "]}").encode("utf-8")))
        out.append(frames)
    return out


def serving_waves_plain(docs: int, ops_per_doc: int, waves: int,
                        start: int = 0) -> List[List[Frame]]:
    """serving_waves built message by message with `boxcar`: the
    reference its templates are held to."""
    out = []
    for wave in range(start, start + waves):
        rng = random.Random(17 + wave)
        frames = []
        base = wave * ops_per_doc
        for d in range(docs):
            doc = f"d{d}"
            msgs = [join(f"c{d}")] if wave == 0 else []
            for i in range(ops_per_doc):
                n = rng.randrange(1, 4)
                msgs.append(channel_op(base + i + 1, base, "t", {
                    "type": OP_INSERT, "pos1": 0,
                    "seg": {"text": "x" * n}}))
            frames.append((wave * docs + d, doc,
                           boxcar("b", doc, f"c{d}", msgs)))
        out.append(frames)
    return out


# Stand-ins for a message's clientSeq and refSeq in its JSON template.
_CSN, _REF = -918273645, -918273646


def _message_template(msg: dict) -> str:
    """json.dumps(msg) as a %-template of its clientSeq and refSeq (msg
    holds _CSN and _REF there)."""
    text = json.dumps(msg).replace("%", "%%")
    if text.count(str(_CSN)) != 1 or text.count(str(_REF)) != 1:
        raise ValueError(f"no single clientSeq and refSeq in {text}")
    return text.replace(str(_CSN), "%d").replace(str(_REF), "%d")


def storm_waves(waves: int, docs: int = 64, ops_keystroke: int = 2,
                storm_ops: int = 128, start: int = 0
                ) -> List[List[Frame]]:
    """Waves of the ragged fleet: document m0 types storm_ops inserts a
    wave, m1.. type ops_keystroke each."""
    out = []
    for wave in range(start, start + waves):
        rng = random.Random(7 + wave)
        frames = []
        for d in range(docs):
            doc = f"m{d}"
            n = storm_ops if d == 0 else ops_keystroke
            base = wave * n
            msgs = [join(f"c{d}")] if wave == 0 else []
            for i in range(n):
                msgs.append(channel_op(base + i + 1, base, "t", {
                    "type": OP_INSERT, "pos1": 0,
                    "seg": {"text": "z" * rng.randrange(1, 3)}}))
            frames.append((wave * docs + d, doc,
                           boxcar("g", doc, f"c{d}", msgs)))
        out.append(frames)
    return out


class _Deli:
    """One document's sequencing, as the deli does it (server/
    ticket_kernel.py): enough to give each generated op a refSeq inside
    the collaboration window and to know what the sequencer admits."""

    def __init__(self):
        self.refs: Dict[str, int] = {}   # joined client -> latest refSeq
        self.cseq: Dict[str, int] = {}   # joined client -> last clientSeq
        self.next_seq = 1
        self.msn = 0

    def _ticket(self) -> int:
        seq = self.next_seq
        if self.refs:
            self.msn = max(self.msn, min(self.refs.values()))
        self.msn = min(self.msn, seq - 1)
        self.next_seq += 1
        return seq

    def join(self, client: str) -> None:
        self.refs[client] = self.next_seq - 1
        self.cseq[client] = 0
        self._ticket()

    def leave(self, client: str) -> bool:
        """Sequences the leave; True when the table emptied, in which
        case the sequencer also sequences a NoClient message."""
        self.refs.pop(client)
        self.cseq.pop(client)
        self._ticket()
        if not self.refs:
            self._ticket()
            return True
        return False

    def op(self, client: str, csn: int, ref: int) -> str:
        """'ok', 'dup', 'stale' or 'unjoined' for an op of `client`."""
        if client not in self.refs:
            return "unjoined"
        if csn <= self.cseq[client]:
            return "dup"
        if ref < self.msn:
            return "stale"
        self.refs[client] = ref
        self.cseq[client] = csn
        self._ticket()
        return "ok"


class _MixedDoc:
    """One document of the mixed stream: its clients, its families, and
    the lengths its text and matrix axes have once every admitted op so
    far is applied."""

    FAMILIES = ("text", "map", "cell", "counter", "matrix", "directory")

    def __init__(self, name: str, rng: random.Random):
        self.name = name
        self.deli = _Deli()
        k = rng.randrange(1, len(self.FAMILIES) + 1)
        self.families = ["text"] + rng.sample(self.FAMILIES[1:], k - 1)
        self.clients: List[str] = []
        self.next_client = 0
        self.csn: Dict[str, int] = {}
        self.text_len = 0
        self.rows = 0
        self.cols = 0
        self.row_runs = 0
        self.col_runs = 0
        self.subdirs: List[str] = []


def _text_op(doc: _MixedDoc, rng: random.Random) -> dict:
    r = rng.random()
    if doc.text_len and r < 0.2:
        a = rng.randrange(doc.text_len)
        b = min(doc.text_len, a + rng.randrange(1, 4))
        doc.text_len -= b - a
        return {"type": OP_REMOVE, "pos1": a, "pos2": b}
    if doc.text_len and r < 0.3:
        a = rng.randrange(doc.text_len)
        b = min(doc.text_len, a + rng.randrange(1, 5))
        return {"type": OP_ANNOTATE, "pos1": a, "pos2": b,
                "props": {"bold": rng.random() < 0.5,
                          "size": rng.randrange(8, 16)}}
    pos = rng.randrange(doc.text_len + 1)
    if r < 0.35:
        doc.text_len += 1
        return {"type": OP_INSERT, "pos1": pos,
                "seg": {"marker": True, "props": {"tag": "p"}}}
    text = "".join(rng.choice("abcdefgh✓") for _ in range(
        rng.randrange(1, 6)))
    doc.text_len += len(text)
    return {"type": OP_INSERT, "pos1": pos, "seg": {"text": text}}


def _matrix_op(doc: _MixedDoc, rng: random.Random, nonce: int) -> dict:
    r = rng.random()
    if doc.rows and doc.cols and r < 0.5:
        key = (f"{nonce}.{rng.randrange(1, doc.row_runs + 1)}.0|"
               f"{nonce + 1}.{rng.randrange(1, doc.col_runs + 1)}.0")
        return {"target": "cell", "key": key,
                "value": rng.randrange(1000)}
    axis = "rows" if r < 0.75 else "cols"
    length = doc.rows if axis == "rows" else doc.cols
    if length > 2 and rng.random() < 0.2:
        a = rng.randrange(length - 1)
        if axis == "rows":
            doc.rows -= 1
        else:
            doc.cols -= 1
        return {"target": axis,
                "op": {"type": OP_REMOVE, "pos1": a, "pos2": a + 1}}
    count = rng.randrange(1, 4)
    if axis == "rows":
        doc.row_runs += 1
        doc.rows += count
        run = [nonce, doc.row_runs, 0, count]
    else:
        doc.col_runs += 1
        doc.cols += count
        run = [nonce + 1, doc.col_runs, 0, count]
    return {"target": axis, "op": {"type": OP_INSERT,
                                   "pos1": rng.randrange(length + 1),
                                   "seg": {"run": run}}}


def _directory_op(doc: _MixedDoc, rng: random.Random) -> dict:
    r = rng.random()
    paths = ["/"] + doc.subdirs
    if r < 0.15 and len(doc.subdirs) < 4:
        name = f"sub{len(doc.subdirs)}"
        parent = rng.choice(paths)
        doc.subdirs.append(parent.rstrip("/") + "/" + name)
        return {"type": "createSubDirectory", "path": parent,
                "name": name}
    if r < 0.2 and doc.subdirs:
        path = doc.subdirs[-1]
        parent, name = path.rsplit("/", 1)
        doc.subdirs = [p for p in doc.subdirs
                       if p != path and not p.startswith(path + "/")]
        return {"type": "deleteSubDirectory", "path": parent or "/",
                "name": name}
    path = rng.choice(paths)
    if r < 0.3:
        kop = {"type": "delete", "key": f"k{rng.randrange(4)}"}
    elif r < 0.33:
        kop = {"type": "clear"}
    else:
        kop = {"type": "set", "key": f"k{rng.randrange(4)}",
               "value": {"v": rng.randrange(100)}}
    return {"type": "storage", "path": path, "op": kop}


def _family_op(doc: _MixedDoc, family: str, rng: random.Random,
               nonce: int) -> Tuple[str, object]:
    """(channel, op) of one well-formed op of `family`."""
    if family == "text":
        return "t", _text_op(doc, rng)
    if family == "map":
        r = rng.random()
        # MapKernel ops carry a pid: the sequencer routes a set, delete
        # or clear to the map's lane only with one.
        if r < 0.15:
            return "m", {"type": "delete", "key": f"k{rng.randrange(5)}",
                         "pid": "p"}
        if r < 0.2:
            return "m", {"type": "clear", "pid": "p"}
        return "m", {"type": "set", "key": f"k{rng.randrange(5)}",
                     "value": {"deep": [rng.randrange(50), None]},
                     "pid": "p"}
    if family == "cell":
        if rng.random() < 0.1:
            return "c", {"type": "deleteCell"}
        return "c", {"type": "setCell", "value": rng.randrange(1000)}
    if family == "counter":
        return "n", {"type": "increment",
                     "delta": rng.randrange(-5, 50)}
    if family == "matrix":
        return "x", _matrix_op(doc, rng, nonce)
    return "dir", _directory_op(doc, rng)


def mixed_waves(docs: int, waves: int, seed: int = 0,
                ops_per_boxcar: Tuple[int, int] = (1, 8),
                poison: bool = False, tenant: str = "x",
                doc_prefix: str = "x",
                heavy: Optional[Tuple[int, int]] = None
                ) -> List[List[Frame]]:
    """`waves` waves of the mixed-family stream over `docs` documents;
    each wave carries one boxcar per document (and, now and then, one
    more from a writer that never joined). heavy=(stride, ops) adds `ops`
    text ops a wave to every stride-th document's boxcar, so their lanes
    outgrow the first capacity bucket. Offsets count frames from 0 across
    the waves."""
    rng = random.Random(seed)
    state = [_MixedDoc(f"{doc_prefix}{d}", rng) for d in range(docs)]
    out: List[List[Frame]] = []
    offset = 0
    for wave in range(waves):
        frames: List[Frame] = []
        for d, doc in enumerate(state):
            deli = doc.deli
            msgs: List[dict] = []
            if not doc.clients or (rng.random() < 0.08
                                   and len(doc.clients) < 4):
                cid = f"{doc.name}-c{doc.next_client}"
                doc.next_client += 1
                doc.clients.append(cid)
                doc.csn[cid] = 0
                msgs.append(join(cid))
                deli.join(cid)
            client = rng.choice(doc.clients)
            n_ops = rng.randrange(*ops_per_boxcar)
            heavy_ops = heavy[1] if heavy and d % heavy[0] == 0 else 0
            for i in range(n_ops + heavy_ops):
                r = rng.random()
                if r < 0.03:
                    # A stale refSeq: nacked, nothing applies.
                    doc.csn[client] += 1
                    msgs.append(channel_op(doc.csn[client], -5, "t", {
                        "type": OP_INSERT, "pos1": 0,
                        "seg": {"text": "stale"}}))
                    assert deli.op(client, doc.csn[client], -5) == "stale"
                    continue
                if r < 0.06 and deli.cseq[client] > 0:
                    # A redelivered clientSeq: dropped silently.
                    csn = deli.cseq[client]
                    msgs.append(channel_op(csn, deli.next_seq - 1, "t", {
                        "type": OP_INSERT, "pos1": 0,
                        "seg": {"text": "dup"}}))
                    assert deli.op(client, csn, deli.next_seq - 1) == "dup"
                    continue
                family = "text" if i >= n_ops else \
                    rng.choice(doc.families)
                channel, op = _family_op(doc, family, rng, 1000 + d * 2)
                doc.csn[client] += 1
                ref = deli.next_seq - 1
                msgs.append(channel_op(doc.csn[client], ref, channel, op))
                assert deli.op(client, doc.csn[client], ref) == "ok"
            if len(doc.clients) > 1 and rng.random() < 0.05:
                # The boxcar's writer leaves (a leave cuts the window).
                msgs.append(leave(client))
                deli.leave(client)
                doc.clients.remove(client)
            elif len(doc.clients) == 1 and rng.random() < 0.02:
                # The last writer leaves: the sequencer adds NoClient.
                msgs.append(leave(client))
                deli.leave(client)
                doc.clients.remove(client)
            frames.append((offset, doc.name,
                           boxcar(tenant, doc.name, client, msgs)))
            offset += 1
            if rng.random() < 0.02:
                # A writer that never joined: nacked.
                frames.append((offset, doc.name, boxcar(
                    tenant, doc.name, f"{doc.name}-ghost",
                    [channel_op(1, deli.next_seq - 1, "t", {
                        "type": OP_INSERT, "pos1": 0,
                        "seg": {"text": "ghost"}})])))
                offset += 1
            if poison and rng.random() < 0.01:
                frames.append((offset, doc.name,
                               b'{"documentId": "' + doc.name.encode()
                               + b'", "contents": [{{{'))
                offset += 1
        out.append(frames)
    return out
