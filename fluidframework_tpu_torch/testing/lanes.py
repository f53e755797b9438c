"""Seeded op schedules for the sequencer's lane stores.

`LaneFleet` turns a testing/serving.py FleetSpec into the traffic a
partition's lane stores take: one SharedString channel per document
(`merge_key(lane)`) and one SharedMap channel on each of the first
`lww_docs` documents (`map_key(lane)`), `windows` windows of `ops` merge
ops per document of each class and `LWW_OPS` map ops per SharedMap, then
backlogs (`backlog`, a long stream on some documents) and hot documents
(`hot_entries`: `rows` snapshot entries to seed, for the classes with
rows > 0). A wide SharedMap (`WIDE_MAP_KEY`) takes WIDE_KEYS_PER_WINDOW new
keys a window, so its key set outgrows the first LWW bucket.

Schedules are plain tuples, so the same schedule can go through either
package's stores; `merge_stream(builder, schedule)` makes HostOps with the
store's own OpBuilder (two builders fed the same schedules in the same
order assign the same op ids) and `lww_stream(store, schedule)` makes LWW
ops with the store's own interning (LwwLaneStore.wire_to_op):

  ("insert", pos, text, ref_seq, client, seq, msn)
  ("remove", start, end, ref_seq, client, seq, msn)
  ("annotate", start, end, props, ref_seq, client, seq, msn)
  (wire_op dict, seq)                                     an LWW op

Every merge op is sequenced at refSeq = seq - 1 by one of the document's
clients with the collaboration window ACK_LAG ops behind (msn = seq -
ACK_LAG), and the generator tracks each document's length, so every
position is valid. The mix: 70% inserts of 1-4 characters (at the end
for most of a typing class's, else anywhere), removes of 1-4 characters,
and annotates at ANNOTATE_RATE on spans of 1-8 characters.
`annotate_storm` gives one document more annotates on one span in a
single window than the annotate ring holds: the overflow that only a
host rescue recovers.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np

from .serving import LWW_OPS, DocClass, FleetSpec

ACK_LAG = 8
ANNOTATE_RATE = 0.05
MAP_KEYS = 16                 # key pool of an ordinary SharedMap
WIDE_MAP_KEY = ("wide", "default", "root")
WIDE_KEYS_PER_WINDOW = 40
ANNOTATE_STORM = 6            # > the annotate ring's 4 slots


def merge_key(lane: int) -> tuple:
    return (f"doc{lane}", "default", "text")


def map_key(lane: int) -> tuple:
    return (f"doc{lane}", "default", "root")


class _Doc:
    __slots__ = ("lane", "cls", "seq", "length", "map_seq")

    def __init__(self, lane: int, cls):
        self.lane = lane
        self.cls = cls
        self.seq = 0
        self.length = 0
        self.map_seq = 0


class LaneFleet:
    """Generates a fleet's windows, backlogs and hot seeds from a seed."""

    def __init__(self, spec: FleetSpec, seed: int = 0):
        self.spec = spec
        self.rng = random.Random(seed)
        self.docs: List[_Doc] = []
        self.hot: List[_Doc] = []
        for cls in spec.classes:
            for _ in range(cls.count):
                doc = _Doc(len(self.docs) + len(self.hot), cls)
                (self.hot if cls.rows else self.docs).append(doc)
        self.wide_keys = 0
        self.wide_seq = 0

    # -- merge ops -----------------------------------------------------------
    def _merge_op(self, doc: _Doc, typing: bool) -> tuple:
        rng = self.rng
        doc.seq += 1
        seq = doc.seq
        client = rng.randrange(doc.cls.clients)
        msn = max(0, seq - ACK_LAG)
        r = rng.random()
        if doc.length == 0 or r < 0.70:
            pos = doc.length if typing and rng.random() < 0.8 \
                else rng.randint(0, doc.length)
            text = "".join(rng.choice("abcdefgh")
                           for _ in range(rng.randint(1, 4)))
            doc.length += len(text)
            return ("insert", pos, text, seq - 1, client, seq, msn)
        start = rng.randint(0, doc.length - 1)
        if r < 1.0 - ANNOTATE_RATE:
            end = rng.randint(start + 1, min(doc.length, start + 4))
            doc.length -= end - start
            return ("remove", start, end, seq - 1, client, seq, msn)
        end = rng.randint(start + 1, min(doc.length, start + 8))
        props = {rng.choice("ab"): rng.choice((1, 2, None))}
        return ("annotate", start, end, props, seq - 1, client, seq, msn)

    def window(self) -> Tuple[Dict[tuple, list], Dict[tuple, list]]:
        """One window: ({merge key: schedule}, {map key: schedule})."""
        merge: Dict[tuple, list] = {}
        lww: Dict[tuple, list] = {}
        for doc in self.docs:
            typing = doc.cls.burst == 0.0
            merge[merge_key(doc.lane)] = [self._merge_op(doc, typing)
                                          for _ in range(doc.cls.ops)]
            if doc.lane < self.spec.lww_docs:
                lww[map_key(doc.lane)] = [self._map_op(doc)
                                          for _ in range(LWW_OPS)]
        wide = []
        for _ in range(WIDE_KEYS_PER_WINDOW):
            self.wide_seq += 1
            wide.append(({"type": "set", "key": f"w{self.wide_keys}",
                          "value": self.wide_keys, "pid": "p"},
                         self.wide_seq))
            self.wide_keys += 1
        lww[WIDE_MAP_KEY] = wide
        return merge, lww

    def _map_op(self, doc: _Doc) -> tuple:
        rng = self.rng
        doc.map_seq += 1
        r = rng.random()
        key = f"k{rng.randrange(MAP_KEYS)}"
        if r < 0.7:
            op = {"type": "set", "key": key, "pid": "p",
                  "value": {"v": rng.randrange(1000)}}
        elif r < 0.9:
            op = {"type": "delete", "key": key, "pid": "p"}
        elif r < 0.97:
            op = {"type": "increment", "delta": rng.randint(-5, 5)}
        else:
            op = {"type": "clear", "pid": "p"}
        return (op, doc.map_seq)

    def backlog(self, n_ops: int) -> Dict[tuple, list]:
        """One long stream of n_ops merge ops on every document of the
        last class without pre-seeded rows (the storm documents) and on
        every hot document."""
        storm = [c for c in self.spec.classes if not c.rows][-1]
        out: Dict[tuple, list] = {}
        for doc in self.docs + self.hot:
            if doc.cls == storm or doc.cls.rows:
                out[merge_key(doc.lane)] = [self._merge_op(doc, False)
                                            for _ in range(n_ops)]
        return out

    def touch(self, stride: int) -> Dict[tuple, list]:
        """One op on every stride-th document (a dirty-epoch pass)."""
        return {merge_key(doc.lane): [self._merge_op(doc, True)]
                for doc in self.docs[::stride]}

    def annotate_storm(self, lane: int) -> list:
        """ANNOTATE_STORM annotates of one span of document `lane`, each
        with a key of its own."""
        doc = next(d for d in self.docs + self.hot if d.lane == lane)
        out = []
        if doc.length == 0:
            out.append(self._merge_op(doc, True))
        end = min(doc.length, 6)
        for i in range(ANNOTATE_STORM):
            doc.seq += 1
            out.append(("annotate", 0, end, {f"s{i}": i}, doc.seq - 1, 0,
                        doc.seq, max(0, doc.seq - ACK_LAG)))
        return out

    # -- hot documents ---------------------------------------------------
    def hot_entries(self) -> Dict[tuple, list]:
        """Snapshot entries of every hot document: `rows` text segments of
        1-4 characters at seq 0 (visible to every client)."""
        out: Dict[tuple, list] = {}
        for doc in self.hot:
            entries = [{"text": "".join(self.rng.choice("wxyz")
                                        for _ in range(
                                            self.rng.randint(1, 4)))}
                       for _ in range(doc.cls.rows)]
            doc.length = sum(len(e["text"]) for e in entries)
            out[merge_key(doc.lane)] = entries
        return out


def merge_stream(builder, schedule) -> list:
    """Schedule tuples -> HostOps through `builder` (either package's
    OpBuilder)."""
    out = []
    for op in schedule:
        kind = op[0]
        if kind == "insert":
            _, pos, text, ref, client, seq, msn = op
            out.append(builder.insert_text(pos, text, ref, client, seq,
                                           msn=msn))
        elif kind == "remove":
            _, start, end, ref, client, seq, msn = op
            out.append(builder.remove(start, end, ref, client, seq,
                                      msn=msn))
        else:
            _, start, end, props, ref, client, seq, msn = op
            out.append(builder.annotate(start, end, props, ref, client,
                                        seq, msn=msn))
    return out


def merge_streams(builder, schedules: Dict[tuple, list]) -> Dict[tuple, list]:
    return {key: merge_stream(builder, s) for key, s in schedules.items()}


def lww_stream(store, schedule) -> list:
    """(wire op, seq) pairs -> LWW ops through `store.wire_to_op` (either
    package's LwwLaneStore)."""
    return [store.wire_to_op(op, seq) for op, seq in schedule]


def lww_streams(store, schedules: Dict[tuple, list]) -> Dict[tuple, list]:
    return {key: lww_stream(store, s) for key, s in schedules.items()}


# ---------------------------------------------------------------------------
# one scenario for every store
# ---------------------------------------------------------------------------

# The lane-store golden's fleet: a few documents of each FULL_RING class,
# one hot document (300 rows: it seeds the bucketed store's widest bucket
# too), four SharedMaps and the wide map; 8 windows, a 700-op backlog on
# the storm documents, the annotate storm on document 0, a dirty pass on
# every DIRTY_STRIDE-th document.
GOLDEN_SPEC = FleetSpec(
    classes=(DocClass(6, 2, 1, 0.0), DocClass(3, 8, 2, 0.3),
             DocClass(2, 16, 3, 0.8), DocClass(1, 16, 3, 0.8, rows=300)),
    lww_docs=4, windows=8, steps=16)
GOLDEN_SEED = 3
BACKLOG_OPS = 700
DIRTY_STRIDE = 4
RECOVERY_COUNTS = ("folds", "fold_rows_reclaimed", "overflow_drops",
                   "fold_rescue_dispatches", "paged_rescues",
                   "page_compactions")


def scenario(spec: FleetSpec, seed: int, backlog_ops: int = BACKLOG_OPS,
             dirty_stride: int = DIRTY_STRIDE) -> list:
    """The whole traffic of one lane-store run as a list of steps:
    ("seed", {key: entries}), ("window", merge, lww) x spec.windows,
    ("backlog", merge) (the storm and hot documents' backlog + the
    annotate storm), ("extract",), ("window", touch, {}) on every
    dirty_stride-th document, ("extract",)."""
    fleet = LaneFleet(spec, seed)
    steps: list = [("seed", fleet.hot_entries())]
    for _ in range(spec.windows):
        merge, lww = fleet.window()
        steps.append(("window", merge, lww))
    back = fleet.backlog(backlog_ops)
    back[merge_key(0)] = fleet.annotate_storm(0)
    steps.append(("backlog", back))
    steps.append(("extract",))
    steps.append(("window", fleet.touch(dirty_stride), {}))
    steps.append(("extract",))
    return steps


def _timed(timer, label, fn):
    return fn() if timer is None else timer(label, fn)


def run_scenario(steps: list, merge=None, lww=None, timer=None) -> dict:
    """Drive either package's MergeLaneStore (`merge`) and LwwLaneStore
    (`lww`) through `steps`; timer(label, fn), when given, runs each store
    call (labels "seed", "window<i>", "backlog", "lww<i>", "extract<i>").
    Returns {"seeded": {key: bool}, "extracts": [extract_all results]}."""
    out: dict = {"seeded": {}, "extracts": []}
    w = 0
    for step in steps:
        kind = step[0]
        if kind == "seed" and merge is not None:
            def seed_all(entries=step[1]):
                return {key: merge.seed(key, e, 0, 0)
                        for key, e in entries.items()}
            out["seeded"] = _timed(timer, "seed", seed_all)
        elif kind in ("window", "backlog"):
            label = "backlog" if kind == "backlog" else f"window{w}"
            if merge is not None:
                streams = merge_streams(merge.builder, step[1])
                _timed(timer, label, lambda s=streams: merge.apply(s))
            if kind == "window" and lww is not None and step[2]:
                streams = lww_streams(lww, step[2])
                _timed(timer, f"lww{w}", lambda s=streams: lww.apply(s))
            w += kind == "window"
        elif kind == "extract" and merge is not None:
            out["extracts"].append(_timed(
                timer, f"extract{len(out['extracts'])}", merge.extract_all))
    return out


def store_results(merge=None, lww=None) -> dict:
    """What the golden and the card are held to: per merge channel its
    placement, text and entries, the recovery counts; per LWW channel its
    placement and snapshot. Keys are joined with "|"."""
    out: dict = {}
    if merge is not None:
        keys = sorted(merge.where, key=repr)
        out["merge"] = {
            "where": {_name(k): list(merge.where[k]) for k in keys},
            "opaque": sorted(_name(k) for k in merge.opaque),
            "text": {_name(k): merge.text(k) for k in keys},
            "entries": {_name(k): merge.entries(k) for k in keys},
            "counts": {a: getattr(merge, a) for a in RECOVERY_COUNTS},
            # channels reseeded by a snapshot seed, a fold or a rescue
            "reseeded": sorted(_name(k) for k in merge._fold_payloads),
        }
    if lww is not None:
        keys = sorted(lww.where, key=repr)
        out["lww"] = {
            "where": {_name(k): list(lww.where[k]) for k in keys},
            "opaque": sorted(_name(k) for k in lww.opaque),
            "snapshot": {_name(k): lww.snapshot(k) for k in keys},
        }
    return out


def cross_store_mismatches(bucketed: dict, paged: dict,
                           extracts: Tuple[list, list]) -> List[str]:
    """Where a bucketed and a paged store's results (store_results, with
    their extract_all lists) disagree: every channel's text and the
    flattened visible content (host.flatten_snapshot_content) of every
    snapshot must match to the character; raw entries must match on every
    channel neither store reseeded (a fold coalesces acked rows and keeps
    its own segmentation of the collaboration window's tombstones, as the
    JAX package's cross-engine bar allows). Returns the mismatches."""
    from ..mergetree.host import flatten_snapshot_content
    bad = []
    b, p = bucketed["merge"], paged["merge"]
    for key, text in b["text"].items():
        if key in p["text"] and p["text"][key] != text:
            bad.append(f"text {key}")
    reseeded = set(b["reseeded"]) | set(p["reseeded"])
    for key, entries in b["entries"].items():
        if key in p["entries"] and key not in reseeded \
                and p["entries"][key] != entries:
            bad.append(f"entries {key}")
    for i, (xb, xp) in enumerate(zip(*extracts)):
        for key in xb:
            if key in xp and flatten_snapshot_content(xb[key]) \
                    != flatten_snapshot_content(xp[key]):
                bad.append(f"extract {i} {key}")
    return bad


def named_extract(extract: dict) -> dict:
    return {_name(k): v for k, v in sorted(extract.items(), key=repr)}


def _name(key: tuple) -> str:
    return "|".join(str(x) for x in key)


def _state_np(state) -> dict:
    return {f: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for f, v in zip(state._fields, state)}


def golden_run(seq_mod, counters_mod, **kw):
    """scenario(GOLDEN_SPEC, GOLDEN_SEED) through `seq_mod`'s lane stores
    (either package's server/tpu_sequencer module, with its telemetry
    counters module; kw goes to the store constructors): a bucketed
    MergeLaneStore with an LwwLaneStore, and a paged MergeLaneStore.
    Returns the lane-store golden's (.npz sections, .json document)."""
    steps = scenario(GOLDEN_SPEC, GOLDEN_SEED)
    sections, doc = {}, {}
    for name, paged in (("bucketed", False), ("paged", True)):
        merge = seq_mod.MergeLaneStore(paged=paged, **kw)
        lww = None if paged else seq_mod.LwwLaneStore(**kw)
        h0 = counters_mod.get("summarize.blob_cache.hits")
        run = run_scenario(steps, merge, lww)
        res = store_results(merge, lww)
        res["seeded"] = named_extract(run["seeded"])
        res["extracts"] = [named_extract(e) for e in run["extracts"]]
        res["blob_cache_hits"] = \
            counters_mod.get("summarize.blob_cache.hits") - h0
        doc[name] = res
        if paged:
            sections["pool"] = _state_np(merge.pages.pool)
        else:
            for i, b in enumerate(merge.buckets):
                sections[f"bucket{i}"] = _state_np(b.state)
            for i, b in enumerate(lww.buckets):
                sections[f"lww{i}"] = _state_np(b.state)
    return sections, doc
