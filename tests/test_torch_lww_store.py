"""The port's LWW lane store and channel routing helpers
(fluidframework_tpu_torch/server/tpu_sequencer.py: LwwLaneStore,
_LwwBucket, _LwwValueBlock, the matrix / directory routing helpers)
against the JAX package's on the CPU: the same wire ops through each
store's own interning give equal snapshots, placements, key and value
tables and bucket states (tests/test_tpu_serving.py::
TestOverflowRecovery::test_freed_lww_lane_zeroed_before_reuse and
TestLwwMaterialization's semantics, at the store); the routing helpers
give equal results on the same inputs.
"""

import random

import numpy as np
import pytest

from fluidframework_tpu.server import tpu_sequencer as jseq

from fluidframework_tpu_torch.mergetree.catchup import Unmodelable
from fluidframework_tpu_torch.server import tpu_sequencer as tseq
from fluidframework_tpu_torch.testing import lanes
from fluidframework_tpu_torch.testing.serving import DocClass, FleetSpec

from test_torch_lane_store import assert_states_equal


def pair(**kw):
    return jseq.LwwLaneStore(**kw), tseq.LwwLaneStore(device="cpu", **kw)


def wire(stores, key, ops):
    """[(wire op, seq)] through each store's wire_to_op, then apply."""
    for s in stores:
        s.apply({key: [s.wire_to_op(op, seq) for op, seq in ops]})


def assert_lww_equal(js, ts):
    assert js.where == ts.where
    assert js.opaque == ts.opaque
    assert js.overflow_drops == ts.overflow_drops
    assert js.change_gen == ts.change_gen
    assert js.key_ids == ts.key_ids and js.key_names == ts.key_names
    assert [js.value(i) for i in range(len(js.values))] == \
        [ts.value(i) for i in range(len(ts.values))]
    assert js.windows_since_value_compact == ts.windows_since_value_compact
    for i, (jb, tb) in enumerate(zip(js.buckets, ts.buckets)):
        assert (jb.capacity, jb.lanes, jb.used, jb._free, jb._next) == \
            (tb.capacity, tb.lanes, tb.used, tb._free, tb._next), i
        assert np.array_equal(jb.count_hint, tb.count_hint), i
        assert_states_equal(jb.state, tb.state, f"lww bucket {i}")
    for key in js.where:
        assert js.snapshot(key) == ts.snapshot(key), key


def test_map_counter_cell_semantics_match_jax():
    stores = pair()
    m, k, c = ("d", "s", "root"), ("d", "s", "clicks"), ("d", "s", "cfg")
    wire(stores, m, [({"type": "set", "key": "a", "value": 1, "pid": 1}, 1),
                     ({"type": "set", "key": "b", "pid": 2,
                       "value": {"nested": True}}, 2),
                     ({"type": "set", "key": "a", "value": 2, "pid": 1}, 3),
                     ({"type": "set", "key": "gone", "value": "x",
                       "pid": 2}, 4),
                     ({"type": "delete", "key": "gone", "pid": 1}, 5)])
    wire(stores, k, [({"type": "increment", "delta": 5}, 6),
                     ({"type": "increment", "delta": -2}, 7)])
    wire(stores, c, [({"type": "setCell", "value": {"theme": "dark"}}, 8)])
    assert_lww_equal(*stores)
    ts = stores[1]
    assert ts.snapshot(m)["entries"] == {"a": 2, "b": {"nested": True}}
    assert ts.snapshot(k)["counter"] == 3
    assert list(ts.snapshot(c)["entries"].values()) == [{"theme": "dark"}]
    wire(stores, m, [({"type": "clear", "pid": 1}, 9),
                     ({"type": "set", "key": "fresh", "value": True,
                       "pid": 1}, 10)])
    wire(stores, c, [({"type": "deleteCell"}, 11)])
    assert_lww_equal(*stores)
    assert ts.snapshot(m) == {"entries": {"fresh": True}, "counter": 0,
                              "sequenceNumber": 10}


def test_key_capacity_growth_promotes_and_matches_jax():
    stores = pair()
    key = ("d", "s", "root")
    wire(stores, key, [({"type": "set", "key": f"key{i}", "value": i,
                         "pid": 1}, i + 1) for i in range(150)])
    assert_lww_equal(*stores)
    snap = stores[1].snapshot(key)
    assert len(snap["entries"]) == 150 and snap["entries"]["key149"] == 149
    assert stores[1].where[key][0] == 1


def test_freed_lww_lane_zeroed_before_reuse():
    stores = pair(capacities=(4, 8), lanes_per_bucket=1)
    a, b = ("d", "s", "a"), ("d", "s", "b")
    for s in stores:
        lk = s.lk
        s.apply({a: [(lk.LwwKind.SET, s.intern_key(f"k{i}"), s.add_value(i),
                      0, i + 1) for i in range(6)]})
        assert s.where[a][0] == 1
        s.apply({b: [(lk.LwwKind.SET, s.intern_key("mine"),
                      s.add_value("v"), 0, 10)]})
        assert s.where[b] == (0, 0)
        assert s.snapshot(b)["entries"] == {"mine": "v"}
    assert_lww_equal(*stores)


def test_exhausted_buckets_degrade_to_opaque():
    stores = pair(capacities=(2, 4), lanes_per_bucket=1)
    key = ("d", "s", "wide")
    wire(stores, key, [({"type": "set", "key": f"k{i}", "value": i,
                         "pid": 1}, i + 1) for i in range(6)])
    assert_lww_equal(*stores)
    assert key in stores[1].opaque and stores[1].overflow_drops == 1
    wire(stores, key, [({"type": "set", "key": "x", "value": 0,
                         "pid": 1}, 9)])
    assert key not in stores[1].where
    stores[1].drop(("d", "s", "never"))
    assert ("d", "s", "never") in stores[1].opaque


@pytest.mark.parametrize("kind,header", [
    ("map", {"a": 1, "b": [2]}), ("cell", {"hasValue": True, "value": 7}),
    ("cell", {"hasValue": False}), ("counter", {"value": 12}),
    ("counter", {"value": 2**40}), ("map", [1, 2]), ("bogus", {}),
    ("map", {f"k{i}": i for i in range(80)})])
def test_seed_matches_jax(kind, header):
    stores = pair(capacities=(64,))
    key = ("d", "s", "c")
    got = [s.seed(key, kind, header) for s in stores]
    assert got[0] == got[1]
    assert_lww_equal(*stores)
    assert [s.seed(key, kind, header) for s in stores] == got
    wire(stores, key, [({"type": "set", "key": "late", "value": 0,
                         "pid": 1}, 3)])
    assert_lww_equal(*stores)


@pytest.mark.parametrize("op", [
    {"type": "set", "key": "k", "value": 1},
    {"type": "delete", "key": "k"}, {"type": "clear"},
    {"type": "setCell", "value": None}, {"type": "deleteCell"},
    {"type": "increment", "delta": 3},
    {"type": "increment", "delta": 2**31},
    {"type": "increment", "delta": "x"}, {"type": "set"},
    {"type": "nope"}])
def test_wire_to_op_matches_jax(op):
    out = []
    for s in pair():
        try:
            out.append(("ok", tuple(int(x) for x in s.wire_to_op(op, 4))))
        except Exception as err:  # noqa: BLE001 — compared across packages
            assert type(err).__name__ == "Unmodelable"
            out.append(("err", str(err)))
    assert out[0] == out[1]
    if out[1][0] == "err":
        with pytest.raises(Unmodelable):
            tseq.LwwLaneStore(device="cpu").wire_to_op(op, 4)


def test_compact_values_matches_jax():
    stores = pair()
    for s in stores:
        s.value_compact_every = 3
    rng = random.Random(9)
    keys = [("d", "s", f"m{i}") for i in range(5)]
    seq = 0
    for _ in range(7):
        ops = []
        for _ in range(6):
            seq += 1
            ops.append(({"type": "set", "key": f"k{rng.randrange(4)}",
                         "value": seq, "pid": 1}, seq))
        for s in stores:
            s.apply({k: [s.wire_to_op(op, q) for op, q in ops]
                     for k in keys})
    assert_lww_equal(*stores)
    for s in stores:
        s.compact_values()
    assert_lww_equal(*stores)
    assert len(stores[1].values) <= 5 * 4   # the live values only


def test_value_blocks_resolve_and_compact():
    bufs = [b'{"a":1} [2,3] "s"']
    stores = pair()
    key = ("d", "s", "m")
    for s, cls in zip(stores, (jseq._LwwValueBlock, tseq._LwwValueBlock)):
        blk = cls(bufs, np.zeros(4, np.int32),
                  np.asarray([0, 8, 14, -1], np.int32),
                  np.asarray([7, 13, 17, 0], np.int32))
        base = s.add_value_block(blk)
        lk = s.lk
        s.apply({key: [(lk.LwwKind.SET, s.intern_key(f"k{i}"), base + i, 0,
                        i + 1) for i in range(4)]})
        assert s.snapshot(key)["entries"] == {"k0": {"a": 1}, "k1": [2, 3],
                                              "k2": "s", "k3": None}
        s.compact_values()
    assert_lww_equal(*stores)


def test_lww_fleet_matches_jax():
    spec = FleetSpec(classes=(DocClass(6, 2, 1, 0.0),), lww_docs=6,
                     windows=4, steps=16)
    fleet = lanes.LaneFleet(spec, seed=4)
    stores = pair()
    for _ in range(spec.windows):
        _merge, lww = fleet.window()
        for s in stores:
            s.apply(lanes.lww_streams(s, lww))
    assert_lww_equal(*stores)
    assert stores[1].where[lanes.WIDE_MAP_KEY][0] == 1   # 160 keys


# ---------------------------------------------------------------------------
# channel routing helpers
# ---------------------------------------------------------------------------

KEYS = [("d", "s", "plain"), ("d", "s", "m" + tseq.MATRIX_ROWS_SUFFIX),
        ("d", "s", "m" + tseq.MATRIX_COLS_SUFFIX),
        ("d", "s", "m" + tseq.MATRIX_CELLS_SUFFIX),
        ("d", "s", "x\x00mx:other"), ("d", "s", "t" + tseq.DIR_SUFFIX),
        ("d", "s", 5)]

OPS = [None, 3, {}, {"type": "storage", "path": "/", "op": {}},
       {"type": "storage", "path": 1, "op": {}},
       {"type": "createSubDirectory", "path": "/", "name": "a"},
       {"type": "deleteSubDirectory", "path": "/a", "name": 2},
       {"target": "rows", "op": {"type": 0, "pos1": 0}},
       {"target": "cols", "op": {"type": 3, "ops": []}},
       {"target": "rows", "op": {"type": 9}},
       {"target": "cell", "key": "1|2"}, {"target": "cell", "key": 4},
       {"type": "set", "key": "k", "pid": 1}, {"type": "set", "key": "k"},
       {"type": "delete", "key": 3, "pid": 1}, {"type": "clear", "pid": 1},
       {"type": "clear", "path": "/"}, {"type": "increment", "delta": 1},
       {"type": "increment"}, {"type": "setCell"}, {"type": "deleteCell"},
       {"type": "insert"}]


@pytest.mark.parametrize("name", ["matrix_base_key", "lane_base_key"])
def test_key_helpers_match_jax(name):
    assert [getattr(tseq, name)(k) for k in KEYS] == \
        [getattr(jseq, name)(k) for k in KEYS]


@pytest.mark.parametrize("name", ["directory_route", "matrix_route",
                                  "looks_like_lww_op"])
def test_op_routes_match_jax(name):
    assert [getattr(tseq, name)(op) for op in OPS] == \
        [getattr(jseq, name)(op) for op in OPS]


def test_paths_and_directory_round_trip_match_jax():
    for p in ("", "/", "//sub", "/sub/", "/a//b/c/"):
        assert tseq._norm_path(p) == jseq._norm_path(p)
        assert tseq._child_path(p or "/", "n") == \
            jseq._child_path(p or "/", "n")
    tree = {"storage": {"a": 1}, "subdirectories": {
        "x": {"storage": {"b": 2}, "subdirectories": {
            "y": {"storage": {}, "subdirectories": {}}}},
        "z": {"storage": {"c": [3]}}}}
    got, want = tseq._flatten_directory(tree), jseq._flatten_directory(tree)
    assert got == want
    assert tseq._nest_directory(*got) == jseq._nest_directory(*want)
    for bad in ({"storage": 1}, {"subdirectories": {"a\x1eb": {}}},
                {"subdirectories": []}, 5):
        errs = []
        for mod in (tseq, jseq):
            with pytest.raises(ValueError) as info:
                mod._flatten_directory(bad)
            errs.append(str(info.value))
        assert errs[0] == errs[1]
    assert (tseq.DIR_SEP, tseq._DIRECTORY_TYPE, tseq._CELL_KEY,
            tseq._MATRIX_TYPES) == (jseq.DIR_SEP, jseq._DIRECTORY_TYPE,
                                    jseq._CELL_KEY, jseq._MATRIX_TYPES)


def test_compose_matrix_channels_matches_jax():
    base = ("d", "s", "m")

    def axis(seq, text):
        return {"header": {"sequenceNumber": seq,
                           "minimumSequenceNumber": seq - 1},
                "chunks": [[{"text": text}], [{"text": text + "2"}]]}

    for parts in (("rows", "cols", "cells"), ("rows",), ("cells",)):
        out = {("d", "s", "plain"): {"x": 1}}
        for name in parts:
            suffix = {"rows": tseq.MATRIX_ROWS_SUFFIX,
                      "cols": tseq.MATRIX_COLS_SUFFIX,
                      "cells": tseq.MATRIX_CELLS_SUFFIX}[name]
            out[(base[0], base[1], base[2] + suffix)] = \
                {"header": {"sequenceNumber": 9}, "entries": {"1|2": 5}} \
                if name == "cells" else axis(3 + len(name), name)
        mine, theirs = dict(out), dict(out)
        tseq._compose_matrix_channels(mine)
        jseq._compose_matrix_channels(theirs)
        assert mine == theirs
        assert base in mine
