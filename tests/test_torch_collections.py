"""core/collections.py and core/trace.py of the port, held against the JAX
package's classes on seeded operation sequences: every query after every
operation must answer the same."""

from __future__ import annotations

import random

import pytest

from fluidframework_tpu.core import collections as ref
from fluidframework_tpu.core import trace as ref_trace
from fluidframework_tpu_torch import core
from fluidframework_tpu_torch.core import collections as port
from fluidframework_tpu_torch.core import trace as port_trace

SEEDS = (3, 11, 29)


def test_core_exports_the_reference_names():
    from fluidframework_tpu import core as ref_core
    for name in ("Heap", "RangeTracker", "RedBlackTree", "IntervalTree",
                 "ConfigProvider", "BulkApplyUnsupported", "Deferred",
                 "TypedEventEmitter", "Trace"):
        assert hasattr(ref_core, name)
        assert hasattr(core, name), name


class _Item:
    def __init__(self, key):
        self.key = key


def _heap_run(mod, seed):
    rng = random.Random(seed)
    heap = mod.Heap(key=lambda it: it.key)
    items = [_Item(rng.randrange(100)) for _ in range(40)]
    names = {id(it): i for i, it in enumerate(items)}
    out = []
    for _ in range(400):
        op = rng.randrange(5)
        it = items[rng.randrange(len(items))]
        if op == 0:
            heap.push(it)
        elif op == 1:
            heap.remove(it)
        elif op == 2:
            it.key = rng.randrange(100)
            heap.update(it)
        elif op == 3:
            got = heap.pop()
            out.append(("pop", None if got is None else names[id(got)]))
        peek = heap.peek()
        out.append((len(heap), None if peek is None else names[id(peek)]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_heap_matches_reference(seed):
    # Both runs mutate their own item keys in the same seeded order.
    assert _heap_run(port, seed) == _heap_run(ref, seed)


def _range_run(mod, seed):
    rng = random.Random(seed)
    tracker = mod.RangeTracker()
    primary, out = 0, []
    for _ in range(300):
        op = rng.randrange(4)
        if op == 0:
            primary += rng.randrange(0, 5)
            tracker.add(primary, rng.randrange(10_000))
        elif op == 1:
            try:
                out.append(tracker.get(rng.randrange(-5, primary + 5)))
            except KeyError as err:
                out.append(("KeyError", err.args))
        elif op == 2:
            tracker.update_base(rng.randrange(0, primary + 1))
        else:
            try:
                tracker.add(primary - 1 - rng.randrange(3), 0)
            except ValueError:
                out.append("ValueError")
        out.append(list(tracker.ranges))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_range_tracker_matches_reference(seed):
    assert _range_run(port, seed) == _range_run(ref, seed)


def _rbtree_run(mod, seed):
    rng = random.Random(seed)
    tree = mod.RedBlackTree()
    out = []
    for _ in range(500):
        op = rng.randrange(7)
        k = rng.randrange(60)
        if op in (0, 1):
            tree.put(k, rng.randrange(1000))
        elif op == 2:
            tree.remove(k)
        elif op == 3:
            out.append(tree.get(k))
        elif op == 4:
            out.append((tree.floor(k), tree.ceil(k)))
        else:
            out.append((tree.min(), tree.max(), len(tree)))
    out.append(list(tree.items()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_red_black_tree_matches_reference(seed):
    assert _rbtree_run(port, seed) == _rbtree_run(ref, seed)


def _interval_run(mod, seed):
    rng = random.Random(seed)
    tree = mod.IntervalTree()
    live, out = [], []

    def view(ivs):
        return [(iv.start, iv.end, iv.data) for iv in ivs]

    for n in range(400):
        op = rng.randrange(5)
        if op in (0, 1) or not live:
            a = rng.randrange(200)
            live.append(tree.put(a, a + rng.randrange(30), n))
        elif op == 2:
            tree.remove(live.pop(rng.randrange(len(live))))
        elif op == 3:
            a = rng.randrange(220)
            out.append(view(tree.overlapping(a, a + rng.randrange(20))))
        else:
            out.append(view(tree.stab(rng.randrange(220))))
        out.append(len(tree))
    out.append(view(tree))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_interval_tree_matches_reference(seed):
    assert _interval_run(port, seed) == _interval_run(ref, seed)


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter(self):
        return next(self.ticks)


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_matches_reference(seed, monkeypatch):
    """Trace's split times, on the same seeded perf_counter readings."""
    rng = random.Random(seed)
    ticks, t = [], 100.0
    for _ in range(12):
        t += rng.random()
        ticks.append(t)
    events = {}
    for name, mod in (("port", port_trace), ("ref", ref_trace)):
        monkeypatch.setattr(mod, "time", _Clock(ticks))
        tr = mod.Trace.start()
        events[name] = [tuple(vars(tr.trace()).values()) for _ in range(11)]
    assert events["port"] == events["ref"]
    assert all(e[1] >= 0 for e in events["port"])
