"""The port's scalar merge-tree oracle (fluidframework_tpu_torch/mergetree/
oracle.py) against the JAX package's, on the CPU.

Mirrors tests/test_oracle.py case by case: every case drives a `Twin`,
which makes each call on both oracles and requires the same result and
the same `snapshot_segments()` after it, and keeps the original
assertions. One more randomized case replays one schedule of local edits,
remote ops, acks and window advances through each oracle separately and
compares `snapshot_segments()` and `collab_segments()` at the end.
Tolerance: exact equality (host dicts, strings and ints).
"""

import dataclasses
import random

import pytest

from fluidframework_tpu.mergetree import MergeTreeOracle as JaxOracle

from fluidframework_tpu_torch.mergetree.constants import (SEG_TEXT,
                                                          UNASSIGNED_SEQ)
from fluidframework_tpu_torch.mergetree.oracle import (Items,
                                                       MergeTreeOracle,
                                                       Segment)

GOD = -2  # non-collab god view: applies every sequenced op as remote


def norm(x):
    """A result of either oracle in a form both compare equal in: Segments
    as their fields (local references left out), Items as lists."""
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, tuple):
        return tuple(norm(v) for v in x)
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name != "local_refs"}
    if hasattr(x, "values") and hasattr(x, "encode"):  # Items
        return ("items", list(x.values))
    return x


class Twin:
    """The port's oracle and the JAX package's driven by the same calls.
    Attribute reads return the port's value (after checking the JAX one
    equals it); every call runs on both and must return the same result
    and leave the same snapshot."""

    def __init__(self, local_client=GOD, port=None, jax=None):
        self.port = port or MergeTreeOracle(local_client=local_client)
        self.jax = jax or JaxOracle(local_client=local_client)

    @classmethod
    def load_segments(cls, snap, **kwargs):
        return cls(port=MergeTreeOracle.load_segments(snap, **kwargs),
                   jax=JaxOracle.load_segments(snap, **kwargs))

    def check(self):
        assert norm(self.port.snapshot_segments()) == \
            norm(self.jax.snapshot_segments())
        assert norm(self.port.segments) == norm(self.jax.segments)

    def visible_length(self, seg, *args, **kwargs):
        j_seg = self.jax.segments[self.port.segments.index(seg)]
        got = self.port.visible_length(seg, *args, **kwargs)
        assert got == self.jax.visible_length(j_seg, *args, **kwargs)
        return got

    def __getattr__(self, name):
        p, j = getattr(self.port, name), getattr(self.jax, name)
        if not callable(p):
            assert norm(p) == norm(j), name
            return p

        def call(*args, **kwargs):
            got, want = p(*args, **kwargs), j(*args, **kwargs)
            assert norm(got) == norm(want), name
            self.check()
            return got
        return call


def god_tree():
    return Twin(GOD)


class TestSequencedApply:
    """Apply already-sequenced ops in seq order (the server/summarizer
    view)."""

    def test_basic_insert(self):
        t = god_tree()
        t.insert_text(0, "hello", ref_seq=0, client=1, seq=1)
        t.insert_text(5, " world", ref_seq=1, client=1, seq=2)
        t.update_seq(2)
        assert t.get_text() == "hello world"

    def test_insert_splits_segment(self):
        t = god_tree()
        t.insert_text(0, "abcd", 0, 1, 1)
        t.insert_text(2, "XY", 1, 1, 2)
        t.update_seq(2)
        assert t.get_text() == "abXYcd"
        assert len(t.segments) == 3

    def test_concurrent_inserts_same_pos_newer_first(self):
        t = god_tree()
        t.insert_text(0, "AAA", 0, 1, 1)
        t.insert_text(0, "BBB", 0, 2, 2)
        t.update_seq(2)
        assert t.get_text() == "BBBAAA"

    def test_insert_after_acked_tombstone_skips_it(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.remove_range(2, 4, 1, 1, 2)
        t.insert_text(2, "XX", 2, 2, 3)
        t.update_seq(3)
        assert t.get_text() == "abXXef"
        order = [s.text for s in t.segments]
        assert order.index("cd") < order.index("XX")

    def test_insert_into_concurrently_removed_range_survives(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.remove_range(0, 6, 1, 1, 2)
        t.insert_text(3, "XY", 1, 2, 3)
        t.update_seq(3)
        assert t.get_text() == "XY"

    def test_remove_spanning_concurrent_insert_leaves_it(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.insert_text(3, "XY", 1, 2, 2)
        t.remove_range(1, 5, 1, 1, 3)
        t.update_seq(3)
        assert t.get_text() == "aXYf"

    def test_overlapping_removes_earliest_wins(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.remove_range(1, 3, 1, 1, 2)
        t.remove_range(1, 5, 1, 2, 3)
        t.update_seq(3)
        assert t.get_text() == "af"
        tomb = [s for s in t.segments if s.rem_seq is not None]
        assert min(s.rem_seq for s in tomb) == 2
        overl = [s for s in tomb if s.rem_overlap]
        assert overl and overl[0].rem_overlap == [2]

    def test_annotate_lww_in_seq_order(self):
        t = god_tree()
        t.insert_text(0, "abcd", 0, 1, 1)
        t.annotate_range(0, 4, {"bold": True}, 1, 1, 2)
        t.annotate_range(1, 3, {"bold": None, "em": 1}, 1, 2, 3)
        t.update_seq(3)
        props = [s.props for s in t.segments
                 if t.visible_length(s, 3, GOD) > 0]
        assert props == [{"bold": True}, {"em": 1}, {"bold": True}]

    def test_marker_occupies_one_position(self):
        t = god_tree()
        t.insert_text(0, "ab", 0, 1, 1)
        t.insert_marker(1, 1, 1, 2, props={"type": "pg"})
        t.update_seq(2)
        assert t.get_length() == 3
        assert t.get_text() == "a￼b"


class TestZamboniAndSnapshot:
    def test_zamboni_frees_old_tombstones_and_merges(self):
        t = god_tree()
        t.insert_text(0, "aaa", 0, 1, 1)
        t.insert_text(3, "bbb", 1, 1, 2)
        t.remove_range(2, 4, 2, 1, 3)
        t.update_seq(3)
        assert t.get_text() == "aabb"
        t.set_min_seq(3)
        assert t.get_text() == "aabb"
        assert all(s.rem_seq is None for s in t.segments)
        assert len(t.segments) == 1

    def test_snapshot_roundtrip_preserves_collab_window(self):
        t = god_tree()
        t.insert_text(0, "hello", 0, 1, 1)
        t.insert_text(5, "world", 1, 2, 2)
        t.remove_range(0, 2, 2, 1, 3)
        t.update_seq(3)
        t.set_min_seq(2)
        snap = t.snapshot_segments()
        t2 = Twin.load_segments(snap, local_client=GOD, min_seq=2,
                                current_seq=3)
        assert t2.get_text() == t.get_text()
        assert t2.get_text(ref_seq=2, client=GOD) == "helloworld"


# ---------------------------------------------------------------------------
# the replica + sequencer harness of tests/test_oracle.py, on twins
# ---------------------------------------------------------------------------

class Replica:
    def __init__(self, client_id):
        self.client_id = client_id
        self.tree = Twin(client_id)
        self.outbox = []

    def local_insert(self, pos, text):
        self.tree.insert_text(pos, text, self.tree.current_seq,
                              self.client_id, UNASSIGNED_SEQ)
        self.outbox.append(("insert", pos, text, self.tree.current_seq))

    def local_remove(self, start, end):
        self.tree.remove_range(start, end, self.tree.current_seq,
                               self.client_id, UNASSIGNED_SEQ)
        self.outbox.append(("remove", start, end, self.tree.current_seq))

    def local_annotate(self, start, end, props):
        self.tree.annotate_range(start, end, props, self.tree.current_seq,
                                 self.client_id, UNASSIGNED_SEQ)
        self.outbox.append(("annotate", start, end, props,
                            self.tree.current_seq))

    def apply_sequenced(self, op, seq):
        kind, client = op[0], op[-1]
        if client == self.client_id:
            self.tree.ack(seq)
            return
        ref_seq = op[-2]
        if kind == "insert":
            _, pos, text, _, _ = op
            self.tree.insert_text(pos, text, ref_seq, client, seq)
        elif kind == "remove":
            _, start, end, _, _ = op
            self.tree.remove_range(start, end, ref_seq, client, seq)
        elif kind == "annotate":
            _, start, end, props, _, _ = op
            self.tree.annotate_range(start, end, props, ref_seq, client,
                                     seq)
        self.tree.update_seq(seq)


def local_edits(rng, rep, ops_per_round, with_annotate=True):
    for _ in range(rng.randint(0, ops_per_round)):
        length = rep.tree.get_length()
        choice = rng.random()
        if length == 0 or choice < 0.55:
            pos = rng.randint(0, length)
            text = "".join(rng.choice("abcdefgh")
                           for _ in range(rng.randint(1, 4)))
            rep.local_insert(pos, text)
        elif choice < 0.85 or not with_annotate:
            start = rng.randint(0, length - 1)
            end = rng.randint(start + 1, length)
            rep.local_remove(start, end)
        else:
            start = rng.randint(0, length - 1)
            end = rng.randint(start + 1, length)
            key = rng.choice(["a", "b"])
            val = rng.choice([1, "x", None])
            rep.local_annotate(start, end, {key: val})


def interleave(rng, pending):
    """Random interleave that keeps each client's order (the sequencer
    keeps each client's ops in clientSeq order)."""
    out = []
    queues = [q for q in pending if q]
    while queues:
        q = rng.choice(queues)
        out.append(q.pop(0))
        queues = [q for q in queues if q]
    return out


def run_farm(n_clients, rounds, ops_per_round, seed, with_annotate=True,
             advance_min_seq=False):
    rng = random.Random(seed)
    replicas = [Replica(i) for i in range(n_clients)]
    seq = 0
    log = []
    for _ in range(rounds):
        pending = []
        for rep in replicas:
            local_edits(rng, rep, ops_per_round, with_annotate)
            pending.append([op + (rep.client_id,) for op in rep.outbox])
            rep.outbox.clear()
        for op in interleave(rng, pending):
            seq += 1
            log.append((op, seq))
            for rep in replicas:
                rep.apply_sequenced(op, seq)
        if advance_min_seq and seq > 0:
            for rep in replicas:
                rep.tree.set_min_seq(seq - 1)
    texts = [rep.tree.get_text() for rep in replicas]
    assert all(tx == texts[0] for tx in texts), (
        f"divergence (seed {seed}): {texts}")
    for rep in replicas:
        rep.tree.verify_local_length()
    god = god_tree()
    for op, s in log:
        kind, client, ref_seq = op[0], op[-1], op[-2]
        if kind == "insert":
            god.insert_text(op[1], op[2], ref_seq, client, s)
        elif kind == "remove":
            god.remove_range(op[1], op[2], ref_seq, client, s)
        else:
            god.annotate_range(op[1], op[2], op[3], ref_seq, client, s)
        god.update_seq(s)
    assert god.get_text() == texts[0]
    return replicas, log


class TestConflictFarm:
    @pytest.mark.parametrize("seed", range(12))
    def test_converges_small(self, seed):
        run_farm(n_clients=3, rounds=4, ops_per_round=3, seed=seed)

    @pytest.mark.parametrize("seed", range(4))
    def test_converges_more_clients(self, seed):
        run_farm(n_clients=6, rounds=3, ops_per_round=2, seed=100 + seed)

    @pytest.mark.parametrize("n_clients", [2, 4, 8, 16])
    def test_converges_scaling_with_window_close(self, n_clients):
        replicas, _ = run_farm(n_clients=n_clients, rounds=4,
                               ops_per_round=3, seed=7000 + n_clients,
                               advance_min_seq=True)
        for rep in replicas:
            live = rep.tree.get_length()
            slots = sum(seg.length for seg in rep.tree.segments
                        if seg.rem_seq is None)
            assert slots == live

    @pytest.mark.parametrize("seed", range(6))
    def test_zamboni_farm_matches_unzambonied(self, seed):
        with_z, _ = run_farm(n_clients=4, rounds=3, ops_per_round=3,
                             seed=9000 + seed, advance_min_seq=True)
        without_z, _ = run_farm(n_clients=4, rounds=3, ops_per_round=3,
                                seed=9000 + seed, advance_min_seq=False)
        assert with_z[0].tree.get_text() == without_z[0].tree.get_text()

    def test_props_converge(self):
        replicas, _ = run_farm(n_clients=3, rounds=5, ops_per_round=3,
                               seed=7)
        views = []
        for rep in replicas:
            view = []
            for s in rep.tree.segments:
                if rep.tree.visible_length(s, rep.tree.current_seq,
                                           GOD) > 0:
                    view.append((s.text, s.props))
            views.append(view)
        assert views[0] == views[1] == views[2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_schedule_same_snapshots(seed):
    """One randomized schedule (three clients' local edits, including
    markers and item runs, sequenced in a random client-order-preserving
    interleave, acks, the window closing behind every round) replayed
    through each oracle on its own: snapshot_segments() and
    collab_segments() of every replica equal, round by round."""
    rng = random.Random(seed)
    n = 3
    trees = {name: [cls(local_client=c) for c in range(n)]
             for name, cls in (("port", MergeTreeOracle), ("jax", JaxOracle))}
    seq = 0
    for rnd in range(6):
        plans = []
        for c in range(n):
            plan = []
            for _ in range(rng.randint(1, 4)):
                length = trees["port"][c].get_length()
                r = rng.random()
                if length == 0 or r < 0.45:
                    plan.append(("insert", rng.randint(0, length),
                                 "".join(rng.choice("xyz")
                                         for _ in range(rng.randint(1, 5)))))
                elif r < 0.55:
                    plan.append(("marker", rng.randint(0, length)))
                elif r < 0.8:
                    s = rng.randint(0, length - 1)
                    plan.append(("remove", s,
                                 rng.randint(s + 1, min(length, s + 6))))
                else:
                    s = rng.randint(0, length - 1)
                    plan.append(("annotate", s, rng.randint(s + 1, length),
                                 {rng.choice("pq"): rng.choice([1, None])}))
                for name in trees:
                    t = trees[name][c]
                    op = plan[-1]
                    if op[0] == "insert":
                        t.insert_text(op[1], op[2], t.current_seq, c,
                                      UNASSIGNED_SEQ)
                    elif op[0] == "marker":
                        t.insert_marker(op[1], t.current_seq, c,
                                        UNASSIGNED_SEQ, props={"m": rnd})
                    elif op[0] == "remove":
                        t.remove_range(op[1], op[2], t.current_seq, c,
                                       UNASSIGNED_SEQ)
                    else:
                        t.annotate_range(op[1], op[2], op[3],
                                         t.current_seq, c, UNASSIGNED_SEQ)
            plans.append([op + (trees["port"][c].current_seq, c)
                          for op in plan])
        for op in interleave(rng, plans):
            seq += 1
            client, ref = op[-1], op[-2]
            for name in trees:
                for c, t in enumerate(trees[name]):
                    if c == client:
                        t.ack(seq)
                    elif op[0] == "insert":
                        t.insert_text(op[1], op[2], ref, client, seq)
                    elif op[0] == "marker":
                        t.insert_marker(op[1], ref, client, seq,
                                        props={"m": rnd})
                    elif op[0] == "remove":
                        t.remove_range(op[1], op[2], ref, client, seq)
                    else:
                        t.annotate_range(op[1], op[2], op[3], ref, client,
                                         seq)
                    t.update_seq(seq)
        if rnd % 2:
            for name in trees:
                for t in trees[name]:
                    t.set_min_seq(seq - 2)
        for c in range(n):
            p, j = trees["port"][c], trees["jax"][c]
            assert norm(p.snapshot_segments()) == \
                norm(j.snapshot_segments()), (rnd, c)
            assert norm(p.collab_segments()) == norm(j.collab_segments())
    texts = {t.get_text() for ts in trees.values() for t in ts}
    assert len(texts) == 1


def test_items_and_segment_types():
    """Item runs and the Segment type round-trip through the port's own
    classes (not the JAX package's)."""
    t = MergeTreeOracle(local_client=GOD)
    t.insert_items(0, [1, 2, 3], 0, 1, 1)
    t.update_seq(1)
    seg = t.segments[0]
    assert isinstance(seg, Segment) and isinstance(seg.text, Items)
    assert seg.kind == SEG_TEXT and seg.text == Items([1, 2, 3])
    j = JaxOracle(local_client=GOD)
    j.insert_items(0, [1, 2, 3], 0, 1, 1)
    j.update_seq(1)
    assert norm(t.snapshot_segments()) == norm(j.snapshot_segments())
