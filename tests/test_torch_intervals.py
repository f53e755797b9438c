"""The port's local references and interval collections, held to the JAX
package's: a mirror of tests/test_intervals.py.

Every assertion of that file is made again on fluidframework_tpu_torch's
SharedString, oracle and Loader over its own LocalServer, on the CPU
(device="cpu").
"""

from fluidframework_tpu_torch.dds.sequence import SharedString
from fluidframework_tpu_torch.loader import container as port_container
from fluidframework_tpu_torch.loader.drivers.local import \
    LocalDocumentServiceFactory
from fluidframework_tpu_torch.mergetree.oracle import (
    REF_SIMPLE, REF_SLIDE_ON_REMOVE, MergeTreeOracle)
from fluidframework_tpu_torch.server.local_server import LocalServer


def Loader(*args, **kwargs):
    return port_container.Loader(*args, device="cpu", **kwargs)


# --- mirrors tests/test_intervals.py ---------------------------------------

def god_tree():
    t = MergeTreeOracle(local_client=-2)
    return t


class TestLocalReferences:
    def test_position_tracks_inserts(self):
        t = god_tree()
        t.insert_text(0, "hello world", 0, 1, 1)
        t.update_seq(1)
        ref = t.create_local_reference(6)  # at 'w'
        t.insert_text(0, ">>> ", 1, 1, 2)
        t.update_seq(2)
        assert t.local_reference_position(ref) == 10
        t.insert_text(t.get_length(), "!", 2, 1, 3)
        t.update_seq(3)
        assert t.local_reference_position(ref) == 10

    def test_ref_inside_split_segment(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.update_seq(1)
        ref = t.create_local_reference(4)  # inside "abcdef"
        t.insert_text(2, "XY", 1, 1, 2)  # splits the segment before the ref
        t.update_seq(2)
        assert t.get_text() == "abXYcdef"
        assert t.local_reference_position(ref) == 6

    def test_tombstone_resolves_to_slot(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.update_seq(1)
        ref = t.create_local_reference(3)  # at 'd'
        t.remove_range(2, 5, 1, 1, 2)  # removes "cde" containing the ref
        t.update_seq(2)
        assert t.get_text() == "abf"
        assert t.local_reference_position(ref) == 2  # slot of removed span

    def test_slide_on_remove_after_zamboni(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.update_seq(1)
        ref = t.create_local_reference(3, REF_SLIDE_ON_REMOVE)
        t.remove_range(2, 5, 1, 1, 2)
        t.update_seq(2)
        t.set_min_seq(2)  # zamboni frees the tombstone
        assert t.local_reference_position(ref) == 2  # slid to 'f'

    def test_simple_ref_detaches_to_end(self):
        t = god_tree()
        t.insert_text(0, "abcdef", 0, 1, 1)
        t.update_seq(1)
        ref = t.create_local_reference(3, REF_SIMPLE)
        t.remove_range(2, 5, 1, 1, 2)
        t.update_seq(2)
        t.set_min_seq(2)
        assert t.local_reference_position(ref) == t.get_length()

    def test_refs_survive_pack_coalesce(self):
        t = god_tree()
        t.insert_text(0, "abc", 0, 1, 1)
        t.insert_text(3, "def", 1, 1, 2)
        t.update_seq(2)
        ref = t.create_local_reference(4)  # at 'e' in second segment
        t.set_min_seq(2)  # zamboni coalesces "abc"+"def"
        assert len(t.segments) == 1
        assert t.local_reference_position(ref) == 4

    def test_remove_local_reference(self):
        t = god_tree()
        t.insert_text(0, "abc", 0, 1, 1)
        t.update_seq(1)
        ref = t.create_local_reference(1)
        t.remove_local_reference(ref)
        assert t.local_reference_position(ref) == t.get_length()
        assert not any(s.local_refs for s in t.segments)


def make_string_pair(server=None):
    server = server or LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.create_detached("doc")
    ds1 = c1.runtime.create_datastore("default")
    s1 = ds1.create_channel("text", SharedString.TYPE)
    c1.attach()
    c2 = loader.resolve("doc")
    s2 = c2.runtime.get_datastore("default").get_channel("text")
    return server, loader, (c1, s1), (c2, s2)


class TestIntervalCollections:
    def test_add_and_query(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "the quick brown fox")
        coll = s1.get_interval_collection("comments")
        iv = coll.add(4, 8, {"author": "a"})
        assert coll.endpoints(iv) == (4, 8)
        hits = coll.find_overlapping_intervals(5, 6)
        assert [h.interval_id for h in hits] == [iv.interval_id]
        assert coll.find_overlapping_intervals(15, 18) == []

    def test_intervals_converge_across_clients(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "collaborate")
        coll1 = s1.get_interval_collection("sel")
        coll2 = s2.get_interval_collection("sel")
        iv = coll1.add(2, 5)
        assert len(coll2) == 1
        iv2 = coll2.get_interval_by_id(iv.interval_id)
        assert coll2.endpoints(iv2) == (2, 5)

    def test_interval_tracks_concurrent_edit(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "abcdef")
        coll1 = s1.get_interval_collection("sel")
        coll2 = s2.get_interval_collection("sel")
        iv = coll1.add(3, 5)
        s2.insert_text(0, "XXX")  # shifts everything right by 3
        assert coll1.endpoints(coll1.get_interval_by_id(iv.interval_id)) \
            == (6, 8)
        assert coll2.endpoints(coll2.get_interval_by_id(iv.interval_id)) \
            == (6, 8)

    def test_delete_and_change(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "0123456789")
        coll1 = s1.get_interval_collection("x")
        coll2 = s2.get_interval_collection("x")
        iv = coll1.add(1, 3)
        coll1.change(iv.interval_id, 5, 7)
        assert coll2.endpoints(coll2.get_interval_by_id(iv.interval_id)) \
            == (5, 7)
        coll2.change_properties(iv.interval_id, {"bold": True})
        assert coll1.get_interval_by_id(iv.interval_id) \
                    .properties["bold"] is True
        coll2.remove_interval_by_id(iv.interval_id)
        assert len(coll1) == 0 and len(coll2) == 0

    def test_events(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "events")
        seen = []
        s2.get_interval_collection("e").on(
            "addInterval", lambda iv, local: seen.append(("add", local)))
        s1.get_interval_collection("e").add(0, 2)
        assert seen == [("add", False)]

    def test_summary_roundtrip(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "persisted text")
        iv = s1.get_interval_collection("notes").add(2, 6, {"n": 1})
        c1.summarize()
        server.pump()
        c3 = loader.resolve("doc")
        s3 = c3.runtime.get_datastore("default").get_channel("text")
        coll3 = s3.get_interval_collection("notes")
        assert len(coll3) == 1
        iv3 = coll3.get_interval_by_id(iv.interval_id)
        assert coll3.endpoints(iv3) == (2, 6)
        assert iv3.properties == {"n": 1}
        # Loaded intervals still track subsequent edits.
        s1.insert_text(0, "> ")
        assert coll3.endpoints(iv3) == (4, 8)

    def test_sharedstring_local_reference_api(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "anchor here")
        ref = s1.create_local_reference_position(7)
        s1.insert_text(0, "___")
        assert s1.local_reference_to_position(ref) == 10
        s1.remove_local_reference_position(ref)


class TestIntervalConflicts:
    """Concurrent interval mutations converge LWW with pending-local
    shadowing (reference intervalCollection pendingChange tracking)."""

    def _concurrent_pair(self):
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "0123456789")
        coll1 = s1.get_interval_collection("sel")
        coll2 = s2.get_interval_collection("sel")
        iv = coll1.add(0, 1)
        return server, coll1, coll2, iv.interval_id

    def test_concurrent_change_converges_lww(self):
        server, coll1, coll2, iid = self._concurrent_pair()
        server.auto_pump = False
        coll1.change(iid, 1, 2)
        coll2.change(iid, 5, 6)  # sequenced second: the winner
        server.auto_pump = True
        server.pump()
        assert coll1.endpoints(coll1.get_interval_by_id(iid)) == (5, 6)
        assert coll2.endpoints(coll2.get_interval_by_id(iid)) == (5, 6)

    def test_concurrent_change_other_order(self):
        server, coll1, coll2, iid = self._concurrent_pair()
        server.auto_pump = False
        coll2.change(iid, 5, 6)
        coll1.change(iid, 1, 2)  # sequenced second: the winner
        server.auto_pump = True
        server.pump()
        assert coll1.endpoints(coll1.get_interval_by_id(iid)) == (1, 2)
        assert coll2.endpoints(coll2.get_interval_by_id(iid)) == (1, 2)

    def test_concurrent_property_change_lww_per_key(self):
        server, coll1, coll2, iid = self._concurrent_pair()
        server.auto_pump = False
        coll1.change_properties(iid, {"a": 1, "only1": True})
        coll2.change_properties(iid, {"a": 2, "b": 3})
        server.auto_pump = True
        server.pump()
        for coll in (coll1, coll2):
            props = coll.get_interval_by_id(iid).properties
            assert props["a"] == 2          # last writer
            assert props["b"] == 3
            assert props["only1"] is True   # disjoint keys both land

    def test_delete_wins_over_pending_change(self):
        server, coll1, coll2, iid = self._concurrent_pair()
        server.auto_pump = False
        coll1.change(iid, 3, 4)
        coll2.remove_interval_by_id(iid)
        server.auto_pump = True
        server.pump()
        assert coll1.get_interval_by_id(iid) is None
        assert coll2.get_interval_by_id(iid) is None

    def test_interval_conflict_farm(self):
        """Randomized concurrent change/changeProperties/delete churn with
        batched delivery windows: every replica converges (farm-style, the
        repo's race-detector pattern)."""
        import random as _random
        rng = _random.Random(1234)
        server, loader, (c1, s1), (c2, s2) = make_string_pair()
        s1.insert_text(0, "x" * 40)
        colls = [s1.get_interval_collection("farm"),
                 s2.get_interval_collection("farm")]
        base = [colls[0].add(i, i + 2).interval_id for i in range(0, 10, 2)]
        for _round in range(30):
            server.auto_pump = False
            for _ in range(rng.randrange(1, 5)):
                coll = colls[rng.randrange(2)]
                live = [iid for iid in base
                        if coll.get_interval_by_id(iid) is not None]
                if not live:
                    break
                iid = rng.choice(live)
                action = rng.random()
                if action < 0.5:
                    a = rng.randrange(38)
                    coll.change(iid, a, a + rng.randrange(1, 3))
                elif action < 0.85:
                    coll.change_properties(
                        iid, {rng.choice("abc"): rng.randrange(100)})
                else:
                    coll.remove_interval_by_id(iid)
            server.auto_pump = True
            server.pump()
            for iid in base:
                iv1 = colls[0].get_interval_by_id(iid)
                iv2 = colls[1].get_interval_by_id(iid)
                assert (iv1 is None) == (iv2 is None), iid
                if iv1 is not None:
                    assert colls[0].endpoints(iv1) == colls[1].endpoints(iv2)
                    assert iv1.properties == iv2.properties


# --- parity with the JAX package ---------------------------------------------
#
# One seeded script of text edits and interval adds, changes, property
# changes and removes from two clients, in batched delivery windows, run
# through the JAX package and the port (test_torch_loader.both: the same
# seed and pins). Texts, every replica's intervals (ids, endpoints,
# properties), both strings' summaries in dict form and a third client's
# intervals after a load from a summary must be equal.

import pytest  # noqa: E402
from test_torch_loader import both  # noqa: E402


def intervals_of(coll) -> list:
    return sorted([iv.interval_id, *coll.endpoints(iv), iv.properties]
                  for iv in coll)


def interval_script(s, rng) -> dict:
    server = s.local_server.LocalServer()
    loader = s.loader(server)
    c1 = loader.create_detached("doc")
    s1 = c1.runtime.create_datastore("default").create_channel(
        "text", s.sequence.SharedString.TYPE)
    s1.insert_text(0, "".join(chr(97 + rng.randrange(26))
                              for _ in range(40)))
    c1.attach()
    c2 = loader.resolve("doc")
    s2 = c2.runtime.get_datastore("default").get_channel("text")
    strings = [s1, s2]
    colls = [s.get_interval_collection("farm") for s in strings]
    for i in range(0, 10, 2):
        colls[0].add(i, i + 2, {"n": i})
    for _round in range(25):
        server.auto_pump = False
        for _ in range(rng.randrange(1, 5)):
            side = rng.randrange(2)
            text, coll = strings[side], colls[side]
            n = text.get_length()
            live = [iv.interval_id for iv in coll]
            action = rng.random()
            if action < 0.2 or not live:
                text.insert_text(rng.randrange(n + 1), f"<{_round}>")
            elif action < 0.3 and n > 12:
                a = rng.randrange(n - 4)
                text.remove_text(a, a + rng.randrange(1, 4))
            elif action < 0.55:
                a = rng.randrange(n - 3)
                coll.change(rng.choice(live), a, a + rng.randrange(1, 3))
            elif action < 0.75:
                coll.change_properties(
                    rng.choice(live), {rng.choice("abc"): rng.randrange(9)})
            elif action < 0.88:
                a = rng.randrange(n - 3)
                coll.add(a, a + rng.randrange(1, 3), {"r": _round})
            else:
                coll.remove_interval_by_id(rng.choice(live))
        server.auto_pump = True
        server.pump()
    done = []
    c1.summarize(lambda h, a, _: done.append(a))
    server.pump()
    c3 = loader.resolve("doc")
    s3 = c3.runtime.get_datastore("default").get_channel("text")
    S = s.summary
    return {"texts": [t.get_text() for t in strings + [s3]],
            "intervals": [intervals_of(c) for c in colls]
            + [intervals_of(s3.get_interval_collection("farm"))],
            "acked": done,
            "trees": [S.summary_tree_to_dict(t.summarize())
                      for t in strings]}


@pytest.mark.parametrize("seed", [1, 7, 1234])
def test_interval_script_matches_jax(seed):
    jax, port = both(interval_script, seed)
    assert port == jax
