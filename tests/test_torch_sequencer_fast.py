"""The port's sequencer lambda on the raw-wire fast path (`handler_raw`:
the native pump, staged windows, the in-flight ring, fused bursts and the
paged megakernel) against the JAX package's, byte for byte.

Each case feeds the same raw boxcar bytes (fluidframework_tpu_torch/
testing/ingest.py) to both lambdas in the same mode and compares with
zero tolerance: the emitted stream in order, nacks, channel views,
summaries, catch-up artifacts, lane placement and recovery counters.
Where the JAX tests hold one mode against another (fast against slow,
pipelined and burst against sync, megakernel against per-window), the
port's modes are held against each other the same way.
"""

from __future__ import annotations

import numpy as np
import pytest

from fluidframework_tpu_torch.server import serve_step as tserve
from fluidframework_tpu_torch.testing import ingest, lambda_runs

from test_torch_sequencer_lambda import (Pair, Side, assert_same,
                                         doc_names, drive, feed, outcome)


def _insert(csn, ref, pos, text, chan="t"):
    return ingest.channel_op(csn, ref, chan, {
        "type": 0, "pos1": pos, "seg": {"text": text}})


def _deep_ragged_waves(n_waves, docs=3, deep_ops=8, shallow_ops=2):
    """Doc r0 types deep bursts (several T=4 windows with t_buckets=
    (1, 4)); the rest type keystrokes. Inserts land at position 0, so any
    reordering changes the text."""
    waves, csn, off = [], {d: 0 for d in range(docs)}, 0
    for w in range(n_waves):
        frames = []
        for d in range(docs):
            msgs = [] if w else [ingest.join(f"c{d}")]
            for _ in range(deep_ops if d == 0 else shallow_ops):
                csn[d] += 1
                msgs.append(_insert(csn[d], csn[d] - 1, 0,
                                    f"{csn[d] % 10}"))
            frames.append((off, f"r{d}",
                           ingest.boxcar("t", f"r{d}", f"c{d}", msgs)))
            off += 1
        waves.append(frames)
    return waves


def _keystroke_waves(n_waves, docs=4, ops=3, bad_flush=None, bad_pos=0):
    """Shallow keystroke waves (one window a flush, so staged windows
    accumulate into bursts); `bad_flush` adds one insert at an impossible
    position on an extra document: overflow no fit proof can see."""
    waves, csn, bad_csn, off = [], {d: 0 for d in range(docs)}, 0, 0
    for w in range(n_waves):
        frames = []
        for d in range(docs):
            msgs = [] if w else [ingest.join(f"c{d}")]
            for _ in range(ops):
                csn[d] += 1
                msgs.append(_insert(csn[d], csn[d] - 1, 0,
                                    f"{csn[d] % 10}"))
            frames.append((off, f"k{d}",
                           ingest.boxcar("t", f"k{d}", f"c{d}", msgs)))
            off += 1
        if bad_flush is not None:
            msgs = [] if w else [ingest.join("cbad")]
            bad_csn += 1
            msgs.append(_insert(bad_csn, bad_csn - 1,
                                bad_pos if w == bad_flush else 0, "X"))
            frames.append((off, "kbad",
                           ingest.boxcar("t", "kbad", "cbad", msgs)))
            off += 1
        waves.append(frames)
    return waves


def _ordered(side: Side):
    return list(side.emits)


def _without_gen(catchup: dict) -> dict:
    return {d: {k: v for k, v in body.items() if k != "gen"}
            for d, body in catchup.items()}


def _lane_planes(lam, key):
    """A merge lane's planes as host arrays, from either package."""
    if lam.merge.paged:
        row = lam.merge.pages.row(key)
    else:
        b, lane = lam.merge.where[key]
        row = lam.merge.buckets[b].row(lane)
    out = {}
    for name in ("length", "ins_seq", "ins_client", "rem_seq", "count",
                 "min_seq", "seq"):
        x = getattr(row, name)
        out[name] = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
    return out


def _run_mode(waves, mode: str, **kw):
    """A Pair driven in one serving mode: "sync" (each window dispatched
    and read back alone), "ring" (pipelined, no bursts), "burst"
    (pipelined with fused bursts). The window shape stays fixed (no
    latency-adaptive T), so the two packages stage identical windows."""
    pair = Pair(**kw)
    pair.set(pipelined=mode != "sync", fused_bursts=mode == "burst",
             adaptive_window=False)
    return pair


class TestFastAgainstSlow:
    def test_mixed_families_fast_slow_and_jax(self):
        """One mixed stream (every family, joins, leaves, nacks, dropped
        duplicates, writers that never joined, undecodable frames) through
        the port's raw path, the port's object path and the JAX raw path:
        the per-document streams, nacks and views agree."""
        waves = ingest.mixed_waves(16, 4, seed=3, poison=True)
        docs = doc_names(waves)
        raw = Pair()
        drive(raw, waves, raw=True)
        got = assert_same(raw, docs)
        assert got["nacks"] and got["lanes"]["poison"] > 0
        slow = Side("torch")
        for frames in waves:
            feed(slow, frames, raw=False)
            slow.lam.flush()
        slow_out = outcome(slow, docs)
        for key in ("streams", "views", "seqs", "summary"):
            assert slow_out[key] == got[key], key
        assert sorted(slow_out["nacks"]) == got["nacks"]

    def test_leave_group_and_items_fall_back(self):
        msgs = [ingest.join("c0"), _insert(1, 0, 0, "abc"),
                ingest.channel_op(2, 1, "t", {"type": 3, "ops": [
                    {"type": 0, "pos1": 0, "seg": {"text": "xy"}}]}),
                ingest.channel_op(3, 2, "i", {"type": 0, "pos1": 0,
                                              "seg": {"items": [1, 2]}}),
                ingest.leave("c0")]
        waves = [[(0, "d0", ingest.boxcar("t", "d0", "c0", msgs))]]
        pair = Pair()
        drive(pair, waves, raw=True)
        got = assert_same(pair, ["d0"])
        assert [e[3] for e in got["streams"]["d0"]][-2:] == \
            ["leave", "noClient"]

    def test_lax_json_payloads_poison_at_ingest(self):
        """A frame that is lax-parseable but not strict JSON falls back
        whole and is dropped as poison at ingest, on both packages."""
        good = ingest.boxcar("t", "d0", "c0", [
            ingest.join("c0"),
            ingest.channel_op(1, 0, "t", {"type": 0, "pos1": 0,
                                          "seg": {"items": [7, 8]}})])
        frames = [(0, "d0", good)]

        def lax(csn, payload):
            raw = ingest.boxcar("t", "d0", "c0", [ingest.channel_op(
                csn, csn - 1, "t", {"type": 0, "pos1": 0,
                                    "seg": {"items": [123456789]}})])
            return raw.replace(b"[123456789]", payload)

        for off, payload in enumerate(
                (b"[1.2.3]", b"[01]", b'["\\x"]', b"[1e]"), start=1):
            frames.append((off, "d0", lax(off, payload)))
        frames.append((5, "d0", b'{"documentId": "d0", "contents": [{{{'))
        frames.append((6, "d0", b'{"documentId": "d0\x81", "contents": []}'))
        frames.append((7, "d0", ingest.boxcar("t", "d0", "c0", [
            ingest.channel_op(2, 1, "t", {"type": 0, "pos1": 2,
                                          "seg": {"items": [9]}})])))
        pair = Pair()
        drive(pair, [frames], raw=True)
        got = assert_same(pair, ["d0"])
        assert got["lanes"]["poison"] == 6
        assert got["views"][("d0", "t")][4] == [7, 8, 9]

    def test_unjoined_and_stale_nacks(self):
        frames = [(0, "d0", ingest.boxcar("t", "d0", "ghost", [
            _insert(1, 0, 0, "x")])),
            (1, "d1", ingest.boxcar("t", "d1", "c0", [
                ingest.join("c0"), _insert(1, 1, 0, "a"),
                _insert(2, -5, 0, "b")]))]
        pair = Pair()
        drive(pair, [frames], raw=True)
        got = assert_same(pair, ["d0", "d1"])
        assert len(got["nacks"]) == 2

    def test_intern_sync_between_paths(self):
        """Clients interned on the object path (a leave routes the
        document slow) keep their ordinals when the pump next sees the
        document, and pump-interned clients carry over to the object
        path."""
        waves = [
            [(0, "d0", ingest.boxcar("t", "d0", "c0", [
                ingest.join("c0"), _insert(1, 1, 0, "a")]))],
            [(1, "d0", ingest.boxcar("t", "d0", "c1", [
                ingest.join("c1"), _insert(1, 3, 0, "b"),
                ingest.leave("c0")]))],
            [(2, "d0", ingest.boxcar("t", "d0", "c2", [
                ingest.join("c2"), _insert(1, 5, 0, "c")])),
             (3, "d0", ingest.boxcar("t", "d0", "c1", [
                 _insert(2, 6, 0, "d")]))],
        ]
        pair = Pair()
        drive(pair, waves, raw=True)
        got = assert_same(pair, ["d0"])
        assert not got["nacks"]
        assert pair.torch.lam.docs["d0"].interner == \
            pair.jax.lam.docs["d0"].interner


class TestServingModes:
    @pytest.mark.parametrize("paged", [False, True])
    def test_sync_ring_burst_agree(self, paged):
        """Serving traffic through sync, the in-flight ring and fused
        bursts (the megakernel when paged): each mode equals JAX in the
        same mode, and every mode emits the same stream, order
        included."""
        waves = ingest.serving_waves(24, 4, 6)
        docs = doc_names(waves)
        streams = {}
        for mode in ("sync", "ring", "burst"):
            pair = _run_mode(waves, mode, paged_lanes=paged)
            for frames in waves:
                for s in pair.sides():
                    feed(s, frames, raw=True)
                    s.lam.flush()
            for s in pair.sides():
                s.lam.drain()
            got = assert_same(pair, docs)
            assert not got["nacks"]
            streams[mode] = _ordered(pair.torch)
            if mode == "burst":
                assert pair.torch.counter_deltas()["serving.bursts"] > 0
            for s in pair.sides():
                assert not s.lam._ring and not s.lam._staged
        assert streams["sync"] == streams["ring"] == streams["burst"]

    def test_megakernel_order_identical_to_per_window(self):
        """The ragged storm fleet on paged lanes: the megakernel stream
        equals the per-window (sync) stream in order, with fewer than a
        quarter of a dispatch per served window. The sync run equals JAX
        in everything; the megakernel run equals JAX's stream, and its
        views, summaries and catch-up artifacts equal the sync run's (the
        JAX megakernel loses the storm document's text: its chunks
        dispatch back to back on stale page scalars)."""
        waves = ingest.storm_waves(4, docs=32, storm_ops=128)
        docs = doc_names(waves)
        streams = {}
        sync_out = None
        for mode in ("sync", "burst"):
            pair = _run_mode(waves, mode, paged_lanes=True)
            # The window depth follows the per-document depth spread
            # (the storm document spans several windows of a flush); on
            # paged lanes it does not depend on measured latencies.
            pair.set(adaptive_window=True)
            for frames in waves:
                for s in pair.sides():
                    feed(s, frames, raw=True)
                    s.lam.flush()
            for s in pair.sides():
                s.lam.drain()
            if mode == "sync":
                assert_same(pair, docs)
                sync_out = outcome(pair.torch, docs)
            else:
                got = outcome(pair.torch, docs)
                assert got["streams"] == outcome(pair.jax, docs)["streams"]
                for key in ("streams", "nacks", "views", "seqs", "summary"):
                    assert got[key] == sync_out[key], key
                # The artifacts' change generation counts applies, which
                # differ between the modes; the artifacts' content may not.
                assert _without_gen(got["catchup"]) == \
                    _without_gen(sync_out["catchup"])
            streams[mode] = _ordered(pair.torch)
            if mode == "burst":
                assert streams["burst"] == _ordered(pair.jax)
                c = pair.torch.counter_deltas()
                per_window = c["serving.burst_dispatch_total"] \
                    / max(1.0, c["serving.burst_windows"])
                assert c["serving.megakernel_rings"] > 0
                assert 0 < per_window < 0.25, per_window
        assert streams["sync"] == streams["burst"]

    @pytest.mark.parametrize("waves", [1, 2])
    def test_megakernel_texts_equal_sync_texts(self, waves):
        """The storm fleet's first waves, where the megakernel splits one
        flush into chunks of 2 and 1 windows: every document's text, the
        storm document's included (191 characters after one wave, not
        2), equals the per-window run's."""
        pkg = lambda_runs.port_package("cpu")
        sync = lambda_runs.storm_run(pkg, "sync", waves=waves)
        mega = lambda_runs.storm_run(pkg, "mega", waves=waves)
        assert mega["rings"] > 1
        assert mega["texts"] == sync["texts"]
        assert mega["stream"] == sync["stream"]


class TestRecovery:
    def test_mid_ring_fold_quarantine_matches_sync(self):
        """Tiny capacities with hint-risky windows forced through the
        ring: overflow recovers while later windows are in flight, the
        quarantine fixup re-applies their rows, and the result equals
        the sync run (order included) and JAX, lane planes too."""
        waves = _deep_ragged_waves(5)
        kw = dict(merge_store={"capacities": (4, 16, 64)},
                  t_buckets=(1, 4))
        sync = _run_mode(waves, "sync", **kw)
        drive(sync, waves, raw=True)
        ring = _run_mode(waves, "ring", **kw)
        ring.set(defer_risky_windows=True)
        drive(ring, waves, raw=True)
        assert ring.torch.counter_deltas()["serving.ring_fixups"] > 0
        docs = doc_names(waves)
        got = assert_same(ring, docs)
        assert _ordered(ring.torch) == _ordered(sync.torch)
        assert outcome(sync.torch, docs, summaries=False)["views"] == \
            got["views"]
        for d in docs:
            key = (d, "s", "t")
            a = _lane_planes(sync.torch.lam, key)
            b = _lane_planes(ring.torch.lam, key)
            c = _lane_planes(ring.jax.lam, key)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
                np.testing.assert_array_equal(b[name], c[name])

    def test_mid_burst_overflow_quarantine(self):
        """An insert at an impossible position inside a burst: the
        donated degrade drops the channel, the later windows' rows for it
        are voided, and the stream equals the sync run and JAX."""
        waves = _keystroke_waves(8, bad_flush=3, bad_pos=500)
        sync = _run_mode(waves, "sync")
        drive(sync, waves, raw=True)
        sync_degrades = sync.torch.counter_deltas()[
            "sequencer.donated_overflow"]
        burst = _run_mode(waves, "burst")
        for frames in waves:
            for s in burst.sides():
                feed(s, frames, raw=True)
                s.lam.flush()
        for s in burst.sides():
            s.lam.drain()
        c = burst.torch.counter_deltas()
        assert c["serving.bursts"] > 0
        assert c["sequencer.donated_overflow"] == sync_degrades > 0
        assert c["serving.ring_fixups"] > 0
        docs = doc_names(waves)
        got = assert_same(burst, docs)
        assert _ordered(burst.torch) == _ordered(sync.torch)
        assert got["lanes"]["merge_opaque"]

    def test_run_packing_with_a_nacked_member(self):
        """Six appends on one ref pack into an INSERT_RUN slot; a
        duplicate clientSeq in the middle drops one member, so the run
        was mispredicted: the lane rolls back and re-runs on the host."""
        msgs = [ingest.join("c0")]
        pos = 0
        for i, csn in enumerate((1, 2, 2, 3, 4, 5)):
            msgs.append(_insert(csn, 1, pos, "ab"))
            pos += 2
        waves = [[(0, "rp", ingest.boxcar("t", "rp", "c0", msgs))],
                 [(1, "rp", ingest.boxcar("t", "rp", "c0", [
                     _insert(6, 6, 0, "z")]))]]
        pair = Pair()
        drive(pair, waves, raw=True)
        got = assert_same(pair, ["rp"])
        assert got["counters"]["serving.recovery_dispatches"] > 0

    def test_paged_rescue_rolls_back_through_the_keep_megakernel(
            self, monkeypatch):
        """Annotate-ring exhaustion inside a megakernel ring (the overflow
        page pre-growth cannot prevent): the window is risky, so its ring
        runs serve_megakernel_keep; the flagged document rolls back to
        the gathered pre-ring view and is rescued on the host. The result
        equals JAX and the port's bucketed engine."""
        calls = []
        for name in ("serve_megakernel", "serve_megakernel_keep"):
            real = getattr(tserve, name)

            def wrapped(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)
            monkeypatch.setattr(tserve, name, wrapped)
        waves, csn, off = [], {d: 0 for d in range(3)}, 0
        for w in range(3):
            frames = []
            for d in range(3):
                msgs = [] if w else [ingest.join(f"c{d}")]
                csn[d] += 1
                msgs.append(_insert(csn[d], csn[d] - 1, 0, "abcdef"))
                if d == 0 and w == 1:
                    for i in range(6):
                        csn[d] += 1
                        msgs.append(ingest.channel_op(
                            csn[d], csn[d] - 1, "t", {
                                "type": 2, "pos1": 0, "pos2": 6,
                                "props": {f"k{i}": i}}))
                frames.append((off, f"a{d}", ingest.boxcar(
                    "t", f"a{d}", f"c{d}", msgs)))
                off += 1
            waves.append(frames)
        docs = doc_names(waves)
        paged = _run_mode(waves, "burst", paged_lanes=True)
        drive(paged, waves, raw=True)
        got = assert_same(paged, docs)
        assert got["lanes"]["paged_rescues"] >= 1
        assert "serve_megakernel_keep" in calls
        bucketed = Side("torch")
        for frames in waves:
            feed(bucketed, frames, raw=True)
            bucketed.lam.flush()
        assert outcome(bucketed, docs, summaries=False)["views"] == \
            got["views"]
        assert _ordered(bucketed) == _ordered(paged.torch)


class TestCheckpoint:
    def test_checkpoint_rows_equal_and_pump_restart(self):
        """After a raw-path run both packages write the same checkpoint
        row; a port lambda restored from it preloads the pump with the
        documents and clients, so the restored writers keep sequencing
        without re-joining."""
        from fluidframework_tpu.server.database import Collection as JC
        from fluidframework_tpu_torch.server.database import Collection
        waves = ingest.mixed_waves(6, 3, seed=2)
        pair = Pair()
        pair.jax.lam.checkpoints = JC()
        pair.torch.lam.checkpoints = Collection()
        drive(pair, waves, raw=True)
        rows = []
        for s in pair.sides():
            s.lam.close()
            rows.append(s.lam.checkpoints.find(lambda d: True))
        assert rows[0] == rows[1]
        restored = Side("torch", checkpoints=pair.torch.lam.checkpoints)
        more = ingest.mixed_waves(6, 5, seed=2)[3:]
        for frames in more:
            feed(restored, frames, raw=True)
            restored.lam.flush()
        restored.lam.drain()
        assert restored.emits and not [
            n for n in restored.nacks
            if "not joined" in n[4] and "ghost" not in n[1]]
