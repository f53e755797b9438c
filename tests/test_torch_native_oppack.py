"""The port's C op packer (fluidframework_tpu_torch/native/src/oppack.cpp,
mergetree/oppack.pack_ops): the mirror of tests/test_native_oppack.py,
plus bit-equality with the numpy packer (`pack_ops_plain`) and the JAX
package's `pack_ops` on seeded lane-fleet windows, and the refusals that
replace the reference's Python fallback (a failed build, an op that is
not a HostOp of int32 integers)."""

from __future__ import annotations

import random

import numpy as np
import pytest

import fluidframework_tpu_torch.mergetree.oppack as oppack
from fluidframework_tpu.mergetree import host as jax_host
from fluidframework_tpu.mergetree.oppack import pack_ops as jax_pack_ops
from fluidframework_tpu_torch.mergetree import host
from fluidframework_tpu_torch.mergetree.oppack import (FIELDS, HostOp, OpKind,
                                                       pack_ops,
                                                       pack_ops_plain)
from fluidframework_tpu_torch.native import build
from fluidframework_tpu_torch.testing import lanes
from fluidframework_tpu_torch.testing.serving import DocClass, FleetSpec


def random_streams(rng, b=17, t_max=9):
    streams = []
    for d in range(b):
        n = rng.randrange(0, t_max)
        streams.append([HostOp(
            kind=rng.randrange(0, 6), seq=rng.randrange(0, 10_000),
            ref_seq=rng.randrange(0, 10_000), client=rng.randrange(-1, 8),
            pos1=rng.randrange(0, 500), pos2=rng.randrange(0, 500),
            op_id=rng.randrange(-1, 1000), new_len=rng.randrange(0, 64),
            local_seq=rng.randrange(0, 100), msn=rng.randrange(0, 10_000))
            for _ in range(n)])
    return streams


def assert_packed_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want) == list(FIELDS)
    for f in FIELDS:
        assert got[f].dtype == np.int32 == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], f)


def jax_np(packed) -> dict:
    return {f: np.asarray(getattr(packed, f)) for f in FIELDS}


class TestNativePacker:
    def test_matches_python_fallback(self):
        streams = random_streams(random.Random(42))
        assert_packed_equal(pack_ops(streams), pack_ops_plain(streams))

    def test_empty_and_ragged_streams(self):
        packed = pack_ops([[], [HostOp(kind=OpKind.INSERT, seq=1,
                                       ref_seq=0, client=0, new_len=2)], []])
        assert packed["kind"].shape == (3, 1)
        assert int(packed["new_len"][1, 0]) == 2
        assert int(packed["kind"][0, 0]) == OpKind.NOOP

    def test_oversized_stream_reports_doc(self):
        ops = [HostOp(kind=OpKind.NOOP, seq=i, ref_seq=0, client=0)
               for i in range(5)]
        with pytest.raises(ValueError, match="doc 1"):
            pack_ops([[], ops], steps=3)

    def test_out_of_int32_raises(self):
        bad = [HostOp(kind=OpKind.INSERT, seq=2**31 + 7, ref_seq=0,
                      client=0)]
        with pytest.raises(OverflowError, match="doc 0, op 0"):
            pack_ops([bad])
        with pytest.raises(OverflowError):
            pack_ops([[HostOp(kind=1, seq=2**70, ref_seq=0, client=0)]])


LANE_SPEC = FleetSpec(
    classes=(DocClass(6, 2, 1, 0.0), DocClass(3, 8, 2, 0.3),
             DocClass(2, 16, 3, 0.8)), lww_docs=0, windows=4, steps=16)


@pytest.mark.parametrize("seed", [3, 17])
def test_lane_fleet_windows_match_plain_and_jax(seed):
    """Every window of a seeded lane fleet, as the lane stores pack it
    (one stream a document, the window's longest stream as T, and a
    padded T), packs bit for bit as pack_ops_plain and the JAX packer do;
    the JAX HostOps come from the JAX OpBuilder fed the same schedules."""
    fleet = lanes.LaneFleet(LANE_SPEC, seed)
    builder, jax_builder = host.OpBuilder(), jax_host.OpBuilder()
    for _ in range(LANE_SPEC.windows):
        merge, _ = fleet.window()
        streams = list(lanes.merge_streams(builder, merge).values())
        jax_streams = list(lanes.merge_streams(jax_builder, merge).values())
        assert [list(map(tuple, s)) for s in streams] == \
            [list(map(tuple, s)) for s in jax_streams]
        for steps in (None, 64):
            got = pack_ops(streams, steps=steps)
            assert_packed_equal(got, pack_ops_plain(streams, steps=steps))
            assert_packed_equal(got, jax_np(jax_pack_ops(jax_streams,
                                                         steps=steps)))
        # Slices of the streams, as the paged store's chunks take them.
        chunks = [s[2:6] for s in streams]
        assert_packed_equal(pack_ops(chunks, steps=4),
                            pack_ops_plain(chunks, steps=4))


@pytest.mark.parametrize("bad, match", [
    ([[(1, 2)]], "HostOp"),
    ([[HostOp(1, 2.5, 0, 0)]], "not an integer"),
    ([[HostOp(1, None, 0, 0)]], "not an integer"),
    ([5], "sequences"),
    ([[HostOp(1, 2, 0, 0)], 7], "sequences"),
])
def test_an_op_that_is_not_a_host_op_raises(bad, match):
    """The reference packs such input a second way, in Python; the port
    has one packer and refuses it."""
    with pytest.raises(TypeError, match=match):
        pack_ops(bad, steps=1)


def test_numpy_integers_pack_like_ints():
    ops = [HostOp(*(np.int64(v) for v in (1, 5, 4, 2, 3, 0, 7, 1, 0, 4)))]
    assert_packed_equal(pack_ops([ops]),
                        pack_ops([[HostOp(*map(int, ops[0]))]]))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the first pack raises NativeBuildError; nothing packs
    a second way."""
    monkeypatch.setattr(build, "LIB_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(oppack, "_NATIVE_PACK", None)
    with pytest.raises(build.NativeBuildError):
        pack_ops(random_streams(random.Random(1)))
    assert oppack._NATIVE_PACK is None
