"""The port's wire pump (fluidframework_tpu_torch/native/src/wirepump.cpp,
server/pump.py) against the JAX package's: the same bytes parse into equal
int32 columns, text arenas and intern deltas, preloads included; and a
pump that cannot be built or bound raises instead of switching itself
off."""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import pytest

from fluidframework_tpu.server import pump as jpump

from fluidframework_tpu_torch.native import build as tbuild
from fluidframework_tpu_torch.server import pump as tpump
from fluidframework_tpu_torch.testing import ingest


def _parse_both(batches, preload=None):
    """Each batch of frames through a fresh pump of each package;
    preload(pump) runs first on both."""
    pumps = (jpump.WirePump(), tpump.WirePump())
    if preload is not None:
        for p in pumps:
            preload(p)
    out = []
    for bufs in batches:
        a, b = (p.parse(list(bufs)) for p in pumps)
        out.append((a, b))
    return out


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.cols, b.cols)
    assert a.cols.dtype == b.cols.dtype == np.int32
    assert a.arena == b.arena
    for name in ("new_docs", "new_clients", "new_channels", "new_keys"):
        assert getattr(a, name) == getattr(b, name), name


def test_columns_match_the_jax_pump():
    assert tpump.NF == jpump.NF
    for name in ("DOC", "KIND", "CLIENT", "CSEQ", "REFSEQ", "FAMILY",
                 "CHAN", "MKIND", "POS1", "POS2", "TEXTOFF", "TEXTLEN",
                 "CHARLEN", "FLAGS", "BUF", "MSTART", "MEND", "PSTART",
                 "PEND", "F_FALLBACK", "F_MARKER", "F_PROPS", "F_VALUE",
                 "F_RUN", "F_ITEMS", "FAM_MERGE", "FAM_LWW"):
        assert getattr(tpump, name) == getattr(jpump, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_stream_parses_identically(seed):
    waves = ingest.mixed_waves(12, 3, seed=seed, poison=True)
    batches = [[data for _o, _d, data in frames] for frames in waves]
    for a, b in _parse_both(batches):
        _assert_equal(a, b)
        assert a.n > 0


def test_serving_and_storm_waves_parse_identically():
    batches = [[d for _o, _k, d in f] for f in
               ingest.serving_waves(8, 6, 2) + ingest.storm_waves(2, 8)]
    for a, b in _parse_both(batches):
        _assert_equal(a, b)


@pytest.mark.parametrize("shape", [(8, 6, 2, 0), (24, 4, 6, 0), (37, 5, 3, 2),
                                   (256, 32, 3, 9)])
def test_serving_waves_equal_the_plain_builder(shape):
    """The templated frames are boxcar's bytes, wave 0's joins included."""
    assert ingest.serving_waves(*shape) == ingest.serving_waves_plain(*shape)


def test_preloads_continue_restored_numbering():
    def preload(p):
        o = p.preload_doc("x0")
        p.preload_client(o, "x0-c0", 0)
        p.preload_client(o, "x0-c3", 3)
        p.preload_doc("x1")

    waves = ingest.mixed_waves(3, 2, seed=4)
    batches = [[d for _o, _k, d in f] for f in waves]
    results = _parse_both(batches, preload)
    for a, b in results:
        _assert_equal(a, b)
    first = results[0][1]
    # The preloaded documents are not new; the third one is.
    assert [name for _o, name in first.new_docs] == ["x2"]


def test_a_broken_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises NativeBuildError from the
    pump's constructor; nothing disables the pump quietly."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "wirepump.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "SRC_DIR", src)
    monkeypatch.setattr(tbuild, "LIB_DIR", tmp_path / "lib")
    monkeypatch.setattr(tpump, "_LIB", None)
    with pytest.raises(tbuild.NativeBuildError):
        tpump.WirePump()


def test_a_missing_symbol_or_column_mismatch_raises(tmp_path):
    """A library without the pump's symbols, or one that reports another
    column count, is refused when it is bound."""
    for body, err in (
            ('extern "C" long pump_nf() { return 19; }', AttributeError),
            (open(tbuild.SRC_DIR / "wirepump.cpp").read().replace(
                "long pump_nf() { return NF; }",
                "long pump_nf() { return NF + 1; }"), RuntimeError)):
        src = tmp_path / "lib.cpp"
        src.write_text(body)
        out = tmp_path / f"lib{err.__name__}.so"
        import sysconfig
        subprocess.run([tbuild.CXX, *tbuild.FLAGS,
                        "-I" + sysconfig.get_paths()["include"], str(src),
                        "-o", str(out)], check=True)
        with pytest.raises(err):
            tpump.library(str(out))
        assert isinstance(tpump.library(), ctypes.PyDLL)
