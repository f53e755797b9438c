"""Python face of the native wire pump (native/src/wirepump.cpp).

Counterpart of fluidframework_tpu's server/pump.py. One `parse()` call
turns a flush's raw boxcar bytes into int32 numpy columns, a text arena
and intern deltas; everything downstream (tpu_sequencer._flush_raw) is
vectorized numpy and device dispatch.

The library builds with g++ at first use (native/build.py). A failed
build, a missing symbol or a column-count mismatch raises: there is no
object-path-only mode that comes on by itself.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np

from ..native.build import ensure_built

# Column indices: they match the Col enum in native/src/wirepump.cpp.
DOC, KIND, CLIENT, CSEQ, REFSEQ, FAMILY, CHAN, MKIND, POS1, POS2, \
    TEXTOFF, TEXTLEN, CHARLEN, FLAGS, BUF, MSTART, MEND, PSTART, PEND = \
    range(19)
NF = 19

F_FALLBACK, F_MARKER, F_PROPS, F_VALUE, F_RUN, F_ITEMS = \
    1, 2, 4, 8, 16, 32
FAM_NONE, FAM_MERGE, FAM_LWW = 0, 1, 2


class Parsed(NamedTuple):
    """One flush's parsed staging."""

    cols: np.ndarray          # [NF, n] int32
    arena: bytes              # unescaped insert text payloads
    bufs: List[bytes]         # the raw inputs (spans index into these)
    new_docs: list            # [(ord, doc_id)]
    new_clients: list         # [(doc_ord, ord, client_id)]
    new_channels: list        # [(ord, doc_ord, store, channel)]
    new_keys: list            # [(ord, key)]

    @property
    def n(self) -> int:
        return self.cols.shape[1]


_LIB = None


def library(path: str | None = None) -> ctypes.PyDLL:
    """The pump library, built and bound on the first call (or loaded from
    `path`, which the tests use to hand in a deliberately broken build).
    Raises NativeBuildError, OSError, AttributeError or RuntimeError."""
    global _LIB
    if _LIB is not None and path is None:
        return _LIB
    lib = ctypes.PyDLL(path or ensure_built("wirepump"))
    lib.pump_new.restype = ctypes.c_void_p
    lib.pump_free.argtypes = [ctypes.c_void_p]
    lib.pump_parse.argtypes = [ctypes.c_void_p, ctypes.py_object]
    lib.pump_parse.restype = ctypes.c_long
    lib.pump_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_long]
    lib.pump_fill.restype = ctypes.c_long
    lib.pump_arena_size.argtypes = [ctypes.c_void_p]
    lib.pump_arena_size.restype = ctypes.c_long
    lib.pump_fill_arena.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_long]
    lib.pump_fill_arena.restype = ctypes.c_long
    for name in ("pump_take_new_docs", "pump_take_new_clients",
                 "pump_take_new_channels", "pump_take_new_keys"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.py_object
    lib.pump_preload_doc.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pump_preload_doc.restype = ctypes.c_long
    lib.pump_preload_client.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    lib.pump_preload_client.restype = ctypes.c_long
    lib.pump_nf.restype = ctypes.c_long
    nf = lib.pump_nf()
    if nf != NF:
        raise RuntimeError(f"wirepump has {nf} columns, this module {NF}: "
                           "the source and pump.py disagree")
    if path is None:
        _LIB = lib
    return lib


class WirePump:
    """Stateful pump: holds the intern tables for one sequencer lambda."""

    def __init__(self):
        self._lib = library()
        self._ctx = self._lib.pump_new()

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.pump_free(ctx)
            self._ctx = None

    def parse(self, bufs: List[bytes]) -> Parsed:
        lib = self._lib
        n = lib.pump_parse(self._ctx, bufs)
        if n < 0:
            raise ValueError(f"pump_parse failed rc={n}")
        cols = np.empty((NF, n), np.int32)
        if n and lib.pump_fill(self._ctx, cols.ctypes.data, n) != 0:
            raise RuntimeError("pump_fill size mismatch")
        asize = lib.pump_arena_size(self._ctx)
        arena = ctypes.create_string_buffer(asize)
        if asize and lib.pump_fill_arena(self._ctx, arena, asize) != 0:
            raise RuntimeError("pump_fill_arena size mismatch")
        return Parsed(
            cols=cols,
            arena=arena.raw[:asize],
            bufs=bufs,
            new_docs=lib.pump_take_new_docs(self._ctx),
            new_clients=lib.pump_take_new_clients(self._ctx),
            new_channels=lib.pump_take_new_channels(self._ctx),
            new_keys=lib.pump_take_new_keys(self._ctx),
        )

    # -- checkpoint-restore preloads ---------------------------------------
    def preload_doc(self, doc_id: str) -> int:
        """Intern a restored document; returns its pump ordinal. The
        caller must treat it as new (it will not reappear in new_docs)."""
        return int(self._lib.pump_preload_doc(
            self._ctx, doc_id.encode("utf-8")))

    def preload_client(self, doc_ord: int, client_id: str,
                       ordinal: int) -> None:
        rc = self._lib.pump_preload_client(
            self._ctx, doc_ord, client_id.encode("utf-8"), ordinal)
        if rc != 0:
            raise ValueError(f"preload_client({doc_ord}) rc={rc}")
