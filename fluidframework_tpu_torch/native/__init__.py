"""Native (C++) host components, built with g++ at first use and bound
with ctypes: the wire pump (src/wirepump.cpp), which parses raw boxcar
bytes into the sequencer's int32 staging columns, and the ordered-log
broker (src/oplog.cpp, bound by oplog.py)."""

from .build import NativeBuildError, ensure_built, sources

__all__ = ["NativeBuildError", "ensure_built", "sources"]
