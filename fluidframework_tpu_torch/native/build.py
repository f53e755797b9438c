"""Build the port's native (C++) host components and load them.

Each src/<name>.cpp compiles with g++ into lib/<name>-<hash>.so, where the
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as is. The build runs at first use, from the
sources in this checkout; a missing compiler or a failed compile raises
NativeBuildError, and nothing falls back.

Usage: python -m fluidframework_tpu_torch.native.build [--force]
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

SRC_DIR = Path(__file__).resolve().parent / "src"
LIB_DIR = Path(__file__).resolve().parent / "lib"

CXX = os.environ.get("CXX", "g++")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_build_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The compiler is missing, or it refused a source."""


def sources() -> List[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cpp"))


def lib_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    if not src.exists():
        raise NativeBuildError(f"no native source {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((CXX,) + FLAGS).encode())
    return LIB_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def ensure_built(name: str, force: bool = False) -> str:
    """Compile src/<name>.cpp unless this source's library exists; returns
    the library's path. Sources that use the CPython C API (loaded with
    ctypes.PyDLL) get the interpreter's headers. The library is written
    under a temporary name and renamed into place, so processes building
    at once never load a half-written file."""
    out = lib_path(name)
    with _build_lock:
        if out.exists() and not force:
            return str(out)
        LIB_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
        os.close(fd)
        cmd = [CXX, *FLAGS, "-I" + sysconfig.get_paths()["include"],
               str(SRC_DIR / f"{name}.cpp"), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as err:
            os.unlink(tmp)
            raise NativeBuildError(f"{CXX} could not run: {err}") from err
        if proc.returncode != 0:
            os.unlink(tmp)
            raise NativeBuildError(
                f"{' '.join(cmd)} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return str(out)


def main(argv: Optional[List[str]] = None) -> int:
    force = "--force" in (sys.argv[1:] if argv is None else argv)
    for name in sources():
        print(f"built {ensure_built(name, force=force)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
