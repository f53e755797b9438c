"""Build the CUDA kernels of csrc/ into one shared library and load it.

Route: `nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3` into a
library with a plain C interface, loaded with ctypes. Every source compiles
to an object file in its own nvcc process, all started together, then one
link. The build runs at first use, from the sources in this checkout only,
into `kernels/build/<hash of the sources>/`, so an edited source rebuilds
and an unchanged one is loaded as is. A missing nvcc or a failed compile
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "libfluid_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of fluidframework_tpu_torch are built from source at first use")
    return nvcc


def _compile_and_link(nvcc: str, work: Path) -> None:
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(work / LIB_NAME),
         *[str(obj) for _src, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    (work / "ptxas.log").write_text("\n".join(log))


def build() -> Path:
    """Compile and link csrc/*.cu unless this source hash is built; returns
    the library path. The compiler's `-Xptxas -v` report (registers, shared
    memory, spills per kernel) is kept beside it as ptxas.log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=".build-", dir=BUILD_ROOT))
    try:
        _compile_and_link(nvcc, work)
        try:
            os.rename(work, out_dir)
        except OSError:
            if not lib.exists():  # not a concurrent build of the same hash
                raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


_LIB = None
BUILD_SECONDS = None


def _note_build(wall_ms: float) -> None:
    """Record the build or load of the library in the compile ledger: one
    cold call per source (they compile in parallel, so each carries the
    same wall) and the wall once in compile.backend_ms."""
    from ..telemetry import counters
    from ..telemetry.compile_ledger import ledger
    for src in sorted(CSRC.glob("*.cu")):
        ledger.note_call(f"kernels/csrc/{src.name}", wall_ms, grew=1)
    counters.increment("compile.backend_ms", wall_ms)


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with argtypes and
    restype declared for every entry point."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        t0 = time.perf_counter()
        path = build()
        BUILD_SECONDS = time.perf_counter() - t0
        _note_build(BUILD_SECONDS * 1e3)
        lib = ctypes.CDLL(str(path))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fluid_error_string.argtypes = [i32]
        lib.fluid_error_string.restype = ctypes.c_char_p
        lib.fluid_selftest.argtypes = [vp, vp, i32, vp]
        lib.fluid_selftest.restype = i32
        lib.fluid_summary_len.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32,
                                          vp]
        lib.fluid_summary_len.restype = i32
        # ptrs, batch, steps, slots, require_join, stream
        lib.fluid_ticket_scan.argtypes = [ctypes.POINTER(vp), i32, i32, i32,
                                          i32, vp]
        lib.fluid_ticket_scan.restype = i32
        # ptrs, batch, capacity, K, A, steps, with_runs, extract, path,
        # docs_per_block, threads, smem_bytes, stream
        lib.fluid_fused_apply.argtypes = [ctypes.POINTER(vp), i32, i32, i32,
                                          i32, i32, i32, i32, i32, i32, i32,
                                          ctypes.c_longlong, vp]
        lib.fluid_fused_apply.restype = i32
        # ptrs, batch, capacity, K, A, steps, with_runs, path, blocks,
        # threads, smem_bytes, stream
        lib.fluid_scan_apply.argtypes = [ctypes.POINTER(vp), i32, i32, i32,
                                         i32, i32, i32, i32, i32, i32,
                                         ctypes.c_longlong, vp]
        lib.fluid_scan_apply.restype = i32
        # ptrs, tiles, batch, capacity, K, A, steps, with_runs, blocks,
        # threads, smem_bytes, stream
        lib.fluid_fused_sp.argtypes = [ctypes.POINTER(vp), vp, i32, i32, i32,
                                       i32, i32, i32, i32, i32,
                                       ctypes.c_longlong, vp]
        lib.fluid_fused_sp.restype = i32
        # ptrs, batch, capacity, steps, plane rows, plane cols, stream
        lib.fluid_lww_scan.argtypes = [ctypes.POINTER(vp), i32, i32, i32,
                                       i32, i32, vp]
        lib.fluid_lww_scan.restype = i32
        # ptrs, lanes, steps, run_k, plane rows, plane cols, stream
        lib.fluid_window_admit.argtypes = [ctypes.POINTER(vp), i32, i32,
                                           i32, i32, i32, vp]
        lib.fluid_window_admit.restype = i32
        lib.fluid_window_pack_scratch_words.argtypes = []
        lib.fluid_window_pack_scratch_words.restype = i32
        # ptrs, ints, batch, steps, entries, bits_at, stats_at, noop_skip,
        # stream
        lib.fluid_window_pack.argtypes = [ctypes.POINTER(vp),
                                          ctypes.POINTER(i32), i32, i32,
                                          i32, i32, i32, i32, vp]
        lib.fluid_window_pack.restype = i32
        # ptrs, mode, batch, capacity, K, A, path, ranks, threads,
        # docs_per_block, stream
        lib.fluid_zamboni.argtypes = [ctypes.POINTER(vp), i32, i32, i32,
                                      i32, i32, i32, i32, i32, i32, vp]
        lib.fluid_zamboni.restype = i32
        # ptrs, batch, capacity, mx, A, stream
        lib.fluid_narrow_pack.argtypes = [ctypes.POINTER(vp), i32, i32, i32,
                                          i32, vp]
        lib.fluid_narrow_pack.restype = i32
        _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch entry point."""
    if rc != 0:
        name = library().fluid_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {name} ({rc})")


def stream_handle() -> int:
    """PyTorch's current CUDA stream as a raw handle for ctypes."""
    import torch
    return torch.cuda.current_stream().cuda_stream
