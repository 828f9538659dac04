"""Build and load the port's CUDA kernel libraries (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ctypes — no PyTorch headers, so a build takes
seconds.  The libraries land in the package's build directory (listed in
``.gitignore``), each keyed by a hash of its source and the flags, so an
edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

from hybrid_gmres_tpu_torch.utils.native import build_dir

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# library (source name) -> the argument types of each of its C entry points
# (pointers and the stream as c_void_p)
LIBRARIES = {
    "bucket_spmv": {"bucket_matvec": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                                      _VP, _VP, _VP, _I, _I, _I, _VP]},
    "bucket_spmm": {"bucket_matmat": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                                      _VP, _VP, _VP, _I, _I, _I, _I, _I64,
                                      _I64, _I64, _I64, _I, _VP]},
    "bucket_rspmv": {
        "bucket_rmatvec": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _VP, _VP, _I, _I, _I, _I, _I, _VP],
        "bucket_rmatmat": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _VP, _VP, _I, _I, _I, _I, _I, _I, _I64, _I64,
                           _I64, _I64, _VP]},
    "row_spmv": {"row_spmv": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                              _VP, _I, _I, _I, _VP],
                 "row_spmm": [_I, _I, _I, _I, _I, _VP, _VP, _VP, _VP,
                              _VP, _I64, _I64, _VP, _VP, _VP, _I64, _I64, _I,
                              _I, _I, _I, _VP],
                 "row_spmm_window": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                                     _VP, _VP, _VP, _I, _I, _VP, _I64, _I64,
                                     _VP, _VP, _VP, _I64, _I64, _I, _I, _I,
                                     _VP]},
    "tile_spmm": {"tile_spmm": [_I, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _VP,
                                _VP, _VP, _VP, _I64, _I64, _VP, _I, _I, _I,
                                _I, _I, _I, _VP]},
}
_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch locates it."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _paths(name: str):
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(build_dir(), f"lib{name}-{digest}.so")


def build_all(extra_flags=()) -> dict:
    """Compile every library that is not built yet, one ``nvcc`` process per
    source, all started together.  Returns ``{name: (seconds, compiler
    output)}`` for the sources compiled by this call.  ``extra_flags`` (e.g.
    ``["-Xptxas", "-v"]``) only add to the compiler's output."""
    running = {}
    for name in LIBRARIES:
        src, out = _paths(name)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            running[name] = (src, out, tmp, time.perf_counter(),
                             subprocess.Popen(
                                 [nvcc_path(), *NVCC_FLAGS, *extra_flags,
                                  "-o", tmp, src], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True))
    done, failed = {}, []
    for name, (src, out, tmp, t0, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load_library(name: str = "bucket_spmv") -> ctypes.CDLL:
    """Build (once) and load one kernel library, with the C signature of
    each of its entry points declared."""
    with _LOCK:
        if name not in _LIBS:
            _, out = _paths(name)
            if not os.path.exists(out):
                build_all()
            lib = ctypes.CDLL(out)
            for entry, argtypes in LIBRARIES[name].items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]
