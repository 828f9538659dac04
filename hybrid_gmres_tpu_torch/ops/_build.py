"""Build and load the port's CUDA kernel library (``csrc/bucket_spmv.cu``).

The source is compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ctypes — no PyTorch headers, so a build takes
seconds.  The library lands in the package's build directory (listed in
``.gitignore``), keyed by a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from hybrid_gmres_tpu_torch.utils.native import build_dir

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch locates it."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(name: str) -> str:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(build_dir(), f"lib{name}-{digest}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library, with the C signature of
    ``bucket_matvec`` declared (pointers and the stream as ``c_void_p``)."""
    with _LOCK:
        if "bucket_spmv" not in _LIBS:
            lib = ctypes.CDLL(_build("bucket_spmv"))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.bucket_matvec.argtypes = [i, i, i, vp, vp, vp, vp, vp, vp,
                                          vp, vp, i, i, i, vp]
            lib.bucket_matvec.restype = i
            _LIBS["bucket_spmv"] = lib
        return _LIBS["bucket_spmv"]
