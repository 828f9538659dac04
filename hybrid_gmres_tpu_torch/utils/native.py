"""Build + ctypes bindings for the native C++ CT assembler (jax-free).

Twin of ``hybrid_gmres_tpu/utils/native.py``.  It compiles the port's own
copy of the assembler, ``csrc/ct_builder.cpp`` (the same source as the JAX
package's; a CPU test holds the two builds to each other bit for bit), with
``g++ -O3`` into the port's own build directory, keyed by a content hash.
No pybind11 — plain C ABI + ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CT_BUILDER_SRC = os.path.join(_PKG_DIR, "csrc", "ct_builder.cpp")
_LOCK = threading.Lock()
_LIBS: dict = {}


def build_dir() -> str:
    """The port's build directory: ``_build/`` inside the package when
    writable (repo checkout), else a user cache dir (read-only install)."""
    out = os.path.join(_PKG_DIR, "_build")
    if not os.access(_PKG_DIR, os.W_OK):
        out = os.path.join(
            os.environ.get("XDG_CACHE_HOME",
                           os.path.join(os.path.expanduser("~"), ".cache")),
            "hybrid_gmres_tpu_torch")
    os.makedirs(out, exist_ok=True)
    return out


def _build() -> str:
    with open(_CT_BUILDER_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(build_dir(), f"libct_builder-{digest}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, _CT_BUILDER_SRC],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return out


def load() -> ctypes.CDLL:
    with _LOCK:
        if "ct_builder" not in _LIBS:
            _LIBS["ct_builder"] = ctypes.CDLL(_build())
        return _LIBS["ct_builder"]


def native_available() -> bool:
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _csr_call(fn, rows, cols, cap, args):
    import scipy.sparse as sp

    indptr = np.zeros(rows + 1, np.int64)
    indices = np.zeros(cap, np.int32)
    data = np.zeros(cap, np.float64)
    nnz = fn(*args, indptr, indices, data, ctypes.c_int64(cap))
    if nnz < 0 or nnz > cap:
        raise RuntimeError("native builder capacity exceeded")
    return sp.csr_matrix(
        (data[:nnz].copy(), indices[:nnz].copy(), indptr), shape=(rows, cols)
    )


def build_fan_projector_native(n, n_angles, n_det, source_radius,
                               fan_margin=1.05, step=0.5):
    fn = load().build_fan_projector
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_double, ctypes.c_double, ctypes.c_double,
                   _i64p, _i32p, _f64p, ctypes.c_int64]
    rows = n_angles * n_det
    # each sample touches <= 4 pixels; ~2*sqrt(2)*n/step in-image samples/ray
    cap = int(rows * (4 * (3.0 * n / step) + 16))
    return _csr_call(
        fn, rows, n * n, cap,
        (ctypes.c_int32(n), ctypes.c_int32(n_angles), ctypes.c_int32(n_det),
         ctypes.c_double(source_radius), ctypes.c_double(fan_margin),
         ctypes.c_double(step)),
    )


def build_pixel_backprojector_native(n, n_angles, n_det, source_radius,
                                     fan_margin=1.05):
    fn = load().build_pixel_backprojector
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_double, ctypes.c_double,
                   _i64p, _i32p, _f64p, ctypes.c_int64]
    rows = n * n
    cap = rows * (2 * n_angles + 8)
    return _csr_call(
        fn, rows, n_angles * n_det, cap,
        (ctypes.c_int32(n), ctypes.c_int32(n_angles), ctypes.c_int32(n_det),
         ctypes.c_double(source_radius), ctypes.c_double(fan_margin)),
    )
