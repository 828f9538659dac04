"""1-D ill-posed test problems (discretized Fredholm integral equations).

Twin of ``hybrid_gmres_tpu/problems/onedim.py``: replacements for the Hansen
Regularization Tools generators the reference dispatches to
(``generate_test_problem.m:3-8``): ``shaw``, ``heat``, ``deriv2``.  Each
returns ``(A, b_exact, x_true)`` with ``b_exact = A @ x_true`` so the
discrete problem is self-consistent.  Matrices are built on the host in
float64 with vectorized numpy (the JAX package's code), then moved to
``device`` at the requested dtype: the card by default, which raises without
one; pass ``device="cpu"`` for the CPU path.
"""

from __future__ import annotations

import numpy as np
import torch

from hybrid_gmres_tpu_torch.utils.device import require_device


def _to_torch(A, b, x, dtype, device):
    dtype = torch.get_default_dtype() if dtype is None else dtype
    device = require_device(device)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (A, b, x))


def shaw(n: int, dtype=None, device="cuda"):
    """1-D image-restoration model (Shaw): Fredholm equation on [-pi/2, pi/2].

    Midpoint quadrature of the kernel
    ``K(s,t) = (cos s + cos t)^2 (sin u / u)^2`` with
    ``u = pi (sin s + sin t)``; the true solution is a sum of two Gaussians.
    """
    if n % 2 != 0:
        raise ValueError("shaw requires even n")
    h = np.pi / n
    s = -np.pi / 2 + (np.arange(1, n + 1) - 0.5) * h
    t = s
    co = np.cos(s)[:, None] + np.cos(t)[None, :]
    u = np.pi * (np.sin(s)[:, None] + np.sin(t)[None, :])
    sinc = np.where(np.abs(u) < 1e-300, 1.0, np.sin(u) / np.where(u == 0, 1.0, u))
    A = h * (co * sinc) ** 2
    x = 2.0 * np.exp(-6.0 * (t - 0.8) ** 2) + np.exp(-2.0 * (t + 0.5) ** 2)
    b = A @ x
    return _to_torch(A, b, x, dtype, device)


def heat(n: int, kappa: float = 1.0, dtype=None, device="cuda"):
    """Inverse heat equation: Volterra integral equation on [0, 1].

    Lower-triangular Toeplitz discretization of the convolution kernel
    ``k(t) = t^{-3/2} / (2 kappa sqrt(pi)) * exp(-1 / (4 kappa^2 t))``;
    the true solution is a smooth ramp/pulse supported on [0, 1/2].
    """
    h = 1.0 / n
    t = (np.arange(1, n + 1) - 0.5) * h
    c = h / (2.0 * kappa * np.sqrt(np.pi))
    d = 1.0 / (4.0 * kappa**2)
    k = c * t ** (-1.5) * np.exp(-d / t)
    # Lower-triangular Toeplitz: A[i, j] = k[i - j] for j <= i.
    idx = np.arange(n)
    diff = idx[:, None] - idx[None, :]
    A = np.where(diff >= 0, k[np.clip(diff, 0, n - 1)], 0.0)
    x = np.zeros(n)
    i = np.arange(1, n // 2 + 1)
    ti = i * 20.0 / n
    x_half = np.where(
        ti < 2.0,
        0.75 * ti**2 / 4.0,
        np.where(ti < 3.0, 0.75 + (ti - 2.0) * (3.0 - ti), 0.75 * np.exp(-(ti - 3.0) * 2.0)),
    )
    x[: n // 2] = x_half
    b = A @ x
    return _to_torch(A, b, x, dtype, device)


def deriv2(n: int, dtype=None, device="cuda"):
    """Second-derivative problem: Green's-function Fredholm equation on [0, 1].

    Midpoint quadrature of ``K(s,t) = s (t - 1)`` for ``s < t`` and
    ``t (s - 1)`` otherwise; true solution ``x(t) = t``.
    """
    h = 1.0 / n
    s = (np.arange(1, n + 1) - 0.5) * h
    S = s[:, None]
    T = s[None, :]
    K = np.where(S < T, S * (T - 1.0), T * (S - 1.0))
    A = h * K
    x = s.copy()
    b = A @ x
    return _to_torch(A, b, x, dtype, device)


_PROBLEMS = {"shaw": shaw, "heat": heat, "deriv2": deriv2}


def generate_test_problem(name: str, n: int, dtype=None, device="cuda"):
    """Name -> problem dispatch mirroring ``generate_test_problem.m:1-12``."""
    try:
        gen = _PROBLEMS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown problem name {name!r}. Use one of {sorted(_PROBLEMS)}."
        ) from None
    return gen(n, dtype=dtype, device=device)
