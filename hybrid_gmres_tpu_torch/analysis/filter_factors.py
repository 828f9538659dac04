"""Filter-factor theory and first-order perturbation bounds (host-side).

PyTorch port of ``hybrid_gmres_tpu/analysis/filter_factors.py``: the
analysis is the same host numpy/scipy code, kept here so the port never
imports the JAX package; only :func:`run_with_bounds` calls the port's
solvers.

The reference fuses this O(n^3) analysis into its solver loops
(``ABgmres_hybrid_bounds.m:43-78`` etc.), forcing a dense eig of ``M = A B``
or ``B A`` on every solver call.  Here it is a separable instrumentation
layer (SURVEY.md §1 L3): the device solver returns its Krylov factorization
``(Q, H)`` once, and this module derives, per iteration k:

  * theoretical GMRES filter factors
      non-hybrid:  phi_i = 1 - prod_j (1 - mu_i / theta_j)
      hybrid:      phi_i = mu_i/(mu_i+lam) * (1 - prod_j (1 - (mu_i+lam)/theta_j))
    with mu the (descending) eigenvalues of M and theta harmonic-Ritz-type
    eigenvalues of the projected pencil
    (``ABgmres_nonhybrid_bounds.m:48-69``, ``ABgmres_hybrid_bounds.m:48-73``);
  * first-order perturbation bounds dphi under an operator perturbation
    DeltaM, via dtheta_j = w_j' (Q' DeltaM Q) w_j and dmu_i = u_i' DeltaM u_i
    (``ABgmres_nonhybrid_bounds.m:71-73``, ``BAgmres_hybrid_bounds.m:71-74``).

Products are evaluated in log space with an eps floor exactly as the
reference does (``ABgmres_nonhybrid_bounds.m:60-68``).  Everything here is
numpy/scipy on host — it is only valid for small dense problems and must not
infect the device solver path.

Faithfulness notes: the reference's dmu uses the right-eigenvector quadratic
form (not the left/right first-order formula) and theta pencils differ per
variant — AB-hybrid shifts the standard pencil by lam I and uses a standard
eig (``ABgmres_hybrid_bounds.m:48-50``) while BA-hybrid uses the generalized
eig of (Hbar'Hbar, H_k) (``BAgmres_hybrid_bounds.m:46``); both are kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import scipy.linalg


_EPS = np.finfo(np.float64).eps


@dataclass
class FilterBounds:
    """Per-iteration theoretical filter factors and perturbation bounds."""

    phi_iter: List[np.ndarray] = field(default_factory=list)
    dphi_iter: List[np.ndarray] = field(default_factory=list)

    @property
    def phi_final(self):
        return self.phi_iter[-1]

    @property
    def dphi_final(self):
        return self.dphi_iter[-1]


def spectral_setup(M, DeltaM=None):
    """Eigendecomposition of M sorted by descending real eigenvalue, plus the
    reference's per-eigenvector perturbation numbers dmu_i = u_i' DeltaM u_i."""
    M = np.asarray(M, dtype=np.float64)
    mu, U = np.linalg.eig(M)
    order = np.argsort(-np.real(mu))
    mu = np.real(mu[order])
    U = U[:, order]
    if DeltaM is None:
        dmu = np.zeros_like(mu)
    else:
        DU = np.asarray(DeltaM, np.float64) @ U
        dmu = np.real(np.sum(U * DU, axis=0))
    return mu, U, dmu


def _theta_pencil(H, kdim, variant_hybrid, lam):
    """Harmonic-Ritz-type eigenvalues theta (ascending) + eigenvectors W.

    ``variant_hybrid`` is one of:
      'nonhybrid'  : P = H_k + h^2 H_k^{-T} e_k e_k'        (standard eig)
      'ab_hybrid'  : same P + lam I                          (standard eig)
      'ba_hybrid'  : generalized eig(Hbar' Hbar, H_k)
    """
    k = kdim
    Hbar = H[: k + 1, :k]
    Hk = H[:k, :k]
    if variant_hybrid == "ba_hybrid":
        theta, W = scipy.linalg.eig(Hbar.T @ Hbar, Hk)
    else:
        ek = np.zeros((k, 1))
        ek[-1, 0] = 1.0
        h2 = H[k, k - 1] ** 2
        P = Hk + h2 * np.linalg.solve(Hk.T, ek @ ek.T)
        if variant_hybrid == "ab_hybrid":
            P = P + lam * np.eye(k)
        theta, W = np.linalg.eig(P)
    theta = np.real(theta)
    order = np.argsort(theta)
    return theta[order], W[:, order]


def _phi_dphi(mu_k, dmu_k, theta, dtheta, lam, hybrid):
    """Log-space filter-factor products + first-order perturbation terms."""
    k = mu_k.shape[0]
    s = mu_k + lam if hybrid else mu_k
    # factors_{ij} = max(1 - s_i / theta_j, eps)
    factors = np.maximum(1.0 - s[:, None] / theta[None, :], _EPS)
    logf = np.log(factors)
    Clog = np.sum(logf, axis=1)  # (k,)
    P_final = np.exp(Clog)
    # P_excl[i, j] = prod_{l != j} factors_il, in log space
    P_excl = np.exp(Clog[:, None] - logf)

    if hybrid:
        phi = (mu_k / s) * (1.0 - P_final)
        term1 = -mu_k * np.sum((dtheta[None, :] / theta[None, :] ** 2) * P_excl, axis=1)
        term2 = (lam / s**2) * (1.0 - P_final) * dmu_k
        term3 = (mu_k / s) * np.sum((1.0 / theta[None, :]) * P_excl, axis=1) * dmu_k
        dphi = term1 + term2 + term3
    else:
        phi = 1.0 - P_final
        term1 = -mu_k * np.sum((dtheta[None, :] / theta[None, :] ** 2) * P_excl, axis=1)
        term2 = np.sum((1.0 / theta[None, :]) * P_excl, axis=1) * dmu_k
        dphi = term1 + term2
    return phi, dphi


def filter_bounds_from_factorization(
    variant: str,
    hybrid: bool,
    Q,
    H,
    niters: int,
    M,
    DeltaM=None,
    lam: float = 0.0,
) -> FilterBounds:
    """Compute phi/dphi for k = 1..niters from a solver's (Q, H) and M.

    ``variant`` in {'ab', 'ba'} selects the theta pencil for the hybrid case.
    """
    Q = np.asarray(Q, np.float64)
    H = np.asarray(H, np.float64)
    mu_full, U, dmu_full = spectral_setup(M, DeltaM)
    if hybrid:
        vh = "ba_hybrid" if variant == "ba" else "ab_hybrid"
    else:
        vh = "nonhybrid"

    if DeltaM is not None:
        DQ = np.asarray(DeltaM, np.float64) @ Q
    out = FilterBounds()
    for k in range(1, int(niters) + 1):
        theta, W = _theta_pencil(H, k, vh, lam)
        if DeltaM is None:
            dtheta = np.zeros(k)
        else:
            dK = Q[:, :k].T @ DQ[:, :k]
            dtheta = np.real(np.diag(W.conj().T @ dK @ W))
        phi, dphi = _phi_dphi(
            mu_full[:k], dmu_full[:k], theta, dtheta, lam, hybrid
        )
        out.phi_iter.append(phi)
        out.dphi_iter.append(dphi)
    return out


def empirical_filter_factors(A, b, x):
    """Empirical filter factors Phi = sigma .* (V'x) ./ (U'b) via svd(A),
    with the |d| < 1e-12 guard (``plot_filter_factors.m:30-40``)."""
    A = np.asarray(A, np.float64)
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    d = U.T @ np.asarray(b, np.float64)
    d = np.where(np.abs(d) < 1e-12, 1.0, d)
    return s * (Vt @ np.asarray(x, np.float64)) / d


def run_with_bounds(
    variant: str,
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: Optional[int] = None,
    lam=None,
    DeltaM=None,
    device="cuda",
):
    """Convenience: run the AB/BA (hybrid or not) solver, then derive bounds.

    Returns ``(GMRESResult, FilterBounds)`` — the decoupled equivalent of the
    reference's eight-output ``*gmres_*_bounds`` functions.  The solve runs
    on ``device`` (the card by default; ``"cpu"`` for the CPU path) in the
    dtype of ``b`` when it is a tensor, else float64; the bounds read its
    ``Q``, ``H`` and ``niters`` back as float64 host arrays.
    """
    import torch

    from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres
    from hybrid_gmres_tpu_torch.utils.device import require_device

    dev = require_device(device)
    dt = b.dtype if isinstance(b, torch.Tensor) else torch.float64
    A_arr, B_arr = _host64(A), _host64(B)
    M = A_arr @ B_arr if variant == "ab" else B_arr @ A_arr

    def on_device(a):
        return None if a is None else torch.as_tensor(
            _host64(a), dtype=dt, device=dev)

    solver = ab_gmres if variant == "ab" else ba_gmres
    res = solver(on_device(A_arr), on_device(B_arr), on_device(b),
                 on_device(x_true), tol=tol, maxit=maxit, lam=lam)
    hybrid = lam is not None
    bounds = filter_bounds_from_factorization(
        variant,
        hybrid,
        _host64(res.Q),
        _host64(res.H),
        int(res.niters),
        M,
        DeltaM=DeltaM,
        lam=float(lam) if hybrid else 0.0,
    )
    return res, bounds


def _host64(a):
    """A tensor (on any device) or an array as a float64 numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)
