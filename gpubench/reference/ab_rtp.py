"""Reference of AB-GMRES, regularize-then-project: Krylov space of the
shifted operator ``B A + lam I`` from ``B b``, and at each step k the
Tikhonov re-solve against the original problem restricted to the basis,

    y_k = (Q_k^T A^T A Q_k + lam I)^{-1} Q_k^T A^T b,   x_k = Q_k y_k,

with the relative residual ``||b - A x_k|| / ||b||``, all in float64."""

from __future__ import annotations

import torch

from gpubench.reference.krylov import arnoldi, by_blocks


def solve(A, B, b, lam, maxit):
    """``b`` (m, R) float64.  Returns ``x`` (n, R) at step ``maxit`` and
    ``res_hist`` (maxit, R)."""
    return by_blocks(_block, A, B, b, lam, maxit)


def _block(A, B, b, lam, maxit):
    Q, _, _ = arnoldi(lambda k, V: B @ (A @ V) + lam * V, B @ b,
                      maxit)
    b_norm = torch.linalg.vector_norm(b, dim=0)
    eye = torch.eye(maxit, dtype=b.dtype, device=b.device)
    xs, hists = [], []
    for r in range(b.shape[1]):
        Qr = Q[r, :maxit].T                               # (n, maxit)
        AQ = A @ Qr                                       # (m, maxit)
        G, c = AQ.T @ AQ, AQ.T @ b[:, r]
        Y = torch.zeros((maxit, maxit), dtype=b.dtype, device=b.device)
        for k in range(1, maxit + 1):
            Y[:k, k - 1] = torch.linalg.solve(G[:k, :k] + lam * eye[:k, :k],
                                              c[:k])
        hists.append(torch.linalg.vector_norm(b[:, r:r + 1] - AQ @ Y, dim=0)
                     / b_norm[r])
        xs.append(Qr @ Y[:, -1])
    return torch.stack(xs, dim=1), torch.stack(hists, dim=1)
