"""Reference of hybrid BA-GMRES: Krylov space of ``B A`` from ``B b``, and
at each step k the Tikhonov-projected iterate

    y_k = argmin ||H_k y - beta e_1||^2 + lam ||y||^2,   x_k = Q_k y_k,

with the relative residual ``||b - A x_k|| / ||b||``, all in float64."""

from __future__ import annotations

import torch

from gpubench.reference.krylov import arnoldi, by_blocks


def solve(A, B, b, lam, maxit):
    """``b`` (m, R) float64.  Returns ``x`` (n, R) at step ``maxit`` and
    ``res_hist`` (maxit, R)."""
    return by_blocks(_block, A, B, b, lam, maxit)


def _block(A, B, b, lam, maxit):
    R = b.shape[1]
    U = torch.zeros((R, maxit, A.shape[0]), dtype=b.dtype, device=b.device)

    def apply(k, V):
        U[:, k] = (A @ V).T                               # kept: A q_k
        return B @ U[:, k].T

    Q, H, beta = arnoldi(apply, B @ b, maxit)
    b_norm = torch.linalg.vector_norm(b, dim=0)
    res = torch.empty((maxit, R), dtype=b.dtype, device=b.device)
    for k in range(1, maxit + 1):
        Hk = H[:, :k + 1, :k]
        G = Hk.mT @ Hk + lam * torch.eye(k, dtype=b.dtype, device=b.device)
        rhs = Hk[:, 0, :] * beta[:, None]                 # Hk^T beta e_1
        y = torch.linalg.solve(G, rhs)                     # (R, k)
        r = b.T - torch.bmm(y[:, None, :], U[:, :k])[:, 0]
        res[k - 1] = torch.linalg.vector_norm(r, dim=1) / b_norm
    x = torch.bmm(y[:, None, :], Q[:, :maxit])[:, 0]
    return x.T, res
