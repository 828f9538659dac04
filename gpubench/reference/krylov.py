"""A plain float64 Arnoldi process over a block of independent right-hand
sides: each column has its own Krylov space and Hessenberg matrix, and the
columns share only the operator products."""

from __future__ import annotations

import torch

BLOCK = 8     # right-hand sides solved together


def by_blocks(solve_block, A, B, b, lam, maxit):
    """``solve_block`` over the columns of ``b`` in blocks of ``BLOCK``
    (the columns are independent), results joined along the columns."""
    xs, hists = [], []
    for j in range(0, b.shape[1], BLOCK):
        x, res = solve_block(A, B, b[:, j:j + BLOCK], lam, maxit)
        xs.append(x)
        hists.append(res)
    return torch.cat(xs, dim=1), torch.cat(hists, dim=1)


def arnoldi(apply, r0, maxit):
    """``maxit`` Arnoldi steps from each column of ``r0`` (space, R), with
    classical Gram-Schmidt applied twice.

    ``apply(k, V)`` maps step k's (space, R) block of basis vectors to the
    (space, R) block of the Krylov operator's products.  Returns ``Q`` (R,
    maxit + 1, space), ``H`` (R, maxit + 1, maxit) and ``beta`` (R,)."""
    R, space = r0.shape[1], r0.shape[0]
    beta = torch.linalg.vector_norm(r0, dim=0)
    Q = torch.zeros((R, maxit + 1, space), dtype=r0.dtype, device=r0.device)
    H = torch.zeros((R, maxit + 1, maxit), dtype=r0.dtype, device=r0.device)
    Q[:, 0] = (r0 / beta).T
    for k in range(maxit):
        W = apply(k, Q[:, k].T.contiguous())
        w = W.T.unsqueeze(2)                              # (R, space, 1)
        Qk = Q[:, :k + 1]
        h = torch.zeros((R, k + 1, 1), dtype=r0.dtype, device=r0.device)
        for _ in range(2):
            c = torch.bmm(Qk, w)
            w = w - torch.bmm(Qk.mT, c)
            h = h + c
        hn = torch.linalg.vector_norm(w[..., 0], dim=1)
        H[:, :k + 1, k] = h[..., 0]
        H[:, k + 1, k] = hn
        Q[:, k + 1] = w[..., 0] / hn[:, None]
    return Q, H, beta
