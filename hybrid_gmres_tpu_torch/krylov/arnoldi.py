"""Arnoldi step with blocked CGS2 orthogonalization (PyTorch port).

Twin of ``hybrid_gmres_tpu/krylov/arnoldi.py``.  One step is two classical
Gram-Schmidt passes ("twice is enough"), each a pair of products
``Q.T @ w`` / ``Q @ c`` against the zero-padded ``(n, maxit+1)`` basis:
dot products against unset columns are exactly zero, so no masking is
needed.  These are plain products, left to ``torch.matmul`` (cuBLAS on the
card) as the JAX package leaves them to XLA.

Unlike the JAX version, which returns new arrays, the step writes the new
basis column and Hessenberg column IN PLACE (``Q[:, k+1] = ...``): the basis
is the largest array of the solve and rebuilding it every step would copy
it every step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ArnoldiState(NamedTuple):
    Q: torch.Tensor  # (n, maxit+1) padded orthonormal basis, cols > k zero
    H: torch.Tensor  # (maxit+1, maxit) padded upper Hessenberg
    breakdown: torch.Tensor  # bool: subdiagonal entry hit breakdown_tol


def arnoldi_orthogonalize(
    Q: torch.Tensor,
    H: torch.Tensor,
    k: int,
    w: torch.Tensor,
    breakdown_tol: float = 0.0,
    active=None,
) -> ArnoldiState:
    """CGS2-orthogonalize a precomputed expansion vector ``w = M q_k`` and
    write column ``k+1`` of ``Q`` and column ``k`` of ``H`` in place.

    ``active``: optional bool tensor; where it is False the columns keep
    their old values (the JAX scan's ``select(active, new, old)``), with no
    host sync.
    """
    dtype = w.dtype
    c1 = Q.T @ w
    w = w - Q @ c1
    c2 = Q.T @ w
    w = w - Q @ c2
    h = c1 + c2
    hnorm = torch.linalg.vector_norm(w)
    breakdown = hnorm <= breakdown_tol
    hsafe = torch.where(breakdown, torch.ones((), dtype=dtype,
                                              device=w.device), hnorm)
    h[k + 1] = hnorm
    qnew = torch.where(breakdown, torch.zeros_like(w), w / hsafe)
    if active is None:
        H[:, k] = h
        Q[:, k + 1] = qnew
    else:
        H[:, k] = torch.where(active, h, H[:, k])
        Q[:, k + 1] = torch.where(active, qnew, Q[:, k + 1])
    return ArnoldiState(Q=Q, H=H, breakdown=breakdown)


def arnoldi_step(
    matvec: Callable,
    Q: torch.Tensor,
    H: torch.Tensor,
    k: int,
    breakdown_tol: float = 0.0,
    active=None,
) -> ArnoldiState:
    """One Arnoldi expansion from basis size k+1 to k+2 (0-based step k):
    ``w = M q_k``, then :func:`arnoldi_orthogonalize`."""
    return arnoldi_orthogonalize(Q, H, k, matvec(Q[:, k]), breakdown_tol,
                                 active)
