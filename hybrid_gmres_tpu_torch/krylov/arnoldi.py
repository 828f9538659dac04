"""Arnoldi process with blocked CGS2 orthogonalization (PyTorch port).

Twin of ``hybrid_gmres_tpu/krylov/arnoldi.py``.  One step is two classical
Gram-Schmidt passes ("twice is enough"), each a pair of products
``Q.T @ w`` / ``Q @ c`` against the zero-padded ``(n, maxit+1)`` basis:
dot products against unset columns are exactly zero, so no masking is
needed.  These are plain products, left to ``torch.matmul`` (cuBLAS on the
card) as the JAX package leaves them to XLA.

Unlike the JAX version, which returns new arrays, the step writes the new
basis column and Hessenberg column IN PLACE (``Q[:, k+1] = ...``): the basis
is the largest array of the solve and rebuilding it every step would copy
it every step.  The basis may be stored in a narrower dtype than the
working one (``basis_dtype``, bf16): its columns are upcast where they are
read, exactly (a bf16 value is exact in float32), and only the stored
column is rounded, as ``jnp`` promotes the mixed product.
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

    The projections read the k+1 set columns of ``Q`` only (the JAX
    package's products run over the whole zero-padded basis: the same
    numbers in exact arithmetic).  So every product of step k has a shape
    that depends on k alone, not on the padded width ``maxit``: cuBLAS
    reduces a product of another width in another order (measured with
    ``scripts_torch/padding_check.py``), and a solve resumed from a
    checkpoint with a smaller ``maxit`` would drift from the uninterrupted
    one.

    ``active``: optional bool tensor; where it is False the columns keep
    their old values (the JAX scan's ``select(active, new, old)``), with no
    host sync.
    """
    dtype = w.dtype
    Qk = Q[:, :k + 1]
    Qk = Qk if Qk.dtype == dtype else Qk.to(dtype)
    c1 = Qk.T @ w
    w = w - Qk @ c1
    c2 = Qk.T @ w
    w = w - Qk @ c2
    hnorm = torch.linalg.vector_norm(w)
    breakdown = hnorm <= breakdown_tol
    hsafe = torch.where(breakdown, torch.ones((), dtype=dtype,
                                              device=w.device), hnorm)
    h = torch.cat([c1 + c2, hnorm.reshape(1)])      # H[:k+2, k]
    qnew = torch.where(breakdown, torch.zeros_like(w), w / hsafe)
    if active is None:
        H[:k + 2, k] = h
        Q[:, k + 1] = qnew
    else:
        H[:k + 2, k] = torch.where(active, h, H[:k + 2, k])
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


def column_major(rows, cols, dtype, device):
    """Zero (rows, cols) tensor stored column by column: a column read or
    write (the per-step access of the bases) touches contiguous memory."""
    return torch.zeros((cols, rows), dtype=dtype, device=device).T


def arnoldi(
    matvec: Callable,
    r0: torch.Tensor,
    maxit: int,
    breakdown_tol: float = 0.0,
):
    """Run ``maxit`` Arnoldi steps from ``r0``; returns (Q, H, beta, nsteps).

    ``nsteps`` (an int32 tensor) counts the fully completed expansions: a
    breakdown at step k still records H[:, k] but stops growing the basis
    (the reference's ``if H(k+1,k)==0, break``,
    ``ABgmres_hybrid_bounds.m:31``).  This differs from ``gmres_core``,
    which adopts the breakdown step's solve and counts it.  A fixed-trip
    loop with an active mask, no host reads: every step launches its
    matvec."""
    n = r0.shape[0]
    beta = torch.linalg.vector_norm(r0)
    Q = column_major(n, maxit + 1, r0.dtype, r0.device)
    Q[:, 0] = r0 / beta
    H = torch.zeros((maxit + 1, maxit), dtype=r0.dtype, device=r0.device)
    active = torch.ones((), dtype=torch.bool, device=r0.device)
    nsteps = torch.zeros((), dtype=torch.int32, device=r0.device)
    for k in range(maxit):
        # on breakdown the new column is zero, as the unset one was: writing
        # it under ``active`` is the JAX ``select(active & ~breakdown)``
        st = arnoldi_step(matvec, Q, H, k, breakdown_tol, active)
        active = active & ~st.breakdown
        nsteps = torch.where(active, k + 1, nsteps)
    return Q, H, beta, nsteps
