"""Row-sharded dense operator pairs and the distributed BA-GMRES
(PyTorch port of ``hybrid_gmres_tpu/parallel/sharded.py``).

Layout over a 1-D mesh of p ranks:

  * A (m, n): row-partitioned, each rank owns m/p rays;
  * B (n, m): column-partitioned, matching A's row split;
  * m-space vectors (sinogram, residual): sharded;
  * n-space vectors (image, the BA Krylov basis): replicated.

The composed BA matvec is ``x' = all_reduce(B_loc @ (A_loc @ x))``: one
collective per composed matvec.  Every rank calls the same function with
its own slabs (:func:`shard_problem`) and gets the same replicated result.

The JAX package also runs its unchanged single-device solvers on sharded
inputs, leaving the collectives to XLA's sharding propagation (GSPMD).
PyTorch has no counterpart short of DTensor, so the port offers the
explicit schedule only.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.solvers.common import (
    GMRESResult,
    gmres_core,
    rel_error_fn,
)
from hybrid_gmres_tpu_torch.solvers.gmres import _make_project_solve


def _default_mesh(mesh, axis):
    if mesh is None:
        from hybrid_gmres_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(axis_name=axis)
    return mesh


def shard_problem(A, B, b, mesh: Mesh):
    """This rank's slabs of the pair on the mesh's device: ``A_loc``
    (m/p, n), ``B_loc`` (n, m/p), ``b_loc`` (m/p,).  ``A``, ``B``, ``b``:
    the full arrays (numpy or tensors, the same on every rank); m must be
    divisible by the mesh size."""
    A, B, b = (torch.as_tensor(v) for v in (A, B, b))
    m = A.shape[0]
    p = mesh.size
    if m % p:
        raise ValueError(f"mesh size {p} must divide m={m}")
    rows = slice(mesh.index * (m // p), (mesh.index + 1) * (m // p))
    dev = mesh.device
    return (A[rows].contiguous().to(dev), B[:, rows].contiguous().to(dev),
            b[rows].contiguous().to(dev))


def sharded_ba_matvec(A, B, mesh: Mesh):
    """BA matvec on this rank's slabs: x (replicated, n) -> B A x
    (replicated): one local product each side, one all_reduce."""
    return lambda x: mesh.all_reduce(B @ (A @ x))


def sharded_ab_matvec(A, B, mesh: Mesh):
    """AB matvec on this rank's slabs: q (sharded, m/p) -> A B q (sharded):
    the image ``B q`` needs the one all_reduce, A's rows are local."""
    return lambda q: A @ mesh.all_reduce(B @ q)


def krylov_mv_r0(B, b, mesh: Mesh):
    """r0 = B b for this rank's slabs of B and b (one all_reduce)."""
    return mesh.all_reduce(B @ b)


def pnorm(mesh: Mesh, v_loc):
    """The norm of a sharded vector from this rank's slab (one
    all_reduce)."""
    return torch.sqrt(mesh.all_reduce(torch.dot(v_loc, v_loc)))


def ba_gmres_sharded(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    history: bool = True,
) -> GMRESResult:
    """BA-GMRES over a mesh with the explicit one-all_reduce matvec, through
    ``solvers/common.py:gmres_core``.

    ``A``, ``B``, ``b``: this rank's slabs (:func:`shard_problem`);
    ``x_true``: the full (replicated) n-vector or None.  The Krylov basis
    is replicated n-space, the sinogram space sharded; the result is the
    same on every rank."""
    mesh = _default_mesh(mesh, axis)
    maxit = int(maxit)
    n = A.shape[1]
    krylov_mv = sharded_ba_matvec(A, B, mesh)
    b_norm = pnorm(mesh, b)

    def residual_fn(x):
        return pnorm(mesh, b - A @ x) / b_norm

    if x_true is not None:
        x_true = torch.as_tensor(x_true, dtype=b.dtype, device=b.device)
    return gmres_core(
        krylov_mv=krylov_mv,
        r0=krylov_mv_r0(B, b, mesh),
        project_solve=_make_project_solve(lam, n, None),
        solution_fn=lambda Q, y: Q[:, :maxit].to(y.dtype) @ y,
        residual_fn=residual_fn,
        error_fn=rel_error_fn(x_true),
        maxit=maxit,
        tol=tol,
        x_shape=n,
        history=history,
    )
