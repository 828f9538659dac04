"""2-D (ray x pixel) mesh BA-GMRES on dense blocks, SUMMA-style (PyTorch
port of ``hybrid_gmres_tpu/parallel/sharded2d.py``).

The 1-D schedules move O(n) values per iteration along the gather
direction whatever the mesh size; a 2-D mesh splits BOTH operator axes:

  * mesh (pr, pc) with axes ("rows", "cols"): rows partition rays, cols
    partition pixels;
  * rank (i, j) holds A's block A[rows_i, cols_j] and B's block B[cols_j,
    rows_i] (the mismatched pair shares the tiling, transposed);
  * n-space vectors (image, Krylov basis) sharded over "cols", replicated
    over "rows"; m-space vectors (sinogram, images A q) sharded over
    "rows", replicated over "cols";
  * the BA matvec is two local block products and two sums: over "cols"
    for ``A x`` (m/pr values), over "rows" for ``B y`` (n/pc values).

The loop is every sharded BA solver's (``sharded_rows._ba_loop``: CGS2
over "cols", the TRUE residual from the stored row-sharded images); only
the block products differ, plain ``torch.matmul`` here as the JAX package
computes them outside any Pallas kernel.  SPMD: every rank passes its own
blocks (:func:`shard_problem_2d`) and the full ``x_true``, and gets the
replicated ``x``.

Reference hot loop being distributed: ``BAgmres_hybrid_bounds.m:24-40``.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels2d import _axes
from hybrid_gmres_tpu_torch.parallel.sharded_rows import _ba_loop, _Setup
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult

__all__ = ["shard_problem_2d", "ba_gmres_sharded_2d"]


def _require_2d(mesh):
    if mesh is None or len(mesh.shape) != 2:
        raise ValueError("ba_gmres_sharded_2d requires an explicit 2-D mesh "
                         "(make_mesh_2d)")


def shard_problem_2d(A, B, b, mesh: Mesh):
    """This rank's blocks on the mesh's device: ``A_blk`` (m/pr, n/pc) =
    A[rows_i, cols_j], ``B_blk`` (n/pc, m/pr) = B[cols_j, rows_i] and
    ``b_loc`` (m/pr,) = b[rows_i], for mesh coordinates (i, j).  ``A``,
    ``B``, ``b``: the full arrays (numpy or tensors, the same on every
    rank); the mesh must divide m and n."""
    _require_2d(mesh)
    A, B, b = (torch.as_tensor(v) for v in (A, B, b))
    (pr, pc), (i, j) = mesh.shape, mesh.coords
    m, n = A.shape
    if m % pr or n % pc:
        raise ValueError(f"mesh {pr}x{pc} must divide m={m}, n={n}")
    rows = slice(i * (m // pr), (i + 1) * (m // pr))
    cols = slice(j * (n // pc), (j + 1) * (n // pc))
    dev = mesh.device
    return (A[rows, cols].contiguous().to(dev),
            B[cols, rows].contiguous().to(dev), b[rows].contiguous().to(dev))


def ba_gmres_sharded_2d(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
) -> GMRESResult:
    """Hybrid/non-hybrid BA-GMRES over a 2-D mesh on dense blocks.

    ``A``, ``B``, ``b``: this rank's blocks (:func:`shard_problem_2d`);
    ``x_true``: the full n-vector or None.  ``mesh``: a
    :func:`~mesh.make_mesh_2d` mesh (required).  ``lam``: None, a scalar
    or ``"gcv"`` (the per-iteration GCV-optimal lambda over ``gcv_grid``,
    replicated, no extra collective).  The TRUE residual comes from the
    stored row-sharded images ``A q_k``.  Per iteration: one sum over
    "cols" for A, one over "rows" for B, two CGS2 sums, the new column's
    norm and the error over "cols", the residual over "rows"."""
    _require_2d(mesh)
    maxit = int(maxit)
    rows, cols = _axes(mesh, axes)
    mloc, nloc = A.shape
    m, n = mloc * rows.size, nloc * cols.size
    s = _Setup(b, x_true, None, lam, None, rows, cols, m, n, maxit, ())
    return _ba_loop(s, rows, cols,
                    lambda x_loc: cols.all_reduce(A @ x_loc),
                    lambda y_loc: rows.all_reduce(B @ y_loc), n, maxit, tol,
                    lam, gcv_grid)
