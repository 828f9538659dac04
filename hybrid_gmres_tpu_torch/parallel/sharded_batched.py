"""Sharded multi-RHS (batched) hybrid BA/AB-GMRES: serving on a mesh
(PyTorch port of ``hybrid_gmres_tpu/parallel/sharded_batched.py``; the
functions keep its names).

The multi-RHS serving solver (``solvers/batched.py``: R sinograms per
solve, one read of a form per tile of 8 columns) on the row-sharded forms
of ``parallel/panels.py``.  Every Krylov product is a multi-RHS product on
this rank's shard:

  * A: the redesigned K2 (``row_matmat``) on A's forward form, after
    :func:`~panels.gather_window_mat` (the windowed shifts or one
    all_gather, R times the payload);
  * B, transposed layout (``BT_panels``): the redesigned K4
    (``row_rmatmat``) on the form of the transpose of this rank's rows of
    B^T, then :func:`~panels.scatter_window_to_full_mat` and one
    reduce_scatter; forward layout (``B_panels``): K2 on B's own shard
    after a gather of the m-sharded intermediate.

The collectives of a step are those of the single-RHS sharded solver, each
carrying R columns: one gather for A, one reduce_scatter (or gather) for B,
one fused all_reduce per CGS2 pass ((k+1, R) coefficients), one for the
new columns' norms and one each for the residual and error norms.  Their
count does not depend on R.

Per-RHS semantics are those of ``ba_gmres_batched``/``ab_gmres_batched``
(independent Arnoldi recurrences, per-RHS projected solves, histories,
active flags and warm starts; not block GMRES): the loop is the
single-chip one (``solvers/batched._batched_core`` and its deferred twin)
run on this rank's slabs with the sums over the mesh injected
(:func:`_mesh_batched_core`).  SPMD as in ``sharded_rows.py``: every rank
passes the full ``b`` (m, R), ``x_true`` and ``x0``, gets the replicated
``x`` (n, R) and histories, and its own slabs of ``Q``, ``IMG`` and ``S``.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels import (
    ShardedPanels,
    gather_window_mat,
    local_matmat,
    local_rmatmat_window,
    scatter_window_to_full_mat,
)
from hybrid_gmres_tpu_torch.parallel.sharded import _default_mesh
from hybrid_gmres_tpu_torch.parallel.sharded_rows import (
    _on_device,
    _validate,
)
from hybrid_gmres_tpu_torch.solvers.batched import (
    Reductions,
    _batched_core,
    _batched_core_deferred,
    _chunk_slices,
    _concat_results,
    _lam_solvers,
    _prepare_resume,
    _slice_result,
)
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.utils.checkpoint import resume_fingerprint

__all__ = [
    "ba_gmres_sharded_batched",
    "ab_gmres_sharded_batched",
]


def _col_norms(mesh: Mesh):
    """Column norms of batch-first arrays summed over ``mesh`` (the R
    column norms of a call ride one collective)."""
    def norm(X):
        return torch.sqrt(mesh.all_reduce((X * X).sum(dim=-1)))
    return norm


def _mesh_reductions(m_mesh: Mesh, n_mesh: Mesh | None = None,
                     basis: Mesh | None = None) -> Reductions:
    """The batched cores' sums: m-space over ``m_mesh``, n-space over
    ``n_mesh``, the Krylov basis's coefficients and norms over ``basis``.
    On a 1-D mesh every space is row-sharded over the same ranks (the
    defaults), so each is one all_reduce over it; on the 2-D tier they are
    the per-axis sub-meshes."""
    n_mesh = m_mesh if n_mesh is None else n_mesh
    basis = m_mesh if basis is None else basis
    return Reductions(coeff=basis.all_reduce, norm_m=_col_norms(m_mesh),
                      norm_sp=_col_norms(basis), norm_n=_col_norms(n_mesh))


def _make_A_mm(A_loc, mesh, dtype, comm_dtype):
    """This rank's ``X (n/p, R) -> A X`` rows (m/p, R)."""
    def A_mm(X_loc):
        X_win = gather_window_mat(A_loc, X_loc, mesh, comm_dtype)
        return local_matmat(A_loc, X_win).to(dtype)
    return A_mm


def _make_B_mm(B_loc, b_forward, mesh, dtype, comm_dtype=None):
    """This rank's ``U (m/p, R) -> B U`` slab (n/p, R) in the two layouts
    of the single-RHS ``sharded_rows._operators``; the partial is cast to
    the solver's dtype before the reduce_scatter."""
    if b_forward:
        def B_mm(U_loc):
            U_win = gather_window_mat(B_loc, U_loc, mesh, comm_dtype)
            return local_matmat(B_loc, U_win).to(dtype)
    else:
        def B_mm(U_loc):
            part = local_rmatmat_window(B_loc, U_loc)
            return mesh.reduce_scatter(
                scatter_window_to_full_mat(B_loc, part).to(dtype))
    return B_mm


def _mesh_batched_core(kind, A_mm, B_mm, red, b_loc, xt_loc, x0_loc,
                       project_solve, select_lam, maxit, tol,
                       defer_histories, resume=None):
    """The shard-local multi-RHS GMRES loop of one chunk of right-hand
    sides, for every tier of the mesh.  The tier injects its operator
    products ``A_mm``/``B_mm`` (collectives inside) and its sums
    ``red`` (:class:`~solvers.batched.Reductions`: the CGS2 coefficients
    and the norms of the image, basis and solution spaces); the loop is the
    single-chip one, in-loop or deferred.  ``b_loc`` (m-slab, R),
    ``xt_loc``/``x0_loc`` (n-slab, R; ``x0_loc`` None for a cold start),
    ``resume``: this rank's checkpoint of the chunk (its own slab of ``x``)
    padded to ``maxit``, in-loop mode only.  Returns the result of this
    rank's slabs (``x`` included)."""
    rhs = b_loc if x0_loc is None else b_loc - A_mm(x0_loc)
    if kind == "ba":
        # r0 only seeds a cold start; on resume the product would be dead
        r0 = None if resume is not None else B_mm(rhs)
        first_mm, second_mm, solution, img_stage = A_mm, B_mm, "basis", \
            "first"
    else:
        r0 = rhs
        first_mm, second_mm, solution, img_stage = B_mm, A_mm, "image", \
            "second"
    core, extra = ((_batched_core_deferred, {"select_lam": select_lam})
                   if defer_histories else (_batched_core,
                                            {"resume": resume}))
    return core(first_mm=first_mm, second_mm=second_mm, r0=r0, rhs=rhs,
                b_norm=red.norm_m(b_loc.T), project_solve=project_solve,
                solution=solution, x_true=xt_loc, maxit=maxit, tol=tol,
                img_stage=img_stage, x_offset=x0_loc, red=red, **extra)


def _sharded_batched(kind, A_panels, BT_panels, b, x_true, tol, maxit, lam,
                     gcv_grid, mesh, axis, x0, B_panels, comm_dtype,
                     chunk_rhs, defer_histories, resume_from):
    mesh = _default_mesh(mesh, axis)
    p, m, n = _validate(A_panels, BT_panels, mesh, B_panels)
    b_forward = B_panels is not None
    A_loc, B_loc = _on_device(mesh, A_panels,
                              B_panels if b_forward else BT_panels)
    b = torch.as_tensor(b, device=mesh.device)
    A_mm = _make_A_mm(A_loc, mesh, b.dtype, comm_dtype)
    B_mm = _make_B_mm(B_loc, b_forward, mesh, b.dtype, comm_dtype)
    return _run_batched(kind, A_mm, B_mm, _mesh_reductions(mesh), mesh,
                        mesh, m, n, b, x_true, tol, maxit, lam, gcv_grid, x0,
                        chunk_rhs, defer_histories, resume_from)


def _run_batched(kind, A_mm, B_mm, red, m_mesh, n_mesh, m, n, b, x_true, tol,
                 maxit, lam, gcv_grid, x0, chunk_rhs, defer_histories,
                 resume_from):
    """The chunks of a sharded multi-RHS solve on this rank, for every
    tier: ``b`` sliced along ``m_mesh`` (its rows), ``x_true``/``x0`` and
    the checkpoint's ``x`` along ``n_mesh``, each chunk through
    :func:`_mesh_batched_core`, its ``x`` gathered over ``n_mesh``."""
    maxit = int(maxit)
    dev = m_mesh.device
    b = torch.as_tensor(b, device=dev)
    if b.ndim != 2:
        raise ValueError(f"{kind}_gmres_sharded_batched expects b of shape "
                         f"(m, R); use {kind}_gmres_sharded_pallas for a "
                         "single RHS")
    dtype, R = b.dtype, b.shape[1]
    like = dict(dtype=dtype, device=dev)
    mloc, nloc = m // m_mesh.size, n // n_mesh.size
    rows_m = slice(m_mesh.index * mloc, (m_mesh.index + 1) * mloc)
    rows = slice(n_mesh.index * nloc, (n_mesh.index + 1) * nloc)
    xt = (torch.full((n, R), float("nan"), **like) if x_true is None
          else torch.as_tensor(x_true, **like).reshape(n, -1).expand(n, R))
    if x0 is not None:
        x0 = torch.as_tensor(x0, **like).reshape(n, -1).expand(n, R)
    resume_from = _prepare_resume(kind, resume_from, x0, lam, maxit,
                                  defer_histories)
    project_solve, select_lam = _lam_solvers(
        lam, n if kind == "ba" else m, gcv_grid, defer_histories)
    fp = resume_fingerprint(x0, lam, device=dev)

    parts = []
    for sl in _chunk_slices(R, chunk_rhs):
        rs = None
        if resume_from is not None:
            rs = _slice_result(resume_from, sl)
            rs = rs._replace(x=rs.x[rows])
        r = _mesh_batched_core(
            kind, A_mm, B_mm, red, b[rows_m, sl], xt[rows, sl],
            None if x0 is None else x0[rows, sl], project_solve, select_lam,
            maxit, tol, defer_histories, rs)
        parts.append(r._replace(x=n_mesh.all_gather(r.x)))
    res = _concat_results(parts)
    if x_true is None:
        res = res._replace(err_hist=torch.full_like(res.err_hist,
                                                    float("nan")))
    return res._replace(fp=fp)


def ba_gmres_sharded_batched(
    A_panels: ShardedPanels,
    BT_panels: ShardedPanels | None,
    b,
    x_true=None,
    tol: float = 0.0,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    x0=None,
    B_panels: ShardedPanels | None = None,
    comm_dtype=None,
    chunk_rhs: int | None = 8,
    defer_histories: bool = False,
    resume_from: GMRESResult | None = None,
) -> GMRESResult:
    """Sharded multi-RHS (hybrid) BA-GMRES over R right-hand sides.

    ``b``: (m, R), the full array on every rank.  Per RHS the results match
    ``solvers.batched.ba_gmres_batched``; the collectives of a step are the
    single-RHS ``ba_gmres_sharded_pallas``'s, whatever R.  ``x0``: an
    optional (n, R) (or (n,) broadcast) per-RHS warm start.  ``chunk_rhs``:
    R is split into solves of at most this many columns (default 8; None:
    one).  ``defer_histories``: the Arnoldi-only loop and the post-loop
    solves and histories of the single-chip deferred mode (``lam=
    "gcv-final"`` needs it).  ``B_panels``/``comm_dtype``/``mesh``/``axis``
    as in ``ba_gmres_sharded_pallas``.  ``resume_from``: this rank's result
    of an earlier call of this solver (same ``x0``/``lam``/``chunk_rhs``;
    fingerprint-checked; in-loop mode only): every RHS continues with its
    carried active flag."""
    return _sharded_batched("ba", A_panels, BT_panels, b, x_true, tol,
                            maxit, lam, gcv_grid, mesh, axis, x0, B_panels,
                            comm_dtype, chunk_rhs, defer_histories,
                            resume_from)


def ab_gmres_sharded_batched(
    A_panels: ShardedPanels,
    BT_panels: ShardedPanels | None,
    b,
    x_true=None,
    tol: float = 0.0,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    x0=None,
    B_panels: ShardedPanels | None = None,
    comm_dtype=None,
    chunk_rhs: int | None = 8,
    defer_histories: bool = False,
    resume_from: GMRESResult | None = None,
) -> GMRESResult:
    """Sharded multi-RHS (hybrid) AB-GMRES: the m-space bases sharded over
    the rays, the solutions from the n-sharded images ``S = B Q`` (per RHS
    ``r0 = b - A x0``, ``x = x0 + S y``).  See
    :func:`ba_gmres_sharded_batched`."""
    return _sharded_batched("ab", A_panels, BT_panels, b, x_true, tol,
                            maxit, lam, gcv_grid, mesh, axis, x0, B_panels,
                            comm_dtype, chunk_rhs, defer_histories,
                            resume_from)
