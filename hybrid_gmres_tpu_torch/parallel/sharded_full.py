"""GMRES with a row-sharded Krylov basis (PyTorch port of
``hybrid_gmres_tpu/parallel/sharded_full.py``).

``ba_gmres_sharded`` keeps the n-space basis replicated; here each rank
owns a slab of the basis, ``(n/p, maxit+1)`` for BA and ``(m/p, maxit+1)``
for AB.  Per iteration the collectives are:

  * BA: one all_gather of the n-vector q for A's rows, one all_reduce of
    the n-vector ``B_loc (A_loc q)``; AB: one all_reduce of the image
    ``B_loc q_loc``;
  * one fused all_reduce of the k+1 CGS2 coefficients per pass (the
    reference's sequential MGS would need k round trips);
  * one all_reduce of the new column's norm, one of the residual and
    error terms (fused into one call of two values).

The projected k x k solves are replicated compute on every rank.  Every
rank calls the solver with its own slabs (``sharded.shard_problem``) and
the full ``x_true``; it gets back the replicated ``x`` and histories and
its own slab of the basis.

:class:`ShardedArnoldi` holds the loop state and the CGS2 step, shared with
the panel solvers of ``sharded_rows.py``.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.krylov.arnoldi import column_major
from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.sharded import _default_mesh, pnorm
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.solvers.gmres import _make_project_solve


class ShardedArnoldi:
    """The state of a sharded GMRES loop: this rank's basis slab ``Q``
    (rows, maxit+1, stored column by column as the single-chip basis is),
    the replicated Hessenberg ``H`` and right-hand side ``t``, the iterate
    ``x`` (this rank's slab), ``active`` and ``niters`` (device tensors),
    the histories.  No host read inside the loop."""

    def __init__(self, mesh, rows, maxit, x0, dtype, device):
        like = dict(dtype=dtype, device=device)
        self.mesh, self.maxit = mesh, maxit
        self.Q = column_major(rows, maxit + 1, dtype, device)
        self.H = torch.zeros((maxit + 1, maxit), **like)
        self.t = torch.zeros(maxit + 1, **like)
        self.x = x0.clone()
        self.res_hist = torch.full((maxit,), float("nan"), **like)
        self.err_hist = torch.full((maxit,), float("nan"), **like)
        self.niters = torch.zeros((), dtype=torch.int32, device=device)
        self.nan = torch.full((), float("nan"), **like)

    def start(self, r0_loc):
        """q_0 = r0 / ||r0|| (zero, and inactive, when r0 = 0)."""
        beta = pnorm(self.mesh, r0_loc)
        safe = torch.where(beta > 0, beta, torch.ones_like(beta))
        self.Q[:, 0] = torch.where(beta > 0, r0_loc / safe,
                                   torch.zeros_like(r0_loc))
        self.beta = beta
        self.active = beta > 0
        self.t[0] = beta

    def resume(self, rs, k0, active):
        """Continue from a padded checkpoint of this rank (``pad_state``)."""
        self.Q.copy_(rs.Q)
        self.H.copy_(rs.H)
        self.res_hist[:k0] = rs.res_hist[:k0]
        self.err_hist[:k0] = rs.err_hist[:k0]
        self.niters.fill_(k0)
        self.beta = rs.beta.to(self.H.dtype)
        self.active = torch.as_tensor(active, device=self.H.device)
        self.t[0] = self.beta

    def expand(self, k, w_loc):
        """CGS2 of ``w_loc`` against columns 0..k (each pass one fused
        all_reduce of the k+1 coefficients), the new column and its norm
        into ``Q`` and ``H`` where active; returns the breakdown flag."""
        mesh, Qk = self.mesh, self.Q[:, :k + 1]
        c1 = mesh.all_reduce(Qk.T @ w_loc)
        w_loc = w_loc - Qk @ c1
        c2 = mesh.all_reduce(Qk.T @ w_loc)
        w_loc = w_loc - Qk @ c2
        hnorm = pnorm(mesh, w_loc)
        breakdown = hnorm <= 0
        hsafe = torch.where(breakdown, torch.ones_like(hnorm), hnorm)
        col = torch.cat([c1 + c2, hnorm.reshape(1)])
        self.H[:k + 2, k] = torch.where(self.active, col, self.H[:k + 2, k])
        q_new = torch.where(breakdown, torch.zeros_like(w_loc),
                            w_loc / hsafe)
        self.Q[:, k + 1] = torch.where(self.active, q_new, self.Q[:, k + 1])
        return breakdown

    def adopt(self, k, xk, res_k, err_k, breakdown, tol):
        """Record step k where active (the projected solve of a lucky
        breakdown is exact: adopt it, then stop)."""
        a = self.active
        self.x = torch.where(a, xk, self.x)
        self.res_hist[k] = torch.where(a, res_k, self.nan)
        self.err_hist[k] = torch.where(a, err_k, self.nan)
        self.niters = torch.where(a, k + 1, self.niters).to(torch.int32)
        self.active = a & ~(breakdown | (res_k <= tol))


def _check_residual(residual):
    if residual not in ("true", "fused"):
        raise ValueError("residual must be 'true' or 'fused'")


def _x_true(x_true, n, dtype, device):
    return (torch.zeros(n, dtype=dtype, device=device) if x_true is None
            else torch.as_tensor(x_true, dtype=dtype, device=device))


def _result(st, x_full, have_xt, **extra):
    err = st.err_hist if have_xt else torch.full_like(st.err_hist,
                                                      float("nan"))
    return GMRESResult(x_full, err, st.res_hist, st.niters, st.Q, st.H,
                       st.beta, active=st.active, **extra)


def ba_gmres_sharded_basis(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    residual: str = "true",
) -> GMRESResult:
    """BA-GMRES with a row-sharded n-space basis over a 1-D mesh.

    ``A``, ``B``, ``b``: this rank's slabs (``shard_problem``); the mesh
    size must divide m and n.  ``residual="fused"`` keeps the images
    ``A q_k`` (computed by the Krylov matvec anyway) in an m-sharded basis
    and forms the TRUE residual ``||b - IMG y||`` from them: no residual
    product with A and no all_gather of the iterate (the same values up to
    float reassociation)."""
    _check_residual(residual)
    mesh = _default_mesh(mesh, axis)
    maxit = int(maxit)
    p, my = mesh.size, mesh.index
    mloc, n = A.shape
    if n % p:
        raise ValueError(f"mesh size {p} must divide both m={mloc * p} and "
                         f"n={n}")
    nloc = n // p
    dtype, dev = b.dtype, b.device
    have_xt = x_true is not None
    xt_loc = _x_true(x_true, n, dtype, dev)[my * nloc:(my + 1) * nloc]
    mine = slice(my * nloc, (my + 1) * nloc)

    b_norm = pnorm(mesh, b)
    xt_norm = pnorm(mesh, xt_loc)
    st = ShardedArnoldi(mesh, nloc, maxit, torch.zeros(nloc, dtype=dtype,
                                                       device=dev),
                        dtype, dev)
    st.start(mesh.all_reduce(B @ b)[mine])
    ps = _make_project_solve(lam, n, None)
    IMG = (column_major(mloc, maxit, dtype, dev) if residual == "fused"
           else None)
    for k in range(maxit):
        q_full = mesh.all_gather(st.Q[:, k])
        img_loc = A @ q_full
        if IMG is not None:
            IMG[:, k] = img_loc
        w_loc = mesh.all_reduce(B @ img_loc)[mine]
        breakdown = st.expand(k, w_loc)
        kdim = k + 1
        y = ps(st.H, None, st.t, kdim)[:kdim]
        xk_loc = st.Q[:, :kdim] @ y
        if IMG is not None:
            r_loc = b - IMG[:, :kdim] @ y
        else:
            r_loc = b - A @ mesh.all_gather(xk_loc)
        d_loc = xk_loc - xt_loc
        sq = mesh.all_reduce(torch.stack([torch.dot(r_loc, r_loc),
                                          torch.dot(d_loc, d_loc)]))
        st.adopt(k, xk_loc, torch.sqrt(sq[0]) / b_norm,
                 torch.sqrt(sq[1]) / xt_norm, breakdown, tol)
    return _result(st, mesh.all_gather(st.x), have_xt)


def ab_gmres_sharded_basis(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    residual: str = "true",
) -> GMRESResult:
    """AB-GMRES with the m-space basis sharded over the rays: each rank
    owns an (m/p, maxit+1) slab.  Per iteration one all_reduce of the
    n-vector image ``x = B q``, a local product with A's rows, one fused
    all_reduce per CGS2 pass, scalar all_reduces; the solution back-map
    ``x = B (Q_k y)`` is one more all_reduce of the n-vector.

    ``residual="fused"`` stores the replicated images ``S_k = B q_k`` and
    the m-sharded ``W_k = A B q_k``: the solution is ``x = S y`` (no
    back-map) and the TRUE residual ``||b - W y||`` (no product with A)."""
    _check_residual(residual)
    mesh = _default_mesh(mesh, axis)
    maxit = int(maxit)
    mloc, n = A.shape
    dtype, dev = b.dtype, b.device
    have_xt = x_true is not None
    xt = _x_true(x_true, n, dtype, dev)

    b_norm = pnorm(mesh, b)
    xt_norm = torch.linalg.vector_norm(xt)
    st = ShardedArnoldi(mesh, mloc, maxit, torch.zeros(n, dtype=dtype,
                                                       device=dev),
                        dtype, dev)
    st.start(b)
    ps = _make_project_solve(lam, mesh.size * mloc, None)
    fused = residual == "fused"
    if fused:
        S = column_major(n, maxit, dtype, dev)
        W = column_major(mloc, maxit, dtype, dev)
    for k in range(maxit):
        ximg = mesh.all_reduce(B @ st.Q[:, k])
        w_loc = A @ ximg
        if fused:
            S[:, k] = ximg
            W[:, k] = w_loc
        breakdown = st.expand(k, w_loc)
        kdim = k + 1
        y = ps(st.H, None, st.t, kdim)[:kdim]
        if fused:
            xk = S[:, :kdim] @ y
            r_loc = b - W[:, :kdim] @ y
        else:
            xk = mesh.all_reduce(B @ (st.Q[:, :kdim] @ y))
            r_loc = b - A @ xk
        res_k = pnorm(mesh, r_loc) / b_norm
        err_k = torch.linalg.vector_norm(xk - xt) / xt_norm
        st.adopt(k, xk, res_k, err_k, breakdown, tol)
    return _result(st, st.x, have_xt)
