"""Sharded regularize-then-project (RTP) hybrid GMRES (PyTorch port of
``hybrid_gmres_tpu/parallel/sharded_rtp.py``; the functions keep its
names): the distributed twins of ``solvers/rtp.py`` on the per-shard forms
of ``sharded_rows.py``.

Both build the Krylov space on the shifted operator ``B A + lam I``
(reference ``hybrid_ab_gmres_rtp.m:6-7``).  The shift is shard-diagonal
(``+ lam q_loc`` on the n-sharded slab), so a step costs the collectives of
the PTR solvers in ``sharded_rows.py``: one gather for A's rows (the
redesigned K1), one reduce_scatter after K3 on B^T's shard (or, with
``B_panels``, a gather and K1 on B's), one fused all_reduce per CGS2 pass,
the new column's norm, and the residual and error norms in one all_reduce.

The AB variant's inner solve ``y = (AQ' AQ + lam I)^{-1} AQ' b``
(``hybrid_ab_gmres_rtp.m:31-33``) is built incrementally from the stored
images: each step's new Gram column ``IMG^T img_k`` and right-hand side
entry ``img_k . b`` ride one fused all_reduce, instead of re-projecting the
whole basis (the single-chip ``solvers/rtp.py`` recomputes ``A Q`` every
step, as the reference does).  The local Gram products run in full float32
whatever the caller set: the normal equations square the conditioning.

The true residual ``||b - A x_k||`` comes from the stored images ``A q_k``
in both (no extra product).  SPMD as in ``sharded_rows.py``: every rank
passes the host-built panels or its :func:`~panels.shard_view`, the full
``b`` and ``x_true``, and gets the replicated ``x`` and histories and its
own basis slab.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.krylov.arnoldi import column_major
from hybrid_gmres_tpu_torch.krylov.projected import (
    projected_gram_tikhonov_solve,
    projected_ls_solve,
)
from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels import ShardedPanels
from hybrid_gmres_tpu_torch.parallel.sharded import _default_mesh, pnorm
from hybrid_gmres_tpu_torch.parallel.sharded_full import ShardedArnoldi
from hybrid_gmres_tpu_torch.parallel.sharded_rows import (
    _finish,
    _operators,
    _Setup,
    _validate,
)
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.utils.device import (
    full_float32_matmul,
    scalar_tensor,
)

__all__ = ["ba_gmres_rtp_sharded", "ab_gmres_rtp_sharded"]


def _rtp_core(kind, A_panels, BT_panels, b, x_true, tol, maxit, lam, mesh,
              axis, B_panels):
    mesh = _default_mesh(mesh, axis)
    maxit = int(maxit)
    p, m, n = _validate(A_panels, BT_panels, mesh, B_panels)
    s = _Setup(b, x_true, None, lam, None, mesh, mesh, m, n, maxit, ())
    dtype, dev = s.dtype, mesh.device
    A_mv, B_mv = _operators(A_panels, BT_panels, B_panels, mesh, dtype, None)
    lam_c = scalar_tensor(lam, dtype, dev)
    b_norm = pnorm(mesh, s.b_loc)
    xt_norm = pnorm(mesh, s.xt_loc)
    st = ShardedArnoldi(mesh, s.nloc, maxit, s.x0_loc, dtype, dev)
    st.start(B_mv(s.b_loc))          # d = B b (hybrid_ba_gmres_rtp.m:6)
    IMG = column_major(s.mloc, maxit, dtype, dev)
    if kind == "ab":
        # the inner Gram G = (A Q)'(A Q) and g = (A Q)' b, replicated
        G = torch.zeros((maxit, maxit), dtype=dtype, device=dev)
        g = torch.zeros((maxit,), dtype=dtype, device=dev)
    for k in range(maxit):
        q = st.Q[:, k]
        img = A_mv(q)
        IMG[:, k] = img
        kdim = k + 1
        if kind == "ab":
            with full_float32_matmul():
                red = mesh.all_reduce(torch.cat(
                    [IMG[:, :kdim].T @ img, (img @ s.b_loc).reshape(1)]))
            a = st.active
            G[:kdim, k] = torch.where(a, red[:kdim], G[:kdim, k])
            G[k, :kdim] = torch.where(a, red[:kdim], G[k, :kdim])
            g[k] = torch.where(a, red[kdim], g[k])
        # the shifted operator: w = B (A q) + lam q
        breakdown = st.expand(k, B_mv(img) + lam_c * q)
        if kind == "ab":
            # Tikhonov re-solve against the original A and b restricted to
            # Q_k (hybrid_ab_gmres_rtp.m:31-33)
            y = projected_gram_tikhonov_solve(G, g, lam, kdim)[:kdim]
        else:
            # the plain projected LS (hybrid_ba_gmres_rtp.m:28-30)
            y = projected_ls_solve(st.H, st.t, kdim)[:kdim]
        xk_loc = st.Q[:, :kdim] @ y
        r_loc = s.b_loc - IMG[:, :kdim] @ y
        d_loc = xk_loc - s.xt_loc
        sq = mesh.all_reduce(torch.stack([torch.dot(r_loc, r_loc),
                                          torch.dot(d_loc, d_loc)]))
        st.adopt(k, xk_loc, torch.sqrt(sq[0]) / b_norm,
                 torch.sqrt(sq[1]) / xt_norm, breakdown, tol)
    return _finish(s, st, mesh, IMG=IMG)


def ba_gmres_rtp_sharded(
    A_panels: ShardedPanels,
    BT_panels: ShardedPanels | None,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam: float = 1e-3,
    mesh: Mesh | None = None,
    axis: str = "rows",
    B_panels: ShardedPanels | None = None,
) -> GMRESResult:
    """Sharded BA-GMRES (RTP): Krylov on ``B A + lam I``, the plain
    projected Hessenberg solve (``hybrid_ba_gmres_rtp.m:6-35`` at scale).
    Panels, ``B_panels``, ``mesh`` and ``axis`` as in
    ``ba_gmres_sharded_pallas``."""
    return _rtp_core("ba", A_panels, BT_panels, b, x_true, tol, maxit, lam,
                     mesh, axis, B_panels)


def ab_gmres_rtp_sharded(
    A_panels: ShardedPanels,
    BT_panels: ShardedPanels | None,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam: float = 1e-3,
    mesh: Mesh | None = None,
    axis: str = "rows",
    B_panels: ShardedPanels | None = None,
) -> GMRESResult:
    """Sharded AB-GMRES (RTP): Krylov on ``B A + lam I``; the inner
    Tikhonov solve against the original A and b through the image Gram,
    accumulated one fused all_reduce a step (``hybrid_ab_gmres_rtp.m:6-33``
    at scale)."""
    return _rtp_core("ab", A_panels, BT_panels, b, x_true, tol, maxit, lam,
                     mesh, axis, B_panels)
