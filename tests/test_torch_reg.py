"""PyTorch port: the GCV objective on the projected problem against the JAX
package.

Float64 on the CPU, the same seeded numpy Hessenbergs to both packages.
GCV values are compared at rtol 1e-9: both sides go through LAPACK SVDs of
the same matrices, and the objective only uses singular values and squared
projections, which do not depend on the sign or basis an SVD picks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybrid_gmres_tpu.krylov import projected as jproj
from hybrid_gmres_tpu.reg import gcv as jgcv
from hybrid_gmres_tpu_torch.krylov import projected as tproj
from hybrid_gmres_tpu_torch.reg import gcv as tgcv

RTOL = 1e-9
KMAX = 7


def _hessenberg(k, seed=0, kmax=KMAX):
    """A padded (kmax+1, kmax) upper Hessenberg with k set columns, and
    t = beta e1."""
    rng = np.random.default_rng(seed)
    H = np.zeros((kmax + 1, kmax))
    H[:k + 1, :k] = np.triu(rng.standard_normal((k + 1, k)), -1)
    t = np.zeros(kmax + 1)
    t[0] = 1.0 + rng.random()
    return H, t


@pytest.mark.parametrize("kdim", [1, 4, KMAX])
def test_gcv_factors_and_values_match_jax(kdim):
    H, t = _hessenberg(kdim, seed=kdim)
    jf = jgcv.gcv_factors(jnp.asarray(H), jnp.asarray(t), kdim)
    tf = tgcv.gcv_factors(torch.from_numpy(H), torch.from_numpy(t), kdim)
    for got, want, name in zip(tf, jf, ("sb", "g^2", "t_perp_sq", "s_tr")):
        got, want = got.numpy(), np.asarray(want)
        if name == "g^2":      # u_i^T t is defined up to the sign of u_i
            got, want = got[:kdim] ** 2, want[:kdim] ** 2
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-13,
                                   err_msg=name)
    for lam in (1e-6, 1e-2, 3.0):
        for weight in (1.0, 0.7):
            want = float(jgcv.gcv_from_factors(jf, lam, 30, weight))
            np.testing.assert_allclose(
                float(tgcv.gcv_from_factors(tf, lam, 30, weight)), want,
                rtol=RTOL)
            # the SVD-free factors and the direct objective agree
            np.testing.assert_allclose(
                float(tgcv.gcv_from_H(torch.from_numpy(H),
                                      torch.from_numpy(t), lam, 30, kdim,
                                      weight)),
                float(jgcv.gcv_from_H(jnp.asarray(H), jnp.asarray(t), lam,
                                      30, kdim, weight)), rtol=RTOL)


def test_gcv_from_H_data_space_numerator_and_guard_match_jax():
    H, t = _hessenberg(5, seed=9)
    rng = np.random.default_rng(1)
    Rm, rhs = rng.standard_normal((20, KMAX)), rng.standard_normal(20)
    want = float(jgcv.gcv_from_H(jnp.asarray(H), jnp.asarray(t), 1e-3, 30, 5,
                                 R=jnp.asarray(Rm), rhs=jnp.asarray(rhs)))
    got = float(tgcv.gcv_from_H(torch.from_numpy(H), torch.from_numpy(t),
                                1e-3, 30, 5, R=torch.from_numpy(Rm),
                                rhs=torch.from_numpy(rhs)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # a vanishing denominator (trace_dim == trace) maps to 1e20 in both
    I = np.zeros((KMAX + 1, KMAX))
    I[:KMAX, :KMAX] = np.eye(KMAX) * 1e8
    args = (0.0, float(KMAX), KMAX)
    assert float(jgcv.gcv_from_H(jnp.asarray(I), jnp.asarray(t), *args)) == \
        float(tgcv.gcv_from_H(torch.from_numpy(I), torch.from_numpy(t),
                              *args)) == 1e20


def test_batched_gcv_equals_the_loop_and_picks_the_jax_lambda():
    """Leading batch dimensions, tensor kdim and a whole lambda grid in one
    call give what a loop over problems gives, and the grid minimizer is
    the one the JAX solver's ``lam="gcv"`` strategy picks (``vmap`` over
    the grid, then argmin)."""
    kdims = [2, 5, KMAX]
    Hs, ts = zip(*(_hessenberg(k, seed=10 + k) for k in kdims))
    Hb, tb = torch.from_numpy(np.stack(Hs)), torch.from_numpy(np.stack(ts))
    kd = torch.tensor(kdims)
    grid = np.logspace(-8, -1, 50)
    tgrid = torch.from_numpy(grid)
    fb = tgcv.gcv_factors(Hb, tb, kd)
    lam_b = tgcv.gcv_grid_lambda(Hb, tb, kd, tgrid, 30)
    per_lam = tgcv.gcv_from_factors(
        fb, torch.tensor([1e-3, 1e-2, 1e-1], dtype=torch.float64), 30)
    for i, k in enumerate(kdims):
        f1 = tgcv.gcv_factors(Hb[i], tb[i], k)
        for a, b_ in zip(fb, f1):
            np.testing.assert_allclose(a[i].numpy() ** 2, b_.numpy() ** 2,
                                       rtol=RTOL, atol=1e-13)
        np.testing.assert_allclose(
            float(per_lam[i]),
            float(tgcv.gcv_from_factors(f1, [1e-3, 1e-2, 1e-1][i], 30)),
            rtol=RTOL)
        jf = jgcv.gcv_factors(jnp.asarray(Hs[i]), jnp.asarray(ts[i]), k)
        vals = jax.vmap(lambda l: jgcv.gcv_from_factors(jf, l, 30))(
            jnp.asarray(grid))
        assert float(lam_b[i]) == grid[int(jnp.argmin(vals))]
        # the batched projected solves at that per-problem lambda
        np.testing.assert_allclose(
            tproj.projected_tikhonov_solve(Hb, tb, lam_b, kd)[i].numpy(),
            np.asarray(jproj.projected_tikhonov_solve(
                jnp.asarray(Hs[i]), jnp.asarray(ts[i]), float(lam_b[i]), k)),
            rtol=RTOL, atol=1e-14)
        np.testing.assert_allclose(
            tproj.projected_ls_solve(Hb, tb, kd)[i].numpy(),
            np.asarray(jproj.projected_ls_solve(
                jnp.asarray(Hs[i]), jnp.asarray(ts[i]), k)),
            rtol=RTOL, atol=1e-14)


def test_projected_solves_over_k_by_batch():
    """The deferred cores' call: one H per RHS, expanded over every k, with
    kdim of shape (k, 1) and a per-RHS lambda — entry [k, r] is the plain
    solve of problem r at size k+1."""
    Hs, ts = zip(*(_hessenberg(KMAX, seed=20 + r) for r in range(3)))
    Hb, tb = torch.from_numpy(np.stack(Hs)), torch.from_numpy(np.stack(ts))
    ks = torch.arange(1, KMAX + 1)
    lam_r = torch.tensor([1e-3, 1e-2, 0.5], dtype=torch.float64)
    Y = tproj.projected_tikhonov_solve(Hb.expand(KMAX, -1, -1, -1),
                                       tb.expand(KMAX, -1, -1), lam_r,
                                       ks[:, None])
    Yls = tproj.projected_ls_solve(Hb.expand(KMAX, -1, -1, -1),
                                   tb.expand(KMAX, -1, -1), ks[:, None])
    assert Y.shape == Yls.shape == (KMAX, 3, KMAX)
    for k in (1, 3, KMAX):
        for r in range(3):
            np.testing.assert_allclose(
                Y[k - 1, r].numpy(), tproj.projected_tikhonov_solve(
                    Hb[r], tb[r], float(lam_r[r]), k).numpy(), rtol=RTOL,
                atol=1e-14)
            np.testing.assert_allclose(
                Yls[k - 1, r].numpy(),
                tproj.projected_ls_solve(Hb[r], tb[r], k).numpy(), rtol=RTOL,
                atol=1e-14)
            assert not Y[k - 1, r, k:].any()
