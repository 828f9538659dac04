"""2-D fan-beam CT phantom experiment (reference ``run_2D_phantom.m``).

n=32 image (1024 px), 90 angles x 90 detectors, mismatched (A, B), 25% noise,
maxit=80, lam=1e-2, on dense operators.  Method set mirrors the reference's
helpers:
  * non-hybrid AB/BA-GMRES (the reference drives MATLAB's built-in ``gmres``
    on the composed operator, run_2D_phantom.m:117-147 — here the native
    AB/BA solvers, which are the same iteration);
  * "hybrid" AB/BA = LSQR on the Tikhonov-augmented composed operator
    ``[M; sqrt(lam) I]`` (run_2D_phantom.m:150-175) — exact Tikhonov in the
    composed space, kept matrix-free via ProductOperator instead of the
    reference's dense m x m product.
Also reproduces the mismatch-robustness sweep (10 levels in logspace(-4,0),
run_2D_phantom.m:79-103).  Unlike the reference — which re-runs the builtin
solver from scratch for every k to get an error history (O(maxit^2),
run_2D_phantom.m:126-132) — the solvers emit per-iteration histories natively.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from hybrid_gmres_tpu_torch.experiments.common import (
    get_pyplot,
    host,
    save_figure,
    torch_dtype,
    trim,
)
from hybrid_gmres_tpu_torch.ops.linear_operator import (
    DenseOperator,
    ProductOperator,
)
from hybrid_gmres_tpu_torch.problems.ct import CTProblem, ct_mismatched
from hybrid_gmres_tpu_torch.solvers import ab_gmres, ba_gmres, hybrid_lsqr
from hybrid_gmres_tpu_torch.utils.device import require_device


@dataclass
class Config:
    n: int = 32                  # run_2D_phantom.m:5
    noise_level: float = 0.25    # :6
    maxit: int = 80              # :7
    lam: float = 1e-2            # :8
    tol: float = 1e-6            # :9
    n_angles: int = 90           # :22-23
    n_det: int = 90
    n_mismatch_levels: int = 10  # :79 logspace(-4, 0, 10)
    mismatch_lo: float = 1e-4
    mismatch_hi: float = 1.0
    seed: int = 0
    run_mismatch_sweep: bool = True
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    prob: CTProblem
    b_noise: np.ndarray
    reconstructions: Dict[str, np.ndarray]
    err_hists: Dict[str, np.ndarray]
    mismatch_levels: np.ndarray | None = None
    mismatch_errors: Dict[str, np.ndarray] | None = None


def _methods(A, B, b, x_true, cfg: Config):
    """The four reference methods on an (A, B) pair; returns name -> result."""
    A_op, B_op = DenseOperator(A), DenseOperator(B)
    out = {}
    out["nonhybrid_ab"] = ab_gmres(A, B, b, x_true, cfg.tol, cfg.maxit)
    out["nonhybrid_ba"] = ba_gmres(A, B, b, x_true, cfg.tol, cfg.maxit)
    # hybrid AB: exact Tikhonov on M = A B via augmented LSQR; x = B z, with
    # the error history tracked in x-space through error_map
    M_ab = ProductOperator(A_op, B_op)
    r = hybrid_lsqr(M_ab, b, x_true, cfg.tol, cfg.maxit, lam=cfg.lam,
                    error_map=B_op.matvec)
    out["hybrid_ab"] = (r, B_op.matvec(r.x))
    # hybrid BA: exact Tikhonov on M = B A with d = B b
    M_ba = ProductOperator(B_op, A_op)
    d = B_op.matvec(b)
    r2 = hybrid_lsqr(M_ba, d, x_true, cfg.tol, cfg.maxit, lam=cfg.lam)
    out["hybrid_ba"] = r2
    return out


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    dev = require_device(cfg.device)
    like = dict(dtype=torch_dtype(cfg.dtype), device=dev)
    prob = ct_mismatched(n=cfg.n, n_angles=cfg.n_angles, n_det=cfg.n_det)
    A = torch.as_tensor(prob.A_csr.toarray(), **like)
    B = torch.as_tensor(prob.B_csr.toarray(), **like)
    b_exact = torch.as_tensor(prob.b_exact, **like)
    x_true = torch.as_tensor(prob.x_true, **like)
    rng = np.random.default_rng(cfg.seed)
    e = rng.standard_normal(prob.b_exact.shape)
    e = e / np.linalg.norm(e) * cfg.noise_level * float(
        torch.linalg.vector_norm(b_exact))
    b = b_exact + torch.as_tensor(e, **like)

    ms = _methods(A, B, b, x_true, cfg)
    recon, errs = {}, {}
    for name, r in ms.items():
        if name == "hybrid_ab":
            res, x_ab = r
            recon[name] = host(x_ab)
            errs[name] = trim(res.err_hist, res.niters)
        else:
            recon[name] = host(r.x)
            errs[name] = trim(r.err_hist, r.niters)

    out = Results(cfg=cfg, prob=prob, b_noise=host(b),
                  reconstructions=recon, err_hists=errs)

    if cfg.run_mismatch_sweep:
        levels = np.logspace(np.log10(cfg.mismatch_lo),
                             np.log10(cfg.mismatch_hi),
                             cfg.n_mismatch_levels)
        A_np = host(A)
        sweep = {k: np.zeros(len(levels)) for k in
                 ("nonhybrid_ab", "nonhybrid_ba", "hybrid_ab", "hybrid_ba")}
        for i, lvl in enumerate(levels):
            E = rng.standard_normal(A_np.T.shape)
            E = E / np.linalg.norm(E, "fro") * lvl
            B_pert = torch.as_tensor(A_np.T + E, **like)
            ms_i = _methods(A, B_pert, b, x_true, cfg)
            for name, r in ms_i.items():
                if name == "hybrid_ab":
                    r = r[0]
                h = trim(r.err_hist, r.niters)
                sweep[name][i] = h[-1] if len(h) else np.nan
        out.mismatch_levels = levels
        out.mismatch_errors = sweep
    return out


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    cfg = res.cfg
    paths = []

    # sinograms
    sino_exact = np.asarray(res.prob.b_exact).reshape(cfg.n_angles,
                                                      cfg.n_det).T
    sino_noisy = res.b_noise.reshape(cfg.n_angles, cfg.n_det).T
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for ax, s, title in ((ax1, sino_exact, "a) Clean Sinogram"),
                         (ax2, sino_noisy,
                          f"b) Noisy Sinogram "
                          f"({cfg.noise_level*100:.0f}% noise)")):
        im = ax.imshow(s, cmap="gray", aspect="auto", origin="lower")
        ax.set_xlabel("Projection Index (k)")
        ax.set_ylabel("Detector Element")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.suptitle("Sinogram of the Shepp-Logan Phantom")
    paths.append(save_figure(fig, outdir, "phantom_sinograms.png"))

    # reconstructions
    fig, axes = plt.subplots(2, 2, figsize=(9, 9))
    titles = {"nonhybrid_ab": "a) Non-Hybrid AB-GMRES",
              "nonhybrid_ba": "b) Non-Hybrid BA-GMRES",
              "hybrid_ab": "c) Hybrid AB-GMRES",
              "hybrid_ba": "d) Hybrid BA-GMRES"}
    for ax, name in zip(axes.ravel(), titles):
        ax.imshow(res.reconstructions[name].reshape(cfg.n, cfg.n),
                  cmap="gray")
        ax.set_title(titles[name])
        ax.axis("off")
    fig.suptitle("Comparison of 2D Reconstruction Methods")
    paths.append(save_figure(fig, outdir, "phantom_reconstructions.png"))

    # semi-convergence
    fig, ax = plt.subplots(figsize=(8, 5))
    styles = {"nonhybrid_ab": "--", "nonhybrid_ba": ":", "hybrid_ab": "-",
              "hybrid_ba": "-."}
    for name, st in styles.items():
        e = res.err_hists[name]
        ax.semilogy(np.arange(1, len(e) + 1), e, st, lw=2, label=name)
    ax.set_title("Semi-Convergence Behavior of GMRES Variants")
    ax.set_xlabel("Iteration (k)")
    ax.set_ylabel("Relative Error")
    ax.grid(True)
    ax.legend(loc="best")
    paths.append(save_figure(fig, outdir, "phantom_semiconvergence.png"))

    # robustness to mismatch
    if res.mismatch_errors is not None:
        fig, ax = plt.subplots(figsize=(8, 6))
        styles = {"nonhybrid_ab": "--o", "nonhybrid_ba": ":s",
                  "hybrid_ab": "-o", "hybrid_ba": "-s"}
        for name, st in styles.items():
            ax.loglog(res.mismatch_levels, res.mismatch_errors[name], st,
                      lw=2, ms=5, label=name)
        ax.set_xlabel("Mismatch Norm ||B - A^T||_F")
        ax.set_ylabel("Final Relative Error")
        ax.set_title("Final Error vs. Back-Projector Mismatch")
        ax.grid(True)
        ax.legend(loc="best")
        paths.append(save_figure(fig, outdir,
                                 "phantom_mismatch_robustness.png"))
    return paths


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
