"""Theoretical vs. empirical filter factors + convergence histories
(reference ``plot_filter_factors.m``): shaw n=32, noise 1e-3,
B = A^T + 1e-4 E, all four GMRES variants.  The solves run on the device;
the filter-factor analysis on the host (``analysis/filter_factors.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from hybrid_gmres_tpu_torch.analysis import (
    empirical_filter_factors,
    run_with_bounds,
)
from hybrid_gmres_tpu_torch.experiments.common import (
    get_pyplot,
    host,
    save_figure,
    torch_dtype,
    trim,
)
from hybrid_gmres_tpu_torch.problems import (
    add_noise,
    generate_test_problem,
    perturb_backprojector,
)


@dataclass
class Config:
    problem: str = "shaw"        # plot_filter_factors.m:3
    n: int = 32
    noise_level: float = 1e-3    # :7
    perturb_scale: float = 1e-4  # :16
    tol: float = 1e-6
    lam: float = 1e-3            # :13
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    phi_theory: Dict[str, np.ndarray]
    phi_empirical: Dict[str, np.ndarray]
    err_hists: Dict[str, np.ndarray]
    res_hists: Dict[str, np.ndarray]


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    B, E = perturb_backprojector(A, cfg.perturb_scale, seed=cfg.seed)
    A_h, E_h, b_h = host(A), host(E), host(b)
    D_AB = A_h @ E_h
    D_BA = E_h @ A_h

    jobs = {
        "ab": ("ab", None, D_AB),
        "ba": ("ba", None, D_BA),
        "hybrid_ab": ("ab", cfg.lam, D_AB),
        "hybrid_ba": ("ba", cfg.lam, D_BA),
    }
    phi_t, phi_e, errs, ress = {}, {}, {}, {}
    for name, (variant, lam, D) in jobs.items():
        res, bounds = run_with_bounds(variant, A, B, b, x_true, tol=cfg.tol,
                                      maxit=cfg.n, lam=lam, DeltaM=D,
                                      device=cfg.device)
        phi_t[name] = np.real(bounds.phi_final)
        phi_e[name] = empirical_filter_factors(A_h, b_h, host(res.x))
        errs[name] = trim(res.err_hist, res.niters)
        ress[name] = trim(res.res_hist, res.niters)
    return Results(cfg=cfg, phi_theory=phi_t, phi_empirical=phi_e,
                   err_hists=errs, res_hists=ress)


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    paths = []
    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    titles = {"ab": "AB-GMRES (non-hybrid)", "ba": "BA-GMRES (non-hybrid)",
              "hybrid_ab": "AB-GMRES (hybrid)",
              "hybrid_ba": "BA-GMRES (hybrid)"}
    for ax, name in zip(axes.ravel(), titles):
        th, em = res.phi_theory[name], res.phi_empirical[name]
        k = min(len(th), len(em))
        ax.plot(np.arange(1, k + 1), th[:k], "--", lw=1.6,
                label="Theoretical")
        ax.plot(np.arange(1, k + 1), em[:k], "o-", ms=4, label="Empirical")
        ax.set_title(titles[name])
        ax.set_xlabel("Mode index i")
        ax.set_ylabel("Filter factor phi_i")
        ax.grid(True)
        ax.legend(fontsize=8)
    fig.suptitle("Final Filter Factor Comparison")
    paths.append(save_figure(fig, outdir, "filter_factors.png"))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for name in titles:
        e = res.err_hists[name]
        ax1.semilogy(np.arange(1, len(e) + 1), e, lw=1.8, label=name)
        r = res.res_hists[name]
        ax2.semilogy(np.arange(1, len(r) + 1), r, lw=1.8, label=name)
    ax1.set_title("Relative Error vs. Iteration")
    ax2.set_title("Relative Residual vs. Iteration")
    for ax in (ax1, ax2):
        ax.set_xlabel("Iteration k")
        ax.grid(True)
        ax.legend(fontsize=8)
    paths.append(save_figure(fig, outdir, "filter_factors_convergence.png"))
    return paths


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
