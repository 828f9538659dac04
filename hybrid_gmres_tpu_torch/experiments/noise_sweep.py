"""Final error vs. data noise level (reference ``plot_error_vs_noise_level.m``).

shaw n=32, 20 noise levels in logspace(-4,-1); per level a fresh noise draw
(the reference seeds once and draws inside the loop, :9,:31), GCV-selected
lambda per level, final errors of all four methods.
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
)
from hybrid_gmres_tpu_torch.problems import (
    generate_test_problem,
    perturb_backprojector,
)
from hybrid_gmres_tpu_torch.reg import gcv_lambda
from hybrid_gmres_tpu_torch.solvers import ab_gmres, ba_gmres


@dataclass
class Config:
    problem: str = "shaw"
    n: int = 32
    perturb_scale: float = 1e-4
    maxit: int = 32
    tol: float = 1e-6
    k_gcv: int = 20
    levels_lo: float = 1e-4      # plot_error_vs_noise_level.m:18
    levels_hi: float = 1e-1
    n_levels: int = 20
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    noise_levels: np.ndarray
    final_errors: Dict[str, np.ndarray]
    gcv_lambdas: Dict[str, np.ndarray]


def final_err(r):
    """The error at the last iteration entered."""
    return float(host(r.err_hist)[int(r.niters) - 1])


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    B, _ = perturb_backprojector(A, cfg.perturb_scale, seed=cfg.seed)
    levels = np.logspace(np.log10(cfg.levels_lo), np.log10(cfg.levels_hi),
                         cfg.n_levels)
    rng = np.random.default_rng(cfg.seed)
    b_norm = float(torch.linalg.vector_norm(b_exact))

    names = ["hybrid_ab", "hybrid_ba", "nonhybrid_ab", "nonhybrid_ba"]
    errors = {k: np.zeros(cfg.n_levels) for k in names}
    lams = {"ab": np.zeros(cfg.n_levels), "ba": np.zeros(cfg.n_levels)}

    for i, level in enumerate(levels):
        e = rng.standard_normal(tuple(b_exact.shape))
        b = b_exact + torch.as_tensor(e / np.linalg.norm(e) * level * b_norm,
                                      dtype=b_exact.dtype,
                                      device=b_exact.device)
        for v, solver in (("ab", ab_gmres), ("ba", ba_gmres)):
            lam, _ = gcv_lambda(v, A, B, b, k_gcv=cfg.k_gcv)
            lams[v][i] = lam
            errors[f"hybrid_{v}"][i] = final_err(
                solver(A, B, b, x_true, tol=cfg.tol, maxit=cfg.maxit,
                       lam=lam))
            errors[f"nonhybrid_{v}"][i] = final_err(
                solver(A, B, b, x_true, tol=cfg.tol, maxit=cfg.maxit))
    return Results(cfg=cfg, noise_levels=levels, final_errors=errors,
                   gcv_lambdas=lams)


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    styles = {"hybrid_ab": "b-o", "hybrid_ba": "r-x",
              "nonhybrid_ab": "b--s", "nonhybrid_ba": "r--d"}
    for name, st in styles.items():
        ax.loglog(res.noise_levels, res.final_errors[name], st, lw=1.8, ms=5,
                  label=name)
    ax.set_xlabel("Relative Noise Level ||e|| / ||b_exact||")
    ax.set_ylabel("Final Relative Error")
    ax.set_title("Final Solution Error vs. Data Noise Level")
    ax.grid(True)
    ax.legend(loc="best")
    return [save_figure(fig, outdir, "error_vs_noise.png")]


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
