"""L-curve + GCV-vs-true-optimal-lambda analysis (reference
``analyze_regularization.m``).

shaw n=32, 1% noise, B = A^T + 1e-4 E; the 100-point lambda sweep (one
solve per lambda, ``reg/lcurve.py``) and the GCV minimization on the
factor-once projected objective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from hybrid_gmres_tpu_torch.experiments.common import (
    get_pyplot,
    host,
    save_figure,
    torch_dtype,
)
from hybrid_gmres_tpu_torch.problems import (
    add_noise,
    generate_test_problem,
    perturb_backprojector,
)
from hybrid_gmres_tpu_torch.reg import gcv_lambda
from hybrid_gmres_tpu_torch.reg.lcurve import LCurveSweep, lcurve_sweep
from hybrid_gmres_tpu_torch.solvers import ab_gmres, ba_gmres


@dataclass
class Config:
    problem: str = "shaw"         # analyze_regularization.m:4
    n: int = 32
    noise_level: float = 1e-2     # :8
    perturb_scale: float = 1e-4   # :12
    maxit: int = 32               # :17
    tol: float = 1e-6
    lam_lo: float = 1e-10         # :19 logspace(-10, 0, 100)
    lam_hi: float = 1.0
    n_lambda: int = 100
    k_gcv: int = 20               # :35
    gcv_lo: float = 1e-9          # :40
    gcv_hi: float = 1e-1
    # "projected" = reference parity (gcv_function.m:38). For BA the
    # projected numerator vanishes as lam->0 and fminbnd parks at gcv_lo
    # (a bias the reference shares); "original" restores an interior
    # minimum.
    gcv_residual_space: str = "projected"
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    sweeps: Dict[str, LCurveSweep]    # tensors on cfg.device
    gcv_lambdas: Dict[str, float]
    solutions: Dict[str, np.ndarray]
    x_true: np.ndarray


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    B, _ = perturb_backprojector(A, cfg.perturb_scale, seed=cfg.seed)

    lam_grid = np.logspace(
        np.log10(cfg.lam_lo), np.log10(cfg.lam_hi), cfg.n_lambda
    )
    sweeps = {
        v: lcurve_sweep(v, A, B, b, x_true, lam_grid, tol=cfg.tol,
                        maxit=cfg.maxit)
        for v in ("ab", "ba")
    }
    gcv_lambdas = {
        v: gcv_lambda(v, A, B, b, k_gcv=cfg.k_gcv, lo=cfg.gcv_lo,
                      hi=cfg.gcv_hi,
                      residual_space=cfg.gcv_residual_space)[0]
        for v in ("ab", "ba")
    }
    solvers = {"ab": ab_gmres, "ba": ba_gmres}
    solutions = {}
    for v in ("ab", "ba"):
        r = solvers[v](A, B, b, x_true, tol=cfg.tol, maxit=cfg.maxit,
                       lam=gcv_lambdas[v])
        solutions[f"hybrid_{v}"] = host(r.x)
        r_nh = solvers[v](A, B, b, x_true, tol=cfg.tol, maxit=cfg.maxit)
        solutions[f"nonhybrid_{v}"] = host(r_nh.x)
    return Results(cfg=cfg, sweeps=sweeps, gcv_lambdas=gcv_lambdas,
                   solutions=solutions, x_true=host(x_true))


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    paths = []
    for v in ("ab", "ba"):
        s = LCurveSweep(*(host(f) for f in res.sweeps[v]))
        lam_gcv = res.gcv_lambdas[v]
        grid = s.lam_grid
        idx_gcv = int(np.argmin(np.abs(grid - lam_gcv)))
        idx_opt = int(np.argmin(s.err_norms))
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
        ax1.loglog(s.res_norms, s.sol_norms, "-o", ms=3, label="L-Curve")
        ax1.plot(s.res_norms[idx_gcv], s.sol_norms[idx_gcv], "r*", ms=12,
                 label="GCV Optimal")
        ax1.plot(s.res_norms[idx_opt], s.sol_norms[idx_opt], "gp", ms=12,
                 label="True Optimal")
        ax1.set_xlabel("Relative Residual Norm")
        ax1.set_ylabel("Solution Norm")
        ax1.set_title(f"L-Curve (Hybrid {v.upper()}-GMRES)")
        ax1.grid(True)
        ax1.legend()
        ax2.loglog(grid, s.err_norms, "-o", ms=3, label="Error Curve")
        ax2.plot(lam_gcv, s.err_norms[idx_gcv], "r*", ms=12,
                 label="GCV Optimal")
        ax2.plot(grid[idx_opt], s.err_norms[idx_opt], "gp", ms=12,
                 label="True Optimal")
        ax2.set_xlabel("lambda")
        ax2.set_ylabel("Relative Error")
        ax2.set_title(f"Error vs. Lambda (Hybrid {v.upper()}-GMRES)")
        ax2.grid(True)
        ax2.legend()
        paths.append(save_figure(fig, outdir, f"regularization_{v}.png"))

    fig, ax = plt.subplots(figsize=(8, 5))
    n = res.cfg.n
    ax.plot(np.arange(1, n + 1), res.x_true, "k-", lw=3,
            label="True Solution")
    for name, sol in res.solutions.items():
        ax.plot(np.arange(1, n + 1), sol, lw=2, label=name)
    ax.set_title("Comparison of Final Solutions from All Methods")
    ax.grid(True)
    ax.legend(loc="best", fontsize=8)
    paths.append(save_figure(fig, outdir, "regularization_solutions.png"))
    return paths


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    print(f" Hybrid AB -> GCV Optimal: {res.gcv_lambdas['ab']:.4e}, "
          f"True Optimal: {float(res.sweeps['ab'].lam_true_opt):.4e}")
    print(f" Hybrid BA -> GCV Optimal: {res.gcv_lambdas['ba']:.4e}, "
          f"True Optimal: {float(res.sweeps['ba'].lam_true_opt):.4e}")
    return res, figures(res, outdir)
