"""error(k, lambda) surfaces + global optimum (reference ``plot_error_surface.m``).

deriv2 n=32, lambda in logspace(-8,-1,100), k=1..n.  The reference re-runs
the full solver per lambda (``plot_error_surface.m:28-42``), and so does
this port: one solve per lambda on the device, whose error history is the
k-axis of that row of the surface.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

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
from hybrid_gmres_tpu_torch.solvers import ab_gmres, ba_gmres


@dataclass
class Config:
    problem: str = "deriv2"      # plot_error_surface.m:6
    n: int = 32
    noise_level: float = 1e-2
    perturb_scale: float = 1e-4
    lam_lo: float = 1e-8         # :22
    lam_hi: float = 1e-1
    n_lambda: int = 100
    tol: float = 1e-10           # :31 (effectively no early exit)
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    lam_grid: np.ndarray
    surfaces: Dict[str, np.ndarray]              # (n_lambda, n)
    optima: Dict[str, Tuple[int, float, float]]  # (k*, lambda*, err*)


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    B, _ = perturb_backprojector(A, cfg.perturb_scale, seed=cfg.seed)
    lam_grid = np.logspace(np.log10(cfg.lam_lo), np.log10(cfg.lam_hi),
                           cfg.n_lambda)
    solvers = {"ab": ab_gmres, "ba": ba_gmres}
    surfaces, optima = {}, {}
    for v, solver in solvers.items():
        # the rows stay on the device until the whole surface is queued
        rows = [solver(A, B, b, x_true, tol=cfg.tol, maxit=cfg.n,
                       lam=float(lam)).err_hist for lam in lam_grid]
        surf = host(torch.stack(rows))
        surfaces[v] = surf
        flat = np.nanargmin(surf)
        i, j = np.unravel_index(flat, surf.shape)
        optima[v] = (int(j + 1), float(lam_grid[i]), float(surf[i, j]))
    return Results(cfg=cfg, lam_grid=lam_grid, surfaces=surfaces,
                   optima=optima)


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    paths = []
    ks = np.arange(1, res.cfg.n + 1)
    for v in ("ab", "ba"):
        k_opt, lam_opt, err_opt = res.optima[v]
        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.pcolormesh(ks, res.lam_grid, np.log10(res.surfaces[v]),
                           shading="auto")
        ax.plot(k_opt, lam_opt, "r*", ms=15, label="Optimal Point")
        ax.set_yscale("log")
        fig.colorbar(im, ax=ax, label="log10(Relative Error)")
        ax.set_xlabel("Iteration Count (k)")
        ax.set_ylabel("lambda")
        ax.set_title(f"Error Surface for Hybrid {v.upper()}-GMRES")
        ax.legend()
        paths.append(save_figure(fig, outdir, f"error_surface_{v}.png"))
    return paths


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    for v in ("ab", "ba"):
        k, lam, err = res.optima[v]
        print(f" Optimal Point ({v.upper()}): k={k}, lambda={lam:.2e}, "
              f"Error={err:.4f}")
    return res, figures(res, outdir)
