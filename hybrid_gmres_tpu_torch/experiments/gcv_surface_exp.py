"""GCV(k, lambda) surfaces + per-k optimal-lambda paths (reference
``plot_gcv_surface.m``): shaw n=32, lambda in logspace(-8,-1,100), k=1..n.
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
from hybrid_gmres_tpu_torch.reg import gcv_surface


@dataclass
class Config:
    problem: str = "shaw"        # plot_gcv_surface.m:6
    n: int = 32
    noise_level: float = 1e-2    # :11
    perturb_scale: float = 1e-4  # :15
    lam_lo: float = 1e-8         # :17
    lam_hi: float = 1e-1
    n_lambda: int = 100
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    lam_grid: np.ndarray
    surfaces: Dict[str, np.ndarray]   # (n_lambda, n_k)
    paths: Dict[str, np.ndarray]      # per-k argmin lambda


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, _ = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    B, _ = perturb_backprojector(A, cfg.perturb_scale, seed=cfg.seed)
    lam_grid = np.logspace(np.log10(cfg.lam_lo), np.log10(cfg.lam_hi),
                           cfg.n_lambda)
    surfaces, paths = {}, {}
    for v in ("ab", "ba"):
        s, p = gcv_surface(v, A, B, b, range(1, cfg.n + 1), lam_grid)
        surfaces[v] = host(s)
        paths[v] = host(p)
    return Results(cfg=cfg, lam_grid=lam_grid, surfaces=surfaces, paths=paths)


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    paths = []
    ks = np.arange(1, res.cfg.n + 1)
    for v in ("ab", "ba"):
        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.pcolormesh(ks, res.lam_grid, np.log10(res.surfaces[v]),
                           shading="auto")
        ax.plot(ks, res.paths[v], "r-p", lw=2, ms=5,
                label="GCV Optimal lambda_k")
        ax.set_yscale("log")
        fig.colorbar(im, ax=ax, label="log10(GCV Value)")
        ax.set_xlabel("Iteration Count (k)")
        ax.set_ylabel("lambda")
        ax.set_title(f"GCV Surface for Hybrid {v.upper()}-GMRES")
        ax.legend()
        paths.append(save_figure(fig, outdir, f"gcv_surface_{v}.png"))
    return paths


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
