"""Final error vs. back-projector mismatch norm (reference
``plot_error_vs_mismatch_norm.m``): heat n=32, B = A^T + c E with unit-Frobenius
E and 20 scales c in logspace(-8,-1); GCV lambda per scale.
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
from hybrid_gmres_tpu_torch.experiments.noise_sweep import final_err
from hybrid_gmres_tpu_torch.problems import add_noise, generate_test_problem
from hybrid_gmres_tpu_torch.reg import gcv_lambda
from hybrid_gmres_tpu_torch.solvers import ab_gmres, ba_gmres


@dataclass
class Config:
    problem: str = "heat"        # plot_error_vs_mismatch_norm.m:7
    n: int = 32
    noise_level: float = 1e-2    # :11
    maxit: int = 32
    tol: float = 1e-6
    k_gcv: int = 20
    c_lo: float = 1e-8           # :23
    c_hi: float = 1e-1
    n_scales: int = 20
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    mismatch_norms: np.ndarray
    final_errors: Dict[str, np.ndarray]
    gcv_lambdas: Dict[str, np.ndarray]


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    A_np = host(A)
    E = rng.standard_normal(A_np.T.shape)
    E = E / np.linalg.norm(E, "fro")

    scales = np.logspace(np.log10(cfg.c_lo), np.log10(cfg.c_hi),
                         cfg.n_scales)
    errors = {"hybrid_ab": np.zeros(cfg.n_scales),
              "hybrid_ba": np.zeros(cfg.n_scales)}
    lams = {"ab": np.zeros(cfg.n_scales), "ba": np.zeros(cfg.n_scales)}
    norms = np.zeros(cfg.n_scales)

    for i, c in enumerate(scales):
        P = c * E
        B = torch.as_tensor(A_np.T + P, dtype=A.dtype, device=A.device)
        norms[i] = np.linalg.norm(P, "fro")
        for v, solver in (("ab", ab_gmres), ("ba", ba_gmres)):
            lam, _ = gcv_lambda(v, A, B, b, k_gcv=cfg.k_gcv)
            lams[v][i] = lam
            errors[f"hybrid_{v}"][i] = final_err(
                solver(A, B, b, x_true, tol=cfg.tol, maxit=cfg.maxit,
                       lam=lam))
    return Results(cfg=cfg, mismatch_norms=norms, final_errors=errors,
                   gcv_lambdas=lams)


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.loglog(res.mismatch_norms, res.final_errors["hybrid_ab"], "b-o", lw=2,
              ms=5, label="Hybrid AB-GMRES")
    ax.loglog(res.mismatch_norms, res.final_errors["hybrid_ba"], "r-x", lw=2,
              ms=5, label="Hybrid BA-GMRES")
    ax.set_xlabel("Mismatch Norm ||B - A^T||_F")
    ax.set_ylabel("Final Relative Error")
    ax.set_title("Final Solution Error vs. Back-Projector Mismatch Norm")
    ax.grid(True)
    ax.legend(loc="best")
    return [save_figure(fig, outdir, "error_vs_mismatch.png")]


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
