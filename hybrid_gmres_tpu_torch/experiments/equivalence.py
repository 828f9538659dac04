"""Equivalence validation experiment (reference ``run_equivalence_plots.m``).

With ``B = A^T`` on deriv2 n=32, 1% noise (seeded), maxit=n, lam=1e-3:
BA-GMRES == LSMR, AB-GMRES == LSQR, hybrid BA == hybrid LSMR (textbook
rank-1 term), hybrid AB != hybrid LSQR.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

from hybrid_gmres_tpu_torch.experiments.common import (
    get_pyplot,
    host,
    save_figure,
    torch_dtype,
    trim,
)
from hybrid_gmres_tpu_torch.problems import add_noise, generate_test_problem
from hybrid_gmres_tpu_torch.solvers import (
    ab_gmres,
    ba_gmres,
    hybrid_lsmr,
    hybrid_lsqr,
    lsmr,
    lsqr,
)


@dataclass
class Config:
    problem: str = "deriv2"      # run_equivalence_plots.m:4
    n: int = 32
    noise_level: float = 1e-2    # :8
    tol: float = 1e-6            # :10
    lam: float = 1e-3            # :11
    seed: int = 0                # rng(0) at :6
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    x_true: np.ndarray
    solutions: Dict[str, np.ndarray] = field(default_factory=dict)
    err_hists: Dict[str, np.ndarray] = field(default_factory=dict)


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    B = A.T
    maxit = cfg.n

    runs: Dict[str, Any] = {
        "ba_gmres": ba_gmres(A, B, b, x_true, cfg.tol, maxit),
        "lsmr": lsmr(A, b, x_true, cfg.tol, maxit),
        "ab_gmres": ab_gmres(A, B, b, x_true, cfg.tol, maxit),
        "lsqr": lsqr(A, b, x_true, cfg.tol, maxit),
        "hybrid_ba": ba_gmres(A, B, b, x_true, cfg.tol, maxit, lam=cfg.lam),
        "hybrid_lsmr": hybrid_lsmr(A, b, x_true, cfg.tol, maxit,
                                   lam=cfg.lam),
        "hybrid_ab": ab_gmres(A, B, b, x_true, cfg.tol, maxit, lam=cfg.lam),
        "hybrid_lsqr": hybrid_lsqr(A, b, x_true, cfg.tol, maxit,
                                   lam=cfg.lam),
    }
    out = Results(cfg=cfg, x_true=host(x_true))
    for k, r in runs.items():
        out.solutions[k] = host(r.x)
        out.err_hists[k] = trim(r.err_hist, r.niters)
    return out


_PAIRS = [
    ("ba_gmres", "lsmr", "BA-GMRES vs. LSMR (==)"),
    ("ab_gmres", "lsqr", "AB-GMRES vs. LSQR (==)"),
    ("hybrid_ba", "hybrid_lsmr", "Hybrid BA-GMRES vs. Hybrid LSMR (==)"),
    ("hybrid_ab", "hybrid_lsqr", "Hybrid AB-GMRES vs. Hybrid LSQR (!=)"),
]


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    n = res.cfg.n
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    for ax, (a, b_, title) in zip(axes.ravel(), _PAIRS):
        ax.plot(np.arange(1, n + 1), res.x_true, "k-", lw=2.5,
                label="True Solution")
        ax.plot(np.arange(1, n + 1), res.solutions[a], "b-", lw=1.5, label=a)
        ax.plot(np.arange(1, n + 1), res.solutions[b_], "r--", lw=1.5,
                label=b_)
        ax.set_title(title)
        ax.grid(True)
        ax.legend(loc="best", fontsize=8)
    fig.suptitle("Equivalence Validation (Final Solution)")
    return [save_figure(fig, outdir, "equivalence_solutions.png")]


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
