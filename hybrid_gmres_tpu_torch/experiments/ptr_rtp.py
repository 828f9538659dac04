"""PTR-vs-RTP inequivalence experiment (reference ``run_ptr_rtp_comparison.m``).

deriv2 n=32, B = A^T, 1% noise, lam=1e-3: the project-then-regularize and
regularize-then-project hybrid variants produce different error curves.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from hybrid_gmres_tpu_torch.experiments.common import (
    get_pyplot,
    save_figure,
    torch_dtype,
    trim,
)
from hybrid_gmres_tpu_torch.problems import add_noise, generate_test_problem
from hybrid_gmres_tpu_torch.solvers import (
    ab_gmres,
    ab_gmres_rtp,
    ba_gmres,
    ba_gmres_rtp,
)


@dataclass
class Config:
    problem: str = "deriv2"   # run_ptr_rtp_comparison.m:5
    n: int = 32
    noise_level: float = 1e-2
    tol: float = 1e-6
    lam: float = 1e-3         # :13
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    err_hists: Dict[str, np.ndarray] = field(default_factory=dict)


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    b, _ = add_noise(b_exact, cfg.noise_level, seed=cfg.seed)
    B = A.T
    maxit = cfg.n

    runs = {
        "ba_ptr": ba_gmres(A, B, b, x_true, cfg.tol, maxit, lam=cfg.lam),
        "ba_rtp": ba_gmres_rtp(A, B, b, x_true, cfg.tol, maxit, lam=cfg.lam),
        "ab_ptr": ab_gmres(A, B, b, x_true, cfg.tol, maxit, lam=cfg.lam),
        "ab_rtp": ab_gmres_rtp(A, B, b, x_true, cfg.tol, maxit, lam=cfg.lam),
    }
    out = Results(cfg=cfg)
    for k, r in runs.items():
        out.err_hists[k] = trim(r.err_hist, r.niters)
    return out


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    for ax, (p, r, title) in zip(
        axes,
        [("ba_ptr", "ba_rtp", "BA-GMRES: PTR vs. RTP (!=)"),
         ("ab_ptr", "ab_rtp", "AB-GMRES: PTR vs. RTP (!=)")],
    ):
        e1, e2 = res.err_hists[p], res.err_hists[r]
        ax.semilogy(np.arange(1, len(e1) + 1), e1, "b-", lw=2, label=p)
        ax.semilogy(np.arange(1, len(e2) + 1), e2, "m-.", lw=2, label=r)
        ax.set_title(title)
        ax.set_xlabel("Iteration k")
        ax.set_ylabel("Relative Error")
        ax.grid(True)
        ax.legend(loc="best")
    fig.suptitle("Validation of PTR != RTP Inequivalence")
    return [save_figure(fig, outdir, "ptr_rtp.png")]


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
