"""Perturbation-bound validation (reference
``plot_perturbation_bound_validation.m``): hybrid AB/BA on shaw with
unperturbed vs perturbed B; actual |Delta phi| vs theoretical |delta phi| at
the final common iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from hybrid_gmres_tpu_torch.analysis import run_with_bounds
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


@dataclass
class Config:
    problem: str = "shaw"        # plot_perturbation_bound_validation.m:4
    n: int = 32
    lam: float = 1e-3            # :6
    tol: float = 1e-6
    perturb_scale: float = 1e-4  # :12
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"


@dataclass
class Results:
    cfg: Config
    actual: Dict[str, np.ndarray]
    bound: Dict[str, np.ndarray]


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    A, b_exact, x_true = generate_test_problem(
        cfg.problem, cfg.n, dtype=torch_dtype(cfg.dtype), device=cfg.device)
    # the reference uses the CLEAN b_exact here (:21-27)
    B_pert, E = perturb_backprojector(A, cfg.perturb_scale, seed=cfg.seed)
    B_unpert = A.T.contiguous()
    A_h, E_h = host(A), host(E)
    D_AB = A_h @ E_h
    D_BA = E_h @ A_h

    actual, bound = {}, {}
    for name, variant, D in (("hybrid_ab", "ab", D_AB),
                             ("hybrid_ba", "ba", D_BA)):
        _, bd_u = run_with_bounds(variant, A, B_unpert, b_exact, x_true,
                                  tol=cfg.tol, maxit=cfg.n, lam=cfg.lam,
                                  DeltaM=D, device=cfg.device)
        _, bd_p = run_with_bounds(variant, A, B_pert, b_exact, x_true,
                                  tol=cfg.tol, maxit=cfg.n, lam=cfg.lam,
                                  DeltaM=None, device=cfg.device)
        k = min(len(bd_u.phi_iter), len(bd_p.phi_iter))
        actual[name] = np.abs(bd_p.phi_iter[k - 1][:k]
                              - bd_u.phi_iter[k - 1][:k])
        bound[name] = np.abs(bd_u.dphi_iter[k - 1][:k])
    return Results(cfg=cfg, actual=actual, bound=bound)


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(9, 7))
    for ax, name in zip(axes, ("hybrid_ab", "hybrid_ba")):
        a, t = res.actual[name], res.bound[name]
        k = len(a)
        ax.semilogy(np.arange(1, k + 1), a, "o-", label="Actual Change |dphi|")
        ax.semilogy(np.arange(1, k + 1), t, "x--",
                    label="Theoretical Bound |dphi|")
        ax.set_title(f"{name} (k={k})")
        ax.set_xlabel("Mode index i")
        ax.set_ylabel("Magnitude")
        ax.grid(True)
        ax.legend()
    fig.suptitle("Validation of Perturbation Bounds at Final Iteration")
    return [save_figure(fig, outdir, "perturbation_bounds.png")]


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
