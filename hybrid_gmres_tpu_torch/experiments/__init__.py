"""Experiment drivers reproducing the reference's L5 scripts (PyTorch port
of ``hybrid_gmres_tpu/experiments``), with the same constants and seeding,
as importable modules returning structured results (figures optional).
Each ``Config`` has a ``device`` (the card by default; ``"cpu"`` for the
CPU path) and a ``dtype``.

| module                | reference script                      |
|-----------------------|---------------------------------------|
| equivalence           | run_equivalence_plots.m               |
| ptr_rtp               | run_ptr_rtp_comparison.m              |
| regularization        | analyze_regularization.m              |
| gcv_surface_exp       | plot_gcv_surface.m                    |
| error_surface         | plot_error_surface.m                  |
| filter_factors_exp    | plot_filter_factors.m                 |
| perturbation_bounds   | plot_perturbation_bound_validation.m  |
| noise_sweep           | plot_error_vs_noise_level.m           |
| mismatch_sweep        | plot_error_vs_mismatch_norm.m         |
| phantom2d             | run_2D_phantom.m                      |
| phantom2d_gpu         | run_2D_phantom.m, bench scale, on the card |

``phantom2d_gpu`` is the JAX package's ``phantom2d_tpu``.  Run the drivers
from the command line with ``python -m hybrid_gmres_tpu_torch.experiments``
(``__main__.py``).
"""

from hybrid_gmres_tpu_torch.experiments import (
    equivalence,
    ptr_rtp,
    regularization,
    gcv_surface_exp,
    error_surface,
    filter_factors_exp,
    perturbation_bounds,
    noise_sweep,
    mismatch_sweep,
    phantom2d,
    phantom2d_gpu,
)

__all__ = [
    "equivalence",
    "ptr_rtp",
    "regularization",
    "gcv_surface_exp",
    "error_surface",
    "filter_factors_exp",
    "perturbation_bounds",
    "noise_sweep",
    "mismatch_sweep",
    "phantom2d",
    "phantom2d_gpu",
]
