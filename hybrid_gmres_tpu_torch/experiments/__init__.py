"""Experiment drivers reproducing the reference's L5 scripts (PyTorch port
of ``hybrid_gmres_tpu/experiments``), with the same constants and seeding,
as importable modules returning structured results (figures optional).
Each ``Config`` has a ``device`` (the card by default; ``"cpu"`` for the
CPU path) and a ``dtype``.

| module                | reference script                      |
|-----------------------|---------------------------------------|
| ptr_rtp               | run_ptr_rtp_comparison.m              |
| regularization        | analyze_regularization.m              |
| gcv_surface_exp       | plot_gcv_surface.m                    |
"""

from hybrid_gmres_tpu_torch.experiments import (
    gcv_surface_exp,
    ptr_rtp,
    regularization,
)

__all__ = ["ptr_rtp", "regularization", "gcv_surface_exp"]
