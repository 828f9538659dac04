from hybrid_gmres_tpu_torch.reg.gcv import (
    gcv_curve,
    gcv_factors,
    gcv_from_factors,
    gcv_from_H,
    gcv_lambda,
    gcv_surface,
    minimize_scalar_bounded,
)
from hybrid_gmres_tpu_torch.reg.discrepancy import discrepancy_lambda
from hybrid_gmres_tpu_torch.reg.lcurve import lcurve_sweep

__all__ = [
    "gcv_from_H",
    "gcv_factors",
    "gcv_from_factors",
    "gcv_curve",
    "gcv_surface",
    "gcv_lambda",
    "minimize_scalar_bounded",
    "discrepancy_lambda",
    "lcurve_sweep",
]
