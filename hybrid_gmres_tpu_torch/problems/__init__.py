from hybrid_gmres_tpu_torch.problems.ct import (
    CTProblem,
    FanBeamGeometry,
    ct_gpu_operators,
    ct_mismatched,
    shepp_logan,
)

__all__ = [
    "CTProblem",
    "FanBeamGeometry",
    "ct_gpu_operators",
    "ct_mismatched",
    "shepp_logan",
]
