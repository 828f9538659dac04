from hybrid_gmres_tpu_torch.problems.ct import (
    CTProblem,
    FanBeamGeometry,
    ct_gpu_operators,
    ct_mismatched,
    shepp_logan,
)
from hybrid_gmres_tpu_torch.problems.onedim import (
    deriv2,
    generate_test_problem,
    heat,
    shaw,
)
from hybrid_gmres_tpu_torch.problems.noise import (
    add_noise,
    perturb_backprojector,
)

__all__ = [
    "add_noise",
    "perturb_backprojector",
    "CTProblem",
    "FanBeamGeometry",
    "ct_gpu_operators",
    "ct_mismatched",
    "shepp_logan",
    "deriv2",
    "generate_test_problem",
    "heat",
    "shaw",
]
