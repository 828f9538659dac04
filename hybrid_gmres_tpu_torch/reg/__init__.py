from hybrid_gmres_tpu_torch.reg.gcv import (
    gcv_factors,
    gcv_from_factors,
    gcv_from_H,
)

__all__ = ["gcv_factors", "gcv_from_factors", "gcv_from_H"]
