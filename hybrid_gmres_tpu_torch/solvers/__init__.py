from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres
from hybrid_gmres_tpu_torch.solvers.batched import (
    ab_gmres_batched,
    ba_gmres_batched,
)

__all__ = ["GMRESResult", "ab_gmres", "ab_gmres_batched", "ba_gmres",
           "ba_gmres_batched"]
