from hybrid_gmres_tpu_torch.krylov.arnoldi import (
    ArnoldiState,
    arnoldi,
    arnoldi_orthogonalize,
    arnoldi_step,
)
from hybrid_gmres_tpu_torch.krylov.projected import (
    projected_gram_tikhonov_solve,
    projected_ls_solve,
    projected_tikhonov_solve,
)

__all__ = [
    "ArnoldiState",
    "arnoldi",
    "arnoldi_orthogonalize",
    "arnoldi_step",
    "projected_gram_tikhonov_solve",
    "projected_ls_solve",
    "projected_tikhonov_solve",
]
