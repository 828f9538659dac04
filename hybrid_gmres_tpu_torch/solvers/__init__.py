from hybrid_gmres_tpu_torch.solvers.common import (
    GKBResult,
    GKBState,
    GMRESResult,
)
from hybrid_gmres_tpu_torch.solvers.gmres import (
    ab_gmres,
    ab_gmres_restarted,
    ba_gmres,
    ba_gmres_restarted,
)
from hybrid_gmres_tpu_torch.solvers.rtp import ab_gmres_rtp, ba_gmres_rtp
from hybrid_gmres_tpu_torch.solvers.batched import (
    ab_gmres_batched,
    ba_gmres_batched,
)
from hybrid_gmres_tpu_torch.solvers.lsqr import hybrid_lsqr, lsqr
from hybrid_gmres_tpu_torch.solvers.lsmr import hybrid_lsmr, lsmr
from hybrid_gmres_tpu_torch.solvers.gkb_batched import (
    hybrid_lsqr_batched,
    lsmr_batched,
    lsqr_batched,
)

__all__ = ["GKBResult", "GKBState", "GMRESResult", "ab_gmres",
           "ab_gmres_batched", "ab_gmres_restarted", "ab_gmres_rtp",
           "ba_gmres", "ba_gmres_batched", "ba_gmres_restarted",
           "ba_gmres_rtp", "hybrid_lsmr", "hybrid_lsqr",
           "hybrid_lsqr_batched", "lsmr", "lsmr_batched", "lsqr",
           "lsqr_batched"]
