from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres

__all__ = ["GMRESResult", "ab_gmres", "ba_gmres"]
