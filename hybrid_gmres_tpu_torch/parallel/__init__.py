"""The 1-D sharded GMRES path on ``torch.distributed`` (PyTorch port of
``hybrid_gmres_tpu/parallel``, items 14.1-14.4 of ROADMAP).

SPMD, one process per card: build a :class:`~mesh.Mesh` (NCCL on the card
by default, gloo with ``device="cpu"``) after the process group exists
(:func:`initialize_multihost` under torchrun), then call the solvers on
every rank.  The sharded GKB, RTP, batched and 2-D solvers of the JAX
package are still to be ported (ROADMAP 14.5-14.10).
"""

from hybrid_gmres_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_replica_meshes,
)
from hybrid_gmres_tpu_torch.parallel.multihost import initialize_multihost
from hybrid_gmres_tpu_torch.parallel.panels import (
    ShardedPanels,
    comms_bytes_per_iteration,
    shard_bucketed_panels,
)
from hybrid_gmres_tpu_torch.parallel.sharded import (
    ba_gmres_sharded,
    shard_problem,
    sharded_ab_matvec,
    sharded_ba_matvec,
)
from hybrid_gmres_tpu_torch.parallel.sharded_full import (
    ab_gmres_sharded_basis,
    ba_gmres_sharded_basis,
)
from hybrid_gmres_tpu_torch.parallel.sharded_rows import (
    ab_gmres_sharded_pallas,
    ab_gmres_sharded_pallas_restarted,
    ba_gmres_sharded_pallas,
    ba_gmres_sharded_pallas_restarted,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "make_replica_meshes",
    "initialize_multihost",
    "shard_problem",
    "sharded_ba_matvec",
    "sharded_ab_matvec",
    "ba_gmres_sharded",
    "ba_gmres_sharded_basis",
    "ab_gmres_sharded_basis",
    "ShardedPanels",
    "shard_bucketed_panels",
    "comms_bytes_per_iteration",
    "ba_gmres_sharded_pallas",
    "ab_gmres_sharded_pallas",
    "ba_gmres_sharded_pallas_restarted",
    "ab_gmres_sharded_pallas_restarted",
]
