"""The sharded tiers on ``torch.distributed`` (PyTorch port of
``hybrid_gmres_tpu/parallel``): the 1-D row-sharded BA/AB-GMRES, RTP, GKB
(LSQR/LSMR and hybrids) and multi-RHS GMRES solvers, and the 2-D (ray x
pixel) tiled tier of the same families (``panels2d``, ``sharded2d``,
``sharded_gkb2d``, ``sharded_batched2d``).

SPMD, one process per card: build a :class:`~mesh.Mesh` (NCCL on the card
by default, gloo with ``device="cpu"``; :func:`make_mesh_2d` for the 2-D
tier, with its per-axis groups) after the process group exists
(:func:`initialize_multihost` under torchrun), then call the solvers on
every rank.  ``python -m hybrid_gmres_tpu_torch.parallel.dryrun`` drives
every tier once against the single-device solvers (``dryrun.py``).
"""

from hybrid_gmres_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_replica_meshes,
)
from hybrid_gmres_tpu_torch.parallel.multihost import initialize_multihost
from hybrid_gmres_tpu_torch.parallel.panels import (
    ComposedPanels,
    PanelsWithAdjoint,
    ShardedPanels,
    build_panels_with_adjoint,
    comms_bytes_per_iteration,
    shard_bucketed_panels,
)
from hybrid_gmres_tpu_torch.parallel.sharded import (
    ba_gmres_sharded,
    shard_problem,
    sharded_ab_matvec,
    sharded_ba_matvec,
)
from hybrid_gmres_tpu_torch.parallel.sharded_batched import (
    ab_gmres_sharded_batched,
    ba_gmres_sharded_batched,
)
from hybrid_gmres_tpu_torch.parallel.sharded_full import (
    ab_gmres_sharded_basis,
    ba_gmres_sharded_basis,
)
from hybrid_gmres_tpu_torch.parallel.sharded_gkb import (
    hybrid_lsmr_sharded,
    hybrid_lsqr_sharded,
    lsmr_sharded,
    lsqr_sharded,
)
from hybrid_gmres_tpu_torch.parallel.sharded_rows import (
    ab_gmres_sharded_pallas,
    ab_gmres_sharded_pallas_restarted,
    ba_gmres_sharded_pallas,
    ba_gmres_sharded_pallas_restarted,
)
from hybrid_gmres_tpu_torch.parallel.sharded_rtp import (
    ab_gmres_rtp_sharded,
    ba_gmres_rtp_sharded,
)
from hybrid_gmres_tpu_torch.parallel.panels2d import (
    TiledPanels,
    ab_gmres_sharded_pallas_2d,
    ab_gmres_sharded_pallas_2d_restarted,
    ba_gmres_sharded_pallas_2d,
    ba_gmres_sharded_pallas_2d_restarted,
    comms_bytes_per_iteration_2d,
    tile_backprojector_forward,
    tile_bucketed_panels,
    tile_view,
)
from hybrid_gmres_tpu_torch.parallel.sharded2d import (
    ba_gmres_sharded_2d,
    shard_problem_2d,
)
from hybrid_gmres_tpu_torch.parallel.sharded_batched2d import (
    ab_gmres_sharded_batched_2d,
    ba_gmres_sharded_batched_2d,
)
from hybrid_gmres_tpu_torch.parallel.sharded_gkb2d import (
    hybrid_lsmr_sharded_2d,
    hybrid_lsqr_sharded_2d,
    lsmr_sharded_2d,
    lsqr_sharded_2d,
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
    "PanelsWithAdjoint",
    "build_panels_with_adjoint",
    "ComposedPanels",
    "ba_gmres_rtp_sharded",
    "ab_gmres_rtp_sharded",
    "lsqr_sharded",
    "hybrid_lsqr_sharded",
    "lsmr_sharded",
    "hybrid_lsmr_sharded",
    "ba_gmres_sharded_batched",
    "ab_gmres_sharded_batched",
    "ba_gmres_sharded_2d",
    "shard_problem_2d",
    "TiledPanels",
    "tile_bucketed_panels",
    "tile_backprojector_forward",
    "tile_view",
    "ba_gmres_sharded_pallas_2d",
    "ab_gmres_sharded_pallas_2d",
    "ba_gmres_sharded_pallas_2d_restarted",
    "ab_gmres_sharded_pallas_2d_restarted",
    "comms_bytes_per_iteration_2d",
    "ba_gmres_sharded_batched_2d",
    "ab_gmres_sharded_batched_2d",
    "lsqr_sharded_2d",
    "hybrid_lsqr_sharded_2d",
    "lsmr_sharded_2d",
    "hybrid_lsmr_sharded_2d",
]
