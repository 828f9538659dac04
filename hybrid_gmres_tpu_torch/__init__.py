"""hybrid_gmres_tpu_torch — the PyTorch + CUDA port of ``hybrid_gmres_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths and public names so each counterpart is easy to find.  It imports
``torch``, ``numpy`` and ``scipy`` only — never ``jax``.

On the CUDA path every sparse product runs as a hand-written Hopper kernel
on the operator's row-packed forms (bfloat16, the default of
``ct_gpu_operators``; float32; int8; or int4 nibble pairs):
``csrc/row_spmv.cu`` (SpMV, SpMM and their transposed twins, built with
``nvcc`` at first use).  ``hybrid_gmres_tpu_torch.parallel`` runs the 1-D
and 2-D sharded solvers on ``torch.distributed`` (NCCL, or gloo on the
CPU); ``hybrid_gmres_tpu_torch.entry`` holds the entry point of the solve
step.  The block-ELL kernels of the earlier ports (``csrc/bucket_*.cu``)
stay as checked counterparts of the Pallas kernels on no solver's path.
On CPU tensors every operator uses its plain PyTorch version.
Constructors build on the card unless given ``device="cpu"``.

Imports are lazy: ``import hybrid_gmres_tpu_torch`` loads no solver until a
name below is first used.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "LinearOperator": "hybrid_gmres_tpu_torch.ops.linear_operator",
    "DenseOperator": "hybrid_gmres_tpu_torch.ops.linear_operator",
    "as_operator": "hybrid_gmres_tpu_torch.ops.linear_operator",
    "AugmentedOperator": "hybrid_gmres_tpu_torch.ops.linear_operator",
    "ShiftedOperator": "hybrid_gmres_tpu_torch.ops.linear_operator",
    "ProductOperator": "hybrid_gmres_tpu_torch.ops.linear_operator",
    "BlockELLOperator": "hybrid_gmres_tpu_torch.ops.spmv_cuda",
    "ct_mismatched": "hybrid_gmres_tpu_torch.problems.ct",
    "ct_gpu_operators": "hybrid_gmres_tpu_torch.problems.ct",
    "generate_test_problem": "hybrid_gmres_tpu_torch.problems.onedim",
    "shaw": "hybrid_gmres_tpu_torch.problems.onedim",
    "heat": "hybrid_gmres_tpu_torch.problems.onedim",
    "deriv2": "hybrid_gmres_tpu_torch.problems.onedim",
    "GMRESResult": "hybrid_gmres_tpu_torch.solvers.common",
    "GKBResult": "hybrid_gmres_tpu_torch.solvers.common",
    "GKBState": "hybrid_gmres_tpu_torch.solvers.common",
    "lsqr": "hybrid_gmres_tpu_torch.solvers.lsqr",
    "hybrid_lsqr": "hybrid_gmres_tpu_torch.solvers.lsqr",
    "lsmr": "hybrid_gmres_tpu_torch.solvers.lsmr",
    "hybrid_lsmr": "hybrid_gmres_tpu_torch.solvers.lsmr",
    "lsqr_batched": "hybrid_gmres_tpu_torch.solvers.gkb_batched",
    "hybrid_lsqr_batched": "hybrid_gmres_tpu_torch.solvers.gkb_batched",
    "lsmr_batched": "hybrid_gmres_tpu_torch.solvers.gkb_batched",
    "ab_gmres": "hybrid_gmres_tpu_torch.solvers.gmres",
    "ba_gmres": "hybrid_gmres_tpu_torch.solvers.gmres",
    "ab_gmres_restarted": "hybrid_gmres_tpu_torch.solvers.gmres",
    "ba_gmres_restarted": "hybrid_gmres_tpu_torch.solvers.gmres",
    "ab_gmres_rtp": "hybrid_gmres_tpu_torch.solvers.rtp",
    "ba_gmres_rtp": "hybrid_gmres_tpu_torch.solvers.rtp",
    "ab_gmres_batched": "hybrid_gmres_tpu_torch.solvers.batched",
    "ba_gmres_batched": "hybrid_gmres_tpu_torch.solvers.batched",
    "gcv_from_H": "hybrid_gmres_tpu_torch.reg.gcv",
    "gcv_factors": "hybrid_gmres_tpu_torch.reg.gcv",
    "gcv_from_factors": "hybrid_gmres_tpu_torch.reg.gcv",
    "gcv_curve": "hybrid_gmres_tpu_torch.reg.gcv",
    "gcv_surface": "hybrid_gmres_tpu_torch.reg.gcv",
    "gcv_lambda": "hybrid_gmres_tpu_torch.reg.gcv",
    "minimize_scalar_bounded": "hybrid_gmres_tpu_torch.reg.gcv",
    "discrepancy_lambda": "hybrid_gmres_tpu_torch.reg.discrepancy",
    "lcurve_sweep": "hybrid_gmres_tpu_torch.reg.lcurve",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
