"""hybrid_gmres_tpu_torch — the PyTorch + CUDA port of ``hybrid_gmres_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths and public names so each counterpart is easy to find.  It imports
``torch``, ``numpy`` and ``scipy`` only — never ``jax``.

On the CUDA path the bucketed block-ELL products run as hand-written Hopper
kernels (``csrc/bucket_spmv.cu``, ``csrc/bucket_spmm.cu`` and, for the
transposed products from the same panel, ``csrc/bucket_rspmv.cu``, built
with ``nvcc`` at first use); on CPU tensors every operator uses its plain
PyTorch version.  Constructors build on the card unless given ``device="cpu"``.

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
    "ab_gmres_batched": "hybrid_gmres_tpu_torch.solvers.batched",
    "ba_gmres_batched": "hybrid_gmres_tpu_torch.solvers.batched",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
