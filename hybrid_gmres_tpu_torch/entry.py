"""Driver entry points of the port: the solve step and the multi-card dry
run (the twin of the repo's ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)``: one hybrid BA-GMRES
reconstruction on the fan-beam CT problem (n=32, 90x90 rays, 25% noise),
``fn(A, B, b) -> (x, res_hist, niters)``.  On the card (the default) it is
the production configuration ``bench.py`` measures: Morton-ordered int8
operators (``ct_gpu_operators``) and the fused exact residual, so a call
runs the redesigned K1 (``csrc/row_spmv.cu``) 41 times.  With
``device="cpu"`` it is the JAX entry's CPU branch: dense float32 operators
and the true residual.  There is no fallback: without a card the default
raises.

``dryrun_multichip`` is ``parallel/dryrun.py``'s: every sharded tier once
on tiny shapes, over the ranks of a ``torch.distributed`` job.
"""

from __future__ import annotations

import numpy as np
import torch

from hybrid_gmres_tpu_torch.parallel.dryrun import dryrun_multichip
from hybrid_gmres_tpu_torch.utils.device import require_device

__all__ = ["dryrun_multichip", "entry"]

N, N_ANGLES, N_DET = 32, 90, 90
NOISE = 0.25
MAXIT, LAM = 20, 1e-2


def entry(device="cuda"):
    """(fn, example_args): the hybrid BA-GMRES solve on CT n=32.

    On the card: int8 operators (``N_BUCKETS`` buckets), the sinogram
    permuted by ``ray_perm``, ``residual="fused"``.  On the CPU
    (``device="cpu"``): dense float32 operators in the natural order,
    ``residual="true"``.  Both solve ``tol=0, maxit=20, lam=1e-2``; the
    noise is 25% of ``||b_exact||`` from ``default_rng(0)``, added to the
    float32 sinogram in float32."""
    from hybrid_gmres_tpu_torch.ops.linear_operator import as_operator
    from hybrid_gmres_tpu_torch.problems.ct import (ct_gpu_operators,
                                                    ct_mismatched)
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    dev = require_device(device)
    prob = ct_mismatched(n=N, n_angles=N_ANGLES, n_det=N_DET)
    b_exact = prob.b_exact.astype(np.float32)
    e = np.random.default_rng(0).standard_normal(b_exact.shape)
    e = e / np.linalg.norm(e) * NOISE * float(np.linalg.norm(b_exact))
    b_noise = b_exact + e.astype(np.float32)
    if dev.type == "cuda":
        A_op, B_op, _, _, ray_perm, _ = ct_gpu_operators(
            prob, dtype="int8", device=dev)
        b_noise = b_noise[ray_perm]
        residual = "fused"
    else:
        A_op = as_operator(prob.A_csr.toarray().astype(np.float32),
                           device=dev)
        B_op = as_operator(prob.B_csr.toarray().astype(np.float32),
                           device=dev)
        residual = "true"

    def fn(A, B, b):
        r = ba_gmres(A, B, b, tol=0.0, maxit=MAXIT, lam=LAM,
                     residual=residual)
        return r.x, r.res_hist, r.niters

    return fn, (A_op, B_op, torch.as_tensor(b_noise, device=dev))
