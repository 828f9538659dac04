#!/usr/bin/env python3
"""How far float32 moves the CT error histories of AB- and BA-GMRES from
float64, on the host, independent of the kernels.

    python3 scripts_torch/float32_gap.py [--n 128] [--steps 12]

Runs the bench scenario (CT n, 180 n/64 angles and detectors, 25% noise
from seed 0, lam=1e-2, fused residual) through the port's ``ab_gmres`` and
``ba_gmres`` with scipy CSR products of the int8-quantized operators
diag(s) Q, in float32 and in float64, and prints the largest relative gap
of the first ``--steps`` error-history entries and of the minima.  A gap
this size is what any reordering of the float32 sums may move a history
by; it stays well inside ``chip_smoke.py``'s 1e-3 history band.  No GPU;
about a minute and 3 GB at n=128.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()

    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator
    from hybrid_gmres_tpu_torch.ops.ordering import morton_perm, reorder_pair
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _row_quantize_csr
    from hybrid_gmres_tpu_torch.problems.ct import ct_mismatched
    from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres

    n, ang = args.n, 180 * args.n // 64
    prob = ct_mismatched(n=n, n_angles=ang, n_det=ang)
    rp, pp = morton_perm(ang, ang), morton_perm(n, n)
    A, B = reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32), rp, pp)

    class HostOperator(LinearOperator):
        device = torch.device("cpu")

        def __init__(self, csr, dtype):
            q, s = _row_quantize_csr(csr.astype(np.float64))
            self.csr = (q.multiply(s.astype(np.float64)[:, None])).tocsr()
            self.csr = self.csr.astype(dtype)
            self.csr_t = self.csr.T.tocsr()
            self.shape = self.csr.shape
            self.dtype = torch.from_numpy(np.zeros(0, dtype)).dtype

        def matvec(self, v):
            return torch.from_numpy(self.csr @ v.numpy())

        def rmatvec(self, u):
            return torch.from_numpy(self.csr_t @ u.numpy())

    b_exact = prob.b_exact.astype(np.float32)
    e = np.random.default_rng(0).standard_normal(b_exact.shape)
    e = e / np.linalg.norm(e) * 0.25 * float(np.linalg.norm(b_exact))
    b = (b_exact + e.astype(np.float32))[rp]
    x_true = prob.x_true[pp]
    hists = {}
    for dt in (np.float32, np.float64):
        ops = HostOperator(A, dt), HostOperator(B, dt)
        for name, fn in (("ab", ab_gmres), ("ba", ba_gmres)):
            r = fn(*ops, torch.from_numpy(b.astype(dt)),
                   torch.from_numpy(x_true.astype(dt)), tol=0.0,
                   maxit=args.steps, lam=1e-2, residual="fused")
            hists[name, dt] = r.err_hist.numpy().astype(np.float64)
    out = {"n": n, "steps": args.steps}
    for name in ("ab", "ba"):
        h32, h64 = hists[name, np.float32], hists[name, np.float64]
        out[name] = {
            "hist_max_rel_gap": float(np.max(np.abs(h32 - h64) / h64)),
            "min_rel_gap": float(abs(h32.min() - h64.min()) / h64.min()),
            "min_float32": float(h32.min()), "min_float64": float(h64.min())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
