#!/usr/bin/env python3
"""Why AB-GMRES on CT turned NaN in float32 with the projected Tikhonov
solve by float32 Cholesky, and that the float64 Gram of the port's
``projected_tikhonov_solve`` keeps it finite.

    python3 scripts_torch/ab_gram_check.py [--n 128] [--steps 100]
                                           [--device cuda]

The bench scenario (CT n, 180 n/64 angles and detectors, int8 operators,
25% noise from seed 0, lam=1e-2, fused residual) through the port's
``ab_gmres`` twice on one device:

  * ``float32_cholesky``: the projected solve as it was, Gram, Cholesky
    and solve in float32.  Each step records ``cholesky_ex``'s info (the
    order of the first non-positive pivot, 0 when it succeeded), the
    extreme eigenvalues of that float32 Gram (float64 ``eigvalsh``) and
    ``eps32 ||H||^2``, the Gram's rounding;
  * ``float64_gram``: the port's solve, the same eigenvalues of its Gram.

Prints one JSON line per run: the first step whose Cholesky failed, the
first non-finite history entry, the minimum error and a few steps' records,
then the card's name and power limit.  The per-step records add host
synchronizations: this is a diagnostic, not a timing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def float32_cholesky_solve(H, t, lam, kdim):
    """The projected Tikhonov solve with the Gram and its Cholesky in the
    working dtype (the port's solve before it moved them to float64)."""
    import torch

    from hybrid_gmres_tpu_torch.krylov.projected import _active, mask_columns

    maxit = H.shape[-1]
    dtype, device = H.dtype, H.device
    H = mask_columns(H, kdim)
    active = _active(maxit, kdim, device)
    G = H.mT @ H + lam * torch.eye(maxit, dtype=dtype, device=device) + \
        torch.diag_embed((~active).to(dtype))
    L, info = torch.linalg.cholesky_ex(G)
    y = torch.cholesky_solve(H.mT @ t[..., None], L)[..., 0]
    return torch.where(active, y, torch.zeros((), dtype=dtype,
                                              device=device)), G, info


def gram_record(G, kdim, info, H):
    import torch

    k = int(kdim)
    ev = torch.linalg.eigvalsh(G[:k, :k].double().cpu())
    h2 = float(torch.linalg.matrix_norm(H[:k + 1, :k].double().cpu(), 2)) ** 2
    return dict(k=k, info=int(info), eig_min=float(ev[0]),
                eig_max=float(ev[-1]),
                rounding=float(np.finfo(np.float32).eps) * h2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import hybrid_gmres_tpu_torch.solvers.gmres as gm
    from hybrid_gmres_tpu_torch.krylov.projected import (
        _active, mask_columns, projected_tikhonov_solve)
    from hybrid_gmres_tpu_torch.problems.ct import (ct_gpu_operators,
                                                    ct_mismatched)

    lam, n, ang = 1e-2, args.n, 180 * args.n // 64
    prob = ct_mismatched(n=n, n_angles=ang, n_det=ang)
    A, B, _, x_true, rp, _ = ct_gpu_operators(prob, dtype="int8",
                                              device=args.device)
    b_exact = prob.b_exact.astype(np.float32)
    e = np.random.default_rng(0).standard_normal(b_exact.shape)
    e = e / np.linalg.norm(e) * 0.25 * float(np.linalg.norm(b_exact))
    b = torch.as_tensor((b_exact + e.astype(np.float32))[rp],
                        device=args.device)
    x_true = x_true.to(torch.float32)

    def float32_run(H, t, lam_, kdim):
        y, G, info = float32_cholesky_solve(H, t, lam_, kdim)
        recs.append(gram_record(G, kdim, info, H))
        return y

    def float64_run(H, t, lam_, kdim):
        Hm = mask_columns(H, kdim).double()
        act = _active(H.shape[-1], kdim, H.device)
        G = Hm.mT @ Hm + lam_ * torch.eye(H.shape[-1], dtype=torch.float64,
                                          device=H.device) + \
            torch.diag_embed((~act).double())
        recs.append(gram_record(G, kdim, 0, H))
        return projected_tikhonov_solve(H, t, lam_, kdim)

    for name, fn in (("float32_cholesky", float32_run),
                     ("float64_gram", float64_run)):
        recs = []
        gm.projected_tikhonov_solve = fn
        try:
            r = gm.ab_gmres(A, B, b, x_true, tol=0.0, maxit=args.steps,
                            lam=lam, residual="fused")
        finally:
            gm.projected_tikhonov_solve = projected_tikhonov_solve
        err = r.err_hist.cpu().numpy().astype(np.float64)
        bad = np.nonzero(~np.isfinite(err))[0]
        failed = [s["k"] for s in recs if s["info"] != 0]
        first_fail = failed[0] if failed else None
        show = sorted({1, 12, 25, len(recs)} | (
            {first_fail - 1, first_fail} if first_fail else set()))
        print(json.dumps(dict(
            run=name, n=n, steps=args.steps, lam=lam,
            device=str(b.device),
            first_cholesky_failure_k=first_fail,
            cholesky_failures=len(failed),
            first_nonfinite_step=int(bad[0]) + 1 if len(bad) else None,
            x_finite=bool(torch.isfinite(r.x).all()),
            min_err=float(np.nanmin(err)) if np.isfinite(err).any()
            else None,
            min_err_k=int(np.nanargmin(err)) + 1 if np.isfinite(err).any()
            else None,
            eig_min_over_steps=min(s["eig_min"] for s in recs),
            records=[s for s in recs if s["k"] in show])))
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    except (OSError, subprocess.CalledProcessError):
        print("nvidia-smi: not available")


if __name__ == "__main__":
    main()
