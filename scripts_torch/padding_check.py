#!/usr/bin/env python3
"""Do the products of one GMRES step give the same bits at another padded
width?  One CUDA card.

    python3 scripts_torch/padding_check.py

The JAX package keeps its Krylov basis, images and Hessenberg zero-padded to
the iteration budget ``maxit`` and multiplies the whole padded arrays.  A
solve resumed from a checkpoint of a smaller budget then runs every step
at another padded width than the uninterrupted one.  This script builds
random float32 bases of 4096 rows (images of 32400) with k+1 set columns,
zero-padded to the widths of a budget of 40 and of 100, and prints, for
k in {5, 30, 39}, whether each product gives the same bits at both widths
(``padded``) and, taking only the k+1 set columns, whether it gives the
bits of the width-100 product (``sliced_vs_padded``):

  * ``Q^T w`` and ``Q c`` (the two products of each CGS2 pass), ``IMG y``
    (the fused residual and the image-composed solution);
  * the projected Tikhonov solve and its Gram ``H^T H``, and the projected
    least-squares solve (QR), on (maxit+1, maxit) Hessenbergs.

Prints one JSON line per k and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    from hybrid_gmres_tpu_torch.krylov.projected import (
        projected_ls_solve, projected_tikhonov_solve)

    if not torch.cuda.is_available():
        sys.exit("padding_check.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda")

    def padded(rows, width, k, fill):
        """A column-major (rows, width) basis, its first k+1 columns set."""
        M = torch.zeros((width, rows), device="cuda").T
        M[:, :k + 1] = fill
        return M

    n, m = 4096, 32400
    for k in (5, 30, 39):
        out = {"k": k}
        q, w, c = rnd(n, k + 1), rnd(n), rnd(k + 1)
        Q41, Q101 = padded(n, 41, k, q), padded(n, 101, k, q)
        c41 = torch.nn.functional.pad(c, (0, 40 - k))
        c101 = torch.nn.functional.pad(c, (0, 100 - k))
        img, y = rnd(m, k + 1), rnd(k + 1)
        I40, I100 = padded(m, 40, k, img), padded(m, 100, k, img)
        y40 = torch.nn.functional.pad(y, (0, 39 - k))
        y100 = torch.nn.functional.pad(y, (0, 99 - k))
        QTw = Q101.T @ w
        Qc = Q101 @ c101
        Iy = I100 @ y100
        out["QT_w"] = dict(padded=torch.equal(Q41.T @ w, QTw[:41]),
                           sliced_vs_padded=torch.equal(
                               Q101[:, :k + 1].T @ w, QTw[:k + 1]))
        out["Q_c"] = dict(padded=torch.equal(Q41 @ c41, Qc),
                          sliced_vs_padded=torch.equal(
                              Q101[:, :k + 1] @ c, Qc))
        out["IMG_y"] = dict(padded=torch.equal(I40 @ y40, Iy),
                            sliced_vs_padded=torch.equal(
                                I100[:, :k + 1] @ y, Iy))
        Hk = torch.triu(rnd(k + 2, k + 1), -1)
        H41 = torch.zeros(41, 40, device="cuda")
        H101 = torch.zeros(101, 100, device="cuda")
        H41[:k + 2, :k + 1] = Hk
        H101[:k + 2, :k + 1] = Hk
        t41 = torch.zeros(41, device="cuda")
        t101 = torch.zeros(101, device="cuda")
        t41[0] = t101[0] = 3.0
        out["tikhonov"] = dict(padded=torch.equal(
            projected_tikhonov_solve(H41, t41, 1e-2, k + 1),
            projected_tikhonov_solve(H101, t101, 1e-2, k + 1)[:40]))
        out["gram"] = dict(padded=torch.equal(
            H41.mT @ H41, (H101.mT @ H101)[:40, :40]))
        out["least_squares"] = dict(padded=torch.equal(
            projected_ls_solve(H41, t41, k + 1),
            projected_ls_solve(H101, t101, k + 1)[:40]))
        print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
