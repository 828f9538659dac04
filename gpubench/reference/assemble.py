"""The CT pair (A, B) assembled again, independently of the program.

A frozen copy of the vectorized numpy assembler of the fan-curved CT problem
(ray-driven projector A with bilinear sampling every ``step`` pixels, and the
pixel-driven back-projector B with linear detector interpolation, B scaled so
that <x, B A x> = <A x, A x> on the modified Shepp-Logan phantom), written in
plain PyTorch so that it runs in float64 on whatever device holds the tensors.
It imports nothing of the program: the benchmark's reference solves with these
matrices, never with the program's.

Rays are numbered ``angle * n_det + detector`` and pixels ``row * n + col``
(the natural orders); the program's Morton order is a relabelling that the
comparison undoes on the program's side.
"""

from __future__ import annotations

import math
import warnings

import torch

F64 = torch.float64
# the fan's half-angle over the half-diagonal's, and the ray's sampling
# step in pixels: fixed in the program (``problems/ct.py``), so constants
# here and in the scanner, not settings of a configuration
FAN_MARGIN = 1.05
RAY_STEP = 0.5

# the modified Shepp-Logan ellipses: (value, a, b, x0, y0, phi in degrees)
SHEPP_LOGAN = (
    (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
    (-0.8, 0.6624, 0.8740, 0.0, -0.0184, 0.0),
    (-0.2, 0.1100, 0.3100, 0.22, 0.0, -18.0),
    (-0.2, 0.1600, 0.4100, -0.22, 0.0, 18.0),
    (0.1, 0.2100, 0.2500, 0.0, 0.35, 0.0),
    (0.1, 0.0460, 0.0460, 0.0, 0.1, 0.0),
    (0.1, 0.0460, 0.0460, 0.0, -0.1, 0.0),
    (0.1, 0.0460, 0.0230, -0.08, -0.605, 0.0),
    (0.1, 0.0230, 0.0230, 0.0, -0.606, 0.0),
    (0.1, 0.0230, 0.0460, 0.06, -0.605, 0.0),
)


def gamma_max(n, source_radius, fan_margin):
    half_diag = n * math.sqrt(2.0) / 2.0
    return fan_margin * math.asin(min(half_diag / source_radius, 1.0))


def source_angles(n_angles, device):
    """numpy's ``linspace(0, 2 pi, n_angles, endpoint=False)``."""
    return (torch.arange(n_angles, dtype=F64, device=device)
            * (2.0 * math.pi / n_angles))


def shepp_logan(n, device):
    """The phantom rasterized on the n x n grid over [-1, 1]^2, flattened
    row by row."""
    c = (torch.arange(n, dtype=F64, device=device) + 0.5) / n * 2.0 - 1.0
    Y, X = torch.meshgrid(c, c, indexing="ij")
    img = torch.zeros((n, n), dtype=F64, device=device)
    for val, a, b, x0, y0, phi in SHEPP_LOGAN:
        t = math.radians(phi)
        xr = (X - x0) * math.cos(t) + (Y - y0) * math.sin(t)
        yr = -(X - x0) * math.sin(t) + (Y - y0) * math.cos(t)
        img += val * (((xr / a) ** 2 + (yr / b) ** 2) <= 1.0).to(F64)
    return img.reshape(-1)


def _coalesced(rows, cols, vals, shape):
    """Sum duplicate (row, col) entries: a CSR tensor sorted by row and
    column."""
    key = rows * shape[1] + cols
    key, inv = torch.unique(key, sorted=True, return_inverse=True)
    summed = torch.zeros(key.numel(), dtype=F64, device=vals.device)
    summed.index_add_(0, inv, vals)
    return key // shape[1], key % shape[1], summed


def _csr(rows, cols, vals, shape):
    counts = torch.bincount(rows, minlength=shape[0])
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(counts, 0)
    return csr_tensor(crow, cols, vals, shape)


def csr_tensor(crow, cols, vals, shape):
    """A CSR tensor, without PyTorch's notice that CSR support is in
    beta."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, vals, size=shape,
                                       check_invariants=False)


def fan_projector(n, n_angles, n_det, source_radius, fan_margin=FAN_MARGIN,
                  step=RAY_STEP, device="cpu", angles_per_chunk=16):
    """A (n_angles * n_det, n * n) as a float64 CSR tensor."""
    gmax = gamma_max(n, source_radius, fan_margin)
    gammas = ((torch.arange(n_det, dtype=F64, device=device) + 0.5)
              / n_det * 2 * gmax - gmax)
    n_samp = int(math.ceil(2.0 * source_radius / step))
    ts = (torch.arange(n_samp, dtype=F64, device=device) + 0.5) * step
    phis = source_angles(n_angles, device)
    parts = []
    for a0 in range(0, n_angles, angles_per_chunk):
        phi = phis[a0:a0 + angles_per_chunk]
        src_x = source_radius * torch.cos(phi)
        src_y = source_radius * torch.sin(phi)
        nrm = torch.sqrt(src_x ** 2 + src_y ** 2)
        base = torch.atan2(-src_y / nrm, -src_x / nrm)
        ang = base[:, None] + gammas[None, :]            # (a, det)
        xs = src_x[:, None, None] + torch.cos(ang)[..., None] * ts
        ys = src_y[:, None, None] + torch.sin(ang)[..., None] * ts
        inside = (xs.abs() <= n / 2 + 1) & (ys.abs() <= n / 2 + 1)
        ray = ((torch.arange(phi.numel(), device=device)[:, None] + a0)
               * n_det + torch.arange(n_det, device=device)[None, :])
        rows = ray[..., None].expand_as(xs)[inside]
        xs, ys = xs[inside], ys[inside]
        gx = xs + n / 2.0 - 0.5
        gy = ys + n / 2.0 - 0.5
        j0 = torch.floor(gx)
        i0 = torch.floor(gy)
        fx, fy = gx - j0, gy - i0
        j0, i0 = j0.to(torch.int64), i0.to(torch.int64)
        r_l, c_l, v_l = [], [], []
        for di, dj, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                           (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            ii, jj = i0 + di, j0 + dj
            ok = (ii >= 0) & (ii < n) & (jj >= 0) & (jj < n)
            r_l.append(rows[ok])
            c_l.append((ii * n + jj)[ok])
            v_l.append((step * wt)[ok])
        parts.append(_coalesced(torch.cat(r_l), torch.cat(c_l),
                                torch.cat(v_l), (n_angles * n_det, n * n)))
    rows, cols, vals = (torch.cat(p) for p in zip(*parts))
    return _csr(rows, cols, vals, (n_angles * n_det, n * n))


def pixel_backprojector(n, n_angles, n_det, source_radius,
                        fan_margin=FAN_MARGIN, device="cpu"):
    """B (n * n, n_angles * n_det), unscaled, as a float64 CSR tensor."""
    gmax = gamma_max(n, source_radius, fan_margin)
    c = torch.arange(n, dtype=F64, device=device) + 0.5 - n / 2.0
    Y, X = torch.meshgrid(c, c, indexing="ij")
    px, py = X.reshape(-1), Y.reshape(-1)
    pix = torch.arange(n * n, device=device)
    r_l, c_l, v_l = [], [], []
    for a_idx, phi in enumerate(source_angles(n_angles, device).tolist()):
        sx, sy = source_radius * math.cos(phi), source_radius * math.sin(phi)
        nrm = math.hypot(sx, sy)
        base = math.atan2(-sy / nrm, -sx / nrm)
        ang = torch.atan2(py - sy, px - sx) - base
        ang = torch.remainder(ang + math.pi, 2 * math.pi) - math.pi
        det = (ang + gmax) / (2 * gmax) * n_det - 0.5
        d0 = torch.floor(det)
        f = det - d0
        d0 = d0.to(torch.int64)
        for dd, wt in ((0, 1.0 - f), (1, f)):
            di = d0 + dd
            ok = (di >= 0) & (di < n_det)
            r_l.append(pix[ok])
            c_l.append((a_idx * n_det + di)[ok])
            v_l.append(wt[ok])
    rows, cols, vals = _coalesced(torch.cat(r_l), torch.cat(c_l),
                                  torch.cat(v_l), (n * n, n_angles * n_det))
    return _csr(rows, cols, vals, (n * n, n_angles * n_det))


def ct_pair(cfg, device):
    """(A, B) of a configuration in float64, B scaled on the phantom."""
    g = cfg
    n = g["n"]
    radius = g["source_radius_factor"] * n
    A = fan_projector(n, g["n_angles"], g["n_det"], radius, device=device)
    B = pixel_backprojector(n, g["n_angles"], g["n_det"], radius,
                            device=device)
    x = shepp_logan(n, device)
    Ax = A @ x
    scale = float(Ax @ Ax) / float(x @ (B @ Ax))
    B = csr_tensor(B.crow_indices(), B.col_indices(), B.values() * scale,
                   B.shape)
    return A, B
