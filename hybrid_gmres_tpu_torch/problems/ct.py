"""Fan-beam CT test problem with a deliberately mismatched back-projector.

Twin of ``hybrid_gmres_tpu/problems/ct.py``: a fan-curved projector ``A``
(ray-driven Joseph-style line integrals) and an *unmatched* back-projector
``B`` (pixel-driven, linear detector interpolation), so ``B != A^T`` by
construction.  Matrices are assembled on the host (C++ builder or vectorized
numpy) into scipy CSR; :func:`ct_gpu_operators` packs them into the
block-ELL operators the CUDA kernel applies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch


# Standard "modified Shepp-Logan" ellipses: (value, a, b, x0, y0, phi_deg).
_SHEPP_LOGAN = [
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
]


def shepp_logan(n: int) -> np.ndarray:
    """Rasterize the modified Shepp-Logan phantom on an n x n grid in [-1,1]^2."""
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    X, Y = np.meshgrid(c, c, indexing="xy")
    img = np.zeros((n, n))
    for val, a, b, x0, y0, phi in _SHEPP_LOGAN:
        t = np.deg2rad(phi)
        Xr = (X - x0) * np.cos(t) + (Y - y0) * np.sin(t)
        Yr = -(X - x0) * np.sin(t) + (Y - y0) * np.cos(t)
        img += val * ((Xr / a) ** 2 + (Yr / b) ** 2 <= 1.0)
    return img


@dataclass
class FanBeamGeometry:
    n: int                 # image is n x n pixels, centered at the origin
    n_angles: int
    n_det: int
    source_radius: float   # distance source <-> image center, in pixels
    fan_margin: float = 1.05

    @property
    def gamma_max(self) -> float:
        half_diag = self.n * np.sqrt(2.0) / 2.0
        return self.fan_margin * np.arcsin(min(half_diag / self.source_radius, 1.0))

    def source_positions(self):
        return np.linspace(0.0, 2.0 * np.pi, self.n_angles, endpoint=False)

    def ray_count(self) -> int:
        return self.n_angles * self.n_det


def _bilinear_scatter(n, xs, ys, w, rows, mat_rows, mat_cols, mat_vals):
    """Accumulate bilinear-interpolated sample weights into COO triplets.

    (xs, ys) in pixel coordinates with the image spanning [-n/2, n/2]^2;
    row-major flattening: p = i * n + j.
    """
    gx = xs + n / 2.0 - 0.5
    gy = ys + n / 2.0 - 0.5
    j0 = np.floor(gx).astype(np.int64)
    i0 = np.floor(gy).astype(np.int64)
    fx = gx - j0
    fy = gy - i0
    for di, dj, wt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        ii = i0 + di
        jj = j0 + dj
        ok = (ii >= 0) & (ii < n) & (jj >= 0) & (jj < n)
        mat_rows.append(rows[ok])
        mat_cols.append((ii * n + jj)[ok])
        mat_vals.append((w * wt)[ok])


def build_fan_projector(geom: FanBeamGeometry, step: float = 0.5) -> sp.csr_matrix:
    """Ray-driven fan-curved forward projector A (n_angles*n_det, n*n)."""
    n = geom.n
    gmax = geom.gamma_max
    gammas = (np.arange(geom.n_det) + 0.5) / geom.n_det * 2 * gmax - gmax
    t_max = 2.0 * geom.source_radius
    n_samp = int(np.ceil(t_max / step))
    ts = (np.arange(n_samp) + 0.5) * step

    rows_l, cols_l, vals_l = [], [], []
    for a_idx, phi in enumerate(geom.source_positions()):
        src = geom.source_radius * np.array([np.cos(phi), np.sin(phi)])
        to_center = -src / np.linalg.norm(src)
        base_angle = np.arctan2(to_center[1], to_center[0])
        ray_angles = base_angle + gammas
        dirs = np.stack([np.cos(ray_angles), np.sin(ray_angles)], axis=1)
        xs = src[0] + dirs[:, 0:1] * ts[None, :]
        ys = src[1] + dirs[:, 1:2] * ts[None, :]
        inside = (np.abs(xs) <= n / 2 + 1) & (np.abs(ys) <= n / 2 + 1)
        ray_ids = a_idx * geom.n_det + np.arange(geom.n_det)
        rows = np.broadcast_to(ray_ids[:, None], xs.shape)[inside]
        w = np.full(rows.shape, step)
        _bilinear_scatter(n, xs[inside], ys[inside], w, rows,
                          rows_l, cols_l, vals_l)
    A = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(geom.ray_count(), n * n),
    ).tocsr()
    A.sum_duplicates()
    return A


def build_pixel_backprojector(geom: FanBeamGeometry) -> sp.csr_matrix:
    """Pixel-driven back-projector B (n*n, n_angles*n_det), B != A^T."""
    n = geom.n
    gmax = geom.gamma_max
    c = np.arange(n) + 0.5 - n / 2.0
    X, Y = np.meshgrid(c, c, indexing="xy")
    px = X.ravel()
    py = Y.ravel()
    pix_ids = np.arange(n * n)

    rows_l, cols_l, vals_l = [], [], []
    for a_idx, phi in enumerate(geom.source_positions()):
        src = geom.source_radius * np.array([np.cos(phi), np.sin(phi)])
        to_center = -src / np.linalg.norm(src)
        base_angle = np.arctan2(to_center[1], to_center[0])
        ang = np.arctan2(py - src[1], px - src[0]) - base_angle
        ang = (ang + np.pi) % (2 * np.pi) - np.pi  # wrap to (-pi, pi]
        det_coord = (ang + gmax) / (2 * gmax) * geom.n_det - 0.5
        d0 = np.floor(det_coord).astype(np.int64)
        f = det_coord - d0
        for dd, wt in ((0, 1.0 - f), (1, f)):
            di = d0 + dd
            ok = (di >= 0) & (di < geom.n_det)
            rows_l.append(pix_ids[ok])
            cols_l.append((a_idx * geom.n_det + di)[ok])
            vals_l.append(wt[ok])
    B = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n * n, geom.ray_count()),
    ).tocsr()
    B.sum_duplicates()
    return B


@dataclass
class CTProblem:
    A_csr: sp.csr_matrix    # (m, n_pix) forward projector
    B_csr: sp.csr_matrix    # (n_pix, m) mismatched back-projector
    b_exact: np.ndarray     # clean sinogram (m,), float64
    x_true: np.ndarray      # phantom (n_pix,), float64
    geom: FanBeamGeometry


def ct_mismatched(
    n: int = 32,
    n_angles: int = 90,
    n_det: int = 90,
    source_radius: float | None = None,
    backend: str = "auto",
) -> CTProblem:
    """Fan-curved CT with mismatched (A, B), Shepp-Logan phantom, clean
    sinogram, as scipy CSR and float64 numpy vectors.

    B is globally rescaled so that the Rayleigh quotients of B A and A^T A
    agree on the phantom.  ``backend``: 'native' (C++ builder), 'numpy', or
    'auto' (native if ``g++`` is available).  Both give the same operators
    to floating-point tolerance.
    """
    if source_radius is None:
        source_radius = 2.0 * n
    geom = FanBeamGeometry(n=n, n_angles=n_angles, n_det=n_det,
                           source_radius=source_radius)
    if backend == "auto":
        from hybrid_gmres_tpu_torch.utils.native import native_available

        backend = "native" if native_available() else "numpy"
    if backend == "native":
        from hybrid_gmres_tpu_torch.utils.native import (
            build_fan_projector_native,
            build_pixel_backprojector_native,
        )

        A_csr = build_fan_projector_native(
            n, n_angles, n_det, source_radius, geom.fan_margin, step=0.5
        )
        B_csr = build_pixel_backprojector_native(
            n, n_angles, n_det, source_radius, geom.fan_margin
        )
    else:
        A_csr = build_fan_projector(geom)
        B_csr = build_pixel_backprojector(geom)

    x = shepp_logan(n).ravel()
    Ax = A_csr @ x
    # scale B: <x, B A x> == <Ax, Ax>
    scale = float(Ax @ Ax) / float(x @ (B_csr @ Ax))
    B_csr = B_csr * scale
    return CTProblem(A_csr=A_csr, B_csr=B_csr, b_exact=Ax, x_true=x, geom=geom)


# Panel layout of the CT operators, as ``bench.py`` calls
# ``ct_tpu_operators``: tall blocks for A (32 Morton-consecutive rays form
# one coherent (angle, det) tile), (8, 128) for B, 8 row-count buckets.
BLOCK_A = (32, 128)
BLOCK_B = (8, 128)
N_BUCKETS = 8


def ct_gpu_operators(prob: CTProblem, dtype="bfloat16", device="cuda",
                     with_adjoint: bool = False):
    """The production path for a CT problem: Morton-ordered block-ELL
    operators (twin of ``ct_tpu_operators``, with its default storage
    type, bfloat16).

    ``dtype``: "bfloat16" (the default), "float32", "int8" (per-row
    quantized, ``bench.py``'s operators) or "int4", or the torch dtype.

    ``with_adjoint=False`` (the default) builds forward panels only: the
    GMRES solvers need nothing else (``B`` is its own operator), and the GKB
    solvers (LSQR/LSMR) apply ``A^T`` from the forward panel through the
    transposed kernels.  ``with_adjoint=True`` also packs a panel of each
    transpose (twice the panel memory), applied through the forward kernels.

    Returns ``(A_op, B_op, b_exact_p, x_true_p, ray_perm, pix_perm)``: rays
    z-ordered by (angle, det) and pixels by (x, y) — a pure relabeling that
    shrinks the block-ELL panels ~3.2x on CT n=64 — with A packed in
    ``BLOCK_A`` blocks and B in ``BLOCK_B`` blocks, ``N_BUCKETS`` buckets
    each and the packer's default bucket padding, so the panels are
    identical to the JAX ones.
    ``b_exact_p``/``x_true_p`` are float64 tensors on ``device``.  Permute
    any external sinogram with ``ray_perm`` and un-permute solutions with
    ``inverse_perm(pix_perm)``.
    """
    from hybrid_gmres_tpu_torch.ops.ordering import morton_perm, reorder_pair
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import BlockELLOperator

    g = prob.geom
    ray_perm = morton_perm(g.n_angles, g.n_det)
    pix_perm = morton_perm(g.n, g.n)
    A_csr, B_csr = reorder_pair(
        prob.A_csr.astype(np.float32), prob.B_csr.astype(np.float32),
        ray_perm, pix_perm)
    A_op = BlockELLOperator.from_csr(
        A_csr, dtype=dtype, block=BLOCK_A, n_buckets=N_BUCKETS,
        with_adjoint=with_adjoint, device=device)
    B_op = BlockELLOperator.from_csr(
        B_csr, dtype=dtype, block=BLOCK_B, n_buckets=N_BUCKETS,
        with_adjoint=with_adjoint, device=device)
    return (A_op, B_op,
            torch.as_tensor(prob.b_exact[ray_perm], device=device),
            torch.as_tensor(prob.x_true[pix_perm], device=device),
            ray_perm, pix_perm)
