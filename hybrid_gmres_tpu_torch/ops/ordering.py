"""Space-filling-curve orderings for block-sparse operator locality.

numpy-only twin of ``hybrid_gmres_tpu/ops/ordering.py``, kept here so the
PyTorch port never imports the JAX package.

The block-ELL SpMV kernel's cost is proportional to panel bytes = block
count, i.e. to how well the operator's nonzeros cluster into (8, 128)
tiles.  For the fan-beam CT pair the natural (angle-major ray, row-major
pixel) orderings are far from optimal:

  * A (rays x pixels): a row-group of 8 adjacent detectors covers a thin
    ray band, but 128 row-major pixels span only 2 image rows — the band
    crosses ~18 such column blocks.  With Morton (z-order) pixels a
    128-pixel block is a compact ~16x8 image tile: the band crosses far
    fewer tiles.
  * B (pixels x rays): a row-group of 8 row-major pixels is hit by ~2
    detectors in EVERY one of the 180 angles, so angle-major 128-ray
    column blocks are all touched (~195 blocks).  With Morton (angle, det)
    rays, the sinogram sine-curve of a compact pixel tile stays inside a
    handful of (16 angle x 8 det) tiles.

Measured on CT n=64 (180x180, bf16 panels): A 147 -> 63MB, B 205 -> 48MB —
3.2x less HBM traffic for the same math.

Because the SAME permutation is applied to A's rows and B's columns (ray
space) and to A's columns and B's rows (pixel space), the reordered pair
is just P_r A P_x^T, P_x B P_r^T: solvers run unmodified on the permuted
problem (norms are permutation-invariant, so residual/error histories are
bit-comparable), and only the RHS is permuted on entry / the solution
un-permuted on exit.  No reference counterpart (the reference is dense
MATLAB, ``run_2D_phantom.m:12-15``); this is a device layout concern.
"""

from __future__ import annotations

import numpy as np


def morton_perm(nu: int, nv: int) -> np.ndarray:
    """Permutation sorting the flat index ``u * nv + v`` by Morton code.

    ``perm[new_position] = old_index``; works for non-power-of-two extents
    (the z-curve is computed on the bounding power-of-two box and sorted
    stably, which simply skips absent cells).
    """
    u = np.repeat(np.arange(nu), nv)
    v = np.tile(np.arange(nv), nu)
    bits = int(max(nu, nv) - 1).bit_length()
    z = np.zeros(nu * nv, dtype=np.int64)
    for i in range(bits):
        z |= ((u >> i) & 1) << (2 * i) | ((v >> i) & 1) << (2 * i + 1)
    return np.argsort(z, kind="stable")


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def reorder_pair(A_csr, B_csr, ray_perm: np.ndarray, pix_perm: np.ndarray):
    """Apply consistent ray/pixel permutations to a mismatched (A, B) pair.

    A (m x n) -> A[ray_perm][:, pix_perm]; B (n x m) -> B[pix_perm][:, ray_perm].
    Returns CSR matrices; use with :func:`morton_perm` over the ray grid
    (n_angles, n_det) and the image grid (n, n).
    """
    Ap = A_csr[ray_perm][:, pix_perm].tocsr()
    Bp = B_csr[pix_perm][:, ray_perm].tocsr()
    return Ap, Bp
