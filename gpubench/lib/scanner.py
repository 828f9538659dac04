"""The one traffic generator: slices, their sinograms, and the requests.

It stands for the scanner.  Each slice is an ellipse phantom of the
Shepp-Logan kind drawn from the seed: the ten modified Shepp-Logan ellipses
moved, stretched, turned and re-weighted a little, and up to three small
extra ellipses.  Its sinogram is the exact line integral of those ellipses
along every ray of the configuration's fan-curved geometry (rays numbered
``angle * n_det + detector``, as the projector numbers them), in float64,
plus Gaussian noise of ``noise`` times the slice's ||b_exact||.  No matrix of
the program or of the reference makes it.

A traffic mix is a data file (``gpubench/traffic/<mix>.json``) of
parameters that this module reads: how many slices a request carries, the
pool they cycle through, and the public solver and arguments a request
calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64

# the modified Shepp-Logan ellipses: (value, a, b, x0, y0, phi in degrees)
SHEPP_LOGAN = np.array([
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
])
MAX_EXTRA = 3
# the fan's half-angle over the half-diagonal's: fixed in the program
# (``problems/ct.py``'s ``FanBeamGeometry.fan_margin``), as in the reference
FAN_MARGIN = 1.05


def phantoms(rng: np.random.Generator, count: int) -> np.ndarray:
    """(count, 13, 6) ellipses (value, a, b, x0, y0, phi) in the unit
    square's coordinates; an unused extra row is a unit circle of value 0."""
    out = np.zeros((count, len(SHEPP_LOGAN) + MAX_EXTRA, 6))
    for s in range(count):
        e = SHEPP_LOGAN.copy()
        e[:, 1:3] *= rng.uniform(0.9, 1.1, size=(len(e), 2))
        e[:, 3:5] += rng.normal(0.0, 0.02, size=(len(e), 2))
        e[:, 5] += rng.normal(0.0, 5.0, size=len(e))
        e[2:, 0] *= rng.uniform(0.7, 1.3, size=len(e) - 2)
        extra = np.tile([0.0, 1.0, 1.0, 0.0, 0.0, 0.0], (MAX_EXTRA, 1))
        for j in range(rng.integers(0, MAX_EXTRA + 1)):
            r, t = 0.5 * math.sqrt(rng.uniform()), rng.uniform(0, 2 * math.pi)
            extra[j] = (rng.choice([-0.1, 0.1, 0.2]), rng.uniform(0.02, 0.08),
                        rng.uniform(0.02, 0.08), r * math.cos(t),
                        r * math.sin(t), rng.uniform(0, 180))
        out[s] = np.concatenate([e, extra])
    return out


def ray_geometry(geometry: dict, device):
    """Source points and unit directions of every ray, (m, 2) each, in
    pixel coordinates (the image spans [-n/2, n/2]^2)."""
    n, na, nd = geometry["n"], geometry["n_angles"], geometry["n_det"]
    radius = geometry["source_radius_factor"] * n
    gmax = FAN_MARGIN * math.asin(
        min(n * math.sqrt(2.0) / 2.0 / radius, 1.0))
    phi = torch.arange(na, dtype=F64, device=device) * (2.0 * math.pi / na)
    gam = (torch.arange(nd, dtype=F64, device=device) + 0.5) / nd * 2 * gmax \
        - gmax
    ang = (phi + math.pi)[:, None] + gam[None, :]
    src = torch.stack([radius * torch.cos(phi), radius * torch.sin(phi)], 1)
    src = src[:, None, :].expand(na, nd, 2).reshape(-1, 2)
    dirs = torch.stack([torch.cos(ang), torch.sin(ang)], -1).reshape(-1, 2)
    return src, dirs


def line_integrals(geometry: dict, ellipses: np.ndarray, device) -> torch.Tensor:
    """(m, S) float64: each slice's exact line integrals along every ray
    (the chord of each ellipse times its value, summed)."""
    n = geometry["n"]
    src, dirs = ray_geometry(geometry, device)
    E = torch.as_tensor(ellipses, dtype=F64, device=device)   # (S, K, 6)
    val, a, b = E[..., 0], E[..., 1] * n / 2, E[..., 2] * n / 2
    cx, cy = E[..., 3] * n / 2, E[..., 4] * n / 2
    t = torch.deg2rad(E[..., 5])
    c, s = torch.cos(t), torch.sin(t)
    out = torch.zeros((src.shape[0], E.shape[0]), dtype=F64, device=device)
    for k in range(E.shape[1]):
        # the ray in the frame of ellipse k of every slice, axes scaled to 1
        px = src[:, 0:1] - cx[:, k]
        py = src[:, 1:2] - cy[:, k]
        ux = (px * c[:, k] + py * s[:, k]) / a[:, k]
        uy = (-px * s[:, k] + py * c[:, k]) / b[:, k]
        dx = (dirs[:, 0:1] * c[:, k] + dirs[:, 1:2] * s[:, k]) / a[:, k]
        dy = (-dirs[:, 0:1] * s[:, k] + dirs[:, 1:2] * c[:, k]) / b[:, k]
        qa = dx * dx + dy * dy
        qb = ux * dx + uy * dy
        disc = qb * qb - qa * (ux * ux + uy * uy - 1.0)
        chord = 2.0 * torch.sqrt(torch.clamp(disc, min=0.0)) / qa
        out += val[:, k] * chord
    return out


def slice_pool(cfg: dict, traffic: dict, seed: int, device):
    """The pool of noisy sinograms, (m, pool) float32 on ``device``, made
    from ``seed``: the ellipses from a numpy generator, the noise from a
    torch generator on the device, one call each."""
    count = traffic["pool_slices"]
    rng = np.random.default_rng(seed)
    b_exact = line_integrals(cfg, phantoms(rng, count), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    e = torch.randn(b_exact.shape, generator=gen, dtype=F64, device=device)
    e *= cfg["noise"] * torch.linalg.vector_norm(b_exact, dim=0) \
        / torch.linalg.vector_norm(e, dim=0)
    return (b_exact + e).to(torch.float32)


def request_slices(traffic: dict, index: int) -> list:
    """The pool columns that request ``index`` carries: requests take the
    pool's slices in turn, ``slices_per_request`` at a time."""
    k, pool = traffic["slices_per_request"], traffic["pool_slices"]
    start = (index * k) % pool
    return [(start + j) % pool for j in range(k)]


def distinct_requests(traffic: dict) -> int:
    """How many requests differ before the cycle through the pool repeats."""
    k, pool = traffic["slices_per_request"], traffic["pool_slices"]
    return pool // math.gcd(k, pool)
