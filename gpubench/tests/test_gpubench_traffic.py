"""The traffic generator: deterministic per seed, distinct slices, noise
at the configuration's level, requests cycling through the pool."""

import numpy as np
import pytest
import torch

from gpubench.lib import scanner, spec

CFG = dict(n=16, n_angles=24, n_det=24, source_radius_factor=2.0,
           noise=0.25)
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", ["frame8", "rtp1"])
def test_pool_same_seed_same_slices(mix):
    traffic = dict(spec.traffic(mix), pool_slices=16)
    a = scanner.slice_pool(CFG, traffic, SEED, "cpu")
    b = scanner.slice_pool(CFG, traffic, SEED, "cpu")
    c = scanner.slice_pool(CFG, traffic, SEED + 1, "cpu")
    assert a.shape == (24 * 24, 16) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()
    # every slice differs from every other
    d = torch.cdist(a.T, a.T)
    assert (d + torch.eye(16) * 1e9).min() > 0


def test_noise_is_a_quarter_of_each_slice():
    rng = np.random.default_rng(3)
    ell = scanner.phantoms(rng, 4)
    exact = scanner.line_integrals(CFG, ell, "cpu")
    traffic = dict(pool_slices=4)
    pool = scanner.slice_pool(CFG, traffic, 3, "cpu").double()
    rel = torch.linalg.vector_norm(pool - exact, dim=0) \
        / torch.linalg.vector_norm(exact, dim=0)
    assert torch.allclose(rel, torch.full_like(rel, 0.25), rtol=1e-5)


def test_line_integral_of_a_disc():
    """A centred disc of radius r (pixels) has chord 2 sqrt(r^2 - d^2) for a
    ray at distance d: the central ray of each view reads 2 r."""
    r_unit = 0.5
    ell = np.array([[[1.0, r_unit, r_unit, 0.0, 0.0, 0.0]]])
    cfg = dict(CFG, n_det=25)          # an odd count: a ray through 0
    out = scanner.line_integrals(cfg, ell, "cpu")[:, 0].reshape(24, 25)
    assert torch.allclose(out[:, 12], torch.full((24,), 2 * r_unit * 8.0,
                                     dtype=torch.float64),
                          rtol=1e-12)


def test_requests_cycle_through_the_pool():
    t = dict(slices_per_request=8, pool_slices=64)
    seen = [c for i in range(8) for c in scanner.request_slices(t, i)]
    assert sorted(seen) == list(range(64))
    assert scanner.request_slices(t, 8) == scanner.request_slices(t, 0)
    assert scanner.distinct_requests(t) == 8
    assert scanner.distinct_requests(dict(slices_per_request=1,
                                          pool_slices=64)) == 64
