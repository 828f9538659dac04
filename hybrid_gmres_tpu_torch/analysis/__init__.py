from hybrid_gmres_tpu_torch.analysis.filter_factors import (
    FilterBounds,
    spectral_setup,
    filter_bounds_from_factorization,
    empirical_filter_factors,
    run_with_bounds,
)

__all__ = [
    "FilterBounds",
    "spectral_setup",
    "filter_bounds_from_factorization",
    "empirical_filter_factors",
    "run_with_bounds",
]
