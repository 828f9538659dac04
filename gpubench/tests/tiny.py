"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
files found by name, with the geometry, the budget and the pool made
small."""

from gpubench.lib import spec

TINY = dict(n=16, n_angles=24, n_det=24, maxit=10)


def tiny_cell(name: str) -> dict:
    cell = spec.load_cell(name)
    cell["config"].update(TINY)
    cell["traffic"].update(pool_slices=16, trace_requests=2,
                           warmup_requests=1)
    return cell
