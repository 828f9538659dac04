#!/usr/bin/env python3
"""Independent witness for the CT quality gates: the JAX package alone.

    JAX_PLATFORMS=cpu python3 scripts_torch/witness_ct.py [--n 64|128]

Runs the bench scenario (``bench.py``: CT n with 180*n/64 angles and
detectors, Morton relabelling, 25% noise from seed 0 drawn in original ray
order, hybrid BA-GMRES at maxit=100, lam=1e-2, residual="fused") through
the JAX package on the host CPU in float64, with a plain-JAX CSR operator
(``segment_sum`` over the nonzeros) instead of the Pallas kernel, so no
code of the PyTorch port computes the answer.  Two operators are solved:

  * ``f32``: the float32-rounded A and B that the panels are packed from;
  * ``int8``: diag(s) Q, the exactly quantized matrices the int8 panels
    hold, from the JAX package's ``_row_quantize_csr``.

It also checks that the port's ``ct_mismatched`` assembles exactly the JAX
package's arrays (A, B, b_exact, x_true) at this size.  Prints one JSON line
per check; the min-over-k relative errors are what the gates are anchored
to.  Needs about 3 GB of host memory at n=128.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def csr_operator(csr):
    """A JAX ``LinearOperator`` applying a scipy CSR matrix in float64."""
    from hybrid_gmres_tpu.ops.linear_operator import LinearOperator

    @jax.tree_util.register_pytree_node_class
    class CSROperator(LinearOperator):
        def __init__(self, data, indices, rows, shape):
            self.data, self.indices, self.rows = data, indices, rows
            self.shape = shape

        @property
        def dtype(self):
            return self.data.dtype

        def matvec(self, v):
            return jax.ops.segment_sum(
                self.data * v[self.indices], self.rows,
                num_segments=self.shape[0], indices_are_sorted=True)

        def tree_flatten(self):
            return (self.data, self.indices, self.rows), self.shape

        @classmethod
        def tree_unflatten(cls, shape, children):
            return cls(*children, shape)

    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int32),
                     np.diff(csr.indptr))
    return CSROperator(jnp.asarray(csr.data, jnp.float64),
                       jnp.asarray(csr.indices, jnp.int32),
                       jnp.asarray(rows), tuple(csr.shape))


def check_assembly(n, ang):
    """The port's CT arrays equal the JAX package's, bit for bit."""
    from hybrid_gmres_tpu.problems.ct import ct_mismatched as jax_ct
    from hybrid_gmres_tpu_torch.problems.ct import ct_mismatched as port_ct

    jp = jax_ct(n=n, n_angles=ang, n_det=ang, dense=False)
    tp = port_ct(n=n, n_angles=ang, n_det=ang)
    same = {}
    for name in ("A_csr", "B_csr"):
        a, b = getattr(jp, name), getattr(tp, name)
        same[name] = bool(a.shape == b.shape and a.nnz == b.nnz
                          and np.array_equal(a.indptr, b.indptr)
                          and np.array_equal(a.indices, b.indices)
                          and np.array_equal(a.data, b.data))
    for name in ("b_exact", "x_true"):
        same[name] = bool(np.array_equal(np.asarray(getattr(jp, name)),
                                         getattr(tp, name)))
    print(json.dumps({"check": "assembly_equal", "n": n, **same}),
          flush=True)
    return jp, all(same.values())


def scenario(prob):
    """bench.py's operators and data: the float32 A and B relabelled by
    Morton order, and the noisy sinogram (float32, 25% noise from seed 0
    drawn in original ray order, then relabelled; bench.py:119-124).
    Returns ``(A, B, b, ray_perm, pix_perm)``."""
    from hybrid_gmres_tpu.ops.ordering import morton_perm, reorder_pair

    g = prob.geom
    ray_perm = morton_perm(g.n_angles, g.n_det)
    pix_perm = morton_perm(g.n, g.n)
    A, B = reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32), ray_perm, pix_perm)
    b_exact = np.asarray(prob.b_exact, np.float32)
    rng = np.random.default_rng(0)
    e = rng.standard_normal(b_exact.shape)
    e = e / np.linalg.norm(e) * 0.25 * float(np.linalg.norm(b_exact))
    b = (b_exact + e.astype(np.float32))[ray_perm]
    return A, B, b, ray_perm, pix_perm


def solve(prob, quantize, maxit=100, lam=1e-2):
    """The bench scenario through the JAX solver in float64; returns the
    error history."""
    from hybrid_gmres_tpu.ops.spmv_pallas import _row_quantize_csr
    from hybrid_gmres_tpu.solvers.gmres import ba_gmres

    import scipy.sparse as sp

    A, B, b, _, pix_perm = scenario(prob)
    A, B = A.astype(np.float64), B.astype(np.float64)
    if quantize:
        A, B = ((sp.diags(s.astype(np.float64)) @ q).tocsr()
                for q, s in (_row_quantize_csr(A), _row_quantize_csr(B)))

    run = jax.jit(lambda A_, B_, b_, x_: ba_gmres(
        A_, B_, b_, x_, tol=0.0, maxit=maxit, lam=lam, residual="fused"))
    t0 = time.perf_counter()
    r = run(csr_operator(A), csr_operator(B),
            jnp.asarray(b, jnp.float64),
            jnp.asarray(prob.x_true[pix_perm], jnp.float64))
    err = np.asarray(jax.block_until_ready(r.err_hist))
    k = int(np.argmin(err))
    g = prob.geom
    print(json.dumps({
        "check": "jax_float64_solve", "n": g.n,
        "operator": "int8" if quantize else "f32", "maxit": maxit,
        "lam": lam, "niters": int(r.niters), "min_err": float(err[k]),
        "min_err_k": k + 1, "final_err": float(err[-1]),
        "seconds": time.perf_counter() - t0}), flush=True)
    if not (np.isfinite(err).all() and int(r.niters) == maxit):
        sys.exit(f"n={g.n}: the JAX solve did not run {maxit} finite steps")
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=128, choices=(16, 64, 128))
    args = ap.parse_args()
    ang = 180 * args.n // 64
    prob, same = check_assembly(args.n, ang)
    for quantize in (False, True):
        solve(prob, quantize)
    if not same:
        sys.exit(f"n={args.n}: the port's CT arrays differ from the JAX "
                 "package's")


if __name__ == "__main__":
    main()
