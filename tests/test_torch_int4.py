"""PyTorch port: int4 panels against the JAX package.

The JAX package stores int4 operators as nibble pairs along the block axis
of its block-ELL panels (``packed4``).  The port takes those panels, unpacks
them into logical int8 blocks, and stores the values of its row-packed
forms as nibble pairs (two entries a byte).  Its four int4 products take
their plain PyTorch versions on CPU tensors; the JAX kernels run in
interpret mode on the same numpy inputs.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.ops import sparse as jsparse
from hybrid_gmres_tpu.ops import spmv_pallas as jspmv
from hybrid_gmres_tpu_torch.ops import sparse as tsparse
from hybrid_gmres_tpu_torch.ops import spmv_cuda as tspmv
from hybrid_gmres_tpu_torch.utils.convert import (
    bell_from_numpy,
    operator_from_numpy,
)

# Both packages multiply the same int4 values by the same float32 vector
# and accumulate in float32; only the summation order differs:
# ||y_port - y_jax||_inf <= 1e-5 ||y_jax||_inf.
RTOL = 1e-5


def _ct16_csr_pair():
    from hybrid_gmres_tpu.ops.ordering import morton_perm, reorder_pair
    from hybrid_gmres_tpu.problems.ct import ct_mismatched

    prob = ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    g = prob.geom
    return reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32),
                        morton_perm(g.n_angles, g.n_det),
                        morton_perm(g.n, g.n))


def _source(name):
    """(csr, block) of a test matrix: random, or CT n=16's A or B."""
    if name == "random":
        return sp.random(300, 260, density=0.05, format="csr",
                         random_state=np.random.RandomState(1),
                         dtype=np.float64), (8, 128)
    A, B = _ct16_csr_pair()
    return (A, (32, 128)) if name == "ct16_A" else (B, (8, 128))


def _leaves(bell):
    return dict(buckets=[(np.asarray(b), np.asarray(c))
                         for b, c in bell.buckets],
                inv_perm=np.asarray(bell.inv_perm), shape=bell.shape,
                ncb=bell.ncb, packed4=bell.packed4)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def test_nibble_codec_round_trip():
    """Every int4 value in every slot: pack then unpack is the identity,
    the zero entry packs to a zero nibble, and the bytes are the JAX
    package's (``_pack_int4``'s lo | hi << 4, decoded by its shifts)."""
    vals = np.array([v for v in range(-8, 8) for _ in range(2)] +
                    [w for w in range(-8, 8) for _ in range(2)], np.int8)
    vals = np.concatenate([vals, np.roll(vals, 3)])
    packed = tsparse.pack_nibbles(torch.from_numpy(vals))
    assert packed.dtype == torch.int8 and packed.numel() == vals.size // 2
    np.testing.assert_array_equal(
        tsparse.unpack_nibbles(packed).numpy(), vals)
    lo, hi = jsparse.unpack_nibbles(jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(np.asarray(lo), vals[0::2])
    np.testing.assert_array_equal(np.asarray(hi), vals[1::2])
    assert tsparse.pack_nibbles(torch.zeros(8, dtype=torch.int8)).eq(0).all()


@pytest.mark.parametrize("source", ["random", "ct16_A", "ct16_B"])
def test_packed4_container_and_forms_from_jax_panels(source):
    """The JAX package's packed4 panel through ``bell_from_numpy``: the
    logical int8 blocks (in [-7, 7]) are the JAX panel's nibbles, the block
    columns and the permutation are kept, and the port's own int4 packer
    gives the same panel.  The int4 forms hold the same entries as the int8
    forms of the same Q (same pack order, lanes and padding), two a byte:
    fewer bytes than the int8 forms."""
    csr, block = _source(source)
    csr_q, _ = jspmv._row_quantize_csr(csr, qmax=7)
    jb = jsparse.bucketed_block_ell_from_csr(csr_q, block=block,
                                             pack_int4=True)
    assert jb.packed4
    tb = bell_from_numpy(device="cpu", **_leaves(jb))
    own = tsparse.bucketed_block_ell_from_csr(csr_q, block=block,
                                              pack_int4=True, device="cpu")
    assert tb.packed4 and own.packed4 and tb.dtype == torch.int8
    for (bj, cj), (bt, ct), (bo, co) in zip(jb.buckets, tb.buckets,
                                            own.buckets):
        lo, hi = jsparse.unpack_nibbles(bj)
        logical = np.stack([np.asarray(lo), np.asarray(hi)], axis=2).reshape(
            bt.shape)
        np.testing.assert_array_equal(bt.numpy(), logical)
        np.testing.assert_array_equal(bo.numpy(), logical)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(co.numpy(), np.asarray(cj))
    assert int(tb.blocks_flat.abs().max()) <= 7
    np.testing.assert_array_equal(tb.inv_perm.numpy(), np.asarray(jb.inv_perm))

    int8_bell = tsparse.bucketed_block_ell_from_csr(
        csr_q, block=block, dtype=np.int8, device="cpu")
    for transpose in (False, True):
        f4 = tsparse.row_packed_from_bell(tb, transpose=transpose)
        f8 = tsparse.row_packed_from_bell(int8_bell, transpose=transpose)
        assert f4.packed4 and not f8.packed4 and f4.value_bits == 4
        assert (f4.shape, f4.lanes, f4.live, f4.group) == \
            (f8.shape, f8.lanes, f8.live, f8.group)
        np.testing.assert_array_equal(f4.cols.numpy(), f8.cols.numpy())
        np.testing.assert_array_equal(f4.vec_off.numpy(), f8.vec_off.numpy())
        np.testing.assert_array_equal(f4.row_map.numpy(), f8.row_map.numpy())
        np.testing.assert_array_equal(f4.entry_values().numpy(),
                                      f8.vals.numpy())
        assert f4.vals.numel() * 2 == f8.vals.numel()
        assert f4.fill == f8.fill
        assert f4.nbytes < f8.nbytes, (f4.nbytes, f8.nbytes)


@pytest.mark.parametrize("product", ["K1", "K3", "K2", "K4"])
@pytest.mark.parametrize("source", ["random", "ct16_A"])
def test_int4_products_match_jax_interpret(source, product):
    """The four int4 products of the port's operator (plain versions of the
    redesigned K1-K4 on the nibble-packed forms) against the JAX
    ``PallasBSROperator`` on the same packed4 panels, its ``packed4``
    Pallas kernels in interpret mode (K3/K4 from the forward panel:
    ``with_adjoint=False``), float32, rel 1e-5."""
    csr, block = _source(source)
    jop = jspmv.PallasBSROperator.from_csr(csr, block=block, dtype="int4",
                                           with_adjoint=False, interpret=True)
    top = operator_from_numpy(_leaves(jop.fwd),
                              fwd_scale=np.asarray(jop.fwd_scale),
                              device="cpu")
    assert top.storage_dtype == torch.int4 and top.dtype == torch.float32
    assert top.fwd_rows.packed4 and top.adj_rows.packed4
    m, n = csr.shape
    rng = np.random.default_rng(3)
    R = 5
    v = {"K1": rng.standard_normal(n), "K3": rng.standard_normal(m),
         "K2": rng.standard_normal((n, R)),
         "K4": rng.standard_normal((m, R))}[product].astype(np.float32)
    fn = {"K1": "matvec", "K3": "rmatvec", "K2": "matmat",
          "K4": "rmatmat"}[product]
    want = np.asarray(getattr(jop, fn)(jnp.asarray(v)))
    got = getattr(top, fn)(torch.from_numpy(v)).numpy()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("transpose", [False, True])
def test_int4_k2r_column_equals_k1r_bit_for_bit(transpose):
    """Column j of the int4 K2 (K4) plain product is the int4 K1 (K3) on
    column j, bit for bit: the same decoded values summed in the same fixed
    order."""
    csr, block = _source("ct16_B")
    op = tspmv.BlockELLOperator.from_csr(csr, block=block, dtype="int4",
                                         with_adjoint=False, device="cpu")
    m, n = op.shape
    rng = np.random.default_rng(5)
    if transpose:
        U = torch.from_numpy(rng.standard_normal((m, 7)).astype(np.float32))
        Y = op.rmatmat(U)
        cols = [op.rmatvec(U[:, j].contiguous()) for j in range(7)]
    else:
        X = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))
        Y = op.matmat(X)
        cols = [op.matvec(X[:, j].contiguous()) for j in range(7)]
    for j, y in enumerate(cols):
        assert torch.equal(Y[:, j], y), j


def test_int4_operator_quantizes_once():
    """``from_csr(dtype="int4")``: one per-row quantization with qmax=7 (the
    JAX package's scales), int4 storage reported, float32 compute; with an
    adjoint panel, the adjoint holds the same Q^T, so <A x, u> equals
    <x, A^T u> to float32 rounding, and the int4 forms are smaller than the
    int8 forms of the same matrix."""
    csr, block = _source("ct16_A")
    op = tspmv.BlockELLOperator.from_csr(csr, block=block, dtype="int4",
                                         with_adjoint=True, device="cpu")
    op8 = tspmv.BlockELLOperator.from_csr(csr, block=block, dtype="int8",
                                          with_adjoint=False, device="cpu")
    _, s = jspmv._row_quantize_csr(csr, qmax=7)
    np.testing.assert_array_equal(op.fwd_scale.numpy(), s)
    assert op.storage_dtype == torch.int4 and op.dtype == torch.float32
    assert op.fwd.packed4 and op.adj.packed4
    assert op.fwd_rows.nbytes < op8.fwd_rows.nbytes
    assert op.adj_rows.nbytes < op8.adj_rows.nbytes
    m, n = op.shape
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    Ax, ATu = op.matvec(x), op.rmatvec(u)
    gap = abs(float(Ax @ u) - float(x @ ATu))
    assert gap <= 1e-5 * float(torch.linalg.vector_norm(Ax)
                               * torch.linalg.vector_norm(u))


def test_int4_ct16_solve_matches_jax():
    """CT n=16 (24x24 rays) through ``ct_tpu_operators(dtype="int4")`` and
    the JAX ``ba_gmres`` (packed4 Pallas kernels in interpret mode) against
    ``ct_gpu_operators(dtype="int4")`` and the port's ``ba_gmres`` (plain
    int4 K1 on the CPU): the same scales and panels, and res/err histories
    and x within 1e-5 of the max entry (float32 products in a float64
    solve, other summation orders, 10 Krylov steps)."""
    from hybrid_gmres_tpu.problems import ct as jct
    from hybrid_gmres_tpu.solvers.gmres import ba_gmres as jba
    from hybrid_gmres_tpu_torch.problems import ct as tct
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres as tba

    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    jA, jB, jb, jx, _, _ = jct.ct_tpu_operators(jp, dtype="int4")
    jA.interpret = jB.interpret = True
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    tA, tB, tb, tx, _, _ = tct.ct_gpu_operators(tp, dtype="int4",
                                                device="cpu")
    for jo, to in ((jA, tA), (jB, tB)):
        assert to.storage_dtype == torch.int4 and jo.fwd.packed4
        np.testing.assert_array_equal(np.asarray(jo.fwd_scale),
                                      to.fwd_scale.numpy())
        for (bj, _), (bt, _) in zip(jo.fwd.buckets, to.fwd.buckets):
            lo, hi = jsparse.unpack_nibbles(bj)
            np.testing.assert_array_equal(
                np.stack([np.asarray(lo), np.asarray(hi)], axis=2).reshape(
                    bt.shape), bt.numpy())
    kw = dict(tol=0.0, maxit=10, lam=1e-2, residual="fused")
    jr = jba(jA, jB, jb, jx, **kw)
    tr = tba(tA, tB, tb, tx, **kw)
    assert int(tr.niters) == int(jr.niters) == 10
    for name in ("res_hist", "err_hist", "x"):
        want = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
