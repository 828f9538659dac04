"""PyTorch port: K2 for wide right-hand-side blocks (K2w) on the tile form,
against the row-packed form, the JAX package and float64.

``wide_matmat`` takes its plain PyTorch version on CPU tensors
(``wide_matmat_plain``: the kernel's split of X into four planes of bytes
and a scale per column, the products with the stored values summed
exactly, one rounding); the JAX multi-RHS kernel ``_bucket_matmat`` runs in
interpret mode on the same numpy inputs.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.ops import spmv_pallas as jspmv
from hybrid_gmres_tpu_torch.ops import sparse as tsparse
from hybrid_gmres_tpu_torch.ops import spmv_cuda as tspmv
from hybrid_gmres_tpu_torch.utils.convert import bell_from_numpy

# Both packages multiply the same stored values by the same float32 columns
# and accumulate in float32 (the port's split of X rounds it to 2^-31 of
# its column's largest entry); only the summation order and that rounding
# differ, so ||Y_port - Y_jax||_inf <= 1e-5 ||Y_jax||_inf, as for K2r.
RTOL = 1e-5
U32 = 2.0 ** -24          # float32 unit roundoff
# the storage types with a tile form (integers: bf16 and float32 forms keep
# the row-packed form)
DTYPES = ("int8", "int4")


def _ct16_csr_pair():
    from hybrid_gmres_tpu.ops.ordering import morton_perm, reorder_pair
    from hybrid_gmres_tpu.problems.ct import ct_mismatched

    prob = ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    g = prob.geom
    return reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32),
                        morton_perm(g.n_angles, g.n_det),
                        morton_perm(g.n, g.n))


CT16 = dict(zip(("A", "B"), _ct16_csr_pair()))


def _wide_csr():
    """A matrix with more columns than a 16-bit index addresses (the row
    form takes 32-bit indices), with a block of empty rows wider than a
    panel and scattered empty rows."""
    rng = np.random.default_rng(7)
    m, n = 300, 70000
    rows = np.repeat(np.arange(m), 12)
    cols = (rows * 233 + rng.integers(0, 300, rows.size)) % n
    keep = ~((rows >= 64) & (rows < 200)) & (rows % 7 != 3)
    csr = sp.csr_matrix((rng.standard_normal(keep.sum()),
                         (rows[keep], cols[keep])), shape=(m, n))
    csr.sum_duplicates()
    return csr


def _source(name):
    return _wide_csr() if name == "wide" else CT16[name]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _op(csr, dtype, block=(8, 128)):
    return tspmv.BlockELLOperator.from_csr(csr, block=block, dtype=dtype,
                                           with_adjoint=False, device="cpu")


def _tile_coo(tp):
    """The (row, column, value) triplets the tile form stores, nonzeros
    only, sorted."""
    pos, chunk, group = tp.tile_index()
    vals = tp.tile_values()[pos]                      # (tiles, 16, 16)
    t, r, k = torch.nonzero(vals, as_tuple=True)
    row = group[t] * tsparse.TILE + r
    col = chunk[t] * tsparse.TILE + k
    order = np.lexsort((col.numpy(), row.numpy()))
    return (row.numpy()[order], col.numpy()[order],
            vals[t, r, k].to(torch.float64).numpy()[order])


def _row_coo(rp):
    """The same triplets from the row-packed form."""
    src, cols, *_ = rp.sum_order
    vec_row, _ = tsparse.pack_positions(rp.vec_off, rp.lanes)
    rows = rp.row_map.long()[vec_row.repeat_interleave(tsparse.VEC)[src]]
    vals = rp.entry_values()[src].to(torch.float64)
    nz = vals != 0
    row, col, val = rows[nz].numpy(), cols[nz].numpy(), vals[nz].numpy()
    order = np.lexsort((col, row))
    return row[order], col[order], val[order]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("source", ["A", "B", "wide"])
def test_tile_form_holds_the_row_forms_matrix(source, dtype):
    """The tile form built from a panel stores exactly the entries of the
    row-packed form of the same panel (16-bit indices for CT n=16's A and
    B, 32-bit for the wide matrix): same rows, columns and values.  Its
    layout: panels of 64 rows in the operator's row order, each row
    group's run of tiles on a multiple of the tiles one load fetches, the
    padding tiles zero, every entry's mask naming its row groups' tiles."""
    op = _op(_source(source), dtype)
    rp, tp = op.fwd_rows, tsparse.tile_packed_from_bell(op.fwd)
    assert rp.wide == (source == "wide")
    assert tp.shape == rp.shape and tp.live == rp.live
    assert tp.packed4 == (dtype == "int4")
    assert tp.value_bits == {"int8": 8, "int4": 4}[dtype]
    assert tp.panels == -(-tp.shape[0] // tsparse.PANEL_ROWS)
    for a, b in zip(_tile_coo(tp), _row_coo(rp)):
        np.testing.assert_array_equal(a, b)
    g = tp.tiles_per_load
    rg_off = tp.rg_off.long()
    assert bool((rg_off % g == 0).all()) and int(rg_off[0]) == 0
    assert tp.vals.numel() * tp.vals.element_size() == \
        int(rg_off[-1]) // g * 512
    pos, chunk, group = tp.tile_index()
    masks = tp.ent.long() & 15
    assert pos.numel() == tp.tiles == int(sum(
        ((masks >> w) & 1).sum() for w in range(tsparse.ROW_GROUPS)))
    assert sorted(pos.tolist()) == sorted(set(pos.tolist()))
    slots = tp.tile_values()
    padding = torch.ones(slots.shape[0], dtype=torch.bool)
    padding[pos] = False
    assert not bool(slots[padding].any())
    assert bool((slots[pos].reshape(pos.numel(), -1) != 0).any(1).all())
    # a row group's tiles in ascending chunk order, inside its run
    assert bool((pos >= rg_off[group]).all() and (pos < rg_off[group + 1])
                .all())
    key = group * tp.chunks + chunk
    assert bool((key[torch.argsort(pos)].diff() > 0).all())


def _jax_matmat(csr, dtype, X, block=(8, 128)):
    """The JAX operator's K2 (``bucketed_bsr_matmat`` in interpret mode,
    the row scale applied as ``PallasBSROperator`` applies it) and the
    port's tile form of the same panel."""
    jop = jspmv.PallasBSROperator.from_csr(
        csr, block=block, dtype=dtype if dtype == "int4" else jnp.dtype(
            dtype), n_buckets=2, with_adjoint=False, interpret=True,
        row_group=1)
    Y = np.asarray(jspmv.bucketed_bsr_matmat(jop.fwd, jnp.asarray(X),
                                             interpret=True), np.float64)
    s = None if jop.fwd_scale is None else np.array(jop.fwd_scale)
    bell = bell_from_numpy(
        device="cpu", buckets=[(np.asarray(b), np.asarray(c))
                               for b, c in jop.fwd.buckets],
        inv_perm=np.asarray(jop.fwd.inv_perm), shape=jop.fwd.shape,
        ncb=jop.fwd.ncb, packed4=jop.fwd.packed4)
    return (Y if s is None else s[:, None] * Y), bell, s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("source", ["A", "B"])
def test_plain_version_matches_jax_interpret_kernel(source, dtype):
    """``wide_matmat`` (its plain version on CPU tensors) on the tile form
    built from the JAX package's own panel against ``_bucket_matmat`` in
    interpret mode at R = 33, and at R = 16 and 20 on its first columns
    (the same inputs; R = 20 and 33 ragged against the 8-column blocks of
    the kernel), in the row-major and the basis' layout."""
    csr = _source(source)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((csr.shape[1], 33)).astype(np.float32)
    want, bell, s = _jax_matmat(csr, dtype, X)
    tp = tsparse.tile_packed_from_bell(bell)
    st = None if s is None else torch.from_numpy(s)
    for R in (16, 20, 33):
        XR = X[:, :R]
        for Xt in (torch.from_numpy(np.ascontiguousarray(XR)),
                   torch.from_numpy(np.ascontiguousarray(XR.T)).T):
            Y = tspmv.wide_matmat(tp, Xt, st)
            assert Y.shape == (csr.shape[0], R) and Y.dtype == torch.float32
            _close(Y.numpy(), want[:, :R])


def test_split_of_x():
    """The split of X per column into four planes of bytes and a
    power-of-two scale: ``M = 2^24 b0 + 2^16 b1 + 2^8 b2 + b3`` with b0 in
    [-128, 127] and the others in [0, 255] (all exact in bf16 and in
    s8/u8), and ``scale M`` within half a unit (``2^(E-31)``) of x, ``2^E``
    the column's largest |x|'s binade: exact for x on that unit's grid
    (every x within 2^7 of the largest; powers of two within 30 binades);
    a zero column is zero, a non-finite one has a NaN scale."""
    rng = np.random.default_rng(3)
    ncols, R = 16 * 40 + 5, 7
    x = rng.standard_normal((ncols, R)) * 2.0 ** rng.integers(
        -30, 30, (ncols, R))
    x[:, 0] = 0.0                        # a zero column
    x[:, 1] = 2.0 ** np.append(rng.integers(-30, 1, ncols - 1), 0)
    x[::3, 1] *= -1
    x[40, 2] = np.inf
    # every entry within 2^7 of the column's largest: exact
    x[:, 3] = rng.uniform(1.0, 127.0, ncols) * np.sign(rng.standard_normal(ncols))
    X = torch.from_numpy(x.astype(np.float32))
    chunks = -(-ncols // 16)
    planes, scale = tspmv.split_planes(X, chunks)
    assert planes.shape == (4, chunks, 16, R) and scale.shape == (R,)
    assert torch.equal(planes, planes.round())
    b = [q.reshape(-1, R).double() for q in planes]
    assert float(b[0].min()) >= -128 and float(b[0].max()) <= 127
    for q in b[1:]:
        assert float(q.min()) >= 0 and float(q.max()) <= 255
    assert torch.equal(planes.to(torch.bfloat16).to(torch.float32), planes)
    V = torch.zeros((chunks * 16, R), dtype=torch.float64)
    V[:ncols] = X.double()
    M = ((b[0] * 256 + b[1]) * 256 + b[2]) * 256 + b[3]
    assert float(M.abs().max()) < 2 ** 31
    back = scale.double() * M
    finite = torch.isfinite(scale)
    assert finite.tolist() == [True, True, False] + [True] * (R - 3)
    err = (back - V).abs()[:, finite]
    assert bool((err <= 0.5 * scale.double()[finite]).all())
    assert float(scale[0]) == 0 and not bool(M[:, 0].any())
    assert torch.equal(back[:, 1], V[:, 1])
    assert torch.equal(back[:, 3], V[:, 3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_products_within_the_rounding_of_x(dtype):
    """The plain version (the kernel's arithmetic) against the float64
    product on the form's values, row by row: within the rounding of X to
    the unit ``2^(E-30)`` of its column, sum_j |q_ij| 2^(E-31), and the one
    rounding of the result to float32, on X whose entries span 2^-20..2^20;
    on a Gaussian X (the solvers' vectors) the largest error relative to
    the largest entry is at most twice the row form's FMA chain's."""
    csr = CT16["A"]
    op = _op(csr, dtype)
    tp = tsparse.tile_packed_from_bell(op.fwd)
    rng = np.random.default_rng(5)
    pos, chunk, group = tp.tile_index()
    Q = tp.tile_values()[pos].double()
    s = op.fwd_scale.double()[:, None] if op.fwd_scale is not None else 1.0
    rows, ncols = csr.shape

    def by_row(per_tile):
        out = torch.zeros((tp.rg_off.numel() - 1, 16, per_tile.shape[-1]),
                          dtype=torch.float64)
        out.index_add_(0, group, per_tile)
        return s * out.reshape(-1, per_tile.shape[-1])[:rows]

    for spread in (20, 0):
        X = rng.standard_normal((ncols, 24)).astype(np.float32)
        X *= 2.0 ** rng.integers(-spread, spread + 1, X.shape)
        Xt = torch.from_numpy(X)
        Y = tspmv.wide_matmat(tp, Xt, op.fwd_scale).double()
        Xg = torch.nn.functional.pad(Xt.double(),
                                     (0, 0, 0, tp.chunks * 16 - ncols))
        Xg = Xg.view(tp.chunks, 16, -1)[chunk]
        _, col_scale = tspmv.split_planes(Xt, tp.chunks)
        exact = by_row(Q @ Xg)
        bound = by_row(Q.abs().sum(2, keepdim=True).expand(-1, -1, 24)
                       * (0.5 * col_scale.double())) \
            + U32 * exact.abs() * 1.01
        assert bool(((Y - exact).abs() <= bound).all())
        if spread == 0:
            Yr = tspmv.row_matmat(op.fwd_rows, Xt, op.fwd_scale).double()
            err_w = float((Y - exact).abs().max() / exact.abs().max())
            err_r = float((Yr - exact).abs().max() / exact.abs().max())
            assert err_w <= 2 * err_r, (err_w, err_r)


@pytest.mark.parametrize("dtype", ["int8", "int4", "bfloat16", "float32"])
def test_routing_rule(dtype):
    """K2w takes a forward multi-RHS product on the card when the form holds
    int8 or int4 values, R >= R_WIDE and the work (stored entries times
    columns) reaches WIDE_WORK; bf16 and f32 forms and every product of at
    most 12 columns (serving, the GKB batch, the sharded and tiled
    products) keep K2r; the CPU keeps the row form's plain version at every
    R, and builds no tile form."""
    assert tspmv.R_WIDE >= 16
    op = _op(CT16["B"], dtype)
    rp = op.fwd_rows
    integers = dtype in DTYPES
    for live in (rp.live, tspmv.WIDE_WORK // 16, 10 ** 9):
        big = dataclasses.replace(rp, live=live)
        for R in (1, 3, 5, 8, 12, 15, 16, 20, 80, 100, 200):
            want = (integers and R >= tspmv.R_WIDE
                    and live * R >= tspmv.WIDE_WORK)
            assert tspmv.takes_tiles(big, R, "cuda") is want
            assert tspmv.takes_tiles(big, R, torch.device("cuda:0")) is want
            assert tspmv.takes_tiles(big, R, "cpu") is False
    assert not any(tspmv.takes_tiles(dataclasses.replace(rp, live=10 ** 12),
                                     R, "cuda") for R in range(1, 16))
    X = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (op.shape[1], 20)).astype(np.float32))
    assert torch.equal(op.matmat(X), tspmv.row_matmat_plain(
        op.fwd_rows, X, op.fwd_scale))
    out = torch.empty((op.shape[0], 20))
    op.matmat_into(X, out)
    assert torch.equal(out, op.matmat(X))
    assert op._tiles is None
    if integers:
        tp = op.fwd_tiles
        assert op.fwd_tiles is tp and op.to("cpu") is op
    else:
        with pytest.raises(TypeError):
            op.fwd_tiles


# The forms of the CT operators the card's sweep measured (chip_smoke.py's
# k2w_sweep: stored entries of the forward form) and the first swept R
# (of 16, 20, 32, 64, 80, 100, 128) at which the rule routes each to K2w:
# where K2w was faster than K2r on the card, and none where it was not.
SWEPT = {"n=64 A int8": (3163656, 64), "n=64 B int8": (1468808, None),
         "n=128 A int8": (25298992, 16), "n=128 B int8": (11749640, 20),
         "n=64 A int4": (2584032, 80), "n=64 B int4": (1370384, None),
         "n=128 A int4": (20652408, 16), "n=128 B int4": (10955512, 20)}


@pytest.mark.parametrize("form", sorted(SWEPT))
def test_routing_rule_on_the_swept_forms(form):
    """The rule routes each swept CT form from the R at which K2w beat K2r
    on the card, and below it keeps K2r."""
    live, first = SWEPT[form]
    op = _op(CT16["A"], form.split()[-1])
    rp = dataclasses.replace(op.fwd_rows, live=live)
    routed = [R for R in (16, 20, 32, 64, 80, 100, 128)
              if tspmv.takes_tiles(rp, R, "cuda")]
    assert routed == [R for R in (16, 20, 32, 64, 80, 100, 128)
                      if first is not None and R >= first]


def test_grid_rule():
    """The kernel's grid: R's blocks of 8 columns in the fewest blocks of at
    most MAX_NT of them (shared out evenly by the kernel), each panel's
    entries in segments of at least SEGMENT_ENTRIES on average: one segment
    on CT A's panels (36 and 73 entries at n=64 and n=128), several on B's
    (279 and 557)."""
    for name, panels, ents, segs in (("n=64 B", 64, 17848, 4),
                                     ("n=128 B", 256, 142490, 8),
                                     ("n=64 A", 507, 18466, 1),
                                     ("n=128 A", 2025, 147278, 1),
                                     ("tiny", 3, 5, 1)):
        tp = tsparse.TilePacked(
            vals=torch.zeros(512, dtype=torch.int8),
            ent=torch.zeros(ents, dtype=torch.int32),
            panel_off=torch.zeros(panels + 1, dtype=torch.int32),
            rg_off=torch.zeros(tsparse.ROW_GROUPS * panels + 1,
                               dtype=torch.int32),
            shape=(tsparse.PANEL_ROWS * panels, 100), live=0, tiles=0)
        for R in (1, 16, 20, 33, 40, 41, 80, 100, 128, 300):
            nb, nseg = tspmv._wide_grid(tp, R)
            nq = -(-R // 8)
            assert nb == -(-nq // tspmv.MAX_NT), (name, R)
            assert 1 <= nb <= nq and -(-nq // nb) <= tspmv.MAX_NT
            assert nseg == segs, (name, nseg)


def test_argument_checks_and_empty_rows():
    """Shapes, types, scales and ``out`` are checked before the device is
    looked at; a float32 panel has no tile form; empty rows and
    panels (the wide matrix has 136 empty rows in a run, two panels'
    worth) come out exactly zero, and ``out=`` writes through a slab's
    strides."""
    csr = _wide_csr()
    op = _op(csr, "int8")
    tp = tsparse.tile_packed_from_bell(op.fwd)
    m, n = op.shape
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.standard_normal((n, 20)).astype(np.float32))
    with pytest.raises(ValueError, match="operator needs"):
        tspmv.wide_matmat(tp, X[:-1])
    with pytest.raises(ValueError, match="operator needs"):
        tspmv.wide_matmat(tp, X[:, 0])
    with pytest.raises(ValueError, match="scale"):
        tspmv.wide_matmat(tp, X, op.fwd_scale[:-1])
    with pytest.raises(ValueError, match="out must be"):
        tspmv.wide_matmat(tp, X, op.fwd_scale, out=torch.empty(m, 19))
    with pytest.raises(ValueError, match="unsupported device"):
        tspmv.wide_matmat(tp, X.to("meta"), None)
    with pytest.raises(TypeError):
        tsparse.tile_packed_from_bell(_op(csr, "float32").fwd)
    Y = tspmv.wide_matmat(tp, X, op.fwd_scale)
    empty = np.diff(csr.indptr) == 0
    assert empty.sum() > 2 * tsparse.PANEL_ROWS
    assert bool((Y[torch.from_numpy(empty)] == 0).all())
    assert bool((Y[torch.from_numpy(~empty)] != 0).any(1).all())
    panel_entries = (tp.panel_off[1:] - tp.panel_off[:-1])
    assert int((panel_entries == 0).sum()) >= 1
    _close(Y.numpy(), tspmv.row_matmat_plain(op.fwd_rows, X,
                                             op.fwd_scale).numpy())
    slab = torch.full((20, m + 3), float("nan"))
    got = tspmv.wide_matmat(tp, X, op.fwd_scale, out=slab[:, :m].T)
    assert got.data_ptr() == slab.data_ptr()
    assert torch.equal(slab[:, :m].T, Y) and bool(slab[:, m:].isnan().all())
