"""Row-sharded panels with static column windows (PyTorch port).

Twin of the 1-D parts of ``hybrid_gmres_tpu/parallel/panels.py``.  The CSR
rows are cut into ``p`` contiguous slabs, each packed with the single-chip
bucketed block-ELL packer (``ops/sparse.py``), and the static column window
of every slab is worked out exactly as the JAX package does:

  * **Static column windows.**  Per shard, the contiguous run of x-slabs
    (``n / p`` columns each) its panel touches.  When the union of the
    needed exchange shifts is smaller than the mesh, the input of the
    forward product is assembled from ``L`` shifts (``ppermute``, here
    ``Mesh.shift``) instead of one ``all_gather``: ``L * n/p`` values on the
    wire instead of ``(p-1) * n/p``.  Column indices are stored
    window-relative.
  * **Reduce-scatter.**  The transposed product's window-relative partial
    is placed in the global frame (:func:`scatter_window_to_full`) and one
    ``reduce_scatter`` lands it on the n-sharded basis.

Where the JAX package stacks the shards' panels, padded to mesh-uniform
shapes, under a leading device axis, the port keeps each shard as two
row-packed forms with window-relative columns (:class:`PanelShard`): the
forward form for the redesigned K1 (``row_matvec``) and the form of its
transpose for the redesigned K3 (``row_rmatvec``), both in
``csrc/row_spmv.cu``.  The bucket padding does not reach the forms, so each
shard's forms have their own lanes.  :func:`shard_bucketed_panels` builds
all shards on the host; a rank puts only its own on its device
(:func:`shard_view`).

The multi-RHS primitives (:func:`gather_window_mat`, :func:`local_matmat`,
:func:`local_rmatmat_window`, :func:`scatter_window_to_full_mat`) run the
redesigned K2 (``row_matmat``) and K4 (``row_rmatmat``) on the same forms,
with the same exchange carrying R times the payload.  Two more operator
shapes serve the sharded GKB solvers: :class:`PanelsWithAdjoint` (A and a
forward-layout panel of its transpose, so ``A^T u`` runs K1 after a gather
instead of K3 and a reduce_scatter) and :class:`ComposedPanels` (``A B`` or
``B A`` from the panels of A and of B^T, optionally B's own).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hybrid_gmres_tpu_torch.ops.sparse import (
    BucketedBlockELL,
    RowPacked,
    bucketed_block_ell_from_csr,
    row_packed_from_bell,
)
from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
    _row_quantize_csr,
    row_matmat,
    row_matvec,
    row_rmatmat,
    row_rmatvec,
)


@dataclass
class PanelShard:
    """One shard of a :class:`ShardedPanels`: its rows of A as the forward
    form (``(m/p, window)``, window-relative columns) and the form of the
    transpose (``(window, m/p)``), the int8/int4 row scales of its rows
    (None for float panels) and the first x-slab of its window."""

    fwd_rows: RowPacked
    adj_rows: RowPacked
    row_scale: torch.Tensor | None
    win_start: int

    def to(self, device) -> "PanelShard":
        return dataclasses.replace(
            self, fwd_rows=self.fwd_rows.to(device),
            adj_rows=self.adj_rows.to(device),
            row_scale=None if self.row_scale is None
            else self.row_scale.to(device))

    @property
    def nbytes(self) -> int:
        return self.fwd_rows.nbytes + self.adj_rows.nbytes


@dataclass
class ShardedPanels:
    """The shards of a row-partitioned operator, with the static window
    description the exchange needs.

    ``shards``: every shard (as :func:`shard_bucketed_panels` builds them)
    or one (a :func:`shard_view`), the first of them shard ``first``.
    Static: ``shape`` (global m, n), ``ncb`` (global block columns),
    ``win_slabs`` (window width in slabs of n/p), ``slab_blocks`` (block
    columns per slab; 0 = no window, the shard sees all n columns),
    ``shifts`` ``(dmin, L)``: the exchange shifts ``dmin .. dmin+L-1``
    (``L == p``: one all_gather), ``p``, ``packed4`` (int4 panels),
    ``fro_sq`` (p,) float32: each slab's exact ``||A_slab||_F^2``,
    ``block_shape`` and ``row_group`` of the packing."""

    shards: tuple
    shape: tuple
    ncb: int
    win_slabs: int
    slab_blocks: int
    shifts: tuple
    p: int
    block_shape: tuple
    row_group: int = 8
    packed4: bool = False
    fro_sq: torch.Tensor | None = None
    first: int = 0

    @property
    def windowed(self) -> bool:
        return self.slab_blocks > 0

    @property
    def win_blocks(self) -> int:
        """Block columns visible to the local kernels."""
        return (self.win_slabs * self.slab_blocks if self.windowed
                else self.ncb)

    @property
    def win_len(self) -> int:
        """Length of a shard's input window: ``win_slabs * n/p`` entries,
        or all n without a window."""
        return (self.win_slabs * (self.shape[1] // self.p) if self.windowed
                else self.shape[1])

    @property
    def win_start(self) -> torch.Tensor:
        """(shards,) int32: the first x-slab of each held shard's window."""
        return torch.tensor([s.win_start for s in self.shards],
                            dtype=torch.int32)

    @property
    def row_scale(self):
        """The held shards' row scales, (shards, m/p), or None."""
        if self.shards[0].row_scale is None:
            return None
        return torch.stack([s.row_scale.cpu() for s in self.shards])

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    @property
    def quantized(self) -> bool:
        """Held with per-row scales (int8/int4 from a quantizing build)."""
        return self.shards[0].row_scale is not None

    @property
    def storage_dtype(self):
        """The stored values' dtype (int8 for int4 nibble pairs)."""
        return self.shards[0].fwd_rows.dtype

    def to(self, device) -> "ShardedPanels":
        """The held shards on ``device`` (a shard already there as it is)."""
        return dataclasses.replace(
            self, shards=tuple(s.to(device) for s in self.shards))

    def local(self, index: int, device=None) -> PanelShard:
        """Shard ``index`` (of the ``p``), on ``device`` when given."""
        if len(self.shards) == self.p:
            shard = self.shards[index]
        elif len(self.shards) == 1 and self.first == index:
            shard = self.shards[0]
        else:
            raise ValueError(
                f"these panels hold shards {self.first}.."
                f"{self.first + len(self.shards) - 1} of {self.p}, not "
                f"shard {index}")
        return shard if device is None else shard.to(device)


def _panel_dtype(dtype):
    """(packer dtype, int4?, quantized?) of a storage type given as a numpy
    or torch dtype or a name."""
    if isinstance(dtype, str):
        if dtype.lower() == "int4":
            return np.int8, True, True
        dtype = getattr(torch, dtype) if dtype == "bfloat16" else dtype
    if isinstance(dtype, torch.dtype):
        if dtype == torch.int4:
            return np.int8, True, True
        if dtype == torch.bfloat16:
            return torch.bfloat16, False, False
        dtype = {torch.float32: np.float32, torch.int8: np.int8}[dtype]
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":      # ml_dtypes
        return torch.bfloat16, False, False
    return dt, False, dt == np.int8


def _live_block_columns(bell: BucketedBlockELL):
    """The block columns of a panel's nonzero blocks (int64 numpy)."""
    cols = []
    for blocks, bcols in bell.buckets:
        nz = blocks.reshape(blocks.shape[0], blocks.shape[1], -1).ne(0).any(
            dim=2)
        cols.append(bcols[nz].long().numpy())
    return np.concatenate(cols) if cols else np.zeros(0, np.int64)


def _window_relative(bell: BucketedBlockELL, offset: int, shape, ncb):
    """The panel with block columns ``c - offset`` clipped to ``[0, ncb)``
    (real blocks lie inside the window, so the clip touches padding slots
    only), logical shape ``shape`` and ``ncb`` block columns, on the
    host."""
    if offset == 0 and tuple(shape) == bell.shape and ncb == bell.ncb:
        return bell
    buckets = []
    for blocks, bcols in bell.buckets:
        blk = blocks.to(torch.float32) if blocks.dtype == torch.bfloat16 \
            else blocks
        buckets.append((blk.numpy(),
                        np.clip(bcols.numpy().astype(np.int64) - offset,
                                0, ncb - 1).astype(np.int32)))
    dtype = torch.bfloat16 if bell.dtype == torch.bfloat16 else None
    return BucketedBlockELL._from_logical(
        buckets, bell.inv_perm.numpy(), shape, ncb, bell.packed4, "cpu",
        dtype)


def _shard_forms(bell, scale, offset, win_start, shape, ncb):
    """One shard: the two forms of its window-relative panel."""
    rel = _window_relative(bell, offset, shape, ncb)
    return PanelShard(fwd_rows=row_packed_from_bell(rel),
                      adj_rows=row_packed_from_bell(rel, transpose=True),
                      row_scale=scale, win_start=int(win_start))


def _windows(panels, p, n, bc, window):
    """The JAX package's static window choice: ``(slab_blocks, S, start,
    dmin, L)`` with ``slab_blocks = 0`` when no window pays (always at
    p = 1: one shard sees all n columns)."""
    nloc = n // p if n % p == 0 else 0
    if window and p > 1 and nloc > 0 and nloc % bc == 0:
        slab_blocks = nloc // bc
        smin = np.zeros(p, np.int64)
        smax = np.zeros(p, np.int64)
        for i, pl in enumerate(panels):
            cols = _live_block_columns(pl)
            if cols.size:
                smin[i] = cols.min() // slab_blocks
                smax[i] = cols.max() // slab_blocks
        S = int((smax - smin + 1).max())
        # Window starts may run NEGATIVE or past p (slabs are fetched mod
        # p): start_i = i + e_i with e_i = clamp(e, smax_i - S + 1 - i,
        # smin_i - i) for the common offset e that minimizes the global
        # shift range L.
        ids = np.arange(p)
        lo = smax - S + 1 - ids
        hi = smin - ids
        best = None
        for e in range(int(lo.min()), int(hi.max()) + 1):
            ei = np.clip(e, lo, hi)
            Le = int(ei.max() - ei.min()) + S
            if best is None or Le < best[0]:
                best = (Le, ei)
        L, e_i = best
        if L < p:  # else one all_gather beats p shifts
            return slab_blocks, S, (ids + e_i).astype(np.int64), \
                int(e_i.min()), L
    return 0, 0, np.zeros(p, np.int64), 0, p


def shard_bucketed_panels(csr, p: int, block=(8, 128), dtype=np.float32,
                          n_buckets: int = 4, row_group: int = 8,
                          window: bool = True,
                          quantize: bool = True) -> ShardedPanels:
    """Split CSR rows into ``p`` contiguous slabs, pack each with the
    single-chip bucketed packer, work out the static column windows, and
    keep each shard as its two window-relative row-packed forms, on the
    host.

    ``dtype``: float32, bfloat16, int8 or int4 (numpy or torch dtype
    or name).  int8/int4 quantize per row once (``A ~= diag(s) Q``,
    ``qmax`` 127 / 7), shared by both forms (an exact adjoint pair);
    ``quantize=False`` stores int8 values raw (integers in [-127, 127]).
    ``window=True`` enables the windowed exchange when the column slabs are
    block-aligned (``(n/p) % bc == 0``) and the shifts it needs are fewer
    than ``p``; otherwise every shard sees all n columns through one
    all_gather."""
    m, n = csr.shape
    if m % p:
        raise ValueError(f"rows {m} not divisible by {p} shards")
    csr = csr.tocsr()
    mloc = m // p
    br, bc = block
    fro = np.zeros(p, np.float32)
    for i in range(p):
        slab = csr[i * mloc:(i + 1) * mloc]
        fro[i] = float((slab.multiply(slab)).sum())
    dt, is_int4, quantized = _panel_dtype(dtype)
    scales = [None] * p
    if quantized and quantize:
        csr, s = _row_quantize_csr(csr, qmax=7 if is_int4 else 127)
        scales = [torch.as_tensor(s[i * mloc:(i + 1) * mloc])
                  for i in range(p)]
    panels = [
        bucketed_block_ell_from_csr(
            csr[i * mloc:(i + 1) * mloc], block=block, dtype=dt,
            n_buckets=n_buckets, row_group=row_group, pack_int4=is_int4,
            device="cpu")
        for i in range(p)
    ]
    slab_blocks, S, start, dmin, L = _windows(panels, p, n, bc, window)
    sp_ = ShardedPanels(
        shards=(), shape=(m, n), ncb=panels[0].ncb, win_slabs=S,
        slab_blocks=slab_blocks, shifts=(dmin, L), p=p,
        block_shape=(br, bc), row_group=row_group, packed4=is_int4,
        fro_sq=torch.as_tensor(fro))
    return dataclasses.replace(sp_, shards=tuple(
        _shard_forms(pl, scales[i], int(start[i]) * slab_blocks, start[i],
                     (mloc, sp_.win_len), sp_.win_blocks)
        for i, pl in enumerate(panels)))


# ---------------------------------------------------------------------------
# Shard-local primitives.  Each takes panels whose first held shard is this
# rank's (a shard_view, or the panels the solver cut to this rank) and the
# mesh of the solve.
# ---------------------------------------------------------------------------

def _exchange(sp: ShardedPanels, rows, mesh, comm_dtype):
    """This shard's window of the n-sharded columns whose slabs are the
    rows of ``rows`` (R, n/p), as (R, ``win_len``) float32.  Windowed
    panels: ``L`` shifts and a slice of the received stack (``L * n/p``
    values a column on the wire); full panels: one all_gather ((p-1) * n/p
    values a column) -> all n.  ``comm_dtype``: the slabs cross the wire in
    this type (a cast before, float32 after)."""
    R = rows.shape[0]
    rows = rows.to(torch.float32)
    wire = rows if comm_dtype is None else rows.to(comm_dtype)
    if not sp.windowed:
        got = mesh.all_gather(wire).reshape(sp.p, R, -1)
    else:
        dmin, L = sp.shifts
        start_rel = sp.shards[0].win_start - mesh.index - dmin
        got = torch.stack([mesh.shift(wire, dmin + idx)
                           for idx in range(L)])[start_rel:
                                                 start_rel + sp.win_slabs]
    return got.transpose(0, 1).reshape(R, -1).to(torch.float32)


def gather_window(sp: ShardedPanels, x_loc, mesh, comm_dtype=None):
    """This shard's x window, float32 and flat (``win_len``,), from the
    n-sharded x (one slab of ``n/p`` per rank).  ``comm_dtype`` (e.g.
    ``torch.bfloat16``): the exchanged slabs are rounded to it, which moves
    the result by ~4e-3 relative (hold it to a band, not to bits)."""
    return _exchange(sp, x_loc[None], mesh, comm_dtype)[0]


def gather_window_mat(sp: ShardedPanels, X_loc, mesh, comm_dtype=None):
    """Multi-RHS twin of :func:`gather_window`: this shard's window of the
    row-sharded X (n/p, R) as (``win_len``, R) float32, from the same
    shifts (or all_gather) with R times the payload.  The slabs travel as
    contiguous (R, n/p) rows and the window comes back as the transposed
    view of a contiguous (R, ``win_len``) tensor: the layout of the batched
    solvers' basis columns, which the redesigned K2 reads fastest
    (``ops/spmv_cuda.py``)."""
    return _exchange(sp, X_loc.T, mesh, comm_dtype).T


def local_matvec(sp: ShardedPanels, x_win):
    """``A_loc x_win`` (m/p,) through the redesigned K1 on this shard's
    forward form, the row scale in its epilogue."""
    shard = sp.shards[0]
    return row_matvec(shard.fwd_rows, x_win, shard.row_scale)


def local_rmatvec_window(sp: ShardedPanels, u_loc):
    """The window-relative partial ``(A_loc)^T u_loc`` (``win_len``,)
    through the redesigned K3 on the form of this shard's transpose, the
    row scale gathered beside ``u``: reduce it over the mesh after
    :func:`scatter_window_to_full`."""
    shard = sp.shards[0]
    return row_rmatvec(shard.adj_rows, u_loc, shard.row_scale)


def scatter_window_to_full(sp: ShardedPanels, y_win):
    """A window-relative partial placed in the global (n,) frame (zero pad
    and roll: windows may start negative or wrap past n)."""
    return scatter_window_to_full_mat(sp, y_win[:, None])[:, 0]


def local_matmat(sp: ShardedPanels, X_win):
    """``A_loc X_win`` (m/p, R) through the redesigned K2 on this shard's
    forward form, the row scale in its epilogue: one read of the form per
    tile of 8 columns, column j bit-equal to :func:`local_matvec` on
    column j."""
    shard = sp.shards[0]
    return row_matmat(shard.fwd_rows, X_win, shard.row_scale)


def local_rmatmat_window(sp: ShardedPanels, U_loc):
    """The window-relative partial ``(A_loc)^T U_loc`` (``win_len``, R)
    through the redesigned K4 on the form of this shard's transpose, the
    row scale gathered beside ``U``: column j bit-equal to
    :func:`local_rmatvec_window` on column j."""
    shard = sp.shards[0]
    return row_rmatmat(shard.adj_rows, U_loc, shard.row_scale)


def scatter_window_to_full_mat(sp: ShardedPanels, Y_win):
    """A window-relative multi-RHS partial placed in the global (n, R)
    frame: zero pad, then roll on axis 0 (a window may start at a negative
    slab or wrap past n)."""
    n = sp.shape[1]
    if not sp.windowed:
        return Y_win[:n]
    full = Y_win.new_zeros((n, Y_win.shape[1]))
    full[:Y_win.shape[0]] = Y_win
    return torch.roll(full, sp.shards[0].win_start * (n // sp.p), dims=0)


def shard_view(sp, i: int, device=None):
    """The panels with shard ``i`` alone (on ``device`` when given), for the
    shard-local primitives: what a rank hands to a solver, and how the
    window-relative forms of a p > 1 build are driven on one card.  A
    :class:`PanelsWithAdjoint` or :class:`ComposedPanels` gives the same
    object over views of its panels.  A shard already on ``device`` is used
    as it is."""
    if isinstance(sp, PanelsWithAdjoint):
        return dataclasses.replace(sp, A=shard_view(sp.A, i, device),
                                   AT=shard_view(sp.AT, i, device))
    if isinstance(sp, ComposedPanels):
        return dataclasses.replace(
            sp, A=shard_view(sp.A, i, device),
            BT=shard_view(sp.BT, i, device),
            B=None if sp.B is None else shard_view(sp.B, i, device))
    return dataclasses.replace(sp, shards=(sp.local(i, device),), first=i)


def host_window_x(sp: ShardedPanels, i: int, x):
    """Shard ``i``'s window of a FULL x, flat float32, on ``x``'s device:
    what the exchange delivers to that shard.  For tests and debugging (no
    communication)."""
    x = torch.as_tensor(x).to(torch.float32)
    if not sp.windowed:
        return x
    p = sp.p
    nloc = sp.shape[1] // p
    start = sp.local(i).win_start
    slabs = [((start + s) % p) * nloc for s in range(sp.win_slabs)]
    return torch.cat([x[a:a + nloc] for a in slabs])


def comms_bytes_per_iteration(A_panels: ShardedPanels,
                              itemsize: int = 4,
                              kdim: int = 0,
                              B_panels: ShardedPanels | None = None,
                              comm_itemsize: int | None = None) -> dict:
    """Analytic per-iteration communication volume (bytes per rank) of the
    sharded GMRES schedule of ``parallel/sharded_rows.py``, the JAX
    package's dict exactly.

    Per iteration: one x gather (windowed shifts or all_gather), two fused
    all_reduce(kdim+1) CGS2 reductions, ~4 scalar all_reduces (ring
    all-reduce ~= 2 (p-1)/p bytes/elem), and the back-projector's
    collective: a reduce_scatter of the n-vector in the transposed layout
    (``B_panels=None``), else a gather of the m-sharded intermediate
    through ``B_panels``'s own window.  ``comm_itemsize``: wire bytes per
    element of the gather terms under a narrower ``comm_dtype``."""
    p = A_panels.p
    n = A_panels.shape[1]
    nloc = n // p
    g_item = itemsize if comm_itemsize is None else comm_itemsize

    def _gather_bytes(sp: ShardedPanels) -> int:
        xloc = sp.shape[1] // p
        if sp.windowed:
            _, L = sp.shifts
            return L * xloc * g_item
        return (p - 1) * xloc * g_item

    gather = _gather_bytes(A_panels)
    if B_panels is None:
        b_collective = (p - 1) * nloc * itemsize
        b_key = "reduce_scatter_bytes"
    else:
        b_collective = _gather_bytes(B_panels)
        b_key = "b_gather_bytes"
    allred = 2.0 * (p - 1) / p * itemsize
    cgs2 = 2 * (kdim + 1) * allred
    scalars = 4 * allred
    return {
        "p": p,
        "gather_bytes": gather,
        b_key: b_collective,
        "cgs2_bytes": cgs2,
        "scalar_bytes": scalars,
        "total_bytes": gather + b_collective + cgs2 + scalars,
    }


# ---------------------------------------------------------------------------
# The GKB family's other operator shapes.
# ---------------------------------------------------------------------------

def _require_exact_values(name: str, sp: ShardedPanels) -> None:
    """Forward-layout adjoint or back panels must hold EXACT (or
    elementwise-rounded bf16) values: per-row quantization of A^T is
    per-column quantization of A, so an int8/int4 panel of the transpose
    would break the exact adjoint pair ``<A v, u> == <v, A^T u>`` that the
    GKB recurrences rely on (``lsqr_solver.m:22-28``)."""
    if sp.quantized or sp.packed4:
        raise ValueError(
            f"{name} panels are quantized (int8/int4): forward-layout "
            "adjoint panels must be f32/bf16 — per-row scales of the "
            "transpose are per-column scales of the operator, which breaks "
            "the exact adjoint pair; use the transposed-kernel layout for "
            "quantized operators")


@dataclass
class PanelsWithAdjoint:
    """``A`` panels plus a dedicated forward-layout panel of ``A^T``.

    By default the sharded GKB solvers apply ``A^T`` through K3 on the form
    of the transpose of A's own shard and a reduce_scatter.  With the pair
    ``PanelsWithAdjoint(A, AT)`` (``AT = shard_bucketed_panels(A_csr.T,
    p)``) ``rmatvec`` runs K1 on the AT shard's forward form after a gather
    of the m-sharded ``u`` (windowed or all_gather) and needs no
    reduction, the trade the GMRES solvers' ``B_panels`` make.  Both panels
    hold f32/bf16 values of one dtype, or (``build_panels_with_adjoint``)
    int8 A with one quantization ``A ~= diag(s) Q`` and AT holding the raw
    ``Q^T`` without scales: ``A^T u = Q^T (s u)`` stays the exact adjoint
    of ``A x = s (Q x)``."""

    A: ShardedPanels
    AT: ShardedPanels

    def __post_init__(self):
        A, AT = self.A, self.AT
        m, n = A.shape
        if AT.shape != (n, m):
            raise ValueError(
                f"AT panels must cover A^T as (n, m)={(n, m)}; got "
                f"{AT.shape}")
        if AT.p != A.p:
            raise ValueError(f"AT panels built for p={AT.p}, A has {A.p}")
        if A.quantized and not A.packed4:
            if AT.quantized or AT.packed4 or \
                    AT.storage_dtype != torch.int8:
                raise ValueError(
                    "int8 A panels need a shared-quantization AT panel "
                    "(raw int8 Q^T, no scales) — build the pair with "
                    "build_panels_with_adjoint")
        else:
            _require_exact_values("AT", AT)
            _require_exact_values("A", A)
            if A.storage_dtype != AT.storage_dtype:
                raise ValueError(
                    f"A/AT storage dtypes differ ({A.storage_dtype} vs "
                    f"{AT.storage_dtype}): a bf16-rounded panel paired with "
                    "an f32 transpose is not an exact adjoint pair")

    @property
    def shape(self):
        return self.A.shape

    @property
    def p(self):
        return self.A.p

    @property
    def fro_sq(self):
        return self.A.fro_sq

    @property
    def nbytes(self) -> int:
        return self.A.nbytes + self.AT.nbytes

    def to(self, device) -> "PanelsWithAdjoint":
        return dataclasses.replace(self, A=self.A.to(device),
                                   AT=self.AT.to(device))


def build_panels_with_adjoint(csr, p: int, block=(8, 128),
                              block_T=(8, 128), dtype=np.float32,
                              n_buckets: int = 4, row_group: int = 8,
                              window: bool = True) -> PanelsWithAdjoint:
    """An exact-adjoint (A, A^T) pair of forward panels, int8 included.

    f32/bf16: both panels hold elementwise(-rounded) values.  int8: A is
    quantized once (``A ~= diag(s) Q``); the AT panel holds the raw integer
    ``Q^T`` with no scales of its own, and the GKB ``rmatvec`` scales the
    m-sharded input first (``A^T u = Q^T (s u)``), the pair K3 realizes,
    now through K1.  int4 raises (no nibble packing of the transpose)."""
    import scipy.sparse as sp_

    _, is_int4, quantized = _panel_dtype(dtype)
    if is_int4:
        raise ValueError("int4 forward-adjoint panels are not supported; "
                         "use int8 or the transposed-kernel layout")
    pack = dict(dtype=dtype, n_buckets=n_buckets, row_group=row_group,
                window=window)
    A = shard_bucketed_panels(csr, p, block=block, **pack)
    csr = sp_.csr_matrix(csr)
    if quantized:
        csr = _row_quantize_csr(csr, qmax=127)[0]
        pack["quantize"] = False
    AT = shard_bucketed_panels(csr.T.tocsr(), p, block=block_T, **pack)
    return PanelsWithAdjoint(A, AT)


@dataclass
class ComposedPanels:
    """The sharded composed operator ``M = A B`` (``kind="ab"``, m-space)
    or ``M = B A`` (``"ba"``, n-space) from two panel sets: the distributed
    twin of ``ProductOperator`` for the reference's composed hybrid path
    (``run_2D_phantom.m:150-176``: LSQR on the Tikhonov-augmented M).

    ``A``: the panels of A (m x n) over ray rows; ``BT``: the panels of B^T
    (m x n) over ray rows.  Both directions of M come from the two kernels
    of each panel, two collectives each (a gather and a reduce_scatter,
    :func:`composed_local_ops`).  ``B``: optional forward-layout panels of B
    itself (B's pixel rows): ``B u`` then runs K1 after a gather of the
    m-sharded ``u`` instead of K3 on BT and a reduce_scatter.  With ``B``,
    B and BT hold f32/bf16 values of one dtype, so that M's products stay
    an exact adjoint pair."""

    A: ShardedPanels
    BT: ShardedPanels
    kind: str
    B: ShardedPanels | None = None

    def __post_init__(self):
        A, BT, B = self.A, self.BT, self.B
        if self.kind not in ("ab", "ba"):
            raise ValueError("kind must be 'ab' or 'ba'")
        if A.shape != BT.shape or A.p != BT.p:
            raise ValueError(
                f"panel mismatch: A {A.shape}/p={A.p}, BT {BT.shape}/p={BT.p}")
        if B is not None:
            m, n = A.shape
            if B.shape != (n, m) or B.p != A.p:
                raise ValueError(
                    f"B panels must cover B as (n, m)={(n, m)} at p={A.p}; "
                    f"got {B.shape}/p={B.p}")
            _require_exact_values("B", B)
            _require_exact_values("BT", BT)
            if B.storage_dtype != BT.storage_dtype:
                raise ValueError(
                    f"B/BT storage dtypes differ ({B.storage_dtype} vs "
                    f"{BT.storage_dtype}): M's matvec/rmatvec would not be "
                    "an exact adjoint pair")

    @property
    def shape(self):
        m, n = self.A.shape
        return (m, m) if self.kind == "ab" else (n, n)

    @property
    def p(self):
        return self.A.p

    @property
    def nbytes(self) -> int:
        return sum(pl.nbytes for pl in (self.A, self.BT, self.B)
                   if pl is not None)

    def to(self, device) -> "ComposedPanels":
        return dataclasses.replace(
            self, A=self.A.to(device), BT=self.BT.to(device),
            B=None if self.B is None else self.B.to(device))


def composed_local_ops(cp: ComposedPanels, mesh, dtype):
    """(matvec, rmatvec) of the composed operator on this rank's shards
    (a :func:`shard_view` on the mesh's device), both taking and returning
    vectors sharded in M's own space."""
    A_loc, BT_loc, B_loc = cp.A, cp.BT, cp.B

    def A_fwd(x_loc):                  # n-sharded -> m-sharded rows of A
        xw = gather_window(A_loc, x_loc, mesh)
        return local_matvec(A_loc, xw).to(dtype)

    def At_rs(v_loc):                  # m-sharded -> n-sharded A^T v
        part = local_rmatvec_window(A_loc, v_loc)
        return mesh.reduce_scatter(
            scatter_window_to_full(A_loc, part).to(dtype))

    def Bt_fwd(x_loc):                 # n-sharded -> m-sharded rows of B^T
        xw = gather_window(BT_loc, x_loc, mesh)
        return local_matvec(BT_loc, xw).to(dtype)

    if B_loc is not None:
        def B_rs(u_loc):               # m-sharded -> n-sharded B u (K1)
            uw = gather_window(B_loc, u_loc, mesh)
            return local_matvec(B_loc, uw).to(dtype)
    else:
        def B_rs(u_loc):               # m-sharded -> n-sharded B u (K3)
            part = local_rmatvec_window(BT_loc, u_loc)
            return mesh.reduce_scatter(
                scatter_window_to_full(BT_loc, part).to(dtype))

    if cp.kind == "ab":
        return (lambda u: A_fwd(B_rs(u)),       # M u   = A (B u)
                lambda v: Bt_fwd(At_rs(v)))     # M^T v = B^T (A^T v)
    return (lambda x: B_rs(A_fwd(x)),           # M x   = B (A x)
            lambda x: At_rs(Bt_fwd(x)))         # M^T x = A^T (B^T x)
