"""Carry parameters and solver states across from the JAX package.

:func:`operator_from_numpy` builds the port's :class:`BlockELLOperator` from
the leaves of a JAX ``PallasBSROperator`` handed over as numpy arrays, so
both packages compute with the very same panels;
:func:`gmres_result_from_numpy` does the same for a GMRES result, and
:func:`gkb_state_from_numpy` / :func:`gkb_result_from_numpy` for the GKB
(LSQR/LSMR) family, so the port can resume a solve the JAX package began;
:func:`sharded_panels_from_numpy`, :func:`panels_with_adjoint_from_numpy`
and :func:`composed_panels_from_numpy` for the sharded panels, and
:func:`tiled_panels_from_numpy` for the 2-D tiles.
Nothing here imports JAX:
the caller does ``np.asarray`` on each leaf.  These helpers exist for the
parity tests, so ``device`` is a required keyword.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hybrid_gmres_tpu_torch.ops.linear_operator import DenseOperator
from hybrid_gmres_tpu_torch.ops.sparse import BucketedBlockELL
from hybrid_gmres_tpu_torch.ops.spmv_cuda import BlockELLOperator
from hybrid_gmres_tpu_torch.parallel.panels import (
    ComposedPanels,
    PanelsWithAdjoint,
    ShardedPanels,
    _shard_forms,
)
from hybrid_gmres_tpu_torch.parallel.panels2d import TiledPanels
from hybrid_gmres_tpu_torch.solvers.common import (
    GKBResult,
    GKBState,
    GMRESResult,
)


def bell_from_numpy(buckets, inv_perm, shape, ncb, packed4=False, *,
                    device) -> BucketedBlockELL:
    """A ``BucketedBlockELL`` from the leaves of the JAX container: the
    ``(blocks, bcols)`` pair of each bucket, ``inv_perm``, ``shape``,
    ``ncb`` and ``packed4``.  The JAX ``row_group`` is not carried: it only
    shaped the packing, and its padding is already in the arrays."""
    buckets = [(np.asarray(b), np.asarray(c)) for b, c in buckets]
    return BucketedBlockELL.from_numpy(buckets, np.asarray(inv_perm), shape,
                                       ncb, packed4=packed4, device=device)


def _vec(a, device):
    return None if a is None else torch.as_tensor(
        np.array(a, np.float32), device=device)


def operator_from_numpy(fwd, adj=None, fwd_scale=None, adj_scale=None,
                        fro_sq=None, *, device) -> BlockELLOperator:
    """The port's operator from a JAX ``PallasBSROperator``'s leaves.

    ``fwd``/``adj``: mappings with the keys of :func:`bell_from_numpy`
    (``buckets``, ``inv_perm``, ``shape``, ``ncb``, ``packed4``); ``adj``
    may be None.  ``fwd_scale``/``adj_scale``: the
    float32 row scales or None; ``fro_sq``: ``||A||_F^2`` or None.
    """
    return BlockELLOperator(
        bell_from_numpy(device=device, **fwd),
        None if adj is None else bell_from_numpy(device=device, **adj),
        fwd_scale=_vec(fwd_scale, device),
        adj_scale=_vec(adj_scale, device),
        fro_sq=None if fro_sq is None else torch.tensor(
            float(np.asarray(fro_sq)), dtype=torch.float32, device=device),
    )


def dense_from_numpy(mat, *, device) -> DenseOperator:
    """The port's ``DenseOperator`` from a JAX ``DenseOperator.mat``."""
    return DenseOperator(torch.as_tensor(np.asarray(mat), device=device))


def gmres_result_from_numpy(result, *, device) -> GMRESResult:
    """The port's ``GMRESResult`` from a JAX one, single-RHS or batched.

    ``result``: any object with the fields of ``GMRESResult`` as arrays
    that ``np.asarray`` takes (the JAX NamedTuple itself will do); absent or
    None fields stay None.  Shapes and dtypes are kept; ``niters`` becomes
    int32 and ``active`` bool, as the port's solvers produce them."""
    out = {}
    for name in GMRESResult._fields:
        val = getattr(result, name, None)
        out[name] = None if val is None else torch.as_tensor(
            np.array(val), device=device)
    out["niters"] = out["niters"].to(torch.int32)
    if out["active"] is not None:
        out["active"] = out["active"].to(torch.bool)
    return GMRESResult(**out)


def _leaf(val, device):
    """One array of a state: dtype kept, except that integers become int32
    (``niters``) as the port's solvers produce them; bools stay bool."""
    if val is None:
        return None
    t = torch.as_tensor(np.array(val), device=device)
    if not (t.dtype.is_floating_point or t.dtype == torch.bool):
        t = t.to(torch.int32)
    return t


def gkb_state_from_numpy(state=None, *, device, **fields) -> GKBState:
    """The port's ``GKBState`` from a JAX one, single-RHS or batched.

    ``state``: any object with the fields of ``GKBState`` as arrays that
    ``np.asarray`` takes (the JAX NamedTuple itself will do), or give the
    fields as keywords.  The carry keeps its order, shapes and ``None``
    entries."""
    if state is not None:
        fields = {name: getattr(state, name, None)
                  for name in GKBState._fields}
    return GKBState(
        carry=tuple(_leaf(c, device) for c in fields["carry"]),
        **{name: _leaf(fields.get(name), device)
           for name in GKBState._fields if name != "carry"})


def gkb_result_from_numpy(result, *, device) -> GKBResult:
    """The port's ``GKBResult`` from a JAX one (its ``state`` included)."""
    out = {name: _leaf(getattr(result, name, None), device)
           for name in GKBResult._fields if name != "state"}
    state = getattr(result, "state", None)
    return GKBResult(state=None if state is None else gkb_state_from_numpy(
        state, device=device), **out)


def sharded_panels_from_numpy(buckets, inv_perm, win_start, shape, ncb,
                              win_slabs, slab_blocks, shifts, row_group, p,
                              packed4=False, row_scale=None, fro_sq=None,
                              fwd_perm=None, *, device) -> ShardedPanels:
    """The port's ``ShardedPanels`` from the leaves of a JAX one, numpy
    arrays under the JAX constructor's names: the stacked per-bucket
    ``(blocks (p, nbr_b, maxb, br, bc), bcols (p, ...))`` with
    window-relative columns (nibble pairs when ``packed4``), ``inv_perm``
    (p, nbr), the window description, ``row_scale`` (p, m/p) or None,
    ``fro_sq``.  Each shard's two forms are built from its slice of the
    stacked panels and put on ``device``; ``fwd_perm`` is not needed by the
    forms and is ignored."""
    m, n = shape
    mloc = m // p
    br, bc = np.asarray(buckets[0][0]).shape[3:]
    sp_ = ShardedPanels(
        shards=(), shape=(m, n), ncb=int(ncb), win_slabs=int(win_slabs),
        slab_blocks=int(slab_blocks), shifts=tuple(int(v) for v in shifts),
        p=int(p), block_shape=(int(br), int(bc)), row_group=int(row_group),
        packed4=bool(packed4),
        fro_sq=None if fro_sq is None else torch.tensor(
            np.asarray(fro_sq, np.float32)))
    inv_perm = np.asarray(inv_perm)
    win_start = np.asarray(win_start).reshape(-1)
    shards = []
    for i in range(p):
        per = []
        for blocks, bcols in buckets:
            blk = np.asarray(blocks)[i]
            per.append((blk, np.asarray(bcols)[i].reshape(blk.shape[0], -1)))
        bell = BucketedBlockELL.from_numpy(
            per, inv_perm[i], (mloc, sp_.win_len), sp_.win_blocks,
            packed4=packed4, device="cpu")
        scale = None if row_scale is None else torch.as_tensor(
            np.array(row_scale, np.float32)[i])
        shards.append(_shard_forms(bell, scale, 0, win_start[i],
                                   bell.shape, bell.ncb).to(device))
    return dataclasses.replace(sp_, shards=tuple(shards))


def panels_with_adjoint_from_numpy(A, AT, *, device) -> PanelsWithAdjoint:
    """The port's ``PanelsWithAdjoint`` from a JAX one: ``A`` and ``AT``
    are mappings with the keyword arguments of
    :func:`sharded_panels_from_numpy` (the leaves of ``pair.A`` and
    ``pair.AT``); the pair is checked as the JAX constructor checks it."""
    return PanelsWithAdjoint(sharded_panels_from_numpy(**A, device=device),
                             sharded_panels_from_numpy(**AT, device=device))


def composed_panels_from_numpy(A, BT, kind, B=None, *,
                               device) -> ComposedPanels:
    """The port's ``ComposedPanels`` from a JAX one: ``A``, ``BT`` and the
    optional ``B`` are mappings with the keyword arguments of
    :func:`sharded_panels_from_numpy`, ``kind`` is ``"ab"`` or ``"ba"``."""
    return ComposedPanels(
        sharded_panels_from_numpy(**A, device=device),
        sharded_panels_from_numpy(**BT, device=device), kind,
        B=None if B is None else sharded_panels_from_numpy(**B,
                                                           device=device))


def tiled_panels_from_numpy(buckets, inv_perm, shape, ncb_tile, row_group,
                            pr, pc, packed4=False, row_scale=None,
                            fro_sq=None, *, device) -> TiledPanels:
    """The port's ``TiledPanels`` from the leaves of a JAX one, numpy arrays
    under the JAX constructor's names: the stacked per-bucket ``(blocks
    (pr*pc, nbr_b, maxb, br, bc), bcols (pr*pc, ...))`` padded to
    mesh-uniform shapes (nibble pairs when ``packed4``), ``inv_perm``
    (pr*pc, nbr) into the padded positions, ``row_scale`` (pr*pc, m/pr) or
    None, ``fro_sq`` (pr*pc,), the grid.  Each tile's panel is taken from
    its slice (the padding positions become padding of that panel, which
    the forms leave out) and kept as its two forms, rows in source order,
    on ``device``.  The forms need no ``fwd_perm``."""
    m, n = shape
    tile = (m // pr, n // pc)
    br, bc = np.asarray(buckets[0][0]).shape[3:]
    inv_perm = np.asarray(inv_perm)
    tiles = []
    for d in range(pr * pc):
        per = []
        for blocks, bcols in buckets:
            blk = np.asarray(blocks)[d]
            per.append((blk, np.asarray(bcols)[d].reshape(blk.shape[0], -1)))
        bell = BucketedBlockELL.from_numpy(per, inv_perm[d], tile,
                                           int(ncb_tile), packed4=packed4,
                                           device="cpu")
        scale = None if row_scale is None else torch.as_tensor(
            np.array(row_scale, np.float32)[d])
        tiles.append(_shard_forms(bell, scale, 0, 0, bell.shape,
                                  bell.ncb).to(device))
    return TiledPanels(
        tiles=tuple(tiles), shape=(int(m), int(n)), pr=int(pr), pc=int(pc),
        block_shape=(int(br), int(bc)), row_group=int(row_group),
        packed4=bool(packed4),
        fro_sq=None if fro_sq is None else torch.tensor(
            np.asarray(fro_sq, np.float32)))
