"""The port's side of ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_solvers.py`` and
``tests/test_torch_parallel_2d.py``, run on 4 gloo ranks.

This module imports no JAX: :func:`spawn` starts the ranks with the
``spawn`` method, each imports this module afresh, joins one gloo process
group on localhost, runs every case of one group (:data:`CASES` for the
first file, :data:`SOLVER_CASES` for the second, :data:`CASES_2D` for the
third) on the inputs the test module made (numpy arrays) and sends its
results back as numpy arrays.  A case that raises records the exception's
type and message instead, on every rank alike (every case raises, if at
all, before its first collective).
"""

from __future__ import annotations

import datetime
import socket
import traceback

import numpy as np

P = 4            # ranks
MAXIT = 8        # the panel solvers' steps, as in tests/test_parallel.py


def dense_prob():
    """tests/test_parallel.py's ``prob``: m = 40 rows (divisible by 4 and
    8), n = 32, float64."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 32)) * 0.1 + np.eye(40, 32)
    x_true = rng.standard_normal(32)
    b = A @ x_true + 0.01 * rng.standard_normal(40)
    return A, A.T.copy(), b, x_true


def sparse_pair(m, n, density=0.3, seed=1):
    """tests/test_parallel.py's ``_sparse_pair``: float32 A, a perturbed
    transpose B, x_true and a noisy b."""
    rng = np.random.default_rng(seed)
    Ad = (rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
          ).astype(np.float32)
    Bd = (Ad.T + 1e-3 * rng.standard_normal((n, m))).astype(np.float32)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = (Ad @ x_true + 0.01 * rng.standard_normal(m)).astype(np.float32)
    return Ad, Bd, b, x_true


# row slab i touches column slabs i and i+1 only: 2 shifts at p = 4, fewer
# gather bytes than an all_gather (the tridiagonal default needs 3, as many)
UPPER_BAND = (0, 40, 100)


def banded(p, seed, offsets=(-40, 0, 40)):
    """A block-banded float32 CSR (n = 128 p) whose row slab i touches
    column slabs i-1..i+1 only: windowed at p = 4 with L = 3 shifts."""
    import scipy.sparse as sp

    n = 128 * p
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(o)) for o in offsets]
    return sp.diags(diags, offsets=offsets).tocsr().astype(np.float32)


def well_conditioned():
    """tests/test_parallel.py's tol-stop problem: converges in few steps."""
    rng = np.random.default_rng(33)
    Ad = (np.eye(64, 32) * 3.0 + 0.05 * rng.standard_normal((64, 32))
          ).astype(np.float32)
    x_true = rng.standard_normal(32).astype(np.float32)
    return Ad, Ad.T.copy(), (Ad @ x_true).astype(np.float32), x_true


def _np(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_np(e) for e in v)
    if isinstance(v, dict):
        return {k: _np(e) for k, e in v.items()}
    return v


def _res(r):
    return {"x": r.x, "err_hist": r.err_hist, "res_hist": r.res_hist,
            "niters": r.niters, "Q": r.Q}


def _csr(a):
    import scipy.sparse as sp

    return sp.csr_matrix(a)


def _panel_pair(seed, forward=False):
    """(Ad, Bd, b, x_true, A_panels, back panels) of a sparse pair at p=4:
    the back-projector as BT panels, or B's own with ``forward``."""
    from hybrid_gmres_tpu_torch.parallel import shard_bucketed_panels

    Ad, Bd, b, xt = sparse_pair(64, 32, seed=seed)
    A = shard_bucketed_panels(_csr(Ad), P)
    back = shard_bucketed_panels(_csr(Bd if forward else Bd.T), P)
    return Ad, Bd, b, xt, A, back


# --------------------------------------------------------------------------
# The cases.  Each takes (mesh, inputs) and returns a dict of results.
# --------------------------------------------------------------------------

def case_dense_matvecs(mesh, inp):
    import torch

    from hybrid_gmres_tpu_torch.parallel import (
        shard_problem, sharded_ab_matvec, sharded_ba_matvec)

    A, B, b, xt = dense_prob()
    A_l, B_l, b_l = shard_problem(A, B, b, mesh)
    ba = sharded_ba_matvec(A_l, B_l, mesh)(torch.from_numpy(xt))
    ab = mesh.all_gather(sharded_ab_matvec(A_l, B_l, mesh)(b_l))
    return {"ba": ba, "ab": ab}


def case_dense_solve(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded, shard_problem)

    A, B, b, xt = dense_prob()
    out = {}
    for lam in (None, 1e-3):
        A_l, B_l, b_l = shard_problem(A, B, b, mesh)
        out[str(lam)] = _res(ba_gmres_sharded(A_l, B_l, b_l, xt, tol=1e-10,
                                              maxit=16, lam=lam, mesh=mesh))
    return out


def case_dense_shaw(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded, shard_problem)

    A, B, b, xt = inp["shaw"]
    A_l, B_l, b_l = shard_problem(A, B, b, mesh)
    return _res(ba_gmres_sharded(A_l, B_l, b_l, xt, tol=1e-6, maxit=16,
                                 lam=1e-3, mesh=mesh))


def case_basis(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_basis, ba_gmres_sharded_basis, shard_problem)

    A, B, b, xt = dense_prob()
    A_l, B_l, b_l = shard_problem(A, B, b, mesh)
    out = {}
    for kind, f in (("ba", ba_gmres_sharded_basis),
                    ("ab", ab_gmres_sharded_basis)):
        for lam in (None, 1e-3):
            out[f"{kind} {lam}"] = _res(f(A_l, B_l, b_l, xt, tol=1e-10,
                                          maxit=16, lam=lam, mesh=mesh))
        for residual in ("true", "fused"):
            out[f"{kind} {residual}"] = _res(f(
                A_l, B_l, b_l, xt, tol=0.0, maxit=12, lam=1e-3, mesh=mesh,
                residual=residual))
    return out


def case_basis_divisible(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded_basis, shard_problem)

    A, B, b, _ = dense_prob()
    A_l, B_l, b_l = shard_problem(A[:, :30], B[:30], b, mesh)
    ba_gmres_sharded_basis(A_l, B_l, b_l, None, maxit=4, mesh=mesh)
    return "no error"


def case_meshes(mesh, inp):
    """The mesh builders: the default device needs a card; a mesh larger
    than the job is refused; the 2-D mesh's coordinates; a replica fleet
    whose replicas reduce only among themselves."""
    import torch

    from hybrid_gmres_tpu_torch.parallel import (
        make_mesh, make_mesh_2d, make_replica_meshes)

    out = {}
    for name, call in (("cuda", lambda: make_mesh()),
                       ("too_many", lambda: make_mesh(P + 1, device="cpu"))):
        try:
            call()
            out[name] = "no error"
        except (RuntimeError, ValueError) as e:
            out[name] = type(e).__name__
    m2 = make_mesh_2d((2, 2), device="cpu")
    out["coords"] = np.array(m2.coords)
    reps = make_replica_meshes(2, device="cpu")
    mine = [i for i, r in enumerate(reps) if r.index is not None]
    rep = reps[mine[0]]
    out["replica"] = np.array([len(mine), mine[0], rep.index, rep.size])
    out["replica_sum"] = rep.all_reduce(
        torch.tensor([float(mesh.index)], dtype=torch.float64))
    return out


def case_pallas_dense(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas, ba_gmres_sharded_pallas)

    _, _, b, xt, A, BT = _panel_pair(1)
    out = {}
    names = ("all_reduce", "all_gather", "reduce_scatter", "shift")
    for kind, f in (("ba", ba_gmres_sharded_pallas),
                    ("ab", ab_gmres_sharded_pallas)):
        before = np.array([mesh.calls[c] for c in names])
        r = f(A, BT, b, xt, tol=0.0, maxit=MAXIT, lam=1e-3, mesh=mesh)
        out[kind] = _res(r)
        out[kind]["calls"] = np.array([mesh.calls[c] for c in names]) - \
            before
    return out


def case_windowed(mesh, inp):
    import torch

    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded_pallas, shard_bucketed_panels)

    Ad = banded(P, 3, offsets=UPPER_BAND)
    rng = np.random.default_rng(3)
    n = Ad.shape[0]
    Bd = (Ad.T + _rand_sparse(n, 5)).tocsr()
    A = shard_bucketed_panels(Ad, P)
    BT = shard_bucketed_panels(Bd.T.tocsr(), P)
    xt = rng.standard_normal(n).astype(np.float32)
    b = (Ad @ xt + 0.01 * rng.standard_normal(n)).astype(np.float32)
    before = mesh.calls["shift"]
    r = ba_gmres_sharded_pallas(A, BT, torch.from_numpy(b), xt, tol=0.0,
                                maxit=6, lam=1e-3, mesh=mesh)
    out = _res(r)
    out["shifts_issued"] = mesh.calls["shift"] - before
    return out


def _rand_sparse(n, seed):
    import scipy.sparse as sp

    return sp.random(n, n, density=1e-4, random_state=seed, format="csr",
                     dtype=np.float64).astype(np.float32)


def _products(mesh, panels, x, u):
    """(A x through the exchange and K1, all_gather-ed; A^T u through K3,
    the scatter and an all_reduce) on this rank's shard."""
    import torch

    from hybrid_gmres_tpu_torch.parallel.panels import (
        gather_window, local_matvec, local_rmatvec_window,
        scatter_window_to_full, shard_view)

    loc = shard_view(panels, mesh.index)
    n, m = panels.shape[1], panels.shape[0]
    nloc, mloc = n // P, m // P
    i = mesh.index
    x_loc = torch.from_numpy(x[i * nloc:(i + 1) * nloc])
    u_loc = torch.from_numpy(u[i * mloc:(i + 1) * mloc])
    y = mesh.all_gather(local_matvec(loc, gather_window(loc, x_loc, mesh)))
    z = mesh.all_reduce(scatter_window_to_full(
        loc, local_rmatvec_window(loc, u_loc)))
    return {"y": y, "z": z}


def case_primitives(mesh, inp):
    import scipy.sparse as sp

    from hybrid_gmres_tpu_torch.parallel import shard_bucketed_panels

    out = {}
    for n, density in ((128 * P, 0.02), (32 * P, 0.2)):
        A = sp.random(n, n, density=density, random_state=7, format="csr",
                      dtype=np.float64).astype(np.float32)
        x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
        u = np.random.default_rng(12).standard_normal(n).astype(np.float32)
        out[str(n)] = _products(mesh, shard_bucketed_panels(A, P), x, u)
    return out


def case_quantized(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import shard_bucketed_panels

    out = {}
    for name, seed in (("int8", 6), ("int4", 9)):
        Ad = sparse_pair(64, 32, seed=seed)[0]
        x = np.random.default_rng(7).standard_normal(32).astype(np.float32)
        u = np.random.default_rng(8).standard_normal(64).astype(np.float32)
        out[name] = _products(mesh, shard_bucketed_panels(
            _csr(Ad), P, dtype=np.int8 if name == "int8" else "int4"), x, u)
    Ad = banded(P, 13, offsets=(-40, 0, 40))
    rng = np.random.default_rng(13)
    x = rng.standard_normal(Ad.shape[1]).astype(np.float32)
    u = rng.standard_normal(Ad.shape[0]).astype(np.float32)
    out["int4 windowed"] = _products(
        mesh, shard_bucketed_panels(Ad, P, dtype="int4"), x, u)
    return out


def case_gcv(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import ba_gmres_sharded_pallas

    _, _, b, xt, A, BT = _panel_pair(11)
    return _res(ba_gmres_sharded_pallas(
        A, BT, b, xt, tol=0.0, maxit=6, lam="gcv",
        gcv_grid=np.logspace(-6, -1, 12), mesh=mesh))


def case_restarted(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas_restarted, ba_gmres_sharded_pallas_restarted)

    _, _, b, xt, A, BT = _panel_pair(19)
    out = {}
    for kind, f in (("ba", ba_gmres_sharded_pallas_restarted),
                    ("ab", ab_gmres_sharded_pallas_restarted)):
        out[kind] = _res(f(A, BT, b, xt, tol=1e-10, restart=4,
                           max_restarts=3, lam=1e-3, mesh=mesh))
    _, _, _, xt, A, BT = _panel_pair(34)
    out["zero"] = _res(ba_gmres_sharded_pallas_restarted(
        A, BT, np.zeros(64, np.float32), xt, tol=1e-6, restart=4,
        max_restarts=3, mesh=mesh))
    return out


def case_resume(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas, ba_gmres_sharded_pallas,
        shard_bucketed_panels)

    out = {}
    for kind, f, seed in (("ba", ba_gmres_sharded_pallas, 27),
                          ("ab", ab_gmres_sharded_pallas, 43)):
        _, _, b, xt, A, BT = _panel_pair(seed)
        kw = dict(tol=0.0, lam=1e-3, mesh=mesh)
        full = f(A, BT, b, xt, maxit=12, **kw)
        half = f(A, BT, b, xt, maxit=6, **kw)
        res = f(A, BT, b, xt, maxit=12, resume_from=half, **kw)
        out[kind] = {"full": _res(full), "resumed": _res(res),
                     "has": np.array([half.IMG is not None,
                                      half.S is not None])}
    Ad, Bd, b, xt = well_conditioned()
    A = shard_bucketed_panels(_csr(Ad), P)
    BT = shard_bucketed_panels(_csr(Bd.T), P)
    kw = dict(mesh=mesh, tol=1e-3)
    half = ba_gmres_sharded_pallas(A, BT, b, xt, maxit=10, **kw)
    out["tol"] = {
        "half": _res(half),
        "resumed": _res(ba_gmres_sharded_pallas(A, BT, b, xt, maxit=14,
                                                resume_from=half, **kw)),
        "full": _res(ba_gmres_sharded_pallas(A, BT, b, xt, maxit=14, **kw))}
    return out


def case_forward(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas, ba_gmres_sharded_pallas,
        ba_gmres_sharded_pallas_restarted)

    _, _, b, xt, A, Bf = _panel_pair(1, forward=True)
    out = {}
    for kind, f in (("ba", ba_gmres_sharded_pallas),
                    ("ab", ab_gmres_sharded_pallas)):
        out[kind] = _res(f(A, None, b, xt, tol=0.0, maxit=MAXIT, lam=1e-3,
                           mesh=mesh, B_panels=Bf))
    _, _, b, xt, A, Bf = _panel_pair(9, forward=True)
    kw = dict(tol=0.0, lam=1e-3, mesh=mesh, B_panels=Bf)
    part = ba_gmres_sharded_pallas(A, None, b, xt, maxit=4, **kw)
    out["full"] = _res(ba_gmres_sharded_pallas(A, None, b, xt, maxit=8,
                                               **kw))
    out["resumed"] = _res(ba_gmres_sharded_pallas(A, None, b, xt, maxit=8,
                                                  resume_from=part, **kw))
    out["restarted"] = _res(ba_gmres_sharded_pallas_restarted(
        A, None, b, xt, tol=1e-10, restart=4, max_restarts=2, lam=1e-3,
        mesh=mesh, B_panels=Bf))
    return out


def case_forward_validation(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import ba_gmres_sharded_pallas

    _, _, b, _, A, Bf = _panel_pair(1, forward=True)
    out = {}
    for name, kw in (("none", {}), ("shape", {"B_panels": A})):
        try:
            ba_gmres_sharded_pallas(A, None, b, mesh=mesh, **kw)
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    return out


def case_comm_dtype(mesh, inp):
    import torch

    from hybrid_gmres_tpu_torch.parallel import ba_gmres_sharded_pallas

    out = {}
    for layout in ("transposed", "forward"):
        _, _, b, xt, A, back = _panel_pair(11, forward=layout == "forward")
        kw = ({"B_panels": back} if layout == "forward" else {})
        BT = None if layout == "forward" else back
        runs = [ba_gmres_sharded_pallas(A, BT, b, xt, tol=0.0, maxit=6,
                                        lam=1e-3, mesh=mesh, comm_dtype=cd,
                                        **kw)
                for cd in (None, torch.bfloat16)]
        out[layout] = {"f32": _res(runs[0]), "bf16": _res(runs[1])}
    return out


def case_all_reduce_view(mesh, inp):
    """``Mesh.all_reduce`` on a view of stored state (a row of this rank's
    (2, 3) block) and on a fresh tensor; ``local_shard_info`` of the
    mesh."""
    import torch
    import torch.distributed as dist

    from hybrid_gmres_tpu_torch.parallel.multihost import local_shard_info

    rank = dist.get_rank()
    owner = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1)
    kept = owner.clone()
    row = mesh.all_reduce(owner[1])
    fresh = owner.sum(dim=0)
    summed = mesh.all_reduce(fresh)
    return {"owner": owner, "kept": kept, "row": row,
            "fresh_in_place": summed is fresh, "fresh": summed,
            "info": local_shard_info(mesh)}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


# --------------------------------------------------------------------------
# The solver cases of tests/test_torch_parallel_solvers.py (the sharded RTP,
# GKB and batched modules).
# --------------------------------------------------------------------------

def batched_pair(m=64, n=32, R=3, seed=1):
    """tests/test_parallel.py's ``_batched_pair``: float32 A, a perturbed
    transpose B, R true images and noisy sinograms."""
    rng = np.random.default_rng(seed)
    Ad = (rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.3)
          ).astype(np.float32)
    Bd = (Ad.T + 1e-3 * rng.standard_normal((n, m))).astype(np.float32)
    x_true = rng.standard_normal((n, R)).astype(np.float32)
    b = (Ad @ x_true + 0.01 * rng.standard_normal((m, R))
         ).astype(np.float32)
    return Ad, Bd, b, x_true


def banded_pair(R=3, seed=3):
    """A block-banded pair whose panels are windowed at p = 4 (the upper
    band: L = 2 shifts), R right-hand sides."""
    Ad = banded(P, seed, offsets=UPPER_BAND)
    n = Ad.shape[0]
    rng = np.random.default_rng(seed)
    Bd = (Ad.T + _rand_sparse(n, seed + 2)).tocsr()
    xt = rng.standard_normal((n, R)).astype(np.float32)
    b = (Ad @ xt + 0.01 * rng.standard_normal((n, R))).astype(np.float32)
    return Ad, Bd, b, xt


def _gkb(r):
    out = {"x": r.x, "err_hist": r.err_hist, "res_hist": r.res_hist,
           "niters": r.niters}
    if r.ar_hist is not None:
        out["ar_hist"] = r.ar_hist
    return out


def _bres(r):
    return {"x": r.x, "err_hist": r.err_hist, "res_hist": r.res_hist,
            "niters": r.niters, "active": r.active}


def _error(call):
    """The message of the ValueError ``call()`` raises."""
    try:
        call()
    except ValueError as e:
        return str(e)
    return "no error"


def _calls(mesh):
    return np.array([mesh.calls[c] for c in
                     ("all_reduce", "all_gather", "reduce_scatter", "shift")])


def scase_gkb_dense(mesh, inp):
    """The dense-slab GKB solvers in float64 on the test_parallel prob."""
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_basis, ba_gmres_sharded_basis, hybrid_lsmr_sharded,
        hybrid_lsqr_sharded, lsmr_sharded, lsqr_sharded, shard_problem)

    A, _, b, xt = dense_prob()
    kw = dict(tol=1e-12, maxit=16, mesh=mesh)
    out = {"lsqr": _gkb(lsqr_sharded(A, b, xt, **kw)),
           "hybrid_lsqr": _gkb(hybrid_lsqr_sharded(A, b, xt, lam=1e-3, **kw)),
           "lsmr": _gkb(lsmr_sharded(A, b, xt, **kw))}
    for mode in ("last", "first"):
        out[f"hybrid_lsmr {mode}"] = _gkb(hybrid_lsmr_sharded(
            A, b, xt, lam=1e-3, rank1_mode=mode, **kw))
    kw = dict(tol=0.0, mesh=mesh)
    full = lsqr_sharded(A, b, xt, maxit=16, **kw)
    half = lsqr_sharded(A, b, xt, maxit=8, **kw)
    out["resume"] = {
        "full": _gkb(full), "half": _gkb(half),
        "half_state_res": half.state.res_hist,
        "resumed": _gkb(lsqr_sharded(A, b, xt, maxit=16,
                                     resume_from=half.state, **kw))}
    A_s, B_s, b_s = shard_problem(A, A.T, b, mesh)
    out["equivalence"] = {
        "ba": _res(ba_gmres_sharded_basis(A_s, B_s, b_s, xt, maxit=6, **kw)),
        "lsmr": _gkb(lsmr_sharded(A, b, xt, maxit=6, **kw)),
        "ab": _res(ab_gmres_sharded_basis(A_s, B_s, b_s, xt, maxit=6, **kw)),
        "lsqr": _gkb(lsqr_sharded(A, b, xt, maxit=6, **kw))}
    return out


def scase_gkb_deriv2(mesh, inp):
    """deriv2 n=32 (float64): reorth, warm starts, resumes and the
    full-depth equivalence oracles."""
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_basis, ba_gmres_sharded_basis, hybrid_lsmr_sharded,
        hybrid_lsqr_sharded, lsmr_sharded, lsqr_sharded, shard_problem)

    A, b, xt, x0_lsqr, x0_lsmr = inp["deriv2"]
    kw = dict(tol=0.0, mesh=mesh)
    out = {"reorth": {
        name: _gkb(f(A, b, xt, maxit=12, reorth=True, **extra, **kw))
        for name, f, extra in (("lsqr", lsqr_sharded, {}),
                               ("lsmr", lsmr_sharded, {}),
                               ("hybrid_lsmr", hybrid_lsmr_sharded,
                                {"lam": 1e-3}))}}
    hk = dict(lam=1e-3, x0=x0_lsqr, **kw)
    out["hybrid_lsqr_x0"] = _gkb(hybrid_lsqr_sharded(A, b, xt, maxit=8,
                                                     **hk))
    for reorth in (False, True):
        part = hybrid_lsqr_sharded(A, b, xt, maxit=4, reorth=reorth, **hk)
        out[f"hybrid_lsqr_resume {reorth}"] = {
            "full": _gkb(hybrid_lsqr_sharded(A, b, xt, maxit=8,
                                             reorth=reorth, **hk)),
            "resumed": _gkb(hybrid_lsqr_sharded(
                A, b, xt, maxit=8, reorth=reorth, resume_from=part.state,
                **hk))}
    out["reorth_mismatch"] = _error(lambda: hybrid_lsqr_sharded(
        A, b, xt, maxit=8, reorth=False, resume_from=part.state, **hk))
    part = lsmr_sharded(A, b, xt, maxit=4, **kw)
    out["lsmr_resume"] = {
        "full": _gkb(lsmr_sharded(A, b, xt, maxit=8, **kw)),
        "resumed": _gkb(lsmr_sharded(A, b, xt, maxit=8,
                                     resume_from=part.state, **kw))}
    A_s, B_s, b_s = shard_problem(A, A.T, b, mesh)
    k = 32
    out["equivalence"] = {
        "ba": _res(ba_gmres_sharded_basis(A_s, B_s, b_s, xt, maxit=k, **kw)),
        "lsmr": _gkb(lsmr_sharded(A, b, xt, maxit=k, reorth=True, **kw)),
        "ab": _res(ab_gmres_sharded_basis(A_s, B_s, b_s, xt, maxit=k, **kw)),
        "lsqr": _gkb(lsqr_sharded(A, b, xt, maxit=k, reorth=True, **kw)),
        "hba": _res(ba_gmres_sharded_basis(A_s, B_s, b_s, xt, maxit=k,
                                           lam=1e-3, **kw)),
        "hlsmr": _gkb(hybrid_lsmr_sharded(A, b, xt, maxit=k, lam=1e-3,
                                          reorth=True, **kw))}
    out["hybrid_lsmr_x0"] = {
        reg: _gkb(hybrid_lsmr_sharded(A, b, xt, maxit=10, lam=1e-3,
                                      x0=x0_lsmr, x0_reg=reg, **kw))
        for reg in ("correction", "full")}
    return out


def scase_gkb_panels(mesh, inp):
    """The GKB solvers on the three panel shapes, float32."""
    import torch

    from hybrid_gmres_tpu_torch.parallel import (
        ComposedPanels, PanelsWithAdjoint, build_panels_with_adjoint,
        hybrid_lsmr_sharded, hybrid_lsqr_sharded, lsmr_sharded, lsqr_sharded,
        shard_bucketed_panels)
    from hybrid_gmres_tpu_torch.utils.convert import (
        composed_panels_from_numpy, panels_with_adjoint_from_numpy)

    def panels(a, **kw):
        return shard_bucketed_panels(_csr(a), P, **kw)

    kw = dict(tol=0.0, mesh=mesh)
    out = {}
    Ad, _, b, xt = sparse_pair(64, 32, seed=4)
    out["lsqr"] = _gkb(lsqr_sharded(panels(Ad), b, xt, maxit=10, **kw))
    Ad, _, b, xt = sparse_pair(64, 32, seed=21)
    A_p = panels(Ad)
    half = lsqr_sharded(A_p, b, xt, maxit=6, **kw)
    out["resume"] = {
        "full": _gkb(lsqr_sharded(A_p, b, xt, maxit=12, **kw)),
        "resumed": _gkb(lsqr_sharded(A_p, b, xt, maxit=12,
                                     resume_from=half.state, **kw))}
    Ad, _, b, xt = sparse_pair(64, 32, seed=6)
    out["int8"] = _gkb(lsqr_sharded(panels(Ad, dtype=np.int8), b, xt,
                                    maxit=8, **kw))
    Ad, _, b, xt = sparse_pair(64, 32, seed=23)
    x0 = (np.random.default_rng(24).standard_normal(32) * 0.1).astype(
        np.float32)
    A_p = panels(Ad)
    part = lsqr_sharded(A_p, b, xt, maxit=3, x0=x0, **kw)
    out["warm"] = {
        "lsqr": _gkb(lsqr_sharded(A_p, b, xt, maxit=6, x0=x0, **kw)),
        "resumed": _gkb(lsqr_sharded(A_p, b, xt, maxit=6, x0=x0,
                                     resume_from=part.state, **kw)),
        "lsmr": _gkb(lsmr_sharded(A_p, b, xt, maxit=6, x0=x0, **kw))}
    Ad, _, b, xt = sparse_pair(64, 32, seed=13)
    pair = PanelsWithAdjoint(panels(Ad), panels(Ad.T.copy()))
    out["adjoint"] = {
        "lsqr": _gkb(lsqr_sharded(pair, b, xt, maxit=6, **kw)),
        "hybrid_lsmr": _gkb(hybrid_lsmr_sharded(pair, b, xt, maxit=6,
                                                lam=1e-3, **kw))}
    Ad, _, b, xt = sparse_pair(64, 32, seed=19)
    out["adjoint_int8"] = {
        "pair": _gkb(lsqr_sharded(build_panels_with_adjoint(
            _csr(Ad), P, dtype=np.int8), b, xt, maxit=6, **kw)),
        "transposed": _gkb(lsqr_sharded(panels(Ad, dtype=np.int8), b, xt,
                                        maxit=6, **kw))}
    Ad, Bd, b, xt = sparse_pair(64, 64, seed=9)
    for kind in ("ab", "ba"):
        M = ComposedPanels(panels(Ad), panels(Bd.T), kind)
        rhs = b if kind == "ab" else (Bd @ b).astype(np.float32)
        out[f"composed {kind}"] = {
            "lsqr": _gkb(lsqr_sharded(M, rhs, maxit=8, **kw)),
            "hybrid_lsqr": _gkb(hybrid_lsqr_sharded(M, rhs, maxit=8,
                                                    lam=1e-2, **kw))}
    Ad, Bd, b, xt = sparse_pair(64, 32, seed=17)
    d = (Bd @ b).astype(np.float32)
    out["composed_forward"] = {
        name: _gkb(lsqr_sharded(ComposedPanels(panels(Ad), panels(Bd.T),
                                               "ba", B=B), d, xt, maxit=5,
                                **kw))
        for name, B in (("transposed", None), ("forward", panels(Bd)))}
    # the pair and the composed operator converted from the JAX package's
    # panels, each rank placing its shard on its device
    conv = inp["converted"]
    pair = panels_with_adjoint_from_numpy(*conv["pair"], device="cpu")
    M = composed_panels_from_numpy(*conv["composed"], device="cpu")
    Ad, Bd, b, xt = sparse_pair(64, 32, seed=13)
    out["converted"] = {
        "pair": _gkb(lsqr_sharded(pair, b, xt, maxit=4, **kw)),
        "composed": _gkb(lsqr_sharded(M, (Bd @ b).astype(np.float32), xt,
                                      maxit=4, **kw))}
    calls0 = _calls(mesh)
    lsqr_sharded(pair, torch.from_numpy(b), xt, maxit=4, **kw)
    out["converted"]["calls"] = _calls(mesh) - calls0
    return out


def scase_rtp(mesh, inp):
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_rtp_sharded, ba_gmres_rtp_sharded, ba_gmres_sharded_pallas)

    f = {"ba": ba_gmres_rtp_sharded, "ab": ab_gmres_rtp_sharded}
    out = {}
    _, _, b, xt, A, BT = _panel_pair(17)
    for kind in ("ba", "ab"):
        calls0 = _calls(mesh)
        out[kind] = _res(f[kind](A, BT, b, xt, tol=0.0, maxit=8, lam=1e-2,
                                 mesh=mesh))
        out[kind]["calls"] = _calls(mesh) - calls0
    _, _, b, xt, A, BT = _panel_pair(18)
    kw = dict(tol=0.0, maxit=8, lam=1e-1, mesh=mesh)
    out["vs_ptr"] = {
        "rtp": _res(ba_gmres_rtp_sharded(A, BT, b, xt, **kw)),
        "ptr": _res(ba_gmres_sharded_pallas(A, BT, b, xt, **kw))}
    Ad, Bd, b, xt, A, BT = _panel_pair(5)
    from hybrid_gmres_tpu_torch.parallel import shard_bucketed_panels

    B = shard_bucketed_panels(_csr(Bd), P)
    kw = dict(tol=0.0, maxit=6, lam=1e-3, mesh=mesh)
    for kind in ("ba", "ab"):
        out[f"forward {kind}"] = {
            "transposed": _res(f[kind](A, BT, b, xt, **kw)),
            "forward": _res(f[kind](A, None, b, xt, B_panels=B, **kw))}
    return out


def scase_batched(mesh, inp):
    import torch

    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_batched, ba_gmres_sharded_batched,
        shard_bucketed_panels)

    f = {"ba": ba_gmres_sharded_batched, "ab": ab_gmres_sharded_batched}

    def pair(Ad, Bd):
        return (shard_bucketed_panels(_csr(Ad), P),
                shard_bucketed_panels(_csr(Bd.T), P))

    out = {}
    Ad, Bd, b, xt = batched_pair()
    A, BT = pair(Ad, Bd)
    for kind in ("ba", "ab"):
        for lam in (None, 1e-3):
            out[f"{kind} {lam}"] = _bres(f[kind](
                A, BT, b, xt, tol=0.0, maxit=6, lam=lam, mesh=mesh))
        out[f"{kind} deferred"] = _bres(f[kind](
            A, BT, b, xt, tol=0.0, maxit=6, lam=1e-3, mesh=mesh,
            defer_histories=True))
        # the collectives of a solve do not depend on R (and chunking off)
        counts = []
        for R in (1, 3):
            calls0 = _calls(mesh)
            f[kind](A, BT, b[:, :R], xt[:, :R], tol=0.0, maxit=6, lam=1e-3,
                    mesh=mesh)
            counts.append(_calls(mesh) - calls0)
        out[f"{kind} calls"] = np.stack(counts)
    Ad, Bd, b, xt = batched_pair(R=5, seed=4)
    A, BT = pair(Ad, Bd)
    x0 = (xt + 0.1 * np.random.default_rng(9).standard_normal(xt.shape)
          ).astype(np.float32)
    kw = dict(tol=0.0, maxit=5, lam=1e-3, mesh=mesh)
    out["warm"] = _bres(ba_gmres_sharded_batched(A, BT, b, xt, x0=x0,
                                                 chunk_rhs=2, **kw))
    out["cold"] = _bres(ba_gmres_sharded_batched(A, BT, b, xt, **kw))
    Ad, Bd, b, xt = batched_pair(seed=7)
    A, BT = pair(Ad, Bd)
    B = shard_bucketed_panels(_csr(Bd), P)
    out["layouts"] = {
        "transposed": _bres(ba_gmres_sharded_batched(A, BT, b, xt, **kw)),
        "forward": _bres(ba_gmres_sharded_batched(A, None, b, xt,
                                                  B_panels=B, **kw)),
        "bf16": _bres(ba_gmres_sharded_batched(
            A, BT, b, xt, comm_dtype=torch.bfloat16, **kw))}
    out["single_rhs"] = _error(lambda: ba_gmres_sharded_batched(
        A, BT, b[:, 0], maxit=4, mesh=mesh))
    Ad, Bd, b, xt = batched_pair(seed=15)
    A, BT = pair(Ad, Bd)
    out["gcv_final"] = _bres(ba_gmres_sharded_batched(
        A, BT, b, xt, tol=0.0, maxit=6, lam="gcv-final", mesh=mesh,
        defer_histories=True))
    out["gcv_final_in_loop"] = _error(lambda: ba_gmres_sharded_batched(
        A, BT, b, maxit=4, lam="gcv-final", mesh=mesh))
    Ad, Bd, b, xt = batched_pair(R=5, seed=21)
    A, BT = pair(Ad, Bd)
    x0 = (xt + 0.1 * np.random.default_rng(2).standard_normal(xt.shape)
          ).astype(np.float32)
    kw = dict(tol=0.0, lam=1e-3, mesh=mesh, x0=x0, chunk_rhs=2)
    for kind in ("ab", "ba"):
        part = f[kind](A, BT, b, xt, maxit=4, **kw)
        out[f"resume {kind}"] = {
            "full": _bres(f[kind](A, BT, b, xt, maxit=8, **kw)),
            "resumed": _bres(f[kind](A, BT, b, xt, maxit=8,
                                     resume_from=part, **kw))}
    out["resume_wrong_x0"] = _error(lambda: f["ba"](
        A, BT, b, maxit=8, tol=0.0, lam=1e-3, mesh=mesh, x0=x0 + 0.5,
        chunk_rhs=2, resume_from=part))
    out["resume_deferred"] = _error(lambda: f["ba"](
        A, BT, b, maxit=8, lam=1e-3, mesh=mesh, x0=x0, chunk_rhs=2,
        defer_histories=True, resume_from=part))
    Ad, Bd, b, xt = banded_pair()
    A = shard_bucketed_panels(Ad, P)
    BT = shard_bucketed_panels(Bd.T.tocsr(), P)
    calls0 = _calls(mesh)
    out["windowed"] = _bres(ba_gmres_sharded_batched(
        A, BT, b, xt, tol=0.0, maxit=6, lam=1e-3, mesh=mesh))
    out["windowed"]["calls"] = _calls(mesh) - calls0
    return out


def scase_primitives(mesh, inp):
    """The four multi-RHS primitives on windowed panels at p = 4 (the
    tridiagonal band: L = 3, a window starting at slab -1; the upper band:
    L = 2), R = 3; column j against the single-RHS primitives."""
    import torch

    from hybrid_gmres_tpu_torch.parallel import shard_bucketed_panels
    from hybrid_gmres_tpu_torch.parallel.panels import (
        gather_window, gather_window_mat, local_matmat, local_matvec,
        local_rmatmat_window, local_rmatvec_window,
        scatter_window_to_full_mat, shard_view)

    out = {}
    for name, offsets in (("band", (-40, 0, 40)), ("upper", UPPER_BAND)):
        Ad = banded(P, 13, offsets=offsets)
        view = shard_view(shard_bucketed_panels(Ad, P), mesh.index)
        m, n = Ad.shape
        rng = np.random.default_rng(13)
        X = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
        U = torch.from_numpy(rng.standard_normal((m, 3)).astype(np.float32))
        i, nloc, mloc = mesh.index, n // P, m // P
        X_loc, U_loc = X[i * nloc:(i + 1) * nloc], U[i * mloc:(i + 1) * mloc]
        Xw = gather_window_mat(view, X_loc, mesh)
        Y = local_matmat(view, Xw)
        Zw = local_rmatmat_window(view, U_loc)
        same = all(
            torch.equal(Xw[:, j], gather_window(view, X_loc[:, j], mesh))
            and torch.equal(Y[:, j], local_matvec(
                view, gather_window(view, X_loc[:, j], mesh)))
            and torch.equal(Zw[:, j], local_rmatvec_window(view, U_loc[:, j]))
            for j in range(3))
        out[name] = {
            "windowed": view.windowed, "shifts": np.array(view.shifts),
            "win_start": view.shards[0].win_start,
            "window_strides": np.array(Xw.stride()),
            "Y": mesh.all_gather(Y),
            "Z": mesh.all_reduce(scatter_window_to_full_mat(view, Zw)),
            "columns_equal": same}
    return out


def scase_fleet(mesh, inp):
    """A 2-replica fleet of 2-rank meshes: each replica a sharded batched
    solve of its own frames, no collective across replicas."""
    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded_batched, make_replica_meshes,
        shard_bucketed_panels)

    Ad, Bd, b, xt = batched_pair(R=4, seed=27)
    reps = make_replica_meshes(2, device="cpu")
    mine = next(i for i, r in enumerate(reps) if r.index is not None)
    sl = slice(2 * mine, 2 * mine + 2)
    r = ba_gmres_sharded_batched(
        shard_bucketed_panels(_csr(Ad), 2),
        shard_bucketed_panels(_csr(Bd.T), 2), b[:, sl], xt[:, sl], tol=0.0,
        maxit=6, lam=1e-3, mesh=reps[mine])
    out = _bres(r)
    out["replica"] = mine
    out["sizes"] = np.array([rep.size for rep in reps])
    out["three"] = _error(lambda: make_replica_meshes(3, device="cpu"))
    return out


SOLVER_CASES = {name[6:]: fn for name, fn in globals().items()
                if name.startswith("scase_")}


# --------------------------------------------------------------------------
# The 2-D cases of tests/test_torch_parallel_2d.py.  Each takes the rank's
# 2-D meshes by grid (built once, every rank in the same order) and the
# inputs.
# --------------------------------------------------------------------------

GRIDS = ((2, 2), (4, 1), (1, 4))
SQUARE = (2, 2)      # the grid of the JAX tests that run one (4, 2) grid
WIDE = (1, 4)        # the grid of those that run one (2, 4) grid


def _tiles(a, grid, **kw):
    from hybrid_gmres_tpu_torch.parallel import tile_bucketed_panels

    return tile_bucketed_panels(_csr(a), *grid, **kw)


def tcase_mesh_axes(meshes, inp):
    """The per-axis groups: their ranks, this rank's index on each, a sum
    over each axis and the calls counted there; the card default raises
    without one; a 1-D mesh has no axis groups."""
    import torch
    import torch.distributed as dist

    from hybrid_gmres_tpu_torch.parallel import make_mesh, make_mesh_2d

    out = {}
    me = torch.tensor([float(dist.get_rank())], dtype=torch.float64)
    for g, mesh in meshes.items():
        rows, cols = mesh.axis("rows"), mesh.axis("cols")
        before = (rows.calls["all_reduce"], cols.calls["all_reduce"],
                  mesh.calls["all_reduce"])
        sums = (rows.all_reduce(me.clone()), cols.all_reduce(me.clone()))
        out[str(g)] = {
            "coords": np.array(mesh.coords),
            "ranks": [list(rows.ranks), list(cols.ranks)],
            "index": np.array([rows.index, cols.index]),
            "sums": np.array([float(v) for v in sums]),
            "calls": np.array([rows.calls["all_reduce"] - before[0],
                               cols.calls["all_reduce"] - before[1],
                               mesh.calls["all_reduce"] - before[2]])}
    try:
        make_mesh_2d((2, 2))
        out["cuda"] = "no error"
    except RuntimeError as e:
        out["cuda"] = type(e).__name__
    out["no_axis"] = _error(lambda: make_mesh(device="cpu").axis("rows"))
    return out


def tcase_dense_2d(meshes, inp):
    """The dense 2-D solver (float64) on every grid and lam, the
    divisibility and mesh checks, and lam="gcv" on the square grid."""
    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded_2d, shard_problem_2d)

    A, B, b, xt = dense_prob()
    out = {}
    for g, mesh in meshes.items():
        A2, B2, b2 = shard_problem_2d(A, B, b, mesh)
        for lam in (None, 1e-3):
            out[f"{g} {lam}"] = _res(ba_gmres_sharded_2d(
                A2, B2, b2, xt, tol=1e-10, maxit=16, lam=lam, mesh=mesh))
    out["divisible"] = _error(lambda: shard_problem_2d(
        A[:30], B[:, :30], b[:30], meshes[(4, 1)]))
    out["no_mesh"] = _error(lambda: ba_gmres_sharded_2d(
        A2, B2, b2, None, maxit=4, mesh=None))
    Ad, Bd, b, xt = sparse_pair(64, 32, seed=26)
    mesh = meshes[SQUARE]
    A2, B2, b2 = shard_problem_2d(Ad, Bd, b, mesh)
    out["gcv"] = _res(ba_gmres_sharded_2d(
        A2, B2, b2, xt, tol=0.0, maxit=6, lam="gcv",
        gcv_grid=np.logspace(-6, -1, 12), mesh=mesh))
    return out


def tcase_tiled(meshes, inp):
    """BA/AB on f32 tiles on every grid; int8/int4 A tiles and lam="gcv"
    on one grid."""
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas_2d, ba_gmres_sharded_pallas_2d)

    out = {}
    kw = dict(tol=0.0, lam=1e-3)
    Ad, Bd, b, xt = sparse_pair(64, 32, seed=23)
    for g, mesh in meshes.items():
        A_t, BT_t = _tiles(Ad, g), _tiles(Bd.T, g)
        for kind, f in (("ba", ba_gmres_sharded_pallas_2d),
                        ("ab", ab_gmres_sharded_pallas_2d)):
            out[f"{kind} {g}"] = _res(f(A_t, BT_t, b, xt, maxit=8,
                                        mesh=mesh, **kw))
    Ad, Bd, b, xt = sparse_pair(64, 32, seed=24)
    mesh = meshes[SQUARE]
    for dtype in ("int8", "int4"):
        out[dtype] = _res(ba_gmres_sharded_pallas_2d(
            _tiles(Ad, SQUARE, dtype=dtype), _tiles(Bd.T, SQUARE), b, xt,
            maxit=6, mesh=mesh, **kw))
    Ad, Bd, b, xt = sparse_pair(64, 32, seed=25)
    out["gcv"] = _res(ba_gmres_sharded_pallas_2d(
        _tiles(Ad, SQUARE), _tiles(Bd.T, SQUARE), b, xt, tol=0.0, maxit=6,
        lam="gcv", gcv_grid=np.logspace(-6, -1, 12), mesh=mesh))
    return out


def tcase_forward(meshes, inp):
    """The forward-layout B tiles on every grid (BA and AB), int8 forward
    tiles on the square grid, and wrong-grid tiles refused."""
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas_2d, ba_gmres_sharded_pallas_2d,
        tile_backprojector_forward)

    Ad, Bd, b, xt = sparse_pair(64, 32, seed=29)
    kw = dict(tol=0.0, maxit=6, lam=1e-3)
    out = {}
    for g, mesh in meshes.items():
        A_t = _tiles(Ad, g)
        B_t = tile_backprojector_forward(_csr(Bd), *g)
        for kind, f in (("ba", ba_gmres_sharded_pallas_2d),
                        ("ab", ab_gmres_sharded_pallas_2d)):
            out[f"{kind} {g}"] = _res(f(A_t, None, b, xt, mesh=mesh,
                                        B_tiles=B_t, **kw))
    mesh, A_t = meshes[SQUARE], _tiles(Ad, SQUARE)
    out["int8"] = _res(ba_gmres_sharded_pallas_2d(
        A_t, None, b, xt, mesh=mesh, B_tiles=tile_backprojector_forward(
            _csr(Bd), *SQUARE, dtype=np.int8), **kw))
    out["wrong_grid"] = _error(lambda: ba_gmres_sharded_pallas_2d(
        A_t, None, b, xt, maxit=4, mesh=mesh,
        B_tiles=_tiles(Bd, SQUARE)))
    return out


def tcase_gmres_modes(meshes, inp):
    """Warm start, resume and the restarted wrappers, BA and AB, on the
    square grid."""
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas_2d, ab_gmres_sharded_pallas_2d_restarted,
        ba_gmres_sharded_pallas_2d, ba_gmres_sharded_pallas_2d_restarted)

    mesh = meshes[SQUARE]
    solvers = {"ba": (ba_gmres_sharded_pallas_2d,
                      ba_gmres_sharded_pallas_2d_restarted),
               "ab": (ab_gmres_sharded_pallas_2d,
                      ab_gmres_sharded_pallas_2d_restarted)}
    out = {}
    for kind, (f, f_rst) in solvers.items():
        Ad, Bd, b, xt = sparse_pair(64, 32, seed=11)
        x0 = (xt + 0.2 * np.random.default_rng(3).standard_normal(
            xt.shape)).astype(np.float32)
        out[f"x0 {kind}"] = _res(f(_tiles(Ad, SQUARE), _tiles(Bd.T, SQUARE),
                                   b, xt, tol=0.0, maxit=6, lam=1e-3,
                                   mesh=mesh, x0=x0))
        Ad, Bd, b, xt = sparse_pair(64, 32, seed=12)
        A_t, BT_t = _tiles(Ad, SQUARE), _tiles(Bd.T, SQUARE)
        kw = dict(tol=0.0, lam=1e-3, mesh=mesh)
        part = f(A_t, BT_t, b, xt, maxit=4, **kw)
        out[f"resume {kind}"] = {
            "full": _res(f(A_t, BT_t, b, xt, maxit=8, **kw)),
            "resumed": _res(f(A_t, BT_t, b, xt, maxit=8, resume_from=part,
                              **kw))}
        Ad, Bd, b, xt = sparse_pair(64, 32, seed=13)
        out[f"restarted {kind}"] = _res(f_rst(
            _tiles(Ad, SQUARE), _tiles(Bd.T, SQUARE), b, xt, tol=1e-10,
            restart=4, max_restarts=2, lam=1e-3, mesh=mesh))
    return out


def tcase_gkb(meshes, inp):
    """The four GKB solvers on every grid; reorth on the wide grid (and
    the hybrid LSQR's, whose augmented space sums over both axes, on the
    square one)."""
    from hybrid_gmres_tpu_torch.parallel import (
        hybrid_lsmr_sharded_2d, hybrid_lsqr_sharded_2d, lsmr_sharded_2d,
        lsqr_sharded_2d)

    Ad, _, b, xt = sparse_pair(64, 32, seed=41)
    kw = dict(tol=0.0, maxit=10)
    out = {}
    for g, mesh in meshes.items():
        t = _tiles(Ad, g)
        out[f"lsqr {g}"] = _gkb(lsqr_sharded_2d(t, b, xt, mesh=mesh, **kw))
        out[f"hybrid_lsqr {g}"] = _gkb(hybrid_lsqr_sharded_2d(
            t, b, xt, lam=1e-2, mesh=mesh, **kw))
        out[f"lsmr {g}"] = _gkb(lsmr_sharded_2d(t, b, xt, mesh=mesh, **kw))
        for lam in (1e-2, "gcv"):
            out[f"hybrid_lsmr {lam} {g}"] = _gkb(hybrid_lsmr_sharded_2d(
                t, b, xt, lam=lam, mesh=mesh, **kw))
    for name, f, g, extra in (
            ("lsqr", lsqr_sharded_2d, WIDE, {}),
            ("lsmr", lsmr_sharded_2d, WIDE, {}),
            ("hybrid_lsmr", hybrid_lsmr_sharded_2d, WIDE, {"lam": 1e-2}),
            ("hybrid_lsqr", hybrid_lsqr_sharded_2d, SQUARE, {"lam": 1e-2})):
        out[f"reorth {name}"] = _gkb(f(_tiles(Ad, g), b, xt, mesh=meshes[g],
                                       reorth=True, **kw, **extra))
    return out


def tcase_gkb_modes(meshes, inp):
    """Warm starts (both hybrid LSMR semantics) and resume, with and without
    reorth, on the wide grid; a reorth mismatch and a changed x0 refused."""
    from hybrid_gmres_tpu_torch.parallel import (
        hybrid_lsmr_sharded_2d, hybrid_lsqr_sharded_2d, lsmr_sharded_2d,
        lsqr_sharded_2d)

    Ad, _, b, xt = sparse_pair(64, 32, seed=41)
    mesh, t = meshes[WIDE], _tiles(Ad, WIDE)
    x0 = (xt + 0.2 * np.random.default_rng(7).standard_normal(xt.shape)
          ).astype(np.float32)
    out = {}
    for name, f, kw in (
            ("lsqr", lsqr_sharded_2d, {}), ("lsmr", lsmr_sharded_2d, {}),
            ("hybrid_lsqr", hybrid_lsqr_sharded_2d, {"lam": 1e-2}),
            ("hybrid_lsmr", hybrid_lsmr_sharded_2d, {"lam": 1e-2}),
            ("hybrid_lsmr full", hybrid_lsmr_sharded_2d,
             {"lam": 1e-2, "x0_reg": "full"})):
        out[f"x0 {name}"] = _gkb(f(t, b, xt, tol=0.0, maxit=8, mesh=mesh,
                                   x0=x0, **kw))
    x0 = (xt + 0.2 * np.random.default_rng(9).standard_normal(xt.shape)
          ).astype(np.float32)
    for name, f, kw in (("lsqr", lsqr_sharded_2d, {}),
                        ("lsmr", lsmr_sharded_2d, {}),
                        ("hybrid_lsqr", hybrid_lsqr_sharded_2d,
                         {"lam": 1e-2})):
        for reorth in (False, True):
            kws = dict(mesh=mesh, x0=x0, reorth=reorth, tol=0.0, **kw)
            part = f(t, b, xt, maxit=4, **kws)
            out[f"resume {name} {reorth}"] = {
                "full": _gkb(f(t, b, xt, maxit=8, **kws)),
                "resumed": _gkb(f(t, b, xt, maxit=8, resume_from=part.state,
                                  **kws))}
        out[f"resume {name} reorth mismatch"] = _error(lambda: f(
            t, b, xt, maxit=8, mesh=mesh, x0=x0, reorth=False,
            resume_from=part.state, **kw))
        out[f"resume {name} x0 changed"] = _error(lambda: f(
            t, b, xt, maxit=8, mesh=mesh, x0=2.0 * x0, reorth=True,
            resume_from=part.state, **kw))
    return out


def tcase_batched(meshes, inp):
    """The 2-D serving batch, BA and AB with warm starts, deferred, and the
    forward B layout, on the square grid; the NCCL calls of R=3 and R=1
    per axis."""
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_batched_2d, ba_gmres_sharded_batched_2d,
        tile_backprojector_forward)

    Ad, Bd, b, xt = batched_pair(seed=31)
    mesh = meshes[SQUARE]
    A_t, BT_t = _tiles(Ad, SQUARE), _tiles(Bd.T, SQUARE)
    x0 = (xt + 0.1 * np.random.default_rng(2).standard_normal(xt.shape)
          ).astype(np.float32)
    kw = dict(tol=0.0, maxit=6, lam=1e-3, mesh=mesh, x0=x0)
    out = {}
    for kind, f in (("ba", ba_gmres_sharded_batched_2d),
                    ("ab", ab_gmres_sharded_batched_2d)):
        out[kind] = _bres(f(A_t, BT_t, b, xt, **kw))
        out[f"{kind} deferred"] = _bres(f(A_t, BT_t, b, xt,
                                          defer_histories=True, **kw))
    out["ba forward"] = _bres(ba_gmres_sharded_batched_2d(
        A_t, None, b, xt, B_tiles=tile_backprojector_forward(
            _csr(Bd), *SQUARE), **kw))
    axes = [mesh.axis("rows"), mesh.axis("cols")]
    for R in (3, 1):
        before = [_calls(a) for a in axes]
        ba_gmres_sharded_batched_2d(A_t, BT_t, b[:, :R], xt[:, :R],
                                    **dict(kw, x0=x0[:, :R]))
        out[f"calls R={R}"] = np.stack([_calls(a) - c
                                        for a, c in zip(axes, before)])
    return out


def tcase_converted(meshes, inp):
    """The BA 2-D solver on tiles carried over from the JAX package."""
    from hybrid_gmres_tpu_torch.parallel import ba_gmres_sharded_pallas_2d
    from hybrid_gmres_tpu_torch.utils.convert import tiled_panels_from_numpy

    A_leaves, BT_leaves = inp["converted_2d"]
    _, _, b, xt = sparse_pair(64, 32, seed=23)
    return _res(ba_gmres_sharded_pallas_2d(
        tiled_panels_from_numpy(**A_leaves, device="cpu"),
        tiled_panels_from_numpy(**BT_leaves, device="cpu"), b, xt, tol=0.0,
        maxit=6, lam=1e-3, mesh=meshes[SQUARE]))


def tcase_dryrun(meshes, inp):
    """The dry run on the 4 ranks: the tags of every tier it held."""
    from hybrid_gmres_tpu_torch.parallel.dryrun import dryrun_multichip

    return {"tags": dryrun_multichip(P, device="cpu"),
            "wrong_size": _error_any(lambda: dryrun_multichip(
                P + 1, device="cpu"))}


def _error_any(call):
    try:
        call()
    except (RuntimeError, ValueError) as e:
        return type(e).__name__
    return "no error"


CASES_2D = {name[6:]: fn for name, fn in globals().items()
            if name.startswith("tcase_")}


def _worker(rank, port, inputs, queue, group):
    import torch
    import torch.distributed as dist

    from hybrid_gmres_tpu_torch.parallel import make_mesh, make_mesh_2d

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=P, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_mesh(device="cpu")
        if group == "2d":
            mesh = {g: make_mesh_2d(g, device="cpu") for g in GRIDS}
        for name, fn in {"cases": CASES, "solvers": SOLVER_CASES,
                         "2d": CASES_2D}[group].items():
            try:
                out[name] = _np(fn(mesh, inputs))
            except Exception as e:  # recorded; the test of the case fails
                out[name] = {"error": type(e).__name__, "message": str(e),
                             "traceback": traceback.format_exc()}
    finally:
        queue.put((rank, out))
        dist.destroy_process_group()


def spawn(inputs, timeout=300, group="cases"):
    """Run every case of ``group`` (``"cases"``: :data:`CASES`,
    ``"solvers"``: :data:`SOLVER_CASES`, ``"2d"``: :data:`CASES_2D` on the
    meshes of :data:`GRIDS`) on ``P`` gloo ranks; returns each rank's
    results, in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, port, inputs, queue, group))
             for r in range(P)]
    for proc in procs:
        proc.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
    return [got[r] for r in range(P)]
