"""The port's side of ``tests/test_torch_parallel.py``, run on 4 gloo ranks.

This module imports no JAX: :func:`spawn` starts the ranks with the
``spawn`` method, each imports this module afresh, joins one gloo process
group on localhost, runs every case of :data:`CASES` on the inputs the test
module made (numpy arrays) and sends its results back as numpy arrays.  A
case that raises records the exception's type and message instead, on
every rank alike (every case raises, if at all, before its first
collective).
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


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _worker(rank, port, inputs, queue):
    import torch
    import torch.distributed as dist

    from hybrid_gmres_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=P, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = make_mesh(device="cpu")
        for name, fn in CASES.items():
            try:
                out[name] = _np(fn(mesh, inputs))
            except Exception as e:  # recorded; the test of the case fails
                out[name] = {"error": type(e).__name__, "message": str(e),
                             "traceback": traceback.format_exc()}
    finally:
        queue.put((rank, out))
        dist.destroy_process_group()


def spawn(inputs, timeout=300):
    """Run every case on ``P`` gloo ranks; returns each rank's results, in
    rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, port, inputs, queue))
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
