"""The multi-device dry run: every sharded tier, one short solve each, held
to its single-device solve (PyTorch twin of ``dryrun_multichip`` in the JAX
package's entry module, ``__graft_entry__.py``).

On a tiny mismatched pair (m = 8 N, n = 4 N for N ranks) each rank runs the
1-D tiers on a mesh of the N ranks (dense slabs, the row-sharded basis,
panels in both layouts, int4 panels, the bf16 wire, the RTP and restarted
solvers, the GKB family on dense slabs, panels, an adjoint pair, a composed
operator and an int8 pair, the serving batch) and, when N is even, the 2-D
tier on a (N/2, 2) mesh (dense blocks, transposed and forward tiles, the
GKB family, the restarted wrapper, the serving batch and its resume, LSQR
with ``reorth``, ``x0`` and a resume).  Each result is held to the
single-device solve of the same matrices by the JAX rule: the NaN masks of
the residual and error histories equal, their relative gaps below 2e-4
(3e-2 for the bf16 wire).

    python -m hybrid_gmres_tpu_torch.parallel.dryrun --cpu 4   # 4 gloo ranks
    torchrun --nproc_per_node=4 -m hybrid_gmres_tpu_torch.parallel.dryrun

The first spawns the ranks on the CPU; under ``torchrun`` the ranks run on
their cards over NCCL.  There is no fallback: without ``--cpu`` and
without a ``torchrun`` job it exits with an error.
"""

from __future__ import annotations

import argparse
import datetime
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

TOL = 2e-4
WIRE_TOL = 3e-2


def _check(tag, got, want, tol=TOL):
    """The JAX ``_check``: equal NaN masks, then every finite entry of the
    residual and error histories within ``tol`` relative (floor 1e-6)."""
    for name in ("res_hist", "err_hist"):
        g = getattr(got, name).detach().cpu().double().numpy()
        w = getattr(want, name).detach().cpu().double().numpy()
        mask = np.isfinite(w)
        if not np.array_equal(mask, np.isfinite(g)):
            raise AssertionError(f"{tag}: {name} NaN mask mismatch: {g} vs "
                                 f"{w}")
        if mask.any():
            d = np.max(np.abs(g[mask] - w[mask])
                       / np.maximum(np.abs(w[mask]), 1e-6))
            if not d < tol:
                raise AssertionError(f"{tag}: {name} rel diff {d:.2e} >= "
                                     f"{tol}")


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """One short solve of every sharded tier over ``n_devices`` ranks, each
    held to its single-device solve (:func:`_check`); run it on every rank
    of an initialized ``torch.distributed`` group of exactly ``n_devices``
    ranks (raises otherwise).  ``device``: ``"cuda"`` (NCCL, this rank's
    card) or ``"cpu"`` (gloo).  Returns the tags checked."""
    import scipy.sparse as sp

    from hybrid_gmres_tpu_torch.ops.linear_operator import DenseOperator
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _row_quantize_csr
    from hybrid_gmres_tpu_torch.parallel import (
        ComposedPanels, PanelsWithAdjoint, ab_gmres_rtp_sharded,
        ab_gmres_sharded_pallas, ba_gmres_rtp_sharded, ba_gmres_sharded,
        ba_gmres_sharded_basis, ba_gmres_sharded_batched,
        ba_gmres_sharded_pallas, ba_gmres_sharded_pallas_restarted,
        build_panels_with_adjoint, hybrid_lsmr_sharded, hybrid_lsqr_sharded,
        lsmr_sharded, lsqr_sharded, make_mesh, shard_bucketed_panels,
        shard_problem)
    from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched
    from hybrid_gmres_tpu_torch.solvers.gmres import (
        ab_gmres, ba_gmres, ba_gmres_restarted)
    from hybrid_gmres_tpu_torch.solvers.lsmr import hybrid_lsmr, lsmr
    from hybrid_gmres_tpu_torch.solvers.lsqr import hybrid_lsqr, lsqr
    from hybrid_gmres_tpu_torch.solvers.rtp import ab_gmres_rtp, ba_gmres_rtp

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"need an initialized process group of "
                           f"{n_devices} ranks (torchrun, or --cpu)")
    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the group has "
                           f"{dist.get_world_size()}")
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    done = []

    def check(tag, got, want, tol=TOL):
        _check(tag, got, want, tol)
        done.append(tag)

    # the tiny mismatched pair, both dims divisible by the mesh size
    m, n = 8 * n_devices, 4 * n_devices
    rng = np.random.default_rng(0)
    A_np = (rng.standard_normal((m, n)) * 0.1 + np.eye(m, n)).astype(
        np.float32)
    B_np = (A_np.T + 1e-4 * rng.standard_normal((n, m))).astype(np.float32)
    xt_np = rng.standard_normal(n).astype(np.float32)
    A, B, x_true = (torch.as_tensor(v, device=dev)
                    for v in (A_np, B_np, xt_np))
    b = A @ x_true
    Ad, Bd = DenseOperator(A), DenseOperator(B)
    gkb = dict(tol=1e-8, maxit=3)
    gm = dict(tol=1e-8, lam=1e-3)

    ref_ba4 = ba_gmres(Ad, Bd, b, x_true, maxit=4, **gm)
    A_s, B_s, b_s = shard_problem(A, B, b, mesh)
    check("ba_gmres_sharded", ba_gmres_sharded(
        A_s, B_s, b_s, x_true, maxit=4, mesh=mesh, **gm), ref_ba4)
    check("ba_gmres_sharded_basis", ba_gmres_sharded_basis(
        A_s, B_s, b_s, x_true, maxit=4, mesh=mesh, residual="fused", **gm),
        ref_ba4)

    csr_A, csr_B = sp.csr_matrix(A_np), sp.csr_matrix(B_np)
    A_panels = shard_bucketed_panels(csr_A, n_devices)
    BT_panels = shard_bucketed_panels(csr_B.T.tocsr(), n_devices)
    ref_ba2 = ba_gmres(Ad, Bd, b, x_true, maxit=2, **gm)
    check("ba_gmres_sharded_pallas", ba_gmres_sharded_pallas(
        A_panels, BT_panels, b, x_true, maxit=2, mesh=mesh, **gm), ref_ba2)
    # int4 panels against the exactly quantized operator diag(s) Q
    q4, s4 = _row_quantize_csr(csr_A, qmax=7)
    Aq4 = torch.as_tensor(s4[:, None] * q4.toarray(), dtype=torch.float32,
                          device=dev)
    check("ab_gmres_sharded_pallas[int4]", ab_gmres_sharded_pallas(
        shard_bucketed_panels(csr_A, n_devices, dtype="int4"), BT_panels,
        b, x_true, maxit=2, mesh=mesh, **gm),
        ab_gmres(DenseOperator(Aq4), Bd, b, x_true, maxit=2, **gm))

    if n_devices % 2 == 0:
        done += _dryrun_2d(n_devices, device, A, B, b, x_true, Ad, Bd)

    check("hybrid_lsqr_sharded", hybrid_lsqr_sharded(
        A, b, x_true, lam=1e-3, mesh=mesh, **gkb),
        hybrid_lsqr(Ad, b, x_true, lam=1e-3, **gkb))
    check("lsmr_sharded", lsmr_sharded(A, b, x_true, mesh=mesh, **gkb),
          lsmr(Ad, b, x_true, **gkb))
    ref_lq = lsqr(Ad, b, x_true, **gkb)
    check("lsqr_sharded[panels]", lsqr_sharded(
        A_panels, b, x_true, mesh=mesh, **gkb), ref_lq)
    rtp = dict(tol=0.0, maxit=3, lam=1e-3)
    check("ba_gmres_rtp_sharded", ba_gmres_rtp_sharded(
        A_panels, BT_panels, b, x_true, mesh=mesh, **rtp),
        ba_gmres_rtp(Ad, Bd, b, x_true, **rtp))
    check("ab_gmres_rtp_sharded", ab_gmres_rtp_sharded(
        A_panels, BT_panels, b, x_true, mesh=mesh, **rtp),
        ab_gmres_rtp(Ad, Bd, b, x_true, **rtp))
    rst = dict(tol=1e-10, restart=2, max_restarts=2, lam=1e-3)
    check("ba_gmres_sharded_pallas_restarted",
          ba_gmres_sharded_pallas_restarted(A_panels, BT_panels, b, x_true,
                                            mesh=mesh, **rst),
          ba_gmres_restarted(Ad, Bd, b, x_true, **rst))
    check("ba_gmres_sharded_pallas[forward B]", ba_gmres_sharded_pallas(
        A_panels, None, b, x_true, maxit=2, mesh=mesh,
        B_panels=shard_bucketed_panels(csr_B, n_devices), **gm), ref_ba2)
    check("ba_gmres_sharded_pallas[bf16 wire]", ba_gmres_sharded_pallas(
        A_panels, BT_panels, b, x_true, maxit=2, mesh=mesh,
        comm_dtype=torch.bfloat16, **gm), ref_ba2, tol=WIRE_TOL)
    check("lsqr_sharded[PanelsWithAdjoint]", lsqr_sharded(
        PanelsWithAdjoint(A_panels, shard_bucketed_panels(
            csr_A.T.tocsr(), n_devices)), b, x_true, mesh=mesh, **gkb),
        ref_lq)
    check("hybrid_lsmr_sharded", hybrid_lsmr_sharded(
        A, b, x_true, lam=1e-3, mesh=mesh, **gkb),
        hybrid_lsmr(Ad, b, x_true, lam=1e-3, **gkb))
    # the composed hybrid: B A through the panels of A and B^T
    rhs_c = B @ b
    check("hybrid_lsqr_sharded[ComposedPanels]", hybrid_lsqr_sharded(
        ComposedPanels(A_panels, BT_panels, "ba"), rhs_c, x_true, lam=1e-3,
        mesh=mesh, **gkb),
        hybrid_lsqr(DenseOperator(B @ A), rhs_c, x_true, lam=1e-3, **gkb))
    q8, s8 = _row_quantize_csr(csr_A, qmax=127)
    Aq8 = torch.as_tensor(s8[:, None] * q8.toarray(), dtype=torch.float32,
                          device=dev)
    check("lsqr_sharded[int8 PanelsWithAdjoint]", lsqr_sharded(
        build_panels_with_adjoint(csr_A, n_devices, dtype=np.int8), b,
        x_true, mesh=mesh, **gkb), lsqr(DenseOperator(Aq8), b, x_true, **gkb))
    Xt, Bb = _batch(A, n, dev)
    bat = dict(tol=0.0, maxit=2, lam=1e-3)
    ref_bt = ba_gmres_batched(Ad, Bd, Bb, Xt, chunk_rhs=None, **bat)
    check("ba_gmres_sharded_batched", ba_gmres_sharded_batched(
        A_panels, BT_panels, Bb, Xt, mesh=mesh, **bat), ref_bt)
    check("ba_gmres_sharded_batched[deferred]", ba_gmres_sharded_batched(
        A_panels, BT_panels, Bb, Xt, mesh=mesh, defer_histories=True,
        **bat), ref_bt)
    return done


def _batch(A, n, dev, R=2):
    """The serving batch's R true images and sinograms."""
    rng = np.random.default_rng(7)
    Xt = torch.as_tensor(rng.standard_normal((n, R)), dtype=torch.float32,
                         device=dev)
    return Xt, A @ Xt


def _dryrun_2d(n_devices, device, A, B, b, x_true, Ad, Bd):
    """The 2-D tier on a (N/2, 2) mesh; returns the tags checked."""
    import scipy.sparse as sp

    from hybrid_gmres_tpu_torch.parallel import (
        ba_gmres_sharded_2d, ba_gmres_sharded_batched_2d,
        ba_gmres_sharded_pallas_2d, ba_gmres_sharded_pallas_2d_restarted,
        hybrid_lsmr_sharded_2d, lsqr_sharded_2d, make_mesh_2d,
        shard_problem_2d, tile_backprojector_forward, tile_bucketed_panels)
    from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched
    from hybrid_gmres_tpu_torch.solvers.gmres import (ba_gmres,
                                                      ba_gmres_restarted)
    from hybrid_gmres_tpu_torch.solvers.lsmr import hybrid_lsmr
    from hybrid_gmres_tpu_torch.solvers.lsqr import lsqr

    grid = (n_devices // 2, 2)
    mesh2 = make_mesh_2d(grid, device=device)
    done = []

    def check(tag, got, want):
        _check(tag, got, want)
        done.append(tag)

    gm = dict(tol=1e-8, lam=1e-3)
    ref_ba3 = ba_gmres(Ad, Bd, b, x_true, maxit=3, **gm)
    A2, B2, b2 = shard_problem_2d(A, B, b, mesh2)
    check("ba_gmres_sharded_2d", ba_gmres_sharded_2d(
        A2, B2, b2, x_true, maxit=3, mesh=mesh2, **gm), ref_ba3)
    csr_A = sp.csr_matrix(A.cpu().numpy())
    csr_B = sp.csr_matrix(B.cpu().numpy())
    A_t = tile_bucketed_panels(csr_A, *grid)
    BT_t = tile_bucketed_panels(csr_B.T.tocsr(), *grid)
    check("ba_gmres_sharded_pallas_2d", ba_gmres_sharded_pallas_2d(
        A_t, BT_t, b, x_true, maxit=3, mesh=mesh2, **gm), ref_ba3)
    check("ba_gmres_sharded_pallas_2d[forward B]",
          ba_gmres_sharded_pallas_2d(
              A_t, None, b, x_true, maxit=3, mesh=mesh2,
              B_tiles=tile_backprojector_forward(csr_B, *grid), **gm),
          ref_ba3)
    gkb = dict(tol=1e-8, maxit=3)
    check("lsqr_sharded_2d",
          lsqr_sharded_2d(A_t, b, x_true, mesh=mesh2, **gkb),
          lsqr(Ad, b, x_true, **gkb))
    check("hybrid_lsmr_sharded_2d", hybrid_lsmr_sharded_2d(
        A_t, b, x_true, lam=1e-3, mesh=mesh2, **gkb),
        hybrid_lsmr(Ad, b, x_true, lam=1e-3, **gkb))
    rst = dict(tol=1e-10, restart=2, max_restarts=2, lam=1e-3)
    check("ba_gmres_sharded_pallas_2d_restarted",
          ba_gmres_sharded_pallas_2d_restarted(A_t, BT_t, b, x_true,
                                               mesh=mesh2, **rst),
          ba_gmres_restarted(Ad, Bd, b, x_true, **rst))
    Xt, Bb = _batch(A, A.shape[1], A.device)
    bat = dict(tol=0.0, lam=1e-3)
    ref_bt = ba_gmres_batched(Ad, Bd, Bb, Xt, maxit=2, chunk_rhs=None, **bat)
    check("ba_gmres_sharded_batched_2d", ba_gmres_sharded_batched_2d(
        A_t, BT_t, Bb, Xt, maxit=2, mesh=mesh2, **bat), ref_bt)
    part = ba_gmres_sharded_batched_2d(A_t, BT_t, Bb, Xt, maxit=1,
                                       mesh=mesh2, **bat)
    check("ba_gmres_sharded_batched_2d[resume]", ba_gmres_sharded_batched_2d(
        A_t, BT_t, Bb, Xt, maxit=2, mesh=mesh2, resume_from=part, **bat),
        ref_bt)
    # reorth + warm start + an exact resume on the 2-D layout
    x0 = 0.5 * x_true
    part = lsqr_sharded_2d(A_t, b, x_true, tol=1e-8, maxit=2, mesh=mesh2,
                           reorth=True, x0=x0)
    check("lsqr_sharded_2d[reorth+x0+resume]", lsqr_sharded_2d(
        A_t, b, x_true, mesh=mesh2, reorth=True, x0=x0,
        resume_from=part.state, **gkb),
        lsqr(Ad, b, x_true, reorth=True, x0=x0, **gkb))
    return done


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_rank(rank, n, port, queue):
    """One gloo rank of ``--cpu``: joins the group, runs the dry run and
    reports (rank, tags or the error)."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=120))
    try:
        queue.put((rank, dryrun_multichip(n, device="cpu")))
    except Exception as e:  # reported to the parent, which fails
        queue.put((rank, f"{type(e).__name__}: {e}"))
    finally:
        dist.destroy_process_group()


def run_cpu(n: int, timeout: float = 600) -> list:
    """The dry run on ``n`` spawned gloo ranks; returns rank 0's tags and
    raises when a rank failed."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_cpu_rank, args=(r, n, port, queue))
             for r in range(n)]
    for proc in procs:
        proc.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
    bad = {r: v for r, v in got.items() if isinstance(v, str)}
    if bad:
        raise RuntimeError(f"dry run failed on ranks {bad}")
    return got[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", type=int, metavar="N",
                    help="spawn N gloo ranks on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        tags = run_cpu(args.cpu)
        print(f"dryrun ok on {args.cpu} gloo ranks: {len(tags)} tiers")
        return 0
    from hybrid_gmres_tpu_torch.parallel.multihost import initialize_multihost

    if not initialize_multihost():
        print("no torchrun job: run under torchrun, or pass --cpu N",
              file=sys.stderr)
        return 2
    try:
        tags = dryrun_multichip(dist.get_world_size())
        if dist.get_rank() == 0:
            print(f"dryrun ok on {dist.get_world_size()} NCCL ranks: "
                  f"{len(tags)} tiers")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
