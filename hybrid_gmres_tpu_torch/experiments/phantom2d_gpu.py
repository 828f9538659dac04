"""2-D CT phantom reconstruction on the card (counterpart of the JAX
package's ``phantom2d_tpu``).

The flagship reference driver (``run_2D_phantom.m:5-9`` scenario, scaled to
the bench geometry) end to end on the production path: n=64 Shepp-Logan,
180x180 fan-beam, mismatched (A, B), 25% noise — int8 Morton-ordered
operators (``ct_gpu_operators``), fused exact residual, hybrid BA-GMRES
through the redesigned K1, plus the serving surfaces: an R-frame batched
solve with deferred histories through the redesigned K2, cold and
warm-started from the previous frame.

On the card the reconstruction quality is asserted against the stored
exact-f32 reference for this scenario (min-over-k rel-err 0.4328 +-3%, the
bench.py quality gate), for the single solve and for the worst batched
frame: a fast-path regression fails the experiment, not just the benchmark.

The driver runs exactly the ``Config`` it is given, on the device it names.
``device="cpu"`` runs the same configuration on the CPU (the operators
through the kernels' plain versions); there the gate only checks that the
error is finite, as the stored reference belongs to the card's scenario.
``dtype`` is ``"int8"`` (the production operators) or ``"dense-f32"``
(dense float32 matrices, the JAX driver's off-chip operators).

    python -m hybrid_gmres_tpu_torch.experiments phantom2d_gpu
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hybrid_gmres_tpu_torch.experiments.common import (
    get_pyplot,
    host,
    save_figure,
)
from hybrid_gmres_tpu_torch.ops.ordering import inverse_perm
from hybrid_gmres_tpu_torch.problems.ct import ct_gpu_operators, ct_mismatched
from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched
from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres
from hybrid_gmres_tpu_torch.utils.device import require_device
from hybrid_gmres_tpu_torch.utils.profiling import benchmark

# bench.py's stored exact-f32 reference for this exact scenario
MIN_ERR_F32_REFERENCE = 0.4328
MIN_ERR_TOLERANCE = 1.03
DTYPES = ("int8", "dense-f32")


@dataclass
class Config:
    n: int = 64                  # run_2D_phantom.m:5 (bench geometry)
    n_angles: int = 180
    n_det: int = 180
    noise_level: float = 0.25    # :6
    maxit: int = 100
    lam: float = 1e-2            # :8
    dtype: str = "int8"          # production operators, or "dense-f32"
    R: int = 4                   # serving frames in the batched solve
    seed: int = 0
    device: str = "cuda"


@dataclass
class Results:
    cfg: Config
    backend: str                 # the card's name, or "cpu"
    min_err: float               # min-over-k rel error, single solve
    final_err: float
    niters: int
    it_per_s: float              # wall iterations/s of the timed solve
    batched_min_err_worst: float  # worst per-frame min-err, R frames
    warm_iters_to_gate: int      # successive frame, warm-started
    cold_iters_to_gate: int
    gate: float
    err_hist: np.ndarray = field(repr=False, default=None)
    batched_err_hists: np.ndarray = field(repr=False, default=None)
    recon: np.ndarray = field(repr=False, default=None)   # (n, n) image
    sino: np.ndarray = field(repr=False, default=None)


def _noise(b_exact, level, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(b_exact.shape)
    e = e / np.linalg.norm(e) * level * float(np.linalg.norm(b_exact))
    return (np.asarray(b_exact) + e).astype(np.float32)


def iters_to_gate(e, g):
    """First iteration (1-based) whose error is at most ``g``; -1 if none."""
    hit = e <= g
    return int(np.argmax(hit) + 1) if hit.any() else -1


def operators(prob, dtype, device):
    """``(A, B, x_true, ray_perm, unpix)`` for ``dtype``: the int8
    Morton-ordered operators of ``ct_gpu_operators``, or dense float32
    matrices in the natural order."""
    if dtype == "int8":
        A_op, B_op, _, x_true_p, ray_perm, pix_perm = ct_gpu_operators(
            prob, dtype="int8", device=device)
        return (A_op, B_op, x_true_p.to(torch.float32), ray_perm,
                inverse_perm(pix_perm))
    like = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(prob.A_csr.toarray(), **like),
            torch.as_tensor(prob.B_csr.toarray(), **like),
            torch.as_tensor(prob.x_true, **like),
            np.arange(prob.b_exact.shape[0]),
            np.arange(prob.x_true.shape[0]))


def run(cfg: Config | None = None) -> Results:
    cfg = cfg or Config()
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: use one of {DTYPES}")
    dev = require_device(cfg.device)
    prob = ct_mismatched(n=cfg.n, n_angles=cfg.n_angles, n_det=cfg.n_det)
    A_op, B_op, xt, rp, unpix = operators(prob, cfg.dtype, dev)
    b_noisy = _noise(prob.b_exact, cfg.noise_level, cfg.seed)
    b = torch.as_tensor(b_noisy[rp], device=dev)

    def solve(maxit=cfg.maxit):
        return ba_gmres(A_op, B_op, b, xt, tol=0.0, maxit=maxit,
                        lam=cfg.lam, residual="fused")

    # the first solve is the warm-up and gives the result (every solve of
    # the same inputs gives the same numbers); then the best of 3
    r = solve()
    err_hist = host(r.err_hist)
    it_per_s = cfg.maxit / benchmark(solve, iters=3, warmup=0)["best_s"]
    min_err = float(np.nanmin(err_hist))
    niters = int(r.niters)
    final_err = float(err_hist[niters - 1])
    recon = host(r.x)[unpix].reshape(cfg.n, cfg.n)

    # serving surfaces: R frames batched (fresh noise per frame), then a
    # successive frame warm-started from the gate-stopped first solve
    gate = MIN_ERR_F32_REFERENCE * MIN_ERR_TOLERANCE
    cols = [_noise(prob.b_exact, cfg.noise_level, cfg.seed + 1 + i)[rp]
            for i in range(cfg.R)]
    b_batch = torch.as_tensor(np.stack(cols, axis=1), device=dev)
    nx = xt.shape[0]

    def batched(x0):
        # one call shape serves cold (zero x0) and warm, as in the JAX
        # driver; defer_histories = the serving mode
        return ba_gmres_batched(A_op, B_op, b_batch, xt, tol=0.0,
                                maxit=cfg.maxit, lam=cfg.lam, x0=x0,
                                defer_histories=True)

    rb = batched(torch.zeros((nx, cfg.R), dtype=torch.float32, device=dev))
    batched_err = host(rb.err_hist)
    batched_worst = float(np.nanmax(np.nanmin(batched_err, axis=0)))
    cold_k = iters_to_gate(batched_err[:, 0], gate)
    # serving flow: the PREVIOUS frame (b, seed 0) stops at ITS OWN gate
    # crossing (semi-convergent solvers must not run past it — the final
    # maxit iterate is the over-fitted one); its solution seeds the next
    # frames.  On the card's scenario the gate is asserted reachable below;
    # a configuration that never crosses it stops after one step.
    k_stop = max(iters_to_gate(err_hist, gate), 1)
    r_stop = solve(maxit=k_stop)
    rw = batched(r_stop.x[:, None].expand(nx, cfg.R))
    warm_k = iters_to_gate(host(rw.err_hist)[:, 0], gate)

    if dev.type == "cuda":
        # quality gate — explicit raise (a bare assert vanishes under -O,
        # and this is the experiment's stated contract)
        if not (np.isfinite(min_err) and min_err <= gate):
            raise RuntimeError(
                f"phantom quality gate failed on the card: {min_err:.4f} > "
                f"{gate:.4f}")
        if batched_worst > gate:
            raise RuntimeError(
                f"batched frame quality gate failed: {batched_worst:.4f}")
    elif not np.isfinite(min_err):
        raise RuntimeError("the CPU run produced a non-finite error")

    return Results(
        cfg=cfg,
        backend=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        min_err=min_err, final_err=final_err, niters=niters,
        it_per_s=float(it_per_s), batched_min_err_worst=batched_worst,
        warm_iters_to_gate=warm_k, cold_iters_to_gate=cold_k,
        gate=float(gate), err_hist=err_hist, batched_err_hists=batched_err,
        recon=recon, sino=b_noisy.reshape(cfg.n_angles, cfg.n_det),
    )


def figures(res: Results, outdir: str):
    plt = get_pyplot()
    cfg = res.cfg
    paths = []

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4.5))
    im = ax1.imshow(res.sino.T, cmap="gray", aspect="auto", origin="lower")
    ax1.set_title(f"Noisy Sinogram ({cfg.noise_level*100:.0f}% noise)")
    ax1.set_xlabel("Projection Index (k)")
    ax1.set_ylabel("Detector Element")
    fig.colorbar(im, ax=ax1)
    ax2.imshow(res.recon, cmap="gray")
    ax2.set_title(f"Hybrid BA-GMRES ({cfg.dtype} operators, "
                  f"min err {res.min_err:.3f})")
    ax2.axis("off")
    fig.suptitle(f"CT reconstruction on {res.backend} (n={cfg.n}, "
                 f"{cfg.n_angles}x{cfg.n_det})")
    paths.append(save_figure(fig, outdir, "phantom_gpu_reconstruction.png"))

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.semilogy(np.arange(1, len(res.err_hist) + 1), res.err_hist, "-",
                lw=2, label="single solve")
    for i in range(res.batched_err_hists.shape[1]):
        ax.semilogy(np.arange(1, res.batched_err_hists.shape[0] + 1),
                    res.batched_err_hists[:, i], ":", lw=1,
                    label=f"batched frame {i}" if i < 2 else None)
    ax.axhline(res.gate, color="k", ls="--", lw=1,
               label=f"quality gate {res.gate:.3f}")
    ax.set_title(f"Semi-convergence on {res.backend} "
                 f"({res.it_per_s:.0f} it/s wall)")
    ax.set_xlabel("Iteration (k)")
    ax.set_ylabel("Relative Error")
    ax.grid(True)
    ax.legend(loc="best")
    paths.append(save_figure(fig, outdir, "phantom_gpu_semiconvergence.png"))
    return paths


def main(outdir: str = "figures_torch", cfg: Config | None = None):
    res = run(cfg)
    return res, figures(res, outdir)
