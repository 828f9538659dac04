#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``hybrid_gmres_tpu_torch/csrc`` and
drives the main path — hybrid BA-GMRES (maxit=100, lam=1e-2, fused
residual) on the Morton-ordered int8 block-ELL fan-beam CT operators — at
n=64 (180x180 rays) and n=128 (360x360 rays), the scenario of ``bench.py``.
Phases:

  1. device: requires CUDA (exits 1 otherwise, no CPU fallback), prints the
     card's name and power limit, the CUDA and nvcc versions; TF32 off;
  2. build: compiles K1 (``bucket_spmv.cu``) and prints the seconds;
  3. kernel vs plain: K1 against its plain PyTorch version on the same CUDA
     tensors (CT n=64 int8 panels of A and B, small random f32/bf16/int8
     panels), with CUDA-event times of both at the CT panel shapes (the
     n=128 panels get the same check and timing in phase 5);
  4. main path at n=64: a 10-step CT n=16 solve on the card against the
     same solve on the CPU; then one n=64 solve with the K1 launch count
     reset before and read after (must be 201: r0 = B b, then A and B per
     iteration), the quality gate on the min-over-k error, its error
     history against a float64 host reference, and it/s from the median
     of 10 solves timed with CUDA events;
  5. main path at n=128: K1 vs plain on its panels, then the same checks
     at the n=128 gate.

Every phase that fails exits non-zero.  The last three lines are the kernel
record ``{"kernels": [...]}``, the card's name and power limit, and the
result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

MAXIT = 100
LAM = 1e-2
# Min-over-k relative error gates: reference x band.  n=64 is bench.py's
# SCALE_GATES entry (0.4328, from exact dense f32 operators).  n=128 is
# anchored to the JAX package's own float64 solve of this scenario with the
# int8 operator (0.3944; scripts_torch/witness_ct.py, no port code in it):
# bench.py's 0.3698 x 1.05 = 0.3883 was read off one TPU run, and neither
# package reproduces it in exact arithmetic.  BENCH_PY_GATES is printed
# beside each result so that the gap stays in view.
GATES = {64: 0.4328 * 1.03, 128: 0.3944 * 1.05}
BENCH_PY_GATES = {64: 0.4328 * 1.03, 128: 0.3698 * 1.05}
# The card's error history vs the float64 host reference: float32 and
# float64 agree to ~1e-5 through the semi-convergence minimum (k = 6-7);
# past it the under-regularized iterations drift apart physically, so the
# history is held over the first REF_K steps and the minimum itself to
# REF_MIN_RTOL.
REF_K, REF_RTOL, REF_MIN_RTOL = 12, 1e-3, 1e-4
# Kernel vs plain version, for every storage type: both read the same stored
# values and accumulate in float32; only the summation order (and fmaf's
# single rounding) differs, far below 1e-5 of the output's scale.
KERNEL_RTOL = 1e-5


def fail(msg):
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps=50):
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def per_call_ms(fn, reps):
    """Milliseconds of each of ``reps`` calls of ``fn()``, each between two
    CUDA events and waited for, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from hybrid_gmres_tpu_torch.ops._build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    release = [ln for ln in nvcc.splitlines() if "release" in ln]
    say("device", card=card, torch=torch.__version__,
        torch_cuda=torch.version.cuda,
        nvcc=release[0].strip() if release else nvcc.strip(),
        device_count=torch.cuda.device_count(),
        tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build():
    from hybrid_gmres_tpu_torch.ops._build import NVCC_FLAGS, load_library

    t0 = time.perf_counter()
    load_library()
    say("build", kernel="bucket_spmv.cu", seconds=time.perf_counter() - t0,
        flags=" ".join(NVCC_FLAGS))


def _compare(bell, x, scale, label, rtol):
    """K1 vs its plain version on the same CUDA tensors."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (bucket_matvec,
                                                      bucket_matvec_plain)

    y_k = bucket_matvec(bell, x, scale)
    torch.cuda.synchronize()
    y_p = bucket_matvec_plain(bell, x, scale)
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape and bool(torch.isfinite(y_k).all()),
          f"{label}: kernel output not finite or misshaped")
    abs_err = float((y_k - y_p).abs().max())
    rel_err = abs_err / max(float(y_p.abs().max()), 1e-30)
    check(rel_err <= rtol, f"{label}: kernel vs plain rel err {rel_err:.3e} "
          f"> {rtol:.1e}")
    return abs_err, rel_err


def phase_ct_kernels(n, A_op, B_op, device="cuda"):
    """K1 vs plain on the CT int8 panels of A and B, both timed."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (bucket_matvec,
                                                      bucket_matvec_plain)

    rng = np.random.default_rng(1)
    recs = []
    for tag, op in (("A", A_op), ("B", B_op)):
        x = torch.as_tensor(rng.standard_normal(op.shape[1]),
                            dtype=torch.float32, device=device)
        abs_err, rel_err = _compare(op.fwd, x, op.fwd_scale,
                                    f"CT n={n} {tag} int8", KERNEL_RTOL)
        run_k = partial(bucket_matvec, op.fwd, x, op.fwd_scale)
        run_p = partial(bucket_matvec_plain, op.fwd, x, op.fwd_scale)
        # plain, kernel, kernel, plain: both see the same card state
        p1, k1, k2, p2 = time_ms(run_p), time_ms(run_k), time_ms(run_k), \
            time_ms(run_p)
        rec = dict(panel=f"n={n} {tag} int8 {tuple(op.fwd.block_shape)}",
                   shape=list(op.shape), panel_mb=op.fwd.nbytes / 1e6,
                   ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   max_abs_err=abs_err, max_rel_err=rel_err)
        recs.append(rec)
        say("kernel_vs_plain", **rec)
    return recs


def phase_small_kernels(device="cuda"):
    """K1 vs plain, forward and adjoint panels, on small random panels in
    every storage type, with (8,128) and (32,128) blocks."""
    import scipy.sparse as sp
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (BlockELLOperator,
                                                      bucket_matvec_plain)

    rng = np.random.default_rng(1)
    csr = sp.random(3000, 2000, density=0.01, format="csr",
                    random_state=np.random.RandomState(2), dtype=np.float64)
    x = torch.as_tensor(rng.standard_normal(2000), dtype=torch.float32,
                        device=device)
    u = torch.as_tensor(rng.standard_normal(3000), dtype=torch.float32,
                        device=device)
    for block in ((8, 128), (32, 128)):
        ref32 = BlockELLOperator.from_csr(csr, block=block, device=device)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            op = BlockELLOperator.from_csr(csr, block=block, dtype=dt,
                                           device=device)
            label = f"random {dt} {block}"
            a1, r1 = _compare(op.fwd, x, op.fwd_scale, label, KERNEL_RTOL)
            # the adjoint panel holds Q^T: rmatvec pre-scales u by s
            u_s = u if op.fwd_scale is None else op.fwd_scale * u
            a2, r2 = _compare(op.adj, u_s, None, label + " adjoint",
                              KERNEL_RTOL)
            if dt == torch.bfloat16:
                # bf16 keeps 8 significant bits: each stored entry is off
                # by <= 2^-9 of itself, so |y_bf16 - y_f32| <= 2^-9 sum|a x|
                # per row (plus f32 accumulation, far smaller): bound 2^-8.
                y16 = op.matvec(x)
                y32 = ref32.matvec(x)
                absax = bucket_matvec_plain(
                    BlockELLOperator.from_csr(abs(csr), block=block,
                                              device=device).fwd, x.abs())
                check(bool(((y16 - y32).abs() <= 2.0 ** -8 * absax
                            + 1e-30).all()),
                      f"{label}: bf16 panel outside its rounding bound")
            say("kernel_vs_plain_small", panel=label, max_rel_err=max(r1, r2),
                max_abs_err=max(a1, a2))


def make_problem(n, device="cuda"):
    """The bench scenario: CT n with 180*n/64 angles and detectors, int8
    Morton block-ELL operators, 25% noise from seed 0 drawn in ORIGINAL
    ray order and then permuted (bench.py:119-124)."""
    import torch

    from hybrid_gmres_tpu_torch.problems.ct import (ct_gpu_operators,
                                                    ct_mismatched)

    ang = 180 * n // 64
    t0 = time.perf_counter()
    prob = ct_mismatched(n=n, n_angles=ang, n_det=ang)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    A_op, B_op, _, x_true, ray_perm, pix_perm = ct_gpu_operators(
        prob, dtype="int8", device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    b_exact = prob.b_exact.astype(np.float32)
    rng = np.random.default_rng(0)
    e = rng.standard_normal(b_exact.shape)
    e = e / np.linalg.norm(e) * 0.25 * float(np.linalg.norm(b_exact))
    b = (b_exact + e.astype(np.float32))[ray_perm]
    info = dict(n=n, rays=f"{ang}x{ang}", A_shape=list(A_op.shape),
                nnz_A=int(prob.A_csr.nnz), nnz_B=int(prob.B_csr.nnz),
                A_panel_mb=A_op.fwd.nbytes / 1e6,
                B_panel_mb=B_op.fwd.nbytes / 1e6,
                assembly_s=t_asm, packing_s=t_pack)
    return (A_op, B_op, torch.as_tensor(b, device=device),
            x_true.to(torch.float32), info,
            lambda: host_reference(prob, ray_perm, pix_perm, b))


def solve(A_op, B_op, b, x_true):
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    return ba_gmres(A_op, B_op, b, x_true, tol=0.0, maxit=MAXIT, lam=LAM,
                    residual="fused")


def host_reference(prob, ray_perm, pix_perm, b):
    """The same solve in float64 on the host, independent of the kernel:
    scipy CSR products with the exactly quantized operators diag(s) Q (the
    matrices the int8 panels hold) and the port's float64 solver.  Returns
    the error history."""
    import scipy.sparse as sp
    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator
    from hybrid_gmres_tpu_torch.ops.ordering import reorder_pair
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _row_quantize_csr
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    class ScipyOperator(LinearOperator):
        def __init__(self, csr):
            csr_q, s = _row_quantize_csr(csr)
            self.csr = (sp.diags(s.astype(np.float64)) @ csr_q).tocsr()
            self.shape, self.dtype = self.csr.shape, torch.float64

        def matvec(self, v):
            return torch.from_numpy(self.csr @ v.numpy())

    A, B = reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32), ray_perm, pix_perm)
    r = ba_gmres(ScipyOperator(A.astype(np.float64)),
                 ScipyOperator(B.astype(np.float64)),
                 torch.from_numpy(b.astype(np.float64)),
                 torch.from_numpy(prob.x_true[pix_perm]), tol=0.0,
                 maxit=MAXIT, lam=LAM, residual="fused")
    return r.err_hist.numpy()


def phase_main_path(n, A_op, B_op, b, x_true, info, reference):
    """One counted solve, its checks (launch count, shapes, finiteness,
    quality gate, float64 host reference), then it/s over timed solves."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import bucket_matvec

    t0 = time.perf_counter()
    bucket_matvec.launches = 0
    r = solve(A_op, B_op, b, x_true)
    torch.cuda.synchronize()
    launches = bucket_matvec.launches
    first_s = time.perf_counter() - t0
    niters = int(r.niters)
    err = r.err_hist.cpu().numpy()
    res = r.res_hist.cpu().numpy()
    ms = per_call_ms(lambda: solve(A_op, B_op, b, x_true), reps=10)
    q1, med, q3 = (float(v) for v in np.percentile(ms, [25, 50, 75]))
    t0 = time.perf_counter()
    err_ref = reference()
    ref_s = time.perf_counter() - t0
    ref_diff = float(np.max(np.abs(err[:REF_K] - err_ref[:REF_K])
                            / err_ref[:REF_K]))
    min_err = float(err.min())
    min_diff = abs(min_err - float(err_ref.min())) / float(err_ref.min())
    say("main_path", **info, maxit=MAXIT, lam=LAM, k1_launches=launches,
        first_solve_s=first_s, timed_solves=len(ms), solve_ms_median=med,
        solve_ms_q1=q1, solve_ms_q3=q3, solve_ms_min=min(ms),
        solve_ms_max=max(ms), iters_per_s=MAXIT / (med / 1e3),
        min_err=min_err,
        min_err_k=int(err.argmin()) + 1, final_err=float(err[-1]),
        final_res=float(res[-1]), gate=GATES[n],
        bench_py_gate=BENCH_PY_GATES[n],
        f64_ref_min_err=float(err_ref.min()), f64_ref_min_rel_diff=min_diff,
        f64_ref_hist_rel_diff=ref_diff, f64_ref_s=ref_s)
    check(launches == 2 * MAXIT + 1,
          f"n={n}: {launches} K1 launches in the solve, expected "
          f"{2 * MAXIT + 1}")
    check(niters == MAXIT, f"n={n}: niters {niters} != {MAXIT}")
    check(bool(np.isfinite(err).all() and np.isfinite(res).all()),
          f"n={n}: non-finite history entries")
    check(tuple(r.x.shape) == (A_op.shape[1],) and
          bool(torch.isfinite(r.x).all()), f"n={n}: bad solution")
    check(min_err <= GATES[n], f"n={n}: min-over-k rel err {min_err:.4f} > "
          f"gate {GATES[n]:.4f}")
    check(ref_diff <= REF_RTOL, f"n={n}: error history vs float64 host "
          f"reference {ref_diff:.2e} > {REF_RTOL:.0e} (first {REF_K} steps)")
    check(min_diff <= REF_MIN_RTOL, f"n={n}: min-over-k error vs float64 "
          f"host reference {min_diff:.2e} > {REF_MIN_RTOL:.0e}")
    return launches


def phase_small_reference():
    """CT n=16, 10 steps: the solve on the card (K1) against the same solve
    on the CPU (plain versions).  Tolerance 1e-4: both run in float32 with
    different summation orders (cuBLAS and the kernel vs the CPU), and ten
    Krylov steps amplify last-bit differences by at most ~10x here."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import bucket_matvec
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    got = {}
    for dev in ("cuda", "cpu"):
        A_op, B_op, b, x_true, _, _ = make_problem(16, device=dev)
        before = bucket_matvec.launches
        r = ba_gmres(A_op, B_op, b, x_true, tol=0.0, maxit=10, lam=LAM,
                     residual="fused")
        got[dev] = (r, bucket_matvec.launches - before)
    (rc, launches_cuda), (rh, launches_cpu) = got["cuda"], got["cpu"]
    check(launches_cuda == 21 and launches_cpu == 0,
          f"small reference: launches cuda={launches_cuda} "
          f"cpu={launches_cpu}, expected 21 and 0")
    worst = 0.0
    for name in ("res_hist", "err_hist", "x"):
        a = getattr(rc, name).cpu().to(torch.float64)
        h = getattr(rh, name).to(torch.float64)
        d = float((a - h).abs().max() / h.abs().max())
        check(d <= 1e-4, f"small reference: {name} card vs CPU {d:.3e}")
        worst = max(worst, d)
    say("small_reference", n=16, maxit=10, max_rel_diff=worst)


def main():
    card = phase_device()
    import torch

    phase_build()
    p64 = make_problem(64)
    shapes64 = phase_ct_kernels(64, p64[0], p64[1])
    phase_small_kernels()
    phase_small_reference()
    launches = phase_main_path(64, *p64)
    del p64
    p128 = make_problem(128)
    shapes128 = phase_ct_kernels(128, p128[0], p128[1])
    phase_main_path(128, *p128)

    kernel = dict(
        name="bucket_matvec", route="cuda",
        source="hybrid_gmres_tpu_torch/csrc/bucket_spmv.cu",
        replaces="hybrid_gmres_tpu/ops/spmv_pallas.py:46",
        launches=launches,
        max_abs_err=max(s["max_abs_err"] for s in shapes64),
        # one n=64 BA-GMRES iteration's K1 work: A then B (every panel,
        # n=128 included, is listed in shapes)
        ms=sum(s["ms"] for s in shapes64),
        plain_ms=sum(s["plain_ms"] for s in shapes64),
        shapes=shapes64 + shapes128)
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
