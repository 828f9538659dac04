#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``hybrid_gmres_tpu_torch/csrc`` and
drives its two paths on the Morton-ordered int8 block-ELL fan-beam CT
operators at n=64 (180x180 rays) and n=128 (360x360 rays):

  * the single solve — hybrid BA-GMRES (maxit=100, lam=1e-2, fused
    residual), the scenario of ``bench.py``, through kernel K1 (SpMV);
  * the serving batch — ``ba_gmres_batched`` over R sinograms with per-RHS
    noise seeds, the scenario of ``scripts/batched_bench.py``, through
    kernel K2 (SpMM): in-loop and deferred histories, R=16 in two scans,
    and a warm start from the previous frame.

Phases:

  1. device: requires CUDA (exits 1 otherwise, no CPU fallback), prints the
     card's name and power limit, the CUDA and nvcc versions; TF32 off;
  2. build: compiles both kernel libraries in parallel, seconds each;
  3. kernel vs plain: K1 and K2 against their plain PyTorch versions on the
     same CUDA tensors (the CT int8 panels of A and B, K2 at R=8 and R=3;
     small random f32/bf16/int8 panels, forward and adjoint, K2 at R in
     {1, 5, 8, 12}), K2's column j against K1 on column j, and CUDA-event
     times of each kernel, its plain version, R launches of K1, and the
     library call (``torch.sparse`` CSR of the same matrix, used nowhere in
     the port), beside the kernel's bound computed from the run's panels;
  4. small reference: CT n=16 solves on the card against the same solves on
     the CPU (single-RHS; batched R=4 in-loop and deferred);
  5. single solve at n=64: the K1 launch count reset before and read after
     (must be 201: r0 = B b, then A and B per iteration; K2 must stay 0),
     the quality gate on the min-over-k error, the error history against a
     float64 host reference, it/s from the median of 5 solves;
  6. serving batch at n=64: launch counts (201 K2 launches per scan, one
     more with a warm start, K1 none), shapes, every column against the
     port's single-RHS solve of that column and against the float64 host
     reference, deferred against in-loop, warm against cold, it/s; and the
     GCV-selected lambda modes (``"gcv-final"``, ``"gcv"``), timed;
  7. the same two paths at n=128 (serving: R=8 deferred; the float64
     reference for column 0).

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
from types import SimpleNamespace

import numpy as np

MAXIT = 100
LAM = 1e-2
NOISE = 0.25
# Min-over-k relative error gates: reference x band.  n=64 is bench.py's
# SCALE_GATES entry (0.4328, from exact dense f32 operators).  n=128 is
# anchored to the JAX package's own float64 solve of this scenario with the
# int8 operator (0.3944; scripts_torch/witness_ct.py, no port code in it):
# bench.py's 0.3698 x 1.05 = 0.3883 was read off one TPU run, and neither
# package reproduces it in exact arithmetic.  BENCH_PY_GATES is printed
# beside each result so that the gap stays in view.
GATES = {64: 0.4328 * 1.03, 128: 0.3944 * 1.05}
BENCH_PY_GATES = {64: 0.4328 * 1.03, 128: 0.3698 * 1.05}
# The serving batch draws its noise from seeds 0..R-1: other realizations
# than the one the anchors were computed for, so its columns get the wider
# band at both sizes.
SERVING_GATES = {64: 0.4328 * 1.05, 128: 0.3944 * 1.05}
# The card's error history vs the float64 host reference: float32 and
# float64 agree to ~1e-5 through the semi-convergence minimum (k = 6-7);
# past it the under-regularized iterations drift apart physically, so the
# history is held over the first REF_K steps and the minimum itself to
# REF_MIN_RTOL.  The same bands hold a batched column to the single-RHS
# solve of that column on the card (same recurrences, other summation order).
REF_K, REF_RTOL, REF_MIN_RTOL = 12, 1e-3, 1e-4
# Deferred vs in-loop histories: the post-loop products sum the same terms
# in another order, in float32.
DEFER_RTOL = 2e-4
# A warm start from the previous frame may not cost quality.
WARM_BAND = 1.03
# A GCV-selected lambda (grid 1e-8..1e-1) against the bench's lam=1e-2: the
# minimum over k sits at k=6-7, where the projected problem is small and the
# choice of lambda moves it little; the JAX package's own test holds its GCV
# modes to each other within 5%.
GCV_BAND = 1.05
# Kernel vs plain version, for every storage type: both read the same stored
# values and accumulate in float32; only the summation order (and fmaf's
# single rounding) differs, far below 1e-5 of the output's scale.
KERNEL_RTOL = 1e-5
# The library call multiplies by float32(s * q), the kernel by s * (sum q x):
# one more rounding per entry.
LIBRARY_RTOL = 1e-4
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the tensor
# cores (the kernels multiply float32 x by converted panel values).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


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
    """Compile both kernel libraries (one nvcc each, started together, with
    the register and spill report of ptxas) and load them."""
    from hybrid_gmres_tpu_torch.ops._build import (LIBRARIES, NVCC_FLAGS,
                                                   build_all, load_library)

    t0 = time.perf_counter()
    built = build_all(extra_flags=["-Xptxas", "-v"])
    for name in LIBRARIES:
        load_library(name)
        seconds, log = built.get(name, (0.0, ""))
        variants, entry = [], None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1][:72]
            elif "spill stores" in ln and entry:
                variants.append(dict(entry=entry, spill=ln.split(":")[-1]
                                     .strip()))
            elif "Used" in ln and "registers" in ln and variants:
                variants[-1]["registers"] = int(
                    ln.split("Used")[1].split("registers")[0])
        say("build", kernel=f"{name}.cu", seconds=seconds, variants=variants,
            flags=" ".join(NVCC_FLAGS))
    say("build_all", seconds=time.perf_counter() - t0)


def panel_work(bell, R):
    """Bytes the product must move and flops it does on this panel: the live
    blocks (the kernels skip each row's trailing padding), their block
    columns, the per-position arrays, X read once and Y written once."""
    import torch

    br, bc = bell.block_shape
    m, n = bell.shape
    live = int(bell.pos_cnt.sum())
    n_pos = int(bell.pos_row.shape[0])
    item = torch.empty((), dtype=bell.dtype).element_size()
    nbytes = (live * br * bc * item + live * 4 + n_pos * 16
              + 4 * R * (n + m) + 4 * m)
    return nbytes, 2 * live * br * bc * R


def bound(work):
    """(bound_ms, bound_by) of ``[(bytes, flops), ...]`` done back to back:
    the larger of bytes over the card's memory rate and flops over its
    float32 rate."""
    t_bytes = sum(w[0] for w in work) / PEAK_BYTES_PER_S * 1e3
    t_flops = sum(w[1] for w in work) / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def quantized_csr(csr):
    """diag(s) Q in float64: the matrix an int8 panel of ``csr`` holds."""
    import scipy.sparse as sp

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _row_quantize_csr

    csr_q, s = _row_quantize_csr(csr)
    return (sp.diags(s.astype(np.float64)) @ csr_q).tocsr()


def library_csr(csr):
    """The library's format of the same matrix: a float32 ``torch.sparse``
    CSR tensor on the card (cuSPARSE), 32-bit indices."""
    import torch

    q = quantized_csr(csr.astype(np.float64))
    return torch.sparse_csr_tensor(
        torch.as_tensor(q.indptr.astype(np.int32), device="cuda"),
        torch.as_tensor(q.indices.astype(np.int32), device="cuda"),
        torch.as_tensor(q.data.astype(np.float32), device="cuda"),
        size=q.shape)


def phase_ct_kernels(P):
    """K1 and K2 against their plain versions on the CT int8 panels of A
    and B, K2's columns against K1, all timed beside the library call and
    the bound.  Returns the per-panel records of (K1, K2)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        bucket_matmat, bucket_matmat_plain, bucket_matvec,
        bucket_matvec_plain)

    rng = np.random.default_rng(1)
    recs1, recs2 = [], []
    for tag, op, csr in (("A", P.A_op, P.A_csr), ("B", P.B_op, P.B_csr)):
        bell, scale = op.fwd, op.fwd_scale
        panel = f"n={P.n} {tag} int8 {tuple(bell.block_shape)}"
        common = dict(panel=panel, shape=list(op.shape),
                      panel_mb=bell.nbytes / 1e6, nnz=int(csr.nnz))
        lib = library_csr(csr)
        X = torch.as_tensor(rng.standard_normal((op.shape[1], 8)),
                            dtype=torch.float32, device="cuda")
        Xt = X.T.contiguous().T       # the batched solver's layout
        x = X[:, 0].contiguous()

        # K1
        y_k, y_p = bucket_matvec(bell, x, scale), \
            bucket_matvec_plain(bell, x, scale)
        torch.cuda.synchronize()
        check(y_k.shape == y_p.shape and bool(torch.isfinite(y_k).all()),
              f"{panel}: K1 output not finite or misshaped")
        e1 = rel_err(y_k, y_p)
        check(e1 <= KERNEL_RTOL, f"{panel}: K1 vs plain {e1:.3e}")
        l1 = rel_err(lib @ x, y_k)
        check(l1 <= LIBRARY_RTOL, f"{panel}: K1 vs library {l1:.3e}")
        run_k = partial(bucket_matvec, bell, x, scale)
        run_p = partial(bucket_matvec_plain, bell, x, scale)
        # plain, kernel, kernel, plain: both see the same card state
        p1, k1, k2, p2 = time_ms(run_p), time_ms(run_k), time_ms(run_k), \
            time_ms(run_p)
        w1 = panel_work(bell, 1)
        b_ms, b_by = bound([w1])
        recs1.append(dict(
            common, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
            library_ms=time_ms(lambda: lib @ x), bound_ms=b_ms,
            bound_by=b_by, work=w1, max_abs_err=float((y_k - y_p).abs().max()),
            max_rel_err=e1, library_max_rel_diff=l1))
        say("kernel_vs_plain", kernel="K1", **recs1[-1])

        # K2: R=8 in both layouts, a ragged tile R=3, columns against K1
        Y_p = bucket_matmat_plain(bell, X, scale)
        Y_k, Y_t = bucket_matmat(bell, X, scale), bucket_matmat(bell, Xt,
                                                                scale)
        torch.cuda.synchronize()
        check(Y_k.shape == Y_p.shape == Y_t.shape and
              bool(torch.isfinite(Y_k).all()),
              f"{panel}: K2 output not finite or misshaped")
        check(Y_t.T.is_contiguous(), f"{panel}: K2 did not keep the layout")
        e2 = max(rel_err(Y_k, Y_p), rel_err(Y_t, Y_p))
        e3 = rel_err(bucket_matmat(bell, X[:, :3].contiguous(), scale),
                     Y_p[:, :3])
        check(max(e2, e3) <= KERNEL_RTOL,
              f"{panel}: K2 vs plain {e2:.3e} (R=8), {e3:.3e} (R=3)")
        col_diff = max(float((Y_t[:, j] - bucket_matvec(
            bell, X[:, j].contiguous(), scale)).abs().max())
            for j in range(8))
        check(col_diff <= KERNEL_RTOL * float(Y_p.abs().max()),
              f"{panel}: K2 column vs K1 {col_diff:.3e}")
        l2 = rel_err(lib @ X, Y_k)
        check(l2 <= LIBRARY_RTOL, f"{panel}: K2 vs library {l2:.3e}")
        run_k = partial(bucket_matmat, bell, Xt, scale)
        run_p = partial(bucket_matmat_plain, bell, X, scale)

        def run_8k1():
            for j in range(8):
                bucket_matvec(bell, Xt[:, j], scale)

        p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), time_ms(run_k), \
            time_ms(run_p, 10)
        w2 = panel_work(bell, 8)
        b_ms, b_by = bound([w2])
        recs2.append(dict(
            common, R=8, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
            ms_row_major=time_ms(partial(bucket_matmat, bell, X, scale)),
            k1_x8_ms=time_ms(run_8k1, 10),
            library_ms=time_ms(lambda: lib @ X), bound_ms=b_ms,
            bound_by=b_by, work=w2, max_abs_err=float(max(
                (Y_k - Y_p).abs().max(), (Y_t - Y_p).abs().max())),
            max_rel_err=e2, max_rel_err_R3=e3, column_vs_k1_max_diff=col_diff,
            column_equals_k1=col_diff == 0.0, library_max_rel_diff=l2))
        say("kernel_vs_plain", kernel="K2", **recs2[-1])
    return recs1, recs2


def phase_small_kernels(device="cuda"):
    """K1 and K2 vs plain, forward and adjoint panels, on small random
    panels in every storage type, with (8,128) and (32,128) blocks; K2 at
    R in {1, 5, 8, 12} in both layouts (12 = a full tile and a ragged one)."""
    import scipy.sparse as sp
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        BlockELLOperator, bucket_matmat, bucket_matmat_plain, bucket_matvec,
        bucket_matvec_plain)

    rng = np.random.default_rng(1)
    csr = sp.random(3000, 2000, density=0.01, format="csr",
                    random_state=np.random.RandomState(2), dtype=np.float64)
    X = torch.as_tensor(rng.standard_normal((2000, 12)), dtype=torch.float32,
                        device=device)
    U = torch.as_tensor(rng.standard_normal((3000, 12)), dtype=torch.float32,
                        device=device)
    for block in ((8, 128), (32, 128)):
        ref32 = BlockELLOperator.from_csr(csr, block=block, device=device)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            op = BlockELLOperator.from_csr(csr, block=block, dtype=dt,
                                           device=device)
            label = f"random {dt} {block}"
            # the adjoint panel holds Q^T: rmatvec pre-scales u by s
            U_s = U if op.fwd_scale is None else op.fwd_scale[:, None] * U
            worst1 = worst2 = col = 0.0
            for bell, scale, V in ((op.fwd, op.fwd_scale, X),
                                   (op.adj, None, U_s)):
                v = V[:, 0].contiguous()
                worst1 = max(worst1, rel_err(
                    bucket_matvec(bell, v, scale),
                    bucket_matvec_plain(bell, v, scale)))
                for R in (1, 5, 8, 12):
                    VR = V[:, :R].contiguous()
                    want = bucket_matmat_plain(bell, VR, scale)
                    for layout in (VR, VR.T.contiguous().T):
                        got = bucket_matmat(bell, layout, scale)
                        check(got.shape == want.shape,
                              f"{label}: K2 output misshaped at R={R}")
                        worst2 = max(worst2, rel_err(got, want))
                    col = max(col, max(float((got[:, j] - bucket_matvec(
                        bell, VR[:, j].contiguous(), scale)).abs().max())
                        for j in range(R)))
            torch.cuda.synchronize()
            check(worst1 <= KERNEL_RTOL, f"{label}: K1 vs plain {worst1:.3e}")
            check(worst2 <= KERNEL_RTOL, f"{label}: K2 vs plain {worst2:.3e}")
            if dt == torch.bfloat16:
                # bf16 keeps 8 significant bits: each stored entry is off
                # by <= 2^-9 of itself, so |y_bf16 - y_f32| <= 2^-9 sum|a x|
                # per row (plus f32 accumulation, far smaller): bound 2^-8.
                x = X[:, 0].contiguous()
                absax = bucket_matvec_plain(
                    BlockELLOperator.from_csr(abs(csr), block=block,
                                              device=device).fwd, x.abs())
                check(bool(((op.matvec(x) - ref32.matvec(x)).abs()
                            <= 2.0 ** -8 * absax + 1e-30).all()),
                      f"{label}: bf16 panel outside its rounding bound")
            say("kernel_vs_plain_small", panel=label, k1_max_rel_err=worst1,
                k2_max_rel_err=worst2, k2_column_vs_k1_max_diff=col)


def noisy_sinograms(P, seeds):
    """(m, R) float32: the clean sinogram plus 25% noise from each seed,
    drawn in ORIGINAL ray order, added in float32 and then permuted
    (bench.py:119-124; scripts/batched_bench.py:51-57 takes seeds 0..R-1)."""
    b_exact = P.prob.b_exact.astype(np.float32)
    cols = []
    for seed in seeds:
        e = np.random.default_rng(seed).standard_normal(b_exact.shape)
        e = e / np.linalg.norm(e) * NOISE * float(np.linalg.norm(b_exact))
        cols.append((b_exact + e.astype(np.float32))[P.ray_perm])
    return np.stack(cols, axis=1)


def make_problem(n, device="cuda"):
    """The bench scenario: CT n with 180*n/64 angles and detectors, int8
    Morton block-ELL operators, 25% noise from seed 0."""
    import torch

    from hybrid_gmres_tpu_torch.ops.ordering import reorder_pair
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
    P = SimpleNamespace(n=n, prob=prob, A_op=A_op, B_op=B_op,
                        x_true=x_true.to(torch.float32), ray_perm=ray_perm,
                        pix_perm=pix_perm, device=device)
    # the float32 matrices the panels were packed from, in panel order
    P.A_csr, P.B_csr = reorder_pair(prob.A_csr.astype(np.float32),
                                    prob.B_csr.astype(np.float32), ray_perm,
                                    pix_perm)
    P.b_host = noisy_sinograms(P, [0])[:, 0]
    P.b = torch.as_tensor(P.b_host, device=device)
    P.info = dict(n=n, rays=f"{ang}x{ang}", A_shape=list(A_op.shape),
                  nnz_A=int(prob.A_csr.nnz), nnz_B=int(prob.B_csr.nnz),
                  A_panel_mb=A_op.fwd.nbytes / 1e6,
                  B_panel_mb=B_op.fwd.nbytes / 1e6,
                  assembly_s=t_asm, packing_s=t_pack)
    return P


def solve(P, b=None, x0=None, maxit=MAXIT):
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    return ba_gmres(P.A_op, P.B_op, P.b if b is None else b, P.x_true,
                    tol=0.0, maxit=maxit, lam=LAM, residual="fused", x0=x0)


def solve_batched(P, b, defer, x0=None, maxit=MAXIT, lam=LAM):
    from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched

    return ba_gmres_batched(P.A_op, P.B_op, b, P.x_true, tol=0.0,
                            maxit=maxit, lam=lam, chunk_rhs=8, x0=x0,
                            defer_histories=defer)


def host_reference(prob, ray_perm, pix_perm, b):
    """The same solve in float64 on the host, independent of the kernels:
    scipy CSR products with the exactly quantized operators diag(s) Q (the
    matrices the int8 panels hold) and the port's float64 single-RHS
    solver.  Returns the error history."""
    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator
    from hybrid_gmres_tpu_torch.ops.ordering import reorder_pair
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    class ScipyOperator(LinearOperator):
        def __init__(self, csr):
            self.csr = quantized_csr(csr)
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


def reset_counts():
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (bucket_matmat,
                                                      bucket_matvec)

    bucket_matvec.launches = bucket_matmat.launches = 0


def counts():
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (bucket_matmat,
                                                      bucket_matvec)

    return bucket_matvec.launches, bucket_matmat.launches


def held_to(err, err_ref, label, what):
    """The first REF_K entries of an error history within REF_RTOL of a
    reference and its minimum within REF_MIN_RTOL; returns both gaps."""
    hist = float(np.max(np.abs(err[:REF_K] - err_ref[:REF_K])
                        / err_ref[:REF_K]))
    at_min = abs(float(err.min()) - float(err_ref.min())) / float(
        err_ref.min())
    check(hist <= REF_RTOL, f"{label}: error history vs {what} {hist:.2e} > "
          f"{REF_RTOL:.0e} (first {REF_K} steps)")
    check(at_min <= REF_MIN_RTOL, f"{label}: min-over-k error vs {what} "
          f"{at_min:.2e} > {REF_MIN_RTOL:.0e}")
    return hist, at_min


def phase_main_path(P):
    """One counted single-RHS solve, its checks (launch counts, shapes,
    finiteness, quality gate, float64 host reference), then it/s over timed
    solves.  Returns (K1 launches, it/s, the reference's error history)."""
    import torch

    n = P.n
    t0 = time.perf_counter()
    reset_counts()
    r = solve(P)
    torch.cuda.synchronize()
    k1, k2 = counts()
    first_s = time.perf_counter() - t0
    niters = int(r.niters)
    err = r.err_hist.cpu().numpy()
    res = r.res_hist.cpu().numpy()
    ms = per_call_ms(lambda: solve(P), reps=5)
    q1, med, q3 = (float(v) for v in np.percentile(ms, [25, 50, 75]))
    check(k1 == 2 * MAXIT + 1 and k2 == 0,
          f"n={n}: {k1} K1 and {k2} K2 launches in the single solve, "
          f"expected {2 * MAXIT + 1} and 0")
    check(niters == MAXIT, f"n={n}: niters {niters} != {MAXIT}")
    check(bool(np.isfinite(err).all() and np.isfinite(res).all()),
          f"n={n}: non-finite history entries")
    check(tuple(r.x.shape) == (P.A_op.shape[1],) and
          bool(torch.isfinite(r.x).all()), f"n={n}: bad solution")
    t0 = time.perf_counter()
    err_ref = host_reference(P.prob, P.ray_perm, P.pix_perm, P.b_host)
    ref_s = time.perf_counter() - t0
    min_err = float(err.min())
    check(min_err <= GATES[n], f"n={n}: min-over-k rel err {min_err:.4f} > "
          f"gate {GATES[n]:.4f}")
    ref_diff, min_diff = held_to(err, err_ref, f"n={n}",
                                 "float64 host reference")
    say("main_path", **P.info, maxit=MAXIT, lam=LAM, k1_launches=k1,
        k2_launches=k2, first_solve_s=first_s, timed_solves=len(ms),
        solve_ms_median=med, solve_ms_q1=q1, solve_ms_q3=q3,
        solve_ms_min=min(ms), solve_ms_max=max(ms),
        iters_per_s=MAXIT / (med / 1e3), min_err=min_err,
        min_err_k=int(err.argmin()) + 1, final_err=float(err[-1]),
        final_res=float(res[-1]), gate=GATES[n],
        bench_py_gate=BENCH_PY_GATES[n],
        f64_ref_min_err=float(err_ref.min()), f64_ref_min_rel_diff=min_diff,
        f64_ref_hist_rel_diff=ref_diff, f64_ref_s=ref_s)
    return k1, MAXIT / (med / 1e3), err_ref


def counted_batched(P, b, defer, expect_k2, label, x0=None, **kw):
    """One batched solve with the launch counts reset before and read
    after, and the checks every serving run gets: counts, niters, shapes,
    finite histories."""
    import torch

    m, nx = P.A_op.shape
    R = b.shape[1]
    reset_counts()
    r = solve_batched(P, b, defer, x0=x0, **kw)
    torch.cuda.synchronize()
    k1, k2 = counts()
    check(k2 == expect_k2 and k1 == 0, f"{label}: {k2} K2 and {k1} K1 "
          f"launches, expected {expect_k2} and 0")
    check(r.niters.tolist() == [MAXIT] * R, f"{label}: niters "
          f"{r.niters.tolist()}")
    shapes = dict(x=(nx, R), err_hist=(MAXIT, R), res_hist=(MAXIT, R),
                  niters=(R,), Q=(nx, MAXIT + 1, R), H=(MAXIT + 1, MAXIT, R),
                  IMG=(m, MAXIT, R), beta=(R,), active=(R,), fp=(3,))
    for name, shape in shapes.items():
        check(tuple(getattr(r, name).shape) == shape,
              f"{label}: {name} has shape {tuple(getattr(r, name).shape)}")
    check(r.S is None, f"{label}: BA result carries S")
    check(bool(torch.isfinite(r.err_hist).all() and
               torch.isfinite(r.res_hist).all() and
               torch.isfinite(r.x).all()), f"{label}: non-finite results")
    return r, k2


def timed_batched(P, b, defer):
    ms = per_call_ms(lambda: solve_batched(P, b, defer), reps=5)
    med = float(np.median(ms))
    R = b.shape[1]
    return dict(solve_ms_median=med, solve_ms_min=min(ms),
                solve_ms_max=max(ms),
                solver_iters_per_s=MAXIT / (med / 1e3),
                rhs_iters_per_s=R * MAXIT / (med / 1e3))


def columns_vs_single(P, r, b, label):
    """Every column of a batched result against the port's single-RHS
    solve of that column on the card."""
    worst_hist = worst_min = 0.0
    err, res = r.err_hist.cpu().numpy(), r.res_hist.cpu().numpy()
    for j in range(b.shape[1]):
        rj = solve(P, b=b[:, j].contiguous())
        h, mn = held_to(err[:, j], rj.err_hist.cpu().numpy(),
                        f"{label} column {j}", "its single-RHS solve")
        res_j = rj.res_hist.cpu().numpy()
        rh = float(np.max(np.abs(res[:REF_K, j] - res_j[:REF_K])
                          / res_j[:REF_K]))
        check(rh <= REF_RTOL, f"{label} column {j}: residual history vs "
              f"its single-RHS solve {rh:.2e}")
        worst_hist, worst_min = max(worst_hist, h, rh), max(worst_min, mn)
    return worst_hist, worst_min


def phase_serving(P, single_its, ref0, full):
    """The serving batch at one size.  ``full``: every mode of the n=64
    scenario (in-loop, deferred, R=16, warm start, a float64 reference per
    column); otherwise R=8 deferred with the float64 reference of column 0
    (``ref0``, the single solve's: seed 0 is column 0).  Returns the K2
    launch count of the first counted solve (R=8 deferred)."""
    import torch

    n, R = P.n, 8
    gate = SERVING_GATES[n]
    cold = 2 * MAXIT + 1
    b_host = noisy_sinograms(P, range(2 * R))
    b_all = torch.as_tensor(b_host, device="cuda")
    b8 = b_all[:, :R].contiguous()
    out = dict(n=n, R=R, maxit=MAXIT, lam=LAM, chunk_rhs=8, gate=gate,
               single_rhs_iters_per_s=single_its)

    r_def, k2_first = counted_batched(P, b8, True, cold,
                                      f"n={n} R=8 deferred")
    err_def = r_def.err_hist.cpu().numpy()
    minima = err_def.min(axis=0)
    check(bool((minima <= gate).all()), f"n={n} serving: min-over-k errors "
          f"{minima.tolist()} above the gate {gate:.4f}")
    out["min_err"] = minima.tolist()
    out["min_err_k"] = (err_def.argmin(axis=0) + 1).tolist()
    out["vs_single_hist"], out["vs_single_min"] = columns_vs_single(
        P, r_def, b8, f"n={n} R=8 deferred")
    t0 = time.perf_counter()
    ref_min = []
    for j in range(R if full else 1):
        err_ref = ref0 if j == 0 else host_reference(
            P.prob, P.ray_perm, P.pix_perm, b_host[:, j])
        held_to(err_def[:, j], err_ref, f"n={n} serving column {j}",
                "float64 host reference")
        ref_min.append(float(err_ref.min()))
    out["f64_ref_min_err"], out["f64_ref_s"] = ref_min, \
        time.perf_counter() - t0
    out["deferred"] = timed_batched(P, b8, True)
    out["k2_launches"] = {"R=8 deferred": k2_first}

    if full:
        r_in, k2 = counted_batched(P, b8, False, cold, f"n={n} R=8 in-loop")
        out["k2_launches"]["R=8 in-loop"] = k2
        err_in = r_in.err_hist.cpu().numpy()
        for name, a, d in (("err", err_in, err_def),
                           ("res", r_in.res_hist.cpu().numpy(),
                            r_def.res_hist.cpu().numpy())):
            gap = float(np.max(np.abs(d[:REF_K] - a[:REF_K]) / a[:REF_K]))
            gap_min = float(np.max(np.abs(d.min(0) - a.min(0)) / a.min(0)))
            check(max(gap, gap_min) <= DEFER_RTOL, f"n={n}: deferred vs "
                  f"in-loop {name} history {gap:.2e}, minimum {gap_min:.2e}")
            out[f"deferred_vs_in_loop_{name}"] = max(gap, gap_min)
        columns_vs_single(P, r_in, b8, f"n={n} R=8 in-loop")
        out["in_loop"] = timed_batched(P, b8, False)

        r16, k2 = counted_batched(P, b_all, True, 2 * cold,
                                  f"n={n} R=16 deferred")
        out["k2_launches"]["R=16 deferred"] = k2
        gap = float((r16.err_hist[:REF_K, :R] - r_def.err_hist[:REF_K])
                    .abs().max())
        check(gap <= 1e-6, f"n={n}: the first scan of R=16 differs from the "
              f"R=8 solve of the same columns by {gap:.2e}")
        out["R16_first_scan_vs_R8"] = gap
        columns_vs_single(P, r16, b_all, f"n={n} R=16 deferred")
        min16 = r16.err_hist.min(dim=0).values
        check(bool((min16 <= gate).all()), f"n={n} R=16: min-over-k errors "
              f"{min16.tolist()} above the gate")
        out["min_err_R16"] = min16.tolist()
        out["R16_deferred"] = timed_batched(P, b_all, True)

        # warm start (scripts/batched_bench.py:99-153): frame 2 (seeds
        # R..2R-1) cold, and from frame 1's solution at the iteration where
        # its last column crossed the gate
        hits = err_in <= GATES[n]
        k_gate1 = int(np.max(np.where(hits.any(0), hits.argmax(0),
                                      MAXIT - 1))) + 1
        x_prev = solve_batched(P, b8, False, maxit=k_gate1).x
        b2 = b_all[:, R:].contiguous()
        r_cold, k2c = counted_batched(P, b2, False, cold,
                                      f"n={n} frame 2 cold")
        r_warm, k2w = counted_batched(P, b2, False, cold + 1,
                                      f"n={n} frame 2 warm", x0=x_prev)
        out["k2_launches"].update({"frame 2 cold": k2c, "frame 2 warm": k2w})
        m_cold = r_cold.err_hist.min(dim=0).values
        m_warm = r_warm.err_hist.min(dim=0).values
        check(bool((m_warm <= WARM_BAND * m_cold).all()),
              f"n={n}: warm minima {m_warm.tolist()} above {WARM_BAND} x "
              f"cold minima {m_cold.tolist()}")

        def to_gate(r):
            hit = (r.err_hist <= GATES[n]).cpu().numpy()
            return np.where(hit.any(0), hit.argmax(0) + 1, -1).tolist()

        out.update(frame1_stop_k=k_gate1, cold_min_err=m_cold.tolist(),
                   warm_min_err=m_warm.tolist(),
                   cold_iters_to_gate=to_gate(r_cold),
                   warm_iters_to_gate=to_gate(r_warm))

        # GCV-selected lambda on the card (batched SVDs): once per RHS from
        # the final projected problem, and per (k, RHS) inside the loop.
        # Held to the fixed-lambda minima within GCV_BAND, and timed.
        for lam, defer in (("gcv-final", True), ("gcv", True),
                           ("gcv", False)):
            label = f"n={n} lam={lam} " + ("deferred" if defer else "in-loop")
            r_g, _ = counted_batched(P, b8, defer, cold, label, lam=lam)
            m_g = r_g.err_hist.min(dim=0).values.cpu().numpy()
            check(bool((m_g <= GCV_BAND * minima).all()),
                  f"{label}: minima {m_g.tolist()} above {GCV_BAND} x the "
                  f"fixed-lambda minima {minima.tolist()}")
            ms = per_call_ms(lambda: solve_batched(P, b8, defer, lam=lam),
                             reps=2)
            out[label.split(" ", 1)[1]] = dict(
                min_err=m_g.tolist(), solve_ms=ms)
    say("serving_path", **out)
    return k2_first


def phase_small_reference():
    """CT n=16, 10 steps: the solves on the card (K1; K2 at R=4, in-loop and
    deferred) against the same solves on the CPU (plain versions).
    Tolerance 1e-4: both run in float32 with different summation orders
    (cuBLAS and the kernels vs the CPU), and ten Krylov steps amplify
    last-bit differences by at most ~10x here."""
    import torch

    got = {}
    for dev in ("cuda", "cpu"):
        P = make_problem(16, device=dev)
        b4 = torch.as_tensor(noisy_sinograms(P, range(4)), device=dev)
        runs = {}
        for name, fn in (
                ("single", lambda: solve(P, maxit=10)),
                ("batched", lambda: solve_batched(P, b4, False, maxit=10)),
                ("deferred", lambda: solve_batched(P, b4, True, maxit=10))):
            reset_counts()
            runs[name] = (fn(), counts())
        got[dev] = runs
    worst = {}
    for name, want in (("single", (21, 0)), ("batched", (0, 21)),
                       ("deferred", (0, 21))):
        (rc, launches_cuda), (rh, launches_cpu) = got["cuda"][name], \
            got["cpu"][name]
        check(launches_cuda == want and launches_cpu == (0, 0),
              f"small reference {name}: (K1, K2) launches cuda="
              f"{launches_cuda} cpu={launches_cpu}, expected {want} and "
              "(0, 0)")
        worst[name] = 0.0
        for field in ("res_hist", "err_hist", "x"):
            a = getattr(rc, field).cpu().to(torch.float64)
            h = getattr(rh, field).to(torch.float64)
            d = float((a - h).abs().max() / h.abs().max())
            check(d <= 1e-4, f"small reference {name}: {field} card vs CPU "
                  f"{d:.3e}")
            worst[name] = max(worst[name], d)
    say("small_reference", n=16, maxit=10, R=4, max_rel_diff=worst)


def kernel_record(name, source, replaces, launches, recs64, recs128):
    """One entry of the ``kernels`` line.  ``ms``, ``plain_ms``,
    ``library_ms`` and ``bound_ms`` are one n=64 BA-GMRES iteration's work
    of this kernel, A's panel then B's; every panel, n=128 included, is
    listed in ``shapes`` with the same keys."""
    b_ms, b_by = bound([s["work"] for s in recs64])
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(s["max_abs_err"] for s in recs64 + recs128),
        ms=sum(s["ms"] for s in recs64),
        plain_ms=sum(s["plain_ms"] for s in recs64),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=sum(s["library_ms"] for s in recs64),
        shapes=recs64 + recs128)


def main():
    card = phase_device()
    import torch

    phase_build()
    P = make_problem(64)
    k1_64, k2_64 = phase_ct_kernels(P)
    phase_small_kernels()
    phase_small_reference()
    k1_launches, its, ref0 = phase_main_path(P)
    k2_launches = phase_serving(P, its, ref0, full=True)
    del P
    torch.cuda.empty_cache()
    P = make_problem(128)
    k1_128, k2_128 = phase_ct_kernels(P)
    _, its, ref0 = phase_main_path(P)
    phase_serving(P, its, ref0, full=False)

    print(json.dumps({"kernels": [
        kernel_record("bucket_matvec",
                      "hybrid_gmres_tpu_torch/csrc/bucket_spmv.cu",
                      "hybrid_gmres_tpu/ops/spmv_pallas.py:46", k1_launches,
                      k1_64, k1_128),
        kernel_record("bucket_matmat",
                      "hybrid_gmres_tpu_torch/csrc/bucket_spmm.cu",
                      "hybrid_gmres_tpu/ops/spmv_pallas.py:220", k2_launches,
                      k2_64, k2_128)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
