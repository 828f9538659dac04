#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py             # every phase (one H100, ~10 minutes)
    python3 chip_smoke.py --kernels   # build and kernel phases only
    python3 chip_smoke.py --sharded   # build and the three sharded phases
    python3 chip_smoke.py --float     # build, float_forms and entry
    python3 chip_smoke.py --windows   # build and the window kernel's phase

Builds the port's CUDA kernels from ``hybrid_gmres_tpu_torch/csrc`` (five
libraries, nine kernels: the block-ELL K1-K4, the redesigned K1-K4 on the
row-packed forms, these also on int4 nibble-packed forms, and K2w, K2 for
wide right-hand-side blocks on the tensor cores, on the tile forms) and
drives
its path families on the Morton-ordered int8 fan-beam CT operators at n=64
(180x180 rays) and n=128 (360x360 rays), on their int4 twins and on their
bfloat16 and float32 twins (the JAX package's default storage type):

  * the single solve — hybrid BA-GMRES (maxit=100, lam=1e-2, fused
    residual), the scenario of ``bench.py``, through the redesigned K1
    (SpMV on the row-packed form);
  * the serving batch — ``ba_gmres_batched`` over R sinograms with per-RHS
    noise seeds, the scenario of ``scripts/batched_bench.py``, through the
    redesigned K2 (SpMM on the row-packed form): in-loop and deferred
    histories, R=16 in two scans, and a warm start from the previous frame;
  * the GKB family on forward panels only — ``lsqr``, ``hybrid_lsqr``,
    ``lsmr``, ``hybrid_lsmr`` through the redesigned K1 and K3 (K3 on the
    row-packed transpose of the forward panel), and the serving twins
    ``lsqr_batched``, ``hybrid_lsqr_batched``, ``lsmr_batched`` (the
    scenario of ``scripts/gkb_batched_bench.py``) through the redesigned K2
    and K4; ``lsqr`` also with ``with_adjoint=True`` (K3 on the form of the
    adjoint panel);
  * the lambda-choice path — the regularize-then-project solvers
    ``ba_gmres_rtp`` and ``ab_gmres_rtp`` (the redesigned K1, and K2w at
    R = maxit for AB-RTP's A Q every step), the restarted wrappers, the
    resumed, bf16-basis and ``history=False`` single solves, the GCV /
    discrepancy / L-curve selectors (K2r or K2w at R = k_gcv and at R = the
    grid size, as the routing rule names them) and the experiment drivers ``ptr_rtp``, ``regularization`` and
    ``gcv_surface_exp``;
  * the rest of the drivers — ``phantom2d_gpu`` (the JAX package's
    ``phantom2d_tpu`` on the card: the single solve through the redesigned
    K1, an R=4 deferred serving batch cold and warm through the redesigned
    K2), the seven dense drivers and the experiments CLI;
  * int4 — ``ct_gpu_operators(dtype="int4")``: the single solve, the
    serving batch, ``lsqr`` and ``lsqr_batched`` through the int4 variants
    of the redesigned K1-K4 (``bench.py``'s ``BENCH_DTYPE=int4``);
  * the sharded path — ``ba_gmres_sharded_pallas`` and
    ``ab_gmres_sharded_pallas`` at p=1 on a one-rank NCCL group (what one
    card runs; the twin of ``scripts/sharded_shard_bench.py``), through the
    redesigned K1 and K3 on each shard's row-packed forms; then the rest of
    the 1-D tier on the same group and panels: the sharded RTP and GKB
    solvers (K1 and K3; K1 on both forms of an adjoint pair) and the
    sharded serving batch ``ba/ab_gmres_sharded_batched`` (the twin of
    ``scripts/sharded_batched_bench.py``) through the redesigned K2 and K4
    on each shard's forms;
  * the 2-D tiled tier on the same group as a (1, 1) mesh of
    ``make_mesh_2d`` (its per-axis groups one-rank NCCL groups): the 2-D
    BA/AB-GMRES, GKB and serving batch through the redesigned K1-K4 on the
    tiles' row-packed forms, and the dense 2-D BA-GMRES.

The block-ELL K1-K4 run on no path any more: they stay as the direct
counterparts of the Pallas kernels on the same panel, checked and timed in
phase 3 beside the kernels that replaced them (an operator keeps its panels
on the host; phase 3 puts them on the card and releases them).

Phases:

  1. device: requires CUDA (exits 1 otherwise, no CPU fallback), prints the
     card's name and power limit, the CUDA and nvcc versions; TF32 off;
  2. build: compiles the kernel libraries in parallel, seconds each, with
     each variant's registers and spills;
  3. kernel vs plain: K1-K4 against their plain PyTorch versions on the
     same CUDA tensors (the CT int8 panels of A and B; small random
     f32/bf16/int8 panels, K2/K4 at R in {1, 3, 5, 8, 12} in both layouts),
     K2's column j against K1 and K4's against K3 on column j, K3 twice on
     the same input, K3 against K1 on an adjoint panel, <A x, u> against
     <x, A^T u>, and CUDA-event times of each kernel, its plain version, R
     launches of the single-RHS kernel, the adjoint-panel alternative and
     the library call (``torch.sparse`` CSR of the same matrix, used
     nowhere in the port), beside the kernel's bound computed from the
     run's panels; the redesigned K1 and K3 on the same CT operators against
     their plain versions, the block-ELL kernel, themselves twice and in
     both variants (the same bits), <A x, u> against <x, A^T u>, timed in
     turns beside the block-ELL kernel and the library call against the
     bound from the form's live bytes, and on small f32/bf16/int8 forms
     with 16- and 32-bit indices; the redesigned K2 and K4 the same way at
     R in {1, 3, 5, 8, 12} in both layouts, column j bit-equal to the
     redesigned K1 (K3) on column j, every gather and block size and
     ``out=`` through a slab's strides giving the same bits, timed at R=8 in
     the solvers' layout beside each of those variants, the block-ELL
     kernel, 8 single-RHS launches and the library call;
  4. small reference: CT n=16 solves on the card against the same solves on
     the CPU (BA-GMRES single and batched; the seven GKB solvers, without
     and with ``reorth=True``);
  5. single solve at n=64: the launch counts reset before and read after
     (the redesigned K1 must give 201: r0 = B b, then A and B per
     iteration; every other kernel 0; counts are 9-tuples, ``LAUNCHES``),
     the quality gate on the min-over-k error, the error history against a
     float64 host reference, it/s from the median of 5 solves;
  6. serving batch at n=64: launch counts (201 redesigned K2 launches per
     scan, one more with a warm start, every other kernel none), shapes,
     every column against the port's single-RHS solve of that column and
     against the float64 host reference, deferred against in-loop, warm
     against cold,
     it/s; and the GCV-selected lambda modes (``"gcv-final"``, ``"gcv"``),
     timed;
  7. the GKB path at n=64: each single-RHS solver with its launch counts
     checked against the counts worked out from the code, its error history
     against the float64 host reference of the same solver, it/s;
     ``hybrid_lsmr`` also with ``lam="gcv"``, timed; the batched solvers
     with their counts, every column against the port's single-RHS solve,
     an (R,) lambda against the scalar, and a resume 40 -> 100 against the
     uninterrupted run, bit for bit;
  8. the lambda-choice path at n=64: BA- and AB-RTP (launches from the
     code: 301 K1r, and 100 K2w for AB-RTP; the min-over-k error against
     the same solver in float64 on the host, AB-RTP's reference making one
     product of A a step; it/s), AB-RTP again with the caller's TF32 on
     (the flag restored, the history in band, the Gram with and without
     the full-float32 context against float64); for BA and AB fused a
     resume 40 -> 100 bit-equal to the uninterrupted run, a bf16 basis,
     ``history=False``, and a deferred BA solve with TF32 on; the restarted
     wrappers (20 x 5); every lambda selector against the same call in
     float64 on the host (a grid step, 1e-3 for Brent, or as good by the
     float64 objective); the three drivers against the CPU port, with the
     values of ``figures/results.json`` beside them;
  9. the rest of the drivers at n=64 (``drivers_rest``): ``phantom2d_gpu``
     at its default Config (its two quality gates; the launch counts worked
     out from the code, no block-ELL kernel; the single solve's history
     against the float64 host reference of its sinogram; warm <= cold
     iterations to the gate; it/s beside the JAX package's TPU record);
     ``equivalence``, ``error_surface``, ``filter_factors_exp``,
     ``perturbation_bounds``, ``noise_sweep``, ``mismatch_sweep`` and
     ``phantom2d`` on the card against the CPU port in float32, with the
     values of ``figures/results.json`` beside them; the CLI's
     ``results.json`` keys against the JAX file's;
 10. the same paths at n=128 (serving: R=8 deferred; GKB: ``lsqr`` and
     ``lsqr_batched``; the float64 reference for column 0; the RTP solvers,
     ``gcv_lambda("ba", residual_space="original")`` and
     ``discrepancy_lambda("ba")``);
 11. int4 (after the n=64 lambda path, and the kernels again at n=128):
     the redesigned K1, K3, K2 and K4 (R=8) on the int4 forms of A and B
     against their plain versions, twice, column j of K2 (K4) bit-equal to
     K1 (K3), the library call on the int4 diag(s) Q, timed beside the int8
     kernel against the int4 form's bound; the forms' bytes against the
     int8 forms'; at n=64 the paths of phase 15 (``phase_variant_path``)
     on the int4 operators: the single solve (201 int4 K1 launches; the
     gate 0.4328 x 1.03), the serving batch R=8 deferred (201 K2),
     ``lsqr`` and ``lsqr_batched`` R=8 (counts from the code), each held
     to the float64 host solve on the values the int4 forms hold, column 0
     of each batch to its single solve, walls in turns with int8;
 12. sharded (after int4, at n=64 and n=128): a one-rank NCCL group;
     BA and AB (n=128: MAXIT steps; n=64: 25), transposed (``BT_panels``)
     and forward (``B_panels``) layouts, on p=1 builds of
     ``shard_bucketed_panels`` put on the card once by ``shard_view``
     (bit-equal to the operators' forms), each with
     K1r/K3r counts from the code, finite, held in the main path's bands to
     the single-chip solve of the same matrices and to the float64 host
     solve, BA to the gate, it/s beside the single-chip solve, the NCCL
     calls of a solve; at n=128 the int8 and int4 forms of p=4 and p=8
     builds of B,
     shard by shard through ``shard_view`` against their plain versions
     and, concatenated and scattered, against the single-chip ``matvec``
     and ``rmatvec``, and the same at R=8 for K2 and K4 (``local_matmat``,
     ``local_rmatmat_window``; column j bit-equal to K1/K3 on column j;
     each shard's call timed beside the single-chip K2r/K4r); the group
     destroyed at the end of each;
 13. sharded_solvers (on phase 12's group and p=1 panels): at n=128
     ``ba_gmres_rtp_sharded`` and ``ab_gmres_rtp_sharded``, ``lsqr_sharded``
     and ``hybrid_lsqr_sharded``, ``lsqr_sharded`` on
     ``build_panels_with_adjoint(A, 1, int8)``, ``ba_gmres_sharded_batched``
     (R=8 in-loop and deferred, R=16 in two chunks) and
     ``ab_gmres_sharded_batched`` (R=8 deferred), the NCCL calls of an R=1
     batch, and the float32 Gram solves of both AB-RTPs (LU failures,
     smallest eigenvalue); at n=64 (25 steps) ``lsmr_sharded``,
     ``hybrid_lsmr_sharded``, ``lsqr_sharded`` on ``ComposedPanels(A, BT,
     "ba")`` and the forward layout for BA-RTP and the R=8 deferred batch.
     Each with its launches from the code, finite, held to the single-chip
     solve of the same matrices (GMRES-type: the main path's bands; GKB:
     6 steps to 1e-3, the minimum to GKB_MIN_RTOL) and, where one exists,
     the float64 host solve, timed in turns with it (5 each).
 14. sharded_2d (on phase 12's group as a (1, 1) mesh): at n=128 the
     (1, 1) tiles of A, of B^T and the forward tiles of B
     (``tile_bucketed_panels``, ``tile_backprojector_forward``), each
     bit-equal to the operator's forms; ``ba_gmres_sharded_pallas_2d``
     (transposed and forward layouts) and ``ab_gmres_sharded_pallas_2d``,
     ``lsqr_sharded_2d``, ``hybrid_lsqr_sharded_2d`` and
     ``ba_gmres_sharded_batched_2d`` (R=8 deferred); at n=64 (25 steps)
     ``lsmr_sharded_2d``, ``hybrid_lsmr_sharded_2d`` and the dense
     ``ba_gmres_sharded_2d`` on the float32 matrices.  Each as in phase 13
     (launches from the code, finite, held to the single-chip solve and
     the float64 host solve, BA to the gate, timed in turns), with its
     NCCL calls per axis.  At n=128 also the int8 and int4 tiles of B at
     (2, 2) and (4, 2), tile by tile: K1r/K3r/K2r/K4r (R=8) against their
     plain versions, column j of K2r/K4r bit-equal to K1r/K3r, the
     partials summed over the axis on the host and scaled against the
     single-chip products, each tile's calls timed beside the single-chip
     call.  The n=128 tiles are packed by a pool of worker processes
     started after the n=128 kernel phases, beside phase 12's packing.

 15. float_forms (after int4, at n=64 and n=128): ``ct_gpu_operators`` with
     ``dtype="bfloat16"`` and ``"float32"`` (at n=64 the call on the card,
     its forms bit-equal to a host build; at n=128 the host build of a
     pool of worker processes started before the n=64 lambda path, moved
     to the card), the redesigned K1-K4 on their forms as on the int4 ones
     (with every gather and block size of K2/K4 at R=8 timed against the
     default, and the storage type's registers and spills from phase 2);
     at n=64 the single solve (201 K1), the serving batch R=8 deferred
     (201 K2), ``lsqr`` (101 K1, 101 K3) and ``lsqr_batched`` R=8 (101 K2,
     101 K4), at n=128 the single solve: each with its launches, its peak
     memory, walls in turns with the int8 twin, held to a float64 host
     solve on the values its forms hold (decoded on the host, independent
     of the kernels) and to its gate, which that host solve decides when
     the card misses it;
 16. entry (after float_forms at n=64): ``hybrid_gmres_tpu_torch.entry``'s
     ``fn(*example_args)`` on the card (CT n=32, int8, fused, 20 steps: 41
     K1 launches), its residual history against the float64 host solve on
     the same int8 matrices and against the CPU branch (dense float32,
     ``entry(device="cpu")``), its wall beside ``dispatch_floor_seconds``.

The peak device memory of each solve path (``max_memory_allocated``, reset
before the path) is printed after it (``memory``) and all together
(``memory_peaks``), once the kernel phases' plain-version caches are
dropped.

Phase 3 also holds K2w (``wide_matmat`` on the tile form, which the
operators' ``matmat`` takes where ``takes_tiles`` says so: int8 and int4
forms, R >= R_WIDE, stored entries times R >= WIDE_WORK) at the lambda
path's R and layouts (R = 100 and 20 on the transposed view of a
column-major basis, R = 80 on a row-major block): one launch through
``op.matmat`` on the kernel the rule names, K2w against its plain version
(in column chunks), the library call and the float64 product on the form's
values (its error at most twice K2r's against the same product), timed in
turns beside K2r and the library call against the float32 and the
tensor-core bounds, faster than both where routed, and held row by row to
its bound on an X spread over 2^30 (``lambda_mm_kernels``); and sweeps R =
8..128 on A and B with K2w, K2r and the library call side by side, every
routed shape faster on K2w than on K2r (``k2w_sweep``: where the rule comes
from).  The int4 phase does the same on the int4 forms and runs AB-RTP on
them against the same solve on K2r (``int4_wide_path``).

Phase 3 also holds the window kernel (``window_kernels``: ``row_matmat`` and
``row_rmatmat`` with ``gather="window"``, each thread block's columns of X
staged in shared memory from the form's window form), which the multi-RHS
products take where ``takes_windows`` says so (a form that kept its window
form when it was made on the card, R's last tile over 4 columns), on the
four forms (A and B, forward and transposed) of each storage type at both
sizes (a form that kept none gets one for the check): against the plain
version at R in {1, 3, 5, 8, 12} in both layouts, column j bit-equal to
K1r (K3r) on column j, to itself run twice, to the gather kernel
(``row_spmm_kernel``) and to ``out=`` through a taller slab's rows; timed
at R in WINDOW_TIMED_RS in
turns with the gather kernel, at R=8 beside the library call and the bound
of the window form's HBM bytes, with the bytes the staging copies from L2
and the window form's reuse, bytes and build seconds.  Its launches are
counted apart (``window_counts``) and checked in the serving and GKB
batched runs, and every kernel the ``kernels`` line puts on a path was
launched there: the gathers' launches are the serving and ``lsqr_batched``
runs' at both sizes less the window kernel's.

Every phase that fails exits non-zero.  The last three lines are the kernel
record ``{"kernels": [...]}`` (the int4, bfloat16 and float32 variants as
entries of their own),
the card's name and power limit, and the result ``{"ok": true, "device":
{...}}``.  ``--kernels`` stops after phase 3 and the int4 kernel checks (at
both sizes) and prints neither; ``--sharded`` runs only phases 12-14
(their float64 references computed for them) and prints neither;
``--float`` runs only phases 15-16 and prints neither; ``--windows`` runs
only the window kernel's phase (every storage type, both sizes) and prints
neither.
"""

from __future__ import annotations

import copy
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
# K2w against the float64 product on the values the form holds, relative
# to the largest entry: at most this multiple of K2r's error on the same
# input (K2r accumulates in float32; K2w rounds X to 2^-31 of its column's
# largest entry and sums exactly, then rounds once, or once a segment).
K2W_ERR_RATIO = 2.0
# K3 against K1 on an adjoint panel of the same Q, and <A x, u> against
# <x, A^T u>: the same products summed in another order, float32.
ADJOINT_RTOL = 1e-5
# The GKB solvers (tol=0, 100 steps, no reorthogonalization) against the
# same solver in float64 on the host.  The short recurrences lose
# orthogonality in float32 where the semi-convergence minimum is reached
# (k = 7-9): measured on the card, the histories agree to <= 8e-6 over the
# first 6 steps at both sizes, to 2e-5..3e-4 at step 7 and only to 1e-2..1e-1
# after it, and the minima to 2e-5 (LSQR) .. 1e-3 (LSMR, whose minimum falls
# one step later than in float64).  So the history is held over the first
# GKB_REF_K steps to GKB_REF_RTOL and the minimum to GKB_MIN_RTOL; the gate
# on each solver's min-over-k error is its float64 reference's minimum times
# GKB_BAND, since bench.py has no GKB anchor.  The same bands hold a batched
# column to the single-RHS solve of that column (measured <= 1.2e-5 over 6
# steps, minima within 5e-4: the norms reduce in another order).
GKB_REF_K, GKB_REF_RTOL, GKB_MIN_RTOL, GKB_BAND = 6, 1e-4, 5e-3, 1.01
# lsqr with with_adjoint=True against the forward-panels-only run: the same
# recurrence with A^T u summed in another order (K1 on the adjoint panel
# against K3); measured <= 1e-7 over the first GKB_REF_K steps.
WITH_ADJOINT_RTOL = 1e-4
# The redesigned kernels' other variant is timed and compared where the
# gathered vector fits the kernel's shared-memory stage (200 KB).
OTHER_VARIANT_MAX_COLS = 51200
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the tensor
# cores (the kernels multiply float32 x by converted panel values).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the bf16 rate of the tensor cores (dense), for K2w's three products of a
# stored value, one per plane of X
PEAK_BF16_FLOPS = 989e12


def fail(msg):
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# Each progress line carries ``t``, the seconds since the script started,
# so that a run's log reads as a timeline of its phases.
T_START = time.perf_counter()


def say(phase, **fields):
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T_START,
                      **fields}), flush=True)


def time_ms(fn, reps=50):
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, from CUDA events behind a spin of the card, after a warm-up
    (``utils/profiling.device_seconds``)."""
    from hybrid_gmres_tpu_torch.utils.profiling import device_seconds

    return device_seconds(fn, repeats=reps, device="cuda") * 1e3


def per_call_ms(fn, reps):
    """Milliseconds of each of ``reps`` calls of ``fn()``, each between two
    CUDA events and waited for, after one warm-up call."""
    return alternating_ms((fn,), reps)[0]


def alternating_ms(fns, reps):
    """Milliseconds of each of ``reps`` calls of every function in
    ``fns``, the functions taking turns (each call between two CUDA events
    and waited for), after one warm-up call of each: host noise then falls
    on all of them alike."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    out = [[] for _ in fns]
    for _ in range(reps):
        for fn, times in zip(fns, out):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return out


class HostSyncs:
    """Counts the host synchronizations of the block it wraps: PyTorch's
    sync debug mode warns on each synchronizing CUDA call."""

    def __enter__(self):
        import warnings

        import torch

        torch.cuda.set_sync_debug_mode("warn")
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.messages = [str(w.message) for w in self._caught
                         if "synchroniz" in str(w.message).lower()]
        self.count = len(self.messages)


# path -> device memory of its run (PeakMemory)
MEMORY = {}


class PeakMemory:
    """Device memory of the block it wraps: ``max_memory_allocated`` after
    a reset of the peak on entry, beside what was allocated on entry (the
    operators and anything else resident); with ``ops``, also the window
    forms their row forms hold (``RowPacked.wins``, made with the forms:
    MB and build seconds)."""

    def __init__(self, path, ops=()):
        self.path = path
        self.ops = ops

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.resident = torch.cuda.memory_allocated()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        MEMORY[self.path] = dict(
            peak_mb=torch.cuda.max_memory_allocated() / 1e6,
            resident_at_start_mb=self.resident / 1e6)
        windows = {}
        for tag, op in zip("AB", self.ops):
            for form, rp in (("forward", op.fwd_rows),
                             ("transposed", op.adj_rows)):
                wf = rp.wins
                if wf is not None:
                    windows[f"{tag} {form}"] = dict(mb=wf.nbytes / 1e6,
                                                    build_s=wf.seconds)
        say("memory", path=self.path, **MEMORY[self.path],
            window_forms=windows)


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


# library -> its variants' registers and spills, from the build phase
BUILD_VARIANTS = {}


def phase_build():
    """Compile the kernel libraries (one nvcc each, started together, with
    the register and spill report of ptxas) and load them; the report goes
    to BUILD_VARIANTS."""
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
                entry = ln.split("'")[1][:110]
            elif "spill stores" in ln and entry:
                variants.append(dict(entry=entry, spill=ln.split(":")[-1]
                                     .strip()))
            elif "Used" in ln and "registers" in ln and variants:
                variants[-1]["registers"] = int(
                    ln.split("Used")[1].split("registers")[0])
        BUILD_VARIANTS[name] = variants
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


def transposed_work(bell, R):
    """Bytes and flops of the transposed product on this panel: the live
    blocks, the block-column index (8 bytes a block, the segment and column
    offsets), U and the row scale read once, Y written once.  The segment
    partials are the kernel's own scratch and are not counted."""
    import torch

    br, bc = bell.block_shape
    m, n = bell.shape
    live = int(bell.col_blk.shape[0])
    item = torch.empty((), dtype=bell.dtype).element_size()
    nbytes = (live * br * bc * item + live * 8
              + 4 * (bell.seg_off.numel() + bell.col_seg.numel())
              + 4 * R * (n + m) + 4 * m)
    return nbytes, 2 * live * br * bc * R


def row_work(rp, n_scale, R=1):
    """Bytes and flops of one product of R columns on a row-packed form: the
    live values and their column indices, the row offsets and the row map,
    the input (ncols, R), the row scale (``n_scale`` entries) and the output
    (rows, R), each once.  The padding of the rows to whole vectors is not
    counted (it is reported as ``fill``)."""
    rows, ncols = rp.shape
    nbytes = (rp.live * (rp.value_bits / 8 + rp.cols.element_size())
              + 4 * (rows + 1) + 4 * rows + 4 * ncols * R + 4 * n_scale
              + 4 * rows * R)
    return nbytes, 2 * rp.live * R


def bound(work):
    """(bound_ms, bound_by) of ``[(bytes, flops), ...]`` done back to back:
    the larger of bytes over the card's memory rate and flops over its
    float32 rate."""
    t_bytes = sum(w[0] for w in work) / PEAK_BYTES_PER_S * 1e3
    t_flops = sum(w[1] for w in work) / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def tc_bound(work):
    """(bound_ms, bound_by) of ``[(bytes, flops), ...]`` on the tensor
    cores: the larger of bytes over the memory rate and three times the
    flops (three bf16 products of a stored value, a float32 X split in
    three) over the bf16 rate.  K2w's four byte products on the int8 tensor
    cores, at twice that rate, take two thirds of that operation term."""
    t_bytes = sum(w[0] for w in work) / PEAK_BYTES_PER_S * 1e3
    t_flops = sum(3 * w[1] for w in work) / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def quantized_csr(csr, qmax=127):
    """diag(s) Q in float64: the matrix an int8 panel of ``csr`` holds
    (an int4 panel with ``qmax=7``)."""
    import scipy.sparse as sp

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _row_quantize_csr

    csr_q, s = _row_quantize_csr(csr, qmax=qmax)
    return (sp.diags(s.astype(np.float64)) @ csr_q).tocsr()


# library_csr's matrices, kept through one size's kernel phases (each
# phase asks for the same few) and dropped before its paths
# (drop_libraries), whose memory they would count
LIBRARIES = {}


def library_csr(csr, transpose=False, qmax=127):
    """The library's format of the same matrix (or of its transpose): a
    float32 ``torch.sparse`` CSR tensor on the card (cuSPARSE), 32-bit
    indices; ``qmax``: the quantization of the panel (7 for int4)."""
    key = (id(csr), transpose, qmax)
    if key not in LIBRARIES:
        q = quantized_csr(csr.astype(np.float64), qmax)
        LIBRARIES[key] = (csr, library_of(q.T.tocsr() if transpose else q))
    return LIBRARIES[key][1]


def drop_libraries():
    """Let library_csr's matrices go (before a size's paths)."""
    import torch

    LIBRARIES.clear()
    torch.cuda.empty_cache()


def library_of(q):
    """A scipy CSR matrix as a float32 ``torch.sparse`` CSR tensor on the
    card (cuSPARSE), 32-bit indices."""
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(q.indptr.astype(np.int32), device="cuda"),
        torch.as_tensor(q.indices.astype(np.int32), device="cuda"),
        torch.as_tensor(q.data.astype(np.float32), device="cuda"),
        size=q.shape)


def device_panels(*ops):
    """The block-ELL panels of ``ops`` (None skipped) on the card inside
    the block (``BlockELLOperator.panels_on_device``), released on exit."""
    import contextlib

    stack = contextlib.ExitStack()
    for op in ops:
        if op is not None:
            stack.enter_context(op.panels_on_device())
    return stack


def phase_ct_kernels(P):
    """K1-K4 against their plain versions on the CT int8 panels of A and B,
    K2's columns against K1 and K4's against K3, all timed beside the
    library call, the adjoint-panel alternative and the bound; then the
    redesigned K1 and K3 on the row-packed forms of the same operators
    (:func:`row_kernels`) and the redesigned K2 and K4
    (:func:`row_mm_kernels`).  Returns the per-panel records of (K1, K2,
    K3, K4, redesigned K1, redesigned K3, redesigned K2, redesigned K4)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        bucket_matmat, bucket_matmat_plain, bucket_matvec,
        bucket_matvec_plain)

    rng = np.random.default_rng(1)
    recs1, recs2, recs3, recs4, recs1r, recs3r, recs2r, recs4r = (
        [] for _ in range(8))
    for tag, op, adj_op, csr in (("A", P.A_op, P.A_adj, P.A_csr),
                                 ("B", P.B_op, P.B_adj, P.B_csr)):
        with device_panels(op, adj_op):
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
                bound_by=b_by, work=w1,
                max_abs_err=float((y_k - y_p).abs().max()),
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
            check(Y_t.T.is_contiguous(),
                  f"{panel}: K2 did not keep the layout")
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

            p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), \
                time_ms(run_k), time_ms(run_p, 10)
            w2 = panel_work(bell, 8)
            b_ms, b_by = bound([w2])
            recs2.append(dict(
                common, R=8, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                ms_row_major=time_ms(partial(bucket_matmat, bell, X, scale)),
                k1_x8_ms=time_ms(run_8k1, 10),
                library_ms=time_ms(lambda: lib @ X), bound_ms=b_ms,
                bound_by=b_by, work=w2, max_abs_err=float(max(
                    (Y_k - Y_p).abs().max(), (Y_t - Y_p).abs().max())),
                max_rel_err=e2, max_rel_err_R3=e3,
                column_vs_k1_max_diff=col_diff,
                column_equals_k1=col_diff == 0.0, library_max_rel_diff=l2))
            say("kernel_vs_plain", kernel="K2", **recs2[-1])
            r3, r4 = transposed_kernels(op, adj_op, csr, common, rng)
            recs3.append(r3)
            recs4.append(r4)
            r1r, r3r = row_kernels(op, csr, common, rng)
            recs1r.append(r1r)
            recs3r.append(r3r)
            r2r, r4r = row_mm_kernels(op, csr, common, rng)
            recs2r.append(r2r)
            recs4r.append(r4r)
    return recs1, recs2, recs3, recs4, recs1r, recs3r, recs2r, recs4r


def row_kernels(op, csr, common, rng):
    """The redesigned K1 (``row_matvec``, ``diag(s) Q x`` on the form of the
    forward panel) and K3 (``row_rmatvec``, ``Q^T (s u)`` on the form of its
    transpose) on one CT operator: each against its plain version, against
    the block-ELL kernel on the same input, against itself run twice (the
    same bits), in its other variant where the vector fits in shared memory
    (the same bits), and the library call; ``<A x, u>`` through the new K1
    against ``<x, A^T u>`` through the new K3.  Timed in turns (plain, new,
    new, plain) beside the other variant, the block-ELL kernel and the
    library call, against the bound from the form's live bytes.  Returns the
    records of (K1, K3)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        STAGE_MAX_COLS, bucket_matvec, bucket_rmatvec, row_matvec,
        row_matvec_plain, row_rmatvec, row_rmatvec_plain)

    m, n = op.shape
    scale, panel = op.fwd_scale, common["panel"]
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device="cuda")
    u = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                        device="cuda")
    forms = dict(block_ell_mb=op.fwd.nbytes / 1e6,
                 rows_mb=op.fwd_rows.nbytes / 1e6,
                 rows_t_mb=op.adj_rows.nbytes / 1e6)
    recs, outs = [], []
    for kernel, rp, fn, plain, old, v, lib in (
            ("K1 redesigned", op.fwd_rows, row_matvec, row_matvec_plain,
             partial(bucket_matvec, op.fwd, x, scale), x, library_csr(csr)),
            ("K3 redesigned", op.adj_rows, row_rmatvec, row_rmatvec_plain,
             partial(bucket_rmatvec, op.fwd, u, scale), u,
             library_csr(csr, transpose=True))):
        label = f"{panel}: {kernel}"
        staged = rp.shape[1] <= STAGE_MAX_COLS
        got, want = fn(rp, v, scale), plain(rp, v, scale)
        again = fn(rp, v, scale)
        other = (fn(rp, v, scale, stage=not staged)
                 if rp.shape[1] <= OTHER_VARIANT_MAX_COLS else None)
        y_old = old()
        torch.cuda.synchronize()
        check(got.shape == want.shape == (rp.shape[0],) and
              bool(torch.isfinite(got).all()),
              f"{label} output not finite or misshaped")
        err = rel_err(got, want)
        check(err <= KERNEL_RTOL, f"{label} vs plain {err:.3e}")
        repeat = float((got - again).abs().max())
        check(repeat == 0.0, f"{label} differs between two runs by "
              f"{repeat:.3e}")
        variant_diff = None if other is None else float(
            (got - other).abs().max())
        check(variant_diff in (None, 0.0), f"{label}: the staged and the "
              f"cached variant differ by {variant_diff}")
        vs_old = rel_err(got, y_old)
        check(vs_old <= KERNEL_RTOL, f"{label} vs the block-ELL kernel "
              f"{vs_old:.3e}")
        lib_diff = rel_err(lib @ v, got)
        check(lib_diff <= LIBRARY_RTOL, f"{label} vs library "
              f"{lib_diff:.3e}")
        run_k = partial(fn, rp, v, scale)
        run_p = partial(plain, rp, v, scale)
        p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), time_ms(run_k), \
            time_ms(run_p, 10)
        work = row_work(rp, m)
        b_ms, b_by = bound([work])
        ms = (k1 + k2) / 2
        rec = dict(
            common, kernel=kernel, ms=ms, plain_ms=(p1 + p2) / 2,
            library_ms=time_ms(lambda: lib @ v),
            block_ell_ms=time_ms(old), bound_ms=b_ms, bound_by=b_by,
            share_of_bound=b_ms / ms, work=work,
            variant="shared memory" if staged else "read-only cache",
            other_variant_ms=None if other is None else time_ms(
                partial(fn, rp, v, scale, stage=not staged)),
            other_variant_max_diff=variant_diff,
            max_abs_err=float((got - want).abs().max()), max_rel_err=err,
            repeat_max_diff=repeat, vs_block_ell=vs_old,
            library_max_rel_diff=lib_diff, form_shape=list(rp.shape),
            lanes=rp.lanes, fill=rp.fill, live=rp.live,
            index_bits=32 if rp.wide else 16, **forms)
        say("kernel_vs_plain", **rec)
        recs.append(rec)
        outs.append(got)
    Ax, ATu = outs
    lhs, rhs = float(torch.dot(Ax, u)), float(torch.dot(x, ATu))
    gap = abs(lhs - rhs) / float(torch.linalg.vector_norm(Ax)
                                 * torch.linalg.vector_norm(u))
    check(gap <= ADJOINT_RTOL, f"{panel}: redesigned <A x, u> = {lhs!r} but "
          f"<x, A^T u> = {rhs!r}")
    recs[1]["transpose_identity_gap"] = gap
    return recs


def variants_for(rp, X):
    """The variants a multi-RHS kernel can run on form ``rp`` and input
    ``X``, as ``{"gather/threads": keywords}``: the gather through its
    strides and after an interleaving copy always, packed as it is where
    it is row-major on 16-byte rows, each at both block sizes; and the
    window kernel where the form holds a window form."""
    from hybrid_gmres_tpu_torch.ops.sparse import WINDOW_THREADS
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import BLOCK_THREADS, _packable

    gathers = ["strided", "copy"] + (["packed"] if _packable(X) else [])
    return {f"{g}/{t}": dict(gather=g, threads=t) for g in gathers
            for t in BLOCK_THREADS} | ({
                f"window/{WINDOW_THREADS}": dict(gather="window")}
                if rp.wins is not None else {})


def mm_sweep(rp, fn, plain, single, V, args, label, old=None, scale=None,
             into=False):
    """A multi-RHS kernel ``fn`` on form ``rp`` at R in {1, 3, 5, 8, 12},
    row-major and in the batched solvers' layout (the first R columns of
    ``V``): against its plain version (within KERNEL_RTOL) and the
    block-ELL kernel ``old`` where given; column j against the single-RHS
    kernel on column j, twice and, with ``into`` (K2), written through the
    strides of a taller slab's rows, bit for bit; at R=8 also in every
    variant (:func:`variants_for`).
    Returns the worst
    (relative error, absolute error, vs block-ELL, column difference,
    run/gather/out= difference)."""
    import torch

    rows = rp.shape[0]
    worst = abs_err = vs_old = col_diff = var_diff = 0.0
    for R in (1, 3, 5, 8, 12):
        VR = V[:, :R].contiguous()
        want = plain(rp, VR, *args)
        for layout in (VR, VR.T.contiguous().T):
            got = fn(rp, layout, *args)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (rows, R) and
                  bool(torch.isfinite(got).all()),
                  f"{label} output not finite or misshaped at R={R}")
            worst = max(worst, rel_err(got, want))
            abs_err = max(abs_err, float((got - want).abs().max()))
            if old is not None:
                vs_old = max(vs_old, rel_err(got, old(layout, scale)))
            col_diff = max(col_diff, max(float(
                (got[:, j] - single(rp, layout[:, j].contiguous(),
                                    *args)).abs().max()) for j in range(R)))
            runs = [fn(rp, layout, *args)] + [
                fn(rp, layout, *args, **kw)
                for kw in (variants_for(rp, layout).values() if R == 8
                           else ())]
            if into:
                slab = torch.full((R, rows + 5), float("nan"), device="cuda")
                fn(rp, layout, *args, out=slab[:, :rows].T)
                check(bool(slab[:, rows:].isnan().all()),
                      f"{label}: out= wrote past its rows")
                runs.append(slab[:, :rows].T)
            var_diff = max([var_diff] + [float((got - y).abs().max())
                                         for y in runs])
    torch.cuda.synchronize()
    check(worst <= KERNEL_RTOL, f"{label} vs plain {worst:.3e}")
    check(vs_old <= KERNEL_RTOL, f"{label} vs the block-ELL kernel "
          f"{vs_old:.3e}")
    check(col_diff == 0.0, f"{label}: a column differs from the single-RHS "
          f"kernel on it by {col_diff:.3e}")
    check(var_diff == 0.0, f"{label} differs between runs, variants or "
          f"out= by {var_diff:.3e}")
    return worst, abs_err, vs_old, col_diff, var_diff


def row_mm_kernels(op, csr, common, rng):
    """The redesigned K2 (``row_matmat``, ``diag(s) Q X`` on the form of the
    forward panel) and K4 (``row_rmatmat``, ``Q^T (s U)`` on the form of its
    transpose) on one CT operator, at R in {1, 3, 5, 8, 12} in the
    row-major and the batched solvers' layout: each against its plain
    version and the block-ELL kernel; column j against the redesigned K1
    (K3) on column j, bit for bit; twice and in every gather and block size
    (the same bits); K2 written through the strides of a taller slab's rows
    (the same bits); ``<A X, U>`` against ``<X, A^T U>`` column by column;
    the library call.  The gather kernel (``ms``: its default gather and
    block size, :func:`gather_of`, whichever kernel the rule routes to;
    the window kernel's own times are :func:`window_kernels`') timed at
    R=8 in the solvers' layout, in turns (plain, kernel, kernel, plain),
    beside each variant, the block-ELL kernel, eight launches of the
    single-RHS kernel and the library call, against the bound from the
    form's live bytes.  Returns the records of (K2, K4)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        bucket_matmat, bucket_rmatmat, row_matmat,
        row_matmat_plain, row_matvec, row_rmatmat, row_rmatmat_plain,
        row_rmatvec)

    m, n = op.shape
    scale, panel = op.fwd_scale, common["panel"]
    Xall = torch.as_tensor(rng.standard_normal((n, 12)), dtype=torch.float32,
                           device="cuda")
    Uall = torch.as_tensor(rng.standard_normal((m, 12)), dtype=torch.float32,
                           device="cuda")
    recs, outs = [], []
    for kernel, rp, fn, plain, single, old, V, lib, args in (
            ("K2 redesigned", op.fwd_rows, row_matmat, row_matmat_plain,
             row_matvec, partial(bucket_matmat, op.fwd), Xall,
             library_csr(csr), (scale,)),
            ("K4 redesigned", op.adj_rows, row_rmatmat, row_rmatmat_plain,
             row_rmatvec, partial(bucket_rmatmat, op.fwd), Uall,
             library_csr(csr, transpose=True), (scale, op.adj_scale))):
        label = f"{panel}: {kernel}"
        worst, abs_err, vs_old, col_diff, var_diff = mm_sweep(
            rp, fn, plain, single, V, args, label, old=old, scale=scale,
            into=kernel.startswith("K2"))
        V8 = V[:, :8].contiguous()
        Vt = V8.T.contiguous().T          # the batched solvers' layout
        got8 = fn(rp, Vt, *args)
        lib_diff = rel_err(lib @ V8, got8)
        check(lib_diff <= LIBRARY_RTOL, f"{label} vs library {lib_diff:.3e}")
        k4 = kernel.startswith("K4")
        gkw = gather_of(rp, Vt, scaled=k4)
        run_k = partial(fn, rp, Vt, *args, **gkw)
        run_p = partial(plain, rp, Vt, *args)
        p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), time_ms(run_k), \
            time_ms(run_p, 10)
        variant_ms = {name: time_ms(partial(fn, rp, Vt, *args, **kw))
                      for name, kw in variants_for(rp, Vt).items()}
        variant_ms["packed, row-major input"] = time_ms(
            partial(fn, rp, V8, *args, gather="packed"))

        def run_singles():
            for j in range(8):
                single(rp, Vt[:, j], *args)

        work = row_work(rp, m, R=8)
        b_ms, b_by = bound([work])
        ms = (k1 + k2) / 2
        rec = dict(
            common, kernel=kernel, R=8, ms=ms, plain_ms=(p1 + p2) / 2,
            library_ms=time_ms(lambda: lib @ Vt),
            block_ell_ms=time_ms(partial(old, Vt, scale)),
            single_x8_ms=time_ms(run_singles, 10), bound_ms=b_ms,
            bound_by=b_by, share_of_bound=b_ms / ms, work=work, **gkw,
            routed=routed_gather(rp, Vt, scaled=k4), variant_ms=variant_ms,
            max_abs_err=abs_err, max_rel_err=worst, vs_block_ell=vs_old,
            column_vs_single_max_diff=col_diff,
            repeat_variant_out_max_diff=var_diff,
            library_max_rel_diff=lib_diff, form_shape=list(rp.shape),
            lanes=rp.lanes, fill=rp.fill, live=rp.live,
            index_bits=32 if rp.wide else 16)
        recs.append(rec)
        outs.append((V8, got8))
    (X8, AX), (U8, ATU) = outs
    gaps = ((torch.sum(AX * U8, 0) - torch.sum(X8 * ATU, 0)).abs()
            / (torch.linalg.vector_norm(AX, dim=0)
               * torch.linalg.vector_norm(U8, dim=0)))
    gap = float(gaps.max())
    check(gap <= ADJOINT_RTOL, f"{panel}: redesigned <A X, U> against "
          f"<X, A^T U> per column: {gaps.tolist()}")
    recs[1]["transpose_identity_gap"] = gap
    for rec in recs:
        say("kernel_vs_plain", **rec)
    return recs


def window_work(rp, wf, n_scale, R=8):
    """Bytes of one product of R columns on the window kernel's path: the
    live values and their 16-bit local indices, the lists, the window and
    row offsets and the row map, X read once, the scale and Y written once
    (the HBM bound); and the bytes the staging copies from L2 into shared
    memory, 32 a listed column a tile of 8."""
    rows, ncols = rp.shape
    tiles = -(-R // 8)
    hbm = (rp.live * (rp.value_bits / 8 + 2) + 4 * wf.listed
           + 8 * (wf.windows + 1) + 4 * (rows + 1) + 4 * rows
           + 4 * ncols * R + 4 * n_scale + 4 * rows * R)
    return (hbm, 2 * rp.live * R), 32 * wf.listed * tiles


def window_form_record(wf):
    """A window form: windows, rows, lists, reuse (stored slots a listed
    column), bytes, build seconds."""
    return dict(windows=wf.windows, rows_per_window=wf.rows_per_window,
                full_windows=int(((wf.win_row[1:] - wf.win_row[:-1])
                                  == wf.rows_per_window).sum()),
                max_cols=wf.max_cols, listed=wf.listed, reuse=wf.reuse,
                window_mb=wf.nbytes / 1e6, build_s=wf.seconds)


WINDOW_RS = (1, 3, 5, 8, 12)
# the widths the window kernel is timed at against the gather kernel: the
# checked ones, the serving chunks' (8), the batched solvers' R=16 and the
# GCV product's R=20 (n=64: K2r, not K2w)
WINDOW_TIMED_RS = (1, 3, 5, 8, 12, 16, 20)


def window_kernels(P, V, variant, library):
    """The window kernel (``gather="window"``: each block's columns of X
    staged in shared memory) on the four forms of one size's ``variant``
    operators ``V`` (A and B, forward and transposed; a form that kept no
    window form, ``RowPacked.wins``, checked and timed on a copy given
    one): against the plain version at R in WINDOW_RS in the row-major
    and the solvers' layout, column j against the single-RHS kernel
    (K1r/K3r) on column j, against itself run twice, the gather kernel
    (:func:`gather_of`) and the routed default, K2 also written through a
    taller slab's rows: all the same bits.  Timed in the solvers' layout
    in turns with the gather kernel (old, window, window, old) at R in
    WINDOW_TIMED_RS (``by_R``, with the rule's choice at each); at R=8
    beside the window kernel on a row-major X (16-byte staging), the
    library call and the bound (HBM bytes of the window form's path), with
    the bytes the staging copies.  Returns ``{"K2": [...], "K4": [...]}``
    (A's forms, then B's)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.sparse import row_windows_from
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        row_matmat, row_matmat_plain, row_matvec, row_rmatmat,
        row_rmatmat_plain, row_rmatvec, takes_windows)

    rng = np.random.default_rng(6)
    recs = {"K2": [], "K4": []}
    width = max(WINDOW_TIMED_RS)
    for tag, op, csr in (("A", V.A_op, P.A_csr), ("B", V.B_op, P.B_csr)):
        m, n = op.shape
        s = op.fwd_scale
        lib, lib_t = library(csr, op)
        X = torch.as_tensor(rng.standard_normal((n, width)),
                            dtype=torch.float32, device="cuda")
        U = torch.as_tensor(rng.standard_normal((m, width)),
                            dtype=torch.float32, device="cuda")
        for kernel, rp, fn, plain, single, Vall, args, lv in (
                ("K2", op.fwd_rows, row_matmat, row_matmat_plain, row_matvec,
                 X, (s,), lib),
                ("K4", op.adj_rows, row_rmatmat, row_rmatmat_plain,
                 row_rmatvec, U, (s, op.adj_scale), lib_t)):
            label = (f"n={P.n} {tag}{'' if kernel == 'K2' else '^T'} "
                     f"{variant}: {kernel} window")
            kept = rp.wins is not None
            rw = rp
            if not kept:    # a copy with a window form, for the check
                rw = copy.copy(rp)
                rw.wins = row_windows_from(rp)
                check(rw.wins is not None, f"{label}: no window form")
            form = window_form_record(rw.wins)
            scaled = kernel == "K4" and s is not None
            rows = rp.shape[0]
            worst = abs_err = 0.0
            same = True
            for R in WINDOW_RS:
                VR = Vall[:, :R].contiguous()
                want = plain(rp, VR, *args)
                for layout in (VR, VR.T.contiguous().T):
                    got = fn(rw, layout, *args, gather="window")
                    runs = [fn(rw, layout, *args, gather="window"),
                            fn(rp, layout, *args),
                            fn(rp, layout, *args,
                               **gather_of(rp, layout, scaled))]
                    cols = [single(rp, layout[:, j].contiguous(), *args)
                            for j in range(R)]
                    if kernel == "K2":
                        slab = torch.full((R, rows + 5), float("nan"),
                                          device="cuda")
                        fn(rw, layout, *args, out=slab[:, :rows].T,
                           gather="window")
                        runs.append(slab[:, :rows].T)
                    torch.cuda.synchronize()
                    check(got.shape == want.shape == (rows, R) and
                          bool(torch.isfinite(got).all()),
                          f"{label} output not finite or misshaped at R={R}")
                    if kernel == "K2":
                        check(bool(slab[:, rows:].isnan().all()),
                              f"{label}: out= wrote past its rows")
                    worst = max(worst, rel_err(got, want))
                    abs_err = max(abs_err, float((got - want).abs().max()))
                    same &= all(torch.equal(got, y) for y in runs)
                    same &= all(torch.equal(got[:, j], c)
                                for j, c in enumerate(cols))
            check(worst <= KERNEL_RTOL, f"{label} vs plain {worst:.3e}")
            check(same, f"{label}: not the bits of the single-RHS kernel, "
                  "of a second run, of the gather kernel or of out=")
            by_R = {}
            for R in WINDOW_TIMED_RS:
                Vt = Vall[:, :R].contiguous().T.contiguous().T
                gkw = gather_of(rp, Vt, scaled)
                run_w = partial(fn, rw, Vt, *args, gather="window")
                run_o = partial(fn, rp, Vt, *args, **gkw)
                o1, w1, w2, o2 = (time_ms(f) for f in (run_o, run_w, run_w,
                                                        run_o))
                by_R[R] = dict(
                    ms=(w1 + w2) / 2, gather_ms=(o1 + o2) / 2,
                    gather_variant=f"{gkw['gather']}/{gkw['threads']}",
                    vs_gather=(w1 + w2) / (o1 + o2),
                    routed=("window" if takes_windows(rp, R)
                            else gkw["gather"]))
            V8 = Vall[:, :8].contiguous()
            Vt = V8.T.contiguous().T
            hbm, staged = window_work(rp, rw.wins, m, R=8)
            b_ms, b_by = bound([hbm])
            ms = by_R[8]["ms"]
            rec = dict(
                panel=f"n={P.n} {tag} {variant}", kernel=f"{kernel} window",
                form="forward" if kernel == "K2" else "transposed",
                shape=list(rp.shape), lanes=rp.lanes, R=8, **by_R[8],
                kept=kept, by_R=by_R,
                row_major_ms=time_ms(partial(fn, rw, V8, *args,
                                             gather="window")),
                plain_ms=time_ms(partial(plain, rp, Vt, *args), 5),
                library_ms=time_ms(lambda: lv @ Vt), bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / ms, work=hbm,
                staged_l2_mb=staged / 1e6,
                gather_bound_ms=bound([row_work(rp, m, R=8)])[0],
                max_abs_err=abs_err, max_rel_err=worst, bits_equal=same,
                **form)
            say("window_kernels", **rec)
            recs[kernel].append(rec)
    release_plain_caches(V)
    return recs


def transposed_kernels(op, adj_op, csr, common, rng):
    """K3 and K4 on one CT panel: against their plain versions, K4's
    columns against K3 (exactly), K3 twice on the same input (the same
    bits), K3 against K1 on the adjoint panel of the same Q and the
    transpose identity <A x, u> = <x, A^T u> through ``matvec`` and K3
    (float32 rounding), the library call on the transposed CSR; times of
    each, of the adjoint-panel alternative of the block-ELL path (the
    pre-scale and K1, or K2, on the panel of Q^T) and of eight K3 launches.
    Returns the records of (K3, K4)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        bucket_matmat, bucket_matvec, bucket_rmatmat, bucket_rmatmat_plain,
        bucket_rmatvec, bucket_rmatvec_plain)

    bell, scale, panel = op.fwd, op.fwd_scale, common["panel"]
    m, n = op.shape
    lib = library_csr(csr, transpose=True)
    U = torch.as_tensor(rng.standard_normal((m, 8)), dtype=torch.float32,
                        device="cuda")
    Ut = U.T.contiguous().T           # the batched solvers' layout
    u = U[:, 0].contiguous()
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device="cuda")
    index_mb = 4 * (2 * bell.col_blk.numel() + bell.seg_off.numel()
                    + bell.col_seg.numel()) / 1e6
    common = dict(common, index_mb=index_mb, seg_len=bell.seg_len,
                  segments=bell.seg_off.numel() - 1)

    # K3
    z_k, z_p = bucket_rmatvec(bell, u, scale), \
        bucket_rmatvec_plain(bell, u, scale)
    again = bucket_rmatvec(bell, u, scale)
    torch.cuda.synchronize()
    check(z_k.shape == z_p.shape == (n,) and bool(torch.isfinite(z_k).all()),
          f"{panel}: K3 output not finite or misshaped")
    e3 = rel_err(z_k, z_p)
    check(e3 <= KERNEL_RTOL, f"{panel}: K3 vs plain {e3:.3e}")
    repeat = float((z_k - again).abs().max())
    check(repeat == 0.0, f"{panel}: K3 differs between two runs by "
          f"{repeat:.3e}")
    # the adjoint-panel alternative of the block-ELL path: the pre-scale,
    # then K1 on the panel of Q^T
    adjoint_k1 = partial(bucket_matvec, adj_op.adj, scale * u,
                         adj_op.adj_scale)
    a3 = rel_err(adjoint_k1(), z_k)
    check(a3 <= ADJOINT_RTOL, f"{panel}: K3 vs K1 on the adjoint panel "
          f"{a3:.3e}")
    Ax = op.matvec(x)
    lhs, rhs = float(torch.dot(Ax, u)), float(torch.dot(x, z_k))
    dot_gap = abs(lhs - rhs) / float(torch.linalg.vector_norm(Ax)
                                     * torch.linalg.vector_norm(u))
    check(dot_gap <= ADJOINT_RTOL, f"{panel}: <A x, u> = {lhs!r} but "
          f"<x, A^T u> = {rhs!r}")
    l3 = rel_err(lib @ u, z_k)
    check(l3 <= LIBRARY_RTOL, f"{panel}: K3 vs library {l3:.3e}")
    run_k = partial(bucket_rmatvec, bell, u, scale)
    run_p = partial(bucket_rmatvec_plain, bell, u, scale)
    p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), time_ms(run_k), \
        time_ms(run_p, 10)
    w3 = transposed_work(bell, 1)
    b_ms, b_by = bound([w3])
    rec3 = dict(
        common, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
        library_ms=time_ms(lambda: lib @ u),
        adjoint_panel_ms=time_ms(adjoint_k1),
        adjoint_panel_mb=adj_op.adj.nbytes / 1e6,
        bound_ms=b_ms, bound_by=b_by, work=w3,
        max_abs_err=float((z_k - z_p).abs().max()), max_rel_err=e3,
        repeat_max_diff=repeat, vs_adjoint_panel_k1=a3,
        transpose_identity_gap=dot_gap, library_max_rel_diff=l3)
    say("kernel_vs_plain", kernel="K3", **rec3)

    # K4: R=8 in both layouts, a ragged tile R=3, columns against K3
    Z_p = bucket_rmatmat_plain(bell, U, scale)
    Z_k, Z_t = bucket_rmatmat(bell, U, scale), bucket_rmatmat(bell, Ut, scale)
    torch.cuda.synchronize()
    check(Z_k.shape == Z_p.shape == Z_t.shape == (n, 8) and
          bool(torch.isfinite(Z_k).all()),
          f"{panel}: K4 output not finite or misshaped")
    check(Z_t.T.is_contiguous(), f"{panel}: K4 did not keep the layout")
    e4 = max(rel_err(Z_k, Z_p), rel_err(Z_t, Z_p))
    e4r = rel_err(bucket_rmatmat(bell, U[:, :3].contiguous(), scale),
                  Z_p[:, :3])
    check(max(e4, e4r) <= KERNEL_RTOL,
          f"{panel}: K4 vs plain {e4:.3e} (R=8), {e4r:.3e} (R=3)")
    col = max(float((Z[:, j] - bucket_rmatvec(
        bell, U[:, j].contiguous(), scale)).abs().max())
        for j in range(8) for Z in (Z_k, Z_t))
    check(col == 0.0, f"{panel}: K4 column differs from K3 by {col:.3e}")
    adjoint_k2 = partial(bucket_matmat, adj_op.adj, scale[:, None] * Ut,
                         adj_op.adj_scale)
    a4 = rel_err(adjoint_k2(), Z_k)
    check(a4 <= ADJOINT_RTOL, f"{panel}: K4 vs K2 on the adjoint panel "
          f"{a4:.3e}")
    l4 = rel_err(lib @ U, Z_k)
    check(l4 <= LIBRARY_RTOL, f"{panel}: K4 vs library {l4:.3e}")
    run_k = partial(bucket_rmatmat, bell, Ut, scale)
    run_p = partial(bucket_rmatmat_plain, bell, U, scale)

    def run_8k3():
        for j in range(8):
            bucket_rmatvec(bell, Ut[:, j], scale)

    p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), time_ms(run_k), \
        time_ms(run_p, 10)
    w4 = transposed_work(bell, 8)
    b_ms, b_by = bound([w4])
    rec4 = dict(
        common, R=8, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
        ms_row_major=time_ms(partial(bucket_rmatmat, bell, U, scale)),
        k3_x8_ms=time_ms(run_8k3, 10),
        library_ms=time_ms(lambda: lib @ U),
        adjoint_panel_ms=time_ms(adjoint_k2),
        bound_ms=b_ms, bound_by=b_by, work=w4,
        max_abs_err=float(max((Z_k - Z_p).abs().max(),
                              (Z_t - Z_p).abs().max())),
        max_rel_err=e4, max_rel_err_R3=e4r, column_vs_k3_max_diff=col,
        vs_adjoint_panel_k2=a4, library_max_rel_diff=l4)
    say("kernel_vs_plain", kernel="K4", **rec4)
    return rec3, rec4


def phase_small_kernels(device="cuda"):
    """K1-K4 vs plain on small random panels in every storage type, with
    (8,128) and (32,128) blocks: K1/K2 on forward and adjoint panels, K2 at
    R in {1, 5, 8, 12} in both layouts (12 = a full tile and a ragged one);
    K3/K4 on the forward panel, K4 at R in {1, 3, 5, 8, 12} in both layouts,
    its columns against K3 exactly, K3 twice for the same bits; the
    redesigned K1-K4 on the operators with and without an adjoint panel
    (:func:`row_checks`), and on matrices of 70000 columns and of 70000 rows
    (32-bit indices in the forward and in the transposed form)."""
    import scipy.sparse as sp
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        BlockELLOperator, bucket_matmat, bucket_matmat_plain, bucket_matvec,
        bucket_matvec_plain, bucket_rmatmat, bucket_rmatmat_plain,
        bucket_rmatvec, bucket_rmatvec_plain)

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
            with op.panels_on_device():
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
                bell, scale = op.fwd, op.fwd_scale
                u = U[:, 0].contiguous()
                z = bucket_rmatvec(bell, u, scale)
                worst3 = rel_err(z, bucket_rmatvec_plain(bell, u, scale))
                rep = float((z - bucket_rmatvec(bell, u, scale)).abs().max())
                worst4 = col4 = 0.0
                for R in (1, 3, 5, 8, 12):
                    UR = U[:, :R].contiguous()
                    want = bucket_rmatmat_plain(bell, UR, scale)
                    for layout in (UR, UR.T.contiguous().T):
                        got = bucket_rmatmat(bell, layout, scale)
                        check(got.shape == want.shape,
                              f"{label}: K4 output misshaped at R={R}")
                        worst4 = max(worst4, rel_err(got, want))
                        col4 = max(col4, max(float((got[:, j] - bucket_rmatvec(
                            bell, UR[:, j].contiguous(), scale)).abs().max())
                            for j in range(R)))
                torch.cuda.synchronize()
                check(worst1 <= KERNEL_RTOL,
                      f"{label}: K1 vs plain {worst1:.3e}")
                check(worst2 <= KERNEL_RTOL,
                      f"{label}: K2 vs plain {worst2:.3e}")
                check(worst3 <= KERNEL_RTOL,
                      f"{label}: K3 vs plain {worst3:.3e}")
                check(worst4 <= KERNEL_RTOL,
                      f"{label}: K4 vs plain {worst4:.3e}")
                check(rep == 0.0 and col4 == 0.0, f"{label}: K3 twice "
                      f"differs by {rep:.3e}, K4's columns from K3 by "
                      f"{col4:.3e}")
                if dt == torch.bfloat16:
                    # bf16 keeps 8 significant bits: each stored entry is
                    # off by <= 2^-9 of itself, so |y_bf16 - y_f32| <= 2^-9
                    # sum|a x| per row (plus f32 accumulation, far smaller):
                    # bound 2^-8.
                    x = X[:, 0].contiguous()
                    abs_op = BlockELLOperator.from_csr(
                        abs(csr), block=block, device=device)
                    with abs_op.panels_on_device():
                        absax = bucket_matvec_plain(abs_op.fwd, x.abs())
                    check(bool(((op.matvec(x) - ref32.matvec(x)).abs()
                                <= 2.0 ** -8 * absax + 1e-30).all()),
                          f"{label}: bf16 panel outside its rounding bound")
                say("kernel_vs_plain_small", panel=label,
                    k1_max_rel_err=worst1, k2_max_rel_err=worst2,
                    k2_column_vs_k1_max_diff=col,
                    k3_max_rel_err=worst3, k4_max_rel_err=worst4,
                    k4_column_vs_k3_max_diff=col4, k3_repeat_max_diff=rep)
            fwd_only = BlockELLOperator.from_csr(
                csr, block=block, dtype=dt, with_adjoint=False, device=device)
            for tag, o in (("with_adjoint", op), ("forward only", fwd_only)):
                say("kernel_vs_plain_small", panel=f"{label} {tag}",
                    **row_checks(o, X, U, f"{label} {tag}"))
    for shape in ((600, 70000), (70000, 600)):
        wide = sp.random(*shape, density=5e-4, format="csr",
                         random_state=np.random.RandomState(3),
                         dtype=np.float64)
        Xw = torch.as_tensor(rng.standard_normal((shape[1], 12)),
                             dtype=torch.float32, device=device)
        Uw = torch.as_tensor(rng.standard_normal((shape[0], 12)),
                             dtype=torch.float32, device=device)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            op = BlockELLOperator.from_csr(wide, block=(8, 128), dtype=dt,
                                           with_adjoint=False, device=device)
            label = f"random {shape} {dt}"
            check(op.fwd_rows.wide == (shape[1] > 65536) and
                  op.adj_rows.wide == (shape[0] > 65536),
                  f"{label}: index widths {op.fwd_rows.cols.dtype}, "
                  f"{op.adj_rows.cols.dtype}")
            say("kernel_vs_plain_small", panel=label,
                **row_checks(op, Xw, Uw, label))


def row_checks(op, X, U, label):
    """The redesigned K1 and K3 of ``op`` against their plain versions on
    the first columns of ``X`` and ``U``, each run twice (the same bits) and
    in both variants where the vector fits in shared memory (the same bits);
    the redesigned K2 and K4 on their columns (:func:`mm_sweep`).  Returns
    the worst numbers."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        row_matmat, row_matmat_plain, row_matvec, row_matvec_plain,
        row_rmatmat, row_rmatmat_plain, row_rmatvec, row_rmatvec_plain)

    x, u = X[:, 0].contiguous(), U[:, 0].contiguous()
    out = {}
    for kernel, rp, fn, plain, single, V, args in (
            ("k2r", op.fwd_rows, row_matmat, row_matmat_plain, row_matvec, X,
             (op.fwd_scale,)),
            ("k4r", op.adj_rows, row_rmatmat, row_rmatmat_plain, row_rmatvec,
             U, (op.fwd_scale, op.adj_scale))):
        worst, _, _, col, var = mm_sweep(rp, fn, plain, single, V, args,
                                         f"{label}: redesigned {kernel}",
                                         into=kernel == "k2r")
        out.update({f"{kernel}_max_rel_err": worst,
                    f"{kernel}_column_vs_single_max_diff": col,
                    f"{kernel}_repeat_variant_out_max_diff": var})
    for kernel, rp, fn, plain, v, scales in (
            ("k1r", op.fwd_rows, row_matvec, row_matvec_plain, x,
             (op.fwd_scale,)),
            ("k3r", op.adj_rows, row_rmatvec, row_rmatvec_plain, u,
             (op.fwd_scale, op.adj_scale))):
        got = fn(rp, v, *scales)
        err = rel_err(got, plain(rp, v, *scales))
        diff = float((got - fn(rp, v, *scales)).abs().max())
        if rp.shape[1] <= OTHER_VARIANT_MAX_COLS:
            for stage in (True, False):
                diff = max(diff, float(
                    (got - fn(rp, v, *scales, stage=stage)).abs().max()))
        torch.cuda.synchronize()
        check(err <= KERNEL_RTOL, f"{label}: redesigned {kernel} vs plain "
              f"{err:.3e}")
        check(diff == 0.0, f"{label}: redesigned {kernel} differs between "
              f"runs or variants by {diff:.3e}")
        out.update({f"{kernel}_max_rel_err": err,
                    f"{kernel}_repeat_and_variant_max_diff": diff,
                    f"{kernel}_lanes": rp.lanes, f"{kernel}_fill": rp.fill,
                    f"{kernel}_index_bits": 32 if rp.wide else 16})
    return out


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


def make_problem(n, device="cuda", adjoint=False):
    """The bench scenario: CT n with 180*n/64 angles and detectors, int8
    Morton block-ELL operators (forward panels only, the default of
    ``ct_gpu_operators``), 25% noise from seed 0.  ``adjoint``: also the
    ``with_adjoint=True`` operators, as ``A_adj``/``B_adj``."""
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
    A_adj = B_adj = None
    if adjoint:
        A_adj, B_adj = ct_gpu_operators(prob, dtype="int8", device=device,
                                        with_adjoint=True)[:2]
    P = SimpleNamespace(n=n, prob=prob, A_op=A_op, B_op=B_op, A_adj=A_adj,
                        B_adj=B_adj,
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


def scipy_operator(csr, qmax=127):
    """The float64 host operator diag(s) Q of an int8 panel of ``csr`` (of
    an int4 one with ``qmax=7``; ``csr`` itself with ``qmax=None``): scipy
    CSR products, independent of the kernels."""
    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator

    class ScipyOperator(LinearOperator):
        dtype, device = torch.float64, torch.device("cpu")

        def __init__(self, csr):
            self.csr = quantized_csr(csr, qmax) if qmax else csr.tocsr()
            self.csr_t = self.csr.T.tocsr()
            self.shape = self.csr.shape

        def matvec(self, v):
            return torch.from_numpy(self.csr @ v.numpy())

        def rmatvec(self, u):
            return torch.from_numpy(self.csr_t @ u.numpy())

    return ScipyOperator(csr.astype(np.float64))


def host_reference(prob, ray_perm, pix_perm, b, qmax=127, kind="ba",
                   transposed=False, maxit=MAXIT, hist="err_hist"):
    """The same solve in float64 on the host, independent of the kernels:
    scipy CSR products with the exactly quantized operators diag(s) Q (the
    matrices the int8 panels hold; the int4 ones with ``qmax=7``) and the
    port's float64 single-RHS solver (``kind``: "ba" or "ab").
    ``transposed``: B quantized per row of B^T, as the sharded solvers'
    transposed layout holds it, instead of per pixel.  Returns the history
    ``hist`` (the error history by default; ``maxit`` steps)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.ordering import reorder_pair
    from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres

    A, B = reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32), ray_perm, pix_perm)
    B_op = (scipy_operator(B.T.tocsr(), qmax).T if transposed
            else scipy_operator(B, qmax))
    r = {"ba": ba_gmres, "ab": ab_gmres}[kind](
        scipy_operator(A, qmax), B_op, torch.from_numpy(b.astype(np.float64)),
        torch.from_numpy(prob.x_true[pix_perm]), tol=0.0, maxit=maxit,
        lam=LAM, residual="fused")
    return getattr(r, hist).numpy()


GKB_SINGLE = ("lsqr", "hybrid_lsqr", "lsmr", "hybrid_lsmr")
GKB_BATCHED = ("lsqr_batched", "hybrid_lsqr_batched", "lsmr_batched")
REORTH = " reorth=True"


def gkb_solver(name):
    """(function, its fixed keywords) of a GKB solver by name."""
    import importlib

    module = {"lsqr": "lsqr", "hybrid_lsqr": "lsqr", "lsmr": "lsmr",
              "hybrid_lsmr": "lsmr"}.get(name, "gkb_batched")
    fn = getattr(importlib.import_module(
        f"hybrid_gmres_tpu_torch.solvers.{module}"), name)
    return fn, ({"lam": LAM} if "hybrid" in name else {})


def gkb_launches(name, maxit):
    """(forward, transposed) kernel launches of one cold GKB solve, worked
    out from the code: every solver applies A^T once at the start, then A
    and A^T once per step.  LSQR adds one forward product for the final
    true-residual patch; hybrid LSQR and hybrid LSMR one per step for the
    true residual; LSMR a forward and a transposed one per step (true
    residual and ||A^T r||).  Single-RHS products run the redesigned K1/K3,
    one launch each (the block-ELL K3's finishing pass is gone), the batched
    twins make the same calls through the redesigned K2/K4; with or without
    an adjoint panel."""
    base = name.replace("_batched", "")
    return {"lsqr": (maxit + 1, maxit + 1),
            "hybrid_lsqr": (2 * maxit, maxit + 1),
            "lsmr": (2 * maxit, 2 * maxit + 1),
            "hybrid_lsmr": (2 * maxit, maxit + 1)}[base]


def host_reference_gkb(P, name, b, maxit=MAXIT):
    """Solver ``name`` of the port in float64 on the host with the scipy
    operator of A.  Returns the error history."""
    import torch

    if getattr(P, "host_A", None) is None:
        P.host_A = scipy_operator(P.A_csr)
    fn, kw = gkb_solver(name)
    r = fn(P.host_A, torch.from_numpy(b.astype(np.float64)),
           torch.from_numpy(P.prob.x_true[P.pix_perm]), tol=0.0, maxit=maxit,
           **kw)
    return r.err_hist.numpy()


def kernel_wrappers():
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        bucket_matmat, bucket_matvec, bucket_rmatmat, bucket_rmatvec,
        row_matmat, row_matvec, row_rmatmat, row_rmatvec, wide_matmat)

    return (bucket_matvec, bucket_matmat, bucket_rmatvec, bucket_rmatmat,
            row_matvec, row_rmatvec, row_matmat, row_rmatmat, wide_matmat)


# the order of counts(): the block-ELL K1-K4, then the redesigned K1, K3,
# K2 and K4, then K2 for wide right-hand-side blocks (K2w)
LAUNCHES = "(K1, K2, K3, K4, K1r, K3r, K2r, K4r, K2w)"


def reset_counts():
    for wrapper in kernel_wrappers():
        wrapper.launches = 0
        if hasattr(wrapper, "window_launches"):
            wrapper.window_launches = 0


def window_counts():
    """Launches of the window kernel as K2r and as K4r since the last reset
    (``row_matmat.window_launches``, ``row_rmatmat.window_launches``): part
    of counts()' K2r and K4r."""
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import row_matmat, row_rmatmat

    return row_matmat.window_launches, row_rmatmat.window_launches


def windowed(rp, R):
    """1 when the rule sends ``rp``'s multi-RHS products of ``R`` columns
    to the window kernel (``takes_windows``), else 0."""
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import takes_windows

    return int(takes_windows(rp, R))


def gathers_only(fn):
    """``fn`` run with the window kernel taking no product (every
    multi-RHS product on the gathers): the same bits, to time a path both
    ways in one process."""
    from hybrid_gmres_tpu_torch.ops import spmv_cuda

    def run():
        rule = spmv_cuda.WINDOW_MIN_TAIL
        spmv_cuda.WINDOW_MIN_TAIL = spmv_cuda.RHS_TILE
        try:
            return fn()
        finally:
            spmv_cuda.WINDOW_MIN_TAIL = rule

    return run


def gather_of(rp, X, scaled=False):
    """The gather kernel's variant for a product on ``rp`` of ``X`` where
    the rule takes no window kernel (``_gather_for``, ``_threads_for``), as
    the keywords of ``row_matmat``/``row_rmatmat``."""
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _gather_for, _threads_for

    g = _gather_for(rp, X, scaled=scaled)
    return dict(gather=g, threads=_threads_for(rp, g))


def routed_gather(rp, X, scaled=False):
    """The way a multi-RHS product on ``rp`` reads ``X`` by default:
    ``"window"`` where the rule takes the window kernel, else the gather
    kernel's (``_gather_for``)."""
    return ("window" if windowed(rp, X.shape[1])
            else gather_of(rp, X, scaled)["gather"])


def counts():
    """Launches of (K1, K2, K3, K4, K1r, K3r, K2r, K4r, K2w) since the last
    reset: the block-ELL kernels, then the redesigned K1, K3, K2 and K4
    (``row_matvec``, ``row_rmatvec``, ``row_matmat``, ``row_rmatmat``), then
    K2w (``wide_matmat``)."""
    return tuple(wrapper.launches for wrapper in kernel_wrappers())


def held_to(err, err_ref, label, what, bands=None):
    """The first REF_K entries of an error history within REF_RTOL of a
    reference and its minimum within REF_MIN_RTOL (or the ``bands`` given:
    steps, history tolerance, minimum tolerance); returns both gaps."""
    ref_k, rtol, min_rtol = bands or (REF_K, REF_RTOL, REF_MIN_RTOL)
    hist = float(np.max(np.abs(err[:ref_k] - err_ref[:ref_k])
                        / err_ref[:ref_k]))
    at_min = abs(float(err.min()) - float(err_ref.min())) / float(
        err_ref.min())
    check(hist <= rtol, f"{label}: error history vs {what} {hist:.2e} > "
          f"{rtol:.0e} (first {ref_k} steps)")
    check(at_min <= min_rtol, f"{label}: min-over-k error vs {what} "
          f"{at_min:.2e} > {min_rtol:.0e}")
    return hist, at_min


def release_plain_caches(P):
    """Drop the sum orders that the kernel phases made the plain versions
    cache on the card (``RowPacked.sum_order``: int64 indices of every
    stored entry, gigabytes at n=128), and the tile forms K2w's phase built
    (the lambda path builds them again at its first wide product).  No
    solve reads them, so the memory peaks of the paths then count what the
    paths need."""
    import torch

    for op in (P.A_op, P.B_op, P.A_adj, P.B_adj):
        if op is not None:
            for rp in (op.fwd_rows, op.adj_rows):
                rp.__dict__.pop("sum_order", None)
            op._tiles = None      # rebuilt at the next wide product
    torch.cuda.empty_cache()


def phase_main_path(P):
    """One counted single-RHS solve, its checks (launch counts, shapes,
    finiteness, quality gate, float64 host reference), then it/s over timed
    solves.  Returns (the launches of counts(), it/s, the reference's error
    history)."""
    import torch

    n = P.n
    t0 = time.perf_counter()
    reset_counts()
    with HostSyncs() as syncs:
        r = solve(P)
    torch.cuda.synchronize()
    launched = counts()
    first_s = time.perf_counter() - t0
    niters = int(r.niters)
    err = r.err_hist.cpu().numpy()
    res = r.res_hist.cpu().numpy()
    ms = per_call_ms(lambda: solve(P), reps=5)
    q1, med, q3 = (float(v) for v in np.percentile(ms, [25, 50, 75]))
    want = (0, 0, 0, 0, 2 * MAXIT + 1, 0, 0, 0, 0)
    check(launched == want, f"n={n}: {LAUNCHES} launches {launched} in the "
          f"single solve, expected {want}")
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
    P.ptr_min = min_err
    ref_diff, min_diff = held_to(err, err_ref, f"n={n}",
                                 "float64 host reference")
    say("main_path", **P.info, maxit=MAXIT, lam=LAM,
        launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=launched, host_syncs=syncs.count,
        first_solve_s=first_s,
        timed_solves=len(ms),
        solve_ms_median=med, solve_ms_q1=q1, solve_ms_q3=q3,
        solve_ms_min=min(ms), solve_ms_max=max(ms),
        iters_per_s=MAXIT / (med / 1e3), min_err=min_err,
        min_err_k=int(err.argmin()) + 1, final_err=float(err[-1]),
        final_res=float(res[-1]), gate=GATES[n],
        bench_py_gate=BENCH_PY_GATES[n],
        f64_ref_min_err=float(err_ref.min()), f64_ref_min_rel_diff=min_diff,
        f64_ref_hist_rel_diff=ref_diff, f64_ref_s=ref_s)
    return launched, MAXIT / (med / 1e3), err_ref


def counted_batched(P, b, defer, expect_k2, label, x0=None, **kw):
    """One batched solve with the launch counts reset before and read
    after, and the checks every serving run gets: counts (``expect_k2``
    launches of the redesigned K2 and nothing else), niters, shapes, finite
    histories.  Returns (result, the launches of counts())."""
    import torch

    m, nx = P.A_op.shape
    R = b.shape[1]
    reset_counts()
    r = solve_batched(P, b, defer, x0=x0, **kw)
    torch.cuda.synchronize()
    launched = counts()
    want = (0, 0, 0, 0, 0, 0, expect_k2, 0, 0)
    check(launched == want, f"{label}: {LAUNCHES} launches {launched}, "
          f"expected {want}")
    # of them on the window kernel: A's products (MAXIT a scan, one more
    # from a warm start) and B's (MAXIT + 1 a scan) where the rule routes
    # their forms there at the scans' width (chunk_rhs=8)
    warm = int(x0 is not None)
    scans = (expect_k2 - warm) // (2 * MAXIT + 1)
    chunk = min(R, 8)
    want_w = ((scans * MAXIT + warm) * windowed(P.A_op.fwd_rows, chunk)
              + scans * (MAXIT + 1) * windowed(P.B_op.fwd_rows, chunk), 0)
    counted_batched.window = window_counts()
    check(counted_batched.window == want_w, f"{label}: window kernel "
          f"launches {counted_batched.window}, expected {want_w}")
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
    return r, launched


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
    (``ref0``, the single solve's: seed 0 is column 0).  Returns the
    launches of counts() in the first counted solve (R=8 deferred), then
    those of the window kernel as (K2r, K4r) in it (:func:`window_counts`)."""
    import torch

    n, R = P.n, 8
    gate = SERVING_GATES[n]
    cold = 2 * MAXIT + 1
    b_host = noisy_sinograms(P, range(2 * R))
    b_all = torch.as_tensor(b_host, device="cuda")
    b8 = b_all[:, :R].contiguous()
    out = dict(n=n, R=R, maxit=MAXIT, lam=LAM, chunk_rhs=8, gate=gate,
               single_rhs_iters_per_s=single_its)

    r_def, first = counted_batched(P, b8, True, cold,
                                   f"n={n} R=8 deferred")
    first_window = counted_batched.window
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
    out["deferred_window_vs_gathers"] = in_turns(
        f"n={n} R=8 deferred: window kernel vs gathers", {
            "rule": lambda: solve_batched(P, b8, True),
            "gathers": gathers_only(lambda: solve_batched(P, b8, True))})
    out["k2r_launches"] = {"R=8 deferred": first[6]}

    if full:
        r_in, k2 = counted_batched(P, b8, False, cold, f"n={n} R=8 in-loop")
        out["k2r_launches"]["R=8 in-loop"] = k2[6]
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
        out["k2r_launches"]["R=16 deferred"] = k2[6]
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
        out["k2r_launches"].update({"frame 2 cold": k2c[6],
                                    "frame 2 warm": k2w[6]})
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
    return first + first_window


def gkb_counted(name, A_op, b, x_true, maxit, label, max_syncs=8, **extra):
    """One GKB solve with the launch counts reset before and read after,
    and the checks every GKB run gets: no host synchronization while the
    solve is queued (PyTorch's sync debug mode warns on each; at most
    ``max_syncs`` outside the loop, None to only count them), niters,
    shapes, finite results.  Returns (result, the launches of counts())."""
    import torch

    fn, kw = gkb_solver(name)
    reset_counts()
    with HostSyncs() as syncs:
        r = fn(A_op, b, x_true, tol=0.0, maxit=maxit, **{**kw, **extra})
    # Outside the loop a solve may touch the host a few times: the
    # fingerprint's host values are copied to the card, a resume reads the
    # stored fingerprint, a lam tensor is read once.  A synchronization
    # inside the loop would show up once per step (maxit >= 40 here).
    check(max_syncs is None or syncs.count <= max_syncs,
          f"{label}: {syncs.count} host synchronizations while queueing the "
          f"solve: {syncs.messages[:3]}")
    torch.cuda.synchronize()
    launched = counts()
    tail = tuple(b.shape[1:])
    k0 = 0 if extra.get("resume_from") is None else \
        extra["resume_from"].res_hist.shape[0]
    if k0 == 0 and "x0" not in extra:
        fwd, tr = gkb_launches(name, maxit)
        want = (0, 0, 0, 0) + ((0, 0, fwd, tr, 0) if tail
                                else (fwd, tr, 0, 0, 0))
        check(launched == want, f"{label}: {LAUNCHES} launches "
              f"{launched}, expected {want}")
        # the window kernel's share: all of A's K2r (K4r) where the rule
        # routes its forward (transposed) form there
        want_w = ((launched[6] * windowed(A_op.fwd_rows, tail[0]),
                   launched[7] * windowed(A_op.adj_rows, tail[0])) if tail
                  else (0, 0))
        check(window_counts() == want_w, f"{label}: window kernel "
              f"launches {window_counts()}, expected {want_w}")
    check(bool((r.niters == maxit).all()), f"{label}: niters "
          f"{r.niters.tolist()} != {maxit}")
    check(tuple(r.x.shape) == (A_op.shape[1],) + tail and
          tuple(r.err_hist.shape) == tuple(r.res_hist.shape) ==
          (maxit,) + tail, f"{label}: misshaped results")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.err_hist).all()
               and torch.isfinite(r.res_hist).all()),
          f"{label}: non-finite results")
    if "lsmr" in name and "hybrid" not in name:
        check(bool(torch.isfinite(r.ar_hist).all()),
              f"{label}: non-finite ||A^T r|| history")
    gkb_counted.host_syncs = syncs.count
    gkb_counted.window = window_counts()
    return r, launched


def gkb_timed(name, A_op, b, x_true, maxit, **extra):
    fn, kw = gkb_solver(name)
    ms = per_call_ms(lambda: fn(A_op, b, x_true, tol=0.0, maxit=maxit,
                                **{**kw, **extra}), reps=5)
    med = float(np.median(ms))
    R = b.shape[1] if b.ndim == 2 else 1
    return dict(solve_ms_median=med, solve_ms_min=min(ms),
                solve_ms_max=max(ms), iters_per_s=maxit / (med / 1e3),
                rhs_iters_per_s=R * maxit / (med / 1e3))


GKB_BANDS = (GKB_REF_K, GKB_REF_RTOL, GKB_MIN_RTOL)


def phase_gkb_path(P, names, gcv=False):
    """The single-RHS GKB solvers on the forward-panels-only operator: the
    launch counts against the counts worked out from the code, the error
    history against the same solver in float64 on the host, the gate
    (that reference's minimum x GKB_BAND), it/s.  ``lsqr`` also on the
    ``with_adjoint=True`` operator and, with ``gcv``, ``hybrid_lsmr`` with
    ``lam="gcv"``.  Returns ``{name: (launches, error history on the card,
    reference history)}``."""
    n, out = P.n, {}
    for name in names:
        label = f"n={n} {name}"
        r, launched = gkb_counted(name, P.A_op, P.b, P.x_true, MAXIT, label)
        host_syncs = gkb_counted.host_syncs
        err = r.err_hist.cpu().numpy()
        t0 = time.perf_counter()
        err_ref = host_reference_gkb(P, name, P.b_host)
        ref_s = time.perf_counter() - t0
        gate = float(err_ref.min()) * GKB_BAND
        check(float(err.min()) <= gate, f"{label}: min-over-k rel err "
              f"{err.min():.4f} > gate {gate:.4f}")
        hist, at_min = held_to(err, err_ref, label, "float64 host reference",
                               GKB_BANDS)
        rec = dict(n=n, solver=name, maxit=MAXIT,
                   lam=LAM if "hybrid" in name else None,
                   launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=launched,
                   host_syncs=host_syncs,
                   min_err=float(err.min()),
                   min_err_k=int(err.argmin()) + 1, final_err=float(err[-1]),
                   final_res=float(r.res_hist[-1]), gate=gate,
                   f64_ref_min_err=float(err_ref.min()),
                   f64_ref_min_rel_diff=at_min, f64_ref_hist_rel_diff=hist,
                   f64_ref_s=ref_s,
                   **gkb_timed(name, P.A_op, P.b, P.x_true, MAXIT))
        if name == "lsqr" and P.A_adj is not None:
            # the with_adjoint=True configuration: K1 on a second panel
            ra, la = gkb_counted(name, P.A_adj, P.b, P.x_true, MAXIT,
                                 label + " with_adjoint")
            gap = float(np.max(np.abs(
                ra.err_hist.cpu().numpy()[:GKB_REF_K] - err[:GKB_REF_K])
                / err[:GKB_REF_K]))
            check(gap <= WITH_ADJOINT_RTOL, f"{label}: with_adjoint=True "
                  f"differs from forward panels only by {gap:.2e}")
            rec["with_adjoint"] = dict(
                launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=la, hist_rel_diff=gap,
                panel_mb=(P.A_adj.fwd.nbytes + P.A_adj.adj.nbytes) / 1e6,
                **gkb_timed(name, P.A_adj, P.b, P.x_true, MAXIT))
        if name == "hybrid_lsmr" and gcv:
            # the per-iteration GCV lambda (two SVDs of the padded
            # (maxit+1, maxit) bidiagonal per step; torch.linalg.svd reads
            # its status on the host, so this mode does synchronize): held
            # to the fixed-lambda minimum within GCV_BAND, and timed
            rg, lg = gkb_counted(name, P.A_op, P.b, P.x_true, MAXIT,
                                 label + " lam=gcv", max_syncs=None,
                                 lam="gcv")
            m_g = float(rg.err_hist.min())
            check(m_g <= GCV_BAND * float(err.min()), f"{label} lam=gcv: "
                  f"min-over-k rel err {m_g:.4f} above {GCV_BAND} x the "
                  f"fixed-lambda minimum {err.min():.4f}")
            fn, _ = gkb_solver(name)
            rec["lam=gcv"] = dict(
                launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=lg,
                host_syncs=gkb_counted.host_syncs,
                min_err=m_g, min_err_k=int(rg.err_hist.argmin()) + 1,
                solve_ms=per_call_ms(lambda: fn(
                    P.A_op, P.b, P.x_true, tol=0.0, maxit=MAXIT, lam="gcv"),
                    reps=2))
        say("gkb_path", **rec)
        out[name] = (launched, err, err_ref)
    return out


def phase_gkb_serving(P, names, ref0, full):
    """The GKB serving batch (R=8, noise seeds 0..7): launch counts, every
    column against the port's single-RHS solve of that column (``full``)
    and column 0 against the float64 host reference ``ref0[name]``, solver
    and RHS it/s; with ``full`` also hybrid LSQR with an (R,) lambda against
    the scalar call and a resume 40 -> 100 against the uninterrupted run,
    both exactly.  Returns ``{name: launches}``: counts() of the first run,
    then the window kernel's (K2r, K4r) in it."""
    import torch

    n, R = P.n, 8
    b_host = noisy_sinograms(P, range(R))
    b8 = torch.as_tensor(b_host, device=P.device)
    out = {}
    for name in names:
        label = f"n={n} {name} R={R}"
        single = name.replace("_batched", "")
        r, launched = gkb_counted(name, P.A_op, b8, P.x_true, MAXIT, label)
        window = gkb_counted.window
        err = r.err_hist.cpu().numpy()
        rec = dict(n=n, solver=name, R=R, maxit=MAXIT,
                   lam=LAM if "hybrid" in name else None,
                   launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=launched,
                   host_syncs=gkb_counted.host_syncs,
                   min_err=err.min(axis=0).tolist(),
                   min_err_k=(err.argmin(axis=0) + 1).tolist())
        rec["f64_ref_hist_rel_diff"], rec["f64_ref_min_rel_diff"] = held_to(
            err[:, 0], ref0[single], f"{label} column 0",
            "float64 host reference", GKB_BANDS)
        if full:
            worst_h = worst_m = 0.0
            fn1, kw1 = gkb_solver(single)
            for j in range(R):
                rj = fn1(P.A_op, b8[:, j].contiguous(), P.x_true, tol=0.0,
                         maxit=MAXIT, **kw1)
                h, mn = held_to(err[:, j], rj.err_hist.cpu().numpy(),
                                f"{label} column {j}",
                                "its single-RHS solve", GKB_BANDS)
                worst_h, worst_m = max(worst_h, h), max(worst_m, mn)
            rec["vs_single_hist"], rec["vs_single_min"] = worst_h, worst_m
            if name == "hybrid_lsqr_batched":
                lam_vec = torch.full((R,), LAM, dtype=torch.float32,
                                     device=P.device)
                rv, _ = gkb_counted(name, P.A_op, b8, P.x_true, MAXIT,
                                    label + " (R,) lam", lam=lam_vec)
                same = all(torch.equal(getattr(rv, f), getattr(r, f))
                           for f in ("x", "res_hist", "err_hist"))
                check(same, f"{label}: an (R,) lam of equal entries differs "
                      "from the scalar call")
                rec["vector_lam_equals_scalar"] = same
            # what the repeatable K3/K4 buy: a resumed solve is the
            # uninterrupted one, bit for bit
            part, _ = gkb_counted(name, P.A_op, b8, P.x_true, 40,
                                  label + " maxit=40")
            resumed, _ = gkb_counted(name, P.A_op, b8, P.x_true, MAXIT,
                                     label + " resumed",
                                     resume_from=part.state)
            fields = ("x", "res_hist", "err_hist") + (
                ("ar_hist",) if r.ar_hist is not None else ())
            same = all(torch.equal(getattr(resumed, f), getattr(r, f))
                       for f in fields)
            check(same, f"{label}: resume 40 -> {MAXIT} differs from the "
                  "uninterrupted run")
            rec["resume_equals_uninterrupted"] = same
        rec.update(gkb_timed(name, P.A_op, b8, P.x_true, MAXIT))
        fnb, kwb = gkb_solver(name)
        run = partial(fnb, P.A_op, b8, P.x_true, tol=0.0, maxit=MAXIT,
                      **kwb)
        rec["window_vs_gathers"] = in_turns(
            f"{label}: window kernel vs gathers",
            {"rule": run, "gathers": gathers_only(run)})
        say("gkb_serving_path", **rec)
        out[name] = launched + window
    return out


def phase_small_reference():
    """CT n=16, 10 steps: the solves on the card (the redesigned K1; the
    redesigned K2 at R=4, in-loop and deferred; the seven GKB solvers
    through the redesigned K1-K4, forward panels only, without and with
    ``reorth=True``: the stored bases and their gemv/bmm purification)
    against the same solves on the CPU (plain versions).
    Tolerance 1e-4 for the GMRES solves: both run in float32 with different
    summation orders (cuBLAS and the kernels vs the CPU), and ten Krylov
    steps amplify last-bit differences by at most ~10x here.  The GKB
    solves run 6 steps at 1e-3: their short recurrences have no
    reorthogonalization to damp the differences, which grow fast from the
    semi-convergence minimum on."""
    import torch

    def gkb(name, P, b, **extra):
        fn, kw = gkb_solver(name)
        return lambda: fn(P.A_op, b, P.x_true, tol=0.0, maxit=6, **kw,
                          **extra)

    got = {}
    for dev in ("cuda", "cpu"):
        P = make_problem(16, device=dev)
        b4 = torch.as_tensor(noisy_sinograms(P, range(4)), device=dev)
        runs = {}
        for name, fn in (
                ("single", lambda: solve(P, maxit=10)),
                ("batched", lambda: solve_batched(P, b4, False, maxit=10)),
                ("deferred", lambda: solve_batched(P, b4, True, maxit=10)),
                *((name, gkb(name, P, P.b)) for name in GKB_SINGLE),
                *((name, gkb(name, P, b4)) for name in GKB_BATCHED),
                *((name + REORTH, gkb(name, P, P.b, reorth=True))
                  for name in GKB_SINGLE),
                *((name + REORTH, gkb(name, P, b4, reorth=True))
                  for name in GKB_BATCHED)):
            reset_counts()
            runs[name] = (fn(), counts())
        got[dev] = runs
    expected = {"single": (0, 0, 0, 0, 21, 0, 0, 0, 0),
                "batched": (0, 0, 0, 0, 0, 0, 21, 0, 0),
                "deferred": (0, 0, 0, 0, 0, 0, 21, 0, 0)}
    for name in GKB_SINGLE + GKB_BATCHED:
        fwd, tr = gkb_launches(name, 6)
        expected[name] = expected[name + REORTH] = (0, 0, 0, 0) + (
            (0, 0, fwd, tr, 0) if "batched" in name else (fwd, tr, 0, 0, 0))
    worst = {}
    for name, want in expected.items():
        (rc, launches_cuda), (rh, launches_cpu) = got["cuda"][name], \
            got["cpu"][name]
        check(launches_cuda == want and not any(launches_cpu),
              f"small reference {name}: {LAUNCHES} launches cuda="
              f"{launches_cuda} cpu={launches_cpu}, expected {want} and "
              "zeros")
        worst[name] = 0.0
        tol = 1e-4 if name in ("single", "batched", "deferred") else 1e-3
        for field in ("res_hist", "err_hist", "x"):
            a = getattr(rc, field).cpu().to(torch.float64)
            h = getattr(rh, field).to(torch.float64)
            d = float((a - h).abs().max() / h.abs().max())
            check(d <= tol, f"small reference {name}: {field} card vs CPU "
                  f"{d:.3e}")
            worst[name] = max(worst[name], d)
    say("small_reference", n=16, maxit=10, gkb_maxit=6, R=4,
        max_rel_diff=worst)


# The multi-RHS products of the lambda-choice path, as (caller, R, layout):
# AB-RTP's A Q (maxit columns of the masked column-major basis, every
# step), BA's original-space GCV numerator A Q_k (k_gcv columns of the
# basis) and the discrepancy principle's candidate residuals A X (a
# row-major block of the grid size; B X first for "ab").
LAMBDA_MM = (("AB-RTP A Q", MAXIT, "basis"), ("GCV A Q_k", 20, "basis"),
             ("discrepancy A X", 80, "block"))
# The plain multi-RHS version gathers a float64 copy of every nonzero's
# input row: at n=128 and R=100 that is 20 GB, so it runs on chunks of
# columns (column j of it is independent of the others, bit for bit).
PLAIN_CHUNK = 10


def plain_in_chunks(plain, rp, X, *args):
    import torch

    return torch.cat([plain(rp, X[:, j:j + PLAIN_CHUNK], *args)
                      for j in range(0, X.shape[1], PLAIN_CHUNK)], dim=1)


def lambda_mm_inputs(n, R, layout, rng, device):
    """An (n, R) float32 input in the layout its caller hands K2r: the
    first R columns of a column-major basis (the transposed view of an
    (R+1, n) tensor) or a row-major block."""
    import torch

    V = torch.as_tensor(rng.standard_normal((R + 1, n)), dtype=torch.float32,
                        device=device)
    return V.T[:, :R] if layout == "basis" else V[:R].T.contiguous()


def csr64_on_card(q):
    """A float64 scipy CSR matrix as a float64 ``torch.sparse`` CSR tensor
    on the card: the product on the values a form holds (:func:`form_csr`),
    independent of the kernels."""
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(q.indptr.astype(np.int64), device="cuda"),
        torch.as_tensor(q.indices.astype(np.int64), device="cuda"),
        torch.as_tensor(q.data, device="cuda"), size=q.shape)


def tile_forms(op, label):
    """``op``'s tile form (K2w's), built here at first use: its seconds on
    the host and the card, and its bytes (also a ``memory`` line)."""
    import torch

    t0 = time.perf_counter()
    tp = op.fwd_tiles
    torch.cuda.synchronize()
    info = dict(build_s=time.perf_counter() - t0, tile_mb=tp.nbytes / 1e6,
                rows_mb=op.fwd_rows.nbytes / 1e6, tiles=tp.tiles,
                entries=int(tp.ent.numel()), panels=tp.panels, fill=tp.fill)
    MEMORY[f"{label} tile form"] = info
    say("memory", path=f"{label} tile form", **info)
    return tp, info


# AB-RTP's basis masked past this step (K2w skips a thread block whose
# columns are all zero; at R=100, 51 leaves the columns of one thread block
# partly zero, computed, and those of another wholly zero, skipped)
MASKED_K = 51
# X for the check of K2w's row bound: each entry of a Gaussian column
# scaled by 2^-u, u uniform in [0, SPREAD_BITS): most entries far below
# their column's largest, where K2w keeps fewer bits than float32
SPREAD_BITS = 30
SPREAD_R = 20


def row_bound_check(tp, rp, q, exact_op, scale, label, rng):
    """K2w (``wide_matmat``) on an X whose columns span 2^SPREAD_BITS,
    held row by row to its bound (``csrc/tile_spmm.cu``): the rounding of
    X to the grid 2^(E-30) of its column, ``|s_i| sum_j |q_ij|
    2^(E_r-31)``, plus the roundings to float32 of the result (one) and, with
    segments, of each segment's sum and of their sum, each at most
    2^-24 ``|s_i| sum_j |q_ij x_jr|``.  K2r (float32 per entry, not held
    to it) beside it.  Returns the record."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        _wide_grid, row_matmat, wide_matmat)

    n = tp.shape[1]
    V = rng.standard_normal((SPREAD_R + 1, n)) * np.exp2(
        -SPREAD_BITS * rng.random((SPREAD_R + 1, n)))
    X = torch.as_tensor(V, dtype=torch.float32, device="cuda").T[:, :SPREAD_R]
    got = wide_matmat(tp, X, scale).double()
    k2r = row_matmat(rp, X, scale).double()
    X64 = X.double()
    exact = exact_op @ X64
    absq = csr64_on_card(abs(q))
    absdot = absq @ X64.abs()
    E = torch.floor(torch.log2(X64.abs().amax(0)))
    nseg = _wide_grid(tp, SPREAD_R)[1]
    roundings = 1 if nseg == 1 else 2 * nseg
    bound = (absq @ torch.ones((n, 1), dtype=torch.float64, device="cuda")
             ) * torch.exp2(E - 31)[None, :] + roundings * 2.0 ** -24 * absdot
    err = (got - exact).abs()
    safe = torch.where(bound > 0, bound, 1.0)
    ratio = float((err / safe).max())
    check(bool((err <= bound * (1 + 1e-6)).all()), f"{label}: K2w outside "
          f"its row bound on X spread over 2^{SPREAD_BITS} (worst "
          f"{ratio:.3f} of it)")
    return dict(spread_bits=SPREAD_BITS, R=SPREAD_R, segments=nseg,
                worst_share_of_row_bound=ratio,
                k2r_worst_share_of_row_bound=float(
                    ((k2r - exact).abs() / safe).max()),
                rel_err=rel_err(got, exact), k2r_rel_err=rel_err(k2r, exact))


def lambda_mm_kernels(P, variant="int8"):
    """K2 at the R and in the layouts of the lambda-choice path
    (``LAMBDA_MM``) on the ``variant`` (int8 or int4) form of A, and at the
    discrepancy's R on the form of B: one launch through ``op.matmat``,
    counted, on the kernel the routing rule names (``takes_tiles``: K2w
    where the work is large, else K2r).  K2w (``wide_matmat`` on the tile
    form, built here) at every shape against its plain version (in column
    chunks, KERNEL_RTOL) and the library call (LIBRARY_RTOL), and against
    the float64 product on the values the row form holds: at most
    K2W_ERR_RATIO times the error of ``row_matmat`` (K2r) on the same input
    against the same product: the check that replaces, at the routed
    shapes, the one of each column against K1r bit for bit (K2w's columns
    are K1r's within the rounding of X, not bit for bit; K2r's are still
    checked at R <= 12 in phase 3's ``mm_sweep``).  Timed in turns beside
    K2r and the library call, against the float32 bound and the
    tensor-core bound of the same work; where routed, faster than both.
    On each form also K2w's row bound on a widely spread X
    (:func:`row_bound_check`) and the sweep (:func:`k2w_sweep`).  Returns
    the records and the sweep's."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        _wide_grid, row_matmat, takes_tiles, wide_matmat, wide_matmat_plain)

    rng = np.random.default_rng(3)
    recs, sweep = [], []
    for tag, op, cases in (("A", P.A_op, LAMBDA_MM),
                           ("B", P.B_op, LAMBDA_MM[2:])):
        m, n = op.shape
        rp, scale = op.fwd_rows, op.fwd_scale
        q = form_csr(rp, scale)
        lib, exact_op = library_of(q), csr64_on_card(q)
        tp, forms = tile_forms(op, f"n={P.n} {tag} {variant}")
        bound_rec = row_bound_check(tp, rp, q, exact_op, scale,
                                    f"n={P.n} {tag} {variant}", rng)
        for caller, R, layout in cases:
            label = f"n={P.n} {tag} {variant}: K2 at R={R} ({caller})"
            X = lambda_mm_inputs(n, R, layout, rng, op.device)
            Xc = X.contiguous()
            routed = takes_tiles(rp, R, X.device)
            reset_counts()
            got_op = op.matmat(X)
            torch.cuda.synchronize()
            launched = counts()
            check(launched == k1r_k2r(0, (1, op, R)), f"{label}: {LAUNCHES} "
                  f"launches {launched} in one op.matmat")
            got = wide_matmat(tp, X, scale)
            want = plain_in_chunks(wide_matmat_plain, tp, X, scale)
            k2r = row_matmat(rp, X, scale)
            exact = exact_op @ X.double()
            torch.cuda.synchronize()
            check(torch.equal(got_op, got if routed else k2r),
                  f"{label}: op.matmat is not the routed kernel's product")
            check(got.shape == want.shape == (m, R) and
                  bool(torch.isfinite(got).all()),
                  f"{label}: output not finite or misshaped")
            check(got.stride() == k2r.stride(), f"{label}: layout "
                  f"{got.stride()}, K2r's {k2r.stride()}")
            err = rel_err(got, want)
            check(err <= KERNEL_RTOL, f"{label}: K2w vs plain {err:.3e}")
            lib_diff = rel_err(lib @ Xc, got)
            check(lib_diff <= LIBRARY_RTOL, f"{label}: K2w vs library "
                  f"{lib_diff:.3e}")
            e_w, e_r = rel_err(got, exact), rel_err(k2r, exact)
            check(e_w <= K2W_ERR_RATIO * e_r, f"{label}: K2w's error "
                  f"{e_w:.3e} to the float64 product, K2r's {e_r:.3e}")
            run_w = partial(wide_matmat, tp, X, scale)
            run_r = partial(row_matmat, rp, X, scale)
            run_p = partial(plain_in_chunks, wide_matmat_plain, tp, X, scale)

            def run_l():
                return lib @ Xc

            # in turns; the plain version takes up to a second: timed once
            w1, r1, l1 = time_ms(run_w), time_ms(run_r), time_ms(run_l)
            p1 = time_ms(run_p, 1)
            l2, r2, w2 = time_ms(run_l), time_ms(run_r), time_ms(run_w)
            ms, row_ms, lib_ms = (w1 + w2) / 2, (r1 + r2) / 2, (l1 + l2) / 2
            if routed:
                check(ms < row_ms and ms < lib_ms, f"{label}: routed to K2w "
                      f"at {ms * 1e3:.1f} us, K2r {row_ms * 1e3:.1f}, the "
                      f"library {lib_ms * 1e3:.1f}")
            masked = None
            if caller == LAMBDA_MM[0][0]:
                # AB-RTP's masked basis at step MASKED_K: K2w skips the
                # blocks of zero columns past it (the same bits)
                Xm = X * (torch.arange(R, device=X.device)
                          < MASKED_K).to(X.dtype)[None, :]
                got_m = wide_matmat(tp, Xm, scale)
                want_m = plain_in_chunks(wide_matmat_plain, tp, Xm, scale)
                err_m = rel_err(got_m, want_m)
                check(err_m <= KERNEL_RTOL and
                      not bool(got_m[:, MASKED_K:].any()), f"{label}: K2w "
                      f"on the basis masked at {MASKED_K} vs plain "
                      f"{err_m:.3e}, or a masked column not zero")
                masked = dict(k=MASKED_K, max_rel_err=err_m, ms=time_ms(
                    partial(wide_matmat, tp, Xm, scale)))
            work = row_work(rp, m, R)
            b_ms, b_by = bound([work])
            tc_ms, tc_by = tc_bound([work])
            rec = dict(
                panel=f"n={P.n} {tag} {variant} tile form", caller=caller,
                R=R, layout=("column-major basis" if layout == "basis"
                             else "row-major block"), shape=list(op.shape),
                routed_to="K2w" if routed else "K2r", live=rp.live,
                work_entries_x_columns=rp.live * R, ms=ms, plain_ms=p1,
                row_matmat_ms=row_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / ms, tc_bound_ms=tc_ms,
                tc_bound_by=tc_by, share_of_tc_bound=tc_ms / ms, work=work,
                faster_than_k2r=ms < row_ms, faster_than_library=ms < lib_ms,
                grid=list(_wide_grid(tp, R)), launches=launched,
                max_abs_err=float((got - want).abs().max()),
                max_rel_err=err, f64_rel_err=e_w, row_matmat_f64_rel_err=e_r,
                f64_err_ratio=e_w / e_r, library_max_rel_diff=lib_diff,
                row_bound=bound_rec, masked_basis=masked, **forms)
            say("kernel_vs_plain", kernel=f"K2w {variant}", **rec)
            recs.append(rec)
        sweep += k2w_sweep(f"n={P.n} {tag} {variant}", op, lib)
        del lib, exact_op
        torch.cuda.empty_cache()
    return recs, sweep


# The sweep of K2w beside K2r and the library call: the routing rule
# (ops/spmv_cuda.py:takes_tiles, R_WIDE and WIDE_WORK) is chosen from it,
# and its R=8 row is the yardstick of a later redesign of the serving
# products.
SWEEP_R = (8, 12, 16, 20, 32, 64, 80, 100, 128)


def k2w_sweep(panel, op, lib):
    """K2w (``wide_matmat``, at every R, whatever the routing) beside K2r
    (``row_matmat``, its default gather) and the library call ``lib`` on
    the forward form of ``op`` at SWEEP_R, in the basis' layout (the
    transposed view of a column-major basis, as AB-RTP and GCV hand it),
    timed in turns (K2w, K2r, library, library, K2r, K2w), against both
    bounds.  Every shape the rule routes to K2w is faster there than on K2r
    (checked).  Returns the records."""
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        _wide_grid, row_matmat, takes_tiles, wide_matmat)

    rng = np.random.default_rng(4)
    recs = []
    m, n = op.shape
    rp, scale, tp = op.fwd_rows, op.fwd_scale, op.fwd_tiles
    for R in SWEEP_R:
        label = f"{panel} R={R}"
        X = lambda_mm_inputs(n, R, "basis", rng, op.device)
        Xc = X.contiguous()
        run_w = partial(wide_matmat, tp, X, scale)
        run_r = partial(row_matmat, rp, X, scale)

        def run_l():
            return lib @ Xc

        d = rel_err(run_w(), run_r())
        check(d <= LIBRARY_RTOL, f"{label}: K2w against K2r {d:.3e}")
        w1, r1, l1 = (time_ms(f, 10) for f in (run_w, run_r, run_l))
        l2, r2, w2 = (time_ms(f, 10) for f in (run_l, run_r, run_w))
        k2w_ms, k2r_ms = (w1 + w2) / 2, (r1 + r2) / 2
        routed = takes_tiles(rp, R, X.device)
        check(not routed or k2w_ms < k2r_ms, f"{label}: routed to K2w at "
              f"{k2w_ms * 1e3:.1f} us, K2r {k2r_ms * 1e3:.1f}")
        work = row_work(rp, m, R)
        b_ms, b_by = bound([work])
        tc_ms, tc_by = tc_bound([work])
        recs.append(dict(
            panel=panel, R=R, routed=routed,
            work_entries_x_columns=rp.live * R, k2w_ms=k2w_ms,
            k2r_ms=k2r_ms, library_ms=(l1 + l2) / 2, bound_ms=b_ms,
            bound_by=b_by, tc_bound_ms=tc_ms, tc_bound_by=tc_by,
            grid=list(_wide_grid(tp, R)), k2w_vs_k2r=d))
    say("k2w_sweep", panel=panel, records=recs)
    return recs


RTP_SOLVERS = ("ba_gmres_rtp", "ab_gmres_rtp")
# Each RTP solver's min-over-k error against its own float64 host reference
# (bench.py has no RTP anchor), as for the GKB solvers.  At n=128 the
# reference runs RTP_REF_STEPS steps (each step's solve does not depend on
# the budget; the minimum lies at k = 6-7 and the history band is REF_K):
# a host product of A takes ~8x longer there.
RTP_BAND = 1.01
RTP_REF_STEPS = 25
# bf16 storage of the bases and images against the float32 run: the band
# of the JAX package's own test (tests/test_gmres_api.py:275, rtol and atol).
BF16_BAND = 5e-3
# history=False against the final x of the history run: the same
# factorization and solve at k = maxit, in float32.
NO_HISTORY_RTOL = 1e-5
# A Brent-selected lambda against the float64 host run of the same call.
BRENT_RTOL = 1e-3
# The single-RHS resume: a solve of this budget continued to MAXIT.
RESUME_AT = 40


def rtp_solver(name):
    import importlib

    return getattr(importlib.import_module(
        "hybrid_gmres_tpu_torch.solvers.rtp"), name)


def rtp_launches(name, maxit):
    """(K1r, K2) launches of one RTP solve, worked out from the code:
    r0 = B b, then per step the shifted operator B (A q) + lam q (two K1r)
    and the true residual A x_k (one); AB-RTP adds one K2 of ``maxit``
    columns per step, A Q on the masked basis (:func:`k1r_k2r` names the
    kernel)."""
    return 3 * maxit + 1, (maxit if name.startswith("ab") else 0)


def host_operators(P, transposed=False):
    """The float64 host operators of A and B (scipy CSR), made once.
    ``transposed``: B quantized per row of B^T, as the sharded solvers'
    transposed layout holds it, instead of per pixel."""
    if getattr(P, "host_A", None) is None:
        P.host_A = scipy_operator(P.A_csr)
    if transposed:
        if getattr(P, "host_BT", None) is None:
            P.host_BT = scipy_operator(P.B_csr.T.tocsr()).T
        return P.host_A, P.host_BT
    if getattr(P, "host_B", None) is None:
        P.host_B = scipy_operator(P.B_csr)
    return P.host_A, P.host_B


def column_cache(op):
    """``op`` whose ``matmat`` computes only the columns it has not seen
    (exactly: a column equal to the one it saw at that position is read
    from the cache; a zero column is zero).  AB-RTP's masked ``A Q`` at
    step k differs from step k-1's in column k only: with this the host
    reference makes one product per step, not ``maxit``."""
    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator

    class ColumnCache(LinearOperator):
        dtype, device, shape = op.dtype, op.device, op.shape

        def __init__(self):
            self.seen, self.images = [], []

        def matvec(self, v):
            return op.matvec(v)

        def matmat(self, X):
            cols = []
            for j in range(X.shape[1]):
                x = X[:, j]
                if not bool(x.any()):
                    cols.append(torch.zeros(op.shape[0], dtype=X.dtype))
                    continue
                if j < len(self.seen) and torch.equal(self.seen[j], x):
                    cols.append(self.images[j])
                    continue
                y = op.matvec(x.contiguous())
                del self.seen[j:], self.images[j:]
                self.seen.append(x.clone())
                self.images.append(y)
                cols.append(y)
            return torch.stack(cols, dim=1)

    return ColumnCache()


def host_reference_rtp(P, name, steps=MAXIT, transposed=False):
    """RTP solver ``name`` of the port in float64 on the host, ``steps``
    steps, with the scipy operators of A and B (AB-RTP's through
    :func:`column_cache`; ``transposed`` as in :func:`host_operators`).
    Returns the error history."""
    import torch

    A, B = host_operators(P, transposed)
    if name.startswith("ab"):
        A = column_cache(A)
    r = rtp_solver(name)(A, B, torch.from_numpy(P.b_host.astype(np.float64)),
                         torch.from_numpy(P.prob.x_true[P.pix_perm]),
                         tol=0.0, maxit=steps, lam=LAM)
    return r.err_hist.numpy()


def counted(run, want, label):
    """``run()`` with the launch counts reset before and read after, checked
    against ``want`` (an 8-tuple); returns (result, the launches)."""
    import torch

    reset_counts()
    r = run()
    torch.cuda.synchronize()
    launched = counts()
    check(launched == want, f"{label}: {LAUNCHES} launches {launched}, "
          f"expected {want}")
    return r, launched


def k1r_k2r(k1, *products):
    """The launches of a path of ``k1`` K1r and the forward multi-RHS
    products ``(count, operator, R)``: each on K2w or K2r as the routing
    rule names it for that operator's form (``ops/spmv_cuda.py:
    takes_tiles``)."""
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import takes_tiles

    wide = sum(c for c, op, R in products
               if takes_tiles(op.fwd_rows, R, op.device))
    return (0, 0, 0, 0, k1, 0, sum(c for c, _, _ in products) - wide, 0,
            wide)


def finite_result(r, label, nx):
    import torch

    check(tuple(r.x.shape) == (nx,) and bool(torch.isfinite(r.x).all()),
          f"{label}: bad solution")
    k = int(r.niters)
    check(bool(torch.isfinite(r.err_hist[:k]).all() and
               torch.isfinite(r.res_hist[:k]).all()),
          f"{label}: non-finite history entries")


def phase_rtp(P, ptr_min, full):
    """BA- and AB-RTP (maxit=100, lam=1e-2, tol=0) on the CT operators:
    launch counts from the code, niters, the min-over-k error against the
    same solver in float64 on the host (gate: that reference's minimum x
    RTP_BAND; history over the first REF_K steps; the reference runs all
    maxit steps with ``full``, else RTP_REF_STEPS), it/s from 5 solves,
    printed beside the PTR solve's minimum.  With ``full``: AB-RTP again
    with the caller's ``allow_tf32 = True`` (the flag reads True afterwards,
    the history stays in the float64 band) and the Gram of its final basis
    with TF32 on and in full float32 against float64.  Returns
    ``{name: launches}``."""
    import torch

    from hybrid_gmres_tpu_torch.utils.device import full_float32_matmul

    n, out = P.n, {}
    for name in RTP_SOLVERS:
        label = f"n={n} {name}"
        run = partial(rtp_solver(name), P.A_op, P.B_op, P.b, P.x_true,
                      tol=0.0, maxit=MAXIT, lam=LAM)
        with HostSyncs() as syncs:
            k1, k2 = rtp_launches(name, MAXIT)
            r, launched = counted(run, k1r_k2r(k1, (k2, P.A_op, MAXIT)),
                                  label)
        check(int(r.niters) == MAXIT, f"{label}: niters {int(r.niters)}")
        finite_result(r, label, P.A_op.shape[1])
        err = r.err_hist.cpu().numpy()
        t0 = time.perf_counter()
        steps = MAXIT if full else RTP_REF_STEPS
        err_ref = host_reference_rtp(P, name, steps)
        ref_s = time.perf_counter() - t0
        check(int(err_ref.argmin()) < steps - 1, f"{label}: the float64 "
              f"reference's minimum lies at its last step ({steps})")
        gate = float(err_ref.min()) * RTP_BAND
        check(float(err.min()) <= gate, f"{label}: min-over-k rel err "
              f"{err.min():.4f} > gate {gate:.4f}")
        hist, at_min = held_to(err, err_ref, label, "float64 host reference")
        ms = per_call_ms(run, reps=5)
        med = float(np.median(ms))
        rec = dict(n=n, solver=name, maxit=MAXIT, lam=LAM,
                   launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=launched,
                   host_syncs=syncs.count, min_err=float(err.min()),
                   min_err_k=int(err.argmin()) + 1,
                   final_err=float(err[-1]), ptr_min_err=ptr_min,
                   gate=gate, f64_ref_min_err=float(err_ref.min()),
                   f64_ref_min_rel_diff=at_min, f64_ref_hist_rel_diff=hist,
                   f64_ref_steps=steps, f64_ref_s=ref_s, solve_ms_median=med,
                   solve_ms_min=min(ms), solve_ms_max=max(ms),
                   iters_per_s=MAXIT / (med / 1e3))
        if full and name == "ab_gmres_rtp":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                r_t = run()
                flag = torch.backends.cuda.matmul.allow_tf32
                AQ = P.A_op.matmat(r.Q[:, :MAXIT])
                G_tf32 = AQ.T @ AQ
                with full_float32_matmul():
                    G_full = AQ.T @ AQ
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            check(flag is True, f"{label}: the caller's allow_tf32 = True "
                  f"reads {flag} after the solve")
            err_t = r_t.err_hist.cpu().numpy()
            h_t, m_t = held_to(err_t, err_ref, label + " with TF32 on",
                               "float64 host reference")
            G64 = AQ.double().T @ AQ.double()
            rec["tf32_on"] = dict(
                flag_after=flag, min_err=float(err_t.min()),
                f64_ref_hist_rel_diff=h_t, f64_ref_min_rel_diff=m_t,
                max_diff_vs_tf32_off=float(np.max(np.abs(err_t - err))),
                gram_rel_err_tf32=rel_err(G_tf32.double(), G64),
                gram_rel_err_full_float32=rel_err(G_full.double(), G64))
        say("rtp_path", **rec)
        out[name] = launched
    return out


def ptr_solver(name):
    from hybrid_gmres_tpu_torch.solvers import gmres

    return getattr(gmres, name)


def ptr_launches(name, maxit):
    """K1r launches of one fused PTR solve from x0 = 0, worked out from the
    code: two per step; BA adds r0 = B b, which a resumed BA solve also
    makes (the checkpoint holds the factorization, not r0's image), so a
    resume costs one more K1r than the uninterrupted run."""
    return 2 * maxit + (1 if name == "ba_gmres" else 0)


def phase_gmres_options(P, tf32):
    """The last branches of ``gmres_core`` on the card, BA and AB fused
    (lam=1e-2, tol=0): a resume 40 -> 100 bit-equal to the uninterrupted
    run, with the launches of the two calls against the uninterrupted one's;
    ``basis_dtype=bfloat16`` (dtypes, the history within BF16_BAND of the
    float32 run, the gate); ``history=False`` (x against the history run's
    final x, 2 maxit + 2 launches); with ``tf32`` also a deferred BA solve
    with the caller's ``allow_tf32 = True`` against the TF32-off run.
    Returns a record."""
    import torch

    n, out = P.n, {}
    nx = P.A_op.shape[1]
    for name in ("ba_gmres", "ab_gmres"):
        label = f"n={n} {name}"
        fn = ptr_solver(name)

        def run(maxit=MAXIT, **kw):
            return fn(P.A_op, P.B_op, P.b, P.x_true, tol=0.0, maxit=maxit,
                      lam=LAM, **{"residual": "fused", **kw})

        full, l_full = counted(run, k1r_k2r(ptr_launches(name, MAXIT)),
                               label)
        finite_result(full, label, nx)
        err = full.err_hist.cpu().numpy()
        part, l_part = counted(partial(run, RESUME_AT),
                               k1r_k2r(ptr_launches(name, RESUME_AT)),
                               label + f" maxit={RESUME_AT}")
        extra = 1 if name == "ba_gmres" else 0
        resumed, l_res = counted(
            partial(run, resume_from=part),
            k1r_k2r(2 * (MAXIT - RESUME_AT) + extra), label + " resumed")
        diffs = {f: float((getattr(resumed, f).float()
                           - getattr(full, f).float()).abs().nan_to_num()
                          .max())
                 for f in ("x", "res_hist", "err_hist", "H", "Q", "IMG")}
        same = all(torch.equal(getattr(resumed, f), getattr(full, f))
                   for f in ("x", "res_hist", "err_hist", "H", "Q", "IMG",
                             "niters", "active")) and (
            full.S is None or torch.equal(resumed.S, full.S))
        check(same, f"{label}: resume {RESUME_AT} -> {MAXIT} differs from "
              f"the uninterrupted run: {diffs}")
        check(l_part[4] + l_res[4] == l_full[4] + extra, f"{label}: "
              f"launches {l_part[4]} + {l_res[4]} against {l_full[4]}")

        rbf, l_bf = counted(partial(run, basis_dtype=torch.bfloat16),
                            k1r_k2r(ptr_launches(name, MAXIT)),
                            label + " bf16 basis")
        bf16 = torch.bfloat16
        check(rbf.Q.dtype == rbf.IMG.dtype == bf16 and
              (rbf.S is None or rbf.S.dtype == bf16) and
              rbf.x.dtype == torch.float32,
              f"{label} bf16 basis: dtypes {rbf.Q.dtype}, {rbf.IMG.dtype}")
        finite_result(rbf, label + " bf16 basis", nx)
        err_bf = rbf.err_hist.cpu().numpy()
        res, res_bf = full.res_hist.cpu().numpy(), rbf.res_hist.cpu().numpy()
        band = float(np.max(np.abs(res_bf - res) / (BF16_BAND + BF16_BAND
                                                     * np.abs(res))))
        check(band <= 1.0, f"{label} bf16 basis: residual history outside "
              f"the {BF16_BAND} band of the float32 run ({band:.2f} of it)")
        check(float(err_bf.min()) <= GATES[n], f"{label} bf16 basis: "
              f"min-over-k rel err {err_bf.min():.4f} > gate {GATES[n]:.4f}")

        rnh, l_nh = counted(partial(run, history=False, residual="true"),
                            k1r_k2r(2 * MAXIT + 2), label + " history=False")
        x_gap = rel_err(rnh.x, full.x)
        check(x_gap <= NO_HISTORY_RTOL, f"{label} history=False: x vs the "
              f"history run's final x {x_gap:.2e}")
        check(int(rnh.niters) == MAXIT and
              int(torch.isfinite(rnh.res_hist).sum()) == 1,
              f"{label} history=False: niters {int(rnh.niters)}, recorded "
              "entries")
        out[name] = dict(
            launches_full=l_full[4], launches_part=l_part[4],
            launches_resumed=l_res[4], resume_equals_uninterrupted=same,
            min_err=float(err.min()), min_err_k=int(err.argmin()) + 1,
            bf16_min_err=float(err_bf.min()),
            bf16_res_hist_max_rel_diff=float(np.max(np.abs(res_bf - res)
                                                    / res)),
            bf16_err_hist_max_rel_diff=float(np.max(np.abs(err_bf - err)
                                                    / err)),
            bf16_launches=l_bf[4], history_false_launches=l_nh[4],
            history_false_x_rel_diff=x_gap)
    if tf32:
        label = f"n={n} ba_gmres deferred"

        def deferred():
            return ptr_solver("ba_gmres")(
                P.A_op, P.B_op, P.b, P.x_true, tol=0.0, maxit=MAXIT,
                lam=LAM, residual="fused", defer_histories=True)

        off = deferred()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            on = deferred()
            flag = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        check(flag is True, f"{label}: the caller's allow_tf32 = True reads "
              f"{flag} after the solve")
        gaps = {}
        for f in ("err_hist", "res_hist"):
            a, d = getattr(off, f).cpu().numpy(), getattr(on, f).cpu().numpy()
            gaps[f] = max(float(np.max(np.abs(d[:REF_K] - a[:REF_K])
                                       / a[:REF_K])),
                          abs(float(d.min() - a.min())) / float(a.min()))
            check(gaps[f] <= DEFER_RTOL, f"{label}: TF32 on vs off {f} "
                  f"{gaps[f]:.2e}")
        out["deferred_tf32_on"] = dict(
            flag_after=flag, vs_tf32_off=gaps,
            max_abs_diff=float((on.err_hist - off.err_hist).abs().max()))
    say("gmres_options", n=n, maxit=MAXIT, lam=LAM, **out)
    return out


def phase_restarted(P):
    """``ba_gmres_restarted`` and ``ab_gmres_restarted`` (restart=20,
    max_restarts=5, lam=1e-2, fused): the joined history's length and
    niters, the gate, the launches from the code (BA: r0 = B b, then
    B (b - A x0) per later cycle: 2 + 40 launches a cycle but the first; AB:
    b - A x0 per later cycle)."""
    from hybrid_gmres_tpu_torch.solvers import gmres

    n, out = P.n, {}
    restart, cycles = 20, 5
    for name in ("ba_gmres_restarted", "ab_gmres_restarted"):
        label = f"n={n} {name}"
        first = 2 * restart + (1 if name.startswith("ba") else 0)
        want = first + (cycles - 1) * (2 * restart + 1 + (
            1 if name.startswith("ba") else 0))
        r, launched = counted(partial(
            getattr(gmres, name), P.A_op, P.B_op, P.b, P.x_true,
            restart=restart, max_restarts=cycles, lam=LAM,
            residual="fused"), k1r_k2r(want), label)
        err = r.err_hist.cpu().numpy()
        check(int(r.niters) == restart * cycles and
              err.shape == (restart * cycles,) and
              bool(np.isfinite(err).all()), f"{label}: niters "
              f"{int(r.niters)}, history {err.shape}")
        check(float(err.min()) <= GATES[n], f"{label}: min-over-k rel err "
              f"{err.min():.4f} > gate {GATES[n]:.4f}")
        out[name] = dict(launches=launched[4], niters=int(r.niters),
                         min_err=float(err.min()),
                         min_err_k=int(err.argmin()) + 1,
                         final_err=float(err[-1]))
    say("restarted", n=n, restart=restart, max_restarts=cycles, lam=LAM,
        gate=GATES[n], **out)


def grid_steps(grid, got, want):
    """How many steps of the log grid ``grid`` lie between two lambdas."""
    ratio = np.log(grid[1] / grid[0])
    return abs(float(np.log(float(got) / float(want)))) / ratio


def noise_norm(P):
    """||e||: the norm of the noise in the sinogram (seed 0)."""
    b_exact = P.prob.b_exact.astype(np.float32)[P.ray_perm]
    return float(np.linalg.norm(P.b_host.astype(np.float64) - b_exact))


# Where a selection differs from the float64 host call's, it must be as good
# by the float64 objective: the GCV value at the card's lambda within
# FLAT_RTOL of the value at the host's (the CT objectives are flat: BA's
# projected GCV varies by 1e-8 over [1e-3, 0.1] at n=64), the L-curve's
# float64 error within LCURVE_FLAT_RTOL.  The L-curve reads the error of
# the final iterate (k = 32), where float32 and float64 have drifted apart
# by up to 6.4e-3 (measured on CT n=64, AB) and the error curve over lambda
# is flatter than that.
FLAT_RTOL = 1e-6
LCURVE_FLAT_RTOL = 1e-2


def phase_lambda_choice(P, full):
    """The lambda selectors on the card against the same calls of the port
    in float64 on the host (the scipy operators of A and B): every grid
    method's lambda within one grid step and Brent's within BRENT_RTOL, or
    as good by the float64 objective (FLAT_RTOL, LCURVE_FLAT_RTOL); the
    launches from the code.  ``full``: ``gcv_lambda`` "ba" in both residual
    spaces, ``gcv_curve`` and ``gcv_surface`` "ba" (k = 1..20, 30
    lambdas), ``discrepancy_lambda`` "ab" and "ba" (delta = the noise norm,
    tau = 1.02, 80 lambdas) and ``lcurve_sweep`` "ab" and "ba" (8 lambdas,
    maxit=32); else ``gcv_lambda("ba", residual_space="original")`` and
    ``discrepancy_lambda("ba")``."""
    import torch

    from hybrid_gmres_tpu_torch import reg

    n, k = P.n, 20
    A64, B64 = host_operators(P)
    b64 = torch.from_numpy(P.b_host.astype(np.float64))
    x64 = torch.from_numpy(P.prob.x_true[P.pix_perm])
    delta = noise_norm(P)
    out = dict(n=n, k_gcv=k, delta=delta, flat_rtol=FLAT_RTOL)
    arnoldi_ba = 2 * k + 1                  # r0 = B b, then A and B
    gcv_grid = np.logspace(-8, -1, 50)
    surf_grid = np.logspace(-8, -1, 30)
    disc_grid = np.logspace(-9, 0, 80)
    lc_grid = np.logspace(-10, 0, 8)

    def brent(space):
        return lambda A, B, b, x: reg.gcv_lambda(
            "ba", A, B, b, k_gcv=k, residual_space=space)[0]

    def objective(space, lams):
        """The float64 host objective at ``lams``."""
        return reg.gcv_curve("ba", A64, B64, b64, k, np.asarray(lams),
                             residual_space=space).numpy()

    # (label, kind, launches, call, grid, residual space)
    calls = [("gcv_lambda ba original", "brent",
              k1r_k2r(arnoldi_ba, (1, P.A_op, k)),
              brent("original"), None, "original"),
             ("discrepancy_lambda ba", "grid",
              k1r_k2r(arnoldi_ba, (1, P.A_op, len(disc_grid))),
              lambda A, B, b, x: reg.discrepancy_lambda(
                  "ba", A, B, b, delta, k=k, lam_grid=disc_grid)[0],
              disc_grid, None)]
    if full:
        calls += [
            ("gcv_lambda ba projected", "brent", k1r_k2r(arnoldi_ba),
             brent("projected"), None, "projected"),
            ("gcv_curve ba original", "curve",
             k1r_k2r(arnoldi_ba, (1, P.A_op, k)),
             lambda A, B, b, x: reg.gcv_curve(
                 "ba", A, B, b, k, gcv_grid, residual_space="original"),
             gcv_grid, "original"),
            ("gcv_surface ba", "surface", k1r_k2r(arnoldi_ba),
             lambda A, B, b, x: reg.gcv_surface(
                 "ba", A, B, b, range(1, k + 1), surf_grid)[0], surf_grid,
             "projected"),
            ("discrepancy_lambda ab", "grid",
             k1r_k2r(2 * k, (1, P.B_op, len(disc_grid)),
                     (1, P.A_op, len(disc_grid))),
             lambda A, B, b, x: reg.discrepancy_lambda(
                 "ab", A, B, b, delta, k=k, lam_grid=disc_grid)[0],
             disc_grid, None),
            # per lambda: r0 (BA), the residual="true" solve's 3 (BA) or 4
            # (AB) products a step, and the sweep's own A x
            ("lcurve_sweep ba", "lcurve", k1r_k2r(8 * (1 + 3 * 32 + 1)),
             lambda A, B, b, x: reg.lcurve_sweep(
                 "ba", A, B, b, x, lc_grid, maxit=32).err_norms,
             lc_grid, None),
            ("lcurve_sweep ab", "lcurve", k1r_k2r(8 * (4 * 32 + 1)),
             lambda A, B, b, x: reg.lcurve_sweep(
                 "ab", A, B, b, x, lc_grid, maxit=32).err_norms,
             lc_grid, None)]
    for label, kind, want, call, grid, space in calls:
        t0 = time.perf_counter()
        got, launched = counted(
            partial(call, P.A_op, P.B_op, P.b, P.x_true), want,
            f"n={n} {label}")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = call(A64, B64, b64, x64)
        host_s = time.perf_counter() - t0
        rec = dict(launches_k1r_k2r_k2w=(launched[4], launched[6],
                                         launched[8]),
                   card_s=card_s, host_f64_s=host_s)
        if kind == "brent":
            gap = abs(got - ref) / ref
            vals = objective(space, [got, ref])
            worse = float((vals[0] - vals[1]) / vals[1])
            check(gap <= BRENT_RTOL or worse <= FLAT_RTOL, f"n={n} {label}: "
                  f"lambda {got!r} vs {ref!r} in float64 on the host "
                  f"({gap:.2e}), float64 objective {worse:.2e} worse")
            rec.update(lam=got, lam_f64=ref, rel_diff=gap,
                       f64_objective_rel_excess=worse)
        elif kind == "grid":
            steps = grid_steps(grid, float(got), float(ref))
            check(steps <= 1.0 + 1e-6, f"n={n} {label}: lambda {float(got)} "
                  f"vs {float(ref)} in float64 ({steps:.2f} grid steps)")
            rec.update(lam=float(got), lam_f64=float(ref), grid_steps=steps)
        else:
            # argmin over the grid (per k for the surface), against the
            # float64 values of the host call
            # a NaN error is no optimum (as in lcurve_sweep)
            vals = np.nan_to_num(got.cpu().double().numpy(), nan=np.inf)
            ref_vals = ref.numpy()
            if vals.ndim == 1:
                vals, ref_vals = vals[:, None], ref_vals[:, None]
            i_card, i_host = vals.argmin(0), ref_vals.argmin(0)
            cols = np.arange(vals.shape[1])
            steps = np.abs(i_card - i_host)
            worse = (ref_vals[i_card, cols] - ref_vals[i_host, cols]) / \
                ref_vals[i_host, cols]
            flat = LCURVE_FLAT_RTOL if kind == "lcurve" else FLAT_RTOL
            bad = (steps > 1) & (worse > flat)
            check(not bad.any(), f"n={n} {label}: argmin {i_card.tolist()} "
                  f"vs {i_host.tolist()} in float64, float64 value "
                  f"{worse.tolist()} worse")
            finite = np.isfinite(vals)
            rec.update(lam=grid[i_card].tolist(),
                       lam_f64=grid[i_host].tolist(),
                       grid_steps=steps.tolist(),
                       f64_value_rel_excess=float(worse.max()),
                       not_finite=int((~finite).sum()),
                       values_max_rel_diff=float(np.max(
                           np.abs(vals - ref_vals)[finite]
                           / ref_vals[finite])))
        out[label] = rec
    say("lambda_choice", **out)


def results_json():
    """``figures/results.json``: the JAX package's record of its drivers
    (float64 CPU runs; ``phantom2d_tpu`` from a TPU)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "figures", "results.json")
    with open(path) as f:
        return json.load(f)


# figures/results.json: the JAX package's float64 runs of the drivers
RESULTS_JSON = {"ptr_rtp": ("ba_ptr", "ba_rtp", "ab_ptr", "ab_rtp"),
                "regularization": ("gcv_lambda_ab", "gcv_lambda_ba"),
                "gcv_surface": ("path_ab_last", "path_ba_last")}
DRIVER_RTOL = 1e-4


def as_good(grid, got, want, values, flat):
    """(grid steps between two selections, how much worse ``values`` (an
    array over ``grid``, the host's float64 objective) is at ``got`` than
    at ``want``); a selection passes within one step or ``flat``."""
    i, j = (int(np.argmin(np.abs(np.log(grid / v)))) for v in (got, want))
    steps = grid_steps(grid, got, want)
    worse = float((values[i] - values[j]) / values[j])
    check(steps <= 1.0 + 1e-6 or worse <= flat, f"{got!r} vs {want!r}: "
          f"{steps:.2f} grid steps, float64 objective {worse:.2e} worse")
    return steps, worse


def phase_drivers(device="cuda"):
    """The three experiment drivers of the lambda-choice path at their
    default configurations, on the card against the same driver on the
    CPU port (float32 both): the error histories over the first REF_K
    steps to DRIVER_RTOL; every selected lambda within one grid step, or
    as good by the CPU run's objective (LCURVE_FLAT_RTOL for the L-curve's
    error, FLAT_RTOL for the GCV surface, whose per-k path is held over
    the first REF_K k: past them the float32 factorizations of shaw drift
    apart, as the histories do); the values of ``figures/results.json``
    (the JAX package's float64 runs) printed beside them."""
    from hybrid_gmres_tpu_torch.experiments import (gcv_surface_exp,
                                                    ptr_rtp, regularization)
    from hybrid_gmres_tpu_torch.experiments.common import host as to_host

    results = results_json()
    out = {}
    for name, module in (("ptr_rtp", ptr_rtp),
                         ("regularization", regularization),
                         ("gcv_surface", gcv_surface_exp)):
        t0 = time.perf_counter()
        card = module.run(module.Config(device=device))
        card_s = time.perf_counter() - t0
        host = module.run(module.Config(device="cpu"))
        rec = dict(card_s=card_s, results_json={
            k: results[name][k] for k in RESULTS_JSON[name]})
        if name == "ptr_rtp":
            for k, h in host.err_hists.items():
                c = card.err_hists[k]
                gap = float(np.max(np.abs(c[:REF_K] - h[:REF_K]) / h[:REF_K]))
                check(c.shape == h.shape and gap <= DRIVER_RTOL,
                      f"driver ptr_rtp {k}: card vs CPU {gap:.2e}, lengths "
                      f"{c.shape} {h.shape}")
                rec[k] = dict(final_err=float(c[-1]),
                              final_err_cpu=float(h[-1]), hist_rel_diff=gap,
                              full_hist_rel_diff=float(
                                  np.max(np.abs(c - h) / h)))
            check(float(np.max(np.abs(card.err_hists["ba_ptr"]
                                      - card.err_hists["ba_rtp"]))) > 1e-3,
                  "driver ptr_rtp: PTR and RTP agree on the card")
        elif name == "regularization":
            cfg = host.cfg
            grid = np.logspace(np.log10(cfg.lam_lo), np.log10(cfg.lam_hi),
                               cfg.n_lambda)
            for v in ("ab", "ba"):
                c, h = card.gcv_lambdas[v], host.gcv_lambdas[v]
                steps = grid_steps(grid, c, h)
                check(steps <= 1.0 + 1e-6, f"driver regularization {v} "
                      f"gcv_lambda: {c!r} vs {h!r} on the CPU ({steps:.2f} "
                      "grid steps)")
                rec[f"gcv_lambda_{v}"] = dict(card=c, cpu=h,
                                              grid_steps=steps)
                c = float(card.sweeps[v].lam_true_opt)
                h = float(host.sweeps[v].lam_true_opt)
                steps, worse = as_good(grid, c, h,
                                       to_host(host.sweeps[v].err_norms),
                                       LCURVE_FLAT_RTOL)
                rec[f"lam_true_opt_{v}"] = dict(card=c, cpu=h,
                                                grid_steps=steps,
                                                cpu_err_rel_excess=worse)
        else:
            for v in ("ab", "ba"):
                steps = [grid_steps(card.lam_grid, c, h) for c, h in
                         zip(card.paths[v], host.paths[v])]
                excess = [as_good(card.lam_grid, c, h,
                                  host.surfaces[v][:, j], FLAT_RTOL)[1]
                          for j, (c, h) in enumerate(zip(
                              card.paths[v][:REF_K], host.paths[v][:REF_K]))]
                rec[f"path_{v}"] = dict(
                    last=float(card.paths[v][-1]),
                    last_cpu=float(host.paths[v][-1]),
                    max_grid_steps_first_k=max(steps[:REF_K]),
                    max_cpu_objective_rel_excess_first_k=max(excess),
                    max_grid_steps=max(steps))
        out[name] = rec
    say("drivers", **out)


# figures/results.json's phantom2d_tpu entry: the JAX package's run of the
# scenario on a TPU, printed beside the card's numbers for context only
TPU_RECORD = ("min_err", "batched_min_err_worst", "it_per_s")
# The seven dense drivers, each on the card and on the CPU port in float32.
# What float32 holds in them, as measured by running each driver on the CPU
# in float32 and in float64 (float32 rounding moves a quantity about as
# much as the card's other summation order does):
#   * the regularized histories (hybrid GMRES and LSMR, the hybrid
#     filter-factor runs, phantom2d's non-hybrid GMRES on the CT pair) over
#     the first REF_K steps to DRIVER_RTOL (float32 vs float64 <= 2.1e-5);
#   * the histories of unregularized GMRES on the 1-D problems and of the
#     GKB recurrences (LSQR, LSMR; hybrid LSQR on the composed CT operator)
#     over their first UNSTABLE_K steps only: float32 rounding moves them by
#     more than 1e-4 from step 3 on (LSMR on deriv2: 0.55 within 12 steps);
#   * a GCV lambda (bounded Brent on [1e-9, 1e-1]) within one step of
#     GCV_GRID (float32 vs float64 <= 1%);
#   * the error surface's optimum (k, lambda) exactly, its error to
#     DRIVER_RTOL;
#   * the sweeps' low/high final errors at those lambdas to SWEEP_RTOL
#     (float32 vs float64 <= 2.8e-2), but not hybrid BA's in the noise sweep
#     (GCV parks BA's projected objective at 1e-9: unregularized) nor the
#     non-hybrid ones (GMRES at step 32 on shaw, of order 1e12): float32
#     moves those by factors of 5 to 1500, and they are held finite;
#   * equivalence's (!=) soldiff to DRIVER_RTOL, its hybrid (==) pair within
#     EQUAL_F32 on both (float32: 1.3e-7); the non-hybrid pairs compare LSQR
#     and LSMR after 32 float32 steps (0.23 / 0.12, float64 1e-3): finite.
UNSTABLE_K = 2
GCV_GRID = np.logspace(-9, -1, 100)
SWEEP_RTOL = 5e-2
EQUAL_F32 = 1e-5
DENSE_DRIVERS = ("equivalence", "error_surface", "filter_factors_exp",
                 "perturbation_bounds", "noise_sweep", "mismatch_sweep",
                 "phantom2d")


def phantom_gpu_launches(res):
    """(K1, K2, K3, K4, K1r, K3r, K2r, K4r, K2w) launches of one run of
    ``phantom2d_gpu``, worked out from the code: four single solves (the
    first, then the best of 3) of 2 maxit + 1 K1r each (B b, then A and B
    per step), the gate-stopped solve of 2 k_stop + 1, and two batched
    scans (cold from zeros and warm) of 2 maxit + 2 K2r each (A x0 and
    B (b - A x0), then A and B per step)."""
    from hybrid_gmres_tpu_torch.experiments import phantom2d_gpu as pg

    maxit = res.cfg.maxit
    k_stop = max(pg.iters_to_gate(res.err_hist, res.gate), 1)
    return (0, 0, 0, 0, 4 * (2 * maxit + 1) + 2 * k_stop + 1, 0,
            2 * (2 * maxit + 2), 0, 0)


def phase_phantom2d_gpu(prob, ray_perm, pix_perm, results):
    """``phantom2d_gpu`` at its default Config on the card: its gates (the
    driver raises), the launch counts, the single solve's history against
    the float64 host reference of the same sinogram (the main path's
    bands), warm <= cold iterations to the gate."""
    import torch

    from hybrid_gmres_tpu_torch.experiments import phantom2d_gpu as pg

    cfg = pg.Config()
    check(cfg.maxit == MAXIT and cfg.lam == LAM and cfg.n == 64,
          "phantom2d_gpu's default Config is not the main path's scenario")
    t0 = time.perf_counter()
    reset_counts()
    with PeakMemory("n=64 phantom2d_gpu"):
        res = pg.run(cfg)
    torch.cuda.synchronize()
    launched = counts()
    run_s = time.perf_counter() - t0
    want = phantom_gpu_launches(res)
    check(launched == want, f"phantom2d_gpu: {LAUNCHES} launches "
          f"{launched}, expected {want}")
    check(res.min_err <= res.gate and res.batched_min_err_worst <= res.gate,
          f"phantom2d_gpu: min {res.min_err:.4f}, worst frame "
          f"{res.batched_min_err_worst:.4f}, gate {res.gate:.4f}")
    check(1 <= res.warm_iters_to_gate <= res.cold_iters_to_gate,
          f"phantom2d_gpu: warm {res.warm_iters_to_gate} cold "
          f"{res.cold_iters_to_gate} iterations to the gate")
    b = pg._noise(prob.b_exact, cfg.noise_level, cfg.seed)[ray_perm]
    err_ref = host_reference(prob, ray_perm, pix_perm, b)
    hist, at_min = held_to(res.err_hist, err_ref, "phantom2d_gpu",
                           "float64 host reference")
    say("drivers_rest", driver="phantom2d_gpu", backend=res.backend,
        run_s=run_s, launches_k1_k2_k3_k4_k1r_k3r_k2r_k4r_k2w=launched,
        min_err=res.min_err, min_err_k=int(np.argmin(res.err_hist)) + 1,
        final_err=res.final_err, batched_min_err_worst=(
            res.batched_min_err_worst), gate=res.gate,
        cold_iters_to_gate=res.cold_iters_to_gate,
        warm_iters_to_gate=res.warm_iters_to_gate, it_per_s=res.it_per_s,
        f64_ref_min_err=float(err_ref.min()), f64_ref_hist_rel_diff=hist,
        f64_ref_min_rel_diff=at_min,
        results_json_tpu={k: results["phantom2d_tpu"][k]
                          for k in TPU_RECORD})
    return launched


def hist_gap(card, cpu, steps, label):
    """The largest relative gap over the first ``steps`` entries of two
    histories (over their common length), held to DRIVER_RTOL; returns
    it with the gap over the common length, which is printed only."""
    n = min(len(card), len(cpu))
    check(n >= min(steps, len(cpu)), f"{label}: {len(card)} steps on the "
          f"card, {len(cpu)} on the CPU")
    rel = np.abs(card[:n] - cpu[:n]) / np.abs(cpu[:n])
    gap = float(rel[:steps].max())
    check(gap <= DRIVER_RTOL, f"{label}: card vs CPU {gap:.2e} over the "
          f"first {steps} steps")
    return dict(held_steps=min(steps, n), rel_gap=gap,
                rel_gap_all=float(rel.max()), len_card=len(card),
                len_cpu=len(cpu))


def dense_driver_checks(name, card, cpu):
    """One dense driver's card result against its CPU float32 result
    (the bands above the definition of UNSTABLE_K)."""
    out = {}
    if name in ("equivalence", "filter_factors_exp", "phantom2d"):
        for field in ("err_hists", "res_hists"):
            for k, h in getattr(cpu, field, {}).items():
                stable = (k.startswith("hybrid") and k != "hybrid_lsqr"
                          if name != "phantom2d" else
                          k.startswith("nonhybrid"))
                out[f"{field} {k}"] = hist_gap(
                    getattr(card, field)[k], h,
                    REF_K if stable else UNSTABLE_K, f"{name} {field} {k}")
    if name == "equivalence":
        from hybrid_gmres_tpu_torch.experiments import __main__ as cli
        from hybrid_gmres_tpu_torch.experiments import equivalence

        c, h = (cli._extras(name, equivalence, r) for r in (card, cpu))
        key = "hybrid_ab_vs_hybrid_lsqr_soldiff"
        gap = abs(c[key] - h[key]) / h[key]
        check(gap <= DRIVER_RTOL, f"{name} {key}: {c[key]} vs {h[key]}")
        eq = "hybrid_ba_vs_hybrid_lsmr_soldiff"
        check(max(c[eq], h[eq]) <= EQUAL_F32, f"{name} {eq}: {c[eq]} on the "
              f"card, {h[eq]} on the CPU")
        check(all(np.isfinite(v) for v in c.values()), f"{name}: {c}")
        out["soldiff"] = dict(card=c, cpu=h)
    elif name == "error_surface":
        for v in ("ab", "ba"):
            (kc, lc, ec), (kh, lh, eh) = card.optima[v], cpu.optima[v]
            check((kc, lc) == (kh, lh), f"{name} {v}: optimum {(kc, lc)} "
                  f"on the card, {(kh, lh)} on the CPU")
            check(abs(ec - eh) / eh <= DRIVER_RTOL, f"{name} {v}: optimal "
                  f"error {ec} vs {eh}")
            surf = np.abs(card.surfaces[v] - cpu.surfaces[v]) / cpu.surfaces[v]
            out[f"opt_{v}"] = dict(card=card.optima[v], cpu=cpu.optima[v],
                                   surface_rel_gap_first_k=float(np.nanmax(
                                       surf[:, :REF_K])))
    elif name == "filter_factors_exp":
        for k, phi in cpu.phi_theory.items():
            check(bool(np.isfinite(card.phi_theory[k]).all()),
                  f"{name} {k}: non-finite filter factors")
            out[f"phi_theory {k}"] = float(np.max(np.abs(
                card.phi_theory[k] - phi)))
    elif name == "perturbation_bounds":
        for k in cpu.actual:
            check(bool(np.isfinite(card.actual[k]).all() and
                       np.isfinite(card.bound[k]).all()),
                  f"{name} {k}: non-finite bounds")
            out[k] = dict(actual_max_abs_gap=float(np.max(np.abs(
                card.actual[k] - cpu.actual[k]))), bound_max_abs_gap=float(
                    np.max(np.abs(card.bound[k] - cpu.bound[k]))))
    elif name in ("noise_sweep", "mismatch_sweep"):
        for v in ("ab", "ba"):
            steps = [grid_steps(GCV_GRID, c, h) for c, h in
                     zip(card.gcv_lambdas[v], cpu.gcv_lambdas[v])]
            check(max(steps) <= 1.0 + 1e-6, f"{name} {v}: GCV lambdas "
                  f"{max(steps):.2f} grid steps apart")
            out[f"gcv_lambda_{v}_max_grid_steps"] = max(steps)
        for k, e in cpu.final_errors.items():
            c = card.final_errors[k]
            check(bool(np.isfinite(c).all()), f"{name} {k}: non-finite")
            gaps = [abs(c[i] - e[i]) / e[i] for i in (0, -1)]
            held = k == "hybrid_ab" or (name == "mismatch_sweep" and
                                        k == "hybrid_ba")
            if held:
                check(max(gaps) <= SWEEP_RTOL, f"{name} {k}: low/high "
                      f"{c[0]}/{c[-1]} on the card, {e[0]}/{e[-1]} on the "
                      "CPU")
            out[k] = dict(low=float(c[0]), high=float(c[-1]),
                          low_cpu=float(e[0]), high_cpu=float(e[-1]),
                          held=held, rel_gaps=gaps)
    elif name == "phantom2d":
        for k, e in cpu.mismatch_errors.items():
            check(bool(np.isfinite(card.mismatch_errors[k]).all()),
                  f"{name} {k}: non-finite mismatch sweep")
            out[f"mismatch {k}"] = float(np.max(np.abs(
                card.mismatch_errors[k] - e) / e))
    return out


def phase_dense_drivers():
    """The seven dense drivers at their default Configs on the card and on
    the CPU port in float32, held to each other as set out above, with the
    values of ``figures/results.json`` (the JAX package's float64 runs)
    printed beside them."""
    import importlib

    from hybrid_gmres_tpu_torch.experiments import __main__ as cli

    results = results_json()
    out = {}
    for name in DENSE_DRIVERS:
        mod = importlib.import_module(
            f"hybrid_gmres_tpu_torch.experiments.{name}")
        t0 = time.perf_counter()
        card = mod.run(mod.Config())
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = mod.run(mod.Config(device="cpu"))
        cpu_s = time.perf_counter() - t0
        rec = dict(card_s=card_s, cpu_s=cpu_s,
                   card=cli._extras(name, mod, card),
                   results_json={k: v for k, v in results[
                       cli._JSON_KEY.get(name, name)].items()
                       if k not in ("time_s", "figures")},
                   **dense_driver_checks(name, card, cpu))
        say("drivers_rest", driver=name, **rec)
        out[name] = card_s
    return out


def phase_cli():
    """``python -m hybrid_gmres_tpu_torch.experiments equivalence
    phantom2d_gpu --outdir <tmp>`` on the card: the keys of its
    ``results.json`` are the JAX file's for those drivers (phantom2d_tpu as
    phantom2d_gpu), each entry's too but ``figures`` (matplotlib may be
    missing)."""
    import os
    import tempfile

    from hybrid_gmres_tpu_torch.experiments import __main__ as cli

    jax_results = results_json()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        check(cli.main(["equivalence", "phantom2d_gpu", "--outdir", tmp])
              == 0, "the CLI failed")
        with open(os.path.join(tmp, "results.json")) as f:
            got = json.load(f)
    rename = {"phantom2d_tpu": "phantom2d_gpu"}
    want = {rename.get(k, k): v for k, v in jax_results.items()
            if k in ("equivalence", "phantom2d_tpu")}
    check(set(got) == set(want), f"CLI keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        check(set(got[k]) == set(want[k]), f"CLI {k} keys {sorted(got[k])} "
              f"vs {sorted(want[k])}")
    say("drivers_rest", driver="cli", seconds=time.perf_counter() - t0,
        keys={k: sorted(v) for k, v in got.items()},
        backend=got["phantom2d_gpu"]["backend"],
        figures={k: v["figures"] for k, v in got.items()})


def phase_drivers_rest(prob, ray_perm, pix_perm):
    """The rest of the experiment drivers at n=64: ``phantom2d_gpu`` on
    the card (the path of this phase), the seven dense drivers against the
    CPU port, the CLI.  Returns the launches of ``phantom2d_gpu``."""
    t0 = time.perf_counter()
    launched = phase_phantom2d_gpu(prob, ray_perm, pix_perm, results_json())
    dense = phase_dense_drivers()
    phase_cli()
    say("drivers_rest_done", seconds=time.perf_counter() - t0,
        dense_card_s=dense)
    return launched


# --------------------------------------------------------------------------
# int4 (nibble-packed forms) and the sharded path (p=1 NCCL, shard_view)
# --------------------------------------------------------------------------

# the int4, float and sharded phases' multi-RHS width
RHS = 8


def int4_operators(P, refs=False):
    """The int4 operators of P's problem (``ct_gpu_operators(dtype="int4")``
    on the card, forward panels only) in a namespace the solve helpers
    take, with the seconds their packing took; with ``refs`` also the
    float64 host solves on the values their forms hold
    (:func:`float_host_refs`), as :func:`phase_variant_path` takes them."""
    from hybrid_gmres_tpu_torch.problems.ct import ct_gpu_operators

    t0 = time.perf_counter()
    A4, B4 = ct_gpu_operators(P.prob, dtype="int4", device="cuda")[:2]
    P4 = SimpleNamespace(**{**vars(P), "A_op": A4, "B_op": B4,
                            "A_adj": None, "B_adj": None, "dtype": "int4",
                            "packing_s": time.perf_counter() - t0})
    if refs:
        t0 = time.perf_counter()
        P4.refs = float_host_refs(A4, B4, P.b_host,
                                  P.prob.x_true[P.pix_perm], gkb=True)
        P4.pool = dict(f64_refs_s=time.perf_counter() - t0)
    return P4


def int4_wide_path(P4):
    """AB-RTP (maxit=100, lam=1e-2, tol=0) on the int4 operators: its
    launches from the code (A Q on K2w where the rule names it, as on the
    int8 operators), its result finite, and its error history against the
    same solve with every product on K2r (the rule's work threshold raised
    for that run): the first REF_K entries within REF_RTOL, the minimum
    within REF_MIN_RTOL.  Returns the launches of the K2w run."""
    import torch

    from hybrid_gmres_tpu_torch.ops import spmv_cuda

    name, label = "ab_gmres_rtp", f"n={P4.n} int4 ab_gmres_rtp"
    run = partial(rtp_solver(name), P4.A_op, P4.B_op, P4.b, P4.x_true,
                  tol=0.0, maxit=MAXIT, lam=LAM)
    k1, k2 = rtp_launches(name, MAXIT)
    r, launched = counted(run, k1r_k2r(k1, (k2, P4.A_op, MAXIT)), label)
    finite_result(r, label, P4.A_op.shape[1])
    threshold = spmv_cuda.WIDE_WORK
    spmv_cuda.WIDE_WORK = float("inf")
    try:
        r0, launched0 = counted(run, k1r_k2r(k1, (k2, P4.A_op, MAXIT)),
                                label + " on K2r")
    finally:
        spmv_cuda.WIDE_WORK = threshold
    err, err0 = r.err_hist.cpu().numpy(), r0.err_hist.cpu().numpy()
    hist, at_min = held_to(err, err0, label, "the same solve on K2r")
    torch.cuda.synchronize()
    say("int4_wide_path", n=P4.n, solver=name, launches=launched,
        launches_on_k2r=launched0, min_err=float(err.min()),
        min_err_on_k2r=float(err0.min()), hist_rel_diff=hist,
        min_rel_diff=at_min)
    return launched


def int8_library(csr, op):
    """(the library's matrix, its transpose): ``torch.sparse`` CSR on the
    card of the int8 diag(s) Q of ``csr``."""
    return library_csr(csr), library_csr(csr, transpose=True)


def int4_library(csr, op):
    """The same for the int4 diag(s) Q."""
    return library_csr(csr, qmax=7), library_csr(csr, transpose=True, qmax=7)


def int4_kernels(P, P4):
    """The redesigned K1-K4 on the int4 forms of one size
    (:func:`form_kernels`), the library call on the int4 diag(s) Q."""
    return form_kernels(P, P4, "int4", int4_library)


def form_kernels(P, V, variant, library, sweep=False):
    """The redesigned K1-K4 on the forms of one size's ``variant``
    operators ``V`` (``"int4"``, ``"bfloat16"``, ``"float32"``): each
    against its plain version on the card, twice (the same bits), K2's
    (K4's) column j against K1 (K3) on column j (the same bits), the
    library call (``library(csr, op)``: the matrix and its transpose as
    ``torch.sparse`` CSR), timed in turns beside the int8 kernel on the
    same input (K2 and K4: the gather kernel, :func:`gather_of`, on both),
    against the bound from the form's live bytes, with the
    registers and spills of the storage type's variants (``spills``).  The
    forms' bytes against the int8 forms' (smaller for int4).  ``sweep``:
    K2 and K4 at R=8 also in every gather and block size, the same bits,
    each timed, the fastest against the default (the window kernel where
    the rule takes it, else ``_gather_for``, ``_threads_for``).  Returns
    the records of (K1, K3, K2, K4), A's panel then B's."""
    import torch

    from hybrid_gmres_tpu_torch.ops.sparse import WINDOW_THREADS
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        _threads_for, row_matmat, row_matmat_plain, row_matvec,
        row_matvec_plain, row_rmatmat, row_rmatmat_plain, row_rmatvec,
        row_rmatvec_plain)

    rng = np.random.default_rng(4)
    recs = {k: [] for k in ("K1", "K3", "K2", "K4")}
    regs = spills(variant)
    for tag, opv, op8, csr in (("A", V.A_op, P.A_op, P.A_csr),
                               ("B", V.B_op, P.B_op, P.B_csr)):
        m, n = opv.shape
        sv, s8 = opv.fwd_scale, op8.fwd_scale
        panel = f"n={P.n} {tag} {variant}"
        forms = dict(rows_mb=opv.fwd_rows.nbytes / 1e6,
                     rows_t_mb=opv.adj_rows.nbytes / 1e6,
                     int8_rows_mb=op8.fwd_rows.nbytes / 1e6,
                     int8_rows_t_mb=op8.adj_rows.nbytes / 1e6)
        check(variant != "int4" or (
            opv.fwd_rows.nbytes < op8.fwd_rows.nbytes and
            opv.adj_rows.nbytes < op8.adj_rows.nbytes),
            f"{panel}: the int4 forms are not smaller than the int8 forms "
            f"({forms})")
        say("forms", panel=panel, **forms,
            ratio=opv.fwd_rows.nbytes / op8.fwd_rows.nbytes,
            ratio_t=opv.adj_rows.nbytes / op8.adj_rows.nbytes,
            spills=regs, int8_spills=spills("int8"))
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device="cuda")
        u = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device="cuda")
        X = torch.as_tensor(rng.standard_normal((n, RHS)),
                            dtype=torch.float32, device="cuda")
        U = torch.as_tensor(rng.standard_normal((m, RHS)),
                            dtype=torch.float32, device="cuda")
        Xt, Ut = X.T.contiguous().T, U.T.contiguous().T  # solvers' layout
        lib, lib_t = library(csr, opv)
        for kernel, rp, rp8, fn, plain, single, v, lv, args, args8, R in (
                ("K1", opv.fwd_rows, op8.fwd_rows, row_matvec,
                 row_matvec_plain, None, x, lib, (sv,), (s8,), 1),
                ("K3", opv.adj_rows, op8.adj_rows, row_rmatvec,
                 row_rmatvec_plain, None, u, lib_t, (sv,), (s8,), 1),
                ("K2", opv.fwd_rows, op8.fwd_rows, row_matmat,
                 row_matmat_plain, row_matvec, Xt, lib, (sv,), (s8,), RHS),
                ("K4", opv.adj_rows, op8.adj_rows, row_rmatmat,
                 row_rmatmat_plain, row_rmatvec, Ut, lib_t, (sv,), (s8,),
                 RHS)):
            label = f"{panel}: {kernel} redesigned"
            got, want, again = fn(rp, v, *args), plain(rp, v, *args), \
                fn(rp, v, *args)
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"{label} output not finite or misshaped")
            err = rel_err(got, want)
            check(err <= KERNEL_RTOL, f"{label} vs plain {err:.3e}")
            repeat = float((got - again).abs().max())
            check(repeat == 0.0, f"{label} differs between two runs")
            col_diff = None
            if single is not None:
                col_diff = max(float((got[:, j] - single(
                    rp, v[:, j].contiguous(), *args)).abs().max())
                    for j in range(R))
                check(col_diff == 0.0, f"{label}: a column differs from the "
                      f"single-RHS kernel on it by {col_diff:.3e}")
            lib_diff = rel_err(lv @ v, got)
            check(lib_diff <= LIBRARY_RTOL, f"{label} vs library "
                  f"{lib_diff:.3e}")
            # K2 and K4: the gather kernel (the window kernel's own times
            # are window_kernels')
            gkw, gkw8 = ((gather_of(rp, v, scaled=kernel == "K4" and
                                    sv is not None),
                          gather_of(rp8, v, scaled=kernel == "K4"))
                         if R > 1 else ({}, {}))
            run_k, run_p = partial(fn, rp, v, *args, **gkw), partial(
                plain, rp, v, *args)
            run_8 = partial(fn, rp8, v, *args8, **gkw8)
            p1, k1, i1, i2, k2, p2 = (time_ms(run_p, 10), time_ms(run_k),
                                      time_ms(run_8), time_ms(run_8),
                                      time_ms(run_k), time_ms(run_p, 10))
            work = row_work(rp, m, R=R)
            b_ms, b_by = bound([work])
            ms = (k1 + k2) / 2
            rec = dict(
                panel=panel, shape=[m, n],
                kernel=f"{kernel} redesigned {variant}", R=R, ms=ms,
                plain_ms=(p1 + p2) / 2, int8_ms=(i1 + i2) / 2,
                library_ms=time_ms(lambda: lv @ v), bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / ms,
                int8_bound_ms=bound([row_work(rp8, m, R=R)])[0], work=work,
                max_abs_err=float((got - want).abs().max()), max_rel_err=err,
                repeat_max_diff=repeat, column_vs_single_max_diff=col_diff,
                library_max_rel_diff=lib_diff, form_shape=list(rp.shape),
                lanes=rp.lanes, fill=rp.fill, live=rp.live,
                form_mb=rp.nbytes / 1e6, int8_form_mb=rp8.nbytes / 1e6,
                index_bits=32 if rp.wide else 16, **gkw,
                routed=routed_gather(rp, v, scaled=kernel == "K4" and
                                     sv is not None) if R > 1 else None,
                spills=None if regs is None else regs.get(
                    "K1r/K3r" if R == 1 else "K2r/K4r"))
            if sweep and R > 1:
                variants = variants_for(rp, v)
                diff = max(float((got - fn(rp, v, *args, **kw)).abs().max())
                           for kw in variants.values())
                check(diff == 0.0, f"{label}: a gather or block size "
                      f"changes the bits by {diff:.3e}")
                gather = routed_gather(rp, v, scaled=kernel == "K4" and
                                       sv is not None)
                default = (f"{gather}/{WINDOW_THREADS}" if gather == "window"
                           else f"{gather}/{_threads_for(rp, gather)}")
                variant_ms = {name: time_ms(partial(fn, rp, v, *args, **kw))
                              for name, kw in variants.items()}
                best = min(variant_ms, key=variant_ms.get)
                rec.update(default_variant=default, variant_ms=variant_ms,
                           best_variant=best, variant_beats_default=(
                               variant_ms[best] < (1 - VARIANT_MARGIN)
                               * variant_ms[default]))
            say("kernel_vs_plain", **rec)
            recs[kernel].append(rec)
    release_plain_caches(V)
    release_plain_caches(P)
    return recs["K1"], recs["K3"], recs["K2"], recs["K4"]


# Phase float_forms: the CT operators in the JAX package's default storage
# type (``ct_tpu_operators(dtype="bfloat16")``) and in float32.  Neither has
# a row scale, so every product runs its kernel's unscaled branch.
FLOAT_DTYPES = ("bfloat16", "float32")
# the worker processes that pack the float operators and solve on their
# values in float64 on the host (at n=128 a pair takes ~30 s to pack)
FLOAT_WORKERS = 2
# a gather or block size other than the default that is faster by more
# than this share at R=8 is flagged (``variant_beats_default``)
VARIANT_MARGIN = 0.2
# entry()'s int8 fused solve on the card against its CPU branch (dense
# float32 operators, true residual): the per-row int8 rounding moves the
# residual history by 7.1e-5 on the CPU port (20 steps)
ENTRY_CPU_RTOL = 1e-4


def form_csr(rp, scale=None):
    """The matrix a row-packed form holds, read back from its stored values
    (``RowPacked.entry_values``, decoded on the host), times
    ``diag(scale)`` when given: float64 scipy CSR, independent of the
    kernels.  A padding entry (a zero in a column its row holds) adds
    nothing."""
    import scipy.sparse as sp
    import torch

    from hybrid_gmres_tpu_torch.ops.sparse import VEC

    rp = rp.to("cpu")
    nv = (rp.vec_off[1:] - rp.vec_off[:-1]).long()
    rows = rp.row_map.long()[torch.repeat_interleave(
        torch.arange(nv.shape[0]), nv)].repeat_interleave(VEC)
    q = sp.csr_matrix((rp.entry_values().to(torch.float64).numpy(),
                       (rows.numpy(), rp.col_index().numpy())),
                      shape=rp.shape)
    q.eliminate_zeros()
    if scale is not None:
        q = sp.diags(scale.cpu().double().numpy()) @ q
    return q.tocsr()


def float_host_refs(A_op, B_op, b, x_true, gkb):
    """The float64 host solves on the matrices the operators' forward
    forms hold (:func:`form_csr`): BA-GMRES (lam=1e-2, fused, MAXIT
    steps) and, with ``gkb``, ``lsqr``.  Returns their error histories by
    solver."""
    import torch

    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres
    from hybrid_gmres_tpu_torch.solvers.lsqr import lsqr

    A = scipy_operator(form_csr(A_op.fwd_rows, A_op.fwd_scale), qmax=None)
    B = scipy_operator(form_csr(B_op.fwd_rows, B_op.fwd_scale), qmax=None)
    b64 = torch.from_numpy(b.astype(np.float64))
    x64 = torch.as_tensor(x_true, dtype=torch.float64)
    refs = {"ba": ba_gmres(A, B, b64, x64, tol=0.0, maxit=MAXIT, lam=LAM,
                           residual="fused").err_hist.numpy()}
    if gkb:
        refs["lsqr"] = lsqr(A, b64, x64, tol=0.0,
                            maxit=MAXIT).err_hist.numpy()
    return refs


def float_job(n, dtype, path):
    """One job of a float pool (a worker process): CT n assembled, its
    operators packed on the host (``ct_gpu_operators(dtype=...,
    device="cpu")``) and saved to ``path`` (``torch.save``: a file, not
    the pool's pipe, carries the gigabytes of an n=128 pair), and the
    float64 host solves on their forms' values (:func:`float_host_refs`;
    ``lsqr`` at n=64).  Returns (``path``, the references, the seconds each
    part took)."""
    import torch

    from hybrid_gmres_tpu_torch.problems.ct import (ct_gpu_operators,
                                                    ct_mismatched)

    torch.set_num_threads(2)
    ang = 180 * n // 64
    t0 = time.perf_counter()
    prob = ct_mismatched(n=n, n_angles=ang, n_det=ang)
    A_op, B_op, _, _, ray_perm, pix_perm = ct_gpu_operators(
        prob, dtype=dtype, device="cpu")
    torch.save((A_op, B_op), path)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = noisy_sinograms(SimpleNamespace(prob=prob, ray_perm=ray_perm),
                        [0])[:, 0]
    refs = float_host_refs(A_op, B_op, b, prob.x_true[pix_perm],
                           gkb=n == 64)
    return path, refs, dict(assembly_and_packing_s=pack_s,
                            f64_refs_s=time.perf_counter() - t0)


def start_float_builds(n):
    """A pool of FLOAT_WORKERS spawned processes running :func:`float_job`
    for size n and each of FLOAT_DTYPES, into a temporary directory.
    Started before ``make_problem(n)``, whose assembly and packing (host
    work, timed by nothing) the jobs run beside; :func:`float_results`
    waits for them before anything is timed (a worker beside a timed phase
    slows its walls and kernel times many-fold)."""
    import multiprocessing
    import os
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_float_")
    pool = ProcessPoolExecutor(FLOAT_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = {dtype: pool.submit(float_job, n, dtype, os.path.join(
            tmp.name, f"{n}_{dtype}.pt")) for dtype in FLOAT_DTYPES}
    except BaseException:
        pool.shutdown(wait=True, cancel_futures=True)
        tmp.cleanup()
        raise
    return n, pool, jobs, tmp


def float_results(builds):
    """Wait for the jobs of :func:`start_float_builds` and shut its pool
    down.  Returns ``{dtype: (path, refs, seconds)}``; the files live in
    the temporary directory of ``builds``, removed when that is dropped
    (at the latest when the script exits)."""
    n, pool, jobs, tmp = builds
    t0 = time.perf_counter()
    try:
        out = {dtype: job.result(timeout=900) for dtype, job in jobs.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    say("float_builds", n=n, wait_s=time.perf_counter() - t0,
        jobs={dtype: secs for dtype, (_, _, secs) in out.items()})
    return out


def same_form(fa, fb):
    """Two row-packed forms hold the same entries in the same places
    (``fb`` compared on the device of ``fa``)."""
    import torch

    return ((fa.shape, fa.lanes, fa.live) == (fb.shape, fb.lanes, fb.live)
            and all(torch.equal(getattr(fa, f),
                                getattr(fb, f).to(getattr(fa, f).device))
                    for f in ("vals", "cols", "vec_off", "row_map")))


def float_operators(P, dtype, job):
    """The ``dtype`` operators of P's problem on the card, in a namespace
    the solve helpers take, with their float64 host references (``refs``;
    ``job``: what :func:`float_job` returned).  At n=64
    ``ct_gpu_operators(dtype=..., device="cuda")``, the user's call, whose
    forms must equal the pool's host build bit for bit; at n=128 the
    pool's host build moved to the card (``BlockELLOperator.to``: the
    forms, the panels stay on the host)."""
    import os

    import torch

    from hybrid_gmres_tpu_torch.problems.ct import ct_gpu_operators

    path, refs, secs = job
    t0 = time.perf_counter()
    A_h, B_h = torch.load(path, weights_only=False)
    os.remove(path)
    if P.n == 64:
        A_op, B_op = ct_gpu_operators(P.prob, dtype=dtype, device="cuda")[:2]
        for tag, card, host in (("A", A_op, A_h), ("B", B_op, B_h)):
            check(same_form(card.fwd_rows, host.fwd_rows) and
                  same_form(card.adj_rows, host.adj_rows),
                  f"n=64 {tag} {dtype}: the forms built for the card differ "
                  "from the host build")
    else:
        A_op, B_op = A_h.to("cuda"), B_h.to("cuda")
    torch.cuda.synchronize()
    want = getattr(torch, dtype)
    for op in (A_op, B_op):
        check(op.storage_dtype == want and op.fwd_scale is None and
              op.fwd_rows.dtype == want and op.adj_rows.dtype == want,
              f"n={P.n} {dtype}: the operator stores {op.storage_dtype}")
    return SimpleNamespace(**{
        **vars(P), "A_op": A_op, "B_op": B_op, "A_adj": None, "B_adj": None,
        "dtype": dtype, "refs": refs, "pool": secs,
        "packing_s": time.perf_counter() - t0})


def spills(dtype):
    """Registers and spills of the ``row_spmv.cu`` variants of one storage
    type (``"int4"``, ``"int8"``, ``"bfloat16"``, ``"float32"``), from the
    build phase's ptxas report: ``{"K1r/K3r": [...], "K2r/K4r": [...],
    "K2r/K4r window": [...]}`` (None when this run built nothing)."""
    import re

    code = {"float32": "f", "bfloat16": "13__nv_bfloat16", "int8": "a"}
    out = {"K1r/K3r": [], "K2r/K4r": [], "K2r/K4r window": []}
    for v in BUILD_VARIANTS.get("row_spmv", []):
        name = v["entry"]
        kernel = ("K1r/K3r" if "row_spmv_kernel" in name else
                  "K2r/K4r" if "row_spmm_kernel" in name else
                  "K2r/K4r window" if "row_spmm_window_kernel" in name
                  else None)
        if kernel is None:
            continue
        t = name.split("kernelI", 1)[1]
        if (t.startswith(code[dtype]) if dtype in code else
                not any(t.startswith(c) for c in code.values())):
            nums = [int(x) for x in re.findall(r"(\d+) bytes", v["spill"])]
            out[kernel].append(dict(registers=v.get("registers"),
                                    stack=nums[0], spill_stores=nums[1],
                                    spill_loads=nums[2]))
    if not any(out.values()):
        return None
    return {k: dict(variants=len(v),
                    registers=sorted({e["registers"] for e in v}),
                    max_spill_stores=max(e["spill_stores"] for e in v),
                    max_spill_loads=max(e["spill_loads"] for e in v),
                    spilling=sum(e["spill_stores"] > 0 for e in v))
            for k, v in out.items() if v}


def in_turns(label, runs, reps=5):
    """Median milliseconds of each named solve in ``runs`` (name -> a call),
    the solves taking turns (:func:`alternating_ms`), and it/s at MAXIT
    steps."""
    ms = alternating_ms(tuple(runs.values()), reps)
    out = {}
    for name, times in zip(runs, ms):
        med = float(np.median(times))
        out[name] = dict(solve_ms_median=med, solve_ms_min=min(times),
                         solve_ms_max=max(times),
                         iters_per_s=MAXIT / (med / 1e3))
    say("in_turns", label=label, **out)
    return out


def gate_or_host(min_err, gate, host_min, label):
    """A quality gate that the float64 host solve on the same values
    decides when the card misses it: both missing it put the fault on the
    storage type's rounding, not the port (recorded, not fatal); the card
    alone missing it is a fault."""
    met = min_err <= gate
    check(met or host_min > gate, f"{label}: min-over-k rel err "
          f"{min_err:.4f} > gate {gate:.4f}, which the float64 host solve "
          f"on the same values meets ({host_min:.4f})")
    return dict(min_err=min_err, gate=gate, gate_met=met,
                f64_ref_min_err=host_min, f64_ref_meets_gate=host_min <= gate)


def phase_variant_path(P, F, full):
    """The paths on one size's ``F.dtype`` operators (int4, bfloat16,
    float32), each run with the counts reset before and read after, each
    held to the float64 host solve on the values its forms hold
    (``F.refs``, :func:`float_host_refs`): the single solve
    (BA-GMRES, lam=1e-2, fused; 201 K1r), its gate and the host band
    (first REF_K entries to REF_RTOL, minimum to REF_MIN_RTOL); with
    ``full`` (n=64) also the serving batch (R=8 deferred; 201 K2r; column 0
    to the host solve and to the single solve, every column to the serving
    gate), ``lsqr`` (101 K1r, 101 K3r) and ``lsqr_batched`` (R=8; 101 K2r,
    101 K4r) in GKB_BANDS of the host ``lsqr``, gated at its minimum times
    GKB_BAND.  Each path's peak memory, and its walls taken in turns with
    the int8 twin's.  Returns the launches of (K1r, K3r, K2r, K4r, the
    window kernel as K2r, as K4r), each from its path's run."""
    import torch

    n, dt = P.n, F.dtype
    label = f"n={n} {dt}"
    ref = F.refs["ba"]
    with PeakMemory(f"{label} single"):
        reset_counts()
        r = solve(F)
        torch.cuda.synchronize()
        launched = counts()
    want = (0, 0, 0, 0, 2 * MAXIT + 1, 0, 0, 0, 0)
    check(launched == want, f"{label}: {LAUNCHES} launches {launched} in the "
          f"single solve, expected {want}")
    err = r.err_hist.cpu().numpy()
    check(bool(np.isfinite(err).all() and torch.isfinite(r.x).all()) and
          int(r.niters) == MAXIT, f"{label}: non-finite single solve")
    hist, at_min = held_to(err, ref, label, "float64 host solve (its values)")
    out = dict(n=n, dtype=dt, packing_s=F.packing_s, pool=F.pool,
               single=dict(launches=launched, f64_ref_hist_rel_diff=hist,
                           f64_ref_min_rel_diff=at_min,
                           min_err_k=int(err.argmin()) + 1,
                           bench_py_gate=BENCH_PY_GATES[n],
                           **gate_or_host(float(err.min()), GATES[n],
                                          float(ref.min()), label),
                           **in_turns(f"{label} single", {
                               "int8": lambda: solve(P),
                               dt: lambda: solve(F)})))
    got = [launched[4], 0, 0, 0, 0, 0]
    if full:
        b8 = torch.as_tensor(noisy_sinograms(P, range(RHS)), device="cuda")
        with PeakMemory(f"{label} serving R={RHS}",
                        (F.A_op, F.B_op)):
            rb, lb = counted_batched(F, b8, True, 2 * MAXIT + 1,
                                     f"{label} serving R={RHS}")
        lb_window = counted_batched.window[0]
        errb = rb.err_hist.cpu().numpy()
        minima = errb.min(axis=0)
        check(bool((minima <= SERVING_GATES[n]).all()), f"{label} serving: "
              f"minima {minima.tolist()} above {SERVING_GATES[n]:.4f}")
        out["serving"] = dict(
            launches=lb, min_err=minima.tolist(), gate=SERVING_GATES[n],
            column0_vs_f64_ref=held_to(errb[:, 0], ref,
                                       f"{label} serving column 0",
                                       "float64 host solve"),
            column0_vs_single=held_to(errb[:, 0], err,
                                      f"{label} serving column 0",
                                      "the single solve"),
            **in_turns(f"{label} serving", {
                "int8": lambda: solve_batched(P, b8, True),
                dt: lambda: solve_batched(F, b8, True)}))
        lref = F.refs["lsqr"]
        with PeakMemory(f"{label} lsqr"):
            rl, ll = gkb_counted("lsqr", F.A_op, F.b, F.x_true, MAXIT,
                                 f"{label} lsqr")
        errl = rl.err_hist.cpu().numpy()
        lgate = float(lref.min()) * GKB_BAND
        check(float(errl.min()) <= lgate, f"{label} lsqr: min-over-k rel "
              f"err {errl.min():.4f} > gate {lgate:.4f}")
        fn, _ = gkb_solver("lsqr")
        fnb, _ = gkb_solver("lsqr_batched")
        out["lsqr"] = dict(
            launches=ll, min_err=float(errl.min()), gate=lgate,
            f64_ref_min_err=float(lref.min()),
            vs_f64_ref=held_to(errl, lref, f"{label} lsqr",
                               "float64 host lsqr", GKB_BANDS),
            **in_turns(f"{label} lsqr", {
                "int8": lambda: fn(P.A_op, P.b, P.x_true, tol=0.0,
                                   maxit=MAXIT),
                dt: lambda: fn(F.A_op, F.b, F.x_true, tol=0.0,
                               maxit=MAXIT)}))
        with PeakMemory(f"{label} lsqr_batched R={RHS}",
                        (F.A_op, F.B_op)):
            rlb, llb = gkb_counted("lsqr_batched", F.A_op, b8, F.x_true,
                                   MAXIT, f"{label} lsqr_batched R={RHS}")
        llb_window = gkb_counted.window[1]
        errlb = rlb.err_hist.cpu().numpy()
        check(float(errlb[:, 0].min()) <= lgate, f"{label} lsqr_batched "
              f"column 0: min-over-k rel err {errlb[:, 0].min():.4f} > gate "
              f"{lgate:.4f}")
        out["lsqr_batched"] = dict(
            launches=llb, min_err=errlb.min(axis=0).tolist(),
            column0_vs_f64_ref=held_to(errlb[:, 0], lref,
                                       f"{label} lsqr_batched column 0",
                                       "float64 host lsqr", GKB_BANDS),
            column0_vs_single=held_to(errlb[:, 0], errl,
                                      f"{label} lsqr_batched column 0",
                                      "the single lsqr", GKB_BANDS),
            **in_turns(f"{label} lsqr_batched", {
                "int8": lambda: fnb(P.A_op, b8, P.x_true, tol=0.0,
                                    maxit=MAXIT),
                dt: lambda: fnb(F.A_op, b8, F.x_true, tol=0.0,
                                maxit=MAXIT)}))
        got = [launched[4], ll[5], lb[6], llb[7], lb_window, llb_window]
    out["memory"] = {k: v for k, v in MEMORY.items() if k.startswith(label)}
    say("variant_path", **out)
    return got


def phase_float_forms(P, jobs):
    """Phase float_forms at P's size, for each of FLOAT_DTYPES: the
    operators (:func:`float_operators`; ``jobs``: :func:`float_results`),
    the redesigned K1-K4 on their forms (:func:`form_kernels`, every
    gather and block size timed at R=8) and the paths
    (:func:`phase_variant_path`; n=64 all four, n=128 the single solve).
    Returns ``{dtype: (kernel records of K1, K3, K2, K4, launches of K1r,
    K3r, K2r, K4r and of the window kernel as K2r and K4r, the window
    kernel's records (:func:`window_kernels`))}``."""
    import torch

    out = {}
    for dtype in FLOAT_DTYPES:
        t0 = time.perf_counter()
        F = float_operators(P, dtype, jobs[dtype])
        recs = form_kernels(P, F, dtype, float_library, sweep=True)
        wrecs = window_kernels(P, F, dtype, float_library)
        launches = phase_variant_path(P, F, full=P.n == 64)
        out[dtype] = (recs, launches, wrecs)
        say("float_forms_done", n=P.n, dtype=dtype,
            seconds=time.perf_counter() - t0)
        del F
        torch.cuda.empty_cache()
    return out


def float_library(csr, op):
    """(the library's matrix, its transpose): ``torch.sparse`` CSR on the
    card of the values a float operator's forward form holds."""
    q = form_csr(op.fwd_rows, op.fwd_scale)
    return library_of(q), library_of(q.T.tocsr())


def phase_entry():
    """``hybrid_gmres_tpu_torch.entry.entry()``'s step on the card (CT
    n=32, int8, fused, 20 steps), the counts reset before and read after:
    41 K1r launches and nothing else; ``res_hist`` against the float64
    host solve on the same int8 matrices (first REF_K entries to
    REF_RTOL), and against the CPU branch (``entry(device="cpu")``: dense
    float32, true residual) within ENTRY_CPU_RTOL; the wall of ``fn``
    beside ``dispatch_floor_seconds``."""
    import torch

    from hybrid_gmres_tpu_torch.entry import MAXIT as STEPS
    from hybrid_gmres_tpu_torch.entry import N, N_ANGLES, N_DET, entry
    from hybrid_gmres_tpu_torch.ops.ordering import morton_perm
    from hybrid_gmres_tpu_torch.problems.ct import ct_mismatched
    from hybrid_gmres_tpu_torch.utils.profiling import dispatch_floor_seconds

    t0 = time.perf_counter()
    fn, args = entry()
    build_s = time.perf_counter() - t0
    reset_counts()
    x, res, niters = fn(*args)
    torch.cuda.synchronize()
    launched = counts()
    want = (0, 0, 0, 0, 2 * STEPS + 1, 0, 0, 0, 0)
    check(launched == want, f"entry: {LAUNCHES} launches {launched}, "
          f"expected {want}")
    res = res.cpu().numpy()
    check(int(niters) == STEPS and tuple(x.shape) == (N * N,) and
          bool(torch.isfinite(x).all()) and bool(np.isfinite(res).all()),
          "entry: non-finite or misshaped result")
    prob = ct_mismatched(n=N, n_angles=N_ANGLES, n_det=N_DET)
    ref = host_reference(prob, morton_perm(N_ANGLES, N_DET), morton_perm(N, N),
                         args[2].cpu().numpy(), maxit=STEPS, hist="res_hist")
    gap_ref = float(np.max(np.abs(res[:REF_K] - ref[:REF_K]) / ref[:REF_K]))
    check(gap_ref <= REF_RTOL, f"entry: res_hist vs the float64 host solve "
          f"{gap_ref:.2e} > {REF_RTOL:.0e}")
    fn_c, args_c = entry(device="cpu")
    res_c = fn_c(*args_c)[1].numpy()
    gap_cpu = float(np.max(np.abs(res - res_c) / res_c))
    check(gap_cpu <= ENTRY_CPU_RTOL, f"entry: res_hist vs the CPU branch "
          f"{gap_cpu:.2e} > {ENTRY_CPU_RTOL:.0e}")
    ms = per_call_ms(lambda: fn(*args), reps=5)
    say("entry", launches=launched, build_s=build_s, niters=int(niters),
        min_res=float(res.min()), f64_ref_res_rel_diff=gap_ref,
        cpu_branch_res_rel_diff=gap_cpu, cpu_branch_min_res=float(
            res_c.min()), fn_ms_median=float(np.median(ms)),
        fn_ms_min=min(ms), dispatch_floor_ms=dispatch_floor_seconds() * 1e3)
    return launched


def sharded_launches(kind, forward, maxit=MAXIT):
    """(K1r, K3r) launches of one sharded solve, worked out from the code:
    A's rows through K1 every step; B per step through K3 (transposed
    layout) or K1 (forward); BA applies B once more for r0 = B b."""
    b_calls = maxit + (kind == "ba")
    return (maxit + b_calls, 0) if forward else (maxit, b_calls)


def phase_sharded(P, err_ref_ba, gkb_refs, B4=None, tiles=None):
    """The sharded solvers at p=1 on a one-rank NCCL group (what runs on
    one card): ``ba_gmres_sharded_pallas`` and ``ab_gmres_sharded_pallas``
    on P's int8 CT operator in the transposed (``BT_panels``) and forward
    (``B_panels``) layouts.  The panels are what a user builds:
    ``shard_bucketed_panels(csr, 1)`` on the host, put on the card once by
    ``shard_view`` (and held bit-equal to the operators' forms).  Each
    solve runs with the counts reset before and read after (K1r/K3r
    against the code), gives a finite history and x, is held in the main
    path's bands (first REF_K entries to REF_RTOL, minimum to REF_MIN_RTOL)
    to the single-chip solve of the same matrices on the card and to the
    float64 host solve (``err_ref_ba``: the main path's, BA forward), BA
    also to the gate, and is timed in turns with the single-chip solve
    (it/s), with the NCCL calls of one solve.  The solves run MAXIT steps
    at n=128 (``B4`` given) and SHARDED_N64_STEPS at n=64.  The transposed
    layout quantizes B^T per ray, the single-chip path B per pixel: its
    references are the single-chip solve with ``BT_op.T`` (K3 on the same
    int8 B^T) and the host solve with B^T quantized alike, and its gap to
    the production pair is printed.  ``B4``: P's int4 operator of B; when
    given, also the forms of p=4 and p=8 builds, int8 and int4, shard by
    shard (:func:`shard_view_checks`).  Then phase ``sharded_solvers`` on
    the same group and panels (:func:`phase_sharded_solvers`;
    ``gkb_refs``: the GKB phase's float64 histories; its n=128 part when
    ``B4`` is given).  Then phase ``sharded_2d`` on the same group
    (:func:`phase_sharded_2d`; ``tiles``: at n=128 the futures of its
    tiles, :func:`start_tile_builds`).  The group is destroyed at the end
    of the phase.
    Returns the launches of the BA transposed solve, the records, the
    shard_view records, the sharded_solvers records, the launches of their
    R=8 in-loop batch and phase sharded_2d's result."""
    import torch
    import torch.distributed as dist

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import BlockELLOperator
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas, ba_gmres_sharded_pallas, make_mesh,
        shard_bucketed_panels)
    from hybrid_gmres_tpu_torch.parallel.panels import shard_view
    from hybrid_gmres_tpu_torch.problems.ct import (BLOCK_A, BLOCK_B,
                                                    N_BUCKETS)
    from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres

    n = P.n
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        t1 = time.perf_counter()
        BT_csr = P.B_csr.T.tocsr()
        BT_op = BlockELLOperator.from_csr(BT_csr, dtype="int8",
                                          n_buckets=N_BUCKETS,
                                          with_adjoint=False, device="cuda")
        pack = dict(dtype=np.int8, n_buckets=N_BUCKETS)
        A_p, BT_p, B_p = (
            shard_view(shard_bucketed_panels(csr, 1, **pack, **blk), 0,
                       mesh.device)
            for csr, blk in ((P.A_csr, dict(block=BLOCK_A)), (BT_csr, {}),
                             (P.B_csr, dict(block=BLOCK_B))))
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t1
        for built, op in ((A_p, P.A_op), (BT_p, BT_op), (B_p, P.B_op)):
            same_forms(built, op, f"n={n} p=1 shard_bucketed_panels")
        steps = MAXIT if B4 is not None else SHARDED_N64_STEPS
        kw = dict(tol=0.0, maxit=steps, lam=LAM)
        single = {"ba": ba_gmres, "ab": ab_gmres}
        sharded = {"ba": ba_gmres_sharded_pallas,
                   "ab": ab_gmres_sharded_pallas}
        host_ref = {("ba", True): err_ref_ba[:steps]}
        recs, ba_t = [], None
        for kind in ("ba", "ab"):
            for layout in ("transposed", "forward"):
                fwd = layout == "forward"
                label = f"n={n} sharded p=1 {kind} {layout}"
                B_ref = P.B_op if fwd else BT_op.T

                def run_sharded():
                    return sharded[kind](
                        A_p, None if fwd else BT_p, P.b, P.x_true,
                        mesh=mesh, B_panels=B_p if fwd else None, **kw)

                def run_single():
                    return single[kind](P.A_op, B_ref, P.b, P.x_true,
                                        residual="fused", **kw)

                calls0 = dict(mesh.calls)
                reset_counts()
                with HostSyncs() as syncs:
                    r = run_sharded()
                torch.cuda.synchronize()
                launched = counts()
                nccl = {c: mesh.calls[c] - calls0.get(c, 0)
                        for c in mesh.calls}
                k1r, k3r = sharded_launches(kind, fwd, steps)
                want = (0, 0, 0, 0, k1r, k3r, 0, 0, 0)
                check(launched == want, f"{label}: {LAUNCHES} launches "
                      f"{launched}, expected {want}")
                err = r.err_hist.cpu().numpy()
                ref = run_single()
                err_ref = ref.err_hist.cpu().numpy()
                check(tuple(r.x.shape) == (P.A_op.shape[1],) and bool(
                    np.isfinite(err).all() and torch.isfinite(r.x).all()),
                    f"{label}: non-finite or misshaped result")
                check(bool(np.isfinite(err_ref).all() and
                           torch.isfinite(ref.x).all()),
                      f"{label}: the single-chip solve is not finite")
                check(int(r.niters) == steps, f"{label}: niters "
                      f"{int(r.niters)}")
                hist, at_min = held_to(err, err_ref, label,
                                       "the single-chip solve")
                t2 = time.perf_counter()
                if (kind, fwd) not in host_ref:
                    host_ref[kind, fwd] = host_reference(
                        P.prob, P.ray_perm, P.pix_perm, P.b_host, kind=kind,
                        transposed=not fwd, maxit=steps)
                ref_s = time.perf_counter() - t2
                hist64, at_min64 = held_to(err, host_ref[kind, fwd], label,
                                           "the float64 host solve")
                prod = err_ref if fwd else single[kind](
                    P.A_op, P.B_op, P.b, P.x_true, residual="fused",
                    **kw).err_hist.cpu().numpy()
                ms_sh, ms_1 = alternating_ms((run_sharded, run_single), 5)
                its, its1 = (steps / (float(np.median(v)) / 1e3)
                             for v in (ms_sh, ms_1))
                if kind == "ba" and not fwd:
                    ba_t = launched
                rec = dict(
                    n=n, kind=kind, layout=layout, maxit=steps,
                    launches=launched, nccl_calls=nccl,
                    nccl_calls_per_iter=sum(nccl.values()) / steps,
                    host_syncs=syncs.count, iters_per_s=its,
                    single_chip_iters_per_s=its1, ratio=its / its1,
                    solve_ms=ms_sh, single_chip_solve_ms=ms_1,
                    min_err=float(err.min()),
                    single_chip_min_err=float(err_ref.min()),
                    hist_rel_diff=hist, min_rel_diff=at_min,
                    f64_ref_min_err=float(host_ref[kind, fwd].min()),
                    f64_ref_hist_rel_diff=hist64,
                    f64_ref_min_rel_diff=at_min64, f64_ref_s=ref_s,
                    production_pair_min_err=float(prod.min()),
                    gap_to_production_pair=abs(
                        float(err.min()) - float(prod.min()))
                    / float(prod.min()))
                # bench.py's gate is the BA scenario's
                check(kind == "ab" or rec["min_err"] <= GATES[n],
                      f"{label}: min-over-k rel err {rec['min_err']:.4f} > "
                      f"gate {GATES[n]:.4f}")
                say("sharded", **rec)
                recs.append(rec)
        views = None if B4 is None else shard_view_checks(P, B4)
        say("sharded_done", n=n, seconds=time.perf_counter() - t0,
            packing_s=pack_s, panels_mb=dict(
                A=A_p.nbytes / 1e6, BT=BT_p.nbytes / 1e6, B=B_p.nbytes / 1e6))
        solver_recs, batched = phase_sharded_solvers(
            P, mesh, A_p, BT_p, B_p, BT_op, host_ref, gkb_refs,
            main=B4 is not None)
        del A_p, BT_p, B_p
        torch.cuda.empty_cache()
        with PeakMemory(f"n={n} sharded_2d"):
            two_d = phase_sharded_2d(P, BT_op, host_ref, gkb_refs, tiles, B4)
        return ba_t, recs, views, solver_recs, batched, two_d
    finally:
        dist.destroy_process_group()


# The sharded solvers of phase sharded_solvers against their single-chip
# twins on the same matrices: the GMRES-type solvers (RTP, batched) in the
# main path's bands (REF_K, REF_RTOL, REF_MIN_RTOL), also to the float64
# host solve; the GKB solvers over the first GKB_REF_K steps to 1e-3 and
# their minima to GKB_MIN_RTOL (float32 GKB agrees with float64 over ~6
# steps only, so no band is set from the late history).
SHARDED_GKB_BANDS = (GKB_REF_K, 1e-3, GKB_MIN_RTOL)
# The n=64 parts of phases sharded, sharded_solvers and sharded_2d run this
# many steps (n=128: MAXIT), to keep the script inside its time: the bands
# read the first 12 steps and the minimum (k = 6-9).
SHARDED_N64_STEPS = 25
NCCL = ("all_reduce", "all_gather", "reduce_scatter", "shift")


def nccl_since(mesh, before):
    """The mesh's collectives since the counts ``before``, by name."""
    return {c: mesh.calls[c] - before.get(c, 0) for c in NCCL}


def held_columns(err, err_ref, label, what, bands):
    """Every column of a batched history held to the same column of a
    reference; returns the worst gaps."""
    gaps = [held_to(err[:, j], err_ref[:, j], f"{label} column {j}", what,
                    bands) for j in range(err.shape[1])]
    return max(g[0] for g in gaps), max(g[1] for g in gaps)


def sharded_vs_single(label, mesh, run_sh, run_1, want, bands, host=None,
                      gate=None, maxit=MAXIT, phase="sharded_solvers"):
    """One sharded solve with the launch counts and the mesh's collectives
    reset before and read after (the counts checked against ``want``),
    finite and ``maxit`` steps; its error history held to the single-chip
    solve's (``run_1``; column by column for a batched one) and, given
    ``host``, column 0 to the float64 host solve; both timed in turns (5
    each).  ``mesh``: a mesh, or the sub-meshes of a 2-D one by axis name
    (the collectives then counted per axis).  Returns (the record, the
    sharded result)."""
    import torch

    axes = mesh if isinstance(mesh, dict) else {None: mesh}
    calls0 = {a: dict(m.calls) for a, m in axes.items()}
    reset_counts()
    with HostSyncs() as syncs:
        r = run_sh()
    torch.cuda.synchronize()
    launched = counts()
    nccl = {a: nccl_since(m, calls0[a]) for a, m in axes.items()}
    per_iter = {a: sum(c.values()) / maxit for a, c in nccl.items()}
    if None in nccl:
        nccl, per_iter = nccl[None], per_iter[None]
    check(launched == want, f"{label}: {LAUNCHES} launches {launched}, "
          f"expected {want}")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.err_hist).all()
               and torch.isfinite(r.res_hist).all()),
          f"{label}: non-finite results")
    check(bool((r.niters == maxit).all()), f"{label}: niters "
          f"{r.niters.tolist()}")
    ref = run_1()
    err, err_ref = r.err_hist.cpu().numpy(), ref.err_hist.cpu().numpy()
    check(bool(np.isfinite(err_ref).all()), f"{label}: the single-chip "
          "solve is not finite")
    held = held_columns if err.ndim == 2 else held_to
    hist, at_min = held(err, err_ref, label, "the single-chip solve", bands)
    rec = dict(label=label, maxit=maxit, launches=launched, nccl_calls=nccl,
               nccl_calls_per_iter=per_iter,
               host_syncs=syncs.count, min_err=np.min(err, axis=0).tolist(),
               single_chip_min_err=np.min(err_ref, axis=0).tolist(),
               hist_rel_diff=hist, min_rel_diff=at_min)
    if host is not None:
        col0 = err[:, 0] if err.ndim == 2 else err
        rec["f64_hist_rel_diff"], rec["f64_min_rel_diff"] = held_to(
            col0, host, label, "the float64 host solve", bands)
        rec["f64_min_err"] = float(host.min())
    if gate is not None:
        check(float(np.max(np.min(err, axis=0))) <= gate, f"{label}: "
              f"min-over-k errors {rec['min_err']} above the gate {gate}")
    ms_sh, ms_1 = alternating_ms((run_sh, run_1), 5)
    its, its1 = (maxit / (float(np.median(v)) / 1e3) for v in (ms_sh, ms_1))
    rec.update(iters_per_s=its, single_chip_iters_per_s=its1,
               ratio=its / its1, solve_ms=ms_sh, single_chip_solve_ms=ms_1)
    say(phase, **rec)
    return rec, r


def gram_check(G, lam):
    """The float32 Gram solves of AB-RTP, one per step k (the leading k x k
    block plus lam I, padded as ``projected_gram_tikhonov_solve`` pads it):
    how many LU solves report a failure (``info``), the smallest
    eigenvalue of a step's block in float64 (the padding set above every
    eigenvalue, so that the minimum is the block's) and the step where it
    is least, and the Gram's rounding ``eps ||G||``."""
    import torch

    maxit = G.shape[0]
    ks = torch.arange(1, maxit + 1, device=G.device)
    active = torch.arange(maxit, device=G.device)[None, :] < ks[:, None]
    mask = active[:, :, None] & active[:, None, :]
    eye = torch.eye(maxit, dtype=G.dtype, device=G.device)
    norm = float(torch.linalg.matrix_norm(G.double(), ord=2))

    def padded(pad):
        return torch.where(mask, G, torch.zeros((), dtype=G.dtype,
                                                device=G.device)) + \
            lam * eye + pad * torch.diag_embed((~active).to(G.dtype))

    _, info = torch.linalg.solve_ex(padded(1.0), torch.ones(
        (maxit, maxit, 1), dtype=G.dtype, device=G.device))
    eig = torch.linalg.eigvalsh(padded(2 * norm + 1).double()).min(
        dim=1).values
    return dict(lu_failures=int((info != 0).sum()),
                min_eigenvalue=float(eig.min()),
                min_eigenvalue_step=int(eig.argmin()) + 1,
                condition=norm / float(eig.min()),
                rounding=float(torch.finfo(G.dtype).eps) * norm, lam=lam)


def phase_sharded_solvers(P, mesh, A_p, BT_p, B_p, BT_op, host_ref, gkb_refs,
                          main):
    """The rest of the 1-D tier at p=1 on the group and the panels of phase
    ``sharded`` (nothing rebuilt but the adjoint pair).  ``main`` (n=128):
    BA- and AB-RTP, ``lsqr`` and ``hybrid_lsqr`` on the transposed layout,
    ``lsqr`` on ``build_panels_with_adjoint(A, 1, int8)``, the serving
    batch ``ba_gmres_sharded_batched`` (R=8 with the serving noise seeds,
    in-loop and deferred; R=16 in two chunks) and
    ``ab_gmres_sharded_batched`` (R=8 deferred), the NCCL calls of an R=1
    batched solve, and the float32 Gram solves of both AB-RTPs; otherwise
    (n=64) ``lsmr`` and ``hybrid_lsmr``, ``lsqr`` on
    ``ComposedPanels(A, BT, "ba")`` against the single-chip ``lsqr`` on the
    product operator, and the forward layout (``B_panels``) for BA-RTP and
    the R=8 deferred batch, each at SHARDED_N64_STEPS steps.  Each through
    :func:`sharded_vs_single`, its
    launches worked out from the code; ``host_ref``: phase ``sharded``'s
    float64 GMRES histories by (kind, forward); ``gkb_refs``: the GKB
    phase's float64 histories by solver.  Returns (the records, the
    launches of the in-loop R=8 batch at n=128)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import ProductOperator
    from hybrid_gmres_tpu_torch.parallel import (
        ComposedPanels, ab_gmres_rtp_sharded, ab_gmres_sharded_batched,
        ba_gmres_rtp_sharded, ba_gmres_sharded_batched,
        build_panels_with_adjoint, hybrid_lsmr_sharded, hybrid_lsqr_sharded,
        lsmr_sharded, lsqr_sharded)
    from hybrid_gmres_tpu_torch.parallel.panels import shard_view
    from hybrid_gmres_tpu_torch.problems.ct import BLOCK_A, N_BUCKETS
    from hybrid_gmres_tpu_torch.solvers.batched import (ab_gmres_batched,
                                                        ba_gmres_batched)
    from hybrid_gmres_tpu_torch.utils.device import full_float32_matmul

    n, t0 = P.n, time.perf_counter()
    steps = MAXIT if main else SHARDED_N64_STEPS
    recs, out = [], {}
    gmres_kw = dict(tol=0.0, maxit=steps, lam=LAM)
    gkb = dict(lsqr=lsqr_sharded, hybrid_lsqr=hybrid_lsqr_sharded,
               lsmr=lsmr_sharded, hybrid_lsmr=hybrid_lsmr_sharded)
    rtp = dict(ba_gmres_rtp=ba_gmres_rtp_sharded,
               ab_gmres_rtp=ab_gmres_rtp_sharded)
    batched = dict(ba=(ba_gmres_sharded_batched, ba_gmres_batched),
                   ab=(ab_gmres_sharded_batched, ab_gmres_batched))

    def rtp_case(name, forward):
        label = f"n={n} {name}_sharded p=1 " + ("forward" if forward
                                                 else "transposed")
        k1r, k3r = sharded_launches("ba", forward, steps)
        host = host_reference_rtp(P, name, RTP_REF_STEPS,
                                  transposed=not forward)
        rec, r = sharded_vs_single(
            label, mesh,
            lambda: rtp[name](A_p, None if forward else BT_p, P.b, P.x_true,
                              mesh=mesh, B_panels=B_p if forward else None,
                              **gmres_kw),
            lambda: rtp_solver(name)(P.A_op, P.B_op if forward else BT_op.T,
                                     P.b, P.x_true, **gmres_kw),
            (0, 0, 0, 0, k1r, k3r, 0, 0, 0), None, host=host, maxit=steps)
        recs.append(rec)
        return r

    def batched_case(kind, b, defer, forward=False):
        R = b.shape[1]
        chunks = -(-R // 8)
        label = (f"n={n} {kind}_gmres_sharded_batched p=1 R={R} "
                 + ("deferred" if defer else "in-loop")
                 + (" forward" if forward else ""))
        sh, single = batched[kind]
        if forward:
            k2r, k4r = 2 * steps + 1, 0
        else:
            k2r, k4r = steps, steps + (kind == "ba")
        rec, r = sharded_vs_single(
            label, mesh,
            lambda: sh(A_p, None if forward else BT_p, b, P.x_true,
                       mesh=mesh, B_panels=B_p if forward else None,
                       defer_histories=defer, **gmres_kw),
            lambda: single(P.A_op, P.B_op if forward else BT_op.T, b,
                           P.x_true, defer_histories=defer, **gmres_kw),
            (0, 0, 0, 0, 0, 0, chunks * k2r, chunks * k4r, 0), None,
            host=host_ref[kind, forward], gate=SERVING_GATES[n]
            if kind == "ba" else None, maxit=steps)
        recs.append(rec)
        return rec

    def gkb_case(name, A, A_single, rhs, want, x_true=P.x_true, host=None,
                 tag=""):
        label = f"n={n} {name}_sharded p=1{tag}"
        kw = dict(tol=0.0, maxit=steps)
        if "hybrid" in name:
            kw["lam"] = LAM
        fn, _ = gkb_solver(name)
        rec, r = sharded_vs_single(
            label, mesh, lambda: gkb[name](A, rhs, x_true, mesh=mesh, **kw),
            lambda: fn(A_single, rhs, x_true, **kw),
            (0, 0, 0, 0) + want + (0, 0, 0), SHARDED_GKB_BANDS, host=host,
            maxit=steps)
        recs.append(rec)

    if main:
        for name in RTP_SOLVERS:
            r = rtp_case(name, False)
            if name == "ab_gmres_rtp":
                # the Gram solves the port runs in float32: of the sharded
                # solve (its images, reduced over the mesh) and of the
                # single-chip one (A Q of its basis), as the solvers form
                # them
                r1 = rtp_solver(name)(P.A_op, BT_op.T, P.b, P.x_true,
                                      **gmres_kw)
                with full_float32_matmul():
                    G_sh = mesh.all_reduce(r.IMG.T @ r.IMG)
                    AQ = P.A_op.matmat(r1.Q[:, :steps])
                    G_1 = AQ.T @ AQ
                out["ab_rtp_gram"] = dict(sharded=gram_check(G_sh, LAM),
                                          single_chip=gram_check(G_1, LAM))
                say("sharded_solvers_gram", n=n, **out["ab_rtp_gram"])
                del AQ, G_1, G_sh, r1
        for name in ("lsqr", "hybrid_lsqr"):
            gkb_case(name, A_p, P.A_op, P.b, gkb_launches(name, steps),
                     host=gkb_refs.get(name))
        t1 = time.perf_counter()
        pair = build_panels_with_adjoint(
            P.A_csr, 1, block=BLOCK_A, dtype=np.int8, n_buckets=N_BUCKETS)
        out["adjoint_pair_build_s"] = time.perf_counter() - t1
        pair = shard_view(pair, 0, mesh.device)
        same_forms(pair.A, P.A_op, f"n={n} build_panels_with_adjoint A")
        out["adjoint_pair_mb"] = pair.nbytes / 1e6
        gkb_case("lsqr", pair, P.A_op, P.b,
                 (sum(gkb_launches("lsqr", steps)), 0),
                 host=gkb_refs.get("lsqr"), tag=" PanelsWithAdjoint int8")
        del pair
        b_host = noisy_sinograms(P, range(16))
        b16 = torch.as_tensor(b_host, device=P.device)
        b8 = b16[:, :8].contiguous()
        # the gather each shard call takes (ops/spmv_cuda.py:_gather_for):
        # the window comes in the basis layout, K4 reads the scaled basis
        probe = b8.T.contiguous().T
        out["gathers"] = dict(
            k2r_A=routed_gather(A_p.shards[0].fwd_rows, probe),
            k4r_BT=routed_gather(BT_p.shards[0].adj_rows, probe,
                                 scaled=True))
        in_loop = batched_case("ba", b8, False)
        batched_case("ba", b8, True)
        batched_case("ba", b16, True)
        batched_case("ab", b8, True)
        # the collectives of an R=1 solve: the batched ones' count
        calls0 = dict(mesh.calls)
        ba_gmres_sharded_batched(A_p, BT_p, b8[:, :1], P.x_true, mesh=mesh,
                                 **gmres_kw)
        torch.cuda.synchronize()
        one = nccl_since(mesh, calls0)
        check(one == in_loop["nccl_calls"], f"n={n}: the NCCL calls of the "
              f"R=8 batch {in_loop['nccl_calls']} differ from R=1's {one}")
        out["nccl_calls_R1"] = one
        out["batched_launches"] = in_loop["launches"]
    else:
        for name in ("lsmr", "hybrid_lsmr"):
            gkb_case(name, A_p, P.A_op, P.b, gkb_launches(name, steps),
                     host=gkb_refs.get(name))
        # M = B A with B through K3 on B^T's shard (rhs d = B b): each of
        # M's products one K1r and one K3r
        d = BT_op.rmatvec(P.b)
        gkb_case("lsqr", ComposedPanels(A_p, BT_p, "ba"),
                 ProductOperator(BT_op.T, P.A_op), d,
                 (2 * (steps + 1), 2 * (steps + 1)), tag=" ComposedPanels ba")
        rtp_case("ba_gmres_rtp", True)
        batched_case("ba", torch.as_tensor(noisy_sinograms(P, range(8)),
                                           device=P.device), True,
                     forward=True)
    out["seconds"] = time.perf_counter() - t0
    say("sharded_solvers_done", n=n, **out)
    return recs, out.get("batched_launches")


def same_forms(view, op, label):
    """A single-shard (or single-tile) view holds the operator's forms and
    row scales, bit for bit."""
    import torch

    sh = view.shards[0] if hasattr(view, "shards") else view.tiles[0]
    for fa, fb in ((sh.fwd_rows, op.fwd_rows), (sh.adj_rows, op.adj_rows)):
        check(same_form(fa, fb), f"{label}: the forms differ from the "
              "operator's")
    check(torch.equal(sh.row_scale, op.fwd_scale), f"{label}: row scales")


def shard_view_checks(P, B4, R=8):
    """The forms of p=4 and p=8 builds of B (int8, and int4 as ``B4``
    holds it), one shard at a time on the card through ``shard_view`` and
    ``host_window_x``: each shard's K1 and K3 against their plain versions,
    the concatenated K1 outputs against the single-chip ``matvec`` and the
    scattered K3 partials summed against ``rmatvec``; the same with the
    multi-RHS primitives at ``R`` columns in the batched solvers' layout
    (``local_matmat``, K2; ``local_rmatmat_window``, K4): against their
    plain versions, column j bit-equal to ``local_matvec`` /
    ``local_rmatvec_window`` on column j, concatenated against ``matmat``
    and the partials placed by ``scatter_window_to_full_mat`` and summed
    against ``rmatmat``; each shard's K2r/K4r call timed (µs, CUDA events)
    beside the single-chip K2r/K4r on the whole matrix.  B rather than A:
    the same kernels on 11.8M instead of 26.4M entries, half the host
    packing.  Returns a record per build."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        row_matmat_plain, row_matvec_plain, row_rmatmat_plain,
        row_rmatvec_plain)
    from hybrid_gmres_tpu_torch.parallel import shard_bucketed_panels
    from hybrid_gmres_tpu_torch.parallel.panels import (
        host_window_x, local_matmat, local_matvec, local_rmatmat_window,
        local_rmatvec_window, scatter_window_to_full,
        scatter_window_to_full_mat, shard_view)
    from hybrid_gmres_tpu_torch.problems.ct import BLOCK_B, N_BUCKETS

    rng = np.random.default_rng(8)
    m, n = P.B_op.shape
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=P.device)
    u = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                        device=P.device)
    # (space, R) as the transposed views of (R, space) tensors: the layout
    # of the batched solvers' basis columns and of gather_window_mat
    X = torch.as_tensor(rng.standard_normal((R, n)), dtype=torch.float32,
                        device=P.device).T
    U = torch.as_tensor(rng.standard_normal((R, m)), dtype=torch.float32,
                        device=P.device).T
    out = []
    for dtype, op in (("int8", P.B_op), ("int4", B4)):
        y_ref, z_ref = op.matvec(x), op.rmatvec(u)
        Y_ref, Z_ref = op.matmat(X), op.rmatmat(U)
        single_us = dict(k2r=time_ms(lambda: op.matmat(X), reps=20) * 1e3,
                         k4r=time_ms(lambda: op.rmatmat(U), reps=20) * 1e3)
        for p in (4, 8):
            t0 = time.perf_counter()
            sp_ = shard_bucketed_panels(
                P.B_csr, p, block=BLOCK_B, n_buckets=N_BUCKETS,
                dtype=np.int8 if dtype == "int8" else "int4")
            build_s = time.perf_counter() - t0
            mloc = m // p
            ys, z, Ys = [], torch.zeros(n, device=P.device), []
            Z = torch.zeros((n, R), device=P.device)
            worst = worst_mm = 0.0
            columns_equal = True
            shard_us = dict(k2r=[], k4r=[])
            gathers = dict(k2r=[], k4r=[])
            for i in range(p):
                view = shard_view(sp_, i, P.device)
                shard = view.shards[0]
                xw = host_window_x(sp_, i, x)
                ui = u[i * mloc:(i + 1) * mloc]
                yi = local_matvec(view, xw)
                zi = local_rmatvec_window(view, ui)
                worst = max(
                    worst, rel_err(yi, row_matvec_plain(
                        shard.fwd_rows, xw, shard.row_scale)),
                    rel_err(zi, row_rmatvec_plain(
                        shard.adj_rows, ui, shard.row_scale)))
                ys.append(yi)
                z += scatter_window_to_full(view, zi)
                Xw = host_window_x(sp_, i, X).T.contiguous().T
                Ui = U[i * mloc:(i + 1) * mloc]
                Yi = local_matmat(view, Xw)
                Zi = local_rmatmat_window(view, Ui)
                worst_mm = max(
                    worst_mm, rel_err(Yi, row_matmat_plain(
                        shard.fwd_rows, Xw, shard.row_scale)),
                    rel_err(Zi, row_rmatmat_plain(
                        shard.adj_rows, Ui, shard.row_scale)))
                for j in range(R):
                    columns_equal &= bool(
                        torch.equal(Yi[:, j], local_matvec(
                            view, Xw[:, j].contiguous()))
                        and torch.equal(Zi[:, j], local_rmatvec_window(
                            view, Ui[:, j].contiguous())))
                Ys.append(Yi)
                Z += scatter_window_to_full_mat(view, Zi)
                gathers["k2r"].append(routed_gather(shard.fwd_rows, Xw))
                gathers["k4r"].append(routed_gather(shard.adj_rows, Ui,
                                                    scaled=True))
                shard_us["k2r"].append(time_ms(
                    lambda: local_matmat(view, Xw), reps=20) * 1e3)
                shard_us["k4r"].append(time_ms(
                    lambda: local_rmatmat_window(view, Ui), reps=20) * 1e3)
                del view, shard
            torch.cuda.synchronize()
            label = f"n={P.n} B {dtype} p={p} shard_view"
            check(worst <= KERNEL_RTOL, f"{label}: a shard's kernel vs "
                  f"plain {worst:.3e}")
            check(worst_mm <= KERNEL_RTOL, f"{label}: a shard's K2r/K4r vs "
                  f"plain {worst_mm:.3e}")
            check(columns_equal, f"{label}: a column of K2r/K4r differs "
                  "from K1r/K3r on that column")
            ey, ez = rel_err(torch.cat(ys), y_ref), rel_err(z, z_ref)
            check(max(ey, ez) <= KERNEL_RTOL, f"{label}: shards against the "
                  f"single-chip products {ey:.3e} (A x), {ez:.3e} (A^T u)")
            eY, eZ = rel_err(torch.cat(Ys), Y_ref), rel_err(Z, Z_ref)
            check(max(eY, eZ) <= KERNEL_RTOL, f"{label}: R={R} shards "
                  f"against the single-chip products {eY:.3e} (A X), "
                  f"{eZ:.3e} (A^T U)")
            rec = dict(n=P.n, dtype=dtype, p=p, windowed=sp_.windowed,
                       shifts=list(sp_.shifts), build_s=build_s,
                       forms_mb=sp_.nbytes / 1e6,
                       shard_vs_plain_max_rel=worst, concat_vs_matvec=ey,
                       scatter_vs_rmatvec=ez, R=R,
                       shard_mm_vs_plain_max_rel=worst_mm,
                       columns_bit_equal=columns_equal,
                       concat_vs_matmat=eY, scatter_vs_rmatmat=eZ,
                       shard_us=shard_us, single_chip_us=single_us,
                       gathers=gathers)
            say("shard_view", **rec)
            out.append(rec)
    return out


# Phase sharded_2d: the grids of the tile checks, and the worker processes
# that pack the n=128 tiles while phase sharded packs its panels (a build of
# n=128 A takes ~20 s on the host, of B ~10 s: seven builds in the
# foreground would take the phase past its 90 s).
TILE_GRIDS = ((2, 2), (4, 2))
TILE_WORKERS = 2


def build_tiles(name, csr, grid, kw):
    """One job of the tile pool (a worker process): ``parallel.<name>(csr,
    *grid, **kw)`` on the host, pickled with its build seconds."""
    import pickle

    import torch

    import hybrid_gmres_tpu_torch.parallel as par

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    tiles = getattr(par, name)(csr, *grid, **kw)
    return pickle.dumps((tiles, time.perf_counter() - t0))


def start_tile_builds(P):
    """A pool of TILE_WORKERS spawned processes and the futures of phase
    sharded_2d's n=128 tiles: the (1, 1) tiles of A, B^T and the forward
    tiles of B (the operators' packing: int8, their blocks), and the int8
    and int4 tiles of B on TILE_GRIDS.  Started after the n=128 kernel
    phases (whose times the pool would share the host with) and just
    before phase sharded, so that the packing runs beside that phase's own
    packing; the caller shuts the pool down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from hybrid_gmres_tpu_torch.problems.ct import (BLOCK_A, BLOCK_B,
                                                    N_BUCKETS)

    pack = dict(dtype=np.int8, n_buckets=N_BUCKETS)
    jobs = {"A": ("tile_bucketed_panels", P.A_csr, (1, 1),
                  dict(pack, block=BLOCK_A)),
            "BT": ("tile_bucketed_panels", P.B_csr.T.tocsr(), (1, 1),
                   pack),
            "B": ("tile_backprojector_forward", P.B_csr, (1, 1),
                  dict(pack, block=BLOCK_B))}
    for dtype in ("int8", "int4"):
        for grid in TILE_GRIDS:
            jobs[dtype, grid] = ("tile_bucketed_panels", P.B_csr, grid,
                                 dict(pack, block=BLOCK_B, dtype=np.int8
                                      if dtype == "int8" else "int4"))
    pool = ProcessPoolExecutor(TILE_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        return pool, {k: pool.submit(build_tiles, *job)
                      for k, job in jobs.items()}
    except BaseException:
        pool.shutdown(wait=True, cancel_futures=True)
        raise


def tiles_of(future):
    """(tiles, build seconds) of a pool job; waits for it."""
    import pickle

    return pickle.loads(future.result(timeout=600))


def phase_sharded_2d(P, BT_op, host_ref, gkb_refs, tiles=None, B4=None):
    """The 2-D tier on the one-rank group as a (1, 1) mesh
    (``make_mesh_2d``: both per-axis groups are that group).  ``tiles``
    (n=128): the pool's futures (:func:`start_tile_builds`); the (1, 1)
    tiles of A, B^T and B put on the card once by ``tile_view`` and held
    bit-equal to the operators' forms; BA (transposed and forward) and AB,
    ``lsqr`` and ``hybrid_lsqr``, the R=8 deferred serving batch, then
    the tile checks of B (:func:`tile_checks`).  Otherwise (n=64,
    SHARDED_N64_STEPS steps): ``lsmr`` and ``hybrid_lsmr`` on a (1, 1)
    tile of A packed here, and the dense BA on the float32 matrices.
    Each through :func:`sharded_vs_single` with its collectives counted per
    axis, against the single-chip solve of the same matrices and
    ``host_ref`` (phase sharded's float64 GMRES histories by (kind,
    forward)) or ``gkb_refs``.  Returns (the records, the tile-check
    records, the launches of the BA transposed solve and of the batch)."""
    import torch

    from hybrid_gmres_tpu_torch.ops.linear_operator import DenseOperator
    from hybrid_gmres_tpu_torch.parallel import (
        ab_gmres_sharded_pallas_2d, ba_gmres_sharded_2d,
        ba_gmres_sharded_batched_2d, ba_gmres_sharded_pallas_2d,
        hybrid_lsmr_sharded_2d, hybrid_lsqr_sharded_2d, lsmr_sharded_2d,
        lsqr_sharded_2d, make_mesh_2d, shard_problem_2d,
        tile_bucketed_panels, tile_view)
    from hybrid_gmres_tpu_torch.problems.ct import BLOCK_A, N_BUCKETS
    from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched
    from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres

    n, t0 = P.n, time.perf_counter()
    main = tiles is not None
    steps = MAXIT if main else SHARDED_N64_STEPS
    mesh = make_mesh_2d((1, 1))
    axes = {a: mesh.axis(a) for a in mesh.axis_names}
    recs, out = [], {}
    gm = dict(tol=0.0, maxit=steps, lam=LAM)

    def case(label, run_sh, run_1, want, bands=None, host=None, gate=None):
        rec, r = sharded_vs_single(
            f"n={n} {label} (1,1)", axes, run_sh, run_1,
            (0, 0, 0, 0) + tuple(want) + (0,), bands, host=host, gate=gate,
            maxit=steps, phase="sharded_2d")
        recs.append(rec)
        return rec

    def gkb_case(name, A_t):
        fn2 = dict(lsqr=lsqr_sharded_2d, hybrid_lsqr=hybrid_lsqr_sharded_2d,
                   lsmr=lsmr_sharded_2d,
                   hybrid_lsmr=hybrid_lsmr_sharded_2d)[name]
        fn, kw = gkb_solver(name)
        kw = dict(kw, tol=0.0, maxit=steps)
        case(f"{name}_sharded_2d",
             lambda: fn2(A_t, P.b, P.x_true, mesh=mesh, **kw),
             lambda: fn(P.A_op, P.b, P.x_true, **kw),
             gkb_launches(name, steps) + (0, 0), SHARDED_GKB_BANDS,
             host=gkb_refs.get(name))

    if main:
        t1 = time.perf_counter()
        built = {k: tiles_of(f) for k, f in tiles.items()}
        out["tiles_wait_s"] = time.perf_counter() - t1
        out["build_s"] = {str(k): v[1] for k, v in built.items()}
        A_t, BT_t, B_t = (tile_view(built[k][0], 0, 0, mesh.device)
                          for k in ("A", "BT", "B"))
        torch.cuda.synchronize()
        for view, op, what in ((A_t, P.A_op, "A"), (BT_t, BT_op, "B^T"),
                               (B_t, P.B_op, "B forward")):
            same_forms(view, op, f"n={n} (1,1) tiles of {what}")
        out["tiles_mb"] = dict(A=A_t.nbytes / 1e6, BT=BT_t.nbytes / 1e6,
                               B=B_t.nbytes / 1e6)
        for kind, fwd in (("ba", False), ("ba", True), ("ab", False)):
            fn = dict(ba=ba_gmres_sharded_pallas_2d,
                      ab=ab_gmres_sharded_pallas_2d)[kind]
            single = dict(ba=ba_gmres, ab=ab_gmres)[kind]
            B_ref = P.B_op if fwd else BT_op.T
            rec = case(
                f"{kind}_gmres_sharded_pallas_2d "
                + ("forward" if fwd else "transposed"),
                lambda: fn(A_t, None if fwd else BT_t, P.b, P.x_true,
                           mesh=mesh, B_tiles=B_t if fwd else None, **gm),
                lambda: single(P.A_op, B_ref, P.b, P.x_true,
                               residual="fused", **gm),
                sharded_launches(kind, fwd, steps) + (0, 0),
                host=host_ref[kind, fwd],
                gate=GATES[n] if kind == "ba" else None)
            if (kind, fwd) == ("ba", False):
                out["ba_launches"] = rec["launches"]
        for name in ("lsqr", "hybrid_lsqr"):
            gkb_case(name, A_t)
        b8 = torch.as_tensor(noisy_sinograms(P, range(8)), device=P.device)
        rec = case(
            "ba_gmres_sharded_batched_2d R=8 deferred",
            lambda: ba_gmres_sharded_batched_2d(
                A_t, BT_t, b8, P.x_true, mesh=mesh, defer_histories=True,
                **gm),
            lambda: ba_gmres_batched(P.A_op, BT_op.T, b8, P.x_true,
                                     defer_histories=True, **gm),
            (0, 0, steps, steps + 1), host=host_ref["ba", False],
            gate=SERVING_GATES[n])
        out["batched_launches"] = rec["launches"]
        del A_t, BT_t, B_t
        checks = tile_checks(P, B4, {k: v for k, v in built.items()
                                     if k not in ("A", "BT", "B")})
    else:
        t1 = time.perf_counter()
        A_t = tile_view(tile_bucketed_panels(
            P.A_csr, 1, 1, block=BLOCK_A, dtype=np.int8,
            n_buckets=N_BUCKETS), 0, 0, mesh.device)
        out["build_s"] = {"A": time.perf_counter() - t1}
        same_forms(A_t, P.A_op, f"n={n} (1,1) tiles of A")
        for name in ("lsmr", "hybrid_lsmr"):
            gkb_case(name, A_t)
        del A_t
        # the dense blocks of the float32 matrices the panels were packed
        # from: at (1, 1) each block is a whole matrix (two ~530 MB arrays)
        A2, B2, b2 = shard_problem_2d(
            torch.from_numpy(P.A_csr.toarray()),
            torch.from_numpy(P.B_csr.toarray()), P.b, mesh)
        case("ba_gmres_sharded_2d dense",
             lambda: ba_gmres_sharded_2d(A2, B2, b2, P.x_true, mesh=mesh,
                                         **gm),
             lambda: ba_gmres(DenseOperator(A2), DenseOperator(B2), P.b,
                              P.x_true, residual="fused", **gm),
             (0,) * 4, gate=GATES[n])
        del A2, B2
        checks = None
    out["seconds"] = time.perf_counter() - t0
    say("sharded_2d_done", n=n, **out)
    return recs, checks, out.get("ba_launches"), out.get("batched_launches")


def tile_checks(P, B4, built, R=8):
    """The int8 (``P.B_op``) and int4 (``B4``) tiles of B on TILE_GRIDS
    (``built``: (dtype, grid) -> (tiles, build seconds)), one tile at a time
    on the card through ``tile_view``: each tile's K1r/K3r (``tile_matvec``,
    ``tile_rmatvec`` with the scales gathered beside u) and K2r/K4r at R
    columns in the solvers' layout against their plain versions, column j
    of K2r/K4r bit-equal to K1r/K3r on column j; the partials summed over
    the axis on the host and the forward sums scaled by the row scales,
    against the single-chip ``matvec``/``rmatvec``/``matmat``/``rmatmat``;
    each tile's four calls timed (µs, CUDA events) and summed beside the
    single-chip calls.  Returns a record per build."""
    import torch

    from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
        row_matmat_plain, row_matvec_plain, row_rmatmat_plain,
        row_rmatvec_plain)
    from hybrid_gmres_tpu_torch.parallel.panels2d import (
        tile_matmat, tile_matvec, tile_rmatmat, tile_rmatvec, tile_view)

    rng = np.random.default_rng(9)
    m, n = P.B_op.shape
    dev = P.device
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=dev)
    u = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                        device=dev)
    X = torch.as_tensor(rng.standard_normal((R, n)), dtype=torch.float32,
                        device=dev).T
    U = torch.as_tensor(rng.standard_normal((R, m)), dtype=torch.float32,
                        device=dev).T
    out = []
    for dtype, op in (("int8", P.B_op), ("int4", B4)):
        want = (op.matvec(x), op.rmatvec(u), op.matmat(X), op.rmatmat(U))
        single_us = dict(zip(("k1r", "k3r", "k2r", "k4r"), (
            time_ms(lambda: op.matvec(x), reps=20) * 1e3,
            time_ms(lambda: op.rmatvec(u), reps=20) * 1e3,
            time_ms(lambda: op.matmat(X), reps=20) * 1e3,
            time_ms(lambda: op.rmatmat(U), reps=20) * 1e3)))
        for grid in TILE_GRIDS:
            tp, build_s = built[dtype, grid]
            pr, pc = grid
            mloc, nloc = m // pr, n // pc
            got = [torch.zeros_like(w) for w in want]
            worst, equal = 0.0, True
            tile_us = dict(k1r=[], k3r=[], k2r=[], k4r=[])
            scales = []
            for i in range(pr):
                for j in range(pc):
                    view = tile_view(tp, i, j, dev)
                    t = view.tiles[0]
                    s = t.row_scale
                    if j == 0:
                        scales.append(s)
                    xs, us = x[j * nloc:(j + 1) * nloc], u[i * mloc:
                                                            (i + 1) * mloc]
                    Xs = X[j * nloc:(j + 1) * nloc]
                    Us = U[i * mloc:(i + 1) * mloc]
                    calls = dict(
                        k1r=lambda: tile_matvec(view, xs),
                        k3r=lambda: tile_rmatvec(view, us, s),
                        k2r=lambda: tile_matmat(view, Xs),
                        k4r=lambda: tile_rmatmat(view, Us, s))
                    parts = [calls[k]() for k in ("k1r", "k3r", "k2r",
                                                  "k4r")]
                    plains = (row_matvec_plain(t.fwd_rows, xs),
                              row_rmatvec_plain(t.adj_rows, us, s),
                              row_matmat_plain(t.fwd_rows, Xs),
                              row_rmatmat_plain(t.adj_rows, Us, s))
                    worst = max([worst] + [rel_err(a, b) for a, b in
                                           zip(parts, plains)])
                    for c in range(R):
                        equal &= bool(
                            torch.equal(parts[2][:, c], tile_matvec(
                                view, Xs[:, c].contiguous()))
                            and torch.equal(parts[3][:, c], tile_rmatvec(
                                view, Us[:, c].contiguous(), s)))
                    got[0][i * mloc:(i + 1) * mloc] += parts[0]
                    got[1][j * nloc:(j + 1) * nloc] += parts[1]
                    got[2][i * mloc:(i + 1) * mloc] += parts[2]
                    got[3][j * nloc:(j + 1) * nloc] += parts[3]
                    for k, fn in calls.items():
                        tile_us[k].append(time_ms(fn, reps=20) * 1e3)
                    del view, t, plains, parts
            s_all = torch.cat(scales)
            got[0] *= s_all
            got[2] *= s_all[:, None]
            torch.cuda.synchronize()
            gaps = [rel_err(g, w) for g, w in zip(got, want)]
            label = f"n={P.n} B {dtype} tiles {pr}x{pc}"
            check(worst <= KERNEL_RTOL, f"{label}: a tile's kernel vs plain "
                  f"{worst:.3e}")
            check(equal, f"{label}: a column of K2r/K4r differs from K1r/K3r "
                  "on that column")
            check(max(gaps) <= KERNEL_RTOL, f"{label}: the summed partials "
                  f"against the single-chip products {gaps}")
            rec = dict(n=P.n, dtype=dtype, grid=list(grid), R=R,
                       build_s=build_s, forms_mb=tp.nbytes / 1e6,
                       tile_vs_plain_max_rel=worst, columns_bit_equal=equal,
                       sums_vs_single_chip=dict(zip(
                           ("matvec", "rmatvec", "matmat", "rmatmat"), gaps)),
                       tile_us=tile_us,
                       tile_us_sum={k: sum(v) for k, v in tile_us.items()},
                       single_chip_us=single_us)
            say("tile_checks", **rec)
            out.append(rec)
            del tp
        torch.cuda.empty_cache()
    return out


def kernel_record(name, source, replaces, launches, path_recs, other_recs,
                  superseded_by=None, bound_fn=bound, **extra):
    """One entry of the ``kernels`` line.  ``ms``, ``plain_ms``,
    ``library_ms`` and ``bound_ms`` are this kernel's work in one iteration
    of its n=64 path (``path_recs``: A's panel then B's for BA-GMRES, A's
    panel for the GKB solvers); every panel, n=128 included, is listed in
    ``shapes`` with the same keys.  ``superseded_by``: the kernel that runs
    this one's products on the paths now (its own ``launches`` are then
    those of the path's run: 0).  ``bound_fn``: :func:`bound` (float32
    FMA) or :func:`tc_bound` (the tensor cores)."""
    b_ms, b_by = bound_fn([s["work"] for s in path_recs])
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, on_path=superseded_by is None,
        superseded_by=superseded_by,
        max_abs_err=max(s["max_abs_err"] for s in path_recs + other_recs),
        ms=sum(s["ms"] for s in path_recs),
        plain_ms=sum(s["plain_ms"] for s in path_recs),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=sum(s["library_ms"] for s in path_recs),
        shapes=path_recs + other_recs, **extra)


def phase_lambda_path(P, full):
    """The lambda-choice path at one size: the RTP solvers, then (``full``)
    the last branches of gmres_core, the restarted wrappers, every lambda
    selector and the three experiment drivers; otherwise the n=128 subset
    (``phase_lambda_choice``).  Returns the RTP solvers' launches."""
    rtp = phase_rtp(P, P.ptr_min, full)
    if full:
        phase_gmres_options(P, tf32=True)
        phase_restarted(P)
    phase_lambda_choice(P, full=full)
    if full:
        phase_drivers()
    return rtp


def main():
    card = phase_device()
    import torch

    phase_build()
    if "--windows" in sys.argv[1:]:      # a short call: the window kernel
        for n in (64, 128):
            P = make_problem(n)
            window_kernels(P, P, "int8", int8_library)
            P4 = int4_operators(P)
            window_kernels(P, P4, "int4", int4_library)
            del P4
            from hybrid_gmres_tpu_torch.problems.ct import ct_gpu_operators

            for dt in FLOAT_DTYPES:
                A_f, B_f = ct_gpu_operators(P.prob, dtype=dt)[:2]
                window_kernels(P, SimpleNamespace(
                    A_op=A_f, B_op=B_f, A_adj=None, B_adj=None), dt,
                    float_library)
                del A_f, B_f
                torch.cuda.empty_cache()
            del P
            drop_libraries()
        say("stopped", after="windows")
        return
    if "--sharded" in sys.argv[1:]:      # a short call: the sharded phases
        for n in (64, 128):
            P = make_problem(n)
            pool, tiles = start_tile_builds(P) if n == 128 else (None, None)
            ref0 = host_reference(P.prob, P.ray_perm, P.pix_perm, P.b_host)
            refs = {name: host_reference_gkb(P, name, P.b_host)
                    for name in (GKB_SINGLE if n == 64 else ("lsqr",))}
            phase_sharded(P, ref0, refs,
                          int4_operators(P).B_op if n == 128 else None,
                          tiles)
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
            del P
            torch.cuda.empty_cache()
        say("stopped", after="sharded")
        return
    if "--float" in sys.argv[1:]:        # a short call: float_forms, entry
        for n in (64, 128):
            builds = start_float_builds(n)
            P = make_problem(n)
            fjobs = float_results(builds)
            phase_float_forms(P, fjobs)
            if n == 64:
                phase_entry()
            del P
            torch.cuda.empty_cache()
        say("stopped", after="float")
        return
    # phase float_forms' operators and float64 host solves are made by
    # worker processes beside each size's own packing
    builds = start_float_builds(64)
    P = make_problem(64, adjoint=True)
    fjobs_64 = float_results(builds)
    k1_64, k2_64, k3_64, k4_64, k1r_64, k3r_64, k2r_64, k4r_64 = \
        phase_ct_kernels(P)
    wk_64 = window_kernels(P, P, "int8", int8_library)
    lmm_64, sweep_64 = lambda_mm_kernels(P)
    phase_small_kernels()
    if "--kernels" in sys.argv[1:]:      # a short call: builds and kernels
        P4 = int4_operators(P)
        int4_kernels(P, P4)
        window_kernels(P, P4, "int4", int4_library)
        lambda_mm_kernels(P4, "int4")
        int4_wide_path(P4)
        del P, P4
        drop_libraries()
        P = make_problem(128, adjoint=True)
        phase_ct_kernels(P)
        window_kernels(P, P, "int8", int8_library)
        lambda_mm_kernels(P)
        P4 = int4_operators(P)
        int4_kernels(P, P4)
        window_kernels(P, P4, "int4", int4_library)
        lambda_mm_kernels(P4, "int4")
        say("stopped", after="kernels")
        return
    release_plain_caches(P)
    drop_libraries()
    phase_small_reference()
    with PeakMemory("n=64 main path", (P.A_op, P.B_op)):
        main_launches, its, ref0 = phase_main_path(P)
    with PeakMemory("n=64 serving", (P.A_op, P.B_op)):
        serving_launches = phase_serving(P, its, ref0, full=True)
    with PeakMemory("n=64 GKB", (P.A_op, P.B_op)):
        gkb = phase_gkb_path(P, GKB_SINGLE, gcv=True)
        gkb_b = phase_gkb_serving(P, GKB_BATCHED,
                                  {k: v[2] for k, v in gkb.items()},
                                  full=True)
    lsqr_launches = gkb["lsqr"][0]
    lsqr_b_launches = gkb_b["lsqr_batched"]
    with PeakMemory("n=64 lambda path", (P.A_op, P.B_op)):
        rtp_64 = phase_lambda_path(P, full=True)
    t0 = time.perf_counter()
    P4 = int4_operators(P, refs=True)
    k1i4_64, k3i4_64, k2i4_64, k4i4_64 = int4_kernels(P, P4)
    wk4_64 = window_kernels(P, P4, "int4", int4_library)
    lmm4_64, sweep4_64 = lambda_mm_kernels(P4, "int4")
    wide4_launches = int4_wide_path(P4)
    release_plain_caches(P4)
    drop_libraries()
    int4_launches = phase_variant_path(P, P4, full=True)
    del P4
    say("int4_done", n=64, seconds=time.perf_counter() - t0)
    float_64 = phase_float_forms(P, fjobs_64)
    entry_launches = phase_entry()
    with PeakMemory("n=64 sharded"):
        sharded_launches_64, sharded_64, _, solvers_64, _, two_d_64 = \
            phase_sharded(P, ref0, {k: v[2] for k, v in gkb.items()})
    host = (P.prob, P.ray_perm, P.pix_perm)
    del P
    torch.cuda.empty_cache()
    phantom_launches = phase_drivers_rest(*host)
    builds = start_float_builds(128)
    P = make_problem(128, adjoint=True)
    fjobs_128 = float_results(builds)
    k1_128, k2_128, k3_128, k4_128, k1r_128, k3r_128, k2r_128, k4r_128 = \
        phase_ct_kernels(P)
    wk_128 = window_kernels(P, P, "int8", int8_library)
    lmm_128, sweep_128 = lambda_mm_kernels(P)
    P.A_adj = P.B_adj = None     # the n=128 solves need forward panels
    release_plain_caches(P)
    drop_libraries()
    with PeakMemory("n=128 main path", (P.A_op, P.B_op)):
        _, its, ref0 = phase_main_path(P)
    with PeakMemory("n=128 serving", (P.A_op, P.B_op)):
        serving_128 = phase_serving(P, its, ref0, full=False)
    with PeakMemory("n=128 GKB", (P.A_op, P.B_op)):
        gkb = phase_gkb_path(P, ("lsqr",))
        lsqr_b_128 = phase_gkb_serving(
            P, ("lsqr_batched",), {k: v[2] for k, v in gkb.items()},
            full=False)["lsqr_batched"]
    with PeakMemory("n=128 lambda path", (P.A_op, P.B_op)):
        phase_lambda_path(P, full=False)
    t0 = time.perf_counter()
    P4 = int4_operators(P)
    k1i4_128, k3i4_128, k2i4_128, k4i4_128 = int4_kernels(P, P4)
    wk4_128 = window_kernels(P, P4, "int4", int4_library)
    lmm4_128, sweep4_128 = lambda_mm_kernels(P4, "int4")
    release_plain_caches(P4)
    drop_libraries()
    say("int4_done", n=128, seconds=time.perf_counter() - t0)
    float_128 = phase_float_forms(P, fjobs_128)
    # phase sharded_2d's tiles, packed by worker processes from here on
    pool, tiles = start_tile_builds(P)
    with PeakMemory("n=128 sharded"):
        _, sharded_128, views, solvers_128, batched_128, two_d_128 = \
            phase_sharded(P, ref0, {k: v[2] for k, v in gkb.items()},
                          P4.B_op, tiles)
    pool.shutdown(wait=True, cancel_futures=True)
    del P4
    say("memory_peaks", card=card, **MEMORY)
    say("phantom2d_gpu_launches", launches=phantom_launches)
    say("sharded_summary", card=card, runs=sharded_64 + sharded_128,
        shard_view=views)
    say("sharded_solvers_summary", card=card, runs=solvers_64 + solvers_128)
    say("sharded_2d_summary", card=card, runs=two_d_64[0] + two_d_128[0],
        tile_checks=two_d_128[1])
    _, _, ba_2d, batched_2d = two_d_128
    two_d = "n=128 (1,1) mesh: parallel/panels2d.py:"

    csrc = "hybrid_gmres_tpu_torch/csrc/"
    pallas = "hybrid_gmres_tpu/ops/spmv_pallas.py"
    # the block-ELL K1-K4 are on no path any more (0 launches in the solves
    # above, checked); they stay as the Pallas kernels' direct counterparts
    # on the same panel, checked and timed in phase 3
    # the bfloat16 and float32 variants, each with the launches of its n=64
    # path as the int4 ones: the single solve (K1), lsqr (K3), the serving
    # batch (K2), lsqr_batched (K4)
    # K2r and K4r run two kernels: the gathers (row_spmm_kernel) and the
    # window kernel (row_spmm_window), each with its own entry, launches and
    # times.  Their launches come from the serving scans (K2) and the
    # lsqr_batched solves (K4), R=8, of each storage type: at n=64 and, for
    # int8, at n=128 too (``runs``: {run: (gather, window launches)}, from
    # the counts' K2r or K4r less the window kernel's).  ``path``: the
    # records of the forms those runs multiply (n=64 first); a kernel's ms
    # etc. are those of the forms it ran on (the gathers' from
    # row_mm_kernels/form_kernels, the window kernel's from window_kernels),
    # at n=64 where it ran there; a kernel with no launch in the runs is
    # superseded by the other
    sharded_k2r = ("the sharded runs' K2r (K4r) launches, on either "
                   "kernel as takes_windows routes each shard or tile form")

    def split(runs, k, w):
        return {name: (c[k] - c[w], c[w]) for name, c in runs.items()}

    def mm_record(name, replaces, runs, path, other, window, mode,
                  **extra):
        launches = sum(r[window] for r in runs.values())
        ran = [r for r in path if (r["routed"] == "window") == window]
        if launches:
            at_64 = [r for r in ran if r["panel"].startswith("n=64")]
            on = at_64 or ran
        else:
            on = [r for r in path if r["panel"].startswith("n=64")]
        return kernel_record(
            name, csrc + "row_spmv.cu", pallas + replaces, launches, on,
            [r for r in path + other if r not in on],
            superseded_by=None if launches else (
                f"row_spmm_window {mode}" if not window else
                f"{'row_matmat' if replaces == ':220' else 'row_rmatmat'} "
                f"{mode}".strip()),
            launches_by_run={k: v[window] for k, v in runs.items()},
            **extra)

    def pair(mode, runs2, runs4, g2, g4, w2, w4):
        """(gather K2, gather K4, window K2, window K4) entries: ``g2``,
        ``g4`` the gathers' records (path forms, others), ``w2``, ``w4`` the
        window kernel's."""
        suffix = f" {mode}" if mode else ""
        return ([mm_record(f"row_matmat{suffix}", ":220", runs2, *g2, False,
                           f"{mode} (K2)".strip()),
                 mm_record(f"row_rmatmat{suffix}", ":279", runs4, *g4,
                           False, f"{mode} (K4)".strip())],
                [mm_record(f"row_spmm_window{suffix} (K2)", ":220", runs2,
                           *w2, True, mode, gather="window",
                           rule="takes_windows"),
                 mm_record(f"row_spmm_window{suffix} (K4)", ":279", runs4,
                           *w4, True, mode, gather="window",
                           rule="takes_windows")])

    def window_recs(w64, w128, k4):
        # K2: A's and B's forward forms (serving); K4: A's transposed form
        # (lsqr_batched)
        if k4:
            return w64[:1] + w128[:1], w64[1:] + w128[1:]
        return w64 + w128, []

    int8_gathers, windows = pair(
        "", split({"n=64 serving R=8 deferred": serving_launches,
                   "n=128 serving R=8 deferred": serving_128}, 6, 9),
        split({"n=64 lsqr_batched R=8": lsqr_b_launches,
               "n=128 lsqr_batched R=8": lsqr_b_128}, 7, 10),
        (k2r_64 + k2r_128, []), (k4r_64[:1] + k4r_128[:1],
                                  k4r_64[1:] + k4r_128[1:]),
        window_recs(wk_64["K2"], wk_128["K2"], False),
        window_recs(wk_64["K4"], wk_128["K4"], True))
    int4_gathers, int4_windows = pair(
        "int4", split({"n=64 int4 serving R=8 deferred": int4_launches},
                      2, 4),
        split({"n=64 int4 lsqr_batched R=8": int4_launches}, 3, 5),
        (k2i4_64 + k2i4_128, []), (k4i4_64[:1] + k4i4_128[:1],
                                    k4i4_64[1:] + k4i4_128[1:]),
        window_recs(wk4_64["K2"], wk4_128["K2"], False),
        window_recs(wk4_64["K4"], wk4_128["K4"], True))
    windows += int4_windows
    floats = []
    for dt in FLOAT_DTYPES:
        (k1, k3, k2, k4), (l1, l3, l2, l4, w2, w4), wk = float_64[dt]
        (m1, m3, m2, m4), _, wk128 = float_128[dt]
        got = (l1, l3, l2, l4, w2, w4)
        gathers_dt, windows_dt = pair(
            dt, split({f"n=64 {dt} serving R=8 deferred": got}, 2, 4),
            split({f"n=64 {dt} lsqr_batched R=8": got}, 3, 5),
            (k2 + m2, []), (k4[:1] + m4[:1], k4[1:] + m4[1:]),
            window_recs(wk["K2"], wk128["K2"], False),
            window_recs(wk["K4"], wk128["K4"], True))
        windows += windows_dt
        floats += [
            kernel_record(f"row_matvec {dt}", csrc + "row_spmv.cu",
                          pallas + ":46", l1, k1, m1),
            kernel_record(f"row_rmatvec {dt}", csrc + "row_spmv.cu",
                          pallas + ":101", l3, k3[:1], k3[1:] + m3),
            *gathers_dt]
    kernels = [
        kernel_record("row_matvec", csrc + "row_spmv.cu", pallas + ":46",
                      main_launches[4], k1r_64, k1r_128,
                      entry_launches=entry_launches[4],
                      sharded_launches=sharded_launches_64[4],
                      sharded_2d_launches=ba_2d[4],
                      sharded_2d_path="ba_gmres_sharded_pallas_2d " + two_d
                      + "tile_matvec"),
        dict(int8_gathers[0], sharded_launches=batched_128[6],
             sharded_path="ba_gmres_sharded_batched n=128 R=8 in-loop "
             "(parallel/panels.py:local_matmat)",
             sharded_2d_launches=batched_2d[6],
             sharded_2d_path="ba_gmres_sharded_batched_2d R=8 deferred "
             + two_d + "tile_matmat", sharded_kernels=sharded_k2r),
        kernel_record("row_rmatvec", csrc + "row_spmv.cu", pallas + ":101",
                      lsqr_launches[5], k3r_64[:1], k3r_64[1:] + k3r_128,
                      sharded_launches=sharded_launches_64[5],
                      sharded_2d_launches=ba_2d[5],
                      sharded_2d_path="ba_gmres_sharded_pallas_2d " + two_d
                      + "tile_rmatvec"),
        dict(int8_gathers[1], sharded_launches=batched_128[7],
             sharded_path="ba_gmres_sharded_batched n=128 R=8 in-loop "
             "(parallel/panels.py:local_rmatmat_window)",
             sharded_2d_launches=batched_2d[7],
             sharded_2d_path="ba_gmres_sharded_batched_2d R=8 deferred "
             + two_d + "tile_rmatmat", sharded_kernels=sharded_k2r),
        # K2w: the launches of the n=64 AB-RTP solve (A Q at R = maxit a
        # step); ms etc. of one such product (n=64 A, R=100); its bound the
        # tensor cores' (the float32 yardstick beside it)
        kernel_record("wide_matmat", csrc + "tile_spmm.cu", pallas + ":220",
                      rtp_64["ab_gmres_rtp"][8], lmm_64[:1],
                      lmm_64[1:] + lmm_128, bound_fn=tc_bound,
                      fp32_bound_ms=lmm_64[0]["bound_ms"],
                      replaces_wrapper=pallas + ":343 (takes_tiles)",
                      sweep=sweep_64 + sweep_128),
        # K2w's int4 variant (the same kernel, dtype code 3): the launches
        # of the n=64 int4 AB-RTP solve, the rest as the int8 one's
        kernel_record("wide_matmat int4", csrc + "tile_spmm.cu",
                      pallas + ":220", wide4_launches[8], lmm4_64[:1],
                      lmm4_64[1:] + lmm4_128, bound_fn=tc_bound,
                      fp32_bound_ms=lmm4_64[0]["bound_ms"],
                      replaces_wrapper=pallas + ":343 (takes_tiles)",
                      sweep=sweep4_64 + sweep4_128),
        # the int4 variants (nibble-packed forms), each with the launches
        # of its n=64 int4 path: the single solve (K1), lsqr (K3), the
        # serving batch (K2), lsqr_batched (K4)
        kernel_record("row_matvec int4", csrc + "row_spmv.cu",
                      pallas + ":46", int4_launches[0], k1i4_64, k1i4_128),
        kernel_record("row_rmatvec int4", csrc + "row_spmv.cu",
                      pallas + ":101", int4_launches[1], k3i4_64[:1],
                      k3i4_64[1:] + k3i4_128),
        *int4_gathers,
        *floats,
        *windows,
        kernel_record("bucket_matvec", csrc + "bucket_spmv.cu",
                      pallas + ":46", main_launches[0], k1_64, k1_128,
                      superseded_by="row_matvec"),
        kernel_record("bucket_matmat", csrc + "bucket_spmm.cu",
                      pallas + ":220", serving_launches[1], k2_64, k2_128,
                      superseded_by="row_matmat"),
        kernel_record("bucket_rmatvec", csrc + "bucket_rspmv.cu",
                      pallas + ":101", lsqr_launches[2], k3_64[:1],
                      k3_64[1:] + k3_128, superseded_by="row_rmatvec"),
        kernel_record("bucket_rmatmat", csrc + "bucket_rspmv.cu",
                      pallas + ":279", lsqr_b_launches[3], k4_64[:1],
                      k4_64[1:] + k4_128, superseded_by="row_rmatmat")]
    # every kernel on a path was launched in that path's run
    idle = [k["name"] for k in kernels if k["on_path"] and not k["launches"]]
    check(not idle, f"kernels on a path with no launch in its run: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
