"""One run of one cell: set-up, warm-up, the measured window, the output
check against the plain reference, and the result.

Every piece comes by name from the cell (``gpubench.lib.spec``).  The
program under test is ``hybrid_gmres_tpu_torch``: its CT problem and
operators (``problems.ct``) and the public solver the traffic mix names
(``solvers.<entry>``), called as a user calls it.  Nothing here imports JAX
or the JAX package.
"""

from __future__ import annotations

import importlib
import math
import sys
import time
from typing import NamedTuple

import torch

from gpubench.lib import env, scanner, stats, tracing
from gpubench.lib.spec import metric_reader, reference_solver
from gpubench.reference import assemble, operators

# what a request hands the public solver, unless the traffic mix says
# otherwise: the operators before the sinograms, and the configuration's
# solver settings as keyword arguments
OPERANDS = ("A", "B")
SOLVER_SETTINGS = ("lam", "maxit", "tol")


class Program:
    """The system under test at one configuration: the port's operators in
    the configuration's storage type (or ``dtype``), the Morton relabelling
    it returns, and the public solver of a traffic mix."""

    def __init__(self, cfg: dict, device, dtype=None):
        from hybrid_gmres_tpu_torch.problems.ct import (ct_gpu_operators,
                                                        ct_mismatched)
        from hybrid_gmres_tpu_torch.ops.ordering import inverse_perm

        g = cfg
        t0 = time.perf_counter()
        prob = ct_mismatched(n=g["n"], n_angles=g["n_angles"],
                             n_det=g["n_det"],
                             source_radius=g["source_radius_factor"] * g["n"])
        self.assemble_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.A, self.B, _, _, ray_perm, pix_perm = ct_gpu_operators(
            prob, dtype=dtype or cfg["dtype"], device=device)
        _sync(device)
        self.pack_s = time.perf_counter() - t0
        self.ray_perm = torch.as_tensor(ray_perm, device=device)
        self.pix_inv = torch.as_tensor(inverse_perm(pix_perm), device=device)
        self.device = device

    def caller(self, cfg: dict, traffic: dict, pool: torch.Tensor):
        """``request(index) -> (x, res_hist)``: the traffic's request number
        ``index``, sent and waited for, its solution in natural pixel
        order.  The mix names the solver (``entry``), the operators it
        takes (``operands``), the configuration's settings it passes
        (``settings``) and any other arguments (``kwargs``)."""
        entry = getattr(importlib.import_module(
            "hybrid_gmres_tpu_torch.solvers"), traffic["entry"])
        kwargs = {k: cfg[k] for k in traffic.get("settings",
                                                 SOLVER_SETTINGS)}
        kwargs.update(traffic.get("kwargs", {}))
        ops = [{"A": self.A, "B": self.B}[name]
               for name in traffic.get("operands", OPERANDS)]
        single = traffic["slices_per_request"] == 1

        def request(index):
            cols = scanner.request_slices(traffic, index)
            b = pool[:, cols[0]] if single else pool[:, cols]
            res = entry(*ops, b[self.ray_perm], **kwargs)
            x, hist = res.x[self.pix_inv], res.res_hist
            _sync(self.device)
            return x, hist

        return request


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_operators(cfg: dict, device, dtype=None):
    """The reference's own A and B as the storage type keeps them (float64
    CSR), and {"A": (m, n, stored entries), "B": ...}."""
    A, B = assemble.ct_pair(cfg, device)
    facts = {name: (M.shape[0], M.shape[1], M.values().numel())
             for name, M in (("A", A), ("B", B))}
    dt = dtype or cfg["dtype"]
    return operators.stored(A, dt), operators.stored(B, dt), facts


class Reference(NamedTuple):
    """The reference's answers for the slice pool: float64 solutions ``x``
    (n, P) and residual histories ``res`` (maxit, P), with its operator
    ``A`` and the pool ``b`` (m, P) it solved for."""

    x: torch.Tensor
    res: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor


def reference_answers(cfg: dict, traffic: dict, pool: torch.Tensor, A, B):
    """The reference's float64 solution and residual history of every slice
    of the pool, by the solver the traffic mix names."""
    solver = reference_solver(traffic["reference"])
    b = pool.to(torch.float64)
    x, res = solver.solve(A, B, b, cfg["lam"], cfg["maxit"])
    if bool((res <= cfg["tol"]).any()):
        # the stated solve would stop there; the traffic's noise keeps
        # every slice's relative residual far above tol, so it runs maxit
        raise ValueError(f"a slice of the pool reached tol {cfg['tol']}: "
                         "the reference runs every solve to maxit")
    return Reference(x, res, A, b)


def gaps(answers, ref: Reference, traffic: dict) -> dict:
    """The compared numbers over all answers (``(index, x, res_hist)``
    each), each the largest over the answers' slices:

    * ``x_gap``: ||x - x_ref|| / ||x_ref||;
    * ``res_gap``: the median over the steps of |res_k - res_ref_k| /
      res_ref_k, of the residual history the program reports;
    * ``fit_gap``: |r - r_ref| / r_ref, where r = ||b - A x|| / ||b|| is the
      returned solution's residual worked out by the reference's operator
      and r_ref its own final one;
    * ``self_fit_gap``: |r - res_last| / res_last, r as above against the
      last entry of the residual history the program reports with it.

    A non-finite gap, or an answer of the wrong shape, reads as infinite."""
    out = dict(x_gap=0.0, res_gap=0.0, fit_gap=0.0, self_fit_gap=0.0)
    for index, x, hist in answers:
        cols = scanner.request_slices(traffic, index)
        xr, rr, b = ref.x[:, cols], ref.res[:, cols], ref.b[:, cols]
        x = x.to(torch.float64).reshape(x.shape[0], -1)
        hist = hist.to(torch.float64).reshape(hist.shape[0], -1)
        if x.shape != xr.shape or hist.shape != rr.shape:
            return dict.fromkeys(out, math.inf)
        fit = torch.linalg.vector_norm(b - ref.A @ x, dim=0) \
            / torch.linalg.vector_norm(b, dim=0)
        new = dict(
            x_gap=torch.linalg.vector_norm(x - xr, dim=0)
            / torch.linalg.vector_norm(xr, dim=0),
            res_gap=((hist - rr).abs() / rr).median(dim=0).values,
            fit_gap=(fit - rr[-1]).abs() / rr[-1],
            self_fit_gap=(fit - hist[-1]).abs() / hist[-1])
        for name, g in new.items():
            out[name] = max(out[name], _finite_max(g))
    return out


def _finite_max(t: torch.Tensor) -> float:
    t = torch.where(torch.isfinite(t), t, torch.full_like(t, math.inf))
    return float(t.max())


def checks(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit (a number over its limit, or
    missing, fails)."""
    return {name: dict(value=numbers.get(name, math.inf), limit=limit,
                       ok=numbers.get(name, math.inf) <= limit)
            for name, limit in limits.items()}


class Context:
    """What a per-layer metric's reader sees: the trace of the window's
    first requests (or None) and the CUDA-only trace of the next ones, the
    set-up timers, the iterations run in the first trace, the (sent, done,
    slices) host times of the window's untraced requests, the
    configuration, and the operators' shapes and stored entries as the
    reference counted them."""

    def __init__(self, trace, device_trace, timers, iterations, untraced,
                 cfg, facts):
        self.trace = trace
        self.device_trace = device_trace
        self.timers = timers
        self.iterations = iterations
        self.untraced = untraced
        self.cfg = cfg
        self.facts = facts


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print):
    """Run ``cell`` once.  Returns (result dict, checks dict); the caller
    prints.  ``t_start``: the host clock at process start."""
    cfg, traffic = cell["config"], cell["traffic"]
    prog = Program(cfg, device)
    pool = scanner.slice_pool(cfg, traffic, seed, device)
    request = prog.caller(cfg, traffic, pool)
    for i in range(traffic["warmup_requests"]):
        request(i)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (assembly {prog.assemble_s:.3f}, packing "
        f"{prog.pack_s:.3f}); load {env.load_average()}")

    answers, records, failed = [], [], 0
    spr = traffic["slices_per_request"]
    holder, index = None, 0

    def serve():
        nonlocal failed, index
        t0 = time.perf_counter()
        try:
            out = request(index)
        except Exception as exc:   # a request that fails counts as failed
            log(f"request {index} failed: {exc!r}")
            failed += 1
            out = None
        t1 = time.perf_counter()
        records.append((t0, t1, spr if out is not None else 0))
        if out is not None:
            answers.append((index, *out))
        index += 1

    t_window = time.perf_counter()
    if trace:
        unwrap = tracing.wrap_products({"A": prog.A, "B": prog.B})
        with tracing.profiled() as holder:
            for _ in range(traffic["trace_requests"]):
                serve()
        unwrap()
        traced_requests = index
        with tracing.profiled(host=False) as light:
            for _ in range(traffic["trace_requests"]):
                serve()
    while time.perf_counter() - t_window < seconds:
        serve()
    t_end = records[-1][1]
    log(f"load {env.load_average()} at the window's close")
    peak = (torch.cuda.max_memory_allocated() if
            torch.device(device).type == "cuda" else 0)
    timers = dict(pack_s=prog.pack_s)
    del prog, request
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    A, B, facts = reference_operators(cfg, device)
    ref = reference_answers(cfg, traffic, pool, A, B)
    numbers = gaps(answers, ref, traffic)   # every answer
    numbers["failed"] = failed
    log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s")
    judged = checks(numbers, cell["limits"])
    attempted = len(records)
    correct = failed == 0 and attempted > 0 and all(
        c["ok"] for c in judged.values())

    window = stats.window_metrics(records, t_window, t_end)
    e2e = dict(setup_s=setup_s, slices_per_s=window["slices_per_s"],
               request_ms_p95=window["request_ms_p95"])
    metrics, dev = {}, {}
    if not trace:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    else:
        tr, dtr = holder.trace, light.trace
        untraced = records[2 * traced_requests:]
        ctx = Context(tr, dtr, timers, traced_requests * cfg["maxit"],
                      untraced, cfg, facts)
        for m in cell["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        dev = dict(busy_s=dtr.busy_s, window_s=dtr.window_s)
        log("request ms, median: traced "
            f"{_median_ms(records[:traced_requests])}, CUDA-only traced "
            f"{_median_ms(records[traced_requests:2 * traced_requests])}, "
            f"untraced {_median_ms(untraced)}; CUDA-only window "
            f"{dtr.window_s:.4f} s from the first "
            f"{'API call' if dtr.from_api else 'device activity'}, device "
            f"busy {dtr.busy_s / traced_requests * 1e3:.3f} ms a request")
    log(f"window {window['window_s']:.3f} s, {window['requests']} requests, "
        f"{window['slices']} slices")
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, memory_peak_bytes=peak, device_extra=dev,
                  window=window)
    if trace:
        result["breakdown"] = holder.trace.breakdown()
    return result, judged


def _median_ms(records):
    ms = sorted((done - sent) * 1e3 for sent, done, _ in records)
    return round(ms[len(ms) // 2], 3) if ms else None


def result_line(result: dict, judged: dict, kind: str, count: int) -> dict:
    """The result's JSON object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and last the
    compared numbers beside their limits."""
    device = dict(platform="gpu", kind=kind, count=count,
                  memory_peak_bytes=result["memory_peak_bytes"],
                  **result["device_extra"])
    line = dict(correct=result["correct"], attempted=result["attempted"],
                failed=result["failed"], metrics=result["metrics"],
                device=device)
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: dict(value=v["value"], limit=v["limit"])
                      for k, v in judged.items()}
    return line


def stderr(msg):
    print(msg, file=sys.stderr, flush=True)
