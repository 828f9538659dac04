"""Device choice of the port's constructors, scalars on the device, and the
float32 matmul precision of the products that need all of it.

The port's entry points build on the card unless the caller asks for the
CPU.  They never fall back: ``device="cuda"`` without a CUDA device raises.
"""

from __future__ import annotations

import contextlib

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and the
    process has no CUDA device (pass ``device="cpu"`` for the CPU path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to build on the CPU (the CPU path "
            "uses the kernels' plain PyTorch versions)")
    return dev


def scalar_tensor(val, dtype, device) -> torch.Tensor:
    """``val`` (a number or a tensor) in ``dtype`` on ``device``.

    A tensor is cast and moved.  A Python number is written by a fill
    kernel: ``torch.as_tensor`` would copy it from pageable host memory,
    which waits for the device's queue — one host synchronization per call
    and, inside a solver's loop, one per step."""
    if isinstance(val, torch.Tensor):
        return val.to(dtype=dtype, device=device)
    if isinstance(val, (int, float)):
        return torch.full((), val, dtype=dtype, device=device)
    return torch.as_tensor(val, dtype=dtype, device=device)


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 matmuls in full float32 inside the block, whatever the caller
    set (``torch.backends.cuda.matmul.allow_tf32 = True``,
    ``torch.set_float32_matmul_precision("high")`` or the per-backend
    ``fp32_precision = "tf32"`` let cuBLAS round the operands to TF32, the
    card's counterpart of the TPU's bf16-pass default precision); the
    caller's setting is back on exit.  For the products the JAX package pins
    at ``Precision.HIGHEST``: a Gram matrix, which squares the conditioning,
    and one-time products that must reproduce per-step matvecs.

    Where torch has the per-backend ``fp32_precision`` settings (2.9 on),
    the block sets and restores those: they take precedence over the global
    setting, and restoring them leaves every getter as it was."""
    mkldnn = getattr(torch.backends, "mkldnn", None)
    backends = [b for b in (torch.backends.cuda.matmul,
                            getattr(mkldnn, "matmul", None))
                if hasattr(b, "fp32_precision")]
    if not backends:
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(precision)
        return
    saved = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, val in zip(backends, saved):
            b.fp32_precision = val
