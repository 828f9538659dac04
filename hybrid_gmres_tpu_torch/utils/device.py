"""Device choice of the port's constructors, and scalars on the device.

The port's entry points build on the card unless the caller asks for the
CPU.  They never fall back: ``device="cuda"`` without a CUDA device raises.
"""

from __future__ import annotations

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
