"""Device choice of the port's constructors.

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
