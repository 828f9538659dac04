"""The values a storage type keeps of a float64 matrix, worked out again.

The program stores its operators from the float32 rounding of the assembled
matrices: bfloat16 and float32 as they are, int8 and int4 as a per-row
symmetric quantization ``A ~= diag(s) Q`` with ``s_i = max_j |A_ij| / qmax``
(``qmax`` 127 and 7; 1 for an empty row), ``Q = rint(A_ij * (1 / s_i))``
clipped to ``[-qmax, qmax]`` and ``s`` kept in float32.  This module applies
that rule to the reference's own matrices and returns the float64 matrix of
the values kept: the operator the reference's float64 solve runs on.
"""

from __future__ import annotations

import torch

from gpubench.reference.assemble import csr_tensor

QMAX = {"int8": 127, "int4": 7}


def stored(M: torch.Tensor, dtype: str) -> torch.Tensor:
    """The float64 CSR matrix of the values that storage type ``dtype``
    keeps of the float64 CSR matrix ``M``."""
    crow, col = M.crow_indices(), M.col_indices()
    v32 = M.values().to(torch.float32)
    if dtype in ("float32", "bfloat16"):
        vals = v32.to(getattr(torch, dtype)).to(torch.float64)
    elif dtype in QMAX:
        qmax = QMAX[dtype]
        v = v32.to(torch.float64)
        rows = torch.repeat_interleave(
            torch.arange(M.shape[0], device=v.device), crow.diff())
        absmax = torch.zeros(M.shape[0], dtype=torch.float64, device=v.device)
        absmax.scatter_reduce_(0, rows, v.abs(), reduce="amax")
        s = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
        q = torch.clamp(torch.round(v * (1.0 / s)[rows]), -qmax, qmax)
        vals = s.to(torch.float32).to(torch.float64)[rows] * q
    else:
        raise ValueError(f"unknown storage type {dtype!r}")
    return csr_tensor(crow, col, vals, M.shape)
