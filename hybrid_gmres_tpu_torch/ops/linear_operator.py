"""Linear-operator protocol for the matvec substrate (PyTorch port).

Twin of ``hybrid_gmres_tpu/ops/linear_operator.py``: operators are small
classes exposing ``shape``, ``dtype``, ``matvec`` and ``rmatvec`` over torch
tensors, so the same Krylov cores run over dense matrices and the block-ELL
SpMV kernel.  Mismatched pairs ``(A, B)`` with ``B != A^T`` are first-class:
``B`` is passed wherever the math calls for a back-projector, never derived
from ``A``.

The Augmented, Shifted and Product operators are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch


class LinearOperator:
    """Minimal protocol: ``shape``, ``dtype``, ``matvec``, ``rmatvec``."""

    shape: tuple
    dtype: torch.dtype

    def matvec(self, v):
        raise NotImplementedError

    def rmatvec(self, u):
        """Action of the (declared) adjoint.  For a mismatched pair this is
        the back-projector's action, which need not equal ``A^T u``."""
        raise NotImplementedError

    def matmat(self, X):
        """Multi-RHS action Y (m, R) = A @ X (n, R).  Default: one matvec per
        column; kernel-backed operators override with a true SpMM."""
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])],
                           dim=1)

    def rmatmat(self, U):
        """Multi-RHS adjoint action Y (n, R) = A' @ U (m, R)."""
        return torch.stack([self.rmatvec(U[:, j]) for j in range(U.shape[1])],
                           dim=1)

    def __call__(self, v):
        return self.matvec(v)

    @property
    def T(self):
        return _TransposedOperator(self)

    def todense(self):
        """Materialize as a dense matrix (columns = images of basis vectors).

        Only for analysis / testing at small sizes, on the CPU.
        """
        return self.matmat(torch.eye(self.shape[1], dtype=self.dtype))


class _TransposedOperator(LinearOperator):
    def __init__(self, op):
        self.op = op

    @property
    def shape(self):
        return (self.op.shape[1], self.op.shape[0])

    @property
    def dtype(self):
        return self.op.dtype

    def matvec(self, v):
        return self.op.rmatvec(v)

    def rmatvec(self, u):
        return self.op.matvec(u)


class DenseOperator(LinearOperator):
    """Dense matrix operator; matvec is one ``torch.matmul``.

    Float32 products run in full float32 only with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default);
    TF32 is the card's counterpart of the TPU's bf16-pass DEFAULT precision.
    """

    def __init__(self, mat):
        self.mat = mat

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    def matvec(self, v):
        return self.mat @ v

    def rmatvec(self, u):
        return self.mat.T @ u

    def matmat(self, X):
        return self.mat @ X

    def rmatmat(self, U):
        return self.mat.T @ U

    def todense(self):
        return self.mat


def as_operator(a, device=None) -> LinearOperator:
    """Coerce an array, tensor or operator to a LinearOperator."""
    if isinstance(a, LinearOperator):
        return a
    return DenseOperator(torch.as_tensor(a, device=device))
