"""Linear-operator protocol for the matvec substrate (PyTorch port).

Twin of ``hybrid_gmres_tpu/ops/linear_operator.py``: operators are small
classes exposing ``shape``, ``dtype``, ``matvec`` and ``rmatvec`` over torch
tensors, so the same Krylov cores run over dense matrices and the block-ELL
SpMV kernel.  Mismatched pairs ``(A, B)`` with ``B != A^T`` are first-class:
``B`` is passed wherever the math calls for a back-projector, never derived
from ``A``.

``AugmentedOperator``, ``ShiftedOperator`` and ``ProductOperator`` compose
operators matrix-free, as in the JAX package.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.utils.device import (
    require_device,
    scalar_tensor,
)


class LinearOperator:
    """Minimal protocol: ``shape``, ``dtype``, ``matvec``, ``rmatvec``."""

    shape: tuple
    dtype: torch.dtype

    @property
    def device(self):
        """Where the operator's data lives (and where its inputs must)."""
        raise NotImplementedError

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

        Only for analysis / testing at small sizes.  The identity is built
        on the operator's device.
        """
        return self.matmat(torch.eye(self.shape[1], dtype=self.dtype,
                                     device=self.device))


class _TransposedOperator(LinearOperator):
    def __init__(self, op):
        self.op = op

    @property
    def shape(self):
        return (self.op.shape[1], self.op.shape[0])

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def matvec(self, v):
        return self.op.rmatvec(v)

    def rmatvec(self, u):
        return self.op.matvec(u)

    def matmat(self, X):
        return self.op.rmatmat(X)

    def rmatmat(self, U):
        return self.op.matmat(U)


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

    @property
    def device(self):
        return self.mat.device

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


class _Composed(LinearOperator):
    """Shared ``dtype``/``device`` of the wrappers around one operator."""

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device


def _scalar(val, like):
    """``val`` (number or tensor) in the dtype and on the device of the
    VECTOR ``like``, never the operator's: a quantized operator's storage
    dtype would truncate lam (int8(1e-2) == 0) and silently drop the
    regularization."""
    return scalar_tensor(val, like.dtype, like.device)


class AugmentedOperator(_Composed):
    """Tikhonov-augmented operator ``[A; sqrt(lam) I]`` of shape (m+n, n),
    kept matrix-free (hybrid LSQR).  ``rmatvec`` is the exact adjoint
    ``A^T u[:m] + sqrt(lam) u[m:]``."""

    def __init__(self, op, lam):
        self.op = op
        self.lam = lam

    @property
    def shape(self):
        m, n = self.op.shape
        return (m + n, n)

    def matvec(self, v):
        return torch.cat([self.op.matvec(v),
                          torch.sqrt(_scalar(self.lam, v)) * v])

    def rmatvec(self, u):
        m = self.op.shape[0]
        return self.op.rmatvec(u[:m]) + torch.sqrt(_scalar(self.lam, u)) * \
            u[m:]

    def augment_rhs(self, b):
        return torch.cat([b, b.new_zeros(self.op.shape[1])])


class ShiftedOperator(_Composed):
    """``op + lam * I`` for square operators (the regularize-then-project
    GMRES variants build their Krylov space on ``B A + lam I``)."""

    def __init__(self, op, lam):
        self.op = op
        self.lam = lam

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, v):
        return self.op.matvec(v) + _scalar(self.lam, v) * v

    def rmatvec(self, u):
        return self.op.rmatvec(u) + _scalar(self.lam, u) * u


class ProductOperator(LinearOperator):
    """``left @ right`` kept matrix-free (e.g. M = A B without forming the
    m x m product)."""

    def __init__(self, left, right):
        self.left = left
        self.right = right

    @property
    def shape(self):
        return (self.left.shape[0], self.right.shape[1])

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def device(self):
        return self.left.device

    def matvec(self, v):
        return self.left.matvec(self.right.matvec(v))

    def rmatvec(self, u):
        return self.right.rmatvec(self.left.rmatvec(u))


def as_operator(a, device="cuda") -> LinearOperator:
    """Coerce an array, tensor or operator to a LinearOperator.

    An operator or a tensor keeps its device.  Anything else (a numpy
    array, a list) is moved to ``device``: the card by default, which raises
    without one; pass ``device="cpu"`` for the CPU path."""
    if isinstance(a, LinearOperator):
        return a
    if isinstance(a, torch.Tensor):
        return DenseOperator(a)
    return DenseOperator(torch.as_tensor(a, device=require_device(device)))


def as_vector(b, device="cuda") -> torch.Tensor:
    """A right-hand side as a tensor: a tensor keeps its device, anything
    else goes to ``device`` under the rule of :func:`as_operator`."""
    if isinstance(b, torch.Tensor):
        return b
    return torch.as_tensor(b, device=require_device(device))
