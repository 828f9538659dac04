from hybrid_gmres_tpu_torch.ops.ordering import (
    inverse_perm,
    morton_perm,
    reorder_pair,
)
from hybrid_gmres_tpu_torch.ops.linear_operator import (
    AugmentedOperator,
    DenseOperator,
    LinearOperator,
    ProductOperator,
    ShiftedOperator,
    as_operator,
)

__all__ = [
    "AugmentedOperator",
    "DenseOperator",
    "LinearOperator",
    "ProductOperator",
    "ShiftedOperator",
    "as_operator",
    "inverse_perm",
    "morton_perm",
    "reorder_pair",
]
