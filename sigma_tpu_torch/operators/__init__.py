from sigma_tpu_torch.operators.linear_operator import (
    AdjointOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    MatvecOperator,
    ProductOperator,
    ScaledOperator,
    SumOperator,
    aslinearoperator,
    move_to,
)

__all__ = [
    "AdjointOperator",
    "DenseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "LinearOperator",
    "MatvecOperator",
    "ProductOperator",
    "ScaledOperator",
    "SumOperator",
    "aslinearoperator",
    "move_to",
]
