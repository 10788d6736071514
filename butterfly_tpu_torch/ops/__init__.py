from butterfly_tpu_torch.ops.linop import (
    BlockCoo,
    BlockDense,
    BlockDiag,
    Dense,
    Diag,
    FuncOp,
    Identity,
    LinOp,
    Product,
    Zero,
    hpad,
    row_slice,
)

__all__ = [
    "BlockCoo",
    "BlockDense",
    "BlockDiag",
    "Dense",
    "Diag",
    "FuncOp",
    "Identity",
    "LinOp",
    "Product",
    "Zero",
    "hpad",
    "row_slice",
]
