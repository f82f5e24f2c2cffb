from .types import (DistMatrix, pad_rows, resolve_device,
                    row_separable_batch_inputs, row_separable_inputs)
from .rowmatrix import RowMatrix
from .sparserow import SparseRowMatrix

__all__ = ["DistMatrix", "pad_rows", "resolve_device",
           "row_separable_batch_inputs", "row_separable_inputs", "RowMatrix",
           "SparseRowMatrix"]
