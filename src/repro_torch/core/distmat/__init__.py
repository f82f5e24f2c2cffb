from .types import (DistMatrix, pad_rows, resolve_device,
                    row_separable_batch_inputs, row_separable_inputs)
from .rowmatrix import RowMatrix, IndexedRowMatrix
from .coordinatematrix import CoordinateMatrix
from .blockmatrix import BlockMatrix
from .sparserow import SparseRowMatrix
from .local import SparseVector, SparseMatrixCSC

__all__ = ["DistMatrix", "pad_rows", "resolve_device",
           "row_separable_batch_inputs", "row_separable_inputs", "RowMatrix",
           "IndexedRowMatrix", "CoordinateMatrix", "BlockMatrix",
           "SparseRowMatrix", "SparseVector", "SparseMatrixCSC"]
