"""Carry the reference's state across: numpy arrays in, port objects out.

The JAX package's arrays leave it as numpy (`np.asarray(jax_array)`); these
helpers put them on a device as torch tensors.  bfloat16 arrays (numpy's
ml_dtypes extension type) cross by bit pattern, since torch does not read
that type: bfloat16 → view as int16 → torch.int16 → view as bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.distmat.sparserow import SparseRowMatrix


def tensor_from_numpy(arr, *, device, dtype=None) -> torch.Tensor:
    """`arr` on `device` with the same values; bfloat16 keeps its bits."""
    arr = np.asarray(arr)
    dev = T.resolve_device(device)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16).to(dev)
    else:
        t = torch.from_numpy(np.array(arr)).to(dev)
    return t if dtype is None else t.to(dtype)


def rowmatrix_from_numpy(rows, n_rows: int, *, device,
                         store_dtype=None) -> RowMatrix:
    """A RowMatrix from the reference's stored rows (`np.asarray(rm.rows)`,
    padding included) and its true row count `rm.n_rows`."""
    t = tensor_from_numpy(rows, device=device)
    if store_dtype is not None:
        t = t.to(store_dtype)
    return RowMatrix(rows=t.contiguous(), n_rows=int(n_rows))


def vector_from_numpy(v, *, device) -> torch.Tensor:
    """A data- or solution-space vector (b, x0, targets, weights) as f32."""
    return tensor_from_numpy(v, device=device, dtype=torch.float32)


def sparserow_from_numpy(data, cols, dims, nnz: int, scales=None, *,
                         device) -> SparseRowMatrix:
    """A SparseRowMatrix from the reference's stored arrays
    (`np.asarray(srm.data)`, `srm.cols`, padding block-rows included), its
    true dims and nnz; int8 data and its f32 `scales` cross as they are."""
    return SparseRowMatrix(
        tensor_from_numpy(data, device=device).contiguous(),
        tensor_from_numpy(np.asarray(cols, np.int32),
                          device=device).contiguous(),
        dims=tuple(int(d) for d in dims), nnz=int(nnz),
        scales=None if scales is None else tensor_from_numpy(
            np.asarray(scales, np.float32), device=device).contiguous())
