"""SparseRowMatrix: a row-partitioned block-sparse matrix on one device.

Counterpart of src/repro/core/distmat/sparserow.py.  The reference keeps
one BlockELL strip of block-rows per device of a TPU mesh and runs each op
as a shard_map body with a psum; here there is one strip, so each op is
its body alone.  The stored block-rows may outnumber the true rows (a
matrix carried over from a multi-device reference keeps its padding);
padding rows are zero blocks and weigh 0 in every loss.

The products run the block-sparse kernels through kernels/ops (plain torch
for CPU tensors): matvec → bsr_matvec, rmatvec and the sparse Gram →
bsr_rmatmul, multiply_local (the U = A(VΣ⁻¹) product) → bsr_matmul, and
the fused gradient → fused_grad_bsr (for int8 storage bsr_matvec and
bsr_rmatmul).  ``dispatch="dense"`` densifies and takes the dense kernels
instead.

Differences from the reference, each until its ROADMAP item lands: the
reference's ``dispatch="auto"`` asks the planner whether BSR beats the
dense product; here it means "bsr" (queue 1 item 11), and ``bs="auto"``
and ``quantize="auto"`` raise (item 11).  ``chunks`` stays at 1 and
``residual=`` raises (item 13).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import bsr as _bsr
from repro_torch.kernels import ops as _ops
from . import types as T
from .rowmatrix import _CHUNKS_ITEM as MULTI_GPU_ITEM
from .rowmatrix import RowMatrix, _check_chunks

PLANNER_ITEM = _bsr.PLANNER_ITEM
SPARSE_SERVING_ITEM = ("ROADMAP queue 1 item 8 (fused_grad_bsr_multi and "
                       "the sparse server)")
DIMSUM_ITEM = "ROADMAP queue 1 item 9 (distmat types and DIMSUM)"
_DISPATCH = ("auto", "bsr", "dense")
# Column-strip width of AᵀX with a wide X (the sparse Gram), as in the
# reference: each strip's partials stay (chunks × bs × 512) f32.
_RMATMUL_STRIP = 512


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_bs(bs) -> int:
    if bs == "auto":
        raise NotImplementedError(f"bs='auto' waits for {PLANNER_ITEM}")
    bs = int(bs)
    if bs not in _bsr.BS_CANDIDATES:
        raise ValueError(f"bs must be one of {_bsr.BS_CANDIDATES}, got {bs}")
    return bs


@dataclass(frozen=True)
class SparseRowMatrix(T.DistMatrix):
    data: torch.Tensor            # (nbr_pad, ell, bs, bs)
    cols: torch.Tensor            # (nbr_pad, ell) int32
    dims: tuple[int, int]         # true (m, n) before any padding
    nnz: int
    # Per-stored-block f32 scales (nbr_pad, ell), set iff data is int8.
    scales: torch.Tensor | None = None
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_dense(a, bs: int | str, *, device="cuda",
                   quantize: str = "none") -> "SparseRowMatrix":
        """Block-compress a dense matrix on `device` (the card unless the
        caller asks for the CPU).  `quantize` "int8" stores int8 blocks
        with per-block f32 scales; "auto" raises until the planner lands."""
        bs = _check_bs(bs)
        dev = T.resolve_device(device)
        a = T.as_float_tensor(a, dev)
        m, n = a.shape
        padded = F.pad(a, (0, _rup(n, bs) - n, 0, _rup(max(m, 1), bs) - m))
        bell = _bsr.BlockELL.from_dense(padded, bs, quantize=quantize)
        return SparseRowMatrix(bell.data, bell.cols, dims=(m, n),
                               nnz=int(torch.count_nonzero(a)),
                               scales=bell.scales)

    @staticmethod
    def from_entries(row_idx, col_idx, values, shape: tuple[int, int],
                     bs: int | str, *, device="cuda") -> "SparseRowMatrix":
        """COO entries → block-ELL without the dense matrix: entries are
        binned into (block-row, block-column) keys with one np.unique and
        one np.add.at, as in the reference; duplicates add up."""
        bs = _check_bs(bs)
        ri = np.asarray(row_idx, np.int64)
        ci = np.asarray(col_idx, np.int64)
        va = np.asarray(values)
        if va.dtype == np.float64:
            va = va.astype(np.float32)
        m, n = shape
        nbc = _rup(n, bs) // bs
        nbr = _rup(max(m, 1), bs) // bs
        key = (ri // bs) * nbc + (ci // bs)
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((max(len(uniq), 1), bs, bs), va.dtype)
        np.add.at(blocks, (inv, ri % bs, ci % bs), va)
        ubi, ubj = uniq // nbc, uniq % nbc
        counts = np.bincount(ubi, minlength=nbr)
        ell = max(1, int(counts.max(initial=0)))
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(uniq)) - starts[ubi]
        data = np.zeros((nbr, ell, bs, bs), va.dtype)
        cols = np.zeros((nbr, ell), np.int32)
        data[ubi, slot] = blocks[: len(uniq)]
        cols[ubi, slot] = ubj
        dev = T.resolve_device(device)
        return SparseRowMatrix(torch.from_numpy(data).to(dev),
                               torch.from_numpy(cols).to(dev), dims=(m, n),
                               nnz=int(np.count_nonzero(blocks)))

    # -- bookkeeping ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return self.dims

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def bs(self) -> int:
        return self.data.shape[-1]

    @property
    def ell(self) -> int:
        return self.data.shape[1]

    @property
    def n_pad(self) -> int:
        return _rup(self.dims[1], self.bs)

    @property
    def m_pad(self) -> int:
        return self.data.shape[0] * self.bs

    def block_density(self) -> float:
        """Stored block fraction."""
        return self.ell / (self.n_pad // self.bs)

    @property
    def out_dtype(self) -> torch.dtype:
        """float32 for int8 or sub-f32 storage: narrow storage never narrows
        the math the caller sees."""
        d = self.data.dtype
        return torch.float32 if (self.scales is not None
                                 or d.itemsize < 4) else d

    def dequantize(self) -> "SparseRowMatrix":
        """Exact-f32 copy (identity when storage is already exact)."""
        if self.scales is None:
            return self
        data = self.data.float() * self.scales[..., None, None]
        return replace(self, data=data, scales=None)

    def astype_store(self, dtype) -> "SparseRowMatrix":
        """Recast the stored blocks.  int8 quantizes with per-block f32
        scales (absmax/127, zero blocks get scale 1); any float dtype
        dequantizes first and recasts."""
        if dtype == "int8":
            dtype = torch.int8
        if dtype == torch.int8:
            if self.scales is not None:
                return self
            q, scales = _bsr.quantize_blocks(self.data)
            return replace(self, data=q, scales=scales)
        out = self.dequantize()
        if dtype == out.data.dtype:
            return out
        return replace(out, data=out.data.to(dtype))

    def _local(self) -> _bsr.BlockELL:
        """The strip as a BlockELL, kept so its column index (built at the
        first AᵀX) is built once."""
        if "local" not in self._cache:
            self._cache["local"] = _bsr.BlockELL(
                self.data, self.cols, (self.m_pad, self.n_pad), self.scales)
        return self._cache["local"]

    def _use_bsr(self, dispatch: str) -> bool:
        if dispatch not in _DISPATCH:
            raise ValueError(f"dispatch must be auto | bsr | dense, "
                             f"got {dispatch!r}")
        return dispatch != "dense"

    def _dense(self) -> torch.Tensor:
        """The padded strip densified (f32 for int8 storage)."""
        return self._local().to_dense()

    def _row_mask(self) -> torch.Tensor:
        """{0,1} mask of true (non-padding) rows."""
        idx = torch.arange(self.m_pad, device=self.device)
        return (idx < self.dims[0]).to(self.out_dtype)

    # -- matrix ops ----------------------------------------------------------
    def matvec(self, v: torch.Tensor, *,
               dispatch: str = "auto") -> torch.Tensor:
        """A v → (m_pad,)."""
        v = torch.as_tensor(v)
        vp = F.pad(v, (0, self.n_pad - self.dims[1]))
        if self._use_bsr(dispatch):
            return _ops.bsr_matvec(self._local(), vp)
        dense = self._dense()
        dt = torch.promote_types(dense.dtype, v.dtype)
        return dense.to(dt) @ vp.to(dt)

    def rmatvec(self, u: torch.Tensor, *,
                dispatch: str = "auto") -> torch.Tensor:
        """Aᵀ u for a data-space u (up to m_pad rows) → (n,)."""
        u = torch.as_tensor(u)
        up = F.pad(u, (0, self.m_pad - u.shape[0]))
        if self._use_bsr(dispatch):
            out = _ops.bsr_rmatmul(self._local(), up[:, None])[:, 0]
        else:
            dense = self._dense()
            dt = torch.promote_types(dense.dtype, u.dtype)
            out = dense.to(dt).T @ up.to(dt)
        return out[: self.dims[1]]

    def multiply_local(self, B: torch.Tensor, *,
                       dispatch: str = "auto") -> RowMatrix:
        """A @ B for a small B, the `U = A (VΣ⁻¹)` pattern.  A sparse matrix
        times a dense factor is dense, so the result is a RowMatrix of
        m_pad stored rows."""
        B = torch.as_tensor(B)
        Bp = F.pad(B, (0, 0, 0, self.n_pad - self.dims[1]))
        if self._use_bsr(dispatch):
            out = _ops.bsr_matmul(self._local(), Bp)
        else:
            out = _ops.gemm(self._dense(), Bp, out_dtype=B.dtype)
        return RowMatrix(rows=out, n_rows=self.dims[0])

    def fused_grad(self, x: torch.Tensor, smooth, *, dispatch: str = "auto",
                   chunks: int = 1, residual=None):
        """(f(Ax), Aᵀ∇f(Ax), Ax) in one pass over the stored blocks
        (fused_grad_bsr); `dispatch="dense"` densifies and takes the dense
        fused_grad.  `smooth` is a row-separable smooth or its RowSeparable
        form; its target/weights get padded to m_pad rows, padding rows
        weighted 0.  Returns (f32 scalar, (n,) gradient, (m_pad,) image)."""
        _check_chunks(chunks)
        if residual is not None:
            raise NotImplementedError(f"residual= (the compressed gradient "
                                      f"psum) waits for {MULTI_GPU_ITEM}")
        kind, t, w, prm = T.row_separable_inputs(smooth, self.m_pad,
                                                 self._row_mask)
        x = torch.as_tensor(x)
        xp = F.pad(x, (0, self.n_pad - x.shape[0]))
        if self._use_bsr(dispatch):
            f, g, z = _ops.fused_grad_bsr(self._local(), xp, t, w, loss=kind,
                                          param=prm)
        else:
            dense = self._dense()
            if dense.dtype not in (torch.float32, torch.bfloat16):
                dense = dense.float()
            f, g, z = _ops.fused_grad(dense, xp, t, w, loss=kind, param=prm)
        return f, g[: self.dims[1]], z

    def gram(self, *, dispatch: str = "auto") -> torch.Tensor:
        """AᵀA with the sparse operand on the transpose side (bsr_rmatmul
        over column strips of the densified strip, flops ∝ stored blocks ·
        n), or the dense tsgram kernel with dispatch="dense"."""
        dense = self._dense()
        if self._use_bsr(dispatch):
            df = dense.float()
            g = torch.cat([_ops.bsr_rmatmul(self._local(),
                                            df[:, i: i + _RMATMUL_STRIP])
                           for i in range(0, df.shape[1], _RMATMUL_STRIP)],
                          dim=1)
        else:
            if dense.dtype not in (torch.float32, torch.bfloat16):
                dense = dense.float()
            g = _ops.tsgram(dense, out_dtype=torch.float32)
        n = self.dims[1]
        return g[:n, :n].to(self.out_dtype)

    def frobenius_norm(self) -> torch.Tensor:
        d = self.dequantize().data.float()
        return torch.sqrt((d * d).sum())

    def column_norms(self) -> torch.Tensor:
        """Per-column L2 norms."""
        d = self.dequantize().data.float()
        sq = (d * d).sum(dim=2)                       # (nbr, ell, bs)
        out = torch.zeros((self.n_pad // self.bs, self.bs), dtype=sq.dtype,
                          device=self.device)
        out.index_add_(0, self.cols.reshape(-1).long(),
                       sq.reshape(-1, self.bs))
        return torch.sqrt(out.reshape(-1)[: self.dims[1]])

    def scale_columns(self, d: torch.Tensor) -> "SparseRowMatrix":
        """A · diag(d), scaling the stored blocks (the pattern is
        unchanged).  int8 storage dequantizes first: per-column scaling
        breaks the per-block scale."""
        if self.scales is not None:
            return self.dequantize().scale_columns(d)
        dp = F.pad(torch.as_tensor(d, device=self.device),
                   (0, self.n_pad - self.dims[1]))
        db = dp.reshape(-1, self.bs)                  # (nbc, bs)
        # bf16 storage times f32 scales promotes to f32, as in the reference.
        return replace(self, data=self.data * db[self.cols.long()][:, :, None, :])

    # -- what waits for later slices ------------------------------------------
    def fused_grad_multi(self, x, smooths, *, dispatch: str = "auto"):
        raise NotImplementedError(
            f"SparseRowMatrix.fused_grad_multi waits for {SPARSE_SERVING_ITEM}")

    def column_similarities(self, threshold: float = 0.0, **kw):
        raise NotImplementedError(
            f"column_similarities waits for {DIMSUM_ITEM}")

    def remesh(self, *args, **kw):
        raise NotImplementedError(f"remesh waits for {MULTI_GPU_ITEM}")

    def init_psum_residual(self):
        raise NotImplementedError(
            f"init_psum_residual waits for {MULTI_GPU_ITEM}")

    # -- conversions ---------------------------------------------------------
    def to_row_matrix(self) -> RowMatrix:
        """The strip densified in place: a RowMatrix of m_pad stored rows."""
        dense = self._dense()[:, : self.dims[1]]
        if dense.dtype not in (torch.float32, torch.bfloat16):
            dense = dense.float()
        return RowMatrix(rows=dense.contiguous(), n_rows=self.dims[0])

    def to_local(self) -> torch.Tensor:
        return self._dense()[: self.dims[0], : self.dims[1]]

    def transpose(self) -> "SparseRowMatrix":
        """Aᵀ with the same block size, through the dense matrix (the
        reference's driver-scale transpose)."""
        return SparseRowMatrix.from_dense(self.to_local().T, bs=self.bs,
                                          device=self.device)

    # -- linalg entry point --------------------------------------------------
    def compute_svd(self, k: int, **kw):
        from repro_torch.core.linalg import svd as _svd
        return _svd.compute_svd(self, k, **kw)
