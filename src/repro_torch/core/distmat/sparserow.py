"""SparseRowMatrix: a row-partitioned block-sparse matrix on one device.

Counterpart of src/repro/core/distmat/sparserow.py.  The reference keeps
one BlockELL strip of block-rows per device of a TPU mesh and runs each op
as a shard_map body with a psum; here there is one strip, so each op is
its body alone.  The stored block-rows may outnumber the true rows (a
matrix carried over from a multi-device reference keeps its padding);
padding rows are zero blocks and weigh 0 in every loss.

The products run the block-sparse kernels through kernels/ops (plain torch
for CPU tensors): matvec → bsr_matvec, rmatvec and the sparse Gram →
bsr_rmatmul (against one densified 512-column strip at a time),
multiply_local (the U = A(VΣ⁻¹) product) → bsr_matmul, the fused gradient
→ fused_grad_bsr (for int8 storage bsr_matvec and bsr_rmatmul) and its
request-batched form, the serving path's group pass → fused_grad_bsr_multi
(for int8 storage bsr_matmul and bsr_rmatmul).  ``dispatch="dense"``
densifies and takes the dense kernels instead, and ``dispatch="auto"``
(the default) asks the planner (launch/planner.plan("sparse_matmul"))
which of the two the product's shape favours.  ``bs="auto"`` prices each
candidate block size at its actual ELL width (plan("bsr_bs")), and
``quantize="auto"`` stores int8 blocks where the planner's precision sweep
admits them at ``tol``.  DIMSUM column similarities
(``column_similarities``) run on the sparse Gram.

Differences from the reference, each until its ROADMAP item lands:
``chunks`` stays at 1 and ``residual=`` raises (item 13).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch
import torch.nn.functional as F

from repro_torch.kernels import bsr as _bsr
from repro_torch.kernels import ops as _ops
from repro_torch.launch import planner as _planner
from . import types as T
from .types import dimsum_gamma  # noqa: F401  (the reference's home)
from .rowmatrix import _CHUNKS_ITEM as MULTI_GPU_ITEM
from .rowmatrix import RowMatrix, _check_chunks

_DISPATCH = ("auto", "bsr", "dense")
# Column-strip width of AᵀX with a wide X (the sparse Gram), as in the
# reference: each strip's partials stay (chunks × bs × 512) f32.
_RMATMUL_STRIP = 512
# Block-rows of sampled DIMSUM's keep mask (and of the column norms'
# float64 sums) handled at a time.
_MASK_BLOCK_ROWS = 2048


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_bs(bs) -> int:
    bs = int(bs)
    if bs not in _bsr.BS_CANDIDATES:
        raise ValueError(f"bs must be one of {_bsr.BS_CANDIDATES}, got {bs}")
    return bs


def _best_block_size(shape: tuple[int, int], dtype, ell_of_bs,
                     nx_hint: int, backend: str) -> int:
    """The block size plan("bsr_bs") picks, each candidate priced at the
    ELL width `ell_of_bs(bs)` it gives this matrix.  Shared by the dense
    and the COO "auto" constructors, so both pick the same block size for
    the same matrix."""
    ell_by_bs = {bs: ell_of_bs(bs) for bs in _planner.BS_CANDIDATES}
    p = _planner.plan("bsr_bs", {"m": shape[0], "n": shape[1],
                                 "nx": nx_hint}, dtype, backend=backend,
                      context={"ell_by_bs": ell_by_bs})
    return int(p.blocks["bs"])


def _auto_block_size(a: torch.Tensor, nx_hint: int) -> int:
    """Auto block size for a dense matrix: each candidate's widest
    block-row, counted on a's device."""
    m, n = a.shape
    nz = a != 0

    def ell_of_bs(bs):
        mp, npd = _rup(max(m, 1), bs), _rup(n, bs)
        padded = F.pad(nz, (0, npd - n, 0, mp - m))
        blocks = padded.reshape(mp // bs, bs, npd // bs, bs).any(dim=3) \
            .any(dim=1)
        return max(1, int(blocks.sum(dim=1).max()))

    return _best_block_size(a.shape, a.dtype, ell_of_bs, nx_hint,
                            a.device.type)


def _entries_block_size(ri, ci, shape, dtype, backend: str, *,
                        nx_hint: int = 128) -> int:
    """Auto block size for COO input: each candidate's widest block-row
    from the index arrays alone (no densification)."""
    n = shape[1]

    def ell_of_bs(bs):
        nbc = _rup(n, bs) // bs
        key = torch.unique((ri // bs) * nbc + (ci // bs))
        if key.numel() == 0:
            return 1
        return max(1, int(torch.bincount(key // nbc).max()))

    return _best_block_size(shape, dtype, ell_of_bs, nx_hint, backend)


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
    def from_dense(a, bs: int | str = "auto", *, device="cuda",
                   nx_hint: int = 128, quantize: str = "none",
                   tol: float = 1e-3) -> "SparseRowMatrix":
        """Block-compress a dense matrix on `device` (the card unless the
        caller asks for the CPU).  bs="auto" takes plan("bsr_bs")'s block
        size for products of `nx_hint` columns.  `quantize` "int8" stores
        int8 blocks with per-block f32 scales; "auto" stores them where the
        planner's precision sweep admits int8 at `tol`."""
        dev = T.resolve_device(device)
        a = T.as_float_tensor(a, dev)
        m, n = a.shape
        if bs == "auto":
            bs = _auto_block_size(a, nx_hint)
        bs = _check_bs(bs)
        padded = F.pad(a, (0, _rup(n, bs) - n, 0, _rup(max(m, 1), bs) - m))
        bell = _bsr.BlockELL.from_dense(padded, bs, quantize=quantize,
                                        tol=tol)
        return SparseRowMatrix(bell.data, bell.cols, dims=(m, n),
                               nnz=int(torch.count_nonzero(a)),
                               scales=bell.scales)

    @staticmethod
    def from_entries(row_idx, col_idx, values, shape: tuple[int, int],
                     bs: int | str = "auto", *,
                     device="cuda") -> "SparseRowMatrix":
        """COO entries → block-ELL without the dense matrix, on `device`:
        entries are binned into (block-row, block-column) keys with one
        torch.unique and one accumulating index_put_, as the reference bins
        them with np.unique and np.add.at; duplicates add up.  bs="auto"
        prices each candidate at the ELL width the indices give it."""
        dev = T.resolve_device(device)
        ri = torch.as_tensor(row_idx, device=dev).long()
        ci = torch.as_tensor(col_idx, device=dev).long()
        va = T.as_float_tensor(values, dev)
        m, n = shape
        if bs == "auto":
            bs = _entries_block_size(ri, ci, shape, va.dtype, dev.type)
        bs = _check_bs(bs)
        nbc = _rup(n, bs) // bs
        nbr = _rup(max(m, 1), bs) // bs
        key = (ri // bs) * nbc + ci // bs
        uniq, inv = torch.unique(key, return_inverse=True)
        nb = uniq.shape[0]
        blocks = va.new_zeros((max(nb, 1), bs, bs))
        blocks.index_put_((inv, ri % bs, ci % bs), va, accumulate=True)
        del key, inv
        ubi, ubj = uniq // nbc, uniq % nbc
        counts = torch.bincount(ubi, minlength=nbr)
        ell = max(1, int(counts.max())) if nb else 1
        slot = torch.arange(nb, device=dev) - (torch.cumsum(counts, 0)
                                               - counts)[ubi]
        data = va.new_zeros((nbr, ell, bs, bs))
        cols = torch.zeros((nbr, ell), dtype=torch.int32, device=dev)
        data[ubi, slot] = blocks[:nb]
        cols[ubi, slot] = ubj.to(torch.int32)
        return SparseRowMatrix(data, cols, dims=(m, n),
                               nnz=int(torch.count_nonzero(blocks)))

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

    def _use_bsr(self, nx: int, dispatch: str) -> bool:
        """BlockELL kernels or the densified dense ones for a product with
        nx columns: "auto" asks plan("sparse_matmul") once per nx and
        keeps the answer until the planner's caches are cleared (a
        recalibration), so a solve's products pay no planning."""
        if dispatch in ("bsr", "dense"):
            return dispatch == "bsr"
        if dispatch != "auto":
            raise ValueError(f"dispatch must be auto | bsr | dense, "
                             f"got {dispatch!r}")
        key = ("use_bsr", max(nx, 1), _planner.generation)
        if key not in self._cache:
            self._cache[key] = _planner.plan(
                "sparse_matmul",
                {"m": self.m_pad, "n": self.n_pad, "nx": max(nx, 1),
                 "ell": self.ell, "bs": self.bs}, self.data.dtype,
                backend=self.device.type).choice == "bsr"
        return self._cache[key]

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
        if self._use_bsr(1, dispatch):
            return _ops.bsr_matvec(self._local(), vp)
        dense = self._dense()
        dt = torch.promote_types(dense.dtype, v.dtype)
        return dense.to(dt) @ vp.to(dt)

    def rmatvec(self, u: torch.Tensor, *,
                dispatch: str = "auto") -> torch.Tensor:
        """Aᵀ u for a data-space u (up to m_pad rows) → (n,)."""
        u = torch.as_tensor(u)
        up = F.pad(u, (0, self.m_pad - u.shape[0]))
        if self._use_bsr(1, dispatch):
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
        if self._use_bsr(B.shape[1], dispatch):
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
        if self._use_bsr(1, dispatch):
            f, g, z = _ops.fused_grad_bsr(self._local(), xp, t, w, loss=kind,
                                          param=prm)
        else:
            dense = self._dense()
            if dense.dtype not in (torch.float32, torch.bfloat16):
                dense = dense.float()
            f, g, z = _ops.fused_grad(dense, xp, t, w, loss=kind, param=prm)
        return f, g[: self.dims[1]], z

    def fused_grad_multi(self, x: torch.Tensor, smooths, *,
                         dispatch: str = "auto"):
        """Request-batched fused gradients over the stored blocks: a group
        of k right-hand sides answered with ONE read of each stored block
        (fused_grad_bsr_multi; for int8 storage bsr_matmul and
        bsr_rmatmul); `dispatch="dense"` densifies and takes the dense
        fused_grad_multi.  `x` (k × n); `smooths` a sequence of k
        row-separable smooths sharing one loss kind/param, or one smooth
        with stacked targets, padded to m_pad rows with padding rows
        weighted 0.  Returns ((k,) values, (k × n) gradients, (k × m_pad)
        images)."""
        kind, t, w, prm = T.row_separable_batch_inputs(smooths, self.m_pad,
                                                       self._row_mask)
        x = torch.atleast_2d(torch.as_tensor(x))
        xp = F.pad(x, (0, self.n_pad - x.shape[1]))
        if self._use_bsr(1, dispatch):
            f, g, z = _ops.fused_grad_bsr_multi(self._local(), xp, t, w,
                                                loss=kind, param=prm)
        else:
            dense = self._dense()
            if dense.dtype not in (torch.float32, torch.bfloat16):
                dense = dense.float()
            f, g, z = _ops.fused_grad_multi(dense, xp, t, w, loss=kind,
                                            param=prm)
        return f, g[:, : self.dims[1]], z

    def gram(self, *, dispatch: str = "auto") -> torch.Tensor:
        """AᵀA with the sparse operand on the transpose side: bsr_rmatmul
        against one densified 512-column strip of A at a time (flops ∝
        stored blocks · n; the whole m_pad × n_pad matrix is never built),
        or the dense tsgram kernel with dispatch="dense"."""
        if self._use_bsr(self.n_pad, dispatch):
            local = self._local()
            strips = []
            for c0 in range(0, self.n_pad, _RMATMUL_STRIP):
                strip = self._dense_columns(
                    c0, min(c0 + _RMATMUL_STRIP, self.n_pad))
                strips.append(_ops.bsr_rmatmul(local, strip))
                del strip
            g = torch.cat(strips, dim=1)
        else:
            dense = self._dense()
            if dense.dtype not in (torch.float32, torch.bfloat16):
                dense = dense.float()
            g = _ops.tsgram(dense, out_dtype=torch.float32)
        n = self.dims[1]
        return g[:n, :n].to(self.out_dtype)

    def _dense_columns(self, c0: int, c1: int) -> torch.Tensor:
        """Columns [c0, c1) of the padded strip densified in f32 (c0 and c1
        multiples of bs): only the blocks whose column falls inside are
        gathered, slot by slot in order, so the values are those of the
        whole densified strip (int8 blocks scaled as in to_dense)."""
        bs, nbr = self.bs, self.data.shape[0]
        j0, nbj = c0 // bs, (c1 - c0) // bs
        out = torch.zeros((nbr, bs, nbj, bs), dtype=torch.float32,
                          device=self.device)
        for s in range(self.ell):
            c = self.cols[:, s].long() - j0
            rows = torch.nonzero((c >= 0) & (c < nbj)).squeeze(1)
            blk = self.data[rows, s].float()
            if self.scales is not None:
                blk = blk * self.scales[rows, s, None, None]
            # One block-row appears once a slot, so no index repeats.
            out[rows, :, c[rows], :] += blk
        return out.reshape(nbr * bs, nbj * bs)

    def frobenius_norm(self) -> torch.Tensor:
        d = self.dequantize().data.float()
        return torch.sqrt((d * d).sum())

    def column_norms(self) -> torch.Tensor:
        """Per-column L2 norms in f32 (the DIMSUM scaling vector), summed
        in float64 in an order fixed by the block pattern: the stored
        blocks' column sums of squares, sorted by block column (the column
        index), then one sum per block column as a difference of prefix
        sums.  Runs repeat bit for bit; the reference sums in f32."""
        bs, nbr = self.bs, self.data.shape[0]
        sq = torch.empty((nbr, self.ell, bs), dtype=torch.float64,
                         device=self.device)
        for i in range(0, nbr, _MASK_BLOCK_ROWS):
            d = self.data[i:i + _MASK_BLOCK_ROWS].double()
            if self.scales is not None:
                d = d * self.scales[i:i + _MASK_BLOCK_ROWS, :, None, None]
            sq[i:i + _MASK_BLOCK_ROWS] = (d * d).sum(dim=2)
        order = self._local().column_index().order.long()
        prefix = F.pad(torch.cumsum(sq.reshape(-1, bs)[order], dim=0),
                       (0, 0, 1, 0))
        counts = torch.bincount(self.cols.reshape(-1).long(),
                                minlength=self.n_pad // bs)
        ends = torch.cumsum(counts, dim=0)
        out = prefix[ends] - prefix[ends - counts]    # (nbc, bs)
        return torch.sqrt(out.reshape(-1)[: self.dims[1]]).float()

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

    # -- DIMSUM --------------------------------------------------------------
    def column_similarities(self, threshold: float = 0.0, *,
                            gamma: float | None = None, seed: int = 0,
                            return_info: bool = False):
        """DIMSUM cosine similarities of the columns through the sparse Gram
        (types.column_similarities); the keep mask is drawn a chunk of
        block-rows at a time into one buffer.  int8 storage dequantizes
        first."""
        if self.scales is not None:
            return self.dequantize().column_similarities(
                threshold, gamma=gamma, seed=seed, return_info=return_info)
        return T.column_similarities(self, threshold, gamma=gamma, seed=seed,
                                     return_info=return_info)

    def _sampled(self, p, scale, gen) -> "SparseRowMatrix":
        """Sampled DIMSUM's copy of the stored blocks: entry (k, i) kept
        with probability p[i] and scaled by scale[i], in f32."""
        pad = self.n_pad - self.dims[1]
        pb = F.pad(p, (0, pad)).reshape(-1, self.bs)
        sb = F.pad(scale, (0, pad)).reshape(-1, self.bs)
        sampled = torch.empty(self.data.shape, dtype=torch.float32,
                              device=self.device)
        for i in range(0, self.data.shape[0], _MASK_BLOCK_ROWS):
            d = self.data[i:i + _MASK_BLOCK_ROWS]
            c = self.cols[i:i + _MASK_BLOCK_ROWS].long()
            u = torch.rand(d.shape, generator=gen, device=self.device)
            keep = u < pb[c][:, :, None, :]
            sampled[i:i + _MASK_BLOCK_ROWS] = (torch.where(keep, d, 0.0)
                                               * sb[c][:, :, None, :])
            del u, keep
        return replace(self, data=sampled)

    def _square_(self) -> "SparseRowMatrix":
        """The stored entries squared in place (on a fresh scaled copy)."""
        self.data.square_()
        return self

    # -- what waits for later slices ------------------------------------------
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

