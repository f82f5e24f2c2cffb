"""SparseRowMatrix: a row-partitioned block-sparse matrix.

Counterpart of src/repro/core/distmat/sparserow.py.  The reference keeps
one BlockELL strip of block-rows per device of a TPU mesh and runs each op
as a shard_map body with a psum.  Here each rank of a `Mesh`
(core/distmat/types) keeps its contiguous strip of block-rows, each op
runs its body on the strip, and each psum is an all_reduce over the row
group (compat.py); without a mesh there is one strip on one device and no
collective.  Every strip has the whole matrix's ELL width.  The stored
block-rows may outnumber the true rows; padding rows are zero blocks and
weigh 0 in every loss.

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
(``column_similarities``) run on the sparse Gram.  ``residual=`` sends the
fused gradient over the compressed int8 all_reduce ("psum8"), and
``chunks`` > 1 all_reduces it a column segment at a time behind the next
segment's (both arms keep their one fused pass over the stored blocks;
the reference's dense arm splits its pass, a difference within
tolerance).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch
import torch.nn.functional as F

from repro_torch.kernels import bsr as _bsr
from repro_torch.kernels import ops as _ops
from repro_torch.launch import planner as _planner
from repro_torch import compat
from . import types as T
from .types import dimsum_gamma  # noqa: F401  (the reference's home)
from .rowmatrix import (_SHARD_SEED_STEP, RowMatrix, _record_collective,
                        _segmented_psum, _Sharded, chunk_bounds)

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
class SparseRowMatrix(_Sharded, T.DistMatrix):
    data: torch.Tensor            # this strip's (nbr_local, ell, bs, bs)
    cols: torch.Tensor            # (nbr_local, ell) int32
    dims: tuple[int, int]         # true global (m, n) before any padding
    nnz: int
    # Per-stored-block f32 scales (nbr_local, ell), set iff data is int8.
    scales: torch.Tensor | None = None
    mesh: T.Mesh | None = field(default=None, repr=False, compare=False)
    row_axes: tuple[str, ...] = T.ROW_AXES
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_dense(a, bs: int | str = "auto", *, device="cuda",
                   nx_hint: int = 128, quantize: str = "none",
                   tol: float = 1e-3, mesh=None,
                   row_axes=None) -> "SparseRowMatrix":
        """Block-compress a dense matrix on `device` (the card unless the
        caller asks for the CPU).  bs="auto" takes plan("bsr_bs")'s block
        size for products of `nx_hint` columns.  `quantize` "int8" stores
        int8 blocks with per-block f32 scales; "auto" stores them where the
        planner's precision sweep admits int8 at `tol`.  With `mesh`,
        every rank converts the whole matrix on its device (driver scale,
        as the reference converts on the host) and keeps its strip of
        block-rows (``remesh``)."""
        if mesh is not None and mesh.size > 1:
            whole = SparseRowMatrix.from_dense(
                a, bs, device=mesh.device, nx_hint=nx_hint,
                quantize=quantize, tol=tol)
            return whole.remesh(mesh, row_axes)
        dev = T.resolve_device(mesh.device if mesh is not None else device)
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
                     bs: int | str = "auto", *, device="cuda", mesh=None,
                     row_axes=None) -> "SparseRowMatrix":
        """COO entries → block-ELL without the dense matrix, on `device`:
        entries are binned into (block-row, block-column) keys with one
        torch.unique and one accumulating index_put_, as the reference bins
        them with np.unique and np.add.at; duplicates add up.  bs="auto"
        prices each candidate at the ELL width the indices give it.  With
        `mesh`, every rank bins all entries and keeps its strip of
        block-rows (``remesh``)."""
        if mesh is not None and mesh.size > 1:
            whole = SparseRowMatrix.from_entries(
                row_idx, col_idx, values, shape, bs, device=mesh.device)
            return whole.remesh(mesh, row_axes)
        dev = T.resolve_device(mesh.device if mesh is not None else device)
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
    def _m_local(self) -> int:
        return self.data.shape[0] * self.bs

    @property
    def m_pad(self) -> int:
        """Padded global row count: the strips' block-rows together."""
        return self._m_local * self.nshards

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
                self.data, self.cols, (self._m_local, self.n_pad),
                self.scales)
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
                {"m": self._m_local, "n": self.n_pad, "nx": max(nx, 1),
                 "ell": self.ell, "bs": self.bs}, self.data.dtype,
                backend=self.device.type).choice == "bsr"
        return self._cache[key]

    def _dense(self) -> torch.Tensor:
        """The padded strip densified (f32 for int8 storage)."""
        return self._local().to_dense()

    # -- matrix ops ----------------------------------------------------------
    def matvec(self, v: torch.Tensor, *,
               dispatch: str = "auto") -> torch.Tensor:
        """A v for a replicated v → this strip's rows (m_pad on one
        device)."""
        v = torch.as_tensor(v)
        vp = F.pad(v, (0, self.n_pad - self.dims[1]))
        if self._use_bsr(1, dispatch):
            return _ops.bsr_matvec(self._local(), vp)
        dense = self._dense()
        dt = torch.promote_types(dense.dtype, v.dtype)
        return dense.to(dt) @ vp.to(dt)

    def rmatvec(self, u: torch.Tensor, *,
                dispatch: str = "auto") -> torch.Tensor:
        """Aᵀ u for a data-space u (the strip's piece, or a global vector
        cut to it) → (n,) on every rank (one all_reduce)."""
        up = self._local_data(u)
        if self._use_bsr(1, dispatch):
            out = _ops.bsr_rmatmul(self._local(), up[:, None])[:, 0]
        else:
            dense = self._dense()
            dt = torch.promote_types(dense.dtype, up.dtype)
            out = dense.to(dt).T @ up.to(dt)
        return self._psum(out)[: self.dims[1]]

    def multiply_local(self, B: torch.Tensor, *,
                       dispatch: str = "auto") -> RowMatrix:
        """A @ B for a small replicated B, the `U = A (VΣ⁻¹)` pattern, on
        each strip.  A sparse matrix times a dense factor is dense, so the
        result is a RowMatrix of the strip's stored rows, on this mesh."""
        B = torch.as_tensor(B)
        Bp = F.pad(B, (0, 0, 0, self.n_pad - self.dims[1]))
        if self._use_bsr(B.shape[1], dispatch):
            out = _ops.bsr_matmul(self._local(), Bp)
        else:
            out = _ops.gemm(self._dense(), Bp, out_dtype=B.dtype)
        return RowMatrix(rows=out, n_rows=self.dims[0], mesh=self.mesh,
                         row_axes=self.row_axes)

    def init_psum_residual(self) -> torch.Tensor:
        """Zeroed f32 error-feedback residual of the compressed ("psum8")
        fused_grad reduction: this strip's (1, n_pad) row (the kernel's
        gradient is n_pad long)."""
        return torch.zeros((1, self.n_pad), dtype=torch.float32,
                           device=self.device)

    def fused_grad(self, x: torch.Tensor, smooth, *, dispatch: str = "auto",
                   chunks: int | str = "auto", residual=None):
        """(f(Ax), Aᵀ∇f(Ax), Ax) in one pass over the strip's stored blocks
        (fused_grad_bsr); `dispatch="dense"` densifies and takes the dense
        fused_grad.  `smooth` is a row-separable smooth or its RowSeparable
        form; its target/weights are data-space vectors (global, cut to the
        strip, or the strip's piece), padding rows weighted 0.  Returns
        (f32 scalar and (n,) gradient, all_reduced over the row group; the
        strip's image).

        `chunks` > 1 (planner-chosen on "auto", plan("grad") with this
        mesh's axis sizes) all_reduces the gradient a column segment at a
        time, each segment's issued behind the next's.  `residual` (from
        init_psum_residual) sends it over the compressed int8 wire with
        error feedback, as RowMatrix.fused_grad does, and returns (f, g,
        z, new_residual)."""
        kind, t, w, prm = T.row_separable_inputs(
            smooth, self._m_local, self._row_mask, self._local_data)
        x = torch.as_tensor(x)
        xp = F.pad(x, (0, self.n_pad - x.shape[0]))
        n = self.dims[1]
        if self._one_eager(chunks, residual):
            f, g, z = self._fused_pass(xp, kind, t, w, prm, dispatch)
            return f, g[:n], z
        from repro_torch.launch import telemetry as _tel
        c, plan = self._resolve_chunks(
            "grad", chunks, {"m": self._m_local, "n": self.n_pad},
            self.data.dtype)
        wire = "int8" if residual is not None else "f32"
        with _tel.current().span("collective.fused_grad", op="grad",
                                 n=self.n_pad, chunks=c, wire=wire) as sp:
            f, g, z = self._fused_pass(xp, kind, t, w, prm, dispatch)
            out = self._reduce_grad(f, g, z, c, residual)
            sp.sync_on(out[1])
        _record_collective(plan, sp, collective="psum", chunks=c, wire=wire)
        return (out[0], out[1][:n]) + tuple(out[2:])

    def _fused_pass(self, xp, kind, t, w, prm, dispatch):
        """The strip's (f, g, z) before any reduction: fused_grad_bsr over
        the stored blocks, or the dense fused_grad on the densified strip."""
        if self._use_bsr(1, dispatch):
            return _ops.fused_grad_bsr(self._local(), xp, t, w, loss=kind,
                                       param=prm)
        dense = self._dense()
        if dense.dtype not in (torch.float32, torch.bfloat16):
            dense = dense.float()
        return _ops.fused_grad(dense, xp, t, w, loss=kind, param=prm)

    def _reduce_grad(self, f, g, z, c: int, residual):
        """(f, g) all_reduced over the row group: g in `c` column segments
        (each issued behind the next), over the int8 wire when a residual
        came in (then its update rides along)."""
        from repro_torch.train import compression as _comp
        mesh, axes, nsh = self.mesh, self.row_axes, self.nshards
        bounds = chunk_bounds(self.n_pad, c) if c > 1 \
            else ((0, self.n_pad),)
        if residual is not None:
            outs = [_comp.psum_int8(g[s0:s1], residual[0, s0:s1], mesh,
                                    axes, nsh) for s0, s1 in bounds]
            return (self._psum(f), torch.cat([o[0] for o in outs]), z,
                    torch.cat([o[1] for o in outs])[None])
        if c > 1:
            return (self._psum(f),
                    _segmented_psum([g[s0:s1] for s0, s1 in bounds], mesh,
                                    axes), z)
        fg = self._psum(torch.cat([g, f.reshape(1).to(g.dtype)]))
        return fg[-1].to(f.dtype), fg[:-1], z

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
        kind, t, w, prm = T.row_separable_batch_inputs(
            smooths, self._m_local, self._row_mask, self._local_data)
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
        if self.nshards > 1:
            k = g.shape[0]
            fg = self._psum(torch.cat([g.reshape(-1), f.to(g.dtype)]))
            f, g = fg[-k:].to(f.dtype), fg[:-k].reshape(g.shape)
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
        return self._psum(g)[:n, :n].to(self.out_dtype)

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
        return torch.sqrt(self._psum((d * d).sum()))

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
        out = self._psum(out.reshape(-1))
        return torch.sqrt(out[: self.dims[1]]).float()

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
        with probability p[i] and scaled by scale[i], in f32.  Strip i > 0
        reseeds `gen` (as RowMatrix._sampled does)."""
        if self.shard:
            gen.manual_seed((gen.initial_seed()
                             + self.shard * _SHARD_SEED_STEP) % (1 << 63))
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

    # -- meshes --------------------------------------------------------------
    def _whole(self) -> tuple:
        """(data, cols, scales) of every block-row, on every rank (the
        strips all_gathered in order; the stored tensors on one strip)."""
        if self.nshards == 1:
            return self.data, self.cols, self.scales

        def gather(t):
            p = compat.all_gather(t, self.mesh, self.row_axes)
            return p.reshape(-1, *t.shape[1:])

        return (gather(self.data), gather(self.cols),
                None if self.scales is None else gather(self.scales))

    def remesh(self, mesh: T.Mesh | None,
               row_axes=None) -> "SparseRowMatrix":
        """The same logical matrix on another mesh (every rank of both
        calls it): the block-rows gathered, re-padded for the new shard
        count (padding block-rows hold zero blocks at column 0, int8 scale
        1, which add nothing) and cut to this rank's strip.  Block size,
        ELL width and the stored blocks are unchanged.  A rank outside the
        new mesh (one an elastic re-mesh dropped) keeps the whole matrix
        on its own device and no mesh."""
        data, cols, scales = self._whole()
        if mesh is not None and (mesh.size == 1 or not mesh.member):
            mesh = None
        row_axes = tuple(row_axes) if row_axes else T.row_axes_for(mesh)
        nsh = T.axes_size(mesh, row_axes)
        nbr_true = _rup(self.dims[0], self.bs) // self.bs
        nbr_pad = _rup(max(nbr_true, 1), nsh)
        r0, nbr_local = T.shard_range(nbr_pad, nsh,
                                      compat.axis_index(mesh, row_axes))

        def strip(t, fill):
            piece = t[r0:min(r0 + nbr_local, t.shape[0])]
            extra = nbr_local - piece.shape[0]
            if extra:
                piece = torch.cat([piece, torch.full(
                    (extra, *t.shape[1:]), fill, dtype=t.dtype,
                    device=t.device)])
            return piece.clone()

        return SparseRowMatrix(
            strip(data, 0), strip(cols, 0), dims=self.dims, nnz=self.nnz,
            scales=None if scales is None else strip(scales, 1.0),
            mesh=mesh, row_axes=row_axes)

    # -- conversions ---------------------------------------------------------
    def to_row_matrix(self) -> RowMatrix:
        """The strip densified in place: a RowMatrix of the strip's stored
        rows, on this mesh."""
        dense = self._dense()[:, : self.dims[1]]
        if dense.dtype not in (torch.float32, torch.bfloat16):
            dense = dense.float()
        return RowMatrix(rows=dense.contiguous(), n_rows=self.dims[0],
                         mesh=self.mesh, row_axes=self.row_axes)

    def to_local(self) -> torch.Tensor:
        """The whole matrix densified, on every rank (driver scale)."""
        dense = self._dense()
        if self.nshards > 1:
            dense = compat.all_gather(dense, self.mesh, self.row_axes)
            dense = dense.reshape(-1, self.n_pad)
        return dense[: self.dims[0], : self.dims[1]]

    def transpose(self) -> "SparseRowMatrix":
        """Aᵀ with the same block size, through the dense matrix (the
        reference's driver-scale transpose), on this mesh."""
        return SparseRowMatrix.from_dense(
            self.to_local().T, bs=self.bs, device=self.device,
            mesh=self.mesh, row_axes=self.row_axes)

    # -- linalg entry point --------------------------------------------------
    def compute_svd(self, k: int, **kw):
        from repro_torch.core.linalg import svd as _svd
        return _svd.compute_svd(self, k, **kw)

