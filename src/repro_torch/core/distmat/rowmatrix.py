"""RowMatrix: a row-partitioned dense matrix on one device.

Counterpart of src/repro/core/distmat/rowmatrix.py.  The reference shards
rows over a TPU mesh and runs each op as a shard_map body with a psum; here
there is one shard, so each op is its body alone.  `rows` may be padded past
`n_rows` (a matrix carried over from a multi-device reference keeps its
padding); padding rows are zero and weigh 0 in every loss.

The Gram goes through the tsgram kernel, the fused gradient through the
fused_grad kernel (fused_grad_multi for a group of right-hand sides), the
randomized SVD's projection AᵀQ through the randsketch kernel and the
small-factor product through the gemm kernel (kernels/ops: plain torch for
CPU tensors).  DIMSUM column similarities (``column_similarities``) run on
tsgram.

`IndexedRowMatrix` (paper §2.1) is a RowMatrix with meaningful row indices;
its `create` takes `device=` in the place of the reference's `mesh=`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.kernels import ops as _ops
from . import types as T

_CHUNKS_ITEM = "ROADMAP queue 1 item 13 (multi-GPU)"
# Rows of DIMSUM's column norms and keep mask handled at a time.
_DIMSUM_ROWS = 1 << 16


def _check_chunks(chunks) -> None:
    if chunks != 1:
        raise NotImplementedError(
            f"chunks={chunks!r}: only 1 until {_CHUNKS_ITEM} lands")


_LOW_PRECISION_ITEM = "ROADMAP queue 1 item 12 (low precision: fp8 storage)"


def _check_store(dtype) -> None:
    if dtype == torch.float8_e4m3fn:
        raise NotImplementedError(
            f"float8_e4m3fn storage waits for {_LOW_PRECISION_ITEM}: the "
            "kernels take float32 and bfloat16")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"storage must be float32 or bfloat16, got {dtype}")


@dataclass(frozen=True)
class RowMatrix(T.DistMatrix):
    rows: torch.Tensor               # (m_padded, n) on one device
    n_rows: int                      # true row count (pre-padding)

    # -- construction ------------------------------------------------------
    @staticmethod
    def create(rows, *, device="cuda", store_dtype=None) -> "RowMatrix":
        """`rows` on `device` (the card unless the caller asks for the
        CPU).  `store_dtype` (float32 or bfloat16) sets the storage type;
        every op upcasts what it reads and accumulates in f32, so results
        come back at `out_dtype`."""
        dev = T.resolve_device(device)
        rows = T.as_float_tensor(rows, dev)
        if store_dtype is not None:
            _check_store(store_dtype)
            rows = rows.to(store_dtype)
        _check_store(rows.dtype)
        padded, m = T.pad_rows(rows.contiguous(), 1)
        return RowMatrix(rows=padded, n_rows=m)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.rows.shape[1])

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def out_dtype(self) -> torch.dtype:
        """float32 when storage is narrower: low-precision storage never
        narrows the math the caller sees."""
        d = self.rows.dtype
        return torch.float32 if d.itemsize < 4 else d

    def astype_store(self, dtype) -> "RowMatrix":
        """Recast the storage (the planner's bf16 pick lands here); identity
        when the dtype already matches.  The recast is a second copy of A
        beside this one (bf16: half its f32 size), which stays as it is."""
        _check_store(dtype)
        if dtype == self.rows.dtype:
            return self
        return replace(self, rows=self.rows.to(dtype))

    def _row_mask(self) -> torch.Tensor:
        """{0,1} mask of true (non-padding) rows."""
        idx = torch.arange(self.rows.shape[0], device=self.device)
        return (idx < self.n_rows).to(self.out_dtype)

    # -- matrix ops ----------------------------------------------------------
    def gram(self, *, chunks: int = 1) -> torch.Tensor:
        """AᵀA (tsgram kernel).  Padding rows are zero and add nothing."""
        _check_chunks(chunks)
        g = _ops.tsgram(self.rows, out_dtype=torch.float32)
        return g.to(self.out_dtype)

    def _promoted(self, v: torch.Tensor) -> torch.Tensor:
        return self.rows.to(torch.promote_types(self.rows.dtype, v.dtype))

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A v → (m_padded,)."""
        return self._promoted(v) @ v

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u for a data-space u (m_padded,) → (n,)."""
        return self._promoted(u).T @ u

    def fused_grad(self, x: torch.Tensor, smooth, *, chunks: int = 1):
        """(f(Ax), Aᵀ∇f(Ax), Ax) in ONE streaming pass over A (fused_grad
        kernel).  `smooth` is a row-separable smooth or its RowSeparable
        form; its target/weights get padded to the stored row count, with
        padding rows weighted 0.  Returns (f32 scalar, (n,) gradient,
        (m_padded,) image)."""
        _check_chunks(chunks)
        kind, t, w, prm = T.row_separable_inputs(smooth, self.rows.shape[0],
                                                 self._row_mask)
        return _ops.fused_grad(self.rows, torch.as_tensor(x), t, w,
                               loss=kind, param=prm)

    def fused_grad_multi(self, x: torch.Tensor, smooths):
        """Request-batched fused gradients: (f, g, z) for a group of k
        right-hand sides in ONE streaming pass over A (fused_grad_multi
        kernel).  `x` is (k × n); `smooths` a sequence of k row-separable
        smooths sharing one loss kind/param, or one smooth with stacked 2-D
        targets.  Padding rows take the row mask.  Returns ((k,) values,
        (k × n) gradients, (k × m_padded) images)."""
        kind, t, w, prm = T.row_separable_batch_inputs(
            smooths, self.rows.shape[0], self._row_mask)
        x = torch.atleast_2d(torch.as_tensor(x))
        return _ops.fused_grad_multi(self.rows, x, t, w, loss=kind,
                                     param=prm)

    def sketch(self, r: int, *, seed: int = 0) -> "RowMatrix":
        """Y = A Ω for an (n × r) Gaussian test matrix Ω (randomized range
        finder), drawn from a torch.Generator on A's device seeded with
        `seed`: the same seed gives the same Ω.  The product is one plain
        matmul, as the reference leaves it to XLA outside any kernel."""
        n = self.rows.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        omega = torch.randn((n, r), generator=gen, device=self.device,
                            dtype=torch.float32).to(self.rows.dtype)
        return replace(self, rows=self.rows @ omega)

    def project(self, Q: "RowMatrix", *,
                out_dtype=torch.float32) -> torch.Tensor:
        """B = AᵀQ for a row-conforming Q (randsketch kernel), the
        randomized SVD's projection.  Padding rows are zero in both
        operands and add nothing."""
        out = _ops.randsketch(self.rows, Q.rows, out_dtype=torch.float32)
        return out.to(out_dtype)

    def multiply_local(self, B: torch.Tensor) -> "RowMatrix":
        """A @ B for a small B, the `U = A (VΣ⁻¹)` pattern (gemm kernel);
        the result keeps the storage type, as in the reference."""
        return replace(self, rows=_ops.gemm(self.rows, B,
                                            out_dtype=self.rows.dtype))

    def scale_columns(self, d: torch.Tensor) -> "RowMatrix":
        """A · diag(d) (DIMSUM's column scaling); bf16 storage times f32
        scales promotes to f32, as in the reference."""
        return replace(self, rows=self.rows * d[None, :])

    def column_stats(self) -> dict[str, torch.Tensor]:
        """Per-column statistics (MLlib colStats)."""
        m = self.n_rows
        mask = self._row_mask()
        a = self.rows
        am = a * mask[:, None]
        s = am.sum(0)
        sq = (am * am).sum(0)
        nnz = (am != 0).sum(0)
        keep = mask[:, None] > 0
        mn = torch.where(keep, a, torch.inf).amin(0)
        mx = torch.where(keep, a, -torch.inf).amax(0)
        mean = s / m
        var = torch.clamp(sq / m - mean * mean, min=0.0) * (m / max(m - 1, 1))
        return {"mean": mean, "variance": var, "num_nonzeros": nnz,
                "min": mn, "max": mx, "norm_l2": torch.sqrt(sq)}

    def frobenius_norm(self) -> torch.Tensor:
        a = self.rows.float()
        return torch.sqrt((a * a).sum())

    def column_norms(self) -> torch.Tensor:
        """Per-column L2 norms of the true rows (column_stats' norm_l2) in
        f32, summed in float64 a chunk of rows at a time, so that no copy
        of A is made."""
        sq = torch.zeros(self.rows.shape[1], dtype=torch.float64,
                         device=self.device)
        for i in range(0, self.n_rows, _DIMSUM_ROWS):
            c = self.rows[i:min(i + _DIMSUM_ROWS, self.n_rows)].double()
            sq += (c * c).sum(0)
        return torch.sqrt(sq).float()

    def column_similarities(self, threshold: float = 0.0, *,
                            gamma: float | None = None, seed: int = 0,
                            return_info: bool = False):
        """DIMSUM cosine similarities of the columns through tsgram
        (types.column_similarities); the keep mask is drawn a chunk of rows
        at a time into the one sampled copy."""
        return T.column_similarities(self, threshold, gamma=gamma, seed=seed,
                                     return_info=return_info)

    def _sampled(self, p, scale, gen) -> "RowMatrix":
        """Sampled DIMSUM's copy: entry (k, i) kept with probability p[i]
        and scaled by scale[i], in f32."""
        m_pad, n = self.rows.shape
        b = torch.empty((m_pad, n), dtype=torch.float32, device=self.device)
        for i in range(0, m_pad, _DIMSUM_ROWS):
            a = self.rows[i:i + _DIMSUM_ROWS]
            keep = torch.rand(a.shape, generator=gen, device=self.device) < p
            b[i:i + _DIMSUM_ROWS] = torch.where(keep, a, 0.0) * scale
            del keep
        return replace(self, rows=b)

    def _square_(self) -> "RowMatrix":
        """The entries squared in place (on a fresh scaled copy)."""
        self.rows.square_()
        return self

    def to_sparse_row_matrix(self, bs: int | str = "auto"):
        """Block-compress into the block-sparse row type on this device;
        bs="auto" takes plan("bsr_bs")'s block size, as from_dense does."""
        from .sparserow import SparseRowMatrix
        return SparseRowMatrix.from_dense(self.to_local(), bs=bs,
                                          device=self.device)

    # -- materialization ----------------------------------------------------
    def to_local(self) -> torch.Tensor:
        return self.rows[: self.n_rows]

    # -- linalg entry points (implemented in core.linalg) -------------------
    def compute_svd(self, k: int, **kw):
        from repro_torch.core.linalg import svd as _svd
        return _svd.compute_svd(self, k, **kw)

    def compute_pca(self, k: int, **kw):
        from repro_torch.core.linalg import svd as _svd
        return _svd.compute_pca(self, k, **kw)

    def tall_skinny_qr(self):
        from repro_torch.core.linalg.tsqr import tsqr
        return tsqr(self)


@dataclass(frozen=True)
class IndexedRowMatrix(T.DistMatrix):
    """RowMatrix plus meaningful row indices (paper §2.1)."""
    indices: torch.Tensor            # (m_padded,) int64
    inner: RowMatrix

    @staticmethod
    def create(indices, rows, *, device="cuda") -> "IndexedRowMatrix":
        rm = RowMatrix.create(rows, device=device)
        idx = torch.as_tensor(indices, device=rm.device).to(torch.int64)
        if idx.shape != (rm.n_rows,):
            raise ValueError(f"{tuple(idx.shape)} indices for {rm.n_rows} "
                             "rows")
        return IndexedRowMatrix(indices=idx, inner=rm)

    @property
    def shape(self) -> tuple[int, int]:
        return self.inner.shape

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def to_row_matrix(self) -> RowMatrix:
        return self.inner

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.inner.matvec(v)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return self.inner.rmatvec(u)

    def to_local(self) -> torch.Tensor:
        """Rows placed at their indices in a (max index + 1, n) matrix."""
        idx = self.indices[: self.inner.n_rows]
        dense = self.inner.to_local()
        rows = int(idx.max()) + 1 if idx.numel() else 0
        out = dense.new_zeros((rows, dense.shape[1]))
        out[idx] = dense
        return out
