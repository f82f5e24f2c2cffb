"""RowMatrix / IndexedRowMatrix: row-partitioned dense matrices.

Counterpart of src/repro/core/distmat/rowmatrix.py.  The reference shards
rows over a TPU mesh and runs each op as a shard_map body with a psum.
Here each rank of a `Mesh` (core/distmat/types) holds its strip of rows
as a plain local tensor, each op runs its body on that strip, and each
psum is an all_reduce over the mesh's row group (compat.py).  Matrix ops
(gram, matvec, the fused gradient, multiply_local, column stats) run on
the shards; vector results (the Gram, Aᵀu, the gradient, the stats) come
back with the same bits on every rank, the paper's "driver" copy.  A
matrix made without a mesh lives on one device: one shard, no collective.
`rows` holds the shard's rows padded to `n_rows` rounded up to the shard
count; padding rows are zero and weigh 0 in every loss.

The Gram goes through the tsgram kernel, the fused gradient through the
fused_grad kernel (fused_grad_multi for a group of right-hand sides), the
randomized SVD's projection AᵀQ through the randsketch kernel and the
small-factor product through the gemm kernel (kernels/ops: plain torch for
CPU tensors).  DIMSUM column similarities (``column_similarities``) run on
tsgram.  ``chunks`` > 1 runs the reference's overlapped schedules: column
segments whose all_reduces are issued behind the next segment's launch.

`IndexedRowMatrix` (paper §2.1) is a RowMatrix with meaningful row
indices.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import torch

from repro_torch import compat
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.dtypes import FP8, cast
from . import types as T

# Rows of DIMSUM's column norms and keep mask handled at a time.
_DIMSUM_ROWS = 1 << 16
# Seeds of the shards' DIMSUM keep masks: shard i draws from seed + i·step,
# so shard 0 draws what one device draws.
_SHARD_SEED_STEP = 0x9E3779B1


STORE_DTYPES = (torch.float32, torch.bfloat16, *FP8)


def _check_store(dtype) -> None:
    if dtype not in STORE_DTYPES:
        raise TypeError("storage must be float32 or bfloat16, or fp8 "
                        f"(float8_e4m3fn, float8_e5m2), got {dtype}")


def chunk_bounds(n: int, chunks: int) -> tuple[tuple[int, int], ...]:
    """Column-segment bounds of the overlapped bodies: `chunks` contiguous
    [s0, s1) segments covering [0, n)."""
    c = max(min(int(chunks), n), 1)
    step = -(-n // c)
    return tuple((s0, min(s0 + step, n)) for s0 in range(0, n, step))


def _record_collective(plan, span, **attrs) -> None:
    """Plan-vs-actual for one distributed op: the span's synced duration
    beside the comm-priced plan (launch/telemetry keeps the records)."""
    from repro_torch.launch import telemetry as _tel
    rec = _tel.current()
    if rec.enabled and plan is not None and span.dur_s > 0:
        rec.record_plan_actual(plan, span.dur_s, **attrs)


class _Sharded:
    """What RowMatrix and SparseRowMatrix share on a mesh: the row group,
    this shard's index, the data-space pieces and the collective plans."""

    @property
    def nshards(self) -> int:
        return T.axes_size(self.mesh, self.row_axes)

    @property
    def shard(self) -> int:
        return compat.axis_index(self.mesh, self.row_axes)

    def _local_data(self, v) -> torch.Tensor:
        """This shard's piece of a data-space vector (a global one is cut
        to the shard's rows; one of the shard's length passes)."""
        return T.local_data(v, self._m_local, self.nshards, self.shard)

    def _row_mask(self) -> torch.Tensor:
        """{0,1} mask of this shard's true (non-padding) rows."""
        start = self.shard * self._m_local
        idx = torch.arange(start, start + self._m_local, device=self.device)
        return (idx < self.shape[0]).to(self.out_dtype)

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        return compat.psum(t, self.mesh, self.row_axes)

    def _collective_plan(self, op: str, dims: dict, dtype):
        """Comm-priced plan for a distributed op on this mesh: the
        shard's dims and the row axes' sizes as the collective's
        topology."""
        from repro_torch.launch import mesh as _mesh
        from repro_torch.launch import planner as _planner
        return _planner.plan(
            op, dims, dtype, backend=self.device.type,
            context={"axes": _mesh.axis_sizes(self.mesh, self.row_axes)})

    def _plan(self, op: str, dims: dict, dtype):
        """_collective_plan kept per (op, planner generation), so a
        solve's passes pay no planning."""
        from repro_torch.launch import planner as _planner
        key = ("plan", op, _planner.generation)
        if key not in self._cache:
            self._cache[key] = self._collective_plan(op, dims, dtype)
        return self._cache[key]

    def _one_eager(self, chunks, residual=None) -> bool:
        """One shard, eager, the f32 wire: no collective to plan, time or
        record, so the op is its kernel alone."""
        return residual is None and chunks in ("auto", 1) \
            and self.nshards == 1

    def _resolve_chunks(self, op: str, chunks, dims: dict, dtype):
        """(chunk count, plan): the planner's pick on "auto" (1, eager,
        without asking on one shard), else the caller's."""
        if chunks == "auto" and self.nshards == 1:
            return 1, None
        plan = self._plan(op, dims, dtype)
        if chunks == "auto":
            return int(plan.blocks.get("chunks", 1)), plan
        return max(int(chunks), 1), plan


def _segmented_psum(parts, mesh, axes) -> torch.Tensor:
    """All-reduce column segments in order, each issued as soon as its
    part is launched and waited for in order, so segment k's reduction
    runs behind segment k + 1's launch; `parts` yields the parts."""
    pending = [compat.psum_start(p, mesh, axes) for p in parts]
    for _, work in pending:
        compat.wait(work)
    return torch.cat([buf for buf, _ in pending], dim=-1)


@dataclass(frozen=True)
class RowMatrix(_Sharded, T.DistMatrix):
    rows: torch.Tensor               # this shard's (m_local, n) rows
    n_rows: int                      # true global row count (pre-padding)
    mesh: T.Mesh | None = field(default=None, repr=False, compare=False)
    row_axes: tuple[str, ...] = T.ROW_AXES
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    # -- construction ------------------------------------------------------
    @staticmethod
    def create(rows, *, device="cuda", store_dtype=None, mesh=None,
               row_axes: Sequence[str] | None = None) -> "RowMatrix":
        """`rows` (global: numpy or a tensor) on `device`, the card unless
        the caller asks for the CPU.  With `mesh`, each rank keeps its
        padded strip on the mesh's device (rows shard over `row_axes`,
        every axis but "model" by default) and only the strip moves.
        `store_dtype` (float32, bfloat16, float8_e4m3fn or float8_e5m2)
        sets the storage type; every op upcasts what it reads and
        accumulates in f32, so results come back at `out_dtype`.  On fp8
        storage the ops the reference computes there run (the Gram, the
        fused gradients, chunked or not, multiply_local, sketch and
        project); the rest raise TypeError, as the reference raises
        (types.refuse_fp8)."""
        row_axes = tuple(row_axes) if row_axes else T.row_axes_for(mesh)
        if mesh is not None and mesh.size == 1:
            device, mesh = mesh.device, None
        if mesh is None:
            dev = T.resolve_device(device)
            local = T.as_float_tensor(rows, dev).contiguous()
            m = local.shape[0]
        else:
            m = int(rows.shape[0])
            local = T.shard_rows(rows, mesh.axes_size(row_axes),
                                 mesh.index(row_axes), mesh.device)
        if store_dtype is not None:
            _check_store(store_dtype)
            local = cast(local, store_dtype)
        _check_store(local.dtype)
        return RowMatrix(rows=local, n_rows=m, mesh=mesh, row_axes=row_axes)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.rows.shape[1])

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def _m_local(self) -> int:
        return self.rows.shape[0]

    @property
    def m_pad(self) -> int:
        """Padded global row count: the shards' rows together."""
        return self._m_local * self.nshards

    @property
    def out_dtype(self) -> torch.dtype:
        """float32 when storage is narrower: low-precision storage never
        narrows the math the caller sees."""
        d = self.rows.dtype
        return torch.float32 if d.itemsize < 4 else d

    def astype_store(self, dtype) -> "RowMatrix":
        """Recast the storage (the planner's bf16 pick lands here); identity
        when the dtype already matches.  The recast is a second copy of A
        beside this one (bf16: half its f32 size, fp8 a quarter), which
        stays as it is."""
        _check_store(dtype)
        if dtype == self.rows.dtype:
            return self
        return replace(self, rows=cast(self.rows, dtype))

    def _with_rows(self, rows: torch.Tensor) -> "RowMatrix":
        return replace(self, rows=rows)

    # -- matrix ops ----------------------------------------------------------
    def gram(self, *, chunks: int | str = "auto") -> torch.Tensor:
        """AᵀA on every rank: the shard's Gram (tsgram kernel), then one
        all_reduce over the row group.  Padding rows are zero.

        `chunks` > 1 runs the overlapped schedule the planner prices
        (plan("gram") with this mesh's axis sizes): one randsketch launch
        of Aᵀ·A[:, seg] a column segment, each segment's all_reduce issued
        behind the next segment's launch.  Within tolerance of the eager
        body, not bit for bit (another order of summation).  "auto" asks
        the planner; on one shard it is eager."""
        a, n = self.rows, self.rows.shape[1]
        if self._one_eager(chunks):
            return _ops.tsgram(a, out_dtype=torch.float32).to(self.out_dtype)
        from repro_torch.launch import telemetry as _tel
        c, plan = self._resolve_chunks(
            "gram", chunks, {"m": self._m_local, "n": n}, a.dtype)
        with _tel.current().span("collective.gram", op="gram", n=n,
                                 chunks=c) as sp:
            if c <= 1:
                g = self._psum(_ops.tsgram(a, out_dtype=torch.float32))
            else:
                g = _segmented_psum(
                    (_ops.randsketch(a, a[:, s0:s1], out_dtype=torch.float32)
                     for s0, s1 in chunk_bounds(n, c)),
                    self.mesh, self.row_axes)
            sp.sync_on(g)
        _record_collective(plan, sp, collective="psum", chunks=c)
        return g.to(self.out_dtype)

    def _promoted(self, v: torch.Tensor, what: str) -> torch.Tensor:
        T.refuse_fp8(self.rows.dtype, what)
        return self.rows.to(torch.promote_types(self.rows.dtype, v.dtype))

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """A v for a replicated v → this shard's (m_local,) rows."""
        return self._promoted(v, "RowMatrix.matvec") @ v

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Aᵀ u for a data-space u (the shard's piece, or a global vector
        cut to it) → (n,) on every rank."""
        u = self._local_data(u)
        a = self._promoted(u, "RowMatrix.rmatvec")
        if self.nshards == 1:
            return a.T @ u
        from repro_torch.launch import telemetry as _tel
        with _tel.current().span("collective.rmatvec", op="matvec",
                                 n=self.rows.shape[1]) as sp:
            out = self._psum(a.T @ u)
            sp.sync_on(out)
        plan = self._plan("matvec", {"m": self._m_local,
                                     "n": self.rows.shape[1]},
                          self.rows.dtype)
        _record_collective(plan, sp, collective="psum")
        return out

    def init_psum_residual(self) -> torch.Tensor:
        """Zeroed f32 error-feedback residual of the compressed ("psum8")
        fused_grad reduction: this shard's (1, n) row (the reference's
        (nshards, n), sharded one row a shard)."""
        return torch.zeros((1, self.rows.shape[1]), dtype=torch.float32,
                           device=self.device)

    def fused_grad(self, x: torch.Tensor, smooth, *,
                   chunks: int | str = "auto", residual=None):
        """(f(Ax), Aᵀ∇f(Ax), Ax) in ONE streaming pass over the shard
        (fused_grad kernel), then one all_reduce of (g, f) over the row
        group.  `smooth` is a row-separable smooth or its RowSeparable
        form; its target/weights are data-space vectors (global, cut to
        the shard, or the shard's piece), padding rows weighted 0.
        Returns (f32 scalar and (n,) gradient, the same on every rank;
        the shard's (m_local,) image).

        `chunks` > 1 runs the planner's overlapped schedule (plan("grad")
        with this mesh's axis sizes): the fused pass gives f, z and the
        f32 row residual r, then the gradient is r·A[:, seg] a column
        segment with f32 sums (the reference's ``jnp.dot(r, a[:, seg],
        preferred_element_type=f32)``, outside its kernel): on f32
        storage a plain product, on narrower storage, which no torch
        product takes beside an f32 r, one randsketch launch (A[:, seg]ᵀr)
        on the segment as it is (its rows strided); each segment's
        all_reduce issued behind the next segment's product.  Within
        tolerance of eager, not bit for bit.

        `residual` (from init_psum_residual) sends the gradient over the
        compressed int8 wire (train/compression.psum_int8): a shared
        pmax'd scale, an int8 all_reduce, the quantization error kept in
        the returned residual for the next call.  Returns (f, g, z,
        new_residual) then."""
        kind, t, w, prm = T.row_separable_inputs(
            smooth, self._m_local, self._row_mask, self._local_data)
        x = torch.as_tensor(x)
        a, n = self.rows, self.rows.shape[1]
        if self._one_eager(chunks, residual):
            return _ops.fused_grad(a, x, t, w, loss=kind, param=prm)
        from repro_torch.kernels import fusedgrad as _fg
        from repro_torch.launch import telemetry as _tel
        from repro_torch.train import compression as _comp
        c, plan = self._resolve_chunks(
            "grad", chunks, {"m": self._m_local, "n": n}, a.dtype)
        mesh, axes, nsh = self.mesh, self.row_axes, self.nshards
        wire = "int8" if residual is not None else "f32"
        with _tel.current().span("collective.fused_grad", op="grad", n=n,
                                 chunks=c, wire=wire) as sp:
            f, g, z = _ops.fused_grad(a, x, t, w, loss=kind, param=prm)
            bounds = chunk_bounds(n, c) if c > 1 else ((0, n),)
            if c > 1:
                # A segment's product is launched just before its
                # all_reduce is issued (the parts are drawn lazily).
                _, r = _fg.row_loss_grad(z, t, w, kind, prm)
                if a.dtype == torch.float32:
                    parts = ((r @ a[:, s0:s1]).to(x.dtype)
                             for s0, s1 in bounds)
                else:
                    parts = (_ops.randsketch(a[:, s0:s1], r[:, None],
                                             out_dtype=torch.float32)[:, 0]
                             .to(x.dtype) for s0, s1 in bounds)
            else:
                parts = iter([g])
            if residual is not None:
                f = self._psum(f)
                outs = [_comp.psum_int8(p, residual[0, s0:s1], mesh, axes,
                                        nsh)
                        for p, (s0, s1) in zip(parts, bounds)]
                g = torch.cat([o[0] for o in outs]).to(x.dtype)
                nres = torch.cat([o[1] for o in outs])
                out = (f, g, z, nres[None])
            elif c > 1:
                f = self._psum(f)
                out = (f, _segmented_psum(parts, mesh, axes), z)
            else:
                # One all_reduce carries both: g's n entries and f.
                fg = self._psum(torch.cat([g, f.reshape(1).to(g.dtype)]))
                out = (fg[n].to(f.dtype), fg[:n], z)
            sp.sync_on(out[1])
        _record_collective(plan, sp, collective="psum", chunks=c, wire=wire)
        return out

    def fused_grad_multi(self, x: torch.Tensor, smooths):
        """Request-batched fused gradients: (f, g, z) for a group of k
        right-hand sides in ONE streaming pass over the shard
        (fused_grad_multi kernel), (f, g) all_reduced.  `x` is (k × n);
        `smooths` a sequence of k row-separable smooths sharing one loss
        kind/param, or one smooth with stacked 2-D targets.  Padding rows
        take the row mask.  Returns ((k,) values and (k × n) gradients on
        every rank, the shard's (k × m_local) images)."""
        kind, t, w, prm = T.row_separable_batch_inputs(
            smooths, self._m_local, self._row_mask, self._local_data)
        x = torch.atleast_2d(torch.as_tensor(x))
        f, g, z = _ops.fused_grad_multi(self.rows, x, t, w, loss=kind,
                                        param=prm)
        if self.nshards == 1:
            return f, g, z
        k = g.shape[0]
        fg = self._psum(torch.cat([g.reshape(-1), f.to(g.dtype)]))
        return fg[-k:].to(f.dtype), fg[:-k].reshape(g.shape), z

    def sketch(self, r: int, *, seed: int = 0) -> "RowMatrix":
        """Y = A Ω for an (n × r) Gaussian test matrix Ω (randomized range
        finder), drawn in f32 on every rank from one torch.Generator on
        the rank's device seeded with `seed` and cast to A's type, as the
        reference draws it in A's type: every rank draws the same Ω, so it
        is never sent.  Y keeps A's type.  On f32 and bf16 storage the
        product is one plain matmul, as the reference leaves it to XLA
        outside any kernel; on fp8 storage, which no torch matmul takes,
        it is one gemm launch (f32 sums) on Ω's fp8 values widened
        exactly to bf16, its f32 Y cast to A's type."""
        a, n = self.rows, self.rows.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        omega = cast(torch.randn((n, r), generator=gen, device=self.device,
                                 dtype=torch.float32), a.dtype)
        if a.dtype in FP8:
            return self._with_rows(_ops.gemm(a, omega.to(torch.bfloat16),
                                             out_dtype=a.dtype))
        return self._with_rows(a @ omega)

    def project(self, Q: "RowMatrix", *,
                out_dtype=torch.float32) -> torch.Tensor:
        """B = AᵀQ for a row-conforming Q (randsketch kernel on the shard,
        then one all_reduce), the randomized SVD's projection.  Padding
        rows are zero in both operands and add nothing.  fp8 A (and Q)
        are read as they are stored and widened in the kernel."""
        out = self._psum(_ops.randsketch(self.rows, Q.rows,
                                         out_dtype=torch.float32))
        return out.to(out_dtype)

    def multiply_local(self, B: torch.Tensor) -> "RowMatrix":
        """A @ B for a small replicated B, the `U = A (VΣ⁻¹)` pattern (gemm
        kernel on each shard, no collective); the result keeps the storage
        type, as in the reference."""
        return self._with_rows(_ops.gemm(self.rows, B,
                                         out_dtype=self.rows.dtype))

    def scale_columns(self, d: torch.Tensor) -> "RowMatrix":
        """A · diag(d) (DIMSUM's column scaling); bf16 storage times f32
        scales promotes to f32, as in the reference."""
        T.refuse_fp8(self.rows.dtype, "RowMatrix.scale_columns")
        return self._with_rows(self.rows * d[None, :])

    def column_stats(self) -> dict[str, torch.Tensor]:
        """Per-column statistics (MLlib colStats), the same on every
        rank."""
        T.refuse_fp8(self.rows.dtype, "RowMatrix.column_stats")
        m = self.n_rows
        mask = self._row_mask()
        a = self.rows
        am = a * mask[:, None]
        n = a.shape[1]
        sums = self._psum(torch.cat([am.sum(0), (am * am).sum(0)]))
        s, sq = sums[:n], sums[n:]
        nnz = self._psum((am != 0).sum(0))
        keep = mask[:, None] > 0
        mn = compat.pmin(torch.where(keep, a, torch.inf).amin(0),
                         self.mesh, self.row_axes)
        mx = compat.pmax(torch.where(keep, a, -torch.inf).amax(0),
                         self.mesh, self.row_axes)
        mean = s / m
        var = torch.clamp(sq / m - mean * mean, min=0.0) * (m / max(m - 1, 1))
        return {"mean": mean, "variance": var, "num_nonzeros": nnz,
                "min": mn, "max": mx, "norm_l2": torch.sqrt(sq)}

    def frobenius_norm(self) -> torch.Tensor:
        a = self.rows.float()
        return torch.sqrt(self._psum((a * a).sum()))

    def column_norms(self) -> torch.Tensor:
        """Per-column L2 norms of the true rows (column_stats' norm_l2) in
        f32, summed in float64 a chunk of rows at a time (no copy of A),
        the shards' sums all_reduced in float64."""
        sq = torch.zeros(self.rows.shape[1], dtype=torch.float64,
                         device=self.device)
        true = max(0, min(self._m_local,
                          self.n_rows - self.shard * self._m_local))
        for i in range(0, true, _DIMSUM_ROWS):
            c = self.rows[i:min(i + _DIMSUM_ROWS, true)].double()
            sq += (c * c).sum(0)
        return torch.sqrt(self._psum(sq)).float()

    def column_similarities(self, threshold: float = 0.0, *,
                            gamma: float | None = None, seed: int = 0,
                            return_info: bool = False):
        """DIMSUM cosine similarities of the columns through tsgram
        (types.column_similarities); the keep mask is drawn a chunk of rows
        at a time into the one sampled copy, each shard from its own
        seed."""
        T.refuse_fp8(self.rows.dtype, "RowMatrix.column_similarities")
        return T.column_similarities(self, threshold, gamma=gamma, seed=seed,
                                     return_info=return_info)

    def _sampled(self, p, scale, gen) -> "RowMatrix":
        """Sampled DIMSUM's copy: entry (k, i) kept with probability p[i]
        and scaled by scale[i], in f32.  Shard i > 0 reseeds `gen` with
        seed + i·step, so no two shards draw the same mask."""
        if self.shard:
            gen.manual_seed((gen.initial_seed()
                             + self.shard * _SHARD_SEED_STEP) % (1 << 63))
        m_pad, n = self.rows.shape
        b = torch.empty((m_pad, n), dtype=torch.float32, device=self.device)
        for i in range(0, m_pad, _DIMSUM_ROWS):
            a = self.rows[i:i + _DIMSUM_ROWS]
            keep = torch.rand(a.shape, generator=gen, device=self.device) < p
            b[i:i + _DIMSUM_ROWS] = torch.where(keep, a, 0.0) * scale
            del keep
        return self._with_rows(b)

    def _square_(self) -> "RowMatrix":
        """The entries squared in place (on a fresh scaled copy)."""
        self.rows.square_()
        return self

    def remesh(self, mesh: T.Mesh | None,
               row_axes: Sequence[str] | None = None) -> "RowMatrix":
        """The same logical matrix on another mesh: gathered, stripped of
        the old padding, re-padded for the new shard count and cut to this
        rank's strip (every rank of both meshes calls it).  A rank outside
        the new mesh (one an elastic re-mesh dropped) keeps the whole
        matrix on its own device and no mesh."""
        glob = self.to_local()
        if mesh is None or not mesh.member:
            return RowMatrix.create(glob, device=self.device)
        return RowMatrix.create(glob, mesh=mesh, row_axes=row_axes)

    def to_sparse_row_matrix(self, bs: int | str = "auto"):
        """Block-compress into the block-sparse row type on this matrix's
        mesh (or device); bs="auto" takes plan("bsr_bs")'s block size, as
        from_dense does."""
        from .sparserow import SparseRowMatrix
        return SparseRowMatrix.from_dense(
            self.to_local(), bs=bs, device=self.device, mesh=self.mesh,
            row_axes=self.row_axes)

    # -- materialization ----------------------------------------------------
    def to_local(self) -> torch.Tensor:
        """The whole matrix (n_rows, n) on every rank (an all_gather of
        the strips on a mesh: driver scale)."""
        if self.nshards == 1:
            return self.rows[: self.n_rows]
        parts = compat.all_gather(self.rows, self.mesh, self.row_axes)
        return parts.reshape(-1, self.rows.shape[1])[: self.n_rows]

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
    """RowMatrix plus meaningful row indices (paper §2.1), sharded with its
    rows."""
    indices: torch.Tensor            # this shard's (m_local,) int64
    inner: RowMatrix

    @staticmethod
    def create(indices, rows, *, device="cuda", mesh=None,
               row_axes: Sequence[str] | None = None) -> "IndexedRowMatrix":
        rm = RowMatrix.create(rows, device=device, mesh=mesh,
                              row_axes=row_axes)
        idx = torch.as_tensor(indices).to(torch.int64)
        if idx.shape != (rm.n_rows,):
            raise ValueError(f"{tuple(idx.shape)} indices for {rm.n_rows} "
                             "rows")
        if rm.nshards > 1:
            r0, m_local = T.shard_range(rm.n_rows, rm.nshards, rm.shard)
            piece = idx[r0:r0 + m_local]
            idx = torch.cat([piece, piece.new_zeros(m_local
                                                    - piece.shape[0])])
        return IndexedRowMatrix(indices=idx.to(rm.device), inner=rm)

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
        inner = self.inner
        idx = self.indices
        if inner.nshards > 1:
            idx = compat.all_gather(idx, inner.mesh,
                                    inner.row_axes).reshape(-1)
        idx = idx[: inner.n_rows]
        dense = inner.to_local()
        rows = int(idx.max()) + 1 if idx.numel() else 0
        out = dense.new_zeros((rows, dense.shape[1]))
        out[idx] = dense
        return out
