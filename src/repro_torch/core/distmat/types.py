"""Meshes, device resolution, row padding and the DistMatrix protocol.

Counterpart of src/repro/core/distmat/types.py.  The reference lays a
matrix out over a TPU mesh (a NamedSharding); the port lays it out over a
`Mesh` of torch.distributed ranks, one process a rank.  Rows shard over
every axis but "model" (``row_axes_for``): each rank holds the contiguous,
zero-padded strip of rows its flat index along the row axes names
(``shard_range``) as a plain local tensor, and the ranks that differ only
along "model" hold the same rows.  "Driver" quantities (the paper's
vectors) are plain tensors with the same bits on every rank.  A matrix
made without a mesh lives on one device: one row shard, and every
collective is the identity.  Padding rows carry weight 0 in every loss.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.dtypes import FP8

# Default logical axis names, as in the reference: rows shard over the
# batch-like axes ("pod" and "data"), "model" replicates them.
ROW_AXES = ("data",)
COL_AXIS = "model"


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A grid of torch.distributed ranks with named axes (the reference's
    ``jax.sharding.Mesh``).  `shape` maps each axis name to its size, as
    the reference's ``mesh.shape`` does; `device` is this rank's device.
    A mesh of more than one rank wraps
    ``torch.distributed.device_mesh.init_device_mesh`` (one process group
    an axis) and adds one group for its row axes when they are several
    ("pod" x "data"); build it with ``make_mesh`` on every rank alike.  A
    mesh over some of the ranks (``mesh_from_grid``, the survivors of an
    elastic re-mesh) holds its `grid` of global ranks and a group an axis;
    on a rank outside it `coordinate` is None and `member` False."""

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 device: torch.device, device_mesh=None, *,
                 grid: torch.Tensor | None = None,
                 groups: dict | None = None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device
        self.device_mesh = device_mesh
        self.grid = device_mesh.mesh if device_mesh is not None else grid
        if device_mesh is not None:
            self.coordinate = tuple(device_mesh.get_coordinate())
        elif grid is not None:
            hit = (grid == dist.get_rank()).nonzero()
            self.coordinate = tuple(int(c) for c in hit[0]) \
                if len(hit) else None
        else:
            self.coordinate = (0,) * len(self.axis_names)
        self._groups: dict = dict(groups or {})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coordinate is not None

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def _ordered(self, axes) -> tuple[str, ...]:
        axes = set(_axes(axes))
        return tuple(a for a in self.axis_names if a in axes)

    def index(self, axes) -> int:
        """This rank's flat index along `axes`, major to minor in the
        mesh's axis order."""
        idx = 0
        for a in self._ordered(axes):
            idx = idx * self.shape[a] + \
                self.coordinate[self.axis_names.index(a)]
        return idx

    def members(self, axes) -> list[int]:
        """Global ranks of this rank's group along `axes`, in flat-index
        order (the order ``index`` counts in)."""
        if self.grid is None:
            return [0]
        sel = tuple(slice(None) if a in _axes(axes) else c
                    for a, c in zip(self.axis_names, self.coordinate))
        return [int(r) for r in self.grid[sel].reshape(-1)]

    def group(self, axes):
        """The process group of this rank's ranks along `axes` (all of
        them: every rank of the mesh)."""
        key = self._ordered(axes)
        if key in self._groups:
            return self._groups[key]
        if self.device_mesh is not None:
            if len(key) == 1:
                return self.device_mesh.get_group(key[0])
            if key == self.axis_names:     # make_mesh spans the world
                return dist.group.WORLD
        raise ValueError(f"no process group for axes {key}: make_mesh "
                         "creates the row axes' group only")


def _make_group(mesh: Mesh, axes: tuple[str, ...]) -> None:
    """Create the group of several axes on every rank (a collective
    call: every rank enumerates every group in the same order)."""
    grid = mesh.device_mesh.mesh
    pos = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in pos]
    groups = grid.permute(*rest, *pos).reshape(-1, mesh.axes_size(axes))
    mine, _ = dist.new_subgroups_by_enumeration(groups.tolist())
    mesh._groups[axes] = mine


def mesh_from_grid(grid: torch.Tensor, names: Sequence[str], device
                   ) -> Mesh:
    """A mesh over the global ranks in `grid` (shaped as the mesh), made
    on EVERY rank of the default process group, those outside `grid`
    included: each process group is created by a call that all ranks
    make in the same order.  A group is made for each axis of more than
    one rank and one for the whole mesh (an axis of one rank needs none:
    compat's collectives over it issue nothing), which is what every type
    takes: RowMatrix and SparseRowMatrix (the row axes), BlockMatrix (the
    row axes, "model" and both) and CoordinateMatrix (the row axes).  On a
    rank outside `grid` the mesh has no coordinate and takes part in no
    later collective."""
    grid = torch.as_tensor(grid)
    names = tuple(names)
    groups: dict = {}
    if grid.numel() > 1:
        for pos, a in enumerate(names):
            if grid.shape[pos] == 1:
                continue
            rest = [i for i in range(grid.dim()) if i != pos]
            lists = grid.permute(*rest, pos).reshape(-1, grid.shape[pos])
            groups[(a,)], _ = dist.new_subgroups_by_enumeration(
                lists.tolist())
        whole = tuple(a for a, s in zip(names, grid.shape) if s > 1)
        if len(whole) == 1:
            groups[names] = groups[whole]
        else:
            groups[names] = dist.new_group(grid.reshape(-1).tolist())
    return Mesh(tuple(grid.shape), names, device, grid=grid, groups=groups)


@functools.cache
def _single(device: torch.device) -> Mesh:
    return Mesh((1, 1), ("data", "model"), device)


def single_device_mesh(device="cuda") -> Mesh:
    """A (1, 1) mesh on one device: one row shard, no collective."""
    return _single(resolve_device(device))


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device="cuda") -> Mesh:
    """The mesh `shape` over axes `names`, on every rank of the default
    process group (its world size must be the mesh's size); `device` is
    this rank's (the card unless the caller asks for the CPU).  A
    one-rank mesh needs no process group."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    dev = resolve_device(device)
    if math.prod(shape) == 1:
        return Mesh(shape, names, dev)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs torch.distributed's "
                           "process group (launch/mesh.spawn, or torchrun)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    mesh = Mesh(shape, names, dev, dm)
    rows = row_axes_for(mesh)
    if len(rows) > 1:
        _make_group(mesh, rows)
    return mesh


# What names the multi-GPU pieces still to port (the LM side on a mesh).
MULTI_GPU_ITEM = "ROADMAP queue 1 item 13 (multi-GPU)"


def single_rank(mesh: Mesh | None) -> bool:
    """Whether a matrix made on `mesh` lives on one device without it: a
    one-rank mesh, or a rank outside the mesh (one an elastic re-mesh
    dropped, which keeps its matrix whole and joins no collective)."""
    return mesh is not None and (mesh.size == 1 or not mesh.member)


def row_axes_for(mesh: Mesh | None) -> tuple[str, ...]:
    """Every mesh axis that shards rows: ("pod", "data") on a multi-pod
    mesh."""
    if mesh is None:
        return ROW_AXES
    return tuple(n for n in mesh.axis_names if n != COL_AXIS)


def axes_size(mesh: Mesh | None, axes: Sequence[str]) -> int:
    return 1 if mesh is None else mesh.axes_size(axes)


def shard_range(m: int, nshards: int, index: int) -> tuple[int, int]:
    """Rows [r0, r0 + m_local) of a matrix of `m` rows that shard `index`
    of `nshards` owns, the rows padded to a multiple of `nshards` (rows
    past `m` are padding)."""
    m_local = -(-m // max(nshards, 1))
    return index * m_local, m_local


def shard_rows(x, nshards: int, index: int, device: torch.device
               ) -> torch.Tensor:
    """Shard `index`'s zero-padded strip of `x`'s rows (axis 0), on
    `device`; `x` is global (numpy or tensor) and only the strip moves."""
    x = tensor_from_array(x)
    r0, m_local = shard_range(x.shape[0], nshards, index)
    piece = as_float_tensor(x[r0:r0 + m_local], device).contiguous()
    short = m_local - piece.shape[0]
    return torch.cat([piece, piece.new_zeros((short, *piece.shape[1:]))]) \
        if short else piece


def local_data(v, m_local: int, nshards: int, index: int) -> torch.Tensor:
    """This shard's piece of a data-space vector (last axis): a global
    vector (the true or the padded row count) is cut to the shard's rows;
    one of the shard's length passes through; a shorter one is padded."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v)
    if v.shape[-1] == m_local:
        return v
    if nshards > 1:
        r0 = index * m_local
        v = v[..., r0:r0 + m_local]
    return F.pad(v, (0, m_local - v.shape[-1])) \
        if v.shape[-1] < m_local else v


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for CUDA when there is no card, so
    an entry point never drops to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# numpy's ml_dtypes types torch does not read: (integer view, torch type).
_NUMPY_BITS = {"bfloat16": ("int16", torch.bfloat16),
               "float8_e4m3fn": ("uint8", torch.float8_e4m3fn),
               "float8_e5m2": ("uint8", torch.float8_e5m2)}


def tensor_from_array(v) -> torch.Tensor:
    """`v` as a tensor (no device move).  A numpy array of an ml_dtypes
    type (the reference's bfloat16, float8_e4m3fn and float8_e5m2 arrays
    leave it so), which torch does not read, crosses by bit pattern: its
    bytes viewed as int16 or uint8, then as the torch type."""
    name = getattr(getattr(v, "dtype", None), "name", None)
    if name in _NUMPY_BITS and not isinstance(v, torch.Tensor):
        import numpy as np
        ints, dt = _NUMPY_BITS[name]
        bits = np.ascontiguousarray(v).view(ints).copy()
        return torch.from_numpy(bits).view(dt)
    return torch.as_tensor(v)


def as_float_tensor(v, device: torch.device) -> torch.Tensor:
    """`v` on `device`; float64 becomes float32, as jax keeps it."""
    t = tensor_from_array(v).to(device)
    return t.float() if t.dtype == torch.float64 else t


# -- fp8 storage (the casts themselves and FP8: kernels/dtypes) -------------
# What names the reference-side refusals.
FP8_REFUSED = ("ROADMAP queue 3, reference-side faults: the reference "
               "raises on fp8 storage here too")


def refuse_fp8(dtype, what: str) -> None:
    """Raise TypeError for float8_e4m3fn or float8_e5m2 storage where the
    reference raises on it too (its jnp products have no fp8 promotion,
    and its QR no fp8 type), before anything runs."""
    if dtype in FP8:
        raise TypeError(f"{what} on float8_e4m3fn or float8_e5m2 storage "
                        f"(here {dtype}): {FP8_REFUSED}")


def pad_rows(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Pad axis 0 of `x` to a multiple; returns (padded, original_rows)."""
    m = x.shape[0]
    rem = (-m) % multiple
    if rem:
        x = torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])
    return x, m


def _pad1(v: torch.Tensor, m_pad: int) -> torch.Tensor:
    return F.pad(v, (0, m_pad - v.shape[0])) if v.shape[0] < m_pad else v


def row_separable_inputs(smooth, m_pad: int, row_mask_fn: Callable,
                         local: Callable | None = None):
    """Resolve a smooth (or its RowSeparable form) into fused-gradient
    kernel inputs: (kind, target, weights, param) with the data-space
    vectors padded to `m_pad` rows, or cut to this shard's by `local`
    (a distributed matrix's ``_local_data``).  Default weights come from
    `row_mask_fn()` so padding rows contribute nothing; explicit weights are
    zero-padded, same effect."""
    local = local or (lambda v: _pad1(torch.as_tensor(v), m_pad))
    sep = smooth if hasattr(smooth, "kind") else (
        smooth.as_row_separable()
        if hasattr(smooth, "as_row_separable") else None)
    if sep is None:
        raise ValueError("fused_grad needs a row-separable smooth")
    t = local(sep.target)
    w = row_mask_fn() if sep.weights is None else local(sep.weights)
    return sep.kind, t, w, float(getattr(sep, "param", 1.0))


def row_separable_batch_inputs(smooths, m_pad: int, row_mask_fn: Callable,
                               local: Callable | None = None):
    """Resolve a group of row-separable smooths into multi-RHS fused kernel
    inputs: (kind, targets (k × m_pad), weights (k × m_pad), param).

    `smooths` is a sequence of k smooths sharing one loss kind and param
    (what makes them one servable group), or a single smooth whose target
    and weights are already stacked 2-D (k × m).  Mixed kinds or params
    raise."""
    def resolve(s):
        sep = s if hasattr(s, "kind") else (
            s.as_row_separable() if hasattr(s, "as_row_separable") else None)
        if sep is None:
            raise ValueError("fused_grad_multi needs row-separable smooths")
        return sep

    if not isinstance(smooths, (list, tuple)):
        sep = resolve(smooths)
        t = torch.atleast_2d(torch.as_tensor(sep.target))
        seps = [sep]
        ts = list(t)
        ws = ([None] * t.shape[0] if sep.weights is None
              else list(torch.atleast_2d(torch.as_tensor(sep.weights))))
    else:
        seps = [resolve(s) for s in smooths]
        ts = [torch.as_tensor(s.target) for s in seps]
        ws = [None if s.weights is None else torch.as_tensor(s.weights)
              for s in seps]

    kinds = {s.kind for s in seps}
    params = {float(getattr(s, "param", 1.0)) for s in seps}
    if len(kinds) != 1 or len(params) != 1:
        raise ValueError(
            f"a fused group must share one loss kind/param, got "
            f"{sorted(kinds)} / {sorted(params)}")
    local = local or (lambda v: _pad1(v, m_pad))
    mask = row_mask_fn()
    t2 = torch.stack([local(t) for t in ts])
    w2 = torch.stack([mask if w is None else local(w) for w in ws])
    return kinds.pop(), t2, w2, params.pop()


def dimsum_gamma(n: int, threshold: float) -> float:
    """The paper's oversampling parameter: γ = 10·log(n)/threshold keeps the
    estimate of every pair with similarity ≥ threshold within ~20% relative
    error w.h.p. (DIMSUM analysis, refs [10, 11])."""
    return 10.0 * math.log(max(n, 2)) / threshold


def dimsum_variance(s2: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-pair sampled-DIMSUM estimator variance,
        Var[ŝᵢⱼ] = Σ_k (ã_ki ã_kj)² · (1/(pᵢpⱼ) − 1),
    from the Gram `s2` of the squared column-scaled matrix and the
    per-column keep probabilities `p`.  The diagonal is written exactly by
    the estimator, so its variance is 0."""
    n = p.shape[0]
    pp = p[:, None] * p[None, :]
    var = s2 * torch.where(pp > 0, 1.0 / torch.clamp(pp, min=1e-30) - 1.0,
                           0.0)
    idx = torch.arange(n, device=var.device)
    var[idx, idx] = 0.0
    return var


def column_similarities(A: "DistMatrix", threshold: float = 0.0, *,
                        gamma: float | None = None, seed: int = 0,
                        return_info: bool = False):
    """DIMSUM cosine similarities of A's columns (paper refs [10, 11]), for
    either matrix type: A supplies column_norms, scale_columns, gram and
    the two hooks _sampled and _square_.

    threshold=0 computes cos(i, j) = (AᵀA)ᵢⱼ/(‖cᵢ‖‖cⱼ‖) exactly, as the Gram
    of the column-scaled A.  threshold>0 runs sampled DIMSUM: an entry of
    column i is kept with probability pᵢ = min(1, √γ/‖cᵢ‖) and rescaled by
    1/(pᵢ‖cᵢ‖), so the estimate is unbiased off the diagonal, whose value
    (1 for a non-zero column) is written exactly; γ defaults to
    dimsum_gamma(n, threshold).  The keep mask comes from a torch.Generator
    on A's device seeded with `seed`, so the sampled entries differ from
    the reference's; γ, p, the diagonal and the variance do not.
    return_info=True returns (sim, info) with γ, p and the per-pair
    estimator variance (dimsum_variance), from one more Gram of the squared
    scaled matrix."""
    norms = A.column_norms()
    inv = torch.where(norms > 0, 1.0 / torch.clamp(norms, min=1e-30), 0.0)
    n = A.shape[1]
    if threshold <= 0.0:
        sim = A.scale_columns(inv).gram()
        if not return_info:
            return sim
        return sim, {"gamma": None, "p": torch.ones(n, device=A.device),
                     "variance": torch.zeros((n, n), device=A.device)}
    g = gamma if gamma is not None else dimsum_gamma(n, threshold)
    p = torch.clamp(math.sqrt(g) * inv, max=1.0)
    scale = inv * torch.where(p > 0, 1.0 / p, 0.0)
    gen = torch.Generator(device=A.device).manual_seed(int(seed))
    sim = A._sampled(p, scale, gen).gram().to(A.out_dtype)
    # The diagonal estimator is biased (E[b²] = a²/p); its true value is
    # known, so write it instead, as the reference (and MLlib) do.
    idx = torch.arange(n, device=A.device)
    sim[idx, idx] = (norms > 0).to(sim.dtype)
    if not return_info:
        return sim
    s2 = A.scale_columns(inv)._square_().gram().float()
    return sim, {"gamma": g, "p": p, "variance": dimsum_variance(s2, p)}


@dataclass(frozen=True)
class DistMatrix:
    """Base for distributed matrices."""

    @property
    def shape(self) -> tuple[int, int]:  # pragma: no cover - abstract
        raise NotImplementedError

    def matvec(self, v: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def to_local(self) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def normal_op(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """v ↦ Aᵀ(A v): the only operator the Lanczos SVD needs."""
        return lambda v: self.rmatvec(self.matvec(v))
