"""Collectives over a mesh's row group, on torch.distributed.

Counterpart of src/repro/compat.py, which held ``shard_map``,
``axis_size`` and ``make_mesh``: the reference runs each distributed op as
a ``shard_map`` body with ``jax.lax.psum`` / ``pmax`` / ``axis_index``
over named mesh axes.  The port runs one process a rank (SPMD): each body
is the local function on the rank's shard, and each reduction below is
one ``torch.distributed`` collective over the process group of the named
axes (NCCL on the card, gloo on the CPU).

Every function takes the mesh (``core/distmat/types.Mesh``, or None for
one device) and the axes it reduces over.  Over axes whose ranks number
one, each returns its input unchanged and issues nothing, so a one-rank
result keeps the bits it had before any mesh existed.  Results of a
reduction are the same bits on every rank of the group: ranks may steer
control flow by them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(mesh, axes) -> int:
    """Ranks along `axes` (1 without a mesh)."""
    return 1 if mesh is None else mesh.axes_size(axes)


def axis_index(mesh, axes) -> int:
    """This rank's flat index along `axes`, major to minor (0 without a
    mesh): the row shard it owns."""
    return 0 if mesh is None else mesh.index(axes)


def _reduce(t: torch.Tensor, mesh, axes, op, async_op: bool):
    if axis_size(mesh, axes) == 1:
        return (t, None) if async_op else t
    shape = t.shape
    out = t.reshape(-1).clone(memory_format=torch.contiguous_format)
    work = dist.all_reduce(out, op=op, group=mesh.group(axes),
                           async_op=async_op)
    out = out.reshape(shape)
    return (out, work) if async_op else out


def psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Σ of `t` over the ranks along `axes` (``jax.lax.psum``)."""
    return _reduce(t, mesh, axes, dist.ReduceOp.SUM, False)


def psum_start(t: torch.Tensor, mesh, axes):
    """``psum`` issued without waiting: returns (buffer, work), and the
    buffer holds the sum once ``wait(work)`` returns.  The overlapped
    (chunked) bodies issue a segment's sum behind the next segment's
    launch and wait in order."""
    return _reduce(t, mesh, axes, dist.ReduceOp.SUM, True)


def wait(work) -> None:
    """Wait for a ``psum_start``'s collective (no-op for a local one)."""
    if work is not None:
        work.wait()


def pmax(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise max over the ranks along `axes` (``jax.lax.pmax``)."""
    return _reduce(t, mesh, axes, dist.ReduceOp.MAX, False)


def pmin(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise min over the ranks along `axes` (``jax.lax.pmin``)."""
    return _reduce(t, mesh, axes, dist.ReduceOp.MIN, False)


def all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's `t` along `axes`, stacked in row-shard order: (P, *t.shape)
    with P = axis_size(mesh, axes).  Every rank's `t` must have one shape."""
    p = axis_size(mesh, axes)
    if p == 1:
        return t[None]
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(p)]
    dist.all_gather(parts, src, group=mesh.group(axes))
    # all_gather fills by group rank (sorted global ranks); put them in
    # row-shard order.
    members = mesh.members(axes)
    by_rank = dict(zip(sorted(members), parts))
    return torch.stack([by_rank[r] for r in members])
