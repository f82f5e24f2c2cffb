"""Elastic re-meshing: continue a SOLVE on fewer ranks.

Counterpart of src/repro/train/elastic.py, the solver side.  The solver's
iterate, gradient and history state is replicated on every rank (the
"driver" copy), so a mid-solve re-mesh moves only the distributed MATRIX:
`survivor_mesh` drops the straggling or lost row shard named by
train/straggler.ShardMonitor (or a DeviceLostError), `remesh_distmat`
re-shards a RowMatrix / SparseRowMatrix onto the survivors, and
`remesh_linop` rebuilds a possibly wrapped LinopMatrix around it; the
elastic executor (core/optim/elastic.ElasticGroup) then continues from the
same iterate without restarting.  BlockMatrix and CoordinateMatrix are
made on a survivor mesh as on any other (their ``create``).

On a mesh of several ranks every rank, the dropped one included, calls
each of these in the same order: `survivor_mesh` creates the survivors'
process groups (a collective over the whole default group), and
`remesh_distmat` gathers the old strips over the old group, as the
reference's simulated lost device still holds its shard.  The dropped rank
keeps the whole matrix on its own device and takes part in no later
collective.

The reference's tree `remesh` and `resume` (training state re-sharded onto
a new mesh) come with the training half of ROADMAP queue 1 item 15.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.distmat import types as T

TRAINING_ITEM = "ROADMAP queue 1 item 15 (LM training)"


def remesh(tree, specs, new_mesh):
    """Re-shard a live training tree onto a new mesh (not ported yet)."""
    raise NotImplementedError(f"remesh of a training tree waits for "
                              f"{TRAINING_ITEM}")


def resume(ckpt_dir, tree_like, specs, new_mesh, **kw):
    """Restore a training checkpoint onto a new mesh (not ported yet)."""
    raise NotImplementedError(f"resume of a training run waits for "
                              f"{TRAINING_ITEM}")


def survivor_mesh(mesh: T.Mesh | None, drop_shard: int) -> T.Mesh | None:
    """The mesh left after dropping row-shard `drop_shard`'s ranks.

    Row shards map to rows of the rank grid viewed as (row_shards, model);
    dropping a shard drops that whole row.  A one-shard mesh has no
    survivors: the last shard is never dropped, and the same ranks come
    back as a fresh mesh, so callers can re-mesh unconditionally (one
    device, no mesh: None).  Every rank of the old mesh calls it."""
    if mesh is None or mesh.grid is None:
        return mesh
    model = mesh.shape[T.COL_AXIS] if mesh.axis_names[-1] == T.COL_AXIS \
        else 1
    rows = mesh.grid.reshape(-1, model)
    if rows.shape[0] > 1:
        drop = drop_shard % rows.shape[0]
        rows = rows[[i for i in range(rows.shape[0]) if i != drop]]
    return T.mesh_from_grid(rows, ("data", "model"), mesh.device)


def remesh_distmat(A, new_mesh: T.Mesh | None, row_axes=None):
    """Re-shard a distributed matrix (RowMatrix / SparseRowMatrix: anything
    with a `.remesh`) onto `new_mesh`; a local tensor passes through (there
    is nothing to move)."""
    if hasattr(A, "remesh"):
        return A.remesh(new_mesh, row_axes)
    return A


def remesh_linop(linop, new_mesh: T.Mesh | None):
    """Rebuild a (possibly wrapped) linear operator onto `new_mesh`.

    Wrapper layers that carry a `.base` (CountingLinop, the fault-injection
    FaultyLinop, LinopAdjoint) keep their state through
    dataclasses.replace; the LinopMatrix at the bottom gets its matrix
    re-sharded.  Operators without a distributed operand come back as
    they are."""
    from repro_torch.core.tfocs.linop import LinopMatrix
    if isinstance(linop, LinopMatrix):
        return LinopMatrix(remesh_distmat(linop.A, new_mesh))
    if dataclasses.is_dataclass(linop) and hasattr(linop, "base"):
        return dataclasses.replace(
            linop, base=remesh_linop(linop.base, new_mesh))
    return linop
