"""Rank bodies of the port's multi-rank fault-tolerance tests
(tests/test_torch_fault_tolerance.py).

``elastic_rank`` runs on every rank of a 4-rank gloo group started by
``repro_torch.launch.mesh.spawn`` and returns a dict the test process
holds against the JAX reference on one device.  It runs three cases in
turn: a straggler re-mesh and a device loss on a (4, 1) mesh, and a
checkpointed solve on a mesh of ranks 0 and 1 alone (the other two sit
it out).  Each rank counts the collectives it enters, so the test can
check that a rank a re-mesh dropped enters none after it.  This module
imports torch and the port only (the spawned ranks never import jax),
and is not a test module itself.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core.distmat import RowMatrix
from repro_torch.core.distmat import types as T
from repro_torch.core.optim.elastic import (ElasticConfig, SolveCheckpoint,
                                            solve_elastic)
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.train.faults import FaultPlan, FaultyLinop, FaultyMesh
from repro_torch.train.straggler import ShardMonitor, StragglerConfig

MONITOR = dict(warmup_steps=2, threshold=2.0, trip_limit=2)
# The elastic cases' plans: a straggler on shard 0 from iteration 6 (the
# reference's test_straggler_detected_remesh_matches_clean_solve), and
# shard 2's device lost at iteration 3.
STRAGGLER = dict(shard_delays={0: 0.2}, delay_from=6)
LOSS = dict(lose_shard_at=3, lost_shard=2)
SOLVE = dict(tol=1e-7, max_iters=400)
CKPT = dict(every=5, cut=20)          # snapshots every 5, stopped at 20
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "broadcast", "barrier", "reduce_scatter_tensor")


def _nosleep(_dt):
    """In place of time.sleep: the injected delays without the wall
    time."""


def _count_collectives() -> dict:
    """Wrap torch.distributed's collectives with a counter (this rank's
    calls since the wrap)."""
    counts = {"n": 0}
    for name in _COLLECTIVES:
        fn = getattr(dist, name)

        def wrapped(*a, _fn=fn, **kw):
            counts["n"] += 1
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)
    return counts


@dataclass
class _Marking(FaultyLinop):
    """A FaultyLinop that notes the rank's collective count when a re-mesh
    finishes with it (`counts` is a field, so remesh_linop's rebuild keeps
    it)."""
    counts: dict = None

    def on_remesh(self, dropped):
        super().on_remesh(dropped)
        self.counts["at_remesh"] = self.counts["n"]


def _elastic_case(mesh, data: dict, plan: dict, counts: dict,
                  monitor: bool) -> dict:
    A = RowMatrix.create(data["A"], mesh=mesh)
    lin = _Marking(LinopMatrix(A), FaultPlan(**plan), sleep=_nosleep,
                   counts=counts)
    fm = FaultyMesh(mesh)
    cfg = ElasticConfig(
        monitor=ShardMonitor(lin.row_shards(), StragglerConfig(**MONITOR))
        if monitor else None, remesh_to=fm.drop)
    counts.pop("at_remesh", None)
    x, info = solve_elastic(lin, "quad", data["b"], elastic=cfg, **SOLVE)
    return {"x": x, "info": info, "casualties": fm.casualties,
            "delays": dict(lin.delays),
            "after_remesh": counts["n"] - counts.get("at_remesh",
                                                     counts["n"])}


def elastic_rank(rank: int, data: dict, ckpt_dir: str) -> dict:
    """The three cases on this rank."""
    counts = _count_collectives()
    out = {"rank": rank}
    for name, plan, monitor in (("straggler", STRAGGLER, True),
                                ("loss", LOSS, False)):
        mesh = T.make_mesh((4, 1), ("data", "model"), device="cpu")
        out[name] = _elastic_case(mesh, data, plan, counts, monitor)
    # A checkpointed solve on ranks 0 and 1, cut at CKPT["cut"]: rank 0
    # writes; every rank of the default group makes the mesh's groups.
    pair = T.mesh_from_grid(torch.tensor([[0], [1]]), ("data", "model"),
                            torch.device("cpu"))
    if pair.member:
        A = RowMatrix.create(data["A"], mesh=pair)
        ck = SolveCheckpoint(ckpt_dir, every=CKPT["every"])
        x, info = solve_elastic(LinopMatrix(A), "quad", data["b"], tol=0.0,
                                max_iters=CKPT["cut"],
                                elastic=ElasticConfig(checkpoint=ck))
        out["checkpoint"] = {"x": x, "info": info, "saves": ck.saves}
    return out
