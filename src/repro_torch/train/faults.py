"""Deterministic fault injection for the solver and serving stack.

Counterpart of src/repro/train/faults.py.  Shards are lost three ways:
slow (a rank that throttles, a degraded link), wrong (a transient NaN, a
dropped collective) and gone (a dead rank).  This module simulates all
three from a seed, so the fault-tolerance layer can be tested on the CPU
and driven on the card:

  * ``FaultyLinop`` wraps any linear operator (LinopMatrix, CountingLinop
    chains) and cooperates with the elastic executor
    (core/optim/elastic.ElasticGroup) through the ``fault_hook``
    protocol: after every solver iteration the executor offers the hook
    (step, state, dt); the hook sleeps the injected shard delay (so
    deadlines and wall-clock telemetry are real), returns per-shard timing
    telemetry for train/straggler.ShardMonitor, and, per the seeded
    ``FaultPlan``, raises ``TransientShardError`` (retried), raises
    ``DeviceLostError`` (re-mesh), or poisons the state's smooth values
    with NaN (rolled back and retried).
  * ``FaultyMesh`` tracks simulated device loss: ``drop(shard)`` shrinks
    the healthy mesh via train/elastic.survivor_mesh, what the executor's
    `remesh_to` callback needs.

Everything is seeded and host-side: injection happens BETWEEN solver
iterations, never inside a kernel, so the wrapped operator's numerics are
untouched.  The shard times are synthetic (a seeded baseline and jitter),
so detection never depends on the host's real speed and every rank of a
mesh sees the same times, the same faults at the same iterations, and so
takes the same decisions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

# The exception types ARE the recovery contract with the executor, so they
# live beside it; re-exported here because injection sites import this
# module.
from repro_torch.core.optim.elastic import DeviceLostError, TransientShardError

from . import elastic as _elastic

__all__ = ["FaultPlan", "FaultyLinop", "FaultyMesh",
           "TransientShardError", "DeviceLostError"]


@dataclass
class FaultPlan:
    """Seeded schedule of injected faults, indexed by solver iteration.

    shard_delays  — extra wall seconds added to the named shards every
                    iteration from `delay_from` on (the straggler
                    signature; a shard slow from iteration 0 just has a
                    slow EMA); cleared for a shard when a re-mesh drops it.
    fail_steps    — iterations that raise TransientShardError once each.
    nan_steps     — iterations whose post-step state is poisoned with NaN
                    once each (a corrupted reduction).
    lose_shard_at — iteration at which `lost_shard`'s device dies
                    (DeviceLostError, raised once).
    base_dt/jitter — synthetic per-shard baseline seconds and seeded noise
                    for the telemetry.
    """
    seed: int = 0
    shard_delays: dict[int, float] = field(default_factory=dict)
    delay_from: int = 0
    fail_steps: tuple[int, ...] = ()
    nan_steps: tuple[int, ...] = ()
    lose_shard_at: int | None = None
    lost_shard: int = 0
    base_dt: float = 0.01
    jitter: float = 0.0005


@dataclass
class FaultyLinop:
    """Linop wrapper: delegates the whole operator protocol to `base`
    untouched and injects faults only through `fault_hook`, between
    iterations.  Composes with CountingLinop in either order and survives
    train/elastic.remesh_linop (dataclasses.replace keeps the mutable
    runtime state shared across the rebuild)."""
    base: object
    plan: FaultPlan = field(default_factory=FaultPlan)
    sleep: object = time.sleep          # injectable for fast tests
    # mutable runtime state (shared across remesh_linop rebuilds):
    delays: dict = None                 # live copy of plan.shard_delays
    fired: set = None                   # consumed one-shot fault steps
    lost: list = None                   # [True] once the device died
    dropped: list = None                # shards removed by re-meshes
    hooks: int = 0

    def __post_init__(self):
        if self.delays is None:
            self.delays = dict(self.plan.shard_delays)
        if self.fired is None:
            self.fired = set()
        if self.lost is None:
            self.lost = []
        if self.dropped is None:
            self.dropped = []

    # -- delegated operator protocol ----------------------------------------
    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    @property
    def device(self):
        return self.base.device

    @property
    def A(self):
        return getattr(self.base, "A", None)

    def apply(self, x):
        return self.base.apply(x)

    def adjoint(self, y):
        return self.base.adjoint(y)

    def fused_grad(self, x, sep, residual=None):
        if residual is not None:
            return self.base.fused_grad(x, sep, residual=residual)
        return self.base.fused_grad(x, sep)

    def fused_grad_multi(self, x, seps):
        return self.base.fused_grad_multi(x, seps)

    def operand_dtype(self):
        return self.base.operand_dtype()

    def init_psum_residual(self):
        return self.base.init_psum_residual()

    def row_shards(self) -> int:
        return self.base.row_shards()

    def axis_sizes(self) -> tuple[int, ...]:
        return self.base.axis_sizes()

    def data_sum(self, t):
        return self.base.data_sum(t)

    def pad_data(self, b):
        return self.base.pad_data(b)

    def row_weights(self):
        return self.base.row_weights()

    # -- the injection protocol ---------------------------------------------
    def shard_times(self, step: int) -> list[float]:
        """Per-shard telemetry for iteration `step`: seeded baseline and
        jitter, plus the injected delay on straggling shards."""
        p = self.plan
        rng = np.random.default_rng((p.seed, step))
        n = self.row_shards()
        times = (p.base_dt + p.jitter * rng.random(n)).tolist()
        if step >= p.delay_from:
            for shard, extra in self.delays.items():
                if 0 <= shard < n:
                    times[shard] += extra
        return times

    def fault_hook(self, step: int, state, dt: float):
        """Called by the elastic executor after each solver iteration.
        Returns (state, telemetry); may sleep (injected delay) or raise
        (scheduled transient and device-loss faults)."""
        self.hooks += 1
        p = self.plan
        if self.delays and step >= p.delay_from:
            self.sleep(max(self.delays.values()))
        if step in p.fail_steps and ("fail", step) not in self.fired:
            self.fired.add(("fail", step))
            raise TransientShardError(f"injected transient fault @ {step}")
        if (p.lose_shard_at is not None and step >= p.lose_shard_at
                and not self.lost):
            self.lost.append(True)
            raise DeviceLostError(p.lost_shard)
        if step in p.nan_steps and ("nan", step) not in self.fired:
            self.fired.add(("nan", step))
            state = state._replace(F=torch.full_like(state.F, float("nan")))
        return state, {"shard_times": self.shard_times(step)}

    def on_remesh(self, dropped: int | None) -> None:
        """A re-mesh removed shard `dropped`: its injected delay goes with
        it (the straggling rank is out of the job)."""
        if dropped is not None:
            self.delays.pop(dropped, None)
            self.dropped.append(dropped)


class FaultyMesh:
    """Simulated device loss for a mesh: `healthy` is the current surviving
    mesh; `drop(shard)` shrinks it (train/elastic.survivor_mesh) and
    records the casualty.  Pass ``drop`` as the elastic executor's
    `remesh_to` callback (on a mesh of several ranks, on every rank)."""

    def __init__(self, mesh):
        self.healthy = mesh
        self.casualties: list[int] = []

    @property
    def mesh(self):
        return self.healthy

    def drop(self, shard: int | None):
        self.healthy = _elastic.survivor_mesh(self.healthy,
                                              0 if shard is None else shard)
        if shard is not None:
            self.casualties.append(shard)
        return self.healthy
