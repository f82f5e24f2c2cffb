"""Elastic, fault-tolerant executor for the batched solver engines.

Counterpart of src/repro/core/optim/elastic.py.  The serving frontend
drives the batched engines (core/optim/batched) one iteration at a time
from the host; ``ElasticGroup`` is that driver, and the host-visible gap
between iterations does the fault-tolerance work:

  * straggler mitigation: per-iteration, per-shard timing telemetry feeds
    train/straggler.ShardMonitor; when it names a slow shard, the group
    re-shards the distributed matrix onto the survivor mesh
    (train/elastic.remesh_linop / survivor_mesh) MID-SOLVE.  The iterate,
    gradient and history state is replicated on every rank and never
    moves, only the matrix does, so the iteration counter stays monotone
    and no completed iteration is re-run (one re-seed pass refreshes F/G
    in the new order of summation);
  * transient faults: a failed pass (TransientShardError) or a non-finite
    smooth value rolls back to the pre-step state and retries with bounded
    exponential backoff; DeviceLostError re-meshes like a monitor trip;
  * resumable solves: ``SolveCheckpoint`` (train/checkpoint underneath)
    snapshots the whole optimizer state (iterates, gradients, L-BFGS
    memory, iteration counters, slot masks) every N iterations and
    restores it bit for bit, so a killed solve resumed from its last
    checkpoint reaches the same state as an undisturbed run.

``solve_elastic`` drives a 1-slot group for the direct call path
(`api.SolveRequest(checkpoint_dir=..., resume=True)` and a gra/lbfgs
request with `deadline_s` come here); launch/serve.GroupRunner wraps a
many-slot group for the serving path.  With ``elastic=None`` the group
runs the op sequence the serving frontend always ran, bit for bit.

On a mesh of several ranks every rank holds the replicated solver state
and runs the same ladder: faults come from a seeded plan (the same fault
at the same iteration on every rank), and every decision a rank could
take alone (a non-finite smooth value, a passed deadline) is agreed over
the row group first.  A re-mesh is called on every rank of the old mesh;
the rank it drops joins the gather of the old strips, then stops
(``dropped``), takes part in no later collective, and its solve returns
its last iterate with ``info["dropped"] = True``.  One rank writes each
checkpoint (train/checkpoint).

The reference writes an admitted slot with jitted scatters; here each
admission writes that slot's row of every state tensor in place (the
engines return fresh tensors every step, so no earlier state shares
them).  The fault-injection side of the contract (``fault_hook`` /
``on_remesh``) is train/faults.FaultyLinop.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.optim import batched as _batched
from repro_torch.launch import telemetry as _tel

GROUP_METHODS = ("gra", "acc", "acc_rb", "lbfgs")
# The accelerated members batch via the affine u-vector trick
# (batched.make_acc_group): quadratic losses only; acc_rb adds
# backtracking and gradient-test restarts.
ACC_METHODS = ("acc", "acc_rb")


class TransientShardError(RuntimeError):
    """One pass over one shard failed but the shard is alive (a dropped
    collective, a preempt notice, a corrupted reduction): roll back the
    iteration and retry with backoff."""


class DeviceLostError(RuntimeError):
    """A shard's device is gone for good: re-mesh onto the survivors."""

    def __init__(self, shard: int):
        super().__init__(f"device backing shard {shard} lost")
        self.shard = shard


# -- resumable solver state ---------------------------------------------------

class SolveCheckpoint:
    """Periodic snapshots of batched solver state, restored bit for bit.

    The snapshot does not depend on the mesh: every optimizer tensor is
    replicated (X/F/G, the L-BFGS S/Y/rho memory, per-slot k/done/obj, the
    active mask), and the data-space rows (targets, weights) are rebuilt
    from the request on restore, so a checkpoint written on two ranks
    resumes on one and the other way round.  Storage is train/checkpoint:
    an atomic .tmp→rename commit, an fsync'd LATEST pointer, and (by
    default) the async writer, so the solve waits only for the copy to the
    host.  `bind` (called by the group, and again after a re-mesh) names
    the mesh whose ranks meet after each commit; its first rank writes."""

    def __init__(self, ckpt_dir, *, every: int = 10, async_save: bool = True):
        from repro_torch.train import checkpoint as _ckpt
        self._ckpt = _ckpt
        self.ckpt_dir = ckpt_dir
        self.every = int(every)
        self.saves = 0
        self.mesh = None
        self._async = _ckpt.AsyncCheckpointer(ckpt_dir) if async_save \
            else None

    def bind(self, mesh) -> None:
        """Write (and meet after each commit) on `mesh`'s ranks from now
        on."""
        self.mesh = mesh
        if self._async is not None:
            self._async.mesh = mesh

    def save(self, step: int, state, active, *, extra: dict | None = None):
        tree = {"state": state, "active": np.asarray(active)}
        extra = dict(extra or {})
        extra["iteration"] = int(step)
        if self._async is not None:
            self._async.save_async(step, tree, extra=extra)
        else:
            self._ckpt.save(self.ckpt_dir, step, tree, extra=extra,
                            mesh=self.mesh)
        self.saves += 1

    def maybe_save(self, step: int, state, active, *,
                   extra: dict | None = None) -> bool:
        if self.every <= 0 or step <= 0 or step % self.every:
            return False
        self.save(step, state, active, extra=extra)
        return True

    def latest(self) -> int | None:
        return self._ckpt.latest_step(self.ckpt_dir)

    def restore(self, state_like, active_like, *, step: int | None = None):
        """(state, active, extra) from the newest committed snapshot (each
        tensor on the device of its `state_like` tensor), or None when the
        directory holds no complete checkpoint."""
        if self.latest() is None:
            return None
        tree, extra = self._ckpt.restore(
            self.ckpt_dir,
            {"state": state_like, "active": np.asarray(active_like)},
            step=step)
        active = np.asarray(tree["active"]).astype(bool)
        return tree["state"], active, extra

    def wait(self) -> None:
        """Block until the in-flight async write commits (and re-raise its
        error, if any); call before treating a checkpoint as durable."""
        if self._async is not None:
            self._async.wait()


@dataclasses.dataclass
class ElasticConfig:
    """Fault-tolerance policy for an ElasticGroup.  All parts optional: a
    monitor without remesh_to only observes; a checkpoint alone gives
    resumability with no straggler handling.  `sleep` is injectable so
    tests check backoff schedules without wall time."""
    monitor: Any = None                                    # ShardMonitor
    remesh_to: Callable[[int | None], Any] | None = None   # shard -> Mesh
    checkpoint: SolveCheckpoint | None = None
    max_retries: int = 3
    backoff_s: float = 0.05
    sleep: Callable[[float], None] = time.sleep


def _reset_row(state, i: int, x0: torch.Tensor, L0: float) -> None:
    """Write slot `i` of every state tensor as a fresh solve from x0: the
    iterates (X, and Z for the accelerated engine) take x0, L takes L0, θ
    takes 1, the objective NaN, everything else 0.  The caches of the
    accelerated engine are rebuilt by the next seed pass."""
    for name, t in state._asdict().items():
        if name in ("X", "Z"):
            t[i] = x0
        elif name == "L":
            t[i] = L0
        elif name == "theta":
            t[i] = 1.0
        elif name == "obj":
            t[i] = math.nan
        else:
            t[i] = 0


def _find_hook(linop):
    """Innermost wrapper exposing the fault_hook protocol
    (train/faults)."""
    obj = linop
    while obj is not None:
        if hasattr(obj, "fault_hook"):
            return obj
        obj = getattr(obj, "base", None)
    return None


def _operand(linop):
    """The matrix under any wrappers (a RowMatrix, a SparseRowMatrix or a
    tensor)."""
    obj = linop
    while not hasattr(obj, "A") or obj.A is None:
        obj = obj.base
    return obj.A


def _mesh_of(linop):
    """The mesh of the operator's matrix: None on one device."""
    return getattr(_operand(linop), "mesh", None)


class ElasticGroup:
    """Host-driven executor for one batched solver group, one iteration at
    a time: the state behind launch/serve.GroupRunner and
    ``solve_elastic``.

    Owns `slots` lanes of batched engine state over a shared linop plus
    the data-space rows (targets T, weights W: this rank's strip of them
    on a mesh, per-slot lam/tol) and the host-side active mask.
    ``admit_slot`` writes a problem into a free lane; ``step_iteration``
    advances every active lane by one engine step (ONE fused group A-pass
    plus shared backtracking attempts) and, with an ElasticConfig, runs
    the recovery ladder around it:

      retry    — TransientShardError / non-finite smooth → roll back to
                 the pre-step state, exponential backoff, bounded retries;
      re-mesh  — DeviceLostError or a ShardMonitor trip → rebuild the
                 linop on config.remesh_to(shard)'s mesh, re-pad T/W for
                 the new shard count, re-seed F/G in one pass; the solver
                 state is untouched, so `k` stays monotone;
      resume   — config.checkpoint snapshots (state, active) every N
                 iterations.

    With ``elastic=None`` every branch above is skipped and the op
    sequence is the serving loop's.

    Every iteration phase is a telemetry span (``solver.iteration`` >
    seed_pass / fused_pass / validate / checkpoint / remesh > rejit), and
    with a live recorder each engine step adds a plan-vs-actual record of
    the fused pass (its planner plan beside the pass's synced time, a try
    each).  `telemetry=None` resolves the module-level recorder at call
    time, a no-op unless enabled.  On a row-sharded matrix an accelerated
    group keeps its cached images as this rank's strips and all_reduces
    their per-slot sums once an attempt (batched.make_acc_group)."""

    def __init__(self, linop, kind: str, param: float = 1.0, *,
                 reg: str = "none", method: str = "gra", slots: int = 8,
                 mem: int = 10, elastic: ElasticConfig | None = None,
                 telemetry: _tel.Recorder | None = None):
        if method not in GROUP_METHODS:
            raise ValueError(f"method must be one of {GROUP_METHODS}")
        if method == "lbfgs" and reg != "none":
            raise ValueError("lbfgs groups need reg='none'")
        if method in ACC_METHODS and kind != "quad":
            raise ValueError("accelerated groups batch via the affine "
                             "u-vector trick — loss='quad' only, got "
                             f"{kind!r}")
        self.linop, self.kind, self.param = linop, kind, param
        self.reg, self.method, self.slots = reg, method, slots
        self.elastic = elastic
        self.n = linop.in_shape[0]
        self.m_pad = linop.out_shape[0]
        self.m_local = self.m_pad // linop.row_shards()
        dev = self.device = torch.device(linop.device)
        if method == "gra":
            self.state = _batched.gra_group_init(slots, self.n, device=dev)
        elif method in ACC_METHODS:
            self.state = _batched.acc_group_init(slots, self.n, self.m_local,
                                                 device=dev)
        else:
            self.state = _batched.lbfgs_group_init(slots, self.n, mem=mem,
                                                   device=dev)
        self._build_engines()
        f32 = dict(dtype=torch.float32, device=dev)
        self.T = torch.zeros((slots, self.m_local), **f32)
        self.W = torch.zeros((slots, self.m_local), **f32)
        self.lam = torch.zeros(slots, **f32)
        self.tol = torch.full((slots,), 1e-8, **f32)
        self.active = np.zeros(slots, bool)          # host-side slot map
        self._slot_b: list = [None] * slots          # raw targets (remesh)
        self.a_passes = 0          # lifetime group passes (the shared cost)
        self._dirty = False        # admissions since the last seed pass
        self.iteration = 0         # global monotone iteration counter
        self.retries = 0
        self.remeshes = 0
        self.checkpoint_saves = 0
        self.dropped = False       # this rank left the mesh at a re-mesh
        self._telemetry = telemetry
        self._fused_plan_cache = None   # invalidated on remesh
        self.monitor = elastic.monitor if elastic is not None else None
        if self.monitor is not None \
                and self.monitor.nshards != linop.row_shards():
            self.monitor.reset(linop.row_shards())
        if elastic is not None and elastic.checkpoint is not None:
            elastic.checkpoint.bind(_mesh_of(linop))

    @property
    def tel(self) -> _tel.Recorder:
        """The group's recorder: the one passed in, else the module-level
        ``telemetry.current()`` (a no-op unless enabled)."""
        return self._telemetry if self._telemetry is not None \
            else _tel.current()

    def _fused_plan(self):
        """The planner's plan of this group's fused pass (the per-step
        unit of plan-vs-actual), made once and again after a re-mesh."""
        if self._fused_plan_cache is None:
            from repro_torch.core.distmat.sparserow import SparseRowMatrix
            from repro_torch.launch import planner
            A = _operand(self.linop)
            if isinstance(A, SparseRowMatrix):
                op, dims, dtype = "fused_grad_bsr_multi", {
                    "m": A._m_local, "n": A.n_pad, "bs": A.bs,
                    "ell": A.ell, "k": self.slots}, A.data.dtype
            else:
                op, dims, dtype = "fused_grad_multi", {
                    "m": self.m_local, "n": self.n, "k": self.slots}, \
                    self.linop.operand_dtype()
            self._fused_plan_cache = planner.plan(
                op, dims, dtype, backend=self.device.type)
        return self._fused_plan_cache

    def _build_engines(self) -> None:
        if self.method == "gra":
            seed, step = _batched.make_gra_group(self.linop, self.kind,
                                                 self.param, reg=self.reg)
        elif self.method in ACC_METHODS:
            rb = self.method == "acc_rb"
            seed, step = _batched.make_acc_group(
                self.linop, self.kind, self.param, reg=self.reg,
                backtracking=rb, restart=rb)
        else:
            seed, step = _batched.make_lbfgs_group(self.linop, self.kind,
                                                   self.param)
        self._seed, self._step = seed, step

    def agree(self, flag: bool) -> bool:
        """`flag` OR-ed over the row group (the flag itself on one shard):
        a host decision every rank takes alike."""
        if self.linop.row_shards() == 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.linop.data_sum(t)[0] > 0)

    # -- slot management ------------------------------------------------------

    def free_slots(self) -> int:
        return int(self.slots - self.active.sum())

    def busy(self) -> bool:
        return bool(self.active.any()) and not self.dropped

    def admit_slot(self, b, *, lam: float = 0.0, tol: float = 1e-8,
                   x0=None, L0: float = 1.0,
                   reset_state: bool = True) -> int:
        """Write a problem into a free slot; costs no pass by itself (the
        next step's seed recomputes F/G for the whole group in one).
        `reset_state=False` binds only the data-space rows, for restoring
        checkpointed solver state into the lane afterwards."""
        i = int(np.flatnonzero(~self.active)[0])
        f32 = dict(dtype=torch.float32, device=self.device)
        b = torch.as_tensor(b, **f32)
        if reset_state:
            x0 = torch.zeros(self.n, **f32) if x0 is None \
                else torch.as_tensor(x0, **f32)
            _reset_row(self.state, i, x0, float(L0))
            self._dirty = True
        self.T[i] = self.linop.pad_data(b)
        self.W[i] = self.linop.row_weights()
        self.lam[i] = float(lam)
        self.tol[i] = float(tol)
        self.active[i] = True
        self._slot_b[i] = b
        return i

    def clear_slot(self, i: int) -> None:
        """Retire lane `i`: zero its weight row so it contributes nothing
        to later group passes (its state rows reset on the next admit)."""
        self.W[i] = 0.0
        self.active[i] = False
        self._slot_b[i] = None

    # -- the iteration --------------------------------------------------------

    def _seed_if_dirty(self) -> int:
        if not self._dirty:
            return 0
        with self.tel.span("solver.seed_pass",
                           active=int(self.active.sum())) as sp:
            if self.method == "lbfgs":
                self.state, p = self._seed(self.state, self.T, self.W)
            else:
                self.state, p = self._seed(self.state, self.T, self.W,
                                           self.lam)
            sp.sync_on(self.state.F)
        self._dirty = False
        self.a_passes += p
        return p

    def _engine_step(self, act):
        if self.method == "lbfgs":
            return self._step(self.state, self.T, self.W, self.tol, act)
        return self._step(self.state, self.T, self.W, self.lam, self.tol,
                          act)

    def step_iteration(self) -> int:
        """One solver iteration for every active slot; returns the group
        A-passes taken (re-seeds, retries and re-meshes included).  Raises
        TransientShardError when a fault outlives max_retries, and
        DeviceLostError when a device dies with no remesh_to policy."""
        if not self.busy():
            return 0
        tel = self.tel
        passes = 0
        failures = 0
        with tel.span("solver.iteration", iteration=self.iteration,
                      active=int(self.active.sum())):
            while True:
                passes += self._seed_if_dirty()
                act = torch.as_tensor(self.active, device=self.device)
                t0 = time.monotonic()
                with tel.span("solver.fused_pass") as psp:
                    new_state, tries = self._engine_step(act)
                    dt = time.monotonic() - t0
                    psp.sync_on(new_state.F)
                    psp.annotate(tries=tries)
                passes += tries
                self.a_passes += tries
                if tel.enabled:
                    tel.record_plan_actual(
                        self._fused_plan(), psp.dur_s / max(tries, 1),
                        iteration=self.iteration, tries=tries)
                if self.elastic is None:
                    self.state = new_state
                    return passes
                telemetry = None
                try:
                    with tel.span("solver.validate"):
                        hook = _find_hook(self.linop)
                        if hook is not None:
                            new_state, telemetry = hook.fault_hook(
                                self.iteration, new_state, dt)
                        bad = not bool(torch.all(torch.isfinite(
                            torch.where(act, new_state.F, 0.0))))
                        if self.agree(bad):
                            raise TransientShardError(
                                "non-finite smooth value after step")
                except DeviceLostError as e:
                    if self.elastic.remesh_to is None:
                        raise
                    # The pre-step state is intact (rollback is free:
                    # new_state was never committed): re-mesh, run the
                    # iteration again.
                    self.remesh(self.elastic.remesh_to(e.shard),
                                dropped=e.shard)
                    if self.dropped:
                        return passes
                    failures = 0
                    continue
                except TransientShardError:
                    failures += 1
                    self.retries += 1
                    tel.counter("solver.retries").inc()
                    if failures > self.elastic.max_retries:
                        raise
                    self.elastic.sleep(self.elastic.backoff_s
                                       * (2 ** (failures - 1)))
                    continue                   # rollback + bounded retry
                self.state = new_state
                self.iteration += 1
                if telemetry is not None and self.monitor is not None:
                    verdict = self.monitor.observe(telemetry["shard_times"])
                    if verdict["tripped"] \
                            and self.elastic.remesh_to is not None:
                        self.remesh(self.elastic.remesh_to(verdict["shard"]),
                                    dropped=verdict["shard"])
                        if self.dropped:
                            return passes
                ck = self.elastic.checkpoint
                if ck is not None and ck.every > 0 \
                        and self.iteration % ck.every == 0:
                    with tel.span("solver.checkpoint",
                                  iteration=self.iteration):
                        if ck.maybe_save(self.iteration, self.state,
                                         self.active,
                                         extra={"a_passes": self.a_passes}):
                            self.checkpoint_saves += 1
                return passes

    # -- mid-solve re-mesh ----------------------------------------------------

    def remesh(self, new_mesh, dropped: int | None = None) -> None:
        """Move the MATRIX to `new_mesh` mid-solve; the solver state does
        not depend on the mesh and stays put.  The data-space rows are
        re-padded for the new shard count from the stored raw targets, and
        the next step re-seeds F/G in one group pass: `k` is untouched,
        so no completed iteration is re-run.  Every rank of the old mesh
        calls it; on the rank `new_mesh` leaves out, the group stops
        (`dropped`)."""
        from repro_torch.train import elastic as _train_elastic
        tel = self.tel
        with tel.span("solver.remesh", dropped=dropped,
                      iteration=self.iteration):
            self._remesh_inner(_train_elastic, new_mesh, dropped, tel)
        tel.counter("solver.remeshes").inc()

    def _remesh_inner(self, _train_elastic, new_mesh, dropped, tel) -> None:
        ck = self.elastic.checkpoint if self.elastic is not None else None
        if ck is not None:
            ck.wait()                  # the old mesh's last commit barrier
        self.linop = _train_elastic.remesh_linop(self.linop, new_mesh)
        obj = self.linop
        while obj is not None:                 # tell injection wrappers
            if hasattr(obj, "on_remesh"):
                obj.on_remesh(dropped)
            obj = getattr(obj, "base", None)
        self.remeshes += 1
        if new_mesh is not None and not new_mesh.member:
            self.dropped = True        # out of the mesh: no more collectives
            return
        if ck is not None:
            ck.bind(_mesh_of(self.linop))
        self.m_pad = self.linop.out_shape[0]
        self.m_local = self.m_pad // self.linop.row_shards()
        self._fused_plan_cache = None          # re-price plan-vs-actual
        with tel.span("solver.rejit"):
            self._build_engines()
        if self.method in ACC_METHODS:
            # The accelerated state caches data-space images at the OLD
            # row count; re-size them and let the dirty re-seed (3 group
            # passes) rebuild AX/AZ and the u-vectors.
            z = torch.zeros((self.slots, self.m_local), dtype=torch.float32,
                            device=self.device)
            self.state = self.state._replace(AX=z, AZ=z.clone())
        self.T = torch.zeros((self.slots, self.m_local), dtype=torch.float32,
                             device=self.device)
        self.W = torch.zeros_like(self.T)
        w = self.linop.row_weights()
        for i in range(self.slots):
            if self.active[i] and self._slot_b[i] is not None:
                self.T[i] = self.linop.pad_data(self._slot_b[i])
                self.W[i] = w
        self._dirty = True                     # one re-seed pass next step
        if self.monitor is not None:
            self.monitor.reset(self.linop.row_shards())


# -- the direct resumable path ------------------------------------------------

def solve_elastic(linop, kind: str, b, *, param: float = 1.0,
                  reg: str = "none", lam: float = 0.0, method: str = "gra",
                  tol: float = 1e-8, max_iters: int = 200, L0: float = 1.0,
                  x0=None, deadline_s: float | None = None,
                  resume: bool = False,
                  elastic: ElasticConfig | None = None):
    """Drive a 1-slot ElasticGroup to convergence: the fault-tolerant,
    resumable, deadline-aware twin of the one-shot solvers (the path
    `api.solve` takes when a request carries checkpoint_dir/deadline_s).
    Returns (x, info) with the standard info keys plus the recovery
    counters (degraded / retries / remeshes / checkpoint_saves /
    resumed_from), and ``dropped=True`` on a rank a re-mesh left out."""
    if elastic is None:
        elastic = ElasticConfig()
    grp = ElasticGroup(linop, kind, param, reg=reg, method=method, slots=1,
                       elastic=elastic)
    ck = elastic.checkpoint
    resumed_from = None
    if resume and ck is not None and ck.latest() is not None:
        grp.admit_slot(b, lam=lam, tol=tol, x0=x0, L0=L0,
                       reset_state=False)
        state, active, extra = ck.restore(grp.state, grp.active)
        grp.state = state
        grp.active = active
        grp.iteration = int(extra.get("iteration", 0))
        grp.a_passes = int(extra.get("a_passes", 0))
        grp._dirty = False          # F/G restored bit for bit: no re-seed
        resumed_from = grp.iteration
    else:
        grp.admit_slot(b, lam=lam, tol=tol, x0=x0, L0=L0)

    deadline_at = time.monotonic() + deadline_s if deadline_s else None
    degraded = None
    while not grp.dropped:
        k = int(grp.state.k[0])
        if bool(grp.state.done[0]) or k >= max_iters:
            break
        if deadline_at is not None \
                and grp.agree(time.monotonic() > deadline_at):
            degraded = "deadline"   # return the best iterate, don't block
            break
        grp.step_iteration()
    if ck is not None:
        ck.wait()                   # surface any lost background write
    k = int(grp.state.k[0])
    converged = bool(grp.state.done[0])
    if degraded is None and not converged and k >= max_iters:
        degraded = "max_iterations"
    info = {"iterations": k, "a_passes": grp.a_passes,
            "converged": converged, "plan": "elastic",
            "objective": float(grp.state.obj[0]),
            "degraded": degraded, "retries": grp.retries,
            "remeshes": grp.remeshes,
            "checkpoint_saves": grp.checkpoint_saves,
            "resumed_from": resumed_from}
    if deadline_s is not None:
        info["deadline_s"] = float(deadline_s)
    if grp.dropped:
        info["dropped"] = True
    return grp.state.X[0].clone(), info
