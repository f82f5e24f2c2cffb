"""Host-driven executor for the batched solver engines (the state behind
launch/serve.GroupRunner).

Counterpart of src/repro/core/optim/elastic.py with ``elastic=None``: the
group runs the op sequence the serving frontend always ran, one iteration
at a time from the host.  The fault-tolerance policy of the reference
(straggler re-meshing, retry with backoff, resumable checkpoints) waits for
ROADMAP queue 1 item 14; a non-None ``elastic`` raises.

The reference writes an admitted slot with jitted scatters; here each
admission writes that slot's row of every state tensor in place (the
engines return fresh tensors every step, so no earlier state shares them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.optim import batched as _batched
from repro_torch.launch import telemetry as _tel

GROUP_METHODS = ("gra", "acc", "acc_rb", "lbfgs")
# The accelerated members batch via the affine u-vector trick
# (batched.make_acc_group): quadratic losses only; acc_rb adds
# backtracking and gradient-test restarts.
ACC_METHODS = ("acc", "acc_rb")
FAULT_TOLERANCE_ITEM = "ROADMAP queue 1 item 14 (fault tolerance and telemetry)"


class TransientShardError(RuntimeError):
    """One pass over one shard failed but the shard is alive: roll back the
    iteration and retry."""


class DeviceLostError(RuntimeError):
    """A shard's device is gone for good."""

    def __init__(self, shard: int):
        super().__init__(f"device backing shard {shard} lost")
        self.shard = shard


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


class ElasticGroup:
    """Host-driven executor for one batched solver group, one iteration at
    a time.

    Owns `slots` lanes of batched engine state over a shared linop plus
    the data-space rows (targets T, weights W, per-slot lam/tol) and the
    host-side active mask.  ``admit_slot`` writes a problem into a free
    lane; ``step_iteration`` advances every active lane by one engine step
    (ONE fused group A-pass plus shared backtracking attempts).  Each
    iteration is a telemetry span (``solver.iteration`` > ``seed_pass`` /
    ``fused_pass``); `telemetry=None` resolves the module-level recorder at
    call time, a no-op unless enabled."""

    def __init__(self, linop, kind: str, param: float = 1.0, *,
                 reg: str = "none", method: str = "gra", slots: int = 8,
                 mem: int = 10, elastic=None,
                 telemetry: _tel.Recorder | None = None):
        if elastic is not None:
            raise NotImplementedError(
                f"an ElasticConfig waits for {FAULT_TOLERANCE_ITEM}")
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
        self.n = linop.in_shape[0]
        self.m_pad = linop.out_shape[0]
        dev = self.device = torch.device(linop.device)
        if method == "gra":
            self.state = _batched.gra_group_init(slots, self.n, device=dev)
            seed, step = _batched.make_gra_group(linop, kind, param, reg=reg)
        elif method in ACC_METHODS:
            self.state = _batched.acc_group_init(slots, self.n, self.m_pad,
                                                 device=dev)
            rb = method == "acc_rb"
            seed, step = _batched.make_acc_group(
                linop, kind, param, reg=reg, backtracking=rb, restart=rb)
        else:
            self.state = _batched.lbfgs_group_init(slots, self.n, mem=mem,
                                                   device=dev)
            seed, step = _batched.make_lbfgs_group(linop, kind, param)
        self._seed, self._step = seed, step
        f32 = dict(dtype=torch.float32, device=dev)
        self.T = torch.zeros((slots, self.m_pad), **f32)
        self.W = torch.zeros((slots, self.m_pad), **f32)
        self.lam = torch.zeros(slots, **f32)
        self.tol = torch.full((slots,), 1e-8, **f32)
        self.active = np.zeros(slots, bool)          # host-side slot map
        self.a_passes = 0          # lifetime group passes (the shared cost)
        self._dirty = False        # admissions since the last seed pass
        self._telemetry = telemetry

    @property
    def tel(self) -> _tel.Recorder:
        """The group's recorder: the one passed in, else the module-level
        ``telemetry.current()``."""
        return self._telemetry if self._telemetry is not None \
            else _tel.current()

    # -- slot management ------------------------------------------------------

    def free_slots(self) -> int:
        return int(self.slots - self.active.sum())

    def busy(self) -> bool:
        return bool(self.active.any())

    def admit_slot(self, b, *, lam: float = 0.0, tol: float = 1e-8,
                   x0=None, L0: float = 1.0) -> int:
        """Write a problem into a free slot; costs no pass by itself (the
        next step's seed recomputes F/G for the whole group in one)."""
        i = int(np.flatnonzero(~self.active)[0])
        f32 = dict(dtype=torch.float32, device=self.device)
        b = torch.as_tensor(b, **f32)
        x0 = torch.zeros(self.n, **f32) if x0 is None \
            else torch.as_tensor(x0, **f32)
        _reset_row(self.state, i, x0, float(L0))
        self.T[i] = self.linop.pad_data(b)
        self.W[i] = self.linop.row_weights()
        self.lam[i] = float(lam)
        self.tol[i] = float(tol)
        self._dirty = True
        self.active[i] = True
        return i

    def clear_slot(self, i: int) -> None:
        """Retire lane `i`: zero its weight row so it contributes nothing
        to later group passes (its state rows reset on the next admit)."""
        self.W[i] = 0.0
        self.active[i] = False

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
        A-passes taken, the re-seed after admissions included."""
        if not self.busy():
            return 0
        tel = self.tel
        with tel.span("solver.iteration", active=int(self.active.sum())):
            passes = self._seed_if_dirty()
            act = torch.as_tensor(self.active, device=self.device)
            with tel.span("solver.fused_pass") as psp:
                self.state, tries = self._engine_step(act)
                psp.sync_on(self.state.F)
                psp.annotate(tries=tries)
            self.a_passes += tries
            return passes + tries
