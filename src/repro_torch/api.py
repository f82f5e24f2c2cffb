"""repro_torch.api: the request/result surface of the port.

Counterpart of src/repro/api.py.  The same request dataclasses drive both
entry paths: the direct call path, where `solve(SolveRequest)` and
`svd(SvdRequest)` run a job at once, and the serving path, where
`launch/serve.SolverServer.submit` enqueues them and answers requests that
share a design matrix with one fused A-pass per group iteration.  Every
`Result.info` carries the standard keys

  iterations — outer iterations (power iterations for randomized SVD)
  a_passes   — streaming passes over A consumed (the paper's cost unit)
  converged  — whether the stopping test fired before the iteration cap
  plan       — which engine answered ("fused", "fused_affine", "cached",
               "gram", "randomized", "fused-group", ...)
  degraded   — None for a full-quality answer, else why it was cut short
               ("deadline", "max_iterations", "fault", "overloaded")
  precision  — what ran ("f32"; "auto" runs f32 until the planner is
               ported)

Requests run on the card: `device` defaults to "cuda" and raises when there
is no card; pass device="cpu" to run on the CPU.  The request validation is
the reference's.  What the port does not have yet raises
NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.distmat.sparserow import SparseRowMatrix
from repro_torch.core.linalg.svd import compute_svd as _compute_svd
from repro_torch.core.optim.first_order import minimize_first_order
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.core.tfocs.prox import ProxL1, ProxL2Sq, ProxZero
from repro_torch.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                           SmoothPoisson, SmoothQuad)
from repro_torch.core.tfocs.solver import TfocsOptions
from repro_torch.kernels.fusedgrad import LOSSES

REGS = ("none", "l1", "l2")
FAULT_TOLERANCE_ITEM = "ROADMAP queue 1 item 14 (fault tolerance and telemetry)"
LOW_PRECISION_ITEM = "ROADMAP queue 1 item 12 (low precision)"
DISTMAT_ITEM = "ROADMAP queue 1 item 9 (distmat types and DIMSUM)"
_ids = itertools.count()


def _next_id(prefix: str) -> str:
    return f"{prefix}-{next(_ids)}"


def _check_scalar(name: str, value, *, minimum=None,
                  exclusive: bool = False, optional: bool = False):
    """Typed validation for request scalars: finite, and bounded below
    when asked."""
    if value is None:
        if optional:
            return
        raise ValueError(f"{name} must be set")
    v = float(value)
    if math.isnan(v) or math.isinf(v):
        raise ValueError(f"{name} must be finite, got {value!r}")
    if minimum is not None:
        if exclusive and not v > minimum:
            raise ValueError(f"{name} must be > {minimum}, got {value!r}")
        if not exclusive and not v >= minimum:
            raise ValueError(f"{name} must be >= {minimum}, got {value!r}")


def _not_yet(what: str, item: str):
    raise NotImplementedError(f"{what} waits for {item}")


@dataclass
class SolveRequest:
    """minimize f(Ax) + h(x): a design matrix `A` (RowMatrix,
    SparseRowMatrix or a local matrix), a target `b` and a row-separable
    `loss`; `smooth` / `prox` are escape hatches for prebuilt components."""
    A: Any = None                 # RowMatrix | SparseRowMatrix | tensor | array
    b: Any = None                 # (m,) target / labels / counts
    loss: str = "quad"            # quad | logistic | huber | poisson
    param: float = 1.0            # loss scalar (huber δ)
    reg: str = "none"             # none | l1 | l2
    lam: float = 0.0              # regularizer weight
    method: str = "gra"           # gra | acc | acc_r | acc_b | acc_rb | lbfgs
    tol: float = 1e-8
    max_iters: int = 200
    L0: float = 1.0               # initial Lipschitz estimate (1/step)
    x0: Any = None
    precision: str = "auto"       # "auto" and "f32" run f32
    deadline_s: float | None = None   # wall budget, honoured by the server
    checkpoint_dir: str | None = None
    checkpoint_every: int = 10
    resume: bool = False
    smooth: Any = None
    prox: Any = None
    telemetry: Any = None
    device: Any = "cuda"
    request_id: str = field(default_factory=lambda: _next_id("solve"))

    def __post_init__(self):
        if self.smooth is None:
            if self.loss not in LOSSES:
                raise ValueError(f"loss must be one of {LOSSES}, "
                                 f"got {self.loss!r}")
            if self.reg not in REGS:
                raise ValueError(f"reg must be one of {REGS}, "
                                 f"got {self.reg!r}")
            if self.A is None or self.b is None:
                raise ValueError("SolveRequest needs (A, b) or a smooth "
                                 "escape hatch")
        _check_scalar("tol", self.tol, minimum=0.0)
        _check_scalar("lam", self.lam, minimum=0.0)
        _check_scalar("L0", self.L0, minimum=0.0, exclusive=True)
        _check_scalar("param", self.param)
        _check_scalar("max_iters", self.max_iters, minimum=0,
                      exclusive=True)
        _check_scalar("deadline_s", self.deadline_s, minimum=0.0,
                      exclusive=True, optional=True)
        _check_scalar("checkpoint_every", self.checkpoint_every, minimum=0,
                      exclusive=True)
        if self.precision not in ("auto", "f32", "bf16", "psum8"):
            raise ValueError("precision must be auto | f32 | bf16 | psum8, "
                             f"got {self.precision!r}")
        if self.resume and self.checkpoint_dir is None:
            raise ValueError("resume=True needs checkpoint_dir")
        if self.precision in ("bf16", "psum8"):
            _not_yet(f"precision={self.precision!r}", LOW_PRECISION_ITEM)
        for name in ("checkpoint_dir", "telemetry"):
            if getattr(self, name) is not None:
                _not_yet(name, FAULT_TOLERANCE_ITEM)
        if self.resume:
            _not_yet("resume", FAULT_TOLERANCE_ITEM)


@dataclass
class SvdRequest:
    """Truncated SVD of a RowMatrix or SparseRowMatrix
    (core.linalg.compute_svd)."""
    A: Any
    k: int
    compute_u: bool = True
    mode: str = "auto"            # auto | gram | lanczos | randomized
    options: dict = field(default_factory=dict)   # extra compute_svd kwargs
    deadline_s: float | None = None
    telemetry: Any = None
    device: Any = "cuda"
    request_id: str = field(default_factory=lambda: _next_id("svd"))

    def __post_init__(self):
        _check_scalar("k", self.k, minimum=0, exclusive=True)
        _check_scalar("deadline_s", self.deadline_s, minimum=0.0,
                      exclusive=True, optional=True)
        for name in ("deadline_s", "telemetry"):
            if getattr(self, name) is not None:
                _not_yet(name, FAULT_TOLERANCE_ITEM)


@dataclass
class SimilarityRequest:
    """DIMSUM column similarities.  Validated as the reference validates
    it; the server refuses it until ROADMAP queue 1 item 9 lands."""
    A: Any
    threshold: float = 0.0
    gamma: float | None = None
    seed: int = 0
    deadline_s: float | None = None
    telemetry: Any = None
    request_id: str = field(default_factory=lambda: _next_id("sim"))

    def __post_init__(self):
        _check_scalar("threshold", self.threshold, minimum=0.0)
        _check_scalar("deadline_s", self.deadline_s, minimum=0.0,
                      exclusive=True, optional=True)


@dataclass
class Result:
    """Answer envelope: `x` for solves, `factors` (U, s, V) for the SVD,
    `info` with the standard keys."""
    x: torch.Tensor | None = None
    factors: tuple | None = None
    info: dict = field(default_factory=dict)
    request_id: str = ""


@dataclass
class Overloaded(Result):
    """Typed load-shed answer: the server refused the request at submit
    because its queue bound was reached.  It carries no solution, only
    `info["degraded"] == "overloaded"`, so clients can tell "retry later"
    from "failed"."""

    def __post_init__(self):
        self.info.setdefault("degraded", "overloaded")
        self.info.setdefault("iterations", 0)
        self.info.setdefault("a_passes", 0)
        self.info.setdefault("converged", False)
        self.info.setdefault("plan", "rejected")


def _on_device(A, device) -> RowMatrix | SparseRowMatrix | torch.Tensor:
    """The request's matrix on the request's device."""
    dev = T.resolve_device(device)
    if isinstance(A, (RowMatrix, SparseRowMatrix, torch.Tensor)):
        if A.device.type != dev.type:
            raise ValueError(f"A lies on {A.device}, the request on {dev}")
        return A
    return T.as_float_tensor(A, dev)


# -- request construction helpers ---------------------------------------------

def solve_linop(req: SolveRequest) -> LinopMatrix:
    return LinopMatrix(_on_device(req.A, req.device))


def solve_smooth(req: SolveRequest, linop: LinopMatrix):
    """The row-separable smooth for a request, padded to the linop's data
    space with padding rows weighted 0."""
    if req.smooth is not None:
        return req.smooth
    b = linop.pad_data(torch.as_tensor(req.b, dtype=torch.float32,
                                       device=linop.device))
    w = linop.row_weights()
    if req.loss == "quad":
        return SmoothQuad(b=b, weights=w)
    if req.loss == "logistic":
        return SmoothLogLoss(y=b, weights=w)
    if req.loss == "huber":
        return SmoothHuber(b=b, delta=req.param, weights=w)
    return SmoothPoisson(y=b, weights=w)


def solve_prox(req: SolveRequest):
    if req.prox is not None:
        return req.prox
    if req.reg == "l1":
        return ProxL1(req.lam)
    if req.reg == "l2":
        return ProxL2Sq(req.lam)
    return ProxZero()


# -- direct call path ---------------------------------------------------------

def solve(req: SolveRequest, *, fused: bool | str = "auto") -> Result:
    """Run one SolveRequest now.  A wall deadline is honoured by the
    server's groups; on this path it waits for the elastic executor."""
    if req.deadline_s is not None:
        _not_yet("deadline_s on the direct path", FAULT_TOLERANCE_ITEM)
    linop = solve_linop(req)
    smooth = solve_smooth(req, linop)
    prox = solve_prox(req)
    x0 = torch.zeros(linop.in_shape, dtype=torch.float32, device=linop.device) \
        if req.x0 is None else torch.as_tensor(req.x0, dtype=torch.float32,
                                               device=linop.device)
    opts = TfocsOptions(max_iters=req.max_iters, tol=req.tol, L0=req.L0,
                        fused=fused, precision=req.precision)
    if req.method == "lbfgs" and not isinstance(prox, ProxZero):
        raise ValueError("method='lbfgs' needs reg='none' (fold the "
                         "regularizer into a smooth loss)")
    x, info = minimize_first_order(req.method, smooth, linop, prox,
                                   x0=x0, opts=opts)
    info.setdefault("degraded", None)
    return Result(x=x, info=info, request_id=req.request_id)


def svd(req: SvdRequest) -> Result:
    """Run one SvdRequest now; factors are (U RowMatrix | None, s, V)."""
    A = _on_device(req.A, req.device)
    if isinstance(A, torch.Tensor):
        A = RowMatrix.create(A, device=A.device)
    res = _compute_svd(A, req.k, compute_u=req.compute_u, mode=req.mode,
                       **req.options)
    info = dict(res.info or {})
    info.setdefault("converged", True)
    info.setdefault("degraded", None)
    info.setdefault("precision", "f32")
    return Result(factors=(res.U, res.s, res.V), info=info,
                  request_id=req.request_id)

