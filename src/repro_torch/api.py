"""repro_torch.api: the request/result surface of the port.

Counterpart of src/repro/api.py.  The same request dataclasses drive both
entry paths: the direct call path, where `solve(SolveRequest)`,
`svd(SvdRequest)` and `similarities(SimilarityRequest)` run a job at once,
and the serving path, where `launch/serve.SolverServer.submit` enqueues
them and answers requests that share a design matrix with one fused A-pass
per group iteration.  Every
`Result.info` carries the standard keys

  iterations — outer iterations (power iterations for randomized SVD)
  a_passes   — streaming passes over A consumed (the paper's cost unit)
  converged  — whether the stopping test fired before the iteration cap
  plan       — which engine answered ("fused", "fused_affine", "cached",
               "gram", "randomized", "lanczos", "fused-group", "dimsum",
               ...)
  degraded   — None for a full-quality answer, else why it was cut short
               ("deadline", "max_iterations", "fault", "overloaded")
  precision  — what ran: "f32", "bf16" or "psum8" ("auto" asks the
               planner's precision sweep at the request's tol; "psum8"
               sends the gradient's all_reduce as int8 with error feedback
               on a RowMatrix or SparseRowMatrix, on one shard or a mesh,
               and reports "psum8"; on a local operand, or in an engine
               that takes no compressed wire, it runs and reports f32)

Requests run on the card: `device` defaults to "cuda" and raises when there
is no card; pass device="cpu" to run on the CPU.  The request validation is
the reference's.  What the port does not have yet raises
NotImplementedError naming its ROADMAP item.

Fault tolerance and observability, as the reference's: a direct-form
gra/lbfgs request with `checkpoint_dir` (periodic resumable snapshots,
`resume=True` to continue from the newest) or `deadline_s` runs the
host-driven elastic executor (core/optim/elastic.solve_elastic; info
"plan" "elastic", with its recovery counters), which returns its best
iterate with degraded="deadline" when the budget runs out; the other
solves, SVDs and similarity requests report a blown deadline after the
fact.  `telemetry=True` (or a telemetry.Recorder) runs the request under a
scoped recorder and attaches its summary as `Result.info["trace"]`.

The thin wrappers `minimize` (a Figure-1 `Problem` through
`solve(SolveRequest(problem=...))`, core.optim.minimize underneath),
`compute_svd` (an SvdRequest on any §2 matrix type, returning
(U, s, V, info)) and `column_similarities` keep the reference's signatures.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.linalg.svd import compute_svd as _compute_svd
from repro_torch.core.optim.api import minimize as _minimize
from repro_torch.core.optim.first_order import minimize_first_order
from repro_torch.core.optim.problems import Problem
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.core.tfocs.prox import ProxL1, ProxL2Sq, ProxZero
from repro_torch.core.tfocs.smooth import (SmoothHuber, SmoothLogLoss,
                                           SmoothPoisson, SmoothQuad)
from repro_torch.core.tfocs.solver import TfocsOptions
from repro_torch.kernels.fusedgrad import LOSSES

REGS = ("none", "l1", "l2")
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


@dataclass
class SolveRequest:
    """minimize f(Ax) + h(x): a design matrix `A` (RowMatrix,
    SparseRowMatrix or a local matrix), a target `b` and a row-separable
    `loss`; `problem` (a core.optim Problem, run by core.optim.minimize)
    and `smooth` / `prox` are escape hatches for prebuilt composites, served
    one-shot."""
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
    # Compute/storage precision: "auto" lets the planner's precision sweep
    # pick within the tolerance's error guard; "f32"/"bf16"/"psum8" force
    # the choice.  Result.info["precision"] reports what ran.
    precision: str = "auto"
    # fault tolerance / resumability (core/optim/elastic):
    deadline_s: float | None = None     # wall budget; past it, best iterate
    checkpoint_dir: str | None = None   # periodic resumable snapshots
    checkpoint_every: int = 10          # iterations between snapshots
    resume: bool = False                # restore from checkpoint_dir first
    problem: Problem | None = None
    smooth: Any = None
    prox: Any = None
    # observability (launch/telemetry): True for a fresh recorder, or a
    # telemetry.Recorder to accumulate across requests; the summary lands
    # in Result.info["trace"].
    telemetry: Any = None
    device: Any = "cuda"
    request_id: str = field(default_factory=lambda: _next_id("solve"))

    def __post_init__(self):
        if self.problem is None and self.smooth is None:
            if self.loss not in LOSSES:
                raise ValueError(f"loss must be one of {LOSSES}, "
                                 f"got {self.loss!r}")
            if self.reg not in REGS:
                raise ValueError(f"reg must be one of {REGS}, "
                                 f"got {self.reg!r}")
            if self.A is None or self.b is None:
                raise ValueError("SolveRequest needs (A, b) or a "
                                 "problem/smooth escape hatch")
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
        if self.checkpoint_dir is not None:
            if self.problem is not None or self.smooth is not None \
                    or self.prox is not None:
                raise ValueError("checkpoint_dir needs the (A, b) request "
                                 "form (escape hatches aren't resumable)")
            if self.method not in ("gra", "lbfgs"):
                raise ValueError("checkpoint_dir needs method 'gra' or "
                                 f"'lbfgs', got {self.method!r}")
        if self.resume and self.checkpoint_dir is None:
            raise ValueError("resume=True needs checkpoint_dir")


@dataclass
class SvdRequest:
    """Truncated SVD of one of the §2 matrix types (RowMatrix,
    SparseRowMatrix, IndexedRowMatrix, CoordinateMatrix, BlockMatrix) or a
    local matrix (core.linalg.compute_svd)."""
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


@dataclass
class SimilarityRequest:
    """DIMSUM column similarities of a RowMatrix or SparseRowMatrix (exact
    at threshold=0, sampled above; column_similarities)."""
    A: Any
    threshold: float = 0.0
    gamma: float | None = None
    seed: int = 0
    deadline_s: float | None = None
    telemetry: Any = None
    device: Any = "cuda"
    request_id: str = field(default_factory=lambda: _next_id("sim"))

    def __post_init__(self):
        _check_scalar("threshold", self.threshold, minimum=0.0)
        _check_scalar("deadline_s", self.deadline_s, minimum=0.0,
                      exclusive=True, optional=True)


@dataclass
class Result:
    """Answer envelope: `x` for solves, `factors` (U, s, V) for the SVD
    and (sim,) for similarities, `info` with the standard keys."""
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


def _on_device(A, device) -> T.DistMatrix | torch.Tensor:
    """The request's matrix on the request's device."""
    dev = T.resolve_device(device)
    if isinstance(A, (T.DistMatrix, torch.Tensor)):
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

def _traced(req, kind: str, run) -> Result:
    """The ``telemetry=`` escape hatch: when the request asks for it, run
    the job under a scoped recorder (every instrumented component resolves
    it through telemetry.current()) and attach the compact summary as
    ``Result.info["trace"]``.  Off (the default) adds no work."""
    if not req.telemetry:
        return run()
    from repro_torch.launch import telemetry as _telemetry
    rec = req.telemetry if isinstance(req.telemetry, _telemetry.Recorder) \
        else _telemetry.Recorder()
    with _telemetry.recording(rec):
        with rec.span("api." + kind, request_id=req.request_id):
            res = run()
    res.info["trace"] = rec.summary()
    return res


def _past(t0: float, deadline_s: float | None) -> bool:
    return deadline_s is not None and time.perf_counter() - t0 > deadline_s


def _solve_elastic(req: SolveRequest) -> Result:
    """The host-driven resumable, deadline-aware path
    (core/optim/elastic): a direct-form gra/lbfgs request that asks for a
    checkpoint or a wall deadline.  The one-shot solvers cannot be
    snapshotted or stopped mid-flight; the per-iteration driver can."""
    from repro_torch.core.optim import elastic as _elastic
    ckpt = None
    if req.checkpoint_dir is not None:
        ckpt = _elastic.SolveCheckpoint(req.checkpoint_dir,
                                        every=req.checkpoint_every)
    cfg = _elastic.ElasticConfig(checkpoint=ckpt)
    linop = solve_linop(req)
    x, info = _elastic.solve_elastic(
        linop, req.loss, req.b, param=req.param, reg=req.reg, lam=req.lam,
        method=req.method, tol=req.tol, max_iters=req.max_iters, L0=req.L0,
        x0=req.x0, deadline_s=req.deadline_s, resume=req.resume,
        elastic=cfg)
    info["precision"] = "bf16" if linop.operand_dtype() == torch.bfloat16 \
        else "f32"
    return Result(x=x, info=info, request_id=req.request_id)


def solve(req: SolveRequest, *, fused: bool | str = "auto") -> Result:
    """Run one SolveRequest now (no queue, no batching)."""
    return _traced(req, "solve", lambda: _solve(req, fused=fused))


def _solve(req: SolveRequest, *, fused: bool | str = "auto") -> Result:
    if req.problem is not None:
        x, info = _minimize(req.problem, req.method,
                            max_iters=req.max_iters, tol=req.tol,
                            fused=fused)
        info = dict(info)
        info.setdefault("degraded", None)
        info.setdefault("precision", "f32")
        return Result(x=x, info=info, request_id=req.request_id)
    if (req.checkpoint_dir is not None
            or (req.deadline_s is not None
                and req.method in ("gra", "lbfgs")
                and req.smooth is None and req.prox is None)):
        return _solve_elastic(req)
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
    t0 = time.perf_counter()
    x, info = minimize_first_order(req.method, smooth, linop, prox,
                                   x0=x0, opts=opts)
    info.setdefault("degraded", None)
    if _past(t0, req.deadline_s):
        # The one-shot accelerated solvers cannot stop mid-flight; the
        # overrun is reported after the fact so callers still learn the
        # budget was blown.
        info["degraded"] = "deadline"
    return Result(x=x, info=info, request_id=req.request_id)


def svd(req: SvdRequest) -> Result:
    """Run one SvdRequest now; factors are (U RowMatrix | None, s, V)."""
    return _traced(req, "svd", lambda: _svd(req))


def _svd(req: SvdRequest) -> Result:
    A = _on_device(req.A, req.device)
    if isinstance(A, torch.Tensor):
        A = RowMatrix.create(A, device=A.device)
    t0 = time.perf_counter()
    res = _compute_svd(A, req.k, compute_u=req.compute_u, mode=req.mode,
                       **req.options)
    info = dict(res.info or {})
    info.setdefault("converged", True)
    info.setdefault("degraded", None)
    info.setdefault("precision", "f32")
    if _past(t0, req.deadline_s):
        info["degraded"] = "deadline"
    return Result(factors=(res.U, res.s, res.V), info=info,
                  request_id=req.request_id)


def similarities(req: SimilarityRequest) -> Result:
    """Run one SimilarityRequest now; factors are (sim,).  DIMSUM is one
    Gram-style reduction: one pass over A, no iteration."""
    return _traced(req, "similarities", lambda: _similarities(req))


def _similarities(req: SimilarityRequest) -> Result:
    A = _on_device(req.A, req.device)
    if isinstance(A, torch.Tensor):
        A = RowMatrix.create(A, device=A.device)
    t0 = time.perf_counter()
    sim, info = A.column_similarities(req.threshold, gamma=req.gamma,
                                      seed=req.seed, return_info=True)
    info = dict(info)
    info.setdefault("iterations", 0)
    info.setdefault("a_passes", 1)
    info.setdefault("converged", True)
    info.setdefault("plan", "dimsum" if req.threshold > 0 else "gram")
    info.setdefault("degraded", None)
    if _past(t0, req.deadline_s):
        info["degraded"] = "deadline"
    return Result(factors=(sim,), info=info, request_id=req.request_id)


# -- thin signature-compatible wrappers ---------------------------------------

def minimize(problem: Problem, method: str, *, max_iters: int = 200,
             step_size: float | None = None, tol: float = 1e-10,
             fused: bool | str = "auto"):
    """Thin wrapper: a Problem-shaped SolveRequest through the path the
    server drives, on the problem's device.  Returns (x, info) as
    core.optim.minimize does."""
    if step_size is not None:
        # A problem request resolves L0 inside core.optim.minimize.
        return _minimize(problem, method, max_iters=max_iters,
                         step_size=step_size, tol=tol, fused=fused)
    res = solve(SolveRequest(problem=problem, method=method, tol=tol,
                             max_iters=max_iters,
                             device=problem.linop.device), fused=fused)
    return res.x, res.info


def compute_svd(A, k: int, *, compute_u: bool = True, mode: str = "auto",
                device="cuda", **options):
    """Thin wrapper: an SvdRequest through the request path.  Returns
    (U, s, V, info) unpacked from the Result."""
    res = svd(SvdRequest(A=A, k=k, compute_u=compute_u, mode=mode,
                         options=options, device=device))
    U, s, V = res.factors
    return U, s, V, res.info


def column_similarities(A, threshold: float = 0.0, *,
                        gamma: float | None = None, seed: int = 0,
                        device="cuda"):
    """Thin wrapper: a SimilarityRequest through the request path.
    Returns (sim, info)."""
    res = similarities(SimilarityRequest(A=A, threshold=threshold,
                                         gamma=gamma, seed=seed,
                                         device=device))
    return res.factors[0], res.info
