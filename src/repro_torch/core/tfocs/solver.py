"""The TFOCS first-order engine (paper §3.2): Auslender–Teboulle accelerated
proximal gradient with backtracking Lipschitz estimation, gradient-test
restart and linear-operator image caching.

Counterpart of src/repro/core/tfocs/solver.py, with its three engines:

  * ``_tfocs_fused`` — non-accelerated runs (`gra`) over a row-separable
    smooth: with θ ≡ 1 the candidate point is the next gradient point, so
    one fused pass over A (kernels/fusedgrad) covers a whole backtracking
    attempt;
  * ``_tfocs_fused_accel`` — accelerated runs over a quadratic smooth: the
    gradient is affine in u_v = Aᵀ(w∘A v), so one fused pass per attempt;
  * the cached engine — everything else: one apply and one adjoint per
    attempt, images of the iterates carried so the momentum point costs no
    pass.

Each `lax.while_loop` of the reference is a Python loop over device
tensors here, so each stopping test and each backtracking test is a host
sync.  L, θ and the objective scalars stay float32, as in the reference, so
the tests fall the same way on both sides.

`fused="auto"` and `precision="auto"` consult the execution planner
(launch/planner.plan("grad", ...)) on the shard's dims and, on a mesh,
the row axes' sizes, as in the reference.  "bf16" runs the operand's bf16
copy (``linop.astype_store``); "psum8" sends the θ ≡ 1 fused engine's
gradient over the compressed int8 all_reduce with error feedback
(train/compression.psum_int8; the residual threads through the loop as
the reference's does), on one rank too, and falls back to f32 on a local
operand and in the other engines, as the reference does.

On a row-sharded operand every data-space reduction of the cached and
the accelerated engines (a smooth's value, a data-space dot) goes through
``linop.data_sum``, one all_reduce per attempt, so every host decision
(backtracking, restart, stopping) reads the same bits on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .smooth import row_separable

_PRECISIONS = ("auto", "f32", "bf16", "psum8")


@dataclass(frozen=True)
class TfocsOptions:
    max_iters: int = 500
    tol: float = 1e-8
    L0: float = 1.0              # initial Lipschitz estimate
    Lexact: float | None = None  # if set: no backtracking, fixed step 1/L
    alpha: float = 2.0           # backtracking increase factor
    beta: float = 0.9            # per-iteration optimistic L decay
    max_backtracks: int = 30
    accel: bool = True
    backtracking: bool = True
    restart: bool = False        # O'Donoghue–Candès gradient-test restart
    fused: bool | str = "auto"   # single-pass fused gradient (False opts out)
    # "auto" asks the planner's precision sweep at `tol`; "f32", "bf16" and
    # "psum8" force the choice; info["precision"] reports what ran.
    precision: str = "auto"


def _fused_capable(linop) -> bool:
    """True when the operator, and every operator it wraps, implements
    fused_grad."""
    if not hasattr(linop, "fused_grad"):
        return False
    base = getattr(linop, "base", None)
    return True if base is None else _fused_capable(base)


def _backend(linop) -> str | None:
    dev = getattr(linop, "device", None)
    return None if dev is None else torch.device(dev).type


def _shard_rows(linop) -> int:
    """Rows of one shard of the operator's data space: the fused-vs-
    unfused roofline is priced per shard, as the reference prices it."""
    m = int(linop.out_shape[0])
    shards = linop.row_shards() if hasattr(linop, "row_shards") else 1
    return max(m // max(shards, 1), 1)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _data_sum(linop):
    """The operator's all_reduce of a partial data-space sum (`_same` on
    one row shard and for an operator without one)."""
    dsum = getattr(linop, "data_sum", None)
    shards = linop.row_shards() if hasattr(linop, "row_shards") else 1
    return dsum if dsum is not None and shards > 1 else _same


def fused_gradient_enabled(smooth, linop, fused: bool | str = "auto",
                           *, needs_theta_one: bool = False,
                           accel: bool = False) -> bool:
    """Whether a (smooth, linop) composite takes the single-pass fused
    gradient.  Structure gates first (a row-separable smooth, a
    fused-capable operator and, with `needs_theta_one`, no acceleration);
    "auto" then consults the planner (plan("grad", ...): one read of A
    against two, priced on the calibrated machine model)."""
    if fused is False or (needs_theta_one and accel):
        return False
    ok = row_separable(smooth) is not None and _fused_capable(linop)
    if fused is True:
        if not ok:
            raise ValueError("fused=True needs a row-separable smooth and a "
                             "fused-capable linop (LinopMatrix)")
        return True
    if fused != "auto":
        raise ValueError(f"fused must be True, False or 'auto', got {fused!r}")
    if not ok:
        return False
    try:
        m, n = _shard_rows(linop), int(linop.in_shape[0])
        dtype = linop.operand_dtype() if hasattr(linop, "operand_dtype") \
            else torch.float32
    except (AttributeError, TypeError):
        return True
    from repro_torch.launch import planner as _planner
    return _planner.plan("grad", {"m": m, "n": n}, dtype,
                         backend=_backend(linop)).choice == "fused"


def resolve_precision(linop, opts: TfocsOptions) -> str:
    """The solver's precision: "auto" runs the planner's precision sweep,
    plan("grad", dims, context={"tol": opts.tol}), which admits bf16
    storage only when its error guard clears opts.tol and its modeled
    savings clear the planner's floor.  Explicit values force the choice;
    a non-f32 operand (already recast) and a non-matrix operator resolve
    to "f32"."""
    if opts.precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, "
                         f"got {opts.precision!r}")
    if opts.precision != "auto":
        return opts.precision
    if not (_fused_capable(linop) and hasattr(linop, "operand_dtype")):
        return "f32"
    try:
        if linop.operand_dtype() != torch.float32:
            return "f32"
        m, n = _shard_rows(linop), int(linop.in_shape[0])
    except (AttributeError, TypeError):
        return "f32"
    ctx = {"tol": float(opts.tol)}
    axes = linop.axis_sizes() if hasattr(linop, "axis_sizes") else ()
    if axes:
        ctx["axes"] = axes
    from repro_torch.launch import planner as _planner
    p = _planner.plan("grad", {"m": m, "n": n}, "float32",
                      backend=_backend(linop), context=ctx)
    return p.precision or "f32"


def store_precision(linop, prec: str, *, wire: bool):
    """(operand, precision, residual) to run `prec` with: "bf16" recasts
    the operand's storage (f32 where it has none); "psum8" gives the
    zeroed error-feedback residual of a RowMatrix or SparseRowMatrix
    operand and falls back to f32 on a local one, or in an engine that
    never takes the compressed wire (`wire` False), as the reference
    does.  The residual is None unless "psum8" runs."""
    if prec == "bf16":
        try:
            return linop.astype_store(torch.bfloat16), "bf16", None
        except AttributeError:
            return linop, "f32", None
    if prec == "psum8":
        init = getattr(linop, "init_psum_residual", None)
        residual = init() if wire and init is not None else None
        return (linop, "psum8", residual) if residual is not None \
            else (linop, "f32", None)
    return linop, prec, None


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _rel_step(x_new: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.vector_norm(x_new - x)
            / torch.clamp(torch.linalg.vector_norm(x_new), min=1.0))


def _data_terms(dsum, smooth, fy_part, gy, Ay, Ax_new):
    """(f(Ay), f(Ax⁺), ⟨∇f(Ay), Ax⁺ − Ay⟩) over the whole data space: the
    shard's three partial sums in one all_reduce (none on one shard)."""
    f_new, gdy = smooth.value(Ax_new), torch.dot(gy, Ax_new - Ay)
    if dsum is _same:
        return fy_part, f_new, gdy
    return tuple(dsum(torch.stack([fy_part, f_new, gdy])))


def _theta_next(theta, L_ratio):
    """TFOCS θ update; with backtracking the ratio L⁺/L rescales the
    accumulated momentum."""
    return 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 * L_ratio / (theta * theta)))


def _info(x, hist, k, converged, n_backtracks, n_restarts, plan, a_passes):
    return x, {"iterations": k, "a_passes": a_passes,
               "converged": converged, "plan": plan,
               "history": hist, "n_backtracks": n_backtracks,
               "n_restarts": n_restarts, "fused": plan != "cached",
               "objective": hist[max(k - 1, 0)]}


def _tfocs_fused(smooth, linop, prox, x0, opts: TfocsOptions, sep,
                 residual=None):
    """Non-accelerated engine over the fused single-pass gradient: with
    θ ≡ 1, `linop.fused_grad(x⁺)` gives f(Ax⁺) for the backtracking test
    (⟨∇f(Ay), Ax⁺ − Ay⟩ collapses to the x-space ⟨g, x⁺ − x⟩) and the
    next gradient.  Exactly ONE A-pass per attempt, plus one to seed.

    `residual` (the "psum8" precision) threads the compressed wire's
    error-feedback state through the loop: every pass ships an int8
    gradient and returns the new residual, and a rejected attempt starts
    again from the step's residual, so no quantization error counts
    twice."""
    backtracking = opts.backtracking and opts.Lexact is None
    L = _scalar(opts.Lexact if opts.Lexact is not None else opts.L0, x0)
    hist = torch.full((opts.max_iters,), torch.nan, device=x0.device)

    def fg(x, res):
        """One fused A-pass; compressed wire iff a residual rides."""
        if res is None:
            f, g, _ = linop.fused_grad(x, sep)
            return f, g, None
        f, g, _, res = linop.fused_grad(x, sep, residual=res)
        return f, g, res

    x = x0
    f, g, res = fg(x, residual)                        # ← ONE A-pass to seed
    k = n_backtracks = 0
    done = False
    while not done and k < opts.max_iters:
        L_try = L * (opts.beta if backtracking else 1.0)
        tries = 0
        while True:
            step = 1.0 / L_try
            x_new = prox.prox(x - step * g, step)
            f_new, g_new, res_new = fg(x_new, res)           # ← ONE A-pass
            tries += 1
            dx = x_new - x
            rhs = f + torch.dot(g, dx) + 0.5 * L_try * torch.dot(dx, dx)
            ok = bool(f_new <= rhs + 1e-12 * torch.abs(f))
            if ok or not backtracking or tries >= opts.max_backtracks:
                break
            L_try = L_try * opts.alpha
        hist[k] = f_new + prox.value(x_new)
        done = bool(_rel_step(x_new, x) < opts.tol)
        x, f, g, L, res = x_new, f_new, g_new, L_try, res_new
        k += 1
        n_backtracks += tries - 1
    return _info(x, hist, k, done, n_backtracks, 0, "fused",
                 1 + k + n_backtracks)


def _tfocs_fused_accel(smooth, linop, prox, x0, opts: TfocsOptions, sep):
    """Accelerated engine over the fused single-pass gradient, quadratic
    smooths only: Aᵀ∇f(A v) = u_v − u_b with u_v = Aᵀ(w∘A v), so the
    momentum point's gradient combines from carried u-vectors and one
    `fused_grad(z⁺)` per attempt refreshes the rest.  a_passes = 2 (seed:
    u_b, then x0) + iterations + extra backtracks."""
    dsum = _data_sum(linop)
    backtracking = opts.backtracking and opts.Lexact is None
    L = _scalar(opts.Lexact if opts.Lexact is not None else opts.L0, x0)
    hist = torch.full((opts.max_iters,), torch.nan, device=x0.device)
    _, g_zero, _ = linop.fused_grad(torch.zeros_like(x0), sep)
    ub = -g_zero
    _, gx0, Ax0 = linop.fused_grad(x0, sep)
    ux0 = gx0 + ub
    x, Ax, ux, z, Az, uz = x0, Ax0, ux0, x0, Ax0, ux0
    theta = _scalar(1.0, x0)
    k = n_backtracks = n_restarts = 0
    done = False
    while not done and k < opts.max_iters:
        L_try = L * (opts.beta if backtracking else 1.0)
        tries = 0
        while True:
            th = _theta_next(theta, L_try / L)
            Ay = (1 - th) * Ax + th * Az
            fy_part = smooth.value(Ay)
            gy = smooth.grad(Ay)                          # data space, no pass
            g = (1 - th) * ux + th * uz - ub              # affine!
            step = 1.0 / (L_try * th)
            z_new = prox.prox(z - step * g, step)
            _, gz, Az_new = linop.fused_grad(z_new, sep)  # ← the ONE A-pass
            tries += 1
            uz_new = gz + ub
            x_new = (1 - th) * x + th * z_new
            Ax_new = (1 - th) * Ax + th * Az_new
            ux_new = (1 - th) * ux + th * uz_new
            dx = th * (z_new - z)                         # = x_new − y
            fy, f_new, gdy = _data_terms(dsum, smooth, fy_part, gy, Ay,
                                         Ax_new)
            rhs = fy + gdy + 0.5 * L_try * torch.dot(dx, dx)
            ok = bool(f_new <= rhs + 1e-12 * torch.abs(fy))
            if ok or not backtracking or tries >= opts.max_backtracks:
                break
            L_try = L_try * opts.alpha
        if opts.restart and bool(dsum(torch.dot(gy, Ax_new - Ax)) > 0):
            # Momentum points uphill: reset it (u_z follows z).
            th, z_new, Az_new, uz_new = _scalar(1.0, x0), x_new, Ax_new, ux_new
            n_restarts += 1
        hist[k] = f_new + prox.value(x_new)
        done = bool(_rel_step(x_new, x) < opts.tol)
        x, Ax, ux, z, Az, uz = x_new, Ax_new, ux_new, z_new, Az_new, uz_new
        theta, L = th, L_try
        k += 1
        n_backtracks += tries - 1
    return _info(x, hist, k, done, n_backtracks, n_restarts, "fused_affine",
                 2 + k + n_backtracks)


def _tfocs_cached(smooth, linop, prox, x0, opts: TfocsOptions):
    """The cached engine: one adjoint and one apply per attempt, images of
    x̄ and z carried so A y = (1−θ)A x̄ + θ A z costs no pass."""
    dsum = _data_sum(linop)
    backtracking = opts.backtracking and opts.Lexact is None
    L = _scalar(opts.Lexact if opts.Lexact is not None else opts.L0, x0)
    hist = torch.full((opts.max_iters,), torch.nan, device=x0.device)
    one = _scalar(1.0, x0)
    Ax0 = linop.apply(x0)
    x, Ax, z, Az = x0, Ax0, x0, Ax0
    theta = one
    k = n_backtracks = n_restarts = 0
    done = False
    while not done and k < opts.max_iters:
        L_try = L * (opts.beta if backtracking else 1.0)
        tries = 0
        while True:
            th = _theta_next(theta, L_try / L) if opts.accel else one
            y = (1 - th) * x + th * z
            Ay = (1 - th) * Ax + th * Az
            fy_part = smooth.value(Ay)
            gy = smooth.grad(Ay)
            g = linop.adjoint(gy)                       # ← ONE adjoint
            step = 1.0 / (L_try * th)
            z_new = prox.prox(z - step * g, step)
            Az_new = linop.apply(z_new)                 # ← ONE apply
            tries += 1
            x_new = (1 - th) * x + th * z_new
            Ax_new = (1 - th) * Ax + th * Az_new
            dx = x_new - y
            fy, f_new, gdy = _data_terms(dsum, smooth, fy_part, gy, Ay,
                                         Ax_new)
            rhs = fy + gdy + 0.5 * L_try * torch.dot(dx, dx)
            ok = bool(f_new <= rhs + 1e-12 * torch.abs(fy))
            if ok or not backtracking or tries >= opts.max_backtracks:
                break
            L_try = L_try * opts.alpha
        if opts.restart and opts.accel and bool(
                dsum(torch.dot(gy, Ax_new - Ax)) > 0):
            th, z_new, Az_new = one, x_new, Ax_new
            n_restarts += 1
        hist[k] = f_new + prox.value(x_new)
        done = bool(_rel_step(x_new, x) < opts.tol)
        x, Ax, z, Az = x_new, Ax_new, z_new, Az_new
        theta, L = th, L_try
        k += 1
        n_backtracks += tries - 1
    return _info(x, hist, k, done, n_backtracks, n_restarts, "cached",
                 1 + 2 * (k + n_backtracks))


def tfocs(smooth, linop, prox, x0: torch.Tensor,
          opts: TfocsOptions = TfocsOptions()):
    """Run the solver; returns (x*, info) with the standard keys
    (iterations, a_passes, converged, plan), the per-iteration history and
    info["precision"].  A bf16 run works on a bf16 copy of the operand
    (``astype_store``); the caller's matrix stays as it is."""
    prec = resolve_precision(linop, opts)
    if prec == "bf16":
        linop, prec, _ = store_precision(linop, prec, wire=False)
    sep = row_separable(smooth)
    theta_one = fused_gradient_enabled(smooth, linop, opts.fused,
                                       needs_theta_one=True,
                                       accel=opts.accel)
    # psum8 rides the θ ≡ 1 fused engine's wire alone (the reference's
    # rule); every other engine reports f32.
    linop, prec, residual = store_precision(linop, prec, wire=theta_one)
    if theta_one:
        x, info = _tfocs_fused(smooth, linop, prox, x0, opts, sep,
                               residual=residual)
    elif (opts.accel and sep is not None and sep.kind == "quad"
            and _fused_capable(linop)
            and fused_gradient_enabled(smooth, linop, opts.fused)):
        x, info = _tfocs_fused_accel(smooth, linop, prox, x0, opts, sep)
    else:
        x, info = _tfocs_cached(smooth, linop, prox, x0, opts)
    info["precision"] = prec
    return x, info
