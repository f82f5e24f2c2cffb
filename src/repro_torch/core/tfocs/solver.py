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
(launch/planner.plan("grad", ...)), as in the reference.  "bf16" runs the
operand's bf16 copy (``linop.astype_store``); "psum8" (the compressed
all-reduce) falls back to f32 on a local operand, as the reference does,
and raises on a RowMatrix or SparseRowMatrix until ROADMAP queue 1 item 13
(multi-GPU) brings the wire it compresses.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .smooth import row_separable

_PRECISIONS = ("auto", "f32", "bf16", "psum8")
_MULTI_GPU_ITEM = "ROADMAP queue 1 item 13 (multi-GPU)"


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
        m, n = int(linop.out_shape[0]), int(linop.in_shape[0])
        dtype = linop.operand_dtype() if hasattr(linop, "operand_dtype") \
            else torch.float32
    except (AttributeError, TypeError):
        return True
    from repro_torch.launch import planner as _planner
    return _planner.plan("grad", {"m": max(m, 1), "n": n}, dtype,
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
        m, n = int(linop.out_shape[0]), int(linop.in_shape[0])
    except (AttributeError, TypeError):
        return "f32"
    from repro_torch.launch import planner as _planner
    p = _planner.plan("grad", {"m": max(m, 1), "n": n}, "float32",
                      backend=_backend(linop),
                      context={"tol": float(opts.tol)})
    return p.precision or "f32"


def store_precision(linop, prec: str, *, wire: bool):
    """(operand, precision) to run `prec` with: "bf16" recasts the
    operand's storage (f32 where it has none); "psum8" falls back to f32
    on a local operand and raises on a RowMatrix or SparseRowMatrix, whose
    compressed all-reduce waits for multi-GPU (`wire` False: an engine
    that never takes the compressed wire reports f32)."""
    if prec == "bf16":
        try:
            return linop.astype_store(torch.bfloat16), "bf16"
        except AttributeError:
            return linop, "f32"
    if prec == "psum8":
        from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
        if wire and isinstance(getattr(linop, "A", None),
                               (RowMatrix, SparseRowMatrix)):
            raise NotImplementedError(
                "precision='psum8' compresses the all-reduce of a "
                f"multi-device matrix; waits for {_MULTI_GPU_ITEM}")
        return linop, "f32"
    return linop, prec


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _rel_step(x_new: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.vector_norm(x_new - x)
            / torch.clamp(torch.linalg.vector_norm(x_new), min=1.0))


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


def _tfocs_fused(smooth, linop, prox, x0, opts: TfocsOptions, sep):
    """Non-accelerated engine over the fused single-pass gradient: with
    θ ≡ 1, `linop.fused_grad(x⁺)` gives f(Ax⁺) for the backtracking test
    (⟨∇f(Ay), Ax⁺ − Ay⟩ collapses to the x-space ⟨g, x⁺ − x⟩) and the
    next gradient.  Exactly ONE A-pass per attempt, plus one to seed."""
    backtracking = opts.backtracking and opts.Lexact is None
    L = _scalar(opts.Lexact if opts.Lexact is not None else opts.L0, x0)
    hist = torch.full((opts.max_iters,), torch.nan, device=x0.device)
    x = x0
    f, g, _ = linop.fused_grad(x, sep)                 # ← ONE A-pass to seed
    k = n_backtracks = 0
    done = False
    while not done and k < opts.max_iters:
        L_try = L * (opts.beta if backtracking else 1.0)
        tries = 0
        while True:
            step = 1.0 / L_try
            x_new = prox.prox(x - step * g, step)
            f_new, g_new, _ = linop.fused_grad(x_new, sep)   # ← ONE A-pass
            tries += 1
            dx = x_new - x
            rhs = f + torch.dot(g, dx) + 0.5 * L_try * torch.dot(dx, dx)
            ok = bool(f_new <= rhs + 1e-12 * torch.abs(f))
            if ok or not backtracking or tries >= opts.max_backtracks:
                break
            L_try = L_try * opts.alpha
        hist[k] = f_new + prox.value(x_new)
        done = bool(_rel_step(x_new, x) < opts.tol)
        x, f, g, L = x_new, f_new, g_new, L_try
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
            fy = smooth.value(Ay)
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
            f_new = smooth.value(Ax_new)
            dx = th * (z_new - z)                         # = x_new − y
            rhs = fy + torch.dot(gy, Ax_new - Ay) + 0.5 * L_try * torch.dot(dx, dx)
            ok = bool(f_new <= rhs + 1e-12 * torch.abs(fy))
            if ok or not backtracking or tries >= opts.max_backtracks:
                break
            L_try = L_try * opts.alpha
        if opts.restart and bool(torch.dot(gy, Ax_new - Ax) > 0):
            # Momentum points uphill: reset it (u_z follows z).
            th, z_new, Az_new, uz_new = _scalar(1.0, x0), x_new, Ax_new, ux_new
            n_restarts += 1
        hist[k] = smooth.value(Ax_new) + prox.value(x_new)
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
            fy = smooth.value(Ay)
            gy = smooth.grad(Ay)
            g = linop.adjoint(gy)                       # ← ONE adjoint
            step = 1.0 / (L_try * th)
            z_new = prox.prox(z - step * g, step)
            Az_new = linop.apply(z_new)                 # ← ONE apply
            tries += 1
            x_new = (1 - th) * x + th * z_new
            Ax_new = (1 - th) * Ax + th * Az_new
            f_new = smooth.value(Ax_new)
            dx = x_new - y
            rhs = fy + torch.dot(gy, Ax_new - Ay) + 0.5 * L_try * torch.dot(dx, dx)
            ok = bool(f_new <= rhs + 1e-12 * torch.abs(fy))
            if ok or not backtracking or tries >= opts.max_backtracks:
                break
            L_try = L_try * opts.alpha
        if opts.restart and opts.accel and bool(torch.dot(gy, Ax_new - Ax) > 0):
            th, z_new, Az_new = one, x_new, Ax_new
            n_restarts += 1
        hist[k] = smooth.value(Ax_new) + prox.value(x_new)
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
        linop, prec = store_precision(linop, prec, wire=False)
    sep = row_separable(smooth)
    theta_one = fused_gradient_enabled(smooth, linop, opts.fused,
                                       needs_theta_one=True,
                                       accel=opts.accel)
    # psum8 rides the θ ≡ 1 fused engine's wire alone (the reference's
    # rule); every other engine reports f32.
    linop, prec = store_precision(linop, prec, wire=theta_one)
    if theta_one:
        x, info = _tfocs_fused(smooth, linop, prox, x0, opts, sep)
    elif (opts.accel and sep is not None and sep.kind == "quad"
            and _fused_capable(linop)
            and fused_gradient_enabled(smooth, linop, opts.fused)):
        x, info = _tfocs_fused_accel(smooth, linop, prox, x0, opts, sep)
    else:
        x, info = _tfocs_cached(smooth, linop, prox, x0, opts)
    info["precision"] = prec
    return x, info
