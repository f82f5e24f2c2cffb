"""Request-batched solver engines for the serving frontend (launch/serve).

Counterpart of src/repro/core/optim/batched.py.  When k requests share one
design matrix A, their iterations share its passes: the fused_grad_multi
kernel evaluates f(Ax), Aᵀ∇f(Ax) and Ax for a whole GROUP of right-hand
sides in ONE streaming read of A, so a group of k requests costs as many
A-passes per iteration as one request.

Three engines, each over a fixed number of SLOTS with per-slot convergence
masks (the server admits and retires requests between iterations by
editing slot rows; the step functions freeze inactive slots bit for bit):

  * ``gra``   — proximal gradient with per-slot backtracking Lipschitz
    estimation; every backtracking attempt is one group A-pass, and slots
    whose step already passed recompute the same accepted candidate;
  * ``acc``   — the accelerated engine for quadratic smooths, via the affine
    u-vector trick: each slot carries (u_x, u_z, u_b) beside its cached
    images, so the momentum point's gradient costs no pass.  Per-slot θ/L,
    shared backtracking attempts and per-slot gradient-test restarts give
    the ``acc`` and ``acc_rb`` variants;
  * ``lbfgs`` — L-BFGS with the two-loop recursion batched over slots and a
    shared Armijo line search (each probe is one group A-pass).

Each `step` returns (state, passes) with `passes` the group A-passes it
took, counted at run time (the reference's `lax.while_loop`s are Python
loops here, so each backtracking test is one host sync).  Only the fused
(row-separable) path exists: groups exist to share A-passes.  Per-slot
reductions accumulate in float64 (`_rowsum`), so a request takes the same
steps alone as in a group except at a float32 rounding tie: the
backtracking and Armijo tests compare float32 values whose difference near
the optimum is below their rounding, and a float32 reduction order that
followed the slot count would let a group and a lone solve stop at
different points.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distmat.types import resolve_device
from repro_torch.core.tfocs.smooth import RowSeparable

REGS = ("none", "l1", "l2")
_F32 = torch.float32


def prox_batch(reg: str, X: torch.Tensor, step: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """Per-slot prox over stacked iterates: X (S × n), step/lam (S,).
    Matches ProxZero / ProxL1 / ProxL2Sq row by row."""
    if reg == "none":
        return X
    tl = (step * lam)[:, None]
    if reg == "l1":
        return torch.sign(X) * torch.clamp(torch.abs(X) - tl, min=0.0)
    if reg == "l2":
        return X / (1.0 + tl)
    raise ValueError(f"reg must be one of {REGS}, got {reg!r}")


def prox_value_batch(reg: str, X: torch.Tensor,
                     lam: torch.Tensor) -> torch.Tensor:
    """Per-slot h(x): (S,) regularizer values for the stacked iterates."""
    if reg == "none":
        return torch.zeros(X.shape[0], dtype=_F32, device=X.device)
    if reg == "l1":
        return lam * _rowsum(torch.abs(X))
    if reg == "l2":
        return 0.5 * lam * _rowsum(X * X)
    raise ValueError(f"reg must be one of {REGS}, got {reg!r}")


def _group_vag(linop, kind: str, param: float, X, T, W):
    """(F, G) for the whole group in ONE A-pass; inactive slots have zero
    weights, so their value and gradient are exactly 0."""
    f, g, _ = linop.fused_grad_multi(X, RowSeparable(kind, T, W, param))
    return f, g


def _rowsum64(X: torch.Tensor) -> torch.Tensor:
    """Per-slot sums of a (S × d) tensor in float64 (``_rowsum`` before
    its rounding): a row shard's partial, summed over the shards before
    it is rounded."""
    return X.double().sum(dim=1)


def _rowsum(X: torch.Tensor) -> torch.Tensor:
    """Per-slot sums of a (S × d) tensor, accumulated in float64 and
    rounded to float32.  A reduction's order may follow the tensor's shape
    (the number of slots); in float32 that changes the rounding of most
    sums, in float64 it changes the float32 result only where the sum lies
    at a float32 rounding tie.  So a slot's trajectory is the same alone or
    in a group, bit for bit, except at such ties (fused_grad_multi's
    per-slot sums do not depend on the slot count at all)."""
    return _rowsum64(X).float()


def _norm_rows(X: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_rowsum(X * X))


def _rel_steps(Xn: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return _norm_rows(Xn - X) / torch.clamp(_norm_rows(Xn), min=1.0)


# -- batched proximal gradient (gra) ------------------------------------------

class GraGroupState(NamedTuple):
    X: torch.Tensor        # (S, n) per-slot iterates
    F: torch.Tensor        # (S,)  smooth value at X (carried)
    G: torch.Tensor        # (S, n) x-space gradient at X (carried)
    L: torch.Tensor        # (S,)  per-slot Lipschitz estimates
    k: torch.Tensor        # (S,)  per-slot completed iterations
    done: torch.Tensor     # (S,)  per-slot convergence flag
    obj: torch.Tensor      # (S,)  last composite objective f + h
    bt: torch.Tensor       # (S,)  per-slot cumulative backtracks


def _full_l0(slots: int, L0, device) -> torch.Tensor:
    """(slots,) f32 filled with L0: a float, or one value a slot, as the
    reference's ``jnp.full((slots,), L0)`` broadcasts it."""
    return torch.empty(slots, dtype=_F32, device=device).copy_(
        torch.as_tensor(L0, dtype=_F32))


def gra_group_init(slots: int, n: int, L0: float = 1.0, *,
                   device="cuda") -> GraGroupState:
    kw = dict(device=resolve_device(device))
    return GraGroupState(
        X=torch.zeros((slots, n), dtype=_F32, **kw),
        F=torch.zeros(slots, dtype=_F32, **kw),
        G=torch.zeros((slots, n), dtype=_F32, **kw),
        L=_full_l0(slots, L0, kw["device"]),
        k=torch.zeros(slots, dtype=torch.int32, **kw),
        done=torch.zeros(slots, dtype=torch.bool, **kw),
        obj=torch.full((slots,), torch.nan, dtype=_F32, **kw),
        bt=torch.zeros(slots, dtype=torch.int32, **kw))


def make_gra_group(linop, kind: str, param: float = 1.0, *,
                   reg: str = "none", alpha: float = 2.0, beta: float = 0.9,
                   max_backtracks: int = 30, backtracking: bool = True,
                   tol_eps: float = 1e-12):
    """Build (seed_fn, step_fn) for a batched proximal-gradient group.

    seed_fn(state, T, W, lam)                → (state, passes)
        recompute F/G (and obj) for every slot in ONE group A-pass; called
        after the server edits slot rows.
    step_fn(state, T, W, lam, tol, active)   → (state, passes)
        one outer iteration for all active slots; `passes` is the number
        of group A-passes taken (1 + extra backtracking attempts).
    Inactive slots are frozen bit for bit."""
    if reg not in REGS:
        raise ValueError(f"reg must be one of {REGS}, got {reg!r}")

    def seed(state: GraGroupState, T, W, lam):
        F, G = _group_vag(linop, kind, param, state.X, T, W)
        obj = F + prox_value_batch(reg, state.X, lam)
        return state._replace(F=F, G=G, obj=obj), 1

    def step(state: GraGroupState, T, W, lam, tol, active):
        act = active & ~state.done
        L = torch.where(act, state.L * (beta if backtracking else 1.0),
                        state.L)

        def attempt(L):
            stepsz = torch.where(act, 1.0 / L, 1.0)
            Xn = prox_batch(reg, state.X - stepsz[:, None] * state.G,
                            stepsz, lam)
            Xn = torch.where(act[:, None], Xn, state.X)
            Fn, Gn = _group_vag(linop, kind, param, Xn, T, W)   # ← ONE pass
            dX = Xn - state.X
            rhs = (state.F + _rowsum(state.G * dX)
                   + 0.5 * L * _rowsum(dX * dX))
            ok = Fn <= rhs + tol_eps * torch.abs(state.F)
            return Xn, Fn, Gn, ok

        Xn, Fn, Gn, ok = attempt(L)
        tries, bt = 1, torch.zeros_like(state.bt)
        # Passed slots recompute the same accepted candidate (same L, same
        # carried state, so the same bits): one shared attempt is still ONE
        # group A-pass for everybody.
        while backtracking and tries < max_backtracks \
                and bool(torch.any(act & ~ok)):
            fail = act & ~ok
            L = torch.where(fail, L * alpha, L)
            bt = bt + fail.to(torch.int32)
            Xn, Fn, Gn, ok = attempt(L)
            tries += 1

        conv = act & (_rel_steps(Xn, state.X) < tol)
        obj = Fn + prox_value_batch(reg, Xn, lam)
        sel = act[:, None]
        return GraGroupState(
            X=torch.where(sel, Xn, state.X),
            F=torch.where(act, Fn, state.F),
            G=torch.where(sel, Gn, state.G),
            L=torch.where(act, L, state.L),
            k=state.k + act.to(torch.int32),
            done=state.done | conv,
            obj=torch.where(act, obj, state.obj),
            bt=state.bt + bt), tries

    return seed, step


# -- batched accelerated proximal gradient (acc / acc_rb) ---------------------

class AccGroupState(NamedTuple):
    X: torch.Tensor        # (S, n) per-slot averaged iterates x̄
    AX: torch.Tensor       # (S, m_pad) cached images A·x̄
    UX: torch.Tensor       # (S, n) u_x = Aᵀ(w∘A·x̄)
    Z: torch.Tensor        # (S, n) proximal-gradient iterates
    AZ: torch.Tensor       # (S, m_pad)
    UZ: torch.Tensor       # (S, n)
    UB: torch.Tensor       # (S, n) per-slot u_b = Aᵀ(w∘t)
    F: torch.Tensor        # (S,)  smooth value at X (from AX)
    theta: torch.Tensor    # (S,)  per-slot momentum parameters
    L: torch.Tensor        # (S,)  per-slot Lipschitz estimates
    k: torch.Tensor        # (S,)
    done: torch.Tensor     # (S,)
    obj: torch.Tensor      # (S,)
    bt: torch.Tensor       # (S,)  cumulative backtracks
    rs: torch.Tensor       # (S,)  cumulative gradient-test restarts


def acc_group_init(slots: int, n: int, m_pad: int, L0: float = 1.0, *,
                   device="cuda") -> AccGroupState:
    device = resolve_device(device)
    kw = dict(dtype=_F32, device=device)
    zn = lambda: torch.zeros((slots, n), **kw)        # noqa: E731
    zm = lambda: torch.zeros((slots, m_pad), **kw)    # noqa: E731
    return AccGroupState(
        X=zn(), AX=zm(), UX=zn(), Z=zn(), AZ=zm(), UZ=zn(), UB=zn(),
        F=torch.zeros(slots, **kw), theta=torch.ones(slots, **kw),
        L=_full_l0(slots, L0, device),
        k=torch.zeros(slots, dtype=torch.int32, device=device),
        done=torch.zeros(slots, dtype=torch.bool, device=device),
        obj=torch.full((slots,), torch.nan, **kw),
        bt=torch.zeros(slots, dtype=torch.int32, device=device),
        rs=torch.zeros(slots, dtype=torch.int32, device=device))


def make_acc_group(linop, kind: str, param: float = 1.0, *,
                   reg: str = "none", backtracking: bool = False,
                   restart: bool = False, alpha: float = 2.0,
                   beta: float = 0.9, max_backtracks: int = 30,
                   tol_eps: float = 1e-12):
    """Build (seed_fn, step_fn) for a batched ACCELERATED group, quadratic
    smooths only.  With f(z) = ½ Σ wᵢ(zᵢ − tᵢ)² the x-space gradient at v
    is u_v − u_b with u_v = Aᵀ(w∘Av) affine in u, so the momentum point's
    gradient (1−θ)u_x + θu_z − u_b costs nothing and one group pass per
    attempt (at z⁺) is the whole iteration.

    seed_fn(state, T, W, lam) → (state, 3) refreshes u_b, (AX, u_x) and
    (AZ, u_z) in three group passes (at 0, X̄ and Z); step_fn(state, T, W,
    lam, tol, active) → (state, passes) runs one iteration for all active
    slots.  Inactive slots freeze bit for bit.

    On a row-sharded matrix the cached images (AX, AZ), T and W are this
    rank's strips, and the attempt's per-slot sums over them (f at the
    momentum point and at x⁺, the backtracking test's GY·(AXn − AY) and
    the restart test's GY·(AXn − AX)) are summed in float64 on each strip
    and all_reduced together, one ``linop.data_sum`` an attempt, before
    they are rounded."""
    if reg not in REGS:
        raise ValueError(f"reg must be one of {REGS}, got {reg!r}")
    if kind != "quad":
        raise ValueError("accelerated groups need the affine u-vector "
                         f"trick — quadratic smooths only, got {kind!r}")
    sharded = linop.row_shards() > 1

    def _pass(X, T, W):
        return linop.fused_grad_multi(X, RowSeparable(kind, T, W, param))

    def _quad_fg(AY, T, W):
        """Per-slot (value's float64 partial, data-space gradient) at
        cached images — local, no A-pass; matches SmoothQuad row by
        row."""
        R = AY - T
        return 0.5 * _rowsum64(W * R * R), W * R

    def _data_sums(*parts):
        """The per-slot float64 partials summed over the row shards in one
        all_reduce (as they are on one shard), rounded to float32."""
        sums = torch.stack(parts)
        if sharded:
            sums = linop.data_sum(sums)
        return sums.float()

    def seed(state: AccGroupState, T, W, lam):
        _, G0, _ = _pass(torch.zeros_like(state.X), T, W)   # g(0) = −u_b
        UB = -G0
        Fx, GX, AX = _pass(state.X, T, W)
        _, GZ, AZ = _pass(state.Z, T, W)
        obj = Fx + prox_value_batch(reg, state.X, lam)
        return state._replace(AX=AX, UX=GX + UB, AZ=AZ, UZ=GZ + UB,
                              UB=UB, F=Fx, obj=obj), 3

    def step(state: AccGroupState, T, W, lam, tol, active):
        act = active & ~state.done
        L = torch.where(act, state.L * (beta if backtracking else 1.0),
                        state.L)

        def attempt(L):
            # TFOCS θ update, per slot; the ratio L⁺/L rescales momentum.
            th = 2.0 / (1.0 + torch.sqrt(
                1.0 + 4.0 * (L / state.L) / (state.theta * state.theta)))
            thc = th[:, None]
            AY = (1 - thc) * state.AX + thc * state.AZ
            FY, GY = _quad_fg(AY, T, W)
            G = (1 - thc) * state.UX + thc * state.UZ - state.UB  # affine!
            stepsz = torch.where(act, 1.0 / (L * th), 1.0)
            Zn = prox_batch(reg, state.Z - stepsz[:, None] * G, stepsz, lam)
            Zn = torch.where(act[:, None], Zn, state.Z)
            _, GZ, AZn = _pass(Zn, T, W)                 # ← the ONE pass
            UZn = GZ + state.UB
            Xn = (1 - thc) * state.X + thc * Zn
            AXn = (1 - thc) * state.AX + thc * AZn
            UXn = (1 - thc) * state.UX + thc * UZn
            parts = [FY, 0.5 * _rowsum64(W * (AXn - T) ** 2),
                     _rowsum64(GY * (AXn - AY))]
            if restart:
                parts.append(_rowsum64(GY * (AXn - state.AX)))
            sums = _data_sums(*parts)
            FY, Fn, cross = sums[0], sums[1], sums[2]
            rise = sums[3] if restart else None
            dX = thc * (Zn - state.Z)                    # = x⁺ − y
            rhs = FY + cross + 0.5 * L * _rowsum(dX * dX)
            ok = Fn <= rhs + tol_eps * torch.abs(FY)
            return th, Xn, AXn, UXn, Zn, AZn, UZn, rise, Fn, ok

        out = attempt(L)
        tries, bt = 1, torch.zeros_like(state.bt)
        # Passed slots recompute the same accepted candidate (same per-slot
        # L, so the same θ and the same bits): one shared attempt is still
        # ONE group A-pass for everybody.
        while backtracking and tries < max_backtracks \
                and bool(torch.any(act & ~out[-1])):
            fail = act & ~out[-1]
            L = torch.where(fail, L * alpha, L)
            bt = bt + fail.to(torch.int32)
            out = attempt(L)
            tries += 1
        th, Xn, AXn, UXn, Zn, AZn, UZn, rise, Fn, _ = out

        if restart:
            # Per-slot O'Donoghue–Candès gradient test (GY·(AXn − AX),
            # summed with the attempt's other sums); resetting momentum
            # also resets (z, Az, u_z) to the averaged iterate's.
            uphill = act & (rise > 0)
            th = torch.where(uphill, 1.0, th)
            up = uphill[:, None]
            Zn = torch.where(up, Xn, Zn)
            AZn = torch.where(up, AXn, AZn)
            UZn = torch.where(up, UXn, UZn)
            rs = uphill.to(torch.int32)
        else:
            rs = torch.zeros_like(state.rs)

        conv = act & (_rel_steps(Xn, state.X) < tol)
        obj = Fn + prox_value_batch(reg, Xn, lam)
        sel = act[:, None]
        return AccGroupState(
            X=torch.where(sel, Xn, state.X),
            AX=torch.where(sel, AXn, state.AX),
            UX=torch.where(sel, UXn, state.UX),
            Z=torch.where(sel, Zn, state.Z),
            AZ=torch.where(sel, AZn, state.AZ),
            UZ=torch.where(sel, UZn, state.UZ),
            UB=state.UB,
            F=torch.where(act, Fn, state.F),
            theta=torch.where(act, th, state.theta),
            L=torch.where(act, L, state.L),
            k=state.k + act.to(torch.int32),
            done=state.done | conv,
            obj=torch.where(act, obj, state.obj),
            bt=state.bt + bt,
            rs=state.rs + rs), tries

    return seed, step


# -- batched L-BFGS -----------------------------------------------------------

class LbfgsGroupState(NamedTuple):
    X: torch.Tensor        # (S, n)
    F: torch.Tensor        # (S,)
    G: torch.Tensor        # (S, n)
    S_: torch.Tensor       # (S, mem, n) s-history
    Y: torch.Tensor        # (S, mem, n) y-history
    rho: torch.Tensor      # (S, mem)
    idx: torch.Tensor      # (S,) circular write pointers
    filled: torch.Tensor   # (S,) valid history pairs
    k: torch.Tensor        # (S,)
    done: torch.Tensor     # (S,)
    obj: torch.Tensor      # (S,)


def lbfgs_group_init(slots: int, n: int, mem: int = 10, *,
                     device="cuda") -> LbfgsGroupState:
    device = resolve_device(device)
    kw = dict(dtype=_F32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return LbfgsGroupState(
        X=torch.zeros((slots, n), **kw), F=torch.zeros(slots, **kw),
        G=torch.zeros((slots, n), **kw),
        S_=torch.zeros((slots, mem, n), **kw),
        Y=torch.zeros((slots, mem, n), **kw),
        rho=torch.zeros((slots, mem), **kw),
        idx=torch.zeros(slots, **i32), filled=torch.zeros(slots, **i32),
        k=torch.zeros(slots, **i32),
        done=torch.zeros(slots, dtype=torch.bool, device=device),
        obj=torch.full((slots,), torch.nan, **kw))


def two_loop_batch(G, S, Y, rho, idx, filled) -> torch.Tensor:
    """H·g per slot via the two-loop recursion over each slot's circular,
    masked history: G (S × n), S/Y (S × mem × n), rho (S × mem), idx and
    filled (S,).  Row by row the same arithmetic as lbfgs._two_loop, with
    invalid history entries masked to zero as the reference's vmapped
    fori_loop does."""
    slots, mem = rho.shape
    rows = torch.arange(slots, device=G.device)
    q = G
    alphas = torch.zeros_like(rho)
    for i in range(mem):
        slot = (idx - 1 - i) % mem
        valid = (i < filled).to(G.dtype)
        a = valid * rho[rows, slot] * _rowsum(S[rows, slot] * q)
        q = q - a[:, None] * Y[rows, slot]
        alphas[rows, slot] = a
    newest = (idx - 1) % mem
    sy = _rowsum(S[rows, newest] * Y[rows, newest])
    yy = _rowsum(Y[rows, newest] * Y[rows, newest])
    gamma = torch.where((filled > 0) & (yy > 0),
                        sy / torch.clamp(yy, min=1e-30), 1.0)
    r = gamma[:, None] * q
    for i in range(mem):
        slot = (idx - filled + i) % mem
        valid = (i < filled).to(G.dtype)
        b = valid * rho[rows, slot] * _rowsum(Y[rows, slot] * r)
        r = r + (alphas[rows, slot] - b)[:, None] * S[rows, slot]
    return r


def make_lbfgs_group(linop, kind: str, param: float = 1.0, *,
                     c1: float = 1e-4, max_ls: int = 25,
                     init_step: float = 1.0):
    """Build (seed_fn, step_fn) for a batched L-BFGS group: the two-loop
    recursion runs over all slots at once and the Armijo line search is
    shared — each probe evaluates the WHOLE group in one A-pass, with
    per-slot step halving.  seed_fn(state, T, W) and step_fn(state, T, W,
    tol, active) → (state, passes); no regularizer (L-BFGS needs a smooth
    objective)."""

    def seed(state: LbfgsGroupState, T, W):
        F, G = _group_vag(linop, kind, param, state.X, T, W)
        return state._replace(F=F, G=G, obj=F), 1

    def step(state: LbfgsGroupState, T, W, tol, active):
        act = active & ~state.done
        mem = state.S_.shape[1]

        d = -two_loop_batch(state.G, state.S_, state.Y, state.rho,
                            state.idx, state.filled)
        gd = _rowsum(state.G * d)
        bad = gd >= 0
        d = torch.where(bad[:, None], -state.G, d)
        gd = torch.where(bad, -_rowsum(state.G * state.G), gd)
        t = torch.where(state.filled > 0, 1.0,
                        init_step / torch.clamp(_norm_rows(state.G),
                                                min=1e-12))

        def probe(t):
            Xp = torch.where(act[:, None], state.X + t[:, None] * d, state.X)
            return _group_vag(linop, kind, param, Xp, T, W)    # ← ONE pass

        Fn, Gn = probe(t)
        tries = 1
        while tries < max_ls:
            fail = act & (Fn > state.F + c1 * t * gd)
            if not bool(torch.any(fail)):
                break
            t = torch.where(fail, 0.5 * t, t)
            Fn, Gn = probe(t)
            tries += 1

        Xn = state.X + t[:, None] * d
        s = Xn - state.X
        y = Gn - state.G
        sy = _rowsum(s * y)
        keep = act & (sy > 1e-10 * _norm_rows(s) * _norm_rows(y))
        # Per-slot circular write: one-hot the write slot, masked by the
        # curvature guard.
        onehot = (torch.arange(mem, device=d.device)[None, :]
                  == state.idx[:, None]) & keep[:, None]       # (S, mem)
        S_ = torch.where(onehot[:, :, None], s[:, None, :], state.S_)
        Y = torch.where(onehot[:, :, None], y[:, None, :], state.Y)
        rho = torch.where(onehot, (1.0 / torch.clamp(sy, min=1e-30))[:, None],
                          state.rho)
        idx = torch.where(keep, (state.idx + 1) % mem, state.idx)
        filled = torch.where(keep, torch.clamp(state.filled + 1, max=mem),
                             state.filled)

        conv = act & (_norm_rows(Gn) < tol * torch.clamp(torch.abs(Fn),
                                                         min=1.0))
        sel = act[:, None]
        return LbfgsGroupState(
            X=torch.where(sel, Xn, state.X),
            F=torch.where(act, Fn, state.F),
            G=torch.where(sel, Gn, state.G),
            S_=S_, Y=Y, rho=rho, idx=idx, filled=filled,
            k=state.k + act.to(torch.int32),
            done=state.done | conv,
            obj=torch.where(act, Fn, state.obj)), tries

    return seed, step
