"""The execution planner: one code path for every "should we?".

Counterpart of src/repro/launch/planner.py.  ``plan()`` prices the
alternatives of one decision against ONE ``MachineModel``
(launch/machine.py: the H100's data-sheet instance, or the backend's
calibrated fit once ``calibrate`` has kept one) and returns an
``ExecutionPlan`` naming the choice, its launch choice, the modeled cost
and an ``explain()`` of why.

    >>> from repro_torch.launch import planner
    >>> p = planner.plan("sparse_matmul",
    ...                  {"m": 4096, "n": 2048, "nx": 1, "ell": 2, "bs": 128})
    >>> p.choice
    'bsr'

Supported ops:

  kernel launch choices    every kernel of kernels/autotune.KERNELS (dims =
                           the kernel's; choice is the kernel, blocks its
                           launch choice: memo, swept cache or ranking, the
                           ops wrappers' ``tune="auto"`` path)
  "sparse_matmul"          {m, n, nx, ell, bs}: BlockELL kernels against the
                           dense gemm of the same product
  "grad"                   {m, n}: the fused single-pass gradient against
                           apply + adjoint (one read of A against two);
                           with context {"axes": ...} the (f, g) psum is
                           priced and a chunked overlap competes
                           (blocks["chunks"])
  "bsr_bs"                 {m, n, nx} + context {"ell_by_bs": {bs: ell}}:
                           the block size, on each candidate's actual ELL
                           width
  "svd"                    {m, n, k} + context {"kind": "row"|"sparse"|
                           "other", thresholds}: gram | randomized | lanczos
  "gram"                   {m, n} + context {"axes": ...}: tsgram and one
                           psum against column-chunked cross-grams
  "matvec"                 {m, n} + context {"axes": ...}: one streaming
                           pass and its reduction (ring | tree | local)

Precision is an axis too: with ``context={"tol": ...}`` and a float32
operand, grad / gram / matvec / sparse_matmul sweep {f32, bf16 storage,
int8 BlockELL, the int8 compressed psum} against PRECISION_GUARDS and a
savings floor (tiny shapes stay f32); ``precision`` names the pick.

Collectives are priced by ``MachineModel.collective`` (ring or tree) for
``context["axes"]``.  A RowMatrix or SparseRowMatrix on a mesh passes its
row axes' sizes (core/distmat/rowmatrix.py ``_collective_plan``), so a
plan that picks ``chunks`` > 1 runs the overlapped schedule, and the
solver's precision sweep (core/tfocs/solver.py ``resolve_precision``) can
pick the int8 compressed psum; on one rank there is no collective and
``chunks="auto"`` is eager without asking.  Decisions are memoized;
``kernels.autotune.reset()`` clears every layer at once.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass, field
from typing import Mapping

from repro_torch.kernels import autotune as at
from repro_torch.kernels import dtypes
from repro_torch.launch import machine as _machine
from repro_torch.launch.machine import CostTerms, MachineModel

KERNEL_OPS = tuple(at.KERNELS)
DECISION_OPS = ("sparse_matmul", "grad", "bsr_bs", "svd", "gram", "matvec")

# Overlap chunk counts the distributed deciders sweep (1 = eager
# compute-then-reduce); segments narrower than one 128-column tsgram tile
# never win.
CHUNK_CANDIDATES = (1, 2, 4, 8)
MIN_SEGMENT = 128
# The storage types whose unfused gradient (apply + adjoint) raises.
FP8 = tuple(_machine.dtype_name(t) for t in dtypes.FP8)

# BSR block-size candidates: the one definition (SparseRowMatrix's
# bs="auto" constructors and plan("bsr_bs") both sweep it; the block-sparse
# kernels take each of them).
BS_CANDIDATES = (8, 16, 32, 64, 128)

# Precision as a planner axis (see the reference for the guard values'
# derivation): a candidate is admissible iff tol >= its guard, and it must
# beat f32 by max(PRECISION_MIN_SAVINGS_FRAC of the f32 time,
# PRECISION_MIN_SAVINGS_S).
PRECISION_OPS = ("grad", "gram", "matvec", "sparse_matmul")
PRECISION_GUARDS = {"f32": 0.0, "psum8": 1e-6, "bf16": 1e-5, "int8": 1e-3}
PRECISION_MIN_SAVINGS_FRAC = 0.20
PRECISION_MIN_SAVINGS_S = 2e-6

# SVD auto-mode gates (paper §3.1; core/linalg/svd.py).
GRAM_THRESHOLD = 8192
RANDOMIZED_K_THRESHOLD = 128


def _us(s: float) -> str:
    return f"{s * 1e6:.2f} us"


@dataclass(frozen=True)
class ExecutionPlan:
    """What to run and why: the planner's answer for one op instance."""
    op: str
    choice: str                       # chosen kernel/path/mode
    blocks: Mapping[str, int]         # launch choice ({} for path decisions)
    cost_s: float                     # modeled seconds of the choice
    dims: Mapping[str, int]
    dtype: str
    backend: str
    machine: str                      # MachineModel.name
    calibrated: bool                  # modeled with calibrated efficiencies?
    breakdown: Mapping[str, float] = field(default_factory=dict)
    alternatives: tuple = ()          # ((label, modeled_s), ...) ascending
    notes: tuple = ()
    terms: Mapping[str, float] = field(default_factory=dict)
    # ^ raw (efficiency-1) terms of the chosen path of a decision op, so
    #   actual_record() can feed calibrate() (kernel ops rebuild theirs).
    precision: str = ""
    # ^ "" when not precision-swept; else "f32" | "bf16" | "int8" | "psum8".

    def explain(self) -> str:
        """Human-readable roofline breakdown of the decision."""
        dims = " ".join(f"{k}={v}" for k, v in self.dims.items())
        lines = [
            f"plan({self.op}) -> {self.choice}"
            + (f" {dict(self.blocks)}" if self.blocks else ""),
            f"  dims: {dims}  dtype={self.dtype}  backend={self.backend}",
            f"  machine: {self.machine}"
            f" ({'calibrated' if self.calibrated else 'builtin constants'})",
            f"  modeled: {_us(self.cost_s)}",
        ]
        if self.precision:
            lines.insert(2, f"  precision: {self.precision}")
        b = self.breakdown
        if b:
            lines.append(
                f"  roofline: compute {_us(b['compute_s'])}"
                f" | memory {_us(b['memory_s'])}"
                f" | steps {_us(b['step_s'])}  -> {b['bound']}-bound")
            comm_s = b.get("comm_s", 0.0)
            if comm_s:
                frac = comm_s / b["total_s"] if b["total_s"] > 0 else 0.0
                lines.append(f"  comm: {_us(comm_s)}"
                             f" ({frac:.0%} of modeled serial time)")
        if self.alternatives:
            selected = {self.choice,
                        json.dumps(dict(self.blocks), sort_keys=True)}
            lines.append("  alternatives:")
            for label, s in self.alternatives:
                marker = "*" if label in selected else " "
                lines.append(f"   {marker} {label}: {_us(s)}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


# Bumped by invalidate_cache(): callers that keep a decision for an
# operand's lifetime (SparseRowMatrix's dispatch) key it with this.
generation = 0


def invalidate_cache() -> None:
    """Forget memoized decisions (recalibration / tests)."""
    global generation
    generation += 1
    _decide_cached.cache_clear()


def plan(op: str, dims: Mapping[str, int], dtype="float32", *,
         backend: str | None = None, machine: MachineModel | None = None,
         context: Mapping | None = None, top: int = 0) -> ExecutionPlan:
    """Price the alternatives for `op` and return the chosen ExecutionPlan.

    `backend` ("cuda" or "cpu") defaults to the card where there is one;
    `machine` overrides the calibrated-model lookup (and bypasses the
    memo).  `top` > 0 attaches the top-N ranked choices of a kernel op as
    alternatives.  `context` carries op-specific inputs (module docstring).
    """
    backend = backend or _machine.default_backend()
    dtype_name = _machine.dtype_name(dtype)
    if op in KERNEL_OPS:
        return _plan_kernel(op, dict(dims), dtype_name, backend,
                            machine, top)
    if op not in DECISION_OPS:
        raise ValueError(f"unknown op {op!r}; expected one of "
                         f"{KERNEL_OPS + DECISION_OPS}")
    dims_key = tuple(sorted((k, int(v)) for k, v in dims.items()))
    ctx_key = _freeze(context or {})
    if machine is not None:
        return _decide(op, dims_key, dtype_name, backend, ctx_key, machine)
    return _decide_cached(op, dims_key, dtype_name, backend, ctx_key)


def _freeze(obj):
    if isinstance(obj, Mapping):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw_ctx(ctx_key) -> dict:
    out = {}
    for k, v in ctx_key:
        out[k] = dict(v) if isinstance(v, tuple) and v \
            and isinstance(v[0], tuple) else v
    return out


# -- kernel launch choices -----------------------------------------------------

def _plan_kernel(op: str, dims: dict, dtype_name: str, backend: str,
                 machine: MachineModel | None, top: int) -> ExecutionPlan:
    explicit = machine is not None
    machine = machine or _machine.for_backend(backend)
    if explicit:
        blocks = at.rank(op, dims, dtype_name, machine=machine)[0][1]
    else:
        # The memo → swept cache → ranking path the ops wrappers dispatch
        # through (kernels/autotune.get_config).
        blocks = at.get_config(op, dims, dtype_name, backend=backend)
    terms = at.cost_terms(op, blocks, dims, dtype_name)
    br = machine.breakdown(terms, dtype_name)
    alts = ()
    if top > 0:
        ranked = at.rank(op, dims, dtype_name, machine=machine)[:top]
        alts = tuple((json.dumps(b, sort_keys=True), s) for s, b in ranked)
    return ExecutionPlan(
        op=op, choice=op, blocks=dict(blocks), cost_s=br["total_s"],
        dims=dims, dtype=dtype_name, backend=backend, machine=machine.name,
        calibrated=machine.source == "calibrated", breakdown=br,
        alternatives=alts)


# -- path decisions ------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _decide_cached(op, dims_key, dtype_name, backend, ctx_key):
    return _decide(op, dims_key, dtype_name, backend, ctx_key,
                   _machine.for_backend(backend))


def _decide(op, dims_key, dtype_name, backend, ctx_key,
            machine: MachineModel) -> ExecutionPlan:
    d = dict(dims_key)
    ctx = _thaw_ctx(ctx_key)
    kw = dict(dims=d, dtype=dtype_name, backend=backend,
              machine=machine.name,
              calibrated=machine.source == "calibrated")
    if op in PRECISION_OPS and "tol" in ctx and dtype_name == "float32":
        return _decide_precision(op, d, dtype_name, machine, ctx, kw)
    if op == "sparse_matmul":
        return _decide_sparse(d, dtype_name, machine, ctx, kw)
    if op == "grad":
        return _decide_grad(d, dtype_name, machine, ctx, kw)
    if op == "bsr_bs":
        return _decide_bsr_bs(d, dtype_name, machine, ctx, kw)
    if op == "gram":
        return _decide_gram(d, dtype_name, machine, ctx, kw)
    if op == "matvec":
        return _decide_matvec(d, dtype_name, machine, ctx, kw)
    return _decide_svd(d, dtype_name, machine, ctx, kw)


# -- collective helpers --------------------------------------------------------

def _axes(ctx) -> tuple[int, ...]:
    """Axis sizes the op reduces across (context["axes"]); () on one
    device."""
    return tuple(int(a) for a in ctx.get("axes", ()) or ())


def _terms_dict(t: CostTerms) -> dict:
    return {"flops": t.flops, "hbm_bytes": t.hbm_bytes, "steps": t.steps,
            "mxu_util": t.mxu_util, "comm_bytes": t.comm_bytes,
            "comm_steps": t.comm_steps, "route": t.route}


def _with_comm(t: CostTerms, coll: Mapping) -> CostTerms:
    return dataclasses.replace(
        t, comm_bytes=t.comm_bytes + coll["comm_bytes"],
        comm_steps=t.comm_steps + coll["comm_steps"])


def _pipeline_s(t_chunk: float, comm_chunk: float, chunks: int,
                pre: float = 0.0) -> float:
    """Modeled wall time of `chunks` compute→psum stages where chunk k's
    psum overlaps chunk k+1's compute."""
    if chunks <= 1:
        return pre + t_chunk + comm_chunk
    return (pre + t_chunk
            + (chunks - 1) * max(t_chunk, comm_chunk) + comm_chunk)


def _chunk_counts(n: int) -> tuple[int, ...]:
    """Chunk counts worth sweeping for an n-column segment split."""
    return tuple(c for c in CHUNK_CANDIDATES
                 if c == 1 or n // c >= MIN_SEGMENT)


def _psum_cost(machine, elems: float, axes, dtype_name, wire=None) -> dict:
    """The all-reduce of an `elems`-element f32 accumulator; wire="int8"
    prices the error-feedback compressed collective (int8 payload and one
    4-byte shared scale)."""
    if wire == "int8":
        body = machine.collective(elems * 1.0, axes, "int8")
        scale = machine.collective(4.0, axes, dtype_name)
        return {"algorithm": f"{body['algorithm']}+int8",
                "comm_bytes": body["comm_bytes"] + scale["comm_bytes"],
                "comm_steps": body["comm_steps"] + scale["comm_steps"],
                "comm_s": body["comm_s"] + scale["comm_s"]}
    return machine.collective(elems * 4.0, axes, dtype_name)


def _pass_terms(m: int, n: int, dtype_name: str) -> CostTerms:
    """One streaming pass over a dense (m × n) A for a vector (A v or
    Aᵀu, a library call): A once, the vectors in and out, 2mn FMA flops."""
    return CostTerms(flops=2.0 * m * n,
                     hbm_bytes=m * n * _machine.itemsize(dtype_name)
                     + 4.0 * (m + n), steps=1, route="fma")


def _decide_precision(op, d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """Sweep storage/wire precision for one decision op against the solver
    tolerance in context["tol"]: each candidate re-prices the op's whole
    decision at its byte widths (bf16 storage, the int8 psum wire, int8
    BlockELL data).  The plan keeps the caller's logical dtype and reports
    the pick and the modeled byte savings."""
    tol = float(ctx["tol"])
    sub = {k: v for k, v in ctx.items() if k != "tol"}

    def run(dname, wire=None):
        c = dict(sub)
        if wire:
            c["wire"] = wire
        kw2 = dict(kw, dtype=dname)
        if op == "sparse_matmul":
            return _decide_sparse(d, dname, machine, c, kw2)
        if op == "grad":
            return _decide_grad(d, dname, machine, c, kw2)
        if op == "gram":
            return _decide_gram(d, dname, machine, c, kw2)
        return _decide_matvec(d, dname, machine, c, kw2)

    base = run(dtype_name)
    cands = [("f32", base)]
    if tol >= PRECISION_GUARDS["psum8"] and op in ("grad", "gram") \
            and _axes(ctx):
        cands.append(("psum8", run(dtype_name, wire="int8")))
    if tol >= PRECISION_GUARDS["bf16"]:
        cands.append(("bf16", run("bfloat16")))
    if tol >= PRECISION_GUARDS["int8"] and op == "sparse_matmul":
        p8 = run("int8")
        if p8.choice == "bsr":     # only BlockELL data quantizes to int8
            cands.append(("int8", p8))

    floor = max(PRECISION_MIN_SAVINGS_S,
                PRECISION_MIN_SAVINGS_FRAC * base.cost_s)
    label, best = "f32", base
    for lb, p in cands[1:]:
        if base.cost_s - p.cost_s >= floor and p.cost_s < best.cost_s:
            label, best = lb, p

    def _moved(p):
        t = p.terms or {}
        return float(t.get("hbm_bytes", 0.0)) + float(t.get("comm_bytes", 0.0))

    b0, b1 = _moved(base), _moved(best)
    if label == "f32":
        note = (f"precision: f32 — no admissible candidate cleared the "
                f"savings floor max({PRECISION_MIN_SAVINGS_FRAC:.0%}, "
                f"{_us(PRECISION_MIN_SAVINGS_S)}) at tol={tol:g}")
    else:
        saved = 1.0 - b1 / b0 if b0 > 0 else 0.0
        note = (f"precision: {label} — modeled bytes {b0:.4g} -> {b1:.4g} "
                f"({saved:.0%} saved); tol={tol:g} clears guard "
                f"{PRECISION_GUARDS[label]:g}")
    return dataclasses.replace(
        best, precision=label, dtype=dtype_name,
        alternatives=best.alternatives + tuple(
            sorted(((f"precision:{lb}", p.cost_s) for lb, p in cands),
                   key=lambda t: t[1])),
        notes=best.notes + (note,))


def _bsr_kernel(nx: int) -> str:
    return "bsr_matvec" if nx <= 1 else "bsr_matmul"


def _bsr_terms(m, n, nx, ell, bs, dtype_name) -> CostTerms:
    """The BlockELL product's terms at its legacy launch choice."""
    kernel = _bsr_kernel(nx)
    dims = {"m": m, "n": n, "nx": nx, "ell": ell, "bs": bs}
    return at.cost_terms(kernel, at.legacy(kernel, dims, dtype_name), dims,
                         dtype_name)


def _decide_sparse(d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """BlockELL kernels (bsr_matvec for nx = 1, bsr_matmul above) against
    the dense gemm of the same (m × n) · (n × nx) product at its best
    launch choice.  int8 storage (the precision sweep's candidate) adds a
    4-byte scale a stored block."""
    m, n, nx = int(d["m"]), int(d["n"]), max(int(d.get("nx", 1)), 1)
    bsr_terms = _bsr_terms(m, n, nx, int(d["ell"]), int(d["bs"]), dtype_name)
    bsr_s = machine.time(bsr_terms, dtype_name)
    gemm_dims = {"m": m, "k": n, "n": nx}
    dense_s, dense_blocks = at.rank("gemm", gemm_dims, dtype_name,
                                    machine=machine)[0]
    use_bsr = bsr_s <= dense_s
    chosen_terms = bsr_terms if use_bsr else at.cost_terms(
        "gemm", dense_blocks, gemm_dims, dtype_name)
    return ExecutionPlan(
        op="sparse_matmul", choice="bsr" if use_bsr else "dense",
        blocks={"bs": int(d["bs"])} if use_bsr else dict(dense_blocks),
        cost_s=min(bsr_s, dense_s),
        breakdown=machine.breakdown(chosen_terms, dtype_name),
        alternatives=tuple(sorted((("bsr", bsr_s), ("dense", dense_s)),
                                  key=lambda t: t[1])),
        notes=(f"stored-block fraction ell/nbc = "
               f"{int(d['ell']) / max(n // int(d['bs']), 1):.3f}",),
        terms=_terms_dict(chosen_terms), **kw)


def _decide_grad(d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """The fused single-pass gradient (fused_grad at its best launch
    choice: A read once) against apply + adjoint (two streaming passes,
    each one library call).  On the H100 neither side pads, so the trade
    is one read of A against two, and launches once a calibration has
    priced them.

    With context {"axes": ...} the (f, g) psum is priced too, and a
    column-chunked overlapped schedule competes with the eager body.

    On fp8 storage (float8_e4m3fn, float8_e5m2) apply and adjoint raise,
    as in the reference (types.refuse_fp8), so the unfused route is
    priced but never chosen; the chunked schedules (their segments
    randsketch launches on the fp8 strip) compete as on any storage."""
    m, n = int(d["m"]), int(d["n"])
    fp8 = dtype_name in FP8
    gdims = {"m": m, "n": n}
    fused_s, fused_blocks = at.rank("fused_grad", gdims, dtype_name,
                                    machine=machine)[0]
    pass_terms = _pass_terms(m, n, dtype_name)
    unfused_s = 2.0 * machine.time(pass_terms, dtype_name)
    two_passes = CostTerms(flops=2 * pass_terms.flops,
                           hbm_bytes=2 * pass_terms.hbm_bytes,
                           steps=2 * pass_terms.steps, route="fma")
    fused_terms = at.cost_terms("fused_grad", fused_blocks, gdims,
                                dtype_name)
    axes = _axes(ctx)
    if not axes:
        use_fused = fp8 or fused_s <= unfused_s
        chosen_terms = fused_terms if use_fused else two_passes
        return ExecutionPlan(
            op="grad", choice="fused" if use_fused else "unfused",
            blocks=dict(fused_blocks) if use_fused else {},
            cost_s=min(fused_s, unfused_s),
            breakdown=machine.breakdown(chosen_terms, dtype_name),
            alternatives=tuple(sorted((("fused", fused_s),
                                       ("unfused", unfused_s)),
                                      key=lambda t: t[1])),
            notes=("unfused = apply + adjoint, 2 reads of A; "
                   "fused = 1 read of A",),
            terms=_terms_dict(chosen_terms), **kw)

    wire = ctx.get("wire")
    coll = _psum_cost(machine, n + 1.0, axes, dtype_name, wire)
    cands = [("fused", 1, fused_s + coll["comm_s"],
              _with_comm(fused_terms, coll))]
    pre = machine.time(pass_terms, dtype_name)
    for c in _chunk_counts(n):
        if c == 1:
            continue
        seg = -(-n // c)
        chunk_terms = _pass_terms(m, seg, dtype_name)
        cc = _psum_cost(machine, float(seg), axes, dtype_name, wire)
        total = _pipeline_s(machine.time(chunk_terms, dtype_name),
                            cc["comm_s"], c, pre=pre)
        agg = CostTerms(
            flops=pass_terms.flops + c * chunk_terms.flops,
            hbm_bytes=pass_terms.hbm_bytes + c * chunk_terms.hbm_bytes,
            steps=pass_terms.steps + c * chunk_terms.steps,
            comm_bytes=c * cc["comm_bytes"], comm_steps=c * cc["comm_steps"],
            route="fma")
        cands.append((f"fused-overlap{c}", c, total, agg))
    cands.append(("unfused", 1, unfused_s + coll["comm_s"],
                  _with_comm(two_passes, coll)))
    label, chunks, best_s, chosen_terms = min(
        cands[:-1] if fp8 else cands, key=lambda t: t[2])
    use_fused = label != "unfused"
    notes = [f"psum({n}·4B) over axes={axes}: {coll['algorithm']} "
             f"all-reduce, {_us(coll['comm_s'])}"]
    if chunks > 1:
        notes.append(f"overlap: {chunks} column chunks pipeline each "
                     "partial psum behind the next chunk's compute "
                     "(one extra A read)")
    return ExecutionPlan(
        op="grad", choice="fused" if use_fused else "unfused",
        blocks={**dict(fused_blocks), "chunks": chunks} if use_fused else {},
        cost_s=best_s,
        breakdown=machine.breakdown(chosen_terms, dtype_name),
        alternatives=tuple(sorted(((lb, s) for lb, _, s, _ in cands),
                                  key=lambda t: t[1])),
        notes=tuple(notes), terms=_terms_dict(chosen_terms), **kw)


def _decide_gram(d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """AᵀA for an (m × n) shard: tsgram and one n×n psum, against C
    column-segment cross-grams Aᵀ·A[:, seg] (randsketch at r = n/C) whose
    partial psums pipeline behind the next segment's compute.  The
    segment Q = A[:, seg] is stored as A is: on bf16 and fp8 storage it is
    exact in TF32 and randsketch skips its low products."""
    m, n = int(d["m"]), int(d["n"])
    gram_s, gram_blocks = at.rank("tsgram", {"m": m, "n": n},
                                  dtype_name, machine=machine)[0]
    axes = _axes(ctx)
    wire = ctx.get("wire")
    coll = _psum_cost(machine, float(n) * n, axes, dtype_name, wire)
    gram_terms = at.cost_terms("tsgram", gram_blocks, {"m": m, "n": n},
                               dtype_name)
    cands = [("eager", 1, gram_s + coll["comm_s"],
              _with_comm(gram_terms, coll))]
    for c in _chunk_counts(n):
        if c == 1 or not axes:
            continue
        seg = -(-n // c)
        sk_dims = {"m": m, "n": n, "r": seg,
                   "q_itemsize": _machine.itemsize(dtype_name)}
        sk_s, sk_blocks = at.rank("randsketch", sk_dims, dtype_name,
                                  machine=machine)[0]
        cc = _psum_cost(machine, float(n) * seg, axes, dtype_name, wire)
        total = _pipeline_s(sk_s, cc["comm_s"], c)
        sk_terms = at.cost_terms("randsketch", sk_blocks, sk_dims, dtype_name)
        agg = CostTerms(flops=c * sk_terms.flops,
                        hbm_bytes=c * sk_terms.hbm_bytes,
                        steps=c * sk_terms.steps, mxu_util=sk_terms.mxu_util,
                        comm_bytes=c * cc["comm_bytes"],
                        comm_steps=c * cc["comm_steps"], route=sk_terms.route)
        cands.append((f"overlap{c}", c, total, agg))
    label, chunks, best_s, chosen_terms = min(cands, key=lambda t: t[2])
    notes = [f"psum({n}x{n} f32) over axes={axes}: {coll['algorithm']} "
             f"all-reduce, {_us(coll['comm_s'])}"]
    if chunks > 1:
        notes.append(f"overlap: {chunks} column-segment cross-grams, each "
                     "partial psum hidden behind the next segment's "
                     "compute (A re-read per segment)")
    return ExecutionPlan(
        op="gram", choice="eager" if chunks == 1 else "overlap",
        blocks={"chunks": chunks}, cost_s=best_s,
        breakdown=machine.breakdown(chosen_terms, dtype_name),
        alternatives=tuple(sorted(((lb, s) for lb, _, s, _ in cands),
                                  key=lambda t: t[1])),
        notes=tuple(notes), terms=_terms_dict(chosen_terms), **kw)


def _decide_matvec(d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """One streaming pass over an (m × n) shard and the reduction of its
    n-vector result (context {"reduce": False}: none); the choice names
    the reduction (ring | tree | local)."""
    m, n = int(d["m"]), int(d["n"])
    pass_terms = _pass_terms(m, n, dtype_name)
    t_pass = machine.time(pass_terms, dtype_name)
    axes = _axes(ctx)
    payload = n * 4.0 if ctx.get("reduce", True) else 0.0
    if not axes or not payload:
        return ExecutionPlan(
            op="matvec", choice="local", blocks={}, cost_s=t_pass,
            breakdown=machine.breakdown(pass_terms, dtype_name),
            alternatives=(("local", t_pass),),
            notes=("no reduction: result stays shard-resident",),
            terms=_terms_dict(pass_terms), **kw)
    priced = {algo: machine.collective(payload, axes, dtype_name,
                                       algorithm=algo)
              for algo in ("ring", "tree")}
    choice = min(priced, key=lambda a: priced[a]["comm_s"])
    chosen_terms = _with_comm(pass_terms, priced[choice])
    return ExecutionPlan(
        op="matvec", choice=choice, blocks={},
        cost_s=t_pass + priced[choice]["comm_s"],
        breakdown=machine.breakdown(chosen_terms, dtype_name),
        alternatives=tuple(sorted(
            ((a, t_pass + priced[a]["comm_s"]) for a in priced),
            key=lambda t: t[1])),
        notes=(f"psum({n}·4B) over axes={axes}",),
        terms=_terms_dict(chosen_terms), **kw)


def bsr_bs_terms(m: int, n: int, nx: int, ell: int, bs: int,
                 dtype_name: str) -> CostTerms:
    """The block-size decision's terms for one candidate: the BlockELL
    product at its legacy launch choice on the padded shape, plus X's rows
    gathered once a stored block (bs · nx f32 each), the traffic that
    makes small blocks pay."""
    mp, np_ = -(-m // bs) * bs, -(-n // bs) * bs
    t = _bsr_terms(mp, np_, nx, ell, bs, dtype_name)
    return dataclasses.replace(
        t, hbm_bytes=t.hbm_bytes + (mp // bs) * ell * bs * nx * 4.0)


def _decide_bsr_bs(d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """Block-size selection on the actual per-candidate ELL widths
    (context["ell_by_bs"]); SparseRowMatrix's bs="auto" constructors and
    ops.bsr_block_size use it."""
    ell_by_bs = {int(k): int(v) for k, v in ctx["ell_by_bs"].items()}
    nx = max(int(d.get("nx", 1)), 1)
    m, n = int(d["m"]), int(d["n"])
    scored = []
    for bs in ctx.get("bs_candidates", BS_CANDIDATES):
        if bs not in ell_by_bs:
            continue
        t = bsr_bs_terms(m, n, nx, ell_by_bs[bs], bs, dtype_name)
        scored.append((machine.time(t, dtype_name), bs, t))
    scored.sort(key=lambda s: (s[0], s[1]))
    best_s, best_bs, terms = scored[0]
    return ExecutionPlan(
        op="bsr_bs", choice=f"bs={best_bs}", blocks={"bs": best_bs},
        cost_s=best_s, breakdown=machine.breakdown(terms, dtype_name),
        alternatives=tuple((f"bs={bs}", s) for s, bs, _ in scored),
        notes=("priced on actual ELL widths, X's rows gathered once a "
               "stored block",), terms=_terms_dict(terms), **kw)


def _decide_svd(d, dtype_name, machine, ctx, kw) -> ExecutionPlan:
    """compute_svd's mode="auto" (paper §3.1): gram while the n×n Gram is
    a comfortable object, the randomized sketch when A is too wide for the
    Gram but k is small, Lanczos for everything else (and always for
    sparse operators).  The structural gates decide; the modeled A-pass
    costs of all three modes are attached for explain()."""
    m, n, k = int(d["m"]), int(d["n"]), int(d["k"])
    kind = ctx.get("kind", "row")
    gram_threshold = int(ctx.get("gram_threshold", GRAM_THRESHOLD))
    rand_k = int(ctx.get("randomized_k_threshold", RANDOMIZED_K_THRESHOLD))
    q = int(ctx.get("power_iters", 2))
    p = int(ctx.get("oversampling", 8))
    db = _machine.itemsize(dtype_name)
    nnz = int(ctx.get("nnz", m * n))
    a_bytes = (nnz if kind == "sparse" else m * n) * db

    gram = CostTerms(flops=2.0 * m * n * n, hbm_bytes=a_bytes + n * n * db)
    sketch_passes = 2 + 2 * q
    rand = CostTerms(flops=2.0 * m * n * (k + p) * sketch_passes,
                     hbm_bytes=a_bytes * sketch_passes)
    lanczos_iters = min(max(2 * k + 10, 20), min(m, n))
    lz = CostTerms(flops=4.0 * (nnz if kind == "sparse" else m * n)
                   * lanczos_iters,
                   hbm_bytes=2.0 * a_bytes * lanczos_iters)
    costs = {"gram": machine.time(gram, dtype_name),
             "randomized": machine.time(rand, dtype_name),
             "lanczos": machine.time(lz, dtype_name)}

    notes = []
    if kind == "sparse":
        choice = "lanczos"
        notes.append("sparse operator: matrix-free iteration, no dense Gram")
    elif kind == "row" and n <= gram_threshold:
        choice = "gram"
        notes.append(f"n={n} <= gram_threshold={gram_threshold}: "
                     "one reduction + local eigh")
    elif kind == "row" and k <= rand_k:
        choice = "randomized"
        notes.append(f"k={k} <= randomized_k_threshold={rand_k}: "
                     f"{sketch_passes}-pass sketch beats k sequential "
                     "Lanczos directions")
    else:
        choice = "lanczos"
        notes.append("wide + large-k (or no sketch primitives): "
                     "matrix-free Lanczos")
    terms = {"gram": gram, "randomized": rand, "lanczos": lz}[choice]
    return ExecutionPlan(
        op="svd", choice=choice, blocks={}, cost_s=costs[choice],
        breakdown=machine.breakdown(terms, dtype_name),
        alternatives=tuple(sorted(costs.items(), key=lambda t: t[1])),
        notes=tuple(notes), **kw)


# -- calibration plumbing ------------------------------------------------------

def calibration_record(kernel: str, dims: Mapping[str, int],
                       blocks: Mapping[str, int], dtype,
                       measured_s: float) -> dict:
    """One MachineModel.calibrate() record from a measured kernel run: its
    raw terms and the measured seconds."""
    t = at.cost_terms(kernel, blocks, dims, dtype)
    return {"kernel": kernel, "dims": dict(dims), "blocks": dict(blocks),
            "dtype": _machine.dtype_name(dtype), "flops": t.flops,
            "hbm_bytes": t.hbm_bytes, "steps": t.steps,
            "mxu_util": t.mxu_util, "route": t.route,
            "measured_s": float(measured_s)}


def actual_record(plan: ExecutionPlan, measured_s: float) -> dict:
    """One plan-vs-actual record: an ExecutionPlan's modeled cost beside a
    measured time.  Kernel ops carry ``calibration_record()``'s terms and
    decision ops their plan's terms, so the same record feeds
    ``calibrate()`` unchanged (launch/telemetry.py collects them)."""
    rec = {"op": plan.op, "choice": plan.choice, "dims": dict(plan.dims),
           "dtype": plan.dtype, "backend": plan.backend,
           "modeled_s": float(plan.cost_s),
           "measured_s": float(measured_s),
           "ratio": (float(measured_s) / plan.cost_s
                     if plan.cost_s > 0 else None)}
    if plan.op in KERNEL_OPS:
        rec.update(calibration_record(plan.op, plan.dims, plan.blocks,
                                      plan.dtype, measured_s))
    elif plan.terms:
        rec.update(dict(plan.terms))
    return rec


def calibrate(records, backend: str | None = None, *,
              write: bool = True) -> tuple[MachineModel, float, float]:
    """Fit the backend's machine model to measured records; returns
    (calibrated model, mean relative error before, after).  "Before" is the
    model plan() used until now (the built-in H100); the fit starts from
    the backend's built-in instance.  With write=True the fit is kept next
    to the autotune cache and every later plan() on this backend prefers
    it."""
    backend = backend or _machine.default_backend()
    reference = _machine.for_backend(backend, prefer_calibrated=False)
    fitted = _machine.builtin(backend).calibrate(records)
    err_before, err_after = reference.error(records), fitted.error(records)
    if write:
        _machine.save_calibration(backend, fitted)
        at.reset()
    return fitted, err_before, err_after
