"""Launch-choice autotuner for the port's CUDA kernels, with a persistent
cache.

Counterpart of src/repro/kernels/autotune.py.  The reference searched the
Pallas kernels' VMEM block sizes for every kernel.  Here one kernel has a
choice whose cost the model can tell apart: gemm's output tile width `bn`
(8, 16 or 32 columns, the reference's bn; gemm.tile_width picks it
today), filtered by the shared memory its ring takes.  A narrow tile reads
A once more a column tile; a wide one pads B with zero columns.  Every
other kernel has one launch, its wrapper's own rule (tsgram's and
randsketch's slicing, the bsr kernels' plans, the fused kernels' C plan
entries, the flash and scan designs' fixed tiles): ``candidates`` gives it
one empty choice, and ``cost_terms`` prices that launch for the planner.

A choice is shape-free (the cache holds it per power-of-two shape bucket).
The legacy choice is what the wrapper launches today, and ``rank`` breaks
ties toward it, so with no recorded sweep and no calibration every kernel
launches as it did before the autotuner.

``cost_terms`` counts what PERF.md §6's bounds count (each input read
once, each output written once, the flops on the kernel's route) plus what
a launch adds: A read once a column tile (gemm), the blocks once a tile
(bsr_matmul, bsr_rmatmul) and the flops of padded tile columns.  Wave fill
is not modelled.  ``steps`` counts kernel launches a call.

Multi-slot kernels (fused_grad_multi, fused_grad_bsr_multi) are keyed and
ranked without k: a request gets the same launch, and so the same bits,
alone and in a group of any size.
"""
from __future__ import annotations

import json
import os
import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping

from repro_torch.launch import machine as _machine
from repro_torch.launch.machine import CostTerms, itemsize

SMEM_BLOCK_MAX = 232448          # shared memory a block may take (sm_90)


# -- per-kernel legacy choice / candidates / shared memory / terms -----------

@dataclass(frozen=True)
class KernelSpec:
    knobs: tuple[str, ...]
    dims: tuple[str, ...]              # the shape-bucket key
    legacy: Callable                   # (dims, dtype) -> choice
    gen: Callable                      # (dims, dtype) -> [choice]
    smem: Callable                     # (choice, dims, dtype) -> bytes
    terms: Callable                    # (choice, dims, dtype) -> CostTerms


def _one(d, dtype):
    return {}


def _only_one(d, dtype):
    return [{}]


def _no_smem(b, d, dtype):
    return 0


def _fixed(dims: tuple[str, ...], terms: Callable) -> KernelSpec:
    """A kernel with one launch: its wrapper's own rule."""
    return KernelSpec((), dims, _one, _only_one, _no_smem, terms)


# gemm (csrc/gemm.cu: Staging<TA, NT>)
GEMM_TILE_M = 256
GEMM_WIDTHS = (8, 16, 32)


def gemm_smem(bn: int, a_itemsize: int) -> tuple[int, int]:
    """(stages, shared memory) of csrc/gemm.cu's ring for tiles of `bn`
    columns and A of `a_itemsize` bytes: 256 staged rows of A, each its
    stage's bytes (256, or 128 for fp8 A, whose B split for 256 values
    would leave no room for two stages at 32 columns) and one more
    16-byte piece, and B's TF32 split of the stage's k-steps, as many
    stages as fit, up to 4."""
    row = 128 if a_itemsize == 1 else 256
    steps = (row // a_itemsize) // 8
    stage = GEMM_TILE_M * (row + 16) + steps * 4 * (bn // 8) * 128
    stages = min(SMEM_BLOCK_MAX // stage, 4)
    return stages, stages * stage


def _gemm_legacy(d, dtype):
    from .gemm import tile_width
    return {"bn": tile_width(int(d["n"]))}


def _gemm_gen(d, dtype):
    return [{"bn": bn} for bn in GEMM_WIDTHS
            if gemm_smem(bn, itemsize(dtype))[0] >= 2]


def _gemm_smem(b, d, dtype):
    return gemm_smem(b["bn"], itemsize(dtype))[1]


def _gemm_terms(b, d, dtype):
    isz = itemsize(dtype)
    m, k, n = int(d["m"]), int(d["k"]), int(d["n"])
    b_isz = int(d.get("b_itemsize", 4))
    ctiles = -(-n // b["bn"])
    # TF32 products a product: an f32 operand adds its low part (3xTF32
    # for f32 x f32); bf16 and fp8 are exact in TF32.
    products = 1 + (isz == 4) + (b_isz == 4)
    return CostTerms(flops=products * 2.0 * m * k * ctiles * b["bn"],
                     hbm_bytes=(m * k * isz * ctiles + k * n * b_isz
                                + 4 * m * n),
                     steps=1, route="tf32")


def _tsgram_terms(b, d, dtype):
    isz = itemsize(dtype)
    m, n = int(d["m"]), int(d["n"])
    flops = float(m) * n * (n + 1)
    return CostTerms(flops=(3 * flops if isz == 4 else flops),
                     hbm_bytes=m * n * isz + n * n * 4, steps=2,
                     route="tf32" if isz == 4 else "bf16")


def _randsketch_terms(b, d, dtype):
    """TF32 products a product: an f32 A adds its low part, and a Q stored
    in f32 (d["q_itemsize"], default 4) its own; bf16 and fp8 A and Q are
    exact in TF32.  Q is read as f32."""
    isz = itemsize(dtype)
    m, n, r = int(d["m"]), int(d["n"]), int(d["r"])
    products = 1 + (isz == 4) + (int(d.get("q_itemsize", 4)) == 4)
    return CostTerms(flops=products * 2.0 * m * n * r,
                     hbm_bytes=m * n * isz + 4 * r * (m + n), steps=3,
                     route="tf32")


# Block-sparse kernels: dims m, n (padded), bs, ell, nx; int8 storage adds
# a 4-byte scale a stored block.
def _stored(d, dtype):
    bs, ell = int(d["bs"]), int(d["ell"])
    nbr = -(-int(d["m"]) // bs)
    blocks = nbr * ell
    scales = 4 * blocks if _machine.dtype_name(dtype) == "int8" else 0
    return nbr, blocks * bs * bs, blocks * bs * bs * itemsize(dtype) \
        + 4 * blocks + scales


def _bsr_matvec_terms(b, d, dtype):
    _, elems, nbytes = _stored(d, dtype)
    m, n = int(d["m"]), int(d["n"])
    return CostTerms(flops=2.0 * elems, hbm_bytes=nbytes + 4 * (n + m),
                     steps=1, route="fma")


def _bsr_matmul_terms(b, d, dtype):
    """The blocks once an output tile of bsr.matmul_plan's width, and the
    flops of the tile's padded columns."""
    from .bsr import matmul_plan
    nbr, elems, nbytes = _stored(d, dtype)
    m, n, nx = int(d["m"]), int(d["n"]), int(d["nx"])
    nt = matmul_plan(nbr, int(d["bs"]), nx, itemsize(dtype),
                     _machine.H100_SMS).nt
    tiles = -(-nx // nt)
    return CostTerms(flops=2.0 * elems * tiles * nt,
                     hbm_bytes=nbytes * tiles + 4 * nx * (n + m), steps=1,
                     route="fma")


def _bsr_rmatmul_terms(b, d, dtype):
    """As bsr_matmul's, at bsr.rmatmul_plan's tile on the tensor cores."""
    from .bsr import rmatmul_plan
    _, elems, nbytes = _stored(d, dtype)
    m, n, nx = int(d["m"]), int(d["n"]), int(d["nx"])
    nt = rmatmul_plan(int(d["bs"]), nx, itemsize(dtype)).nt
    tiles = -(-nx // nt)
    products = 3 if itemsize(dtype) == 4 else 2
    return CostTerms(flops=products * 2.0 * elems * tiles * nt,
                     hbm_bytes=nbytes * tiles + 4 * nx * (n + m), steps=2,
                     route="tf32")


def _fg_terms(b, d, dtype):
    isz = itemsize(dtype)
    m, n, k = int(d["m"]), int(d["n"]), int(d.get("k", 1))
    return CostTerms(flops=4.0 * m * n * k,
                     hbm_bytes=m * n * isz + 4 * k * (2 * n + 3 * m + 1),
                     steps=2, route="fma")


def _fgb_terms(b, d, dtype):
    _, elems, nbytes = _stored(d, dtype)
    m, n, k = int(d["m"]), int(d["n"]), int(d.get("k", 1))
    return CostTerms(flops=4.0 * elems * k,
                     hbm_bytes=nbytes + 4 * k * (2 * n + 3 * m + 1),
                     steps=2, route="fma")


# flash_attention: dims bh (B·Hq), bkv (B·Hkv), sq, sk, d, causal.
def _flash_terms(b, d, dtype):
    isz = itemsize(dtype)
    bh, bkv = int(d["bh"]), int(d.get("bkv", d["bh"]))
    sq, sk, hd = int(d["sq"]), int(d["sk"]), int(d["d"])
    if int(d.get("causal", 1)):     # the mask is top-left: row i sees
        pairs = (sq * (sq + 1) / 2 if sq <= sk    # min(i + 1, sk) keys
                 else sk * (sk + 1) / 2 + (sq - sk) * sk)
    else:
        pairs = sq * sk
    return CostTerms(flops=4.0 * hd * bh * pairs,
                     hbm_bytes=(2 * bh * sq * hd + 2 * bkv * sk * hd) * isz,
                     steps=1, route="bf16" if isz == 2 else "fma")


def _scan_terms(b, d, dtype):
    bt, s, dd, n = int(d["bt"]), int(d["s"]), int(d["d"]), int(d["n"])
    return CostTerms(flops=float(bt) * s * dd * n,
                     hbm_bytes=(3 * bt * s * dd + 2 * bt * s * n + dd * n
                                + dd + bt * dd * n) * 4,
                     steps=1, route="exp")


_BSR = ("m", "n", "bs", "ell")

KERNELS: dict[str, KernelSpec] = {
    "gemm": KernelSpec(("bn",), ("m", "k", "n"), _gemm_legacy, _gemm_gen,
                       _gemm_smem, _gemm_terms),
    "tsgram": _fixed(("m", "n"), _tsgram_terms),
    "randsketch": _fixed(("m", "n", "r"), _randsketch_terms),
    "fused_grad": _fixed(("m", "n"), _fg_terms),
    "fused_grad_multi": _fixed(("m", "n"), _fg_terms),
    "bsr_matvec": _fixed(_BSR, _bsr_matvec_terms),
    "bsr_matmul": _fixed(_BSR + ("nx",), _bsr_matmul_terms),
    "bsr_rmatmul": _fixed(_BSR + ("nx",), _bsr_rmatmul_terms),
    "fused_grad_bsr": _fixed(_BSR, _fgb_terms),
    "fused_grad_bsr_multi": _fixed(_BSR, _fgb_terms),
    "flash_attention": _fixed(("bh", "sq", "sk", "d"), _flash_terms),
    "selective_scan": _fixed(("bt", "s", "d", "n"), _scan_terms),
}


# -- candidate enumeration + ranking -----------------------------------------

def candidates(kernel: str, dims: Mapping[str, int], dtype) -> list[dict]:
    """Choices whose shared memory fits a block."""
    spec = KERNELS[kernel]
    return [b for b in spec.gen(dims, dtype)
            if spec.smem(b, dims, dtype) <= SMEM_BLOCK_MAX]


def estimate_smem(kernel: str, blocks: Mapping[str, int],
                  dims: Mapping[str, int], dtype) -> int:
    """Shared memory a block of this choice takes (bytes)."""
    return KERNELS[kernel].smem(blocks, dims, dtype)


def legacy(kernel: str, dims: Mapping[str, int], dtype) -> dict:
    """The choice the kernel's wrapper launches with today."""
    return dict(KERNELS[kernel].legacy(dims, dtype))


def cost_terms(kernel: str, blocks: Mapping[str, int],
               dims: Mapping[str, int], dtype) -> CostTerms:
    """Machine-independent work description (flops, bytes, launches)."""
    return KERNELS[kernel].terms(dict(blocks), dims, dtype)


def model_time(kernel: str, blocks: Mapping[str, int],
               dims: Mapping[str, int], dtype, *,
               machine: "_machine.MachineModel | None" = None) -> float:
    """Modeled seconds on `machine` (the current backend's by default)."""
    machine = machine or _machine.for_backend()
    return machine.time(cost_terms(kernel, blocks, dims, dtype), dtype)


def _ranking_dims(kernel: str, dims: Mapping[str, int]) -> dict:
    """The dims a ranking reads: the bucket key's, never a slot count
    (multi-slot kernels rank the same at every k)."""
    keep = set(KERNELS[kernel].dims) | {"b_itemsize", "bkv", "causal"}
    return {k: v for k, v in dims.items() if k in keep}


def rank(kernel: str, dims: Mapping[str, int], dtype, *,
         machine: "_machine.MachineModel | None" = None
         ) -> list[tuple[float, dict]]:
    """(score, choice) ascending by model time; ties go to the legacy
    choice, then to the sorted knobs.  The legacy choice is always in the
    pool, so the pick never models slower than it."""
    machine = machine or _machine.for_backend()
    dims = _ranking_dims(kernel, dims)
    pool = candidates(kernel, dims, dtype)
    old = legacy(kernel, dims, dtype)
    if old not in pool:
        pool = pool + [old]
    scored = [(model_time(kernel, b, dims, dtype, machine=machine), b)
              for b in pool]
    scored.sort(key=lambda t: (t[0], t[1] != old, sorted(t[1].items())))
    return scored


# -- shape buckets + persistent cache ----------------------------------------

def bucket(x: int) -> int:
    """Next power of two (0 stays 0): the shape-bucket granularity."""
    return 0 if x <= 0 else 1 << (int(x) - 1).bit_length()


def cache_key(kernel: str, backend: str, dtype,
              dims: Mapping[str, int]) -> str:
    spec = KERNELS[kernel]
    shape = "x".join(str(bucket(int(dims[k]))) for k in spec.dims)
    return f"{kernel}|{backend}|{_machine.dtype_name(dtype)}|{shape}"


def user_cache_path() -> Path:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


class ConfigCache:
    """One JSON file of {key: {"blocks": ..., "source": ..., "us": ...}}."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.entries: dict[str, dict] = {}
        self._loaded = False

    def load(self) -> "ConfigCache":
        if not self._loaded:
            self._loaded = True
            try:
                data = json.loads(self.path.read_text())
                self.entries = dict(data.get("entries", {}))
            except (OSError, ValueError):
                self.entries = {}
        return self

    def lookup(self, key: str) -> dict | None:
        return self.load().entries.get(key)

    def put(self, key: str, blocks: Mapping[str, int], *,
            source: str = "swept", us: float | None = None) -> None:
        entry = {"blocks": dict(blocks), "source": source}
        if us is not None:
            entry["us"] = round(float(us), 3)
        self.load().entries[key] = entry

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"version": 1, "entries": self.entries}, indent=1, sort_keys=True))
        tmp.replace(self.path)


_memo: dict[tuple, dict] = {}
# resolve()'s answers keyed by its arguments as given, so a wrapper's
# repeated call costs one lookup (no sorting, no ranking dims).
_resolved: dict[tuple, dict] = {}
_caches: dict[Path, ConfigCache] = {}
stats = {"memo_hits": 0, "cache_hits": 0, "ranked": 0, "swept": 0}


def _cache_at(path: Path) -> ConfigCache:
    if path not in _caches:
        _caches[path] = ConfigCache(path)
    return _caches[path]


def reset() -> None:
    """Forget memoized choices, cache handles and counters, and the
    planner and machine caches layered on top, so a recalibration or a
    cache-path change is picked up everywhere at once."""
    _memo.clear()
    _resolved.clear()
    _caches.clear()
    for k in stats:
        stats[k] = 0
    _machine.invalidate_cache()
    from repro_torch.launch import planner as _planner
    _planner.invalidate_cache()


def _memo_key(kernel, backend, dtype, dims) -> tuple:
    return (kernel, backend, _machine.dtype_name(dtype),
            tuple(sorted(_ranking_dims(kernel, dims).items())))


def get_config(kernel: str, dims: Mapping[str, int], dtype, *,
               backend: str | None = None) -> dict:
    """The choice for a shape: memo → user cache (a swept winner for the
    shape's bucket, where it is a candidate at this exact shape) → ranking
    at the exact shape.  Never times anything."""
    backend = backend or _machine.default_backend()
    mkey = _memo_key(kernel, backend, dtype, dims)
    if mkey in _memo:
        stats["memo_hits"] += 1
        return dict(_memo[mkey])
    entry = _cache_at(user_cache_path()).lookup(
        cache_key(kernel, backend, dtype, dims))
    rdims = _ranking_dims(kernel, dims)
    pool = candidates(kernel, rdims, dtype) + [legacy(kernel, rdims, dtype)]
    if entry is not None and dict(entry["blocks"]) in pool:
        stats["cache_hits"] += 1
        blocks = dict(entry["blocks"])
    else:
        stats["ranked"] += 1
        blocks = rank(kernel, rdims, dtype,
                      machine=_machine.for_backend(backend))[0][1]
    _memo[mkey] = dict(blocks)
    return dict(blocks)


def resolve(kernel: str, dims: Mapping[str, int], dtype,
            overrides: Mapping[str, int | None] | None = None, *,
            tune: str = "auto", backend: str | None = None) -> dict:
    """The launch choice the ops wrappers dispatch with: explicit knob
    values always win; missing knobs come from the planner (`tune="auto"`:
    memo, swept cache or ranking against the calibrated machine model) or
    the legacy choice (`tune="off"`).  A value the kernel cannot take
    raises ValueError."""
    fast = (kernel, backend, dtype, tune, tuple(dims.items()),
            tuple((overrides or {}).items()))
    hit = _resolved.get(fast)
    if hit is not None:
        stats["memo_hits"] += 1
        return dict(hit)
    spec = KERNELS[kernel]
    ov = {k: v for k, v in (overrides or {}).items() if v is not None}
    unknown = set(ov) - set(spec.knobs)
    if unknown:
        raise ValueError(f"{kernel} takes no {sorted(unknown)}; its launch "
                         f"choices are {spec.knobs}")
    if tune == "auto":
        # planner.plan(kernel, ...)'s choice, without pricing it.
        base = {} if len(ov) == len(spec.knobs) else get_config(
            kernel, dims, dtype, backend=backend)
    elif tune == "off":
        base = legacy(kernel, dims, dtype)
    else:
        raise ValueError(f"tune must be 'auto' or 'off', got {tune!r}")
    if ov:
        rdims = _ranking_dims(kernel, dims)
        legal = candidates(kernel, rdims, dtype) + [legacy(kernel, rdims,
                                                           dtype)]
        if not any(all(c.get(k) == v for k, v in ov.items())
                   for c in legal):
            raise ValueError(
                f"{kernel} cannot launch with {ov} at {dict(dims)} "
                f"({_machine.dtype_name(dtype)}); its choices there are "
                f"{[dict(c) for c in legal]}")
    _resolved[fast] = {**base, **ov}
    return {**base, **ov}


# -- on-device timing sweep ---------------------------------------------------

def sweep(kernel: str, dims: Mapping[str, int], dtype,
          run_fn: Callable[[Mapping[str, int]], float | None], *,
          top_n: int = 3, reps: int = 5,
          include_legacy: bool = True) -> list[tuple[float, dict]]:
    """Time the top-N model-ranked choices (and the legacy one) with
    `run_fn(choice)` and return (median seconds, choice) ascending.
    `run_fn` either returns the seconds it measured (CUDA events) or
    returns None once the device is done, and is then timed on the host
    clock.  Offline use only: dispatch never calls this."""
    ranked = rank(kernel, dims, dtype)
    pool = [blocks for _, blocks in ranked[:top_n]]
    old = legacy(kernel, dims, dtype)
    if include_legacy and old not in pool:
        pool.append(old)
    stats["swept"] += 1
    timed = []
    for blocks in pool:
        run_fn(blocks)                       # warm-up
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = run_fn(blocks)
            times.append(got if got is not None
                         else time.perf_counter() - t0)
        timed.append((statistics.median(times), blocks))
    timed.sort(key=lambda t: (t[0], t[1] != old, sorted(t[1].items())))
    return timed


def record(kernel: str, dims: Mapping[str, int], dtype,
           blocks: Mapping[str, int], *, backend: str | None = None,
           source: str = "swept", us: float | None = None) -> str:
    """Keep a winner in the user cache (and the in-memory memo)."""
    backend = backend or _machine.default_backend()
    key = cache_key(kernel, backend, dtype, dims)
    cache = _cache_at(user_cache_path())
    cache.put(key, blocks, source=source, us=us)
    cache.save()
    _memo[_memo_key(kernel, backend, dtype, dims)] = dict(blocks)
    _resolved.clear()
    return key
