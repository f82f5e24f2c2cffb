"""The machine model: the single home of the port's hardware constants.

Counterpart of src/repro/launch/machine.py.  Two layers, as there:

  * ``CostTerms``: what an op does, independent of the machine: flops,
    bytes moved through HBM, launches, the utilization fraction of its
    tiling, and the collective's bytes and hops.  kernels/autotune.py's
    per-kernel terms produce them.  ``route`` names the units a kernel's
    flops run on ("fma" for f32 FMA on the CUDA cores, "tf32", "bf16" and
    "int8" for the tensor cores' dense rates, "exp" for exponentials on the
    special-function units); an empty route prices them by the operand's
    item size, as the reference does.  On the H100 the route, not the
    dtype, sets the peak: the port's f32 tsgram, gemm, randsketch and
    bsr_rmatmul run 3xTF32 on the tensor cores while fused_grad and
    bsr_matvec/bsr_matmul run f32 FMA on the CUDA cores.

  * ``MachineModel``: terms into seconds,

        time = max(flops / (peak·util·mxu_eff), bytes / (bw·hbm_eff))
               + steps · step_overhead

    ``calibrate()`` fits the effective efficiencies ``mxu_eff`` and
    ``hbm_eff`` per dtype (and ``step_overhead_s``, the cost of one launch,
    where the records carry launches; see ``calibrate``) from measured
    records, and ``save_calibration()`` keeps the fit next to the autotune
    cache, so every later ``planner.plan()`` on that backend prefers it.

The built-in ``H100`` instance carries the NVIDIA H100 SXM data sheet's
peaks: the same figures every bound in PERF.md §6 divides by.  They are
the card's published numbers, not measurements.  Its ``step_overhead_s``
is 0: a launch's cost is fitted on the card, never guessed.  Until a
backend has been calibrated, "cuda" and "cpu" both plan against ``H100``,
so the CPU tests see the card's decisions (the reference plans every
uncalibrated backend against its TPU instance for the same reason).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "float64": torch.float64,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def dtype_name(dtype) -> str:
    """The dtype's name as the reference spells it ("float32", "bfloat16",
    "int8"), from a torch dtype or a name."""
    if isinstance(dtype, str):
        name = dtype.removeprefix("torch.")
        if name not in _DTYPES:
            raise TypeError(f"unknown dtype {dtype!r}")
        return name
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if hasattr(dtype, "name"):          # numpy dtypes and scalar types
        return dtype_name(str(dtype.name))
    return dtype_name(np.dtype(dtype).name)


def itemsize(dtype) -> int:
    return _DTYPES[dtype_name(dtype)].itemsize


@dataclass(frozen=True)
class CostTerms:
    """What an op does, independent of the machine that runs it."""
    flops: float = 0.0           # operations issued (on `route`'s units)
    hbm_bytes: float = 0.0       # bytes moved through HBM
    steps: float = 0.0           # kernel launches (and host syncs)
    mxu_util: float = 1.0        # utilization fraction of the tiling
    comm_bytes: float = 0.0      # bytes on the busiest link (collectives)
    comm_steps: float = 0.0      # serial collective hops (latency term)
    route: str = ""              # "" = the peak of the operand's item size


def collective_cost(n_devices: int, payload_bytes: float,
                    algorithm: str) -> tuple[float, float]:
    """(bytes on the busiest link, serial hops) for one all-reduce over
    `n_devices`.  Ring moves 2·P·(N−1)/N bytes in 2·(N−1) hops; a binary
    reduce and broadcast tree 2·P·⌈log₂N⌉ bytes in 2·⌈log₂N⌉ hops."""
    n = int(n_devices)
    if n <= 1:
        return 0.0, 0.0
    if algorithm == "ring":
        return 2.0 * payload_bytes * (n - 1) / n, 2.0 * (n - 1)
    if algorithm == "tree":
        depth = math.ceil(math.log2(n))
        return 2.0 * payload_bytes * depth, 2.0 * depth
    raise ValueError(f"algorithm must be 'ring' or 'tree', got {algorithm!r}")


@dataclass(frozen=True)
class MachineModel:
    """Per-backend machine constants and calibrated effective efficiencies."""
    name: str
    mxu_flops: Mapping[int, float]      # peak FLOP/s by operand itemsize
    hbm_bw: float                       # bytes/s per card
    step_overhead_s: float              # cost of one launch
    link_bw: float                      # bytes/s per link
    vmem_bytes: int                     # fast scratch: shared memory a block
    mxu_eff: Mapping[str, float] = field(default_factory=dict)  # dtype name
    hbm_eff: Mapping[str, float] = field(default_factory=dict)  # dtype name
    link_eff: Mapping[str, float] = field(default_factory=dict)  # dtype name
    link_latency_s: float = 1e-6        # per-hop collective latency
    source: str = "builtin"             # "builtin" | "calibrated"
    route_flops: Mapping[str, float] = field(default_factory=dict)
    sms: int = 0                        # multiprocessors (0: not a GPU)

    # -- constants, efficiency-adjusted --------------------------------------
    def peak_flops(self, dtype, route: str = "") -> float:
        return (self.peak_flops_raw(dtype_name(dtype), route)
                * self.mxu_eff.get(dtype_name(dtype), 1.0))

    def bandwidth(self, dtype) -> float:
        return self.hbm_bw * self.hbm_eff.get(dtype_name(dtype), 1.0)

    def link_bandwidth(self, dtype) -> float:
        return self.link_bw * self.link_eff.get(dtype_name(dtype), 1.0)

    # -- terms → seconds -----------------------------------------------------
    def breakdown(self, terms: CostTerms, dtype) -> dict:
        """The roofline decomposition plan().explain() prints."""
        compute_s = terms.flops / (self.peak_flops(dtype, terms.route)
                                   * max(terms.mxu_util, 1e-9))
        memory_s = terms.hbm_bytes / self.bandwidth(dtype)
        step_s = terms.steps * self.step_overhead_s
        comm_s = 0.0
        if terms.comm_bytes or terms.comm_steps:
            comm_s = (terms.comm_bytes / self.link_bandwidth(dtype)
                      + terms.comm_steps * self.link_latency_s)
        bound = "compute" if compute_s >= memory_s else "memory"
        if comm_s > max(compute_s, memory_s):
            bound = "comm"
        total = max(compute_s, memory_s) + step_s
        if comm_s:
            total += comm_s
        return {"compute_s": compute_s, "memory_s": memory_s,
                "step_s": step_s, "comm_s": comm_s, "bound": bound,
                "total_s": total}

    def time(self, terms: CostTerms, dtype) -> float:
        return self.breakdown(terms, dtype)["total_s"]

    # -- collectives ---------------------------------------------------------
    def collective(self, payload_bytes: float, axis_sizes: Sequence[int],
                   dtype="float32", algorithm: str = "auto") -> dict:
        """Price one all-reduce of `payload_bytes` over the axes it reduces
        across, one axis after another; "auto" takes the cheaper of ring
        and tree for this payload and layout."""
        algos = ("ring", "tree") if algorithm == "auto" else (algorithm,)
        best = None
        for algo in algos:
            cb = cs = 0.0
            for nax in axis_sizes:
                b, s = collective_cost(nax, payload_bytes, algo)
                cb += b
                cs += s
            t = (cb / self.link_bandwidth(dtype)
                 + cs * self.link_latency_s)
            if best is None or t < best["comm_s"]:
                best = {"algorithm": algo, "comm_bytes": cb,
                        "comm_steps": cs, "comm_s": t}
        return best

    # -- calibration ---------------------------------------------------------
    def calibrate(self, records: Sequence[Mapping]) -> "MachineModel":
        """Fit effective efficiencies per dtype from measured records.  Each
        record carries its raw terms (``planner.calibration_record`` builds
        them) and the measured seconds:

            {"dtype": "float32", "flops": …, "hbm_bytes": …, "steps": …,
             "mxu_util": …, "route": …, "measured_s": …}

        Least squares on the additive relaxation of the roofline,
            measured − steps·overhead − comm_steps·latency
                ≈ a·compute_raw + b·hbm_raw [+ c·comm_raw],
        weighted by 1/measured (relative error, the metric ``error()``
        scores), gives a = 1/mxu_eff, b = 1/hbm_eff and, where a record
        carries collective bytes, c = 1/link_eff; coefficients are kept
        positive, and a dtype needs at least 2 records.  This is the
        reference's fit term for term.

        On a model whose ``step_overhead_s`` is 0 (the built-in H100), a
        launch's cost is not known: where the records carry launches and
        span more than one launch count per record, it joins the fit as
        one more column shared by every dtype (the sum over dtypes of the
        per-dtype fits, solved jointly), clamped to [0, 1 ms]."""
        by_dtype: dict[str, list[Mapping]] = {}
        for r in records:
            by_dtype.setdefault(str(r["dtype"]), []).append(r)
        overhead = self.step_overhead_s
        if overhead == 0.0 and self.sms:
            overhead = self._fit_overhead(by_dtype)
        mxu_eff = dict(self.mxu_eff)
        hbm_eff = dict(self.hbm_eff)
        link_eff = dict(self.link_eff)
        for dname, recs in by_dtype.items():
            if len(recs) < 2:
                continue
            A, y, ncol = self._rows(recs, overhead)
            coef, *_ = np.linalg.lstsq(A, y, rcond=None)
            coef = [float(v) for v in coef]
            if coef[0] <= 0 or coef[1] <= 0:
                # Degenerate fit (one term dominates every record, or the
                # terms are collinear): the single-slope fit that leaves
                # the smaller residual.
                fits = []
                for col in range(ncol):
                    s = float(A[:, col] @ y
                              / max(A[:, col] @ A[:, col], 1e-30))
                    s = max(s, 0.0)
                    sse = float(((A[:, col] * s - y) ** 2).sum())
                    fits.append((sse, col, s))
                _, col, s = min(fits)
                coef = [0.0] * ncol
                coef[col] = s
            a, b = coef[0], coef[1]
            c = coef[2] if ncol > 2 else 0.0
            if a > 0:
                mxu_eff[dname] = float(np.clip(1.0 / a, 1e-4, 16.0))
            if b > 0:
                hbm_eff[dname] = float(np.clip(1.0 / b, 1e-4, 16.0))
            if c > 0:
                link_eff[dname] = float(np.clip(1.0 / c, 1e-4, 16.0))
        return dataclasses.replace(self, mxu_eff=mxu_eff, hbm_eff=hbm_eff,
                                   link_eff=link_eff, source="calibrated",
                                   step_overhead_s=overhead)

    def _rows(self, recs, overhead, *, with_steps: bool = False):
        """The weighted least-squares rows of `recs`: (A, y, columns)."""
        has_comm = any(float(r.get("comm_bytes", 0.0)) > 0 for r in recs)
        A, y = [], []
        for r in recs:
            compute_raw = (float(r["flops"])
                           / (self.peak_flops_raw(str(r["dtype"]),
                                                  r.get("route", ""))
                              * max(float(r.get("mxu_util", 1.0)), 1e-9)))
            hbm_raw = float(r["hbm_bytes"]) / self.hbm_bw
            resid = (float(r["measured_s"])
                     - float(r.get("steps", 0.0)) * overhead
                     - float(r.get("comm_steps", 0.0)) * self.link_latency_s)
            scale = 1.0 / max(float(r["measured_s"]), 1e-12)
            row = [compute_raw * scale, hbm_raw * scale]
            if has_comm:
                row.append(float(r.get("comm_bytes", 0.0))
                           / self.link_bw * scale)
            if with_steps:
                row.append(float(r.get("steps", 0.0)) * scale)
            A.append(row)
            y.append((max(resid, 0.0) if not with_steps else resid) * scale)
        A = np.asarray(A, np.float64).reshape(len(recs), -1)
        return A, np.asarray(y, np.float64), A.shape[1]

    def _fit_overhead(self, by_dtype) -> float:
        """The launch cost shared by every dtype's records (see
        ``calibrate``): one joint least-squares problem, block-diagonal in
        the per-dtype efficiency columns plus one launch column."""
        blocks, launch_col, ys = [], [], []
        steps = set()
        for recs in by_dtype.values():
            if len(recs) < 2:
                continue
            A, y, ncol = self._rows(recs, 0.0, with_steps=True)
            blocks.append(A[:, :-1])
            launch_col.append(A[:, -1])
            ys.append(y)
            steps.update(float(r.get("steps", 0.0)) for r in recs)
        if not blocks or len(steps) < 2:
            return 0.0
        rows = sum(b.shape[0] for b in blocks)
        cols = sum(b.shape[1] for b in blocks)
        M = np.zeros((rows, cols + 1))
        r0 = c0 = 0
        for b, lc in zip(blocks, launch_col):
            M[r0:r0 + b.shape[0], c0:c0 + b.shape[1]] = b
            M[r0:r0 + b.shape[0], cols] = lc
            r0 += b.shape[0]
            c0 += b.shape[1]
        coef, *_ = np.linalg.lstsq(M, np.concatenate(ys), rcond=None)
        return float(np.clip(coef[-1], 0.0, 1e-3))

    def peak_flops_raw(self, dname: str, route: str = "") -> float:
        if route and route in self.route_flops:
            return self.route_flops[route]
        it = itemsize(dname)
        return self.mxu_flops.get(it, self.mxu_flops[max(self.mxu_flops)])

    def error(self, records: Sequence[Mapping]) -> float:
        """Mean relative |modeled − measured| / measured over records: the
        number calibration must tighten."""
        errs = []
        for r in records:
            t = self.time(
                CostTerms(flops=float(r["flops"]),
                          hbm_bytes=float(r["hbm_bytes"]),
                          steps=float(r.get("steps", 0.0)),
                          mxu_util=float(r.get("mxu_util", 1.0)),
                          comm_bytes=float(r.get("comm_bytes", 0.0)),
                          comm_steps=float(r.get("comm_steps", 0.0)),
                          route=str(r.get("route", ""))),
                str(r["dtype"]))
            meas = float(r["measured_s"])
            if meas > 0:
                errs.append(abs(t - meas) / meas)
        return float(np.mean(errs)) if errs else float("nan")

    # -- persistence ---------------------------------------------------------
    def as_dict(self) -> dict:
        return {"name": self.name,
                "mxu_flops": {str(k): v for k, v in self.mxu_flops.items()},
                "hbm_bw": self.hbm_bw,
                "step_overhead_s": self.step_overhead_s,
                "link_bw": self.link_bw, "vmem_bytes": self.vmem_bytes,
                "mxu_eff": dict(self.mxu_eff), "hbm_eff": dict(self.hbm_eff),
                "link_eff": dict(self.link_eff),
                "link_latency_s": self.link_latency_s,
                "source": self.source,
                "route_flops": dict(self.route_flops), "sms": self.sms}

    @staticmethod
    def from_dict(d: Mapping) -> "MachineModel":
        return MachineModel(
            name=d["name"],
            mxu_flops={int(k): float(v) for k, v in d["mxu_flops"].items()},
            hbm_bw=float(d["hbm_bw"]),
            step_overhead_s=float(d["step_overhead_s"]),
            link_bw=float(d["link_bw"]), vmem_bytes=int(d["vmem_bytes"]),
            mxu_eff=dict(d.get("mxu_eff", {})),
            hbm_eff=dict(d.get("hbm_eff", {})),
            link_eff=dict(d.get("link_eff", {})),
            link_latency_s=float(d.get("link_latency_s", 1e-6)),
            source=d.get("source", "builtin"),
            route_flops={str(k): float(v)
                         for k, v in d.get("route_flops", {}).items()},
            sms=int(d.get("sms", 0)))


# -- built-in instances -------------------------------------------------------
# The ONLY place these numbers appear in the port: chip_smoke.py's and
# tools/'s bounds, the autotuner's ranking and every plan import them.

# NVIDIA H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12                # HBM3
F32_FMA_FLOPS = 67e12                    # f32 FMA on the CUDA cores
TF32_FLOPS = 495e12                      # TF32 tensor cores, dense
BF16_FLOPS = 989e12                      # bf16 tensor cores, dense
INT8_FLOPS = 1979e12                     # int8 tensor cores, dense
FP8_FLOPS = 1979e12                      # fp8 (e4m3, e5m2) tensor cores
# Exponentials: the special-function units issue 16 a clock an SM against
# 128 f32 FMA lanes (256 flops), so a sixteenth of the f32 rate.
EXP_PER_S = F32_FMA_FLOPS / 16
NVLINK_BYTES_PER_S = 450e9               # NVLink 4: 900 GB/s both ways
SMEM_BLOCK_BYTES = 227 * 1024            # shared memory a block may take
H100_SMS = 132

H100 = MachineModel(
    name="h100-sxm",
    mxu_flops={1: INT8_FLOPS, 2: BF16_FLOPS, 4: F32_FMA_FLOPS},
    hbm_bw=HBM_BYTES_PER_S,
    step_overhead_s=0.0,                 # fitted on the card
    link_bw=NVLINK_BYTES_PER_S,
    vmem_bytes=SMEM_BLOCK_BYTES,
    link_latency_s=1e-6,
    route_flops={"fma": F32_FMA_FLOPS, "tf32": TF32_FLOPS,
                 "bf16": BF16_FLOPS, "int8": INT8_FLOPS, "exp": EXP_PER_S},
    sms=H100_SMS)

CPU = MachineModel(
    name="cpu-host",
    mxu_flops={1: 1e11, 2: 1e11, 4: 1e11},  # a few vector cores' worth
    hbm_bw=3e10,                         # one socket's DRAM stream
    step_overhead_s=1e-6,                # dispatch cost per call
    link_bw=1e10,
    vmem_bytes=SMEM_BLOCK_BYTES,
    link_latency_s=2e-6)

_BUILTIN = {"cuda": H100, "cpu": CPU}


def builtin(backend: str) -> MachineModel:
    return _BUILTIN.get(backend, CPU)


def default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


# -- calibration cache (next to the autotune config cache) --------------------

def calibration_path() -> Path:
    """machine.json in the same directory as the autotune config cache
    ($REPRO_TORCH_AUTOTUNE_CACHE redirects both)."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    base = (Path(env) if env else
            Path.home() / ".cache" / "repro_torch" / "autotune.json")
    return base.with_name("machine.json")


_loaded: dict[Path, dict] = {}


def invalidate_cache() -> None:
    """Forget loaded calibrations (tests; after save_calibration)."""
    _loaded.clear()


def _calibrations(path: Path) -> dict:
    if path not in _loaded:
        try:
            data = json.loads(Path(path).read_text())
            _loaded[path] = dict(data.get("backends", {}))
        except (OSError, ValueError):
            _loaded[path] = {}
    return _loaded[path]


def save_calibration(backend: str, model: MachineModel,
                     path: Path | None = None) -> Path:
    """Keep a calibrated model for `backend`; later for_backend() calls
    prefer it over the built-in instance."""
    path = Path(path) if path else calibration_path()
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        data = {"version": 1, "backends": {}}
    data.setdefault("backends", {})[backend] = model.as_dict()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
    tmp.replace(path)
    invalidate_cache()
    return path


def for_backend(backend: str | None = None, *,
                prefer_calibrated: bool = True) -> MachineModel:
    """The model every decision prices against: the calibrated model for
    this backend where one has been saved, else ``H100`` (see the module
    docstring for why the card's instance, not the CPU's)."""
    backend = backend or default_backend()
    if prefer_calibrated:
        entry = _calibrations(calibration_path()).get(backend)
        if entry is not None:
            return MachineModel.from_dict(entry)
    return H100
