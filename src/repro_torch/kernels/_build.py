"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At first use, ``nvcc``
compiles each ``*.cu`` for ``sm_90a`` into an object (all sources at once,
one process each) and links them into one shared library under ``build/`` at
the repository root, named by a hash of the sources and flags; ``ctypes``
loads it.  ptxas reports each kernel's registers and spills (``-Xptxas -v``)
into a log beside the library (``build_log``).  Nothing is built or loaded
when a module is imported.

Every C entry returns ``cudaGetLastError()``; ``check`` raises on non-zero.
There is no fallback: a failed build, a missing ``nvcc`` or a device that is
not sm_90 raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Block-sparse storage also takes int8, with a per-block f32 scale.
STORAGE_CODES = {**DTYPE_CODES, torch.int8: 2}
# The dense operand of fused_grad(_multi), tsgram, gemm and randsketch (A)
# also takes float8_e4m3fn and float8_e5m2 (common.cuh: DT_F8, DT_F8E5),
# where the reference computes on them.
DENSE_CODES = {**DTYPE_CODES, torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # device, m, n, dtype, *staged, *grid
    "repro_fused_grad_multi_plan": [_I, _LL, _I, _I, _IP, _IP],
    # device, a, dtype, x, t, w, m, n, k, staged, grid, loss, param, z,
    # g_part, f_part, g, f, stream
    "repro_fused_grad_multi": [_I, _P, _I, _P, _P, _P, _LL, _I, _I, _I, _I,
                               _I, _F, _P, _P, _P, _P, _P, _P],
    # device, a, dtype, lda, q, q_exact, m, n, r, qs, slices,
    # rows_per_slice, part, out, out_dtype, stream
    "repro_randsketch": [_I, _P, _I, _I, _P, _I, _LL, _I, _I, _P, _I, _LL,
                         _P, _P, _I, _P],
    # device, a, dtype, m, n, slices, rows_per_slice, part, out, out_dtype,
    # stream
    "repro_tsgram": [_I, _P, _I, _LL, _I, _I, _LL, _P, _P, _I, _P],
    # device, a, a_dtype, b, b_dtype, c, c_dtype, m, K, N, nt, blocks,
    # stream
    "repro_gemm": [_I, _P, _I, _P, _I, _P, _I, _LL, _I, _I, _I, _I, _P],
    # device, data, dtype, scales, cols, nbr, ell, bs, x, y, stream
    "repro_bsr_spmv": [_I, _P, _I, _P, _P, _LL, _I, _I, _P, _P, _P],
    # device, data, dtype, scales, cols, nbr, ell, bs, x, nx, ldx, nt, br,
    # stages, smem, grid, y, stream
    "repro_bsr_spmm": [_I, _P, _I, _P, _P, _LL, _I, _I, _P, _I, _I, _I, _I,
                       _I, _I, _I, _P, _P],
    # device, data, dtype, scales, order, rows, chunk_start, chunk_len,
    # col_chunks, nchunks, bs, nbc, x, nx, xvec, nt, stages, smem, part, y,
    # stream
    "repro_bsr_rmatmul": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # device, nbr, ell, bs, n, dtype, *staged, *grid
    "repro_fused_grad_bsr_multi_plan": [_I, _LL, _I, _I, _I, _I, _IP, _IP],
    # device, data, dtype, cols, x, t, w, nbr, ell, bs, n, k, staged, grid,
    # loss, param, z, g_part, f_part, g, f, stream
    "repro_fused_grad_bsr_multi": [_I, _P, _I, _P, _P, _P, _P, _LL, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _P, _P, _P, _P,
                                   _P, _P],
    # device, q, k, v, o, dtype, bhq, Sq, Sk, D, group, scale, causal, stream
    "repro_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _I, _P],
    # device, x, dt, A, B, C, D, h0, y, h_out, Bt, S, d, N, stream
    "repro_selective_scan": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def build_log() -> Path:
    """The compiler's report for the current library, one section a source."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile and link the kernels unless the library is already built."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, logs = [], []
        for src, _, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            logs.append(f"== {src.name}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        (Path(tmp) / "build.log").write_text("\n".join(logs))
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(Path(tmp) / "build.log", build_log())
        os.replace(lib, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.repro_error_string.argtypes = [_I]
            loaded.repro_error_string.restype = ctypes.c_char_p
            _lib = loaded
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_device(*tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of `tensors`; raises unless it is an sm_90
    card, the only target the kernels are built for."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; {dev} is "
                           f"sm_{cap[0]}{cap[1]}")
    return dev


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def dense_code(t: torch.Tensor, what: str) -> int:
    """The dtype code of a dense operand that may be stored in fp8."""
    if t.dtype not in DENSE_CODES:
        raise TypeError(f"{what} must be float32, bfloat16, float8_e4m3fn "
                        f"or float8_e5m2, got {t.dtype}")
    return DENSE_CODES[t.dtype]


def storage_code(t: torch.Tensor, what: str) -> int:
    """The dtype code of block-sparse storage: f32, bf16 or int8."""
    if t.dtype not in STORAGE_CODES:
        raise TypeError(f"{what} must be float32, bfloat16 or int8, got "
                        f"{t.dtype}")
    return STORAGE_CODES[t.dtype]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` if it starts on a 16-byte boundary, else a fresh copy of it (a
    new allocation, which does): the kernels' 16-byte loads and copies need
    that boundary, and a view such as ``x[1:]`` may start anywhere."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
