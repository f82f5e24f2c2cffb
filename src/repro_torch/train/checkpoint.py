"""Atomic, async checkpointing of tensor trees, with restore onto any
device and any mesh.

Counterpart of src/repro/train/checkpoint.py, on the reference's on-disk
layout (one directory a step):

    ckpt_dir/
      step_00000120/
        manifest.json          # leaf paths, shapes, dtypes, extra
        shard_0.npz            # every leaf, as numpy
      LATEST                   # atomically replaced pointer file

  * a checkpoint is written under ``.tmp_step_*``, fsync'd, and *committed*
    by the rename of that directory, then the fsync'd LATEST pointer is
    replaced atomically: a crash mid-write leaves a ``.tmp`` directory that
    ``latest_step`` and ``restore`` ignore;
  * leaves are tensors (or numpy arrays and Python scalars), saved as
    numpy, bf16 as its 16-bit pattern; ``restore`` puts each leaf back on
    the device and in the dtype of its ``tree_like`` leaf, so the same
    files restore on the card, on the CPU, or on a mesh of another size;
  * on a mesh of several ranks one rank writes (the mesh's first, the
    reference's "host 0") and every rank then meets the others in a
    collective that says whether the write committed: a barrier after the
    commit, and a failed write raises on every rank.  Every rank restores
    by reading the files itself;
  * ``AsyncCheckpointer.save_async`` copies each leaf to the host on the
    caller's thread (the reference's device_get), so the solve may go on
    at once; the disk I/O runs on a worker thread, whose error surfaces at
    the next ``save_async`` or ``wait``.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import compat
from repro_torch.launch import telemetry as _tel


def _fsync_file(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: pathlib.Path) -> None:
    # Directory fsync makes the rename/replace itself durable; some
    # filesystems don't support it: best effort, never fatal.
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - exotic fs
        pass
    finally:
        os.close(fd)


# -- tensor trees --------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) for every leaf of a tree of dicts, lists, tuples and
    NamedTuples, in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flatten(tree[k],
                                                   f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for k in tree._fields
                for kv in _flatten(getattr(tree, k), f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree_like, leaves):
    """`tree_like`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves) for k, v in tree_like.items()}
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(_unflatten(v, leaves) for v in tree_like))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (a copy for a device tensor;
    bf16 as its int16 bit pattern, which numpy can hold)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _host_copy(leaf):
    """A leaf copied to the host, in its own dtype: what a worker thread
    may write while the caller's tensors change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


# -- the mesh's writer and its commit barrier ---------------------------------

def _ranks(mesh) -> int:
    return 1 if mesh is None or not mesh.member else mesh.size


def is_writer(mesh) -> bool:
    """Whether this rank writes the mesh's checkpoints: the mesh's first
    rank, or the only one."""
    return _ranks(mesh) == 1 or all(c == 0 for c in mesh.coordinate)


def _agree_failed(mesh, failed: bool) -> bool:
    """The barrier after a commit: every rank of the mesh learns whether
    the writer's write failed (a max over one flag)."""
    if _ranks(mesh) == 1:
        return failed
    flag = torch.tensor([1.0 if failed else 0.0], device=mesh.device)
    return bool(compat.pmax(flag, mesh, mesh.axis_names)[0] > 0)


class CheckpointWriteFailed(OSError):
    """The mesh's writer rank failed to commit a checkpoint (raised on the
    other ranks; the writer raises its own error)."""


def _raise_agreed(mesh, err: BaseException | None) -> None:
    if _agree_failed(mesh, err is not None):
        if err is not None:
            raise err
        raise CheckpointWriteFailed("the writer rank failed to commit a "
                                    "checkpoint")


# -- save / restore -----------------------------------------------------------

def save(ckpt_dir: str | os.PathLike, step: int, tree, *,
         extra: dict | None = None, mesh=None) -> pathlib.Path:
    """Synchronous save; returns the committed directory.  On a mesh of
    several ranks every rank calls it: the writer writes, and all meet
    after the commit."""
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    err = None
    if is_writer(mesh):
        tel = _tel.current()
        t0 = time.perf_counter()
        try:
            with tel.span("checkpoint.write", step=step):
                final = _save(ckpt_dir, step, tree, extra=extra)
        except Exception as e:  # noqa: BLE001 - re-raised after the barrier
            err = e
        tel.histogram("checkpoint.write_s").observe(time.perf_counter() - t0)
    _raise_agreed(mesh, err)
    return final


def _save(ckpt_dir, step, tree, *, extra=None) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    arrays = {}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = to_host(leaf)
        key = f"a{i}"
        arrays[key] = arr
        # "spec" is the reference's sharding spec: every leaf here is
        # whole (replicated), so the reference reads these files too.
        manifest["leaves"][name] = {"key": key, "shape": list(arr.shape),
                                    "dtype": _dtype_name(leaf),
                                    "spec": "[]"}
    np.savez(tmp / "shard_0.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # Durability before the commit point: the shard data and manifest are
    # fsync'd while still under the .tmp name, so the rename can never
    # expose a directory whose contents are still in the page cache.
    _fsync_file(tmp / "shard_0.npz")
    _fsync_file(tmp / "manifest.json")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # commit point
    _fsync_dir(ckpt_dir)
    latest_tmp = ckpt_dir / ".LATEST.tmp"
    latest_tmp.write_text(final.name)
    # fsync the step marker BEFORE the atomic replace: a crash between the
    # two leaves the old LATEST intact, never a torn pointer.
    _fsync_file(latest_tmp)
    os.replace(latest_tmp, ckpt_dir / "LATEST")  # atomic pointer update
    _fsync_dir(ckpt_dir)
    return final


class AsyncCheckpointer:
    """Device→host copy on the caller's thread; disk I/O on a worker.

    A worker's write error is never dropped: the next ``save_async`` or
    ``wait`` re-raises it on the caller's thread (and clears it, so one
    failure is reported once).  On a mesh (`mesh`, which the caller may
    rebind) only the writer rank starts a worker, and ``wait`` is the
    commit barrier every rank meets."""

    def __init__(self, ckpt_dir: str | os.PathLike, mesh=None):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.mesh = mesh
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.last_error: BaseException | None = None
        self._pending = False

    def save_async(self, step: int, tree, *, extra=None) -> None:
        # Surface a pending background failure BEFORE doing new work.
        self.wait()
        self._pending = True
        if not is_writer(self.mesh):
            return
        tel = _tel.current()
        tel.counter("checkpoint.async_saves").inc()
        # Backlog gauge: 1 while a write is in flight on the worker, 0 once
        # it commits; stuck at 1 means the disk cannot keep up.
        backlog = tel.gauge("checkpoint.backlog")
        backlog.set(1)
        host_tree = _unflatten(tree, iter(
            [_host_copy(leaf) for _, leaf in _flatten(tree)]))

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra)
            except BaseException as e:  # noqa: BLE001
                with self._lock:
                    self.last_error = e
            finally:
                backlog.set(0)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            err, self.last_error = self.last_error, None
        if self._pending:
            self._pending = False
            _raise_agreed(self.mesh, err)
        elif err is not None:
            raise err


def _complete(step_dir: pathlib.Path) -> bool:
    return (step_dir / "manifest.json").exists() \
        and (step_dir / "shard_0.npz").exists()


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """Newest *committed* step.  The LATEST pointer is trusted only when
    the directory it names is complete (manifest and shard data);
    otherwise the newest complete step directory is taken, so a partly
    written checkpoint is never picked up."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ptr = ckpt_dir / "LATEST"
    if ptr.exists():
        name = ptr.read_text().strip()
        if name and _complete(ckpt_dir / name):
            return int(name.split("_")[-1])
    if not ckpt_dir.exists():
        return None
    steps = sorted((int(d.name.split("_")[-1]) for d in
                    ckpt_dir.glob("step_*") if _complete(d)), reverse=True)
    return steps[0] if steps else None


def _leaf_like(arr: np.ndarray, info: dict, like):
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if info["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def restore(ckpt_dir: str | os.PathLike, tree_like, *,
            step: int | None = None) -> tuple[Any, dict]:
    """Restore into the structure of `tree_like`: each leaf on the device
    and in the dtype of its `tree_like` leaf (numpy leaves stay numpy).
    Returns (tree, extra)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_0.npz") as data:
        out = []
        for name, like in _flatten(tree_like):
            info = manifest["leaves"].get(name)
            if info is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[info["key"]]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{name}: shape {arr.shape} vs "
                                 f"{tuple(like.shape)}")
            out.append(_leaf_like(arr, info, like))
    return _unflatten(tree_like, iter(out)), manifest["extra"]
