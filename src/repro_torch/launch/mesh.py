"""Mesh construction, and a launcher that runs one function on every rank.

Counterpart of src/repro/launch/mesh.py.  The reference builds jax meshes
over a TPU pod; the port builds ``core/distmat/types.Mesh`` over the ranks
of a torch.distributed process group, one process a rank:

    torchrun --nproc-per-node=4 my_script.py    # each rank: make_host_mesh(4)

or, from Python (what the tests and chip_smoke.py use):

    from repro_torch.launch import mesh
    results = mesh.spawn(fn, 4, args=(...,), backend="gloo", device="cpu")

``spawn`` starts one process a rank, gives each a process group
(``tcp://localhost:<free port>``, a timeout of its own so a collective
that one rank never reaches fails instead of hanging), calls
``fn(rank, *args)`` there and returns each rank's result in rank order.
NCCL takes one rank a card; ranks that share a card take gloo, which
stages CUDA tensors through the host while every kernel stays on the
card.
"""
from __future__ import annotations

import datetime
import socket
import tempfile
import time
import traceback
from pathlib import Path

import torch

from repro_torch.core.distmat import types as T


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16): the reference's
    production shapes, for a process group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return T.make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A (data, model) mesh over the process group's ranks; one rank
    without one.  Asks for more ranks than there are → (world size, 1), as
    the reference clamps to the devices that exist."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data * model > n:
        data, model = n, 1
    return T.make_mesh((data, model), ("data", "model"), device=device)


def axis_sizes(mesh, axes=None) -> tuple[int, ...]:
    """Ranks along each axis of `mesh` (all axes, or the named subset, a
    single name included): the topology the planner's collective model
    prices reductions against (``MachineModel.collective``)."""
    if mesh is None:
        return ()
    if axes is None:
        names = tuple(mesh.axis_names)
    elif isinstance(axes, str):
        names = (axes,)
    else:
        names = tuple(axes)
    return tuple(int(mesh.shape[a]) for a in names)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, fn, args, backend: str, port: int,
               device: str, timeout_s: float, outdir: str) -> None:
    import torch.distributed as dist
    out = Path(outdir)
    try:
        if device == "cpu":
            # Ranks on the CPU share its cores: one intra-op thread each.
            torch.set_num_threads(1)
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: no CUDA device")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
            if device == "cuda":
                torch.cuda.synchronize()
            torch.save(result, out / f"{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(fn, nprocs: int, *, args: tuple = (), backend: str | None = None,
          device: str = "cuda", timeout_s: float = 60.0,
          deadline_s: float | None = None) -> list:
    """Run ``fn(rank, *args)`` on `nprocs` new processes, one a rank of a
    fresh process group, and return their results in rank order (each
    saved with torch.save, so tensors come back as they were).  `fn` must
    be importable by name (a module-level function).

    `backend` defaults to NCCL when every rank has a card of its own and
    to gloo otherwise.  `timeout_s` is the process group's timeout (a
    collective some rank never joins raises after it); `deadline_s` (by
    default 4 × timeout_s) bounds the whole run, after which every rank
    is killed.  Ranks on the CPU (`device="cpu"`) share its cores, one
    intra-op thread each.  Any rank that fails fails the call, with its
    traceback; no process outlives it."""
    import torch.multiprocessing as mp
    if device == "cuda" and backend is None:
        backend = "nccl" if torch.cuda.device_count() >= nprocs else "gloo"
    backend = backend or "gloo"
    deadline_s = deadline_s or 4 * timeout_s
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as outdir:
        port = free_port()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nprocs, fn, args, backend, port,
                                   device, timeout_s, outdir))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = bad
                    break
                if time.monotonic() > end:
                    raise TimeoutError(f"spawn: {nprocs} ranks still running "
                                       f"after {deadline_s:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errs = sorted(Path(outdir).glob("*.err"))
        if failed or errs or any(p.exitcode != 0 for p in procs):
            text = "\n".join(f"rank {e.stem}:\n{e.read_text()}" for e in errs)
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"spawn: ranks exited {codes}\n{text}")
        return [torch.load(Path(outdir) / f"{r}.pt", weights_only=False)
                for r in range(nprocs)]
