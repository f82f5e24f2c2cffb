"""The port's request surface against the reference's, end to end on the CPU,
and the guard that keeps JAX and the reference package out of the port.

``api.solve`` and ``api.svd`` take the same requests on both sides (the
port's with ``device="cpu"``) and must give the same answers with the
standard ``Result.info`` keys.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.distmat import RowMatrix as JRowMatrix
from repro_torch import api, convert
from repro_torch.core.distmat import RowMatrix

ROOT = Path(__file__).resolve().parents[1]
STANDARD_KEYS = {"iterations", "a_passes", "converged", "plan", "degraded",
                 "precision"}
M, N = 180, 24


def _data(loss, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(M, N)) / np.sqrt(N)).astype(np.float32)
    z = a @ rng.normal(size=N)
    if loss == "logistic":
        b = np.where(z + rng.normal(size=M) > 0, 1.0, -1.0)
    elif loss == "poisson":
        b = rng.poisson(np.exp(0.3 * z))
    else:
        b = z + 0.2 * rng.normal(size=M)
    return a, b.astype(np.float32), float(np.linalg.norm(a, 2) ** 2)


def _matrices(a):
    ref = JRowMatrix.create(jnp.asarray(a))
    return ref, convert.rowmatrix_from_numpy(np.asarray(ref.rows),
                                             ref.n_rows, device="cpu")


@pytest.mark.parametrize("loss,method,reg,fused", [
    ("quad", "gra", "none", True),
    ("quad", "acc_rb", "l2", True),
    ("logistic", "gra", "l1", True),
    ("huber", "gra", "none", "auto"),
    ("poisson", "gra", "none", True),
    ("quad", "acc", "none", False),
])
def test_solve_matches_reference(loss, method, reg, fused):
    a, b, L = _data(loss, seed=len(loss))
    ref_A, port_A = _matrices(a)
    kw = dict(b=b, loss=loss, method=method, reg=reg, lam=0.1, param=0.5,
              L0=2.0 * L, tol=1e-5, max_iters=400, precision="f32")
    want = japi.solve(japi.SolveRequest(A=ref_A, **kw), fused=fused)
    got = api.solve(api.SolveRequest(A=port_A, device="cpu", **kw),
                    fused=fused)
    assert STANDARD_KEYS <= set(got.info)
    assert STANDARD_KEYS <= set(want.info)
    assert got.info["plan"] == want.info["plan"]
    assert got.info["precision"] == want.info["precision"] == "f32"
    assert got.info["degraded"] is want.info["degraded"] is None
    if method == "gra":
        assert got.info["iterations"] == int(want.info["iterations"])
        assert got.info["a_passes"] == int(want.info["a_passes"])
    np.testing.assert_allclose(got.info["objective"].item(),
                               float(want.info["objective"]), rtol=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               atol=1e-3 * max(1.0, np.linalg.norm(want.x)))
    assert got.request_id.startswith("solve-")


def test_solve_takes_a_local_array_and_x0():
    a, b, L = _data("quad", seed=3)
    x0 = np.full(N, 0.1, np.float32)
    kw = dict(A=a, b=b, L0=L, tol=1e-5, x0=x0, precision="f32")
    got = api.solve(api.SolveRequest(device="cpu", **kw), fused=True)
    want = japi.solve(japi.SolveRequest(**kw), fused=True)
    assert got.info["iterations"] == int(want.info["iterations"])
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)


@pytest.mark.parametrize("m,n,mode", [(300, 32, "gram"), (300, 32, "auto"),
                                      (30, 50, "gram")])
def test_svd_matches_reference(m, n, mode):
    rng = np.random.default_rng(m + n)
    a = (rng.normal(size=(m, n)) * 0.8 ** np.arange(n)).astype(np.float32)
    ref_A, port_A = _matrices(a)
    want = japi.svd(japi.SvdRequest(A=ref_A, k=5, mode=mode))
    got = api.svd(api.SvdRequest(A=port_A, k=5, mode=mode, device="cpu"))
    assert STANDARD_KEYS <= set(got.info)
    for key in ("iterations", "a_passes", "converged", "plan", "degraded"):
        assert got.info[key] == want.info[key], key
    U, s, V = got.factors
    jU, js, jV = want.factors
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    sign = np.sign(np.sum(V.numpy() * np.asarray(jV), axis=0))
    np.testing.assert_allclose(V.numpy() * sign, np.asarray(jV), atol=1e-3)
    np.testing.assert_allclose(U.to_local().numpy() * sign,
                               np.asarray(jU.to_local()), atol=1e-3)


def test_svd_wraps_a_plain_tensor():
    a = torch.from_numpy(_data("quad")[0])
    res = api.svd(api.SvdRequest(A=a, k=3, device="cpu", compute_u=False))
    assert res.factors[0] is None and res.factors[1].shape == (3,)
    assert res.request_id.startswith("svd-")


@pytest.mark.parametrize("bad", [
    dict(loss="hinge"), dict(reg="l0"), dict(tol=-1.0), dict(lam=float("nan")),
    dict(L0=0.0), dict(max_iters=0), dict(precision="f16"),
    dict(resume=True), dict(b=None), dict(deadline_s=-1.0),
])
def test_request_validation_matches_reference(bad):
    a, b, _ = _data("quad")
    kw = dict(A=a, b=b)
    kw.update(bad)
    with pytest.raises(ValueError) as ref_err:
        japi.SolveRequest(**kw)
    with pytest.raises(ValueError) as port_err:
        api.SolveRequest(device="cpu", **kw)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("extra", [
    dict(checkpoint_dir="ckpt", checkpoint_every=5),
    dict(deadline_s=60.0),
    dict(telemetry=True),
], ids=["checkpoint_dir", "deadline_s", "telemetry"])
def test_fault_tolerance_options_run(extra, tmp_path):
    """checkpoint_dir and deadline_s take gra to the elastic executor (plan
    "elastic", its recovery counters) and telemetry adds the trace, as on
    the reference's direct path, with the same answer."""
    a, b, L = _data("quad")
    if "checkpoint_dir" in extra:
        extra = dict(extra, checkpoint_dir=str(tmp_path / "port"))
    # tol 0: both run every iteration (a stop at the f32 rounding floor
    # may come an iteration apart in the two packages; ROADMAP queue 3).
    kw = dict(b=b, method="gra", tol=0.0, max_iters=40, L0=L)
    res = api.solve(api.SolveRequest(A=RowMatrix.create(a, device="cpu"),
                                     device="cpu", **kw, **extra))
    if "checkpoint_dir" in extra:
        extra = dict(extra, checkpoint_dir=str(tmp_path / "ref"))
    ref = japi.solve(japi.SolveRequest(A=JRowMatrix.create(jnp.asarray(a)),
                                       **kw, **extra))
    assert res.info["plan"] == ref.info["plan"]
    assert STANDARD_KEYS <= set(res.info)
    assert res.info["degraded"] == ref.info["degraded"]
    assert ("trace" in res.info) == ("trace" in ref.info)
    for key in ("checkpoint_saves", "retries", "remeshes", "resumed_from"):
        assert res.info.get(key) == ref.info.get(key), key
    assert float(np.max(np.abs(res.x.numpy() - np.asarray(ref.x)))) < 1e-4


def test_psum8_takes_the_int8_wire():
    """precision="psum8" on a RowMatrix through gra runs the error-feedback
    int8 wire and reports it, as the reference does (one shard here; four
    in tests/test_torch_compression.py)."""
    a, b, _ = _data("quad")
    L = float(np.linalg.norm(a, 2) ** 2)
    kw = dict(b=b, method="gra", tol=1e-5, max_iters=400, L0=L)
    low = api.solve(api.SolveRequest(A=RowMatrix.create(a, device="cpu"),
                                     precision="psum8", device="cpu", **kw))
    f32 = api.solve(api.SolveRequest(A=RowMatrix.create(a, device="cpu"),
                                     precision="f32", device="cpu", **kw))
    ref = japi.solve(japi.SolveRequest(A=JRowMatrix.create(jnp.asarray(a)),
                                       precision="psum8", **kw))
    assert low.info["precision"] == ref.info["precision"] == "psum8"
    assert low.info["plan"] == "fused"
    scale = float(np.linalg.norm(np.asarray(ref.x)))
    assert float(np.linalg.norm(low.x.numpy() - np.asarray(ref.x))) \
        < 100 * 1e-5 * scale
    assert float(torch.linalg.vector_norm(low.x - f32.x)) \
        < 100 * 1e-5 * scale


def test_svd_request_validation():
    with pytest.raises(ValueError, match="k must be"):
        api.SvdRequest(A=None, k=0)
    with pytest.raises(ValueError, match="deadline_s must be"):
        api.SvdRequest(A=None, k=2, deadline_s=-1.0)
    req = api.SvdRequest(A=None, k=2, deadline_s=1.0, telemetry=True)
    assert req.deadline_s == 1.0 and req.telemetry


def test_requests_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, _ = _data("quad")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.solve(api.SolveRequest(A=a, b=b))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.svd(api.SvdRequest(A=a, k=2))
    cpu = convert.rowmatrix_from_numpy(a, M, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.solve(api.SolveRequest(A=cpu, b=b))


@pytest.mark.parametrize("entry", ["lanczos_eigsh", "gra_group_init",
                                   "acc_group_init", "lbfgs_group_init"])
def test_engine_entry_points_default_to_the_card(monkeypatch, entry):
    """Lanczos and the group engines' state constructors, called without
    a device, go to the card and raise where there is none."""
    from repro_torch.core.linalg import lanczos_eigsh
    from repro_torch.core.optim import batched

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"lanczos_eigsh": lambda: lanczos_eigsh(lambda v: v, 30, 2),
            "gra_group_init": lambda: batched.gra_group_init(2, 5),
            "acc_group_init": lambda: batched.acc_group_init(2, 5, 7),
            "lbfgs_group_init": lambda: batched.lbfgs_group_init(2, 5)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry]()


def _imports(path):
    """Top-level module names a file imports (absolute imports only)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


@pytest.mark.parametrize("rel", [
    "src/repro_torch/compat.py", "src/repro_torch/launch/mesh.py",
    "src/repro_torch/train/compression.py", "tests/torch_cluster_cases.py",
    "src/repro_torch/train/checkpoint.py", "src/repro_torch/train/elastic.py",
    "src/repro_torch/train/faults.py", "src/repro_torch/train/straggler.py",
    "src/repro_torch/core/optim/elastic.py", "tests/torch_fault_cases.py"])
def test_cluster_modules_import_neither_jax_nor_the_reference(rel):
    """The cluster path's and the fault tolerance's modules, and the rank
    bodies their multi-rank tests spawn, exist and import no jax (the
    ranks never load it)."""
    path = ROOT / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert names
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")], names


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20
