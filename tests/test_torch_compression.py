"""The compressed all-reduce with error feedback (``precision="psum8"``),
port against reference.

psum_int8's payload range is ±(127 // nshards), so the port is held to the
reference at the same shard count: four gloo ranks against the reference
on four forced host devices in a subprocess (tests/test_multidevice.py's
way), on the same numpy inputs.  On one rank the call is the reference's
local quantize-dequantize round trip.  The error-feedback identity of
tests/test_precision.py (sent + residual = exact + old residual) holds at
one rank and at four.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cluster_cases as C
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.tfocs.linop import LinopMatrix as JLinopMatrix
from repro.core.tfocs.smooth import SmoothQuad as JQuad
from repro.core.tfocs.smooth import row_separable as jrow_separable
from repro.train.compression import psum_int8 as jpsum_int8
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.core.tfocs.smooth import SmoothQuad, row_separable
from repro_torch.launch import mesh as tmesh
from repro_torch.train.compression import psum_int8

ROOT = Path(__file__).resolve().parents[1]
N = 24


def _data() -> dict:
    rng = np.random.default_rng(11)
    A = rng.normal(size=(130, N)).astype(np.float32)
    return {"parts": rng.normal(size=(4, N)).astype(np.float32),
            "res": (0.01 * rng.normal(size=(4, N))).astype(np.float32),
            "A": A, "b": (A @ rng.normal(size=N) + 0.1 * rng.normal(size=130))
            .astype(np.float32),
            "x": (0.1 * rng.normal(size=N)).astype(np.float32),
            "L": float(np.linalg.norm(A, 2) ** 2)}


DATA = _data()

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    assert len(jax.devices()) == 4
    from repro import api, compat
    from repro.core.distmat import RowMatrix
    from repro.core.distmat.types import make_mesh
    from repro.core.tfocs.linop import LinopMatrix
    from repro.core.tfocs.smooth import SmoothQuad, row_separable
    from repro.train.compression import psum_int8

    d = dict(np.load(sys.argv[1]))
    mesh = make_mesh((4, 1), ("data", "model"))

    def body(x, r):
        t, nr = psum_int8(x[0], r[0], ("data",), 4)
        return t, nr[None]

    tot, res = compat.shard_map(
        body, mesh=mesh, in_specs=(P("data", None), P("data", None)),
        out_specs=(P(), P("data", None)))(jnp.asarray(d["parts"]),
                                           jnp.asarray(d["res"]))
    rm = RowMatrix.create(jnp.asarray(d["A"]), mesh)
    lin = LinopMatrix(rm)
    sep = row_separable(SmoothQuad(lin.pad_data(jnp.asarray(d["b"])),
                                   lin.row_weights()))
    x = jnp.asarray(d["x"])
    f32 = rm.fused_grad(x, sep)
    f8, g8, _, res1 = rm.fused_grad(x, sep, residual=rm.init_psum_residual())
    sol = api.solve(api.SolveRequest(A=rm, b=d["b"], method="gra",
                                     tol=float(sys.argv[3]),
                                     max_iters=int(sys.argv[4]),
                                     L0=float(d["L"]), precision="psum8"))
    np.savez(sys.argv[2], psum_total=np.asarray(tot),
             psum_res=np.asarray(res), f32_f=np.asarray(f32[0]),
             f32_g=np.asarray(f32[1]), f8=np.asarray(f8),
             g8=np.asarray(g8), res1=np.asarray(res1),
             solve_x=np.asarray(sol.x))
    print(json.dumps({"precision": sol.info["precision"]}))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference at four shards, in a subprocess of its own (120 s
    timeout)."""
    tmp = tmp_path_factory.mktemp("psum8")
    np.savez(tmp / "in.npz", **DATA)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "out.npz"), str(C.PSUM8_TOL), str(C.PSUM8_ITERS)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = dict(np.load(tmp / "out.npz"))
    out.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def ranks():
    """The port on four gloo CPU ranks (about 10 s)."""
    return tmesh.spawn(C.psum8_rank, 4, args=(DATA,), backend="gloo",
                       device="cpu", timeout_s=60, deadline_s=240)


@pytest.mark.parametrize("rank", range(4))
def test_psum_int8_matches_reference_at_four_shards(ranks, reference, rank):
    """The same partials and residuals give the reference's bits: the
    shared scale, the int8 sum and every rank's new residual."""
    r = ranks[rank]
    np.testing.assert_array_equal(r["psum_total"].numpy(),
                                  reference["psum_total"])
    np.testing.assert_array_equal(r["psum_res"].numpy(),
                                  reference["psum_res"][rank])


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (24, 2), (1000, 3)])
def test_psum_int8_on_one_rank_is_the_local_round_trip(n, seed):
    """One rank: the reference's quantize-dequantize round trip with
    ±127, bit for bit."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    res = (0.01 * rng.normal(size=n)).astype(np.float32)
    got, got_res = psum_int8(torch.from_numpy(x), torch.from_numpy(res))
    want, want_res = jpsum_int8(jnp.asarray(x), jnp.asarray(res), (), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res))


def test_psum8_fused_pass_matches_reference_at_four_shards(ranks, reference):
    """f rides the f32 wire (within tests/test_fusedgrad.py's 1e-5); g is
    the sum of four int8 payloads on one shared scale, so where a shard's
    f32 partial rounds to the other side of a quantum the two packages
    may differ by one quantum a shard: at most 4 · scale."""
    r = ranks[0]
    np.testing.assert_allclose(float(r["f8"]), float(reference["f8"]),
                               rtol=1e-5, atol=1e-5)
    scale = float(np.abs(reference["f32_g"]).max()) / (127 // 4)
    assert np.abs(r["g8"].numpy() - reference["g8"]).max() <= 4 * scale
    for rr in ranks:
        assert torch.equal(rr["g8"], r["g8"])


@pytest.mark.parametrize("shards", [1, 4])
def test_psum8_fused_grad_ef_identity(ranks, shards):
    """tests/test_precision.py:96's identity: the value is exact, and what
    was sent plus what stays equals the exact gradient plus the old
    (zero) residuals, summed over the shards."""
    if shards == 1:
        A, b, x = DATA["A"], DATA["b"], DATA["x"]
        rm = RowMatrix.create(A, device="cpu")
        lin = LinopMatrix(rm)
        sep = row_separable(SmoothQuad(lin.pad_data(torch.from_numpy(b)),
                                       lin.row_weights()))
        xt = torch.from_numpy(x)
        f, g, _ = rm.fused_grad(xt, sep)
        res0 = rm.init_psum_residual()
        f8, g8, _, res1 = rm.fused_grad(xt, sep, residual=res0)
        sent_plus_kept = g8 + res1[0]
        jrm = JRowMatrix.create(jnp.asarray(A))
        jlin = JLinopMatrix(jrm)
        jsep = jrow_separable(JQuad(jlin.pad_data(jnp.asarray(b)),
                                    jlin.row_weights()))
        jf8, jg8, _, jres1 = jrm.fused_grad(
            jnp.asarray(x), jsep, residual=jrm.init_psum_residual())
        np.testing.assert_allclose(g8.numpy(), np.asarray(jg8), rtol=1e-5,
                                   atol=2 * float(np.abs(g.numpy()).max())
                                   / 127)
    else:
        f, g, f8 = ranks[0]["f32_f"], ranks[0]["f32_g"], ranks[0]["f8"]
        sent_plus_kept = ranks[0]["g8"] + sum(r["res1"] for r in ranks)
    np.testing.assert_allclose(float(f8), float(f), rtol=1e-6)
    np.testing.assert_allclose(sent_plus_kept.numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_psum8_shards_share_one_scale(ranks):
    """Each rank's new residual is its partial's distance to a multiple of
    one shared scale, within half a quantum."""
    scale = max(float(np.abs(r["g_local"].numpy()).max()) for r in ranks) \
        / (127 // 4)
    for r in ranks:
        err = np.abs(r["res1"].numpy())
        assert err.max() <= 0.5 * scale * (1 + 1e-5)


def test_psum8_solve_matches_reference_at_four_shards(ranks, reference):
    """gra with precision="psum8" on four shards: reported on every rank,
    the same x on every rank, within 100 × tol of the f32 solve
    (tests/test_precision.py's bound) and of the reference's psum8 solve
    at four shards."""
    assert reference["precision"] == "psum8"
    for r in ranks:
        assert r["solve_psum8_reported"] == "psum8"
        assert torch.equal(r["solve_psum8_x"], ranks[0]["solve_psum8_x"])
    x8, x32 = ranks[0]["solve_psum8_x"].numpy(), ranks[0]["solve_f32_x"].numpy()
    bound = 100 * C.PSUM8_TOL * np.linalg.norm(x32)
    assert np.linalg.norm(x8 - x32) < bound
    assert np.linalg.norm(x8 - reference["solve_x"]) < bound


def test_api_docstring_names_psum8_as_running():
    """repro_torch.api's `precision` key says what runs: psum8 runs on a
    RowMatrix or SparseRowMatrix (one shard or a mesh) and reports
    "psum8"; nothing there says it raises on either type."""
    from repro_torch import api
    doc = " ".join(api.__doc__.split())
    start = doc.index("precision —")
    entry = doc[start:doc.index("Requests run on the card")]
    assert '"psum8"' in entry and "reports \"psum8\"" in entry
    assert "RowMatrix or SparseRowMatrix" in entry
    assert "raise" not in entry and "until multi-GPU" not in entry
