"""The port's randomized SVD (core/linalg/randsvd) and its randsketch kernel
against the JAX reference and numpy, on the CPU.

The randsketch dispatch is held against the reference's Pallas kernel in
interpret mode (``force_pallas=True``) to 1e-5, normwise relative.  The
test matrices Ω differ between the packages (torch's generator against
jax.random), so the factorizations are compared by their singular values,
against numpy's exact ones, never entry by entry.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.linalg import compute_svd as j_compute_svd
from repro.kernels import ops as jops
from repro_torch import api, convert
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.linalg import (RANDOMIZED_K_THRESHOLD, compute_svd,
                                     randomized_svd)
from repro_torch.core.linalg.randsvd import randomized_range_finder
from repro_torch.kernels import ops, randsketch


def _t(arr):
    return convert.tensor_from_numpy(arr, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _low_rank_plus_noise(m, n, rank, seed, noise=0.01):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.normal(size=(m, rank)))[0]
    V = np.linalg.qr(rng.normal(size=(n, rank)))[0]
    s = np.geomspace(50.0, 5.0, rank)
    return ((U * s) @ V.T + noise * rng.normal(size=(m, n))).astype(np.float32)


def _rm(a):
    return RowMatrix.create(a, device="cpu")


# -- the kernel dispatch ------------------------------------------------------

@pytest.mark.parametrize("m,n,r", [(64, 16, 8), (100, 20, 12), (256, 130, 24),
                                   (33, 7, 3), (64, 1000, 12)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_randsketch_matches_pallas(dtype, m, n, r):
    rng = np.random.default_rng(m + n + r)
    a = rng.normal(size=(m, n)).astype(
        np.float32 if dtype == "f32" else ml_dtypes.bfloat16)
    q = rng.normal(size=(m, r)).astype(np.float32)
    want = jops.randsketch(jnp.asarray(a), jnp.asarray(q),
                           out_dtype=jnp.float32, force_pallas=True)
    got = ops.randsketch(_t(a), _t(q), out_dtype=torch.float32)
    assert got.shape == (n, r) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    # The default output type is the storage type, as in the reference.
    assert ops.randsketch(_t(a), _t(q)).dtype == _t(a).dtype
    assert _rel(randsketch.randsketch_plain(_t(a), _t(q), torch.float32),
                want) <= 1e-5


def test_randsketch_slicing_bounds_sums_and_fills_the_card():
    # Main-path shape: A_w of 2^18 x 16384, r = 26: 128 column tiles and
    # one Q tile, sliced so that no slice sums more than SLICE_ROWS rows.
    slices, rows = randsketch.slicing(1 << 18, 16384, 26, 132)
    assert slices * rows >= 1 << 18 and rows <= randsketch.SLICE_ROWS
    assert 128 * slices >= randsketch.BLOCKS_PER_SM * 132
    assert slices * 16384 * 26 * 4 <= randsketch.PARTIALS_BYTES
    s, r = randsketch.slicing(20, 64, 5, 132)     # few rows: none empty
    assert s * r >= 20 and (s - 1) * r < 20


# -- RowMatrix primitives -----------------------------------------------------

def test_sketch_and_project():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(123, 37)).astype(np.float32)
    rm = _rm(a)
    Y1, Y2 = rm.sketch(9, seed=7), rm.sketch(9, seed=7)
    assert torch.equal(Y1.to_local(), Y2.to_local())
    assert Y1.shape == (123, 9)
    assert not torch.allclose(Y1.to_local(), rm.sketch(9, seed=8).to_local())
    B = rm.project(Y1)
    assert B.dtype == torch.float32 and B.shape == (37, 9)
    assert _rel(B, a.T @ Y1.to_local().numpy()) <= 1e-5
    # Padding rows carried over from the reference add nothing.
    ref = JRowMatrix.create(jnp.asarray(a))
    rows = np.concatenate([np.asarray(ref.rows), np.zeros((5, 37), np.float32)])
    padded = convert.rowmatrix_from_numpy(rows, 123, device="cpu")
    Q = padded.sketch(9, seed=7)
    assert Q.rows.shape == (128, 9) and bool((Q.rows[123:] == 0).all())
    assert _rel(padded.project(Q), B) <= 1e-6


# -- randomized SVD -----------------------------------------------------------

def test_randomized_matches_exact_singular_values():
    a = _low_rank_plus_noise(2000, 300, rank=12, seed=2)
    res = compute_svd(_rm(a), 8, mode="randomized")
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:8]
    assert np.max(np.abs(res.s.numpy() - s_ref) / s_ref) <= 1e-4
    U = res.U.to_local().numpy().astype(np.float64)
    np.testing.assert_allclose(U.T @ U, np.eye(8), atol=1e-4)
    # The rank-8 reconstruction is the optimal rank-8 approximant.
    u, s, vt = np.linalg.svd(a.astype(np.float64), full_matrices=False)
    best = (u[:, :8] * s[:8]) @ vt[:8]
    recon = (U * res.s.numpy()) @ res.V.numpy().T
    assert np.linalg.norm(recon - best, 2) / s[0] <= 1e-4


def test_randomized_agrees_with_gram_and_the_reference():
    rng = np.random.default_rng(3)
    n = 40
    Q = np.linalg.qr(rng.normal(size=(500, n)))[0]
    W = np.linalg.qr(rng.normal(size=(n, n)))[0]
    a = ((Q * np.geomspace(30.0, 0.1, n)) @ W).astype(np.float32)
    s_gram = compute_svd(_rm(a), 8, mode="gram").s.numpy()
    s_rand = compute_svd(_rm(a), 8, mode="randomized").s.numpy()
    np.testing.assert_allclose(s_rand, s_gram, rtol=1e-3)
    s_ref = np.asarray(j_compute_svd(JRowMatrix.create(jnp.asarray(a)), 8,
                                     mode="randomized").s)
    np.testing.assert_allclose(s_rand, s_ref, rtol=1e-3)


def test_info_reports_convergence_evidence():
    a = _low_rank_plus_noise(800, 200, rank=10, seed=4)
    res = compute_svd(_rm(a), 5, mode="randomized", oversampling=8,
                      power_iters=3, seed=5)
    info = res.info
    assert info["mode"] == info["plan"] == "randomized"
    assert info["rank"] == 13 and info["seed"] == 5
    assert info["passes_over_A"] == info["a_passes"] == 2 + 2 * 3
    assert info["iterations"] == 3 and info["converged"]
    assert info["oversampling"] == 8 and info["power_iters"] == 3
    # rank-10 signal, k = 5: the oversampled tail still holds real spectrum
    assert 0.0 < info["tail_ratio"] < 1.0
    want = j_compute_svd(JRowMatrix.create(jnp.asarray(a)), 5,
                         mode="randomized", oversampling=8,
                         power_iters=3).info
    assert set(want) <= set(info) | {"transposed"}


def test_auto_mode_follows_the_reference_planner():
    a = _low_rank_plus_noise(600, 96, rank=8, seed=6)
    rm, jrm = _rm(a), JRowMatrix.create(jnp.asarray(a))
    for kw, mode in ((dict(k=4), "gram"),
                     (dict(k=4, gram_threshold=64), "randomized")):
        assert compute_svd(rm, mode="auto", **kw).info["mode"] == mode
        assert j_compute_svd(jrm, mode="auto", **kw).info["mode"] == mode
    kw = dict(k=24, gram_threshold=64, randomized_k_threshold=16)
    assert j_compute_svd(jrm, mode="auto", tol=1e-5, max_restarts=100,
                         **kw).info["mode"] == "lanczos"
    got = compute_svd(rm, mode="auto", tol=1e-5, max_restarts=100, **kw)
    assert got.info["mode"] == "lanczos"
    assert RANDOMIZED_K_THRESHOLD == 128


def test_compute_u_false_and_wide_input():
    a = _low_rank_plus_noise(400, 150, rank=6, seed=7)
    res = compute_svd(_rm(a), 3, mode="randomized", compute_u=False)
    assert res.U is None and res.s.shape == (3,) and res.V.shape == (150, 3)
    wide = compute_svd(_rm(np.ascontiguousarray(a.T)), 3, mode="randomized")
    assert wide.info["transposed"] and wide.U.shape == (150, 3)
    np.testing.assert_allclose(wide.s.numpy(), res.s.numpy(), rtol=1e-4)


def test_randomized_svd_direct_api_and_range_finder():
    a = _low_rank_plus_noise(500, 120, rank=8, seed=8)
    U, s, V, info = randomized_svd(_rm(a), 4, oversampling=6,
                                   power_iters=2, seed=3)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:4]
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-4)
    assert U.shape == (500, 4) and V.shape == (120, 4) and info["seed"] == 3
    Q = randomized_range_finder(_rm(a), 10, power_iters=1, seed=0)
    q = Q.to_local().double()
    np.testing.assert_allclose(q.T @ q, np.eye(10), atol=1e-4)


def test_api_svd_request_takes_the_randomized_mode():
    a = _low_rank_plus_noise(300, 100, rank=6, seed=9)
    res = api.svd(api.SvdRequest(A=_rm(a), k=3, mode="auto", device="cpu",
                                 options={"gram_threshold": 50}))
    assert res.info["plan"] == "randomized" and res.info["a_passes"] == 6
    assert res.info["degraded"] is None and res.info["precision"] == "f32"
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:3]
    np.testing.assert_allclose(res.factors[1].numpy(), s_ref, rtol=1e-4)
