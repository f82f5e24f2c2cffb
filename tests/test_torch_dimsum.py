"""The port's DIMSUM column similarities against the reference's, on the CPU.

Both matrix types, built from the same numpy arrays: the exact path
(threshold 0, the scaled Gram) agrees with the reference to 1e-5; γ = 1e9
keeps every entry, so the sampled path equals the exact one; γ, the keep
probabilities p and the estimator variance are deterministic and agree with
the reference's ``info``.  The sampled entries themselves come from a
torch.Generator, not the reference's fold_in key, so they are held to the
reference's contract instead (tests/test_sparserow.py, TestSampledDimsum):
bounded relative error above the threshold, and unbiasedness over seeds.
Then api.similarities, its info keys, and a similarity request in a mixed
server queue.
"""
import functools

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.distmat import SparseRowMatrix as JSparseRowMatrix
from repro_torch import api
from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
from repro_torch.core.distmat.sparserow import dimsum_gamma
from repro_torch.launch.serve import SolverServer

BS = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny torch ops, which
    torch's thread pool slows by 50× when the machine's cores are shared
    (a parallel test run); restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def indicator_matrix(m=2000, n=16, seed=3):
    """Binary indicator data with overlapping column support (the reference
    tests' matrix): the bounded-entry setting of the DIMSUM analysis."""
    rng = np.random.default_rng(seed)
    base = rng.random((m, 4)) < 0.4
    cols = []
    for j in range(n):
        src = base[:, j % 4]
        flip = rng.random(m) < 0.15
        cols.append(np.where(flip, ~src, src))
    return np.stack(cols, 1).astype(np.float32)


def _exact(A):
    norms = np.linalg.norm(A.astype(np.float64), axis=0)
    return (A.T.astype(np.float64) @ A) / np.maximum(np.outer(norms, norms),
                                                     1e-30)


def _ports(A):
    """The port's RowMatrix and SparseRowMatrix of A, by kind."""
    return {"row": RowMatrix.create(A, device="cpu"),
            "sparse": SparseRowMatrix.from_dense(A, BS, device="cpu")}


@functools.lru_cache(maxsize=None)
def _reference(kind, seed, threshold):
    """The reference's api.similarities on indicator_matrix(seed=seed) as
    (sim, info) in numpy.  Each call compiles anew, so the file makes few
    and shares them."""
    A = indicator_matrix(seed=seed)
    M = JRowMatrix.create(A) if kind == "row" \
        else JSparseRowMatrix.from_dense(A, bs=BS)
    res = japi.similarities(japi.SimilarityRequest(A=M, threshold=threshold))
    info = {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in res.info.items()}
    return np.asarray(res.factors[0]), info


def _block_sparse(m=203, n=45, seed=1):
    """Ragged block-sparse Gaussian data with an all-zero column."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-m // BS), -(-n // BS)
    mask = rng.random((mb, nb)) < 0.4
    a = np.kron(mask, np.ones((BS, BS))) * rng.normal(size=(mb * BS, nb * BS))
    a = a[:m, :n].astype(np.float32)
    a[:, 7] = 0.0
    return a


@pytest.mark.parametrize("kind", ["row", "sparse"])
def test_exact_path_matches_the_reference(kind):
    A = indicator_matrix()
    want, _ = _reference(kind, 3, 0.0)
    got = _ports(A)[kind].column_similarities()
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _exact(A), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["row", "sparse"])
def test_exact_path_on_ragged_block_sparse_data(kind):
    """Ragged m and n, padding rows and columns, and an all-zero column
    (similarity 0, diagonal 0) against the float64 cosine matrix."""
    A = _block_sparse()
    port = _ports(A)[kind]
    got = port.column_similarities()
    np.testing.assert_allclose(got.numpy(), _exact(A), rtol=1e-5, atol=1e-5)
    assert float(got[7].abs().max()) == 0.0
    sim, info = port.column_similarities(0.0, return_info=True)
    assert torch.equal(sim, got) and info["gamma"] is None
    assert float(info["variance"].abs().sum()) == 0.0
    assert bool((info["p"] == 1).all())


@pytest.mark.parametrize("kind", ["row", "sparse"])
def test_huge_gamma_recovers_exact(kind):
    """√γ ≥ max‖cᵢ‖ ⇒ every pᵢ = 1 ⇒ the sampled estimator is exact."""
    A = _block_sparse(seed=4)
    port = _ports(A)[kind]
    want = port.column_similarities().numpy()
    got = port.column_similarities(0.5, gamma=1e9).numpy()
    off = ~np.eye(A.shape[1], dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=1e-5)
    diag = (np.linalg.norm(A, axis=0) > 0).astype(np.float32)
    np.testing.assert_array_equal(np.diag(got), diag)


@pytest.mark.parametrize("kind", ["row", "sparse"])
def test_sampling_parameters_match_the_reference(kind):
    """γ, p and the per-pair variance are deterministic: both of the port's
    types match the reference's info (variance to 1e-5 of its largest
    entry; the reference computes it the same way on both of its types)."""
    _, jinfo = _reference("row", 6, 0.5)
    sim, info = _ports(indicator_matrix(seed=6))[kind].column_similarities(
        0.5, return_info=True)
    assert info["gamma"] == pytest.approx(jinfo["gamma"], rel=1e-12)
    assert info["gamma"] == pytest.approx(dimsum_gamma(16, 0.5))
    np.testing.assert_allclose(info["p"].numpy(), jinfo["p"], rtol=1e-6)
    jv = jinfo["variance"]
    np.testing.assert_allclose(info["variance"].numpy(), jv, rtol=1e-5,
                               atol=1e-5 * np.abs(jv).max())
    np.testing.assert_array_equal(np.diag(sim.numpy()), np.ones(16))


@pytest.mark.parametrize("kind", ["row", "sparse"])
@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_error_bound_above_threshold(kind, threshold):
    """DIMSUM's contract at the default γ: pairs with similarity ≥ the
    threshold are estimated to bounded relative error, mean < 0.15 and max
    < 0.55 (the reference's bounds).  They hold with high probability, not
    for every draw: over 40 seeds of the port's generator about one draw in
    ten misses one of them on this matrix, so the bounds are held by the
    average over seeds 0-7 of each draw's mean and by the median of each
    draw's max."""
    A = indicator_matrix()
    port = _ports(A)[kind]
    want = _exact(A)
    off = ~np.eye(A.shape[1], dtype=bool)
    hi = (want >= threshold) & off
    assert hi.any()
    means, maxes = [], []
    for seed in range(8):
        got = port.column_similarities(threshold, seed=seed).numpy()
        rel = np.abs(got - want)[hi] / want[hi]
        means.append(rel.mean())
        maxes.append(rel.max())
    assert np.mean(means) < 0.15, means
    assert np.median(maxes) < 0.55, maxes


@pytest.mark.parametrize("kind", ["row", "sparse"])
def test_estimator_is_unbiased(kind):
    """Averaging estimates over seeds converges toward the exact value even
    under aggressive sampling, and a seed reproduces its draw."""
    A = indicator_matrix(seed=5)
    port = _ports(A)[kind]
    want = _exact(A)
    off = ~np.eye(A.shape[1], dtype=bool)
    single = port.column_similarities(0.5, gamma=25.0, seed=0)
    assert torch.equal(single, port.column_similarities(0.5, gamma=25.0,
                                                        seed=0))
    err1 = np.abs(single.numpy() - want)[off]
    ests = np.stack([port.column_similarities(0.5, gamma=25.0,
                                              seed=s).numpy()
                     for s in range(16)])
    avg = np.abs(ests.mean(0) - want)[off]
    assert avg.max() < err1.max()
    assert avg.mean() < 0.5 * err1.mean()


@pytest.mark.parametrize("kind", ["row", "sparse"])
def test_variance_shrinks_with_gamma(kind):
    port = _ports(indicator_matrix(seed=6))[kind]
    sums = []
    for g in (2.0, 20.0, 1e9):
        _, info = port.column_similarities(0.5, gamma=g, return_info=True)
        v = info["variance"].numpy()
        assert v.shape == (16, 16) and (v >= -1e-6).all()
        assert np.allclose(np.diag(v), 0.0)
        sums.append(float(v.sum()))
    assert sums[0] > sums[1] > sums[2] == 0.0, sums
    assert bool((info["p"] <= 1.0).all()) and info["gamma"] == 1e9


def test_int8_and_bf16_storage_dequantize_first():
    """int8 blocks are dequantized, bf16 rows upcast: the similarities of
    the values they hold."""
    A = _block_sparse(seed=9)
    ps = SparseRowMatrix.from_dense(A, BS, device="cpu", quantize="int8")
    np.testing.assert_allclose(
        ps.column_similarities().numpy(),
        ps.dequantize().column_similarities().numpy(), rtol=1e-6, atol=1e-6)
    pr = RowMatrix.create(A, device="cpu", store_dtype=torch.bfloat16)
    got = pr.column_similarities()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _exact(pr.rows.float().numpy()),
                               rtol=1e-5, atol=1e-5)


def test_api_similarities_and_wrapper():
    """The reference's info keys, with its values for the exact path, on
    both types and both paths; a plain tensor is wrapped as a RowMatrix."""
    _, jinfo = _reference("row", 3, 0.0)
    for kind, port in _ports(indicator_matrix()).items():
        for threshold in (0.0, 0.4):
            res = api.similarities(api.SimilarityRequest(
                A=port, threshold=threshold, device="cpu"))
            assert set(res.info) == set(jinfo), kind
            for key in ("iterations", "a_passes", "converged", "degraded"):
                assert res.info[key] == jinfo[key], (kind, key)
            assert res.info["plan"] == ("dimsum" if threshold else "gram")
            assert res.factors[0].shape == (16, 16)
            assert res.request_id.startswith("sim-")
    assert jinfo["plan"] == "gram"
    A = _block_sparse(seed=11)
    sim, info = api.column_similarities(torch.from_numpy(A), device="cpu")
    np.testing.assert_allclose(sim.numpy(), _exact(A), rtol=1e-5, atol=1e-5)
    assert info["a_passes"] == 1 and info["gamma"] is None


def test_similarity_request_validation():
    with pytest.raises(ValueError, match="threshold"):
        api.SimilarityRequest(A=None, threshold=-1.0)
    with pytest.raises(ValueError, match="threshold"):
        api.SimilarityRequest(A=None, threshold=float("nan"))
    with pytest.raises(ValueError, match="deadline_s must be"):
        api.SimilarityRequest(A=None, deadline_s=0.0)
    for extra in (dict(deadline_s=1.0), dict(telemetry=True)):
        req = api.SimilarityRequest(A=None, **extra)
        assert all(getattr(req, k) == v for k, v in extra.items())
    with pytest.raises(ValueError, match="lies on"):
        api.similarities(api.SimilarityRequest(
            A=RowMatrix.create(np.eye(4, dtype=np.float32), device="meta"),
            device="cpu"))


def test_mixed_queue_answers_similarity_requests():
    """Similarity requests on both matrix types ride the FIFO queue as
    one-shots beside a sparse solve group."""
    A = _block_sparse(seed=13)
    pr, ps = _ports(A)["row"], _ports(A)["sparse"]
    rng = np.random.default_rng(14)
    b = (A @ rng.normal(size=45)).astype(np.float32)
    srv = SolverServer(slots=2)
    s0 = srv.submit(api.SolveRequest(A=ps, b=b, max_iters=50, device="cpu"))
    s1 = srv.submit(api.SimilarityRequest(A=ps, threshold=0.4,
                                          device="cpu"))
    s2 = srv.submit(api.SimilarityRequest(A=pr, device="cpu"))
    s3 = srv.submit(api.SolveRequest(A=ps, b=b, max_iters=50, device="cpu"))
    res = srv.run()
    assert len(res) == 4 and srv.stats["oneshot"] == 2
    assert srv.result(s0).info["plan"] == srv.result(s3).info["plan"] \
        == "fused-group"
    assert srv.result(s1).info["plan"] == "dimsum"
    np.testing.assert_allclose(srv.result(s2).factors[0].numpy(), _exact(A),
                               rtol=1e-4, atol=1e-4)
    assert np.diag(srv.result(s1).factors[0].numpy())[7] == 0.0
