"""fp8 storage through randsketch, sketch, project and the chunked
products, against the reference on the CPU.

The same numpy inputs (seeded) go to both packages:

  * randsketch's plain version on float8_e4m3fn and float8_e5m2 A, with
    Q in f32 or in A's type, against the reference's CPU dispatch and its
    Pallas kernel in interpret mode; an fp8 B within one step;
  * the kernel's staging arithmetic (randsketch.window) on a column
    segment of a wider matrix, the chunked gradient's operand: every
    element found, every piece inside the allocation;
  * RowMatrix.sketch on both fp8 types: the port's Ω (drawn in f32, cast
    to A's type) carried across by convert into the reference's
    ``a @ omega``, Y within one step of A's type; RowMatrix.project on
    both, Q in f32 and in A's type;
  * one two-rank gloo mesh (rank body tests/torch_cluster_cases.py
    chunked_rank), for bf16, e4m3 and e5m2 strips: gram(chunks=2) and
    fused_grad(chunks=2) against one device's eager result and the mesh's
    eager, within the reference tests' tolerances (the Gram 1e-5/1e-3,
    f 1e-5, g and z 1e-4);
  * the bf16 chunked gradient's f32 residual: 4096 × 100 bf16 rows, a
    quad residual, two segments, g within 1e-4 normwise of eager and of
    float64 (rounding r to bf16 and summing in bf16 put it 2.5e-3 off).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_cluster_cases as C
from fp8_types import TYPE_E4M3, TYPE_E5M2
from repro.core.distmat import RowMatrix as JRowMatrix
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.distmat import RowMatrix
from repro_torch.core.tfocs.smooth import SmoothQuad
from repro_torch.kernels import autotune as at
from repro_torch.kernels import dtypes, ops, randsketch
from repro_torch.launch import mesh as tmesh

FP8 = {t.name: t for t in (TYPE_E4M3, TYPE_E5M2)}
M = 300
WIDTHS = (64, 100)
TOL_F, TOL_GZ, TOL_GRAM = 1e-5, 1e-4, (1e-5, 1e-3)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    at.reset()
    yield
    at.reset()
    torch.set_num_threads(threads)


def _rows(n: int, m: int = M, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + n).normal(size=(m, n)) \
        .astype(np.float32)


# -- randsketch's plain version ------------------------------------------------

@pytest.mark.parametrize("q_in", ["float32", "fp8"])
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", sorted(FP8))
def test_randsketch_plain_matches_reference_and_its_kernel(name, n, q_in):
    """B = AᵀQ on fp8 A (and Q): the plain version widens exactly and
    sums in f32, as the reference's dispatch and its Pallas kernel (which
    upcasts both in VMEM) do; B in A's type within one step."""
    t8 = FP8[name]
    tdt, jdt = t8.torch, t8.jax
    A = _rows(n)
    Q = np.random.default_rng(n).normal(size=(M, 26)).astype(np.float32)
    ja, jq = jnp.asarray(A).astype(jdt), jnp.asarray(Q)
    a, q = dtypes.cast(torch.from_numpy(A), tdt), torch.from_numpy(Q)
    if q_in == "fp8":
        jq, q = jq.astype(jdt), dtypes.cast(q, tdt)
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
    got = ops.randsketch(a, q, out_dtype=torch.float32).numpy()
    for force in (False, True):
        want = np.asarray(jops.randsketch(ja, jq, out_dtype=jnp.float32,
                                          force_pallas=force))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    exact = a.double().numpy().T @ q.double().numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
    b8 = ops.randsketch(a, q)
    assert b8.dtype == tdt
    assert t8.one_step(b8.float().numpy(), np.asarray(
        jops.randsketch(ja, jq)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e5m2])
@pytest.mark.parametrize("width,s0,s1", [(100, 0, 50), (100, 50, 100),
                                         (1024, 512, 1024), (37, 3, 20)])
def test_randsketch_window_takes_a_column_segment(dtype, width, s0, s1):
    """The kernel's staging (randsketch.window) on A[:, s0:s1] of a
    (m × width) matrix at its row stride: for every row and column tile,
    the 16-byte pieces copied hold an element of the segment, lie inside
    the allocation, and element shift + j of the copy is A[row, j0 + j];
    the plain version of the segment equals that of its copy."""
    rng = np.random.default_rng(width + s0)
    m = 9
    esize = torch.empty((), dtype=dtype).element_size()
    vec = randsketch.PIECE_BYTES // esize
    codes = torch.from_numpy(rng.permutation(1 << 16)[:m * width]
                             .astype(np.int32))
    whole = codes.reshape(m, width)
    seg = whole[:, s0:s1]
    n, lda = s1 - s0, whole.stride(0)
    p = (s0 * esize) % 16 // esize      # the allocation starts aligned
    base = s0 - p
    for row in range(m):
        for j0 in range(0, n, randsketch.TILE_N):
            first, pieces, shift = randsketch.window(p, n, vec, row, j0,
                                                     lda=lda)
            length = min(randsketch.TILE_N, n - j0)
            lo, hi = base + first * vec, base + (first + pieces) * vec
            assert lo >= 0 and hi <= -(-m * width // vec) * vec
            at_ = s0 + row * lda + j0
            assert lo <= at_ < lo + vec and hi - vec < at_ + length <= hi
            flat = whole.reshape(-1)
            assert torch.equal(flat[lo + shift:lo + shift + length],
                               seg[row, j0:j0 + length])
    a = dtypes.cast(torch.from_numpy(rng.normal(size=(m, width))
                                     .astype(np.float32)), dtype)
    q = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    view = a[:, s0:s1]
    assert torch.equal(randsketch.randsketch_plain(view, q, torch.float32),
                       randsketch.randsketch_plain(view.contiguous(), q,
                                                   torch.float32))


# -- sketch and project ----------------------------------------------------------

@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", sorted(FP8))
def test_sketch_matches_reference(name, n):
    """Y = A Ω in A's type: the port draws Ω in f32 from its generator and
    casts it to A's type (the reference draws it in A's type from its own
    key), so Ω's fp8 values are carried across by convert and multiplied
    by the reference's ``a @ omega``; every entry within one step of A's
    type of the reference's (an e4m3 step is 2^-3 of the value, an e5m2
    step 2^-2)."""
    t8 = FP8[name]
    tdt, jdt = t8.torch, t8.jax
    A = _rows(n, seed=4)
    rm = RowMatrix.create(A, device="cpu", store_dtype=tdt)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=jdt)
    r, seed = 7, 3
    y = rm.sketch(r, seed=seed)
    assert y.rows.dtype == tdt and y.shape == (M, r)
    gen = torch.Generator().manual_seed(seed)
    omega = dtypes.cast(torch.randn((n, r), generator=gen), tdt)
    om = omega.view(torch.uint8).numpy().view(getattr(ml_dtypes, name))
    assert convert.tensor_from_numpy(om, device="cpu").dtype == tdt
    want = np.asarray(jrm.rows @ jnp.asarray(om))
    assert want.dtype == getattr(ml_dtypes, name)
    assert t8.one_step(y.rows.float().numpy(), want[:M].astype(np.float32))
    # Every rank draws the same Ω: the same seed, the same Y.
    assert torch.equal(rm.sketch(r, seed=seed).rows.view(torch.uint8),
                       y.rows.view(torch.uint8))


@pytest.mark.parametrize("q_in", ["float32", "fp8"])
@pytest.mark.parametrize("name", sorted(FP8))
def test_project_matches_reference(name, q_in):
    """B = AᵀQ through randsketch on fp8 A, Q a row-conforming RowMatrix
    in f32 or in A's type, against the reference's project."""
    tdt, jdt = FP8[name].torch, FP8[name].jax
    A = _rows(100, seed=5)
    Q = np.random.default_rng(8).normal(size=(M, 12)).astype(np.float32)
    rm = RowMatrix.create(A, device="cpu", store_dtype=tdt)
    jrm = JRowMatrix.create(jnp.asarray(A), store_dtype=jdt)
    qd = (tdt, jdt) if q_in == "fp8" else (None, None)
    tq = RowMatrix.create(Q, device="cpu", store_dtype=qd[0])
    jq = JRowMatrix.create(jnp.asarray(Q), store_dtype=qd[1])
    got = rm.project(tq)
    assert got.dtype == torch.float32 and got.shape == (100, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrm.project(jq)),
                               rtol=1e-5, atol=1e-4)


# -- the chunked products on a two-rank mesh -------------------------------------

def _mesh_data() -> dict:
    rng = np.random.default_rng(21)
    A = rng.normal(size=(101, 64)).astype(np.float32)
    x = (rng.normal(size=64) / 8).astype(np.float32)
    b = rng.normal(size=101).astype(np.float32)
    y = np.where(rng.normal(size=101) > 0, 1.0, -1.0).astype(np.float32)
    F = rng.normal(size=(4096, 100)).astype(np.float32)
    xF = (rng.normal(size=100) / 10).astype(np.float32)
    bF = (F @ xF + 0.05 * rng.normal(size=4096)).astype(np.float32)
    return dict(A=A, b=b, y=y, x=x, F=F, bF=bF, xF=xF)


DATA = _mesh_data()


@pytest.fixture(scope="module")
def ranks():
    d = DATA
    return tmesh.spawn(C.chunked_rank, 2,
                       args=(d["A"], d["b"], d["y"], d["x"], d["F"],
                             d["bF"], d["xF"]),
                       backend="gloo", device="cpu", timeout_s=60,
                       deadline_s=180)


def _one_device(name: str) -> RowMatrix:
    return RowMatrix.create(DATA["A"], device="cpu",
                            store_dtype=getattr(torch, name))


@pytest.mark.parametrize("name", C.CHUNKED_STORE)
def test_chunked_gram_on_a_mesh_matches_one_rank(ranks, name):
    """gram(chunks=2) on the strips (one randsketch launch of Aᵀ·A[:, seg]
    a segment, Q the segment in A's type) within the Gram's tolerance of
    one device's eager tsgram and of the mesh's eager Gram; the same bits
    on both ranks."""
    want = _one_device(name).gram().numpy()
    for r in ranks:
        assert r[f"{name}_dtype"] == str(getattr(torch, name))
        got = r[f"{name}_gram_2"].numpy()
        np.testing.assert_allclose(got, want, rtol=TOL_GRAM[0],
                                   atol=TOL_GRAM[1])
        np.testing.assert_allclose(got, r[f"{name}_gram_1"].numpy(),
                                   rtol=TOL_GRAM[0], atol=TOL_GRAM[1])
    assert torch.equal(ranks[0][f"{name}_gram_2"], ranks[1][f"{name}_gram_2"])


@pytest.mark.parametrize("loss", C.CHUNKED_LOSSES)
@pytest.mark.parametrize("name", C.CHUNKED_STORE)
def test_chunked_fused_grad_on_a_mesh_matches_one_rank(ranks, name, loss):
    """fused_grad(chunks=2) on the strips (the fused pass, then A[:, seg]ᵀr
    a segment through randsketch on the strip's segment, r in f32) within
    the reference tests' tolerances of one device's eager pass and of the
    mesh's eager pass: f 1e-5, g and z 1e-4."""
    d = DATA
    sep = C.smooth_for(loss, torch.as_tensor(C.targets(loss, d["b"],
                                                       d["y"])))
    f, g, z = _one_device(name).fused_grad(torch.from_numpy(d["x"]), sep)
    for r in ranks:
        for c in (2, 1):
            fc, gc, _ = r[f"{name}_{loss}_{c}"]
            np.testing.assert_allclose(fc.numpy(), f.numpy(), rtol=TOL_F,
                                       atol=TOL_F)
            np.testing.assert_allclose(gc.numpy(), g.numpy(), rtol=TOL_GZ,
                                       atol=TOL_GZ)
    z2 = torch.cat([r[f"{name}_{loss}_2"][2] for r in ranks])[:101]
    np.testing.assert_allclose(z2.numpy(), z.numpy(), rtol=TOL_GZ,
                               atol=TOL_GZ)


def test_bf16_chunked_gradient_keeps_its_residual_in_f32(ranks):
    """bf16 storage, quad residual, two segments on two ranks: g within
    1e-4 normwise of the eager pass on the same strips and of float64 on
    the bf16 values.  The reference keeps r in f32 for every storage but
    f32 and sums in f32; rounding r to bf16 and taking a bf16 product put
    the chunked g 2.5e-3 off."""
    d = DATA
    F64 = np.asarray(jnp.asarray(d["F"]).astype(jnp.bfloat16)
                     .astype(jnp.float32)).astype(np.float64)
    g64 = F64.T @ (F64 @ d["xF"].astype(np.float64) - d["bF"])

    def rel(got, want):
        got = np.asarray(got, np.float64)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    for r in ranks:
        g2, g1 = r["fault_2"][1].numpy(), r["fault_1"][1].numpy()
        assert g2.dtype == np.float32
        assert rel(g2, g1.astype(np.float64)) <= 1e-4
        assert rel(g2, g64) <= 1e-4
        assert rel(g1, g64) <= 1e-4
