"""The port's CUDA kernels against their plain torch versions, on the card.

Small shapes that still cover every path of each kernel: ragged m and n,
f32 and bf16 storage, the staged and the unstaged paths of the
fused_grad_multi kernel (fused_grad is its one-slot launch), slot counts
from 1 to 32, every gemm block tile, one and several randsketch slices and
Q tiles; for the block-sparse kernels every block size from 8 to 128, f32,
bf16 and int8 blocks, ragged block-row counts and nx, a hot column longer
than one rmatmul chunk, and fused_grad_bsr's staged and unstaged paths with
g in shared and in global memory.  Skips where there is no CUDA device.  Run on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import (bsr, fusedgrad, gemm, ops, randsketch,
                                 tsgram)

pytestmark = pytest.mark.cuda

# Normwise relative error: the kernels sum in another order than torch.
TOL = 1e-4
TOL_SUM = 5e-4   # g and the Gram sum over every row


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("m,n", [(1000, 70), (4099, 1024), (300, 6000)])
def test_fused_grad_matches_plain(dev, dtype, loss, m, n):
    g = _gen(dev, m + n)
    a = (torch.randn(m, n, generator=g, device=dev) / n ** 0.5).to(dtype)
    x = torch.randn(n, generator=g, device=dev)
    t = torch.randn(m, generator=g, device=dev)
    if loss == "logistic":
        t = torch.where(t >= 0, 1.0, -1.0)
    elif loss == "poisson":
        t = torch.poisson(torch.ones(m, device=dev), generator=g)
    w = torch.rand(m, generator=g, device=dev)
    w[-(m // 7):] = 0.0
    got = fusedgrad.fused_grad(a, x, t, w, loss=loss, param=0.5)
    want = fusedgrad.fused_grad_plain(a, x, t, w, loss=loss, param=0.5)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= TOL
    assert _rel(got[1], want[1]) <= TOL_SUM
    assert _rel(got[2], want[2]) <= TOL
    again = fusedgrad.fused_grad(a, x, t, w, loss=loss, param=0.5)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _multi_inputs(dev, loss, m, n, k, dtype, seed):
    g = _gen(dev, seed)
    a = (torch.randn(m, n, generator=g, device=dev) / n ** 0.5).to(dtype)
    x = torch.randn(k, n, generator=g, device=dev)
    t = torch.randn(k, m, generator=g, device=dev)
    if loss == "logistic":
        t = torch.where(t >= 0, 1.0, -1.0)
    elif loss == "poisson":
        t = torch.poisson(torch.ones(k, m, device=dev), generator=g)
    w = torch.rand(k, m, generator=g, device=dev)
    w[:, -(m // 7):] = 0.0
    return a, x, t, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("m,n", [(1000, 70), (4099, 1024), (300, 6000)])
def test_fused_grad_multi_matches_plain(dev, dtype, loss, k, m, n):
    a, x, t, w = _multi_inputs(dev, loss, m, n, k, dtype, m + n + k)
    got = fusedgrad.fused_grad_multi(a, x, t, w, loss=loss, param=0.5)
    want = fusedgrad.fused_grad_multi_plain(a, x, t, w, loss=loss,
                                            param=0.5)
    torch.cuda.synchronize()
    assert [v.shape for v in got] == [(k,), (k, n), (k, m)]
    assert _rel(got[0], want[0]) <= TOL
    assert _rel(got[1], want[1]) <= TOL_SUM
    assert _rel(got[2], want[2]) <= TOL
    again = fusedgrad.fused_grad_multi(a, x, t, w, loss=loss, param=0.5)
    for u, v in zip(got, again):
        assert torch.equal(u, v)


def test_fused_grad_multi_takes_32_slots(dev):
    a, x, t, w = _multi_inputs(dev, "huber", 2000, 300, 32, torch.float32, 5)
    got = fusedgrad.fused_grad_multi(a, x, t, w, loss="huber", param=0.5)
    want = fusedgrad.fused_grad_multi_plain(a, x, t, w, loss="huber",
                                            param=0.5)
    torch.cuda.synchronize()
    assert _rel(got[1], want[1]) <= TOL_SUM and _rel(got[2], want[2]) <= TOL
    with pytest.raises(ValueError, match="slots"):
        fusedgrad.fused_grad_multi(a, torch.cat([x, x[:1]]),
                                   torch.cat([t, t[:1]]),
                                   torch.cat([w, w[:1]]), loss="quad")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(4099, 1024, 8), (300, 6000, 4),
                                   (1000, 70, 16)])
def test_fused_grad_multi_slots_are_independent(dev, dtype, m, n, k):
    """Slot 0's (f, g, z) are the same bits whatever the other slots hold,
    and zero-weight slots give exactly zero f and g."""
    a, x, t, w = _multi_inputs(dev, "logistic", m, n, k, dtype, 11)
    f1, g1, z1 = fusedgrad.fused_grad_multi(a, x, t, w, loss="logistic")
    x2, t2, w2 = x.clone(), t.clone(), w.clone()
    x2[1:] = torch.randn_like(x2[1:])
    t2[1:] = -t2[1:]
    w2[1:] = 0.0
    f2, g2, z2 = fusedgrad.fused_grad_multi(a, x2, t2, w2, loss="logistic")
    torch.cuda.synchronize()
    assert torch.equal(f1[0], f2[0]) and torch.equal(g1[0], g2[0])
    assert torch.equal(z1[0], z2[0])
    assert bool((f2[1:] == 0).all()) and bool((g2[1:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(4099, 1024), (300, 6000), (1000, 70),
                                 (257, 16384)])
def test_fused_grad_multi_slot_bits_do_not_depend_on_the_slot_count(
        dev, dtype, m, n):
    """A request gets the same bits alone (k = 1, and fused_grad, its
    one-slot launch) as in a group of 3, 8 or 16: the row blocking and the
    grid follow from A's shape alone."""
    a, x, t, w = _multi_inputs(dev, "huber", m, n, 16, dtype, 13)
    alone = fusedgrad.fused_grad_multi(a, x[:1], t[:1], w[:1], loss="huber",
                                       param=0.5)
    single = fusedgrad.fused_grad(a, x[0], t[0], w[0], loss="huber",
                                  param=0.5)
    torch.cuda.synchronize()
    assert [v.shape for v in single] == [(), (n,), (m,)]
    for u, v in zip(single, alone):
        assert torch.equal(u, v[0])
    for k in (3, 8, 16):
        group = fusedgrad.fused_grad_multi(a, x[:k], t[:k], w[:k],
                                           loss="huber", param=0.5)
        torch.cuda.synchronize()
        for u, v in zip(alone, group):
            assert torch.equal(u[0], v[0]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,r", [(1000, 70, 5), (70000, 300, 26),
                                   (300, 6000, 40), (33, 7, 3)])
def test_randsketch_matches_plain(dev, dtype, m, n, r):
    g = _gen(dev, m + n + r)
    a = torch.randn(m, n, generator=g, device=dev).to(dtype)
    q = torch.randn(m, r, generator=g, device=dev)
    got = randsketch.randsketch(a, q, out_dtype=torch.float32)
    want = randsketch.randsketch_plain(a, q, torch.float32)
    torch.cuda.synchronize()
    assert got.shape == (n, r)
    assert _rel(got, want) <= TOL
    assert torch.equal(got, randsketch.randsketch(a, q,
                                                  out_dtype=torch.float32))
    assert randsketch.randsketch(a, q).dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(1000, 70), (5003, 130), (64, 200)])
def test_tsgram_matches_plain(dev, dtype, out_dtype, m, n):
    a = torch.randn(m, n, generator=_gen(dev, m), device=dev).to(dtype)
    got = tsgram.tsgram(a, out_dtype=out_dtype)
    want = tsgram.tsgram_plain(a, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert _rel(got, want) <= (TOL_SUM if out_dtype == torch.float32 else 1e-2)
    assert torch.equal(got, got.T)
    assert torch.equal(got, tsgram.tsgram(a, out_dtype=out_dtype))


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1000, 70, 5), (777, 64, 20),
                                   (513, 100, 64), (300, 33, 130)])
def test_gemm_matches_plain(dev, a_dtype, b_dtype, m, k, n):
    g = _gen(dev, m + k + n)
    a = torch.randn(m, k, generator=g, device=dev).to(a_dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(b_dtype)
    got = gemm.gemm(a, b, out_dtype=torch.float32)
    want = gemm.gemm_plain(a, b, torch.float32)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL
    assert gemm.gemm(a, b).dtype == a_dtype


def test_ops_route_cuda_tensors_to_the_kernels(dev):
    ops.reset_launch_counts()
    a = torch.randn(200, 30, device=dev)
    x = torch.randn(30, device=dev)
    t, w = torch.randn(200, device=dev), torch.ones(200, device=dev)
    ops.fused_grad(a, x, t, w, loss="quad")
    ops.tsgram(a)
    ops.gemm(a, x[:, None])
    ops.fused_grad_multi(a, x[None], t[None], w[None], loss="quad")
    ops.randsketch(a, a[:, :3])
    b = _random_bell(dev, 5, 4, 2, 8, "f32", 1)
    xb, ub = torch.randn(32, device=dev), torch.randn(40, device=dev)
    ops.bsr_matvec(b, xb)
    ops.bsr_matmul(b, xb[:, None])
    ops.bsr_rmatmul(b, ub[:, None])
    ops.fused_grad_bsr(b, xb, ub, torch.ones_like(ub), loss="quad")
    assert ops.launch_counts() == {"fused_grad": 1, "tsgram": 1, "gemm": 1,
                                   "fused_grad_multi": 1, "randsketch": 1,
                                   "bsr_matvec": 1, "bsr_matmul": 1,
                                   "bsr_rmatmul": 1, "fused_grad_bsr": 1}
    # int8 blocks compose bsr_matvec and bsr_rmatmul, as the reference does.
    ops.reset_launch_counts()
    q = b.quantize_int8()
    f, g, z = ops.fused_grad_bsr(q, xb, ub, torch.ones_like(ub), loss="quad")
    want = fusedgrad.fused_grad_bsr_plain(q, xb, ub, torch.ones_like(ub),
                                          loss="quad")
    torch.cuda.synchronize()
    assert _rel(g, want[1]) <= TOL_SUM and _rel(z, want[2]) <= TOL
    counts = ops.launch_counts()
    assert (counts["bsr_matvec"], counts["bsr_rmatmul"],
            counts["fused_grad_bsr"]) == (1, 1, 0)


# -- block-sparse kernels ---------------------------------------------------

def _random_bell(dev, nbr, nbc, ell, bs, storage, seed, hot=None):
    """A BlockELL of Gaussian blocks, each block-row's `ell` columns drawn
    without replacement and sorted; with `hot`, every block-row holds that
    column."""
    g = _gen(dev, seed)
    keys = torch.rand(nbr, nbc, generator=g, device=dev)
    if hot is not None:
        keys[:, hot] = -1.0
    cols = torch.sort(torch.argsort(keys, dim=1)[:, :ell], dim=1).values
    data = torch.randn(nbr, ell, bs, bs, generator=g, device=dev) / bs ** 0.5
    a = bsr.BlockELL(data, cols.to(torch.int32).contiguous(),
                     (nbr * bs, nbc * bs))
    if storage == "bf16":
        return bsr.BlockELL(data.to(torch.bfloat16), a.cols, a.shape)
    return a.quantize_int8() if storage == "int8" else a


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("nbr,nbc,ell,nx", [(37, 13, 5, 1), (70, 9, 3, 16),
                                            (11, 6, 6, 33)])
def test_bsr_kernels_match_plain(dev, storage, bs, nbr, nbc, ell, nx):
    a = _random_bell(dev, nbr, nbc, ell, bs, storage, nbr + bs)
    m, n = a.shape
    g = _gen(dev, nx)
    x = torch.randn(n, generator=g, device=dev)
    X = torch.randn(n, nx, generator=g, device=dev)
    U = torch.randn(m, nx, generator=g, device=dev)
    for kern, plain, arg, tol in (
            (bsr.bsr_matvec, bsr.bsr_matvec_plain, x, TOL),
            (bsr.bsr_matmul, bsr.bsr_matmul_plain, X, TOL),
            (bsr.bsr_rmatmul, bsr.bsr_rmatmul_plain, U, TOL_SUM)):
        got = kern(a, arg)
        want = plain(a, arg)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got, want) <= tol, kern.__name__
        assert torch.equal(got, kern(a, arg)), kern.__name__


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_bsr_rmatmul_hot_column(dev, storage):
    """Every block-row holds block column 3: its list is 500 slots, 16
    chunks of the gather, summed in chunk order."""
    a = _random_bell(dev, 500, 20, 4, 16, storage, 9, hot=3)
    idx = a.column_index()
    assert int(idx.col_chunks[4] - idx.col_chunks[3]) == \
        -(-500 // bsr.RMATMUL_CHUNK)
    for nx in (1, 16):
        X = torch.randn(a.shape[0], nx, generator=_gen(dev, nx), device=dev)
        got = bsr.bsr_rmatmul(a, X)
        want = bsr.bsr_rmatmul_plain(a, X)
        torch.cuda.synchronize()
        assert _rel(got, want) <= TOL_SUM
        assert torch.equal(got, bsr.bsr_rmatmul(a, X))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("bs,nbr,nbc,ell", [(8, 301, 40, 7), (32, 150, 16, 16),
                                            (128, 9, 5, 2), (8, 40, 5000, 4),
                                            (64, 33, 700, 3),
                                            (128, 5, 400, 2)])
def test_fused_grad_bsr_matches_plain(dev, dtype, loss, bs, nbr, nbc, ell):
    """Staged block-rows (up to 64 KB of f32) and unstaged ones (bs = 128);
    g in shared memory, and in global memory where n·4 bytes do not fit
    beside the tile (n = 40000, 44800 and 51200)."""
    a = _random_bell(dev, nbr, nbc, ell, bs, dtype, nbr + ell)
    m, n = a.shape
    g = _gen(dev, m)
    x = torch.randn(n, generator=g, device=dev) / ell ** 0.5
    t = torch.randn(m, generator=g, device=dev)
    if loss == "logistic":
        t = torch.where(t >= 0, 1.0, -1.0)
    elif loss == "poisson":
        t = torch.poisson(torch.ones(m, device=dev), generator=g)
    w = torch.rand(m, generator=g, device=dev)
    w[-(m // 7):] = 0.0
    got = fusedgrad.fused_grad_bsr(a, x, t, w, loss=loss, param=0.5)
    want = fusedgrad.fused_grad_bsr_plain(a, x, t, w, loss=loss, param=0.5)
    torch.cuda.synchronize()
    assert [v.shape for v in got] == [(), (n,), (m,)]
    assert _rel(got[0], want[0]) <= TOL
    assert _rel(got[1], want[1]) <= TOL_SUM
    assert _rel(got[2], want[2]) <= TOL
    again = fusedgrad.fused_grad_bsr(a, x, t, w, loss=loss, param=0.5)
    for u, v in zip(got, again):
        assert torch.equal(u, v)
