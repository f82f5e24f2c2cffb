"""The port's CUDA kernels against their plain torch versions, on the card.

Small shapes that still cover every path of each kernel: ragged m and n,
f32 and bf16 storage, the staged and the unstaged fused_grad, every gemm
block tile.  Skips where there is no CUDA device.  Run on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import fusedgrad, gemm, ops, tsgram

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
    assert ops.launch_counts() == {"fused_grad": 1, "tsgram": 1, "gemm": 1}
