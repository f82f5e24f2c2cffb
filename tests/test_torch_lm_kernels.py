"""The port's LM kernels' plain versions against the reference, on the CPU.

flash_attention (causal and not; MHA, GQA 2:1 and 4:1; a ragged S of 50;
query and key lengths that differ, both ways;
f32 and bf16) and the Mamba1 selective_scan (ragged d and S, N = 8 and 16,
a starting state, the final state) take the same numpy inputs in both
packages.  The reference runs its Pallas kernels in interpret mode
(``force_pallas=True``) and its ``kernels/ref.py`` oracles; the port runs
``ops`` on CPU tensors, which dispatch to the plain torch versions.
Tolerances are tests/test_kernels.py's: f32 rtol 1e-4 / atol 3e-4 for
attention and 1e-4 / 1e-4 for the scan, bf16 3e-2 / 5e-2, and 1e-3 for
the scan against the model's chunked scan (``_mamba1_inner``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JSSM
from repro_torch import convert
from repro_torch.kernels import ops, ref, selective_scan

F32 = dict(rtol=1e-4, atol=3e-4)
BF16 = dict(rtol=3e-2, atol=5e-2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return convert.tensor_from_numpy(a, device="cpu")


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(B, hq, hkv, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    return [rng.normal(size=(B, h, S, D)).astype(npdt)
            for h in (hq, hkv, hkv)]


ATTN_SHAPES = [(1, 2, 2, 64, 16),     # MHA
               (2, 4, 2, 64, 16),     # GQA 2:1
               (1, 8, 2, 128, 32),    # GQA 4:1
               (2, 4, 1, 50, 32)]     # GQA 4:1, ragged S


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,hq,hkv,S,D", ATTN_SHAPES)
def test_flash_attention_matches_reference(B, hq, hkv, S, D, causal, dtype):
    q, k, v = _qkv(B, hq, hkv, S, D, dtype, seed=B * 1000 + hq * 10 + S)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, hq, S, D) and got.dtype == _t(q).dtype
    tol = F32 if dtype == "f32" else BF16
    want = jref.flash_attention_ref(
        jnp.asarray(q).reshape(B * hq, S, D),
        jnp.asarray(k).reshape(B * hkv, S, D),
        jnp.asarray(v).reshape(B * hkv, S, D), causal=causal,
        q_heads_per_kv=hq // hkv).reshape(B, hq, S, D)
    np.testing.assert_allclose(_np32(got), _np32(want), **tol)
    # The Pallas kernel in interpret mode; its wrapper pads K for the
    # causal case only, so the non-causal kernel takes bk = S.
    if causal or S % 8 == 0:
        kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, bq=16,
                                    bk=128 if causal else S,
                                    force_pallas=True)
        np.testing.assert_allclose(_np32(got), _np32(kern), **tol)


def _qkv2(B, hq, hkv, sq, sk, D, dtype, seed):
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    return [rng.normal(size=(B, h, s, D)).astype(npdt)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("sq,sk", [(8, 12), (16, 12), (1, 33), (40, 7)])
def test_flash_attention_query_and_key_lengths_differ(sq, sk, group, causal,
                                                      dtype):
    """Sq ≠ Sk against the reference's default dispatch (its jnp oracle on
    the CPU): the causal mask is top-left, so query rows ≥ Sk see every
    key."""
    B, hkv, D = 2, 2, 16
    q, k, v = _qkv2(B, hkv * group, hkv, sq, sk, D, dtype,
                    seed=sq * 100 + sk + group)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, hkv * group, sq, D)
    assert got.dtype == _t(q).dtype
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_np32(got), _np32(want),
                               **(F32 if dtype == "f32" else BF16))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [40, 200])
def test_flash_attention_lengths_differ_against_the_pallas_kernel(sq,
                                                                  causal):
    """The reference's Pallas kernel (interpret mode) at Sk = 128, a
    multiple of its key tile bk = 128.  Only there: its wrapper pads K to
    bk with zeros, and for causal Sq > Sk with a ragged Sk the rows ≥ Sk
    then attend to the padded keys, which its default dispatch does not."""
    q, k, v = _qkv2(1, 4, 2, sq, 128, 32, "f32", seed=sq)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=16,
                                bk=128, force_pallas=True)
    np.testing.assert_allclose(_np32(got), _np32(kern), **F32)


def test_flash_attention_scale_and_port_oracle():
    q, k, v = _qkv(2, 4, 2, 40, 32, "f32", seed=5)
    got = ops.flash_attention(_t(q), _t(k), _t(v), scale=0.3)
    want = jref.flash_attention_ref(
        jnp.asarray(q).reshape(8, 40, 32), jnp.asarray(k).reshape(4, 40, 32),
        jnp.asarray(v).reshape(4, 40, 32), scale=0.3,
        q_heads_per_kv=2).reshape(2, 4, 40, 32)
    np.testing.assert_allclose(_np32(got), _np32(want), **F32)
    port = ref.flash_attention_ref(_t(q).reshape(8, 40, 32),
                                   _t(k).reshape(4, 40, 32),
                                   _t(v).reshape(4, 40, 32), scale=0.3,
                                   q_heads_per_kv=2)
    np.testing.assert_allclose(_np32(port).reshape(2, 4, 40, 32),
                               _np32(want), **F32)


def test_flash_attention_rejects_tiles_and_nonconforming_heads():
    q, k, v = (_t(a) for a in _qkv(1, 4, 2, 16, 32, "f32", seed=1))
    with pytest.raises(NotImplementedError, match="autotune"):
        ops.flash_attention(q, k, v, bq=16)
    with pytest.raises(NotImplementedError, match="autotune"):
        ops.flash_attention(q, k, v, bk=128)
    with pytest.raises(ValueError, match="conform"):
        ops.flash_attention(q, q[:, :3], q[:, :3])


def _scan_inputs(Bt, S, d, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bt, S, d)).astype(np.float32),
            (np.abs(rng.normal(size=(Bt, S, d))) * 0.1).astype(np.float32),
            (-np.abs(rng.normal(size=(d, N))) - 0.1).astype(np.float32),
            rng.normal(size=(Bt, S, N)).astype(np.float32),
            rng.normal(size=(Bt, S, N)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


SCAN_SHAPES = [(1, 32, 128, 16), (2, 64, 96, 16), (1, 50, 70, 8),
               (3, 17, 130, 16), (2, 45, 40, 8), (1, 33, 129, 8)]


@pytest.mark.parametrize("Bt,S,d,N", SCAN_SHAPES)
def test_selective_scan_matches_reference(Bt, S, d, N):
    args = _scan_inputs(Bt, S, d, N, seed=Bt * 100 + S)
    y, h = ops.selective_scan(*map(_t, args))
    assert y.shape == (Bt, S, d) and h.shape == (Bt, d, N)
    want = jref.selective_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np32(y), _np32(want), rtol=1e-4, atol=1e-4)
    kern = jops.selective_scan(*map(jnp.asarray, args), q=16,
                               force_pallas=True)
    np.testing.assert_allclose(_np32(y), _np32(kern), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [1, 20, 49])
def test_selective_scan_state_carries_across_calls(split):
    """Two calls, the second starting from the first's final state, give
    the one call's y and state."""
    x, dt, A, B, C, D = map(_t, _scan_inputs(2, 50, 70, 16, seed=11))
    y, h = ops.selective_scan(x, dt, A, B, C, D)
    y1, h1 = ops.selective_scan(x[:, :split].contiguous(),
                                dt[:, :split].contiguous(), A,
                                B[:, :split].contiguous(),
                                C[:, :split].contiguous(), D)
    y2, h2 = ops.selective_scan(x[:, split:].contiguous(),
                                dt[:, split:].contiguous(), A,
                                B[:, split:].contiguous(),
                                C[:, split:].contiguous(), D, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h, rtol=1e-5, atol=1e-5)


def test_selective_scan_matches_mamba1_inner():
    """y and the final state equal the reference model's chunked
    associative scan (tests/test_kernels.py's set-up and 1e-3 bound)."""
    rng = np.random.default_rng(7)
    Bt, S, di, N, dt_rank = 2, 32, 64, 16, 8
    x = rng.normal(size=(Bt, S, di)).astype(np.float32)
    p = {"x_proj": (rng.normal(size=(di, dt_rank + 2 * N)) * 0.1
                    ).astype(np.float32),
         "dt_proj": (rng.normal(size=(dt_rank, di)) * 0.1).astype(np.float32),
         "dt_bias": np.zeros((di,), np.float32),
         "A_log": np.log(np.tile(np.arange(1, N + 1), (di, 1))
                         ).astype(np.float32),
         "D": np.ones((di,), np.float32)}
    h0 = np.asarray(rng.normal(size=(Bt, di, N)) * 0.5, np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y_prod, h_prod = JSSM._mamba1_inner(jp, jnp.asarray(x), dt_rank, N,
                                        jnp.asarray(h0), chunk=8)
    dtBC = x @ p["x_proj"]
    dtr, Bm, Cm = np.split(dtBC, [dt_rank, dt_rank + N], -1)
    dt = np.asarray(jax.nn.softplus(dtr @ p["dt_proj"] + p["dt_bias"]))
    A = -np.exp(p["A_log"])
    y, h = ops.selective_scan(*map(_t, (x, dt, A, Bm, Cm, p["D"])),
                              h0=_t(h0))
    np.testing.assert_allclose(_np32(y), _np32(y_prod), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np32(h), _np32(h_prod), rtol=1e-3, atol=1e-3)


def test_selective_scan_plain_is_the_oracle_loop():
    args = list(map(_t, _scan_inputs(2, 9, 24, 8, seed=3)))
    h0 = torch.randn(2, 24, 8, generator=torch.Generator().manual_seed(0))
    y, h = selective_scan.selective_scan_plain(*args, h0=h0)
    # one explicit step at a time
    x, dt, A, B, C, D = args
    hh = h0.clone()
    for t in range(9):
        hh = torch.exp(dt[:, t, :, None] * A) * hh + \
            (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        yt = (hh * C[:, t, None, :]).sum(-1) + D * x[:, t]
        torch.testing.assert_close(y[:, t], yt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, hh, rtol=1e-5, atol=1e-5)


def test_selective_scan_rejects_tiles():
    args = list(map(_t, _scan_inputs(1, 4, 8, 8, seed=0)))
    with pytest.raises(NotImplementedError, match="autotune"):
        ops.selective_scan(*args, q=16)
