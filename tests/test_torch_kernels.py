"""The port's kernel modules against the JAX reference, on the CPU.

Each port kernel's CPU path (its plain torch version) is held against the
JAX wrapper run through the Pallas kernel in interpret mode
(``force_pallas=True``) and against the port's own oracles in
``repro_torch.kernels.ref``.  Inputs come from a numpy seed; ragged m and n
exercise the edges the TPU wrappers pad.  Tolerances are the reference's
own (tests/test_fusedgrad.py): 1e-5 for f, 1e-4 for g and z.  bf16 storage
is upcast to f32 before any arithmetic on both sides, so it is held to the
same tolerances.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import fusedgrad as jfg
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import (_build, flash_attention, fusedgrad, gemm,
                                 ops, randsketch, ref, selective_scan, tsgram)

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
SHAPES = [(96, 48), (130, 70)]       # multi-tile, and ragged in m and n


def _t(arr):
    return convert.tensor_from_numpy(arr, device="cpu")


def _targets(rng, loss, m):
    if loss == "logistic":
        return np.where(rng.random(m) < 0.5, -1.0, 1.0).astype(np.float32)
    if loss == "poisson":
        return rng.poisson(1.0, m).astype(np.float32)
    return rng.normal(size=m).astype(np.float32)


def _fused_inputs(m, n, dtype, loss, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(DTYPES[dtype])
    x = rng.normal(size=n).astype(np.float32)
    t = _targets(rng, loss, m)
    w = rng.random(m).astype(np.float32)
    w[-(m // 5):] = 0.0                # a zero-weight tail, as padding rows
    return a, x, t, w


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("m,n", SHAPES)
def test_fused_grad_matches_pallas_and_oracle(dtype, loss, m, n):
    a, x, t, w = _fused_inputs(m, n, dtype, loss, seed=m + n)
    jf, jg, jz = jops.fused_grad(jnp.asarray(a), jnp.asarray(x),
                                 jnp.asarray(t), jnp.asarray(w), loss=loss,
                                 param=0.5, force_pallas=True)
    f, g, z = ops.fused_grad(_t(a), _t(x), _t(t), _t(w), loss=loss,
                             param=0.5)
    assert f.dtype == z.dtype == torch.float32 and g.dtype == torch.float32
    assert f.shape == () and g.shape == (n,) and z.shape == (m,)
    _close(f, jf, 1e-5)
    _close(g, jg, 1e-4)
    _close(z, jz, 1e-4)
    rf, rg, rz = ref.fused_grad_ref(_t(a), _t(x), _t(t), _t(w), loss=loss,
                                    param=0.5)
    _close(f, rf, 1e-5)
    _close(g, rg, 1e-4)
    _close(z, rz, 1e-4)


@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
def test_row_loss_elem_matches_reference(loss):
    rng = np.random.default_rng(7)
    z = (2.0 * rng.normal(size=257)).astype(np.float32)
    t, w = _targets(rng, loss, 257), rng.random(257).astype(np.float32)
    jle, jr = jfg.row_loss_elem(jnp.asarray(z), jnp.asarray(t),
                                jnp.asarray(w), loss, 0.7)
    le, r = fusedgrad.row_loss_elem(_t(z), _t(t), _t(w), loss, 0.7)
    _close(le, jle, 1e-6)
    _close(r, jr, 1e-6)
    f, r2 = fusedgrad.row_loss_grad(_t(z), _t(t), _t(w), loss, 0.7)
    _close(f, jnp.sum(jle), 1e-5)
    assert torch.equal(r, r2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n", SHAPES)
def test_tsgram_matches_pallas_and_oracle(dtype, m, n):
    rng = np.random.default_rng(m * n)
    a = rng.normal(size=(m, n)).astype(DTYPES[dtype])
    want = jops.tsgram(jnp.asarray(a), out_dtype=jnp.float32,
                       force_pallas=True)
    got = ops.tsgram(_t(a), out_dtype=torch.float32)
    assert got.shape == (n, n) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    _close(got, ref.tsgram_ref(_t(a), torch.float32), 1e-4)
    # The default output type is the storage type, as in the reference.
    assert ops.tsgram(_t(a)).dtype == _t(a).dtype


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(130, 70, 5), (96, 48, 16), (200, 33, 40)])
def test_gemm_matches_pallas_and_oracle(dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype(DTYPES[dtype])
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = jops.gemm(jnp.asarray(a), jnp.asarray(b), out_dtype=jnp.float32,
                     force_pallas=True)
    got = ops.gemm(_t(a), _t(b), out_dtype=torch.float32)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    _close(got, ref.gemm_ref(_t(a), _t(b), torch.float32), 1e-4)
    assert ops.gemm(_t(a), _t(b)).dtype == _t(a).dtype


def test_fused_grad_returns_g_in_x_dtype():
    a, x, t, w = _fused_inputs(40, 12, "f32", "quad", seed=1)
    _, g, z = ops.fused_grad(_t(a), _t(x).double(), _t(t), _t(w),
                             loss="quad")
    assert g.dtype == torch.float64 and z.dtype == torch.float32


def test_ops_validate_loss_and_devices():
    a, x, t, w = _fused_inputs(40, 12, "f32", "quad", seed=2)
    with pytest.raises(ValueError, match="loss must be one of"):
        ops.fused_grad(_t(a), _t(x), _t(t), _t(w), loss="hinge")
    with pytest.raises(ValueError, match="loss must be one of"):
        jops.fused_grad(jnp.asarray(a), jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(w), loss="hinge")
    meta = torch.empty(12, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ops.gemm(_t(a), meta[:, None])


def test_cpu_tensors_never_reach_the_kernels():
    """On the CPU the wrappers take the plain version; the kernel wrappers
    themselves refuse CPU tensors instead of computing on them."""
    ops.reset_launch_counts()
    a, x, t, w = _fused_inputs(40, 12, "f32", "quad", seed=3)
    ops.fused_grad(_t(a), _t(x), _t(t), _t(w), loss="quad")
    ops.tsgram(_t(a))
    ops.gemm(_t(a), _t(x)[:, None])
    X, T, W = _t(x)[None], _t(t)[None], _t(w)[None]
    ops.fused_grad_multi(_t(a), X, T, W, loss="quad")
    ops.randsketch(_t(a), _t(a)[:, :3])
    q = torch.randn(1, 2, 5, 32)
    ops.flash_attention(q, q, q)
    s = torch.rand(1, 5, 12)
    scan = (s, s, -torch.rand(12, 8), torch.randn(1, 5, 8),
            torch.randn(1, 5, 8), torch.randn(12))
    ops.selective_scan(*scan)
    assert ops.launch_counts() == {"fused_grad": 0, "tsgram": 0, "gemm": 0,
                                   "fused_grad_multi": 0, "randsketch": 0,
                                   "bsr_matvec": 0, "bsr_matmul": 0,
                                   "bsr_rmatmul": 0, "fused_grad_bsr": 0,
                                   "fused_grad_bsr_multi": 0,
                                   "flash_attention": 0,
                                   "selective_scan": 0}
    for call in (lambda: fusedgrad.fused_grad(_t(a), _t(x), _t(t), _t(w),
                                              loss="quad"),
                 lambda: tsgram.tsgram(_t(a)),
                 lambda: gemm.gemm(_t(a), _t(x)[:, None]),
                 lambda: fusedgrad.fused_grad_multi(_t(a), X, T, W,
                                                    loss="quad"),
                 lambda: randsketch.randsketch(_t(a), _t(a)[:, :3]),
                 lambda: flash_attention.flash_attention(q[0], q[0], q[0]),
                 lambda: selective_scan.selective_scan(*scan)):
        with pytest.raises(ValueError, match="need CUDA tensors"):
            call()


def test_plain_versions_agree_with_oracles():
    a, x, t, w = _fused_inputs(64, 20, "bf16", "huber", seed=4)
    got = fusedgrad.fused_grad_plain(_t(a), _t(x), _t(t), _t(w),
                                     loss="huber", param=0.3)
    want = ref.fused_grad_ref(_t(a), _t(x), _t(t), _t(w), loss="huber",
                              param=0.3)
    for u, v in zip(got, want):
        _close(u, v, 1e-5)
    _close(tsgram.tsgram_plain(_t(a), torch.float32),
           ref.tsgram_ref(_t(a), torch.float32), 1e-5)
    _close(gemm.gemm_plain(_t(a), _t(a).T, torch.float32),
           ref.gemm_ref(_t(a), _t(a).T, torch.float32), 1e-5)


def test_tsgram_slicing_fills_the_card_and_bounds_partials():
    tiles = lambda n: -(-n // tsgram.TILE)
    # Main-path shape: 16 x 16 tiles -> 136 upper-triangle tiles, sliced
    # so that tiles x slices reaches four blocks per SM of a 132-SM card
    # and no slice sums more than SLICE_ROWS rows.
    slices, rows = tsgram.slicing(2 ** 21, 1024, 132)
    pairs = tiles(1024) * (tiles(1024) + 1) // 2
    assert pairs * slices >= tsgram.BLOCKS_PER_SM * 132
    assert slices * rows >= 2 ** 21 and rows % tsgram.CHUNK == 0
    assert rows <= tsgram.SLICE_ROWS
    assert slices * 1024 * 1024 * 4 <= tsgram.PARTIALS_BYTES
    # Wide n: the tiles alone fill the card, so one slice.
    assert tsgram.slicing(4096, 8192, 132)[0] == 1
    # Few rows: never more slices than row chunks, none empty.
    s, r = tsgram.slicing(20, 64, 132)
    assert s * r >= 20 and (s - 1) * r < 20


def test_build_checks_refuse_other_devices_and_types():
    with pytest.raises(ValueError, match="need CUDA tensors"):
        _build.check_device(torch.zeros(2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.dtype_code(torch.zeros(2, dtype=torch.float16), "a")
    assert _build.library_path().parent == _build.BUILD_DIR
