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
@pytest.mark.parametrize("m,k,n", [(130, 70, 5), (96, 48, 16), (200, 33, 40),
                                   (97, 1, 16), (1003, 26, 26)])
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


@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 26, 32, 33, 130])
def test_gemm_tile_width_fits_n(n):
    """An output tile holds 8, 16 or 32 columns (1, 2 or 4 n8 mma tiles):
    the narrowest that holds N up to 32, else 32 and several tiles."""
    w = gemm.tile_width(n)
    assert w == min(x for x in (8, 16, 32) if x >= min(n, 32))


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
    pairs = tiles(1024) * (tiles(1024) + 1) // 2
    # Main-path shape: 8 x 8 tiles of 128 -> 36 upper-triangle pairs; 33
    # slices of whole 32-row stages make 1188 blocks, 9 whole waves of one
    # block an SM on a 132-SM card, and no slice sums more than SLICE_ROWS.
    slices, rows = tsgram.slicing(2 ** 21, 1024, 132)
    assert (pairs, slices, rows) == (36, 33, 63552)
    assert pairs * slices % 132 == 0
    assert slices * rows >= 2 ** 21 > (slices - 1) * rows
    assert rows % tsgram.STAGE_ROWS == 0 and rows <= tsgram.SLICE_ROWS
    assert slices * 1024 * 1024 * 4 <= tsgram.PARTIALS_BYTES
    # S_sim's dense copy (2^20 x 4096): 528 pairs fill 4 waves alone, and
    # the partials cap (four 64 MB slices) wins over SLICE_ROWS.
    assert tsgram.slicing(2 ** 20, 4096, 132) == (4, 2 ** 18)
    # Wide n: one slice's partials fill the cap.
    assert tsgram.slicing(4096, 8192, 132)[0] == 1
    # Few rows: never more slices than row stages, none empty.
    s, r = tsgram.slicing(20, 64, 132)
    assert s * r >= 20 and (s - 1) * r < 20


@pytest.mark.parametrize("vec", [4, 8])
def test_tsgram_k_order_reads_each_row_once_with_one_shift_a_load(vec):
    """The kernel's K order (tsgram.cu, "K order"): each k-step's rows, in
    K order, cover a 32-row stage once; the four rows one shared load of a
    warp reads (one a lane group t) have the same shift for any start p and
    width n, and sit in adjacent staging slots, so the load touches 32
    distinct banks."""
    steps = tsgram.kstep_rows(vec)
    assert sorted(r for rows in steps for r in rows) == list(
        range(tsgram.STAGE_ROWS))
    assert sorted(tsgram.slot(k, vec) for k in range(tsgram.STAGE_ROWS)) \
        == list(range(tsgram.STAGE_ROWS))
    for rows in steps:
        if vec == 4:     # m16n8k8: lane group t reads K indices t and t + 4
            loads = [[rows[t + 4 * h] for t in range(4)] for h in range(2)]
        else:            # m16n8k16: K indices 2t + b + 8h
            loads = [[rows[2 * t + b + 8 * h] for t in range(4)]
                     for b in range(2) for h in range(2)]
        for load in loads:
            for n in (1, 7, 70, 1023, 1024, 4097):
                for p in range(vec):
                    assert len({(p + k * n) % vec for k in load}) == 1
            slots = sorted(tsgram.slot(k, vec) for k in load)
            assert slots == list(range(slots[0], slots[0] + 4))


@pytest.mark.parametrize("vec", [4, 8])
@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 1023, 4096])
def test_tsgram_window_covers_the_tile(vec, n):
    """The kernel copies, for each row and column tile, the 16-byte pieces
    from the one that holds the segment's first element, as many as the
    tile's width spans, and reads back element c at shift + c: the copy
    covers every column a fragment reads, each piece it reads from memory
    holds at least one element of the segment, and where the tile reaches
    past A's last column it reads nothing past that column (the rest of
    the tile arrives as zeros)."""
    for p in range(vec):
        for row in (0, 1, 2, 5, 1000):
            for c0 in range(0, n, tsgram.TILE):
                first, pieces, shift, end = tsgram.window(p, n, vec, row, c0)
                assert first * vec + shift == p + row * n + c0
                assert 0 <= shift < vec
                assert pieces * vec >= shift + tsgram.TILE
                assert pieces * vec <= shift + tsgram.TILE + vec - 1
                if c0 + tsgram.TILE > n:
                    assert end - shift == n - c0
                else:
                    assert end == pieces * vec
                read = [pc for pc in range(pieces) if end > pc * vec]
                assert all(pc * vec < shift + min(tsgram.TILE, n - c0)
                           for pc in read)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared, as the kernel splits an
    operand and as the mma reads a .tf32 operand."""
    return (x.contiguous().view(torch.int32) & ~((1 << 13) - 1)).view(
        torch.float32)


def _tf32_gram(a: torch.Tensor, products: int, rows: int) -> torch.Tensor:
    """AᵀA with the kernel's f32 arithmetic in plain torch: each operand
    split into a TF32 high part and the rest (read cut to TF32), the parts'
    products (exact in f32) summed from zero over each run of `rows` rows,
    the runs added to an f32 total.  products = 3 keeps lo·hi, hi·lo and
    hi·hi (3xTF32), 1 keeps hi·hi."""
    hi = _tf32(a)
    lo = _tf32(a - hi)
    total = torch.zeros(a.shape[1], a.shape[1])
    for k0 in range(0, a.shape[0], rows):
        h, l = hi[k0:k0 + rows], lo[k0:k0 + rows]
        acc = h.T @ h
        if products == 3:
            acc = l.T @ h + h.T @ l + acc
        total = total + acc
    return total


def test_three_tf32_products_keep_the_gram_at_f32_accuracy():
    """Why tsgram meets TOL["tsgram"] (5e-4) on the tensor cores: 3xTF32
    with 64-row runs (the kernel's kSumRows) stays within 1e-5 of float64,
    normwise, where one TF32 product does not; bf16 storage is exact in one
    bf16 product."""
    rng = np.random.default_rng(64)
    a = torch.from_numpy(rng.normal(size=(4096, 40)).astype(np.float32))
    exact = a.double().T @ a.double()

    def rel(got):
        return float(torch.linalg.vector_norm(got.double() - exact)
                     / torch.linalg.vector_norm(exact))

    assert rel(_tf32_gram(a, 3, 64)) <= 1e-5 < rel(_tf32_gram(a, 1, 64))
    ab = a.bfloat16().float()
    assert torch.equal(_tf32(ab), ab)


def test_build_checks_refuse_other_devices_and_types():
    with pytest.raises(ValueError, match="need CUDA tensors"):
        _build.check_device(torch.zeros(2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.dtype_code(torch.zeros(2, dtype=torch.float16), "a")
    assert _build.library_path().parent == _build.BUILD_DIR
