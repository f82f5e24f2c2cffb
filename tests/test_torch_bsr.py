"""The port's block-sparse kernels module against the JAX reference, on the
CPU.

The same numpy inputs go to the reference's BlockELL and its default (jnp)
dispatch and ``kernels/ref.py`` oracles, and to the port's BlockELL and its
plain torch versions (what a CPU tensor gets).  The reference is never run
with ``force_pallas=True``: its interpret path for bsr_rmatmul's fused
scatter and for fused_grad_bsr raises on the installed jax (ROADMAP queue
3, "Removed Pallas API").  Block sizes 8 and 16, block-row and block-column
counts that are not powers of two, ragged nx; f32, bf16 and int8 storage.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import bsr as jbsr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import bsr, fusedgrad, ops, ref

STORAGE = ("f32", "bf16", "int8")
LOSSES = ("quad", "logistic", "huber", "poisson")


def _t(arr):
    return convert.tensor_from_numpy(arr, device="cpu")


def block_sparse(m, n, bs, density, seed):
    """A dense array with block-structured sparsity (tests/test_sparserow.py)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m // bs, n // bs)) < density
    return (np.kron(mask, np.ones((bs, bs)))
            * rng.normal(size=(m, n))).astype(np.float32)


def _pair(dense, bs, storage):
    """The reference's BlockELL and the port's, from the same array."""
    if storage == "bf16":
        dense = dense.astype(ml_dtypes.bfloat16)
    jb = jbsr.BlockELL.from_dense(dense, bs,
                                  quantize="int8" if storage == "int8"
                                  else "none")
    pb = bsr.BlockELL(_t(np.asarray(jb.data)), _t(np.asarray(jb.cols)),
                      jb.shape, None if jb.scales is None
                      else _t(np.asarray(jb.scales)))
    return jb, pb


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bs,nbr,nbc,density", [(8, 7, 5, 0.3),
                                                (16, 3, 6, 0.5),
                                                (8, 5, 3, 1.0),
                                                (8, 4, 9, 0.0)])
def test_from_dense_gives_the_reference_layout(dtype, bs, nbr, nbc,
                                               density):
    dense = block_sparse(nbr * bs, nbc * bs, bs, density, seed=nbr * nbc)
    src = dense.astype(ml_dtypes.bfloat16) if dtype == "bf16" else dense
    jb = jbsr.BlockELL.from_dense(src, bs)
    got = bsr.BlockELL.from_dense(_t(src), bs)
    assert got.shape == jb.shape and got.ell == jb.ell and got.bs == bs
    assert got.cols.dtype == torch.int32
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(jb.cols))
    np.testing.assert_array_equal(got.data.float().numpy(),
                                  np.asarray(jb.data, np.float32))
    np.testing.assert_array_equal(got.to_dense().float().numpy(),
                                  np.asarray(src, np.float32))
    assert got.density() == pytest.approx(jb.density())


@pytest.mark.parametrize("bs", [8, 16])
def test_quantize_int8_matches_the_reference(bs):
    dense = block_sparse(6 * bs, 5 * bs, bs, 0.4, seed=bs)
    jb = jbsr.BlockELL.from_dense(dense, bs, quantize="int8")
    got = bsr.BlockELL.from_dense(_t(dense), bs, quantize="int8")
    assert got.data.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(jb.cols))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(jb.scales),
                               rtol=1e-7)
    step = np.abs(got.data.numpy().astype(np.int32)
                  - np.asarray(jb.data).astype(np.int32))
    assert step.max() <= 1
    # Padding blocks keep scale 1 and stay exactly zero.
    pad = np.asarray(jb.scales) == 1.0
    assert np.all(got.data.numpy()[pad] == 0)
    _close(got.dequantize().to_dense(), jb.dequantize().to_dense(),
           rtol=0, atol=float(np.asarray(jb.scales).max()))
    assert got.quantize_int8() is got


def test_quantize_auto_waits_for_the_planner():
    with pytest.raises(NotImplementedError, match="item 11"):
        bsr.BlockELL.from_dense(torch.zeros(16, 16), 8, quantize="auto")
    with pytest.raises(ValueError, match="quantize"):
        bsr.BlockELL.from_dense(torch.zeros(16, 16), 8, quantize="fp8")
    with pytest.raises(ValueError, match="multiple"):
        bsr.BlockELL.from_dense(torch.zeros(12, 16), 8)


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("bs,nbr,nbc,nx", [(8, 7, 5, 7), (16, 5, 3, 13),
                                           (8, 9, 11, 1)])
def test_plain_products_match_the_reference(storage, bs, nbr, nbc, nx):
    dense = block_sparse(nbr * bs, nbc * bs, bs, 0.35, seed=nbr + nbc + nx)
    jb, pb = _pair(dense, bs, storage)
    rng = np.random.default_rng(nx)
    x = rng.normal(size=nbc * bs).astype(np.float32)
    X = rng.normal(size=(nbc * bs, nx)).astype(np.float32)
    U = rng.normal(size=(nbr * bs, nx)).astype(np.float32)
    jx, jX, jU = jnp.asarray(x), jnp.asarray(X), jnp.asarray(U)

    y = bsr.bsr_matvec_plain(pb, _t(x))
    _close(y, jops.bsr_matvec(jb, jx))
    _close(y, jref.bsr_matvec_ref(jb, jx))
    _close(y, ref.bsr_matvec_ref(pb, _t(x)))
    Y = bsr.bsr_matmul_plain(pb, _t(X))
    assert Y.shape == (nbr * bs, nx)
    _close(Y, jops.bsr_matmul(jb, jX))
    _close(Y, jref.bsr_matmul_ref(jb, jX))
    _close(Y, ref.bsr_matmul_ref(pb, _t(X)))
    R = bsr.bsr_rmatmul_plain(pb, _t(U))
    assert R.shape == (nbc * bs, nx)
    _close(R, jops.bsr_rmatmul(jb, jU))
    _close(R, jref.bsr_rmatmul_ref(jb, jU))
    _close(R, ref.bsr_rmatmul_ref(pb, _t(U)))
    # The public ops send CPU tensors to the plain versions.
    assert torch.equal(ops.bsr_matvec(pb, _t(x)), y)
    assert torch.equal(ops.bsr_matmul(pb, _t(X)), Y)
    assert torch.equal(ops.bsr_rmatmul(pb, _t(U)), R)


def _targets(rng, loss, m):
    if loss == "logistic":
        return np.where(rng.random(m) < 0.5, -1.0, 1.0).astype(np.float32)
    if loss == "poisson":
        return rng.poisson(1.0, m).astype(np.float32)
    return rng.normal(size=m).astype(np.float32)


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("bs", [8, 16])
def test_fused_grad_bsr_plain_matches_the_reference(storage, loss, bs):
    """rtol/atol 1e-5 for f and 1e-4 for g and z (tests/test_fusedgrad.py).
    The reference's jnp form narrows the residual to bf16 for bf16 blocks
    and the port keeps it f32, as both kernels do; there g is held to the
    densifying oracle, which keeps it f32 too."""
    nbr, nbc = 6, 5
    dense = block_sparse(nbr * bs, nbc * bs, bs, 0.4, seed=bs + len(loss))
    jb, pb = _pair(dense, bs, storage)
    m, n = jb.shape
    rng = np.random.default_rng(bs)
    x = (0.3 * rng.normal(size=n)).astype(np.float32)
    t = _targets(rng, loss, m)
    w = rng.random(m).astype(np.float32)
    w[-bs:] = 0.0
    got = fusedgrad.fused_grad_bsr_plain(pb, _t(x), _t(t), _t(w), loss=loss,
                                         param=0.5)
    want = jops.fused_grad_bsr(jb, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(w), loss=loss, param=0.5)
    oracle = jref.fused_grad_ref(jb, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(w), loss=loss, param=0.5)
    _close(got[0], want[0], rtol=1e-5, atol=1e-5)
    _close(got[2], want[2])
    _close(got[1], (oracle if storage == "bf16" else want)[1])
    _close(got[1], oracle[1])
    port_oracle = ref.fused_grad_ref(pb, _t(x), _t(t), _t(w), loss=loss,
                                     param=0.5)
    _close(got[0], port_oracle[0], rtol=1e-5, atol=1e-5)
    f, g, z = ops.fused_grad_bsr(pb, _t(x), _t(t), _t(w), loss=loss,
                                 param=0.5)
    assert torch.equal(g, got[1]) and torch.equal(z, got[2])
    assert g.dtype == torch.float32 and z.shape == (m,)


def _gather_rmatmul(a: bsr.BlockELL, x: torch.Tensor) -> torch.Tensor:
    """AᵀX summed the way csrc/bsr_rmatmul.cu sums it: per chunk of the
    column index in chunk order, then the chunks of each column in order."""
    idx = a.column_index()
    bs, ell = a.bs, a.ell
    blocks = bsr.effective_data(a).float().reshape(-1, bs, bs)
    xr = x.float().reshape(-1, bs, x.shape[1])
    parts = []
    for c in range(idx.nchunks):
        s0, n0 = int(idx.chunk_start[c]), int(idx.chunk_len[c])
        p = idx.order[s0: s0 + n0].long()
        parts.append(sum(blocks[q].T @ xr[q // ell] for q in p))
    out = torch.zeros((a.shape[1] // bs, bs, x.shape[1]))
    for j in range(a.shape[1] // bs):
        for c in range(int(idx.col_chunks[j]), int(idx.col_chunks[j + 1])):
            out[j] += parts[c]
    return out.reshape(a.shape[1], -1)


@pytest.mark.parametrize("storage", STORAGE)
def test_column_index_chunks_a_hot_column(storage):
    """Every block-row hits block column 2 (a hot column longer than one
    chunk); summing over the index's chunks gives AᵀX."""
    bs, nbr, nbc = 8, 75, 6
    rng = np.random.default_rng(5)
    mask = rng.random((nbr, nbc)) < 0.3
    mask[:, 2] = True
    dense = (np.kron(mask, np.ones((bs, bs)))
             * rng.normal(size=(nbr * bs, nbc * bs))).astype(np.float32)
    _, pb = _pair(dense, bs, storage)
    idx = pb.column_index()
    assert pb.column_index() is idx                     # built once
    flat = pb.cols.reshape(-1).long()
    order = idx.order.long()
    assert torch.equal(flat[order], torch.sort(flat, stable=True).values)
    assert int(idx.chunk_len.max()) <= bsr.RMATMUL_CHUNK
    assert int(idx.chunk_len.sum()) == flat.numel()
    hot = int(idx.col_chunks[3] - idx.col_chunks[2])
    assert hot == -(-int((flat == 2).sum()) // bsr.RMATMUL_CHUNK) > 1
    for j in range(nbc):                                # ascending rows
        c0, c1 = int(idx.col_chunks[j]), int(idx.col_chunks[j + 1])
        if c1 > c0:
            s0 = int(idx.chunk_start[c0])
            s1 = int(idx.chunk_start[c1 - 1] + idx.chunk_len[c1 - 1])
            assert bool((order[s0:s1].diff() > 0).all())
    X = _t(rng.normal(size=(nbr * bs, 3)).astype(np.float32))
    _close(_gather_rmatmul(pb, X), bsr.bsr_rmatmul_plain(pb, X), atol=1e-4)


def test_column_index_refuses_columns_out_of_range():
    a = bsr.BlockELL(torch.zeros(2, 1, 8, 8),
                     torch.tensor([[0], [3]], dtype=torch.int32), (16, 24))
    with pytest.raises(ValueError, match="block columns"):
        a.column_index()


def test_cpu_tensors_never_reach_the_bsr_kernels():
    dense = block_sparse(32, 24, 8, 0.5, seed=3)
    _, pb = _pair(dense, 8, "f32")
    x, u = torch.ones(24), torch.ones(32)
    ops.reset_launch_counts()
    ops.bsr_matvec(pb, x)
    ops.bsr_matmul(pb, x[:, None])
    ops.bsr_rmatmul(pb, u[:, None])
    ops.fused_grad_bsr(pb, x, u, u, loss="quad")
    counts = ops.launch_counts()
    assert all(counts[k] == 0 for k in ("bsr_matvec", "bsr_matmul",
                                        "bsr_rmatmul", "fused_grad_bsr"))
    for call in (lambda: bsr.bsr_matvec(pb, x),
                 lambda: bsr.bsr_matmul(pb, x[:, None]),
                 lambda: bsr.bsr_rmatmul(pb, u[:, None]),
                 lambda: fusedgrad.fused_grad_bsr(pb, x, u, u, loss="quad")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="loss"):
        ops.fused_grad_bsr(pb, x, u, u, loss="hinge")
