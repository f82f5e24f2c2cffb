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
REDUCE_LANES = 8    # csrc/bsr_rmatmul.cu's kReduceLanes
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
    # quantize="auto" asks the planner: a tiny shape stays exact (int8's
    # modeled savings are under the planner's floor), a large one at a
    # tolerance over int8's guard is quantized (tests/test_torch_planner.py
    # holds the decision itself).
    assert bsr.BlockELL.from_dense(torch.zeros(16, 16), 8,
                                   quantize="auto").scales is None
    big = torch.zeros(32768, 256)
    big[:, :128] = 1.0
    assert bsr.BlockELL.from_dense(big, 128, quantize="auto",
                                   tol=1e-3).scales is not None
    assert bsr.BlockELL.from_dense(big, 128, quantize="auto",
                                   tol=1e-8).scales is None
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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 mma operand keeps of an f32 value: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _gather_rmatmul(a: bsr.BlockELL, x: torch.Tensor,
                    idx: bsr.ColumnIndex | None = None) -> torch.Tensor:
    """AᵀX summed the way csrc/bsr_rmatmul.cu sums it: per chunk of the
    column index, its slots in order, each slot's product Aᵢⱼᵀ Xᵢ from its
    TF32 parts (3xTF32 for f32 blocks: a_lo x_hi + a_hi x_lo + a_hi x_hi;
    bf16 and int8 blocks are exact in TF32: a x_lo + a x_hi) from zero, its
    even and odd k-steps (rows 8k .. 8k + 7) apart and then added, added to
    the chunk's f32 total (int8: times the block's scale); then
    each column's chunk totals in the reduce pass's order: lane w of
    REDUCE_LANES adds chunks w, w + REDUCE_LANES, .. in order, and the
    lanes' sums are added in lane order.  The mma's own rounding inside a
    product is not modelled (float64 here)."""
    idx = idx or a.column_index()
    bs, ell = a.bs, a.ell
    blocks = a.data.float().reshape(-1, bs, bs)
    scales = None if a.scales is None else a.scales.reshape(-1)
    xr = x.float().reshape(-1, bs, x.shape[1])
    x_hi = _tf32(xr)
    x_lo = _tf32(xr - x_hi)
    parts = []
    for c in range(idx.nchunks):
        s0, n0 = int(idx.chunk_start[c]), int(idx.chunk_len[c])
        total = torch.zeros((bs, x.shape[1]))
        for q in idx.order[s0: s0 + n0].long().tolist():
            blk = blocks[q].T
            hi, lo = x_hi[q // ell].double(), x_lo[q // ell].double()
            if a.data.dtype == torch.float32:
                a_hi = _tf32(blk)
                a_lo = _tf32(blk - a_hi)
                terms = ((a_lo, hi), (a_hi, lo), (a_hi, hi))
            else:
                terms = ((blk, lo), (blk, hi))
            half = []
            for par in (0, 1):
                ks = [r for r in range(bs) if (r // 8) % 2 == par]
                half.append(sum(u.double()[:, ks] @ v[ks] for u, v in terms)
                            .float())
            p = half[0] + half[1]
            total = total + (p if scales is None else scales[q] * p)
        parts.append(total)
    out = torch.zeros((a.shape[1] // bs, bs, x.shape[1]))
    for j in range(a.shape[1] // bs):
        c0, c1 = int(idx.col_chunks[j]), int(idx.col_chunks[j + 1])
        for w in range(REDUCE_LANES):
            lane = torch.zeros((bs, x.shape[1]))
            for c in range(c0 + w, c1, REDUCE_LANES):
                lane = lane + parts[c]
            out[j] = out[j] + lane
    return out.reshape(a.shape[1], -1)


def _check_index(idx: bsr.ColumnIndex, cols: torch.Tensor, nbc: int,
                 chunk: int) -> None:
    """The invariants of a ColumnIndex: `order` sorted by column (ascending
    rows within one) and `rows` its block-rows; chunks of one column, at
    most `chunk` slots, cut from the front of each column's run, back to
    back in `order`, which is the kernel's launch order (unit u is chunk
    u // ntiles): column by column, in rows within a column;
    `col_chunks` the chunks of each column."""
    ell = cols.shape[1]
    flat = cols.reshape(-1).long()
    order = idx.order.long()
    assert torch.equal(order, torch.argsort(flat, stable=True))
    assert torch.equal(idx.rows.long(), order // ell)
    start, length = idx.chunk_start.long(), idx.chunk_len.long()
    assert int(length.min()) >= 1 and int(length.max()) <= chunk
    assert int(start[0]) == 0 and torch.equal(start[1:],
                                              (start + length)[:-1])
    assert int(length.sum()) == flat.numel()
    keys = []
    for c in range(idx.nchunks):
        q = order[int(start[c]): int(start[c] + length[c])]
        rows = q // ell
        assert len(set(flat[q].tolist())) == 1
        assert bool((rows.diff() > 0).all())
        keys.append((int(flat[q[0]]), int(rows[0])))
    assert keys == sorted(keys)
    for j in range(nbc):
        mine = list(range(int(idx.col_chunks[j]), int(idx.col_chunks[j + 1])))
        assert all(keys[c][0] == j for c in mine)
        assert all(int(length[c]) == chunk for c in mine[:-1])


def test_column_index_cuts_chunks_in_launch_order():
    """ColumnIndex at several chunk sizes: a hot column (every block-row)
    cut into whole chunks from its front; the chunks in the kernel's launch
    order, column by column, in rows order within a column."""
    rng = np.random.default_rng(11)
    nbr, nbc, ell = 53, 9, 4
    keys = rng.random((nbr, nbc))
    keys[:, 5] = -1.0
    cols = torch.sort(torch.from_numpy(np.argsort(keys, axis=1)[:, :ell]),
                      dim=1).values.to(torch.int32)
    for chunk in (4, 3, 32, 2, 1):
        idx = bsr.ColumnIndex.build(cols, nbc, chunk)
        _check_index(idx, cols, nbc, chunk)
        hot = int(idx.col_chunks[6] - idx.col_chunks[5])
        assert hot == -(-nbr // chunk)


def test_column_index_order_stays_sorted_by_column():
    """A BlockELL's cached index keeps `order` the stable sort of the
    columns, which SparseRowMatrix.column_norms takes prefix sums over."""
    bs, nbr, nbc, ell = 8, 2500, 7, 3
    rng = np.random.default_rng(12)
    cols = np.sort(np.argsort(rng.random((nbr, nbc)), axis=1)[:, :ell],
                   axis=1)
    a = bsr.BlockELL(torch.ones(nbr, ell, bs, bs),
                     torch.from_numpy(cols).to(torch.int32).contiguous(),
                     (nbr * bs, nbc * bs))
    _check_index(a.column_index(), a.cols, nbc, bsr.RMATMUL_CHUNK)
    assert torch.equal(a.column_index().order.long(), torch.argsort(
        a.cols.reshape(-1).long(), stable=True))


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("chunk", [3, 32])
def test_rmatmul_3xtf32_order_matches_plain(storage, chunk):
    """The kernel's sum order and 3xTF32 products, emulated on the CPU over
    an index whose columns span several chunks (and one), agree with
    bsr_rmatmul_plain; each column of X gives the same emulated bits
    alone."""
    bs, nbr, nbc = 8, 23, 6
    dense = block_sparse(nbr * bs, nbc * bs, bs, 0.5, seed=chunk)
    _, pb = _pair(dense, bs, storage)
    idx = bsr.ColumnIndex.build(pb.cols, nbc, chunk)
    X = _t(np.random.default_rng(4).normal(size=(nbr * bs, 5))
           .astype(np.float32))
    got = _gather_rmatmul(pb, X, idx)
    _close(got, bsr.bsr_rmatmul_plain(pb, X), atol=1e-4)
    assert torch.equal(_gather_rmatmul(pb, X[:, 2:3], idx), got[:, 2:3])


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("nx", [1, 8, 16, 33, 512, 520])
def test_rmatmul_plan_at_every_block_size(bs, itemsize, nx):
    """bsr_rmatmul's plan (csrc/bsr_rmatmul.cu): a tile of 8 to nt_max
    columns covering nx in whole tiles, at most RMATMUL_TILES_PER_WARP mma
    tiles a warp, two to RMATMUL_MAX_STAGES stages within a block's shared
    memory; staged rows of whole 16-byte pieces (or one run of them) on
    which one fragment load's 4 rows x 8 elements hit 32 distinct banks or
    share words only within a row."""
    p = bsr.rmatmul_plan(bs, nx, itemsize)
    assert bsr.RMATMUL_CHUNK == 32    # csrc/bsr_rmatmul.cu's kMaxChunk
    mt = max(1, bs // 16)
    assert p.nt in (8, 16, 32, 64, 128, 256)
    assert p.nt * (p.ntiles - 1) < nx <= p.nt * p.ntiles
    assert (p.nt // 8) * mt <= bsr.RMATMUL_WARPS * bsr.RMATMUL_TILES_PER_WARP
    if nx <= 32:
        assert p.ntiles == 1
    assert 2 <= p.stages <= bsr.RMATMUL_MAX_STAGES
    # Tiles up to 32 columns with fewer than 4 mma tiles a slot share each
    # tile among 4 / tiles warps, one slot each, and take at most half the
    # ring an iteration.
    tiles = mt * (p.nt // 8)
    if p.nt <= 32 and tiles < 4:
        assert p.stages >= 2 * (4 // tiles)
    assert p.stage_bytes == bs * p.row_stride + 4 * bs * p.x_stride + 16
    assert p.stage_bytes % 16 == 0
    assert p.smem == p.stages * p.stage_bytes <= bsr.SMEM_BLOCK_MAX
    for stride, elem in ((p.row_stride, itemsize), (4 * p.x_stride, 4)):
        assert stride % 16 == 0 or stride == bs * itemsize < 16
        words = {}
        for t in range(4):
            for g in range(8):
                w = (t * stride + g * elem) // 4
                words.setdefault(w % 32, set()).add(w)
        assert all(len(ws) == 1 for ws in words.values())


def test_rmatmul_plan_at_the_paths_shapes():
    """S's blocks (32 × 32 f32): 160-byte rows, one 8-column tile at nx = 1
    and 8 (the Lanczos operator, the int8 group pass) with 8 stages, 16 at
    16 with 6, and four 128-column tiles of a 512-column Gram strip with
    5: four blocks an SM fit beside each other at the narrow tiles, two
    at the wide ones."""
    for nx, (nt, ntiles, stages) in {1: (8, 1, 8), 8: (8, 1, 8),
                                     16: (16, 1, 6),
                                     512: (128, 4, 5)}.items():
        p = bsr.rmatmul_plan(32, nx, 4)
        assert (p.nt, p.ntiles, p.stages, p.row_stride) == (nt, ntiles,
                                                            stages, 160)
        static = 3 * 2 * 4 * 32 + (16 * 8 * 32 if nt <= 32 else 0)
        assert (4 if nt <= 32 else 2) * (p.smem + static + 1024) \
            <= bsr.SMEM_SM


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


def test_bsr_matmul_plan_reads_the_blocks_once_and_fits_the_card():
    """bsr_matmul's launch plan (csrc/bsr_spmm.cu) at S's shape (2^17
    block-rows of 32 x 32 f32 blocks, nx = 16): units of 8 block-rows, one
    thread per 4 x 4 outputs (256 threads), one tile of 16 columns, a ring
    of 4 stages of 53,408 bytes, one block an SM.  Every nx <= 32 is one
    tile (the stored blocks read once); wider nx takes tiles of 32."""
    p = bsr.matmul_plan(1 << 17, 32, 16, 4, 132)
    assert (p.nt, p.ntiles, p.br, p.threads, p.stages) == (16, 1, 8, 256, 4)
    assert (p.stage_bytes, p.smem, p.grid) == (53408, 4 * 53408, 132)
    # The int8 group pass at 8 slots: 16 block-rows a unit.
    q = bsr.matmul_plan(1 << 17, 32, 8, 1, 132)
    assert (q.nt, q.ntiles, q.br, q.threads) == (8, 1, 16, 256)
    for nx, tiles in {1: (4, 1), 3: (4, 1), 5: (8, 1), 8: (8, 1),
                      16: (16, 1), 17: (32, 1), 32: (32, 1), 33: (32, 2),
                      520: (32, 17)}.items():
        r = bsr.matmul_plan(1000, 32, nx, 4, 132)
        assert (r.nt, r.ntiles) == tiles, nx


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("nx", [1, 4, 8, 16, 32, 33, 520])
def test_bsr_matmul_plan_at_every_block_size(bs, itemsize, nx):
    """Every plan launches: at most MATMUL_THREADS threads, one a 4 x 4
    output tile of one block-row (exactly four X pieces a thread), two to
    MATMUL_MAX_STAGES stages within a block's shared memory, and a grid no
    larger than its units."""
    nbr = 37
    p = bsr.matmul_plan(nbr, bs, nx, itemsize, 132)
    per_row = (bs // 4) * (p.nt // 4)
    assert p.nt in (4, 8, 16, 32) and p.nt * (p.ntiles - 1) < nx <= \
        p.nt * p.ntiles
    assert p.threads == p.br * per_row <= bsr.MATMUL_THREADS
    assert (p.br * bs * (p.nt // 4)) == 4 * p.threads
    assert 2 <= p.stages <= bsr.MATMUL_MAX_STAGES
    assert p.stage_bytes % 16 == 0
    assert p.smem == p.stages * p.stage_bytes <= bsr.SMEM_BLOCK_MAX
    assert 1 <= p.grid <= -(-nbr // p.br) * p.ntiles


def test_bsr_matmul_pads_x_to_whole_pieces():
    """X goes to the kernel as rows of whole 16-byte pieces on a 16-byte
    boundary: as it is where it already is, else a copy padded with zero
    columns."""
    x = torch.arange(30.0).reshape(10, 3)
    xp = bsr.padded_columns(x)
    assert xp.shape == (10, 4) and torch.equal(xp[:, :3], x)
    assert not xp[:, 3].any()
    x16 = torch.zeros(10, 16)
    assert x16.data_ptr() % 16 == 0 and bsr.padded_columns(x16) is x16
    off = torch.arange(170.0)[1:161].view(10, 16)
    assert off.data_ptr() % 16 != 0
    op = bsr.padded_columns(off)
    assert op.data_ptr() % 16 == 0 and torch.equal(op, off)
