"""The port's CUDA kernels against their plain torch versions, on the card.

Small shapes that still cover every path of each kernel: ragged m and n,
f32 and bf16 storage, the staged and the unstaged paths of the
fused_grad_multi kernel (fused_grad is its one-slot launch), slot counts
from 1 to 100 (one launch each, across and past 8-slot chunks), a slot's
bits at k = 1, 40 and 100; gemm at every operand and output type, K of
1, 3, 26, 1023 and 16384, N of one to several column tiles, on views off a
16-byte boundary (the same bits as aligned copies), TSQR's 26-wide rows,
and rows whose bits do not depend on m; one and several
randsketch slices and Q tiles, at widths off its tiles and pieces, and
views of A that start off a 16-byte boundary (the same bits as aligned
copies); tsgram at n of 1, odd and off its 128-column tile, across slices,
and on offset views with NaNs beside them (the same bits as aligned
copies); for the block-sparse kernels every block size from 8 to 128, f32,
bf16 and int8 blocks, ragged block-row counts and nx (up to past a sparse
Gram strip's 512 columns), bsr_matmul's columns the same bits at any nx,
a hot column longer than one rmatmul chunk, and
fused_grad_bsr (the multi kernel's one-slot launch, slot 0's bits);
bsr_rmatmul at every storage and block size for nx of 1 to 520, its
columns the same bits at any nx, a hot column across row ranges and X off
a 16-byte boundary; an int8 request's bits alone and in a group;
fused_grad_bsr_multi at every block size, 1 to 100 slots, staged
and unstaged, with its slot independence and repeatability bit for bit;
blocks that start off a 16-byte boundary through every sparse kernel;
a SolverServer group of 40 slots on a dense and on a sparse matrix, one
launch per A-pass; flash_attention at head dims 32, 64, 128 and 192, 1, 3
and 4 q heads a KV head, causal and not, query and key lengths of 1, 63 and 2049
and unequal ones both ways (2048 against 2049 among them), f32 and bf16,
q, k and v that start off a 16-byte boundary,
key lengths off the bf16 kernel's 128-key tile (64 at D = 192), scores
near 50, four KV heads each read by the right q heads, the same bits twice
and a launch count for each variant (bf16 on the tensor cores, f32 on the
CUDA cores) and each mask (causal, non-causal); MLA's prefill shape at D = 192 (one q head a KV head, the
rotary key shared by the heads, v zero-padded from 128) at S = 2048, 2049
and 2048 queries against 2049 keys, and the smoke MLA's head of 48
refused on the card;
the selective scan at
channel counts of 1 and off its 16- to 128-channel blocks, N = 8, 16,
32 and 64 (Mamba2's),
S of 1 to 2049 on both sides of its 16-step tile, from a nonzero state,
with its final state, and the same bits twice; BlockMatrix.multiply (one
gemm launch) at square and ragged shapes in f32 and bf16, the same bits
twice; CoordinateMatrix products and its block-sparse conversion against
the CPU's; make_problem's L on the card against the CPU's.  The dense
kernels' storage types take e4m3 and e5m2 beside f32 and bf16 (STORE);
randsketch also on column segments of a wider A at its row stride (the
same bits as contiguous copies), on fp8 A with Q in A's type (the
products with Q's zero low parts skipped, the same bits), with an fp8 B,
and through the chunked products of a RowMatrix.
Skips where there is no CUDA device.  Run on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import (bsr, flash_attention, fusedgrad, gemm, ops,
                                 randsketch, selective_scan, tsgram)
from repro_torch.kernels.dtypes import cast, to_e4m3

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


# The dense kernels' storage types: fp8 (e4m3 and e5m2) reaches
# fused_grad(_multi), tsgram, gemm's A and randsketch's A.
FP8 = [torch.float8_e4m3fn, torch.float8_e5m2]
STORE = [torch.float32, torch.bfloat16, *FP8]


def _nan_buffer(numel, dtype, dev):
    """`numel` NaNs of `dtype` (0x7F is a NaN code of both fp8 types)."""
    if dtype in FP8:
        return torch.full((numel,), 0x7F, dtype=torch.uint8,
                          device=dev).view(dtype)
    return torch.full((numel,), float("nan"), device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("m,n", [(1000, 70), (4099, 1024), (300, 6000)])
def test_fused_grad_matches_plain(dev, dtype, loss, m, n):
    g = _gen(dev, m + n)
    a = cast(torch.randn(m, n, generator=g, device=dev) / n ** 0.5,
               dtype)
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
    a = cast(torch.randn(m, n, generator=g, device=dev) / n ** 0.5,
               dtype)
    x = torch.randn(k, n, generator=g, device=dev)
    t = torch.randn(k, m, generator=g, device=dev)
    if loss == "logistic":
        t = torch.where(t >= 0, 1.0, -1.0)
    elif loss == "poisson":
        t = torch.poisson(torch.ones(k, m, device=dev), generator=g)
    w = torch.rand(k, m, generator=g, device=dev)
    w[:, -(m // 7):] = 0.0
    return a, x, t, w


SLOT_COUNTS = [1, 3, 8, 16, 31, 32, 33, 40, 64, 100]


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("k", SLOT_COUNTS)
@pytest.mark.parametrize("m,n", [(1000, 70), (4099, 1024), (300, 6000)])
def test_fused_grad_multi_matches_plain(dev, dtype, loss, k, m, n):
    a, x, t, w = _multi_inputs(dev, loss, m, n, k, dtype, m + n + k)
    launches = fusedgrad.fused_grad_multi.launches
    got = fusedgrad.fused_grad_multi(a, x, t, w, loss=loss, param=0.5)
    assert fusedgrad.fused_grad_multi.launches == launches + 1
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
    """32 slots, and 33 (once the cap), each in one launch; no slot is
    refused."""
    a, x, t, w = _multi_inputs(dev, "huber", 2000, 300, 33, torch.float32, 5)
    for k in (32, 33):
        launches = fusedgrad.fused_grad_multi.launches
        got = fusedgrad.fused_grad_multi(a, x[:k], t[:k], w[:k],
                                         loss="huber", param=0.5)
        assert fusedgrad.fused_grad_multi.launches == launches + 1
        want = fusedgrad.fused_grad_multi_plain(a, x[:k], t[:k], w[:k],
                                                loss="huber", param=0.5)
        torch.cuda.synchronize()
        assert _rel(got[1], want[1]) <= TOL_SUM
        assert _rel(got[2], want[2]) <= TOL
    with pytest.raises(ValueError, match="one slot or more"):
        fusedgrad.fused_grad_multi(a, x[:0], t[:0], w[:0], loss="quad")


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("m,n,k", [(4099, 1024, 8), (300, 6000, 4),
                                   (1000, 70, 16), (4099, 1024, 40),
                                   (300, 6000, 33)])
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


def _off_boundary(v: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of v that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
    out = buf[1:].view(v.shape)
    out.copy_(v)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("m,n", [(4099, 1024), (300, 6000), (257, 6001)])
def test_fused_grad_multi_bits_do_not_depend_on_alignment(dev, dtype, m, n):
    """A and X that start off a 16-byte boundary (or rows that are not a
    multiple of 4 elements) load element by element with the same
    arithmetic: the same bits as aligned copies, on the staged and the
    unstaged path, and close to the plain version."""
    a, x, t, w = _multi_inputs(dev, "quad", m, n, 8, dtype, 17)
    want = fusedgrad.fused_grad_multi(a, x, t, w, loss="quad")
    got = fusedgrad.fused_grad_multi(_off_boundary(a), _off_boundary(x), t, w,
                                     loss="quad")
    plain = fusedgrad.fused_grad_multi_plain(a, x, t, w, loss="quad")
    torch.cuda.synchronize()
    for u, v in zip(want, got):
        assert torch.equal(u, v)
    assert _rel(got[0], plain[0]) <= TOL and _rel(got[1], plain[1]) <= TOL_SUM
    assert _rel(got[2], plain[2]) <= TOL


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("m,n", [(4099, 1024), (300, 6000), (1000, 70),
                                 (257, 16384)])
def test_fused_grad_multi_slot_bits_do_not_depend_on_the_slot_count(
        dev, dtype, m, n):
    """A request gets the same bits alone (k = 1, and fused_grad, its
    one-slot launch) as in a group of 3, 8, 16, 40 or 100: the row tiling,
    the grid and the chunk width follow from A's shape and storage
    alone."""
    a, x, t, w = _multi_inputs(dev, "huber", m, n, 100, dtype, 13)
    alone = fusedgrad.fused_grad_multi(a, x[:1], t[:1], w[:1], loss="huber",
                                       param=0.5)
    single = fusedgrad.fused_grad(a, x[0], t[0], w[0], loss="huber",
                                  param=0.5)
    torch.cuda.synchronize()
    assert [v.shape for v in single] == [(), (n,), (m,)]
    for u, v in zip(single, alone):
        assert torch.equal(u, v[0])
    for k in (3, 8, 16, 40, 100):
        group = fusedgrad.fused_grad_multi(a, x[:k], t[:k], w[:k],
                                           loss="huber", param=0.5)
        torch.cuda.synchronize()
        for u, v in zip(alone, group):
            assert torch.equal(u[0], v[0]), k


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("r", [3, 26, 32, 40, 64])
@pytest.mark.parametrize("m,n", [(1000, 7), (4099, 70), (33, 255),
                                 (70000, 257), (300, 6000), (140000, 70)])
def test_randsketch_matches_plain(dev, dtype, m, n, r):
    """Widths off every tile and piece boundary, one Q tile and several,
    and m within one slice and across several (70000 and 140000 rows on
    132 SMs): within TOL of plain, the same bits twice, and the output in
    a's type by default."""
    g = _gen(dev, m + n + r)
    a = cast(torch.randn(m, n, generator=g, device=dev), dtype)
    q = torch.randn(m, r, generator=g, device=dev)
    got = randsketch.randsketch(a, q, out_dtype=torch.float32)
    want = randsketch.randsketch_plain(a, q, torch.float32)
    torch.cuda.synchronize()
    assert got.shape == (n, r)
    assert _rel(got, want) <= TOL
    assert torch.equal(got, randsketch.randsketch(a, q,
                                                  out_dtype=torch.float32))
    assert randsketch.randsketch(a, q).dtype == dtype
    if m >= 70000:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert randsketch.slicing(m, n, r, sms)[0] > 1


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("m,n,r", [(1000, 7, 5), (4099, 257, 26),
                                   (70000, 300, 26), (300, 6001, 40)])
def test_randsketch_offset_views_match_their_aligned_copies(dev, dtype, m,
                                                            n, r):
    """A view that starts 1..3 (f32), 1..7 (bf16) or 1..15 (e4m3) elements
    past a 16-byte boundary, with NaNs in the bytes around it, gives the
    same bits as its aligned copy: the kernel stages each row's aligned
    window and
    selects the ragged edge to 0, never multiplying the NaNs."""
    g = _gen(dev, 7 * m + n)
    a = cast(torch.randn(m, n, generator=g, device=dev), dtype)
    q = torch.randn(m, r, generator=g, device=dev)
    want = randsketch.randsketch(a, q, out_dtype=torch.float32)
    assert _rel(want, randsketch.randsketch_plain(a, q, torch.float32)) <= TOL
    for off in range(1, 16 // a.element_size()):
        buf = _nan_buffer(m * n + off + 16, dtype, dev)
        view = buf[off:off + m * n].view(m, n)
        view.copy_(a)
        assert view.data_ptr() % 16 != 0
        got = randsketch.randsketch(view, q, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want), off


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("width,s0,s1,r", [(1024, 0, 512, 1),
                                           (1024, 512, 1024, 1),
                                           (1001, 3, 700, 26),
                                           (16384, 4096, 8192, 1),
                                           (300, 150, 300, 512)])
def test_randsketch_column_segments_match_their_copies(dev, dtype, width,
                                                       s0, s1, r):
    """A[:, s0:s1] of a wider A, read at A's row stride (the chunked
    gradient's segments at r = 1, the chunked Gram's Q = A[:, seg] at r =
    its width), with NaNs past A's end: the same bits as its contiguous
    copy, within TOL of plain; one launch each."""
    m = 5000
    g = _gen(dev, width + s0 + r)
    buf = _nan_buffer(m * width + 64, dtype, dev)
    a = buf[:m * width].view(m, width)
    a.copy_(cast(torch.randn(m, width, generator=g, device=dev), dtype))
    q = torch.randn(m, r, generator=g, device=dev)
    seg = a[:, s0:s1]
    assert not seg.is_contiguous() or s1 - s0 == width
    launches = randsketch.randsketch.launches
    got = randsketch.randsketch(seg, q, out_dtype=torch.float32)
    assert randsketch.randsketch.launches == launches + 1
    want = randsketch.randsketch(seg.contiguous(), q, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _rel(got, randsketch.randsketch_plain(seg, q, torch.float32)) \
        <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, *FP8])
def test_randsketch_q_in_a_narrow_type_skips_its_low_products(dev, dtype):
    """Q stored in bf16 or fp8 (the chunked Gram's Q = A[:, seg]) is exact
    in TF32: the kernel skips the products with its zero low parts and
    gives the same bits as for the same Q in f32."""
    g = _gen(dev, 11)
    a = cast(torch.randn(70000, 300, generator=g, device=dev), dtype)
    q = a[:, 40:72]
    got = randsketch.randsketch(a, q, out_dtype=torch.float32)
    want = randsketch.randsketch(a, q.float(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _rel(got, randsketch.randsketch_plain(a, q, torch.float32)) <= TOL


@pytest.mark.parametrize("dtype", FP8)
def test_randsketch_fp8_out(dev, dtype):
    """An fp8 B (the output in A's type by default): the kernel's f32 B
    through dtypes.cast, one launch."""
    g = _gen(dev, 13)
    a = cast(torch.randn(3000, 70, generator=g, device=dev) / 8, dtype)
    q = torch.randn(3000, 5, generator=g, device=dev) / 8
    launches = randsketch.randsketch.launches
    got = randsketch.randsketch(a, q)
    assert randsketch.randsketch.launches == launches + 1
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.uint8), cast(randsketch.randsketch(
        a, q, out_dtype=torch.float32), dtype).view(torch.uint8))


@pytest.mark.parametrize("dtype", STORE)
def test_chunked_products_launch_randsketch(dev, dtype):
    """A one-shard RowMatrix at chunks=4: the Gram's four segments are
    randsketch launches on the card, and so are the fused gradient's
    where A is narrower than f32 (no torch product takes an fp8 or bf16
    operand beside the f32 residual; f32 A takes a plain product), within
    TOL_SUM of eager."""
    from repro_torch.core.distmat import RowMatrix
    from repro_torch.core.tfocs.smooth import SmoothQuad
    g = _gen(dev, 17)
    rm = RowMatrix.create(torch.randn(6000, 256, generator=g, device=dev),
                          device=dev, store_dtype=dtype)
    x = torch.randn(256, generator=g, device=dev) / 16
    sep = SmoothQuad(torch.randn(6000, generator=g, device=dev))
    ops.reset_launch_counts()
    gram = rm.gram(chunks=4)
    _, grad, _ = rm.fused_grad(x, sep, chunks=4)
    counts = ops.launch_counts()
    segments = 4 if dtype == torch.float32 else 8
    assert counts["randsketch"] == segments and counts["fused_grad"] == 1
    assert _rel(gram, rm.gram()) <= TOL_SUM
    assert _rel(grad, rm.fused_grad(x, sep)[1]) <= TOL_SUM


def test_randsketch_row_slice_of_a_matrix(dev):
    """A row slice A[i:] of a matrix whose width is off the 16-byte piece
    (a user's view, no copy): the same bits as a fresh copy of it."""
    g = _gen(dev, 5)
    a = torch.randn(5000, 1001, generator=g, device=dev)
    q = torch.randn(4997, 26, generator=g, device=dev)
    view = a[3:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert torch.equal(randsketch.randsketch(view, q),
                       randsketch.randsketch(view.clone(), q))


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(1000, 70), (5003, 130), (64, 200),
                                 (3001, 1), (777, 257), (70000, 129),
                                 (300, 385), (140000, 33)])
def test_tsgram_matches_plain(dev, dtype, out_dtype, m, n):
    """n of 1, odd, off the 128-column tile and across several tile pairs,
    m within one slice and across several: within TOL_SUM of plain,
    symmetric, and the same bits twice."""
    a = cast(torch.randn(m, n, generator=_gen(dev, m), device=dev),
               dtype)
    got = tsgram.tsgram(a, out_dtype=out_dtype)
    want = tsgram.tsgram_plain(a, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, n)
    assert _rel(got, want) <= (TOL_SUM if out_dtype == torch.float32 else 1e-2)
    assert torch.equal(got, got.T)
    assert torch.equal(got, tsgram.tsgram(a, out_dtype=out_dtype))
    if m >= 70000:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert tsgram.slicing(m, n, sms)[0] > 1


@pytest.mark.parametrize("dtype", STORE)
@pytest.mark.parametrize("m,n", [(1000, 7), (4099, 257), (70000, 131),
                                 (300, 1)])
def test_tsgram_offset_views_match_their_aligned_copies(dev, dtype, m, n):
    """A view that starts 1..3 (f32), 1..7 (bf16) or 1..15 (e4m3) elements
    past a 16-byte boundary, with NaNs in the bytes around it, gives the
    same bits as its aligned copy: the kernel stages each row's aligned
    window and
    selects the columns past A's last to 0, never multiplying the NaNs."""
    a = cast(torch.randn(m, n, generator=_gen(dev, 3 * m + n), device=dev),
               dtype)
    want = tsgram.tsgram(a, out_dtype=torch.float32)
    assert _rel(want, tsgram.tsgram_plain(a, torch.float32)) <= TOL_SUM
    for off in range(1, 16 // a.element_size()):
        buf = _nan_buffer(m * n + off + 16, dtype, dev)
        view = buf[off:off + m * n].view(m, n)
        view.copy_(a)
        assert view.data_ptr() % 16 != 0
        got = tsgram.tsgram(view, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want), off


@pytest.mark.parametrize("dtype", STORE)
def test_tsgram_row_slice_of_a_matrix(dev, dtype):
    """a[3:] of a matrix of odd width (a user's view, no copy): the same
    bits as a fresh copy of it, and close to plain."""
    a = cast(torch.randn(5000, 1001, generator=_gen(dev, 9), device=dev),
               dtype)
    view = a[3:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = tsgram.tsgram(view, out_dtype=torch.float32)
    assert torch.equal(got, tsgram.tsgram(view.clone(),
                                          out_dtype=torch.float32))
    assert _rel(got, tsgram.tsgram_plain(view, torch.float32)) <= TOL_SUM


@pytest.mark.parametrize("a_dtype", STORE)
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1000, 70, 5), (777, 64, 20),
                                   (513, 100, 64), (300, 33, 130)])
def test_gemm_matches_plain(dev, a_dtype, b_dtype, m, k, n):
    g = _gen(dev, m + k + n)
    a = cast(torch.randn(m, k, generator=g, device=dev), a_dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(b_dtype)
    got = gemm.gemm(a, b, out_dtype=torch.float32)
    want = gemm.gemm_plain(a, b, torch.float32)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL
    assert gemm.gemm(a, b).dtype == a_dtype


DTYPES = [torch.float32, torch.bfloat16]


def _gemm_tol(out_dtype):
    # bf16 output: one rounding of each entry, which plain rounds too but
    # may round the other way from a sum in another order.
    return TOL if out_dtype == torch.float32 else 1e-2


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("b_dtype", DTYPES)
@pytest.mark.parametrize("a_dtype", STORE)
@pytest.mark.parametrize("n", [1, 16, 26, 64, 130])
@pytest.mark.parametrize("k", [1, 3, 26, 1023])
def test_gemm_every_k_and_n_matches_plain(dev, k, n, a_dtype, b_dtype,
                                          out_dtype):
    """Every operand and output type, K off the 8-wide k-step and the
    stage (1, 3, 26, 1023) and N of one, two and four n8 tiles and of
    several column tiles (1, 16, 26, 64, 130), m off the 256-row tile:
    within TOL of plain, and the same bits twice."""
    g = _gen(dev, 31 * k + n)
    a = cast(torch.randn(777, k, generator=g, device=dev), a_dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(b_dtype)
    got = gemm.gemm(a, b, out_dtype=out_dtype)
    want = gemm.gemm_plain(a, b, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (777, n)
    assert _rel(got, want) <= _gemm_tol(out_dtype)
    assert torch.equal(got, gemm.gemm(a, b, out_dtype=out_dtype))


@pytest.mark.parametrize("a_dtype", STORE)
def test_gemm_long_k(dev, a_dtype):
    """K = 16384, N = 26: A_w's row length and the sketch's width, with
    512 (f32) or 256 (bf16) stages a tile summed into one total."""
    g = _gen(dev, 16384)
    a = cast(torch.randn(3000, 16384, generator=g, device=dev), a_dtype)
    b = torch.randn(16384, 26, generator=g, device=dev)
    got = gemm.gemm(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _rel(got, gemm.gemm_plain(a, b, torch.float32)) <= TOL


@pytest.mark.parametrize("a_dtype", STORE)
@pytest.mark.parametrize("m,k,n", [(1000, 1023, 16), (777, 26, 26),
                                   (300, 3, 5), (4099, 64, 130)])
def test_gemm_offset_views_match_their_aligned_copies(dev, a_dtype, m, k, n):
    """A view that starts 1..3 (f32), 1..7 (bf16) or 1..15 (e4m3) elements
    past a 16-byte boundary, with NaNs in the bytes around it, gives the
    same bits as its aligned copy: each row is staged from its aligned
    window and read at
    its shift, and the bytes past K arrive as zeros, so the NaNs are never
    multiplied."""
    g = _gen(dev, 5 * m + k + n)
    a = cast(torch.randn(m, k, generator=g, device=dev), a_dtype)
    b = torch.randn(k, n, generator=g, device=dev)
    want = gemm.gemm(a, b, out_dtype=torch.float32)
    assert _rel(want, gemm.gemm_plain(a, b, torch.float32)) <= TOL
    for off in range(1, 16 // a.element_size()):
        buf = _nan_buffer(m * k + off + 16, a_dtype, dev)
        view = buf[off:off + m * k].view(m, k)
        view.copy_(a)
        assert view.data_ptr() % 16 != 0
        got = gemm.gemm(view, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want), off


def test_gemm_tsqr_shape(dev):
    """TSQR's Q = Y R^-1: rows of 26 f32 (104 bytes, so every second row
    starts 8 bytes off a 16-byte boundary), in Y's own dtype."""
    g = _gen(dev, 26)
    y = torch.randn(70000, 26, generator=g, device=dev)
    r_inv = torch.randn(26, 26, generator=g, device=dev).triu() / 26 ** 0.5
    got = gemm.gemm(y, r_inv, out_dtype=y.dtype)
    torch.cuda.synchronize()
    assert _rel(got, gemm.gemm_plain(y, r_inv, y.dtype)) <= TOL
    assert torch.equal(got, gemm.gemm(y, r_inv, out_dtype=y.dtype))


@pytest.mark.parametrize("a_dtype", STORE)
@pytest.mark.parametrize("k,n", [(1024, 16), (26, 26), (1023, 130)])
def test_gemm_rows_do_not_depend_on_m(dev, a_dtype, k, n):
    """Rows of gemm(a[:j]) are bit for bit the same rows of gemm(a), for j
    inside and at the edge of the 256-row tile."""
    g = _gen(dev, 3 * k + n)
    a = cast(torch.randn(5000, k, generator=g, device=dev), a_dtype)
    b = torch.randn(k, n, generator=g, device=dev)
    whole = gemm.gemm(a, b, out_dtype=torch.float32)
    for j in (1, 255, 256, 257, 4097):
        part = gemm.gemm(a[:j], b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:j]), j


def _within_one_e4m3_step(got, want):
    """Each entry of an e4m3 result within one e4m3 step of the plain
    version's (the f32 sums behind them differ in their last bits, which
    may round either way): the step at |want| is 2^(floor(log2|want|) - 3),
    2^-9 among the subnormals."""
    g, w = got.double(), want.double()
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -6)))
    return bool(((g - w).abs() <= torch.exp2(e - 3)).all())


@pytest.mark.parametrize("m,k,n", [(1000, 70, 5), (777, 1024, 16),
                                   (4099, 1023, 26)])
def test_gemm_e4m3_out(dev, m, k, n):
    """e4m3 A, f32 B, e4m3 C (the reference's multiply_local keeps A's
    type): the kernel's f32 C cast by to_e4m3, within one e4m3 step of the
    plain version's, NaN where it rounds past 448, one launch."""
    g = _gen(dev, m + k)
    a = to_e4m3(torch.randn(m, k, generator=g, device=dev))
    b = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
    b[0, 0] = 1e4                       # column 0 rounds past 448
    launches = gemm.gemm.launches
    got = gemm.gemm(a, b)
    assert gemm.gemm.launches == launches + 1
    want = gemm.gemm_plain(a, b)
    f32 = gemm.gemm(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float8_e4m3fn
    assert torch.equal(got.view(torch.uint8), to_e4m3(f32).view(torch.uint8))
    ok = ~(f32.abs() > 464)
    assert bool(got.float()[~ok].isnan().all())
    assert _within_one_e4m3_step(got.float()[ok], want.float()[ok])


def test_tsgram_e4m3_out(dev):
    """An e4m3 Gram (tsgram's default out_dtype for e4m3 A): the f32 Gram
    cast by to_e4m3, within one e4m3 step of plain."""
    a = to_e4m3(torch.randn(3000, 70, generator=_gen(dev, 7), device=dev)
                / 40.0)
    got = tsgram.tsgram(a)
    want = tsgram.tsgram_plain(a)
    torch.cuda.synchronize()
    assert got.dtype == torch.float8_e4m3fn
    assert torch.equal(got.view(torch.uint8), to_e4m3(
        tsgram.tsgram(a, out_dtype=torch.float32)).view(torch.uint8))
    assert _within_one_e4m3_step(got.float(), want.float())


@pytest.mark.parametrize("dtype", FP8)
def test_e4m3_reaches_four_kernels_alone(dev, dtype):
    """ops routes fp8 CUDA operands (e4m3 and e5m2) to fused_grad,
    fused_grad_multi, tsgram, gemm and randsketch; the block-sparse
    kernels raise TypeError before any launch."""
    ops.reset_launch_counts()
    a = cast(torch.randn(200, 32, device=dev), dtype)
    x = torch.randn(32, device=dev)
    t, w = torch.randn(200, device=dev), torch.ones(200, device=dev)
    ops.fused_grad(a, x, t, w, loss="quad")
    ops.fused_grad_multi(a, x[None], t[None], w[None], loss="quad")
    ops.tsgram(a, out_dtype=torch.float32)
    ops.gemm(a, x[:, None])
    ops.randsketch(a, a[:, :3])
    bell = _random_bell(dev, 5, 4, 2, 8, "f32", 1)
    e4m3 = bsr.BlockELL(cast(bell.data, dtype), bell.cols, bell.shape)
    xb, ub = torch.randn(32, device=dev), torch.randn(40, device=dev)
    for call in (lambda: ops.bsr_matvec(e4m3, xb),
                 lambda: ops.bsr_matmul(e4m3, xb[:, None]),
                 lambda: ops.bsr_rmatmul(e4m3, ub[:, None]),
                 lambda: ops.fused_grad_bsr(e4m3, xb, ub, torch.ones_like(ub),
                                            loss="quad")):
        with pytest.raises(TypeError, match=str(dtype).split(".")[1]):
            call()
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "fused_grad": 1, "fused_grad_multi": 1, "tsgram": 1, "gemm": 1,
        "randsketch": 1}


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
    ops.fused_grad_bsr_multi(b, xb[None], ub[None], torch.ones_like(ub)[None],
                             loss="quad")
    q4 = torch.randn(1, 2, 9, 32, device=dev)
    ops.flash_attention(q4, q4, q4)
    s3 = torch.rand(1, 9, 12, device=dev)
    ops.selective_scan(s3, s3, -torch.rand(12, 8, device=dev),
                       torch.randn(1, 9, 8, device=dev),
                       torch.randn(1, 9, 8, device=dev),
                       torch.randn(12, device=dev))
    assert ops.launch_counts() == {"fused_grad": 1, "tsgram": 1, "gemm": 1,
                                   "fused_grad_multi": 1, "randsketch": 1,
                                   "bsr_matvec": 1, "bsr_matmul": 1,
                                   "bsr_rmatmul": 1, "fused_grad_bsr": 1,
                                   "fused_grad_bsr_multi": 1,
                                   "flash_attention": 1, "selective_scan": 1}
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
                                            (11, 6, 6, 33), (9, 5, 3, 520)])
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


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("nx", [1, 8, 16, 33, 520])
def test_bsr_matmul_matches_plain(dev, storage, bs, nx):
    """Every storage and block size at nx of 1, 8, 16 (one tile), 33 and
    520 (several): within TOL of plain and the same bits twice."""
    a = _random_bell(dev, 45, 11, 4, bs, storage, 3 * bs + nx)
    X = torch.randn(a.shape[1], nx, generator=_gen(dev, nx), device=dev)
    got = bsr.bsr_matmul(a, X)
    want = bsr.bsr_matmul_plain(a, X)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    assert torch.equal(got, bsr.bsr_matmul(a, X))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 32, 128])
def test_bsr_matmul_columns_do_not_depend_on_nx(dev, storage, bs):
    """Y[:, :j] at nx = 16 has the bits of X[:, :j] run alone (j = 1, 8),
    and does not change when X's other columns do: every output is one
    thread's sum in an order fixed by A's shape."""
    a = _random_bell(dev, 70, 9, 5, bs, storage, 7 * bs)
    g = _gen(dev, bs)
    X = torch.randn(a.shape[1], 16, generator=g, device=dev)
    Y = bsr.bsr_matmul(a, X)
    for j in (1, 8):
        assert torch.equal(bsr.bsr_matmul(a, X[:, :j].contiguous()),
                           Y[:, :j]), j
    X2 = X.clone()
    X2[:, 8:] = 1e3 * torch.randn(a.shape[1], 8, generator=g, device=dev)
    assert torch.equal(bsr.bsr_matmul(a, X2)[:, :8], Y[:, :8])


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


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("nx", [1, 8, 16, 33, 512, 520])
def test_bsr_rmatmul_matches_plain(dev, storage, bs, nx):
    """Every storage and block size at nx of 1, 8, 16 (one tile at every
    bs), 33, 512 and 520 (wide tiles, several, a ragged last one): within
    TOL_SUM of plain and the same bits twice."""
    a = _random_bell(dev, 45, 11, 4, bs, storage, 5 * bs + nx)
    U = torch.randn(a.shape[0], nx, generator=_gen(dev, nx), device=dev)
    got = bsr.bsr_rmatmul(a, U)
    want = bsr.bsr_rmatmul_plain(a, U)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL_SUM
    assert torch.equal(got, bsr.bsr_rmatmul(a, U))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 32, 128])
def test_bsr_rmatmul_columns_do_not_depend_on_nx(dev, storage, bs):
    """Y[:, :j] at nx = 16 has the bits of X[:, :j] run alone (j = 1, 8)
    and of the first 16 columns of a 512-column X (wide tiles), and does
    not change when X's other columns do: mma computes an output from its
    own column of X, in an order fixed by A's pattern."""
    a = _random_bell(dev, 70, 9, 5, bs, storage, 11 * bs)
    g = _gen(dev, bs + 1)
    U = torch.randn(a.shape[0], 16, generator=g, device=dev)
    Y = bsr.bsr_rmatmul(a, U)
    for j in (1, 8):
        assert torch.equal(bsr.bsr_rmatmul(a, U[:, :j].contiguous()),
                           Y[:, :j]), j
    U2 = U.clone()
    U2[:, 8:] = 1e3 * torch.randn(a.shape[0], 8, generator=g, device=dev)
    assert torch.equal(bsr.bsr_rmatmul(a, U2)[:, :8], Y[:, :8])
    wide = torch.cat([U, torch.randn(a.shape[0], 496, generator=g,
                                     device=dev)], dim=1)
    assert torch.equal(bsr.bsr_rmatmul(a, wide)[:, :16], Y)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_bsr_rmatmul_hot_column_of_many_chunks(dev, storage):
    """Every one of 2000 block-rows holds block column 3: its list is cut
    into 63 chunks, more than the reduce pass reads four rounds of lanes
    at a time, and summed in chunk order."""
    a = _random_bell(dev, 2000, 20, 4, 16, storage, 13, hot=3)
    idx = a.column_index()
    assert int(idx.col_chunks[4] - idx.col_chunks[3]) == 63
    for nx in (1, 16, 40):
        X = torch.randn(a.shape[0], nx, generator=_gen(dev, nx), device=dev)
        got = bsr.bsr_rmatmul(a, X)
        want = bsr.bsr_rmatmul_plain(a, X)
        torch.cuda.synchronize()
        assert _rel(got, want) <= TOL_SUM
        assert torch.equal(got, bsr.bsr_rmatmul(a, X))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nx", [1, 4, 16, 33, 512])
def test_bsr_rmatmul_offset_x_matches_its_aligned_copy(dev, storage, nx):
    """X that starts off a 16-byte boundary goes in element by element, an
    aligned X (nx a multiple of 4) in 16-byte pieces: the same bits."""
    a = _random_bell(dev, 37, 13, 5, 32, storage, 17 + nx)
    U = torch.randn(a.shape[0], nx, generator=_gen(dev, 3 * nx), device=dev)
    got = bsr.bsr_rmatmul(a, _off_boundary(U))
    torch.cuda.synchronize()
    assert torch.equal(got, bsr.bsr_rmatmul(a, U))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("bs,nbr,nbc,ell", [(8, 301, 40, 7), (32, 150, 16, 16),
                                            (128, 9, 5, 2), (8, 40, 5000, 4),
                                            (64, 33, 700, 3),
                                            (128, 5, 400, 2)])
def test_fused_grad_bsr_matches_plain(dev, dtype, loss, bs, nbr, nbc, ell):
    """fused_grad_bsr_multi.cu's one-slot launch on staged block-rows (up
    to 64 KB of f32) and unstaged ones (bs = 128), at n up to 51200."""
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



# -- the request-batched block-sparse kernel -----------------------------------

def _bsr_multi_inputs(dev, a, k, loss, seed):
    m, n = a.shape
    g = _gen(dev, seed)
    x = torch.randn(k, n, generator=g, device=dev) / a.ell ** 0.5
    t = torch.randn(k, m, generator=g, device=dev)
    if loss == "logistic":
        t = torch.where(t >= 0, 1.0, -1.0)
    elif loss == "poisson":
        t = torch.poisson(torch.ones(k, m, device=dev), generator=g)
    w = torch.rand(k, m, generator=g, device=dev)
    w[:, -(m // 7):] = 0.0
    return x, t, w


# (bs, nbr, nbc, ell): staged at bs 8, 16, 32 (S's shape) and 64, and at
# bs 128 in bf16; unstaged at bs 128 in f32 (the block-row passes 64 KB).
BSR_MULTI_SHAPES = [(8, 301, 40, 7), (16, 90, 60, 40), (32, 150, 16, 16),
                    (64, 33, 20, 3), (128, 9, 5, 2)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 8, 17, 31, 32, 33, 40, 64, 100])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("bs,nbr,nbc,ell", BSR_MULTI_SHAPES)
def test_fused_grad_bsr_multi_matches_plain(dev, dtype, k, loss, bs, nbr,
                                            nbc, ell):
    a = _random_bell(dev, nbr, nbc, ell, bs, dtype, nbr + ell)
    m, n = a.shape
    x, t, w = _bsr_multi_inputs(dev, a, k, loss, m + k)
    launches = fusedgrad.fused_grad_bsr_multi.launches
    got = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss=loss, param=0.5)
    assert fusedgrad.fused_grad_bsr_multi.launches == launches + 1
    want = fusedgrad.fused_grad_bsr_multi_plain(a, x, t, w, loss=loss,
                                                param=0.5)
    torch.cuda.synchronize()
    assert [v.shape for v in got] == [(k,), (k, n), (k, m)]
    assert _rel(got[0], want[0]) <= TOL
    assert _rel(got[1], want[1]) <= TOL_SUM
    assert _rel(got[2], want[2]) <= TOL
    again = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss=loss, param=0.5)
    for u, v in zip(got, again):
        assert torch.equal(u, v)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
@pytest.mark.parametrize("bs,nbr,nbc,ell", BSR_MULTI_SHAPES)
def test_fused_grad_bsr_is_slot_0_of_the_multi_kernel(dev, dtype, loss, bs,
                                                      nbr, nbc, ell):
    """fused_grad_bsr is fused_grad_bsr_multi.cu's one-slot launch: a
    request's f, g and z have the bits of slot 0 of a three-slot group, and
    each wrapper counts its own launches."""
    a = _random_bell(dev, nbr, nbc, ell, bs, dtype, nbr + 3 * ell)
    x, t, w = _bsr_multi_inputs(dev, a, 3, loss, bs + ell)
    before = (fusedgrad.fused_grad_bsr.launches,
              fusedgrad.fused_grad_bsr_multi.launches)
    one = fusedgrad.fused_grad_bsr(a, x[0], t[0], w[0], loss=loss, param=0.5)
    grp = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss=loss, param=0.5)
    torch.cuda.synchronize()
    assert (fusedgrad.fused_grad_bsr.launches,
            fusedgrad.fused_grad_bsr_multi.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert [v.shape for v in one] == [(), (a.shape[1],), (a.shape[0],)]
    for u, v in zip(one, grp):
        assert torch.equal(u, v[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_grad_bsr_multi_hot_column(dev, dtype):
    """Every block-row holds block column 3 (500 slots of one column):
    its g entries take one owner thread's adds over every block-row."""
    a = _random_bell(dev, 500, 20, 4, 16, dtype, 9, hot=3)
    x, t, w = _bsr_multi_inputs(dev, a, 8, "huber", 3)
    got = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss="huber", param=0.5)
    want = fusedgrad.fused_grad_bsr_multi_plain(a, x, t, w, loss="huber",
                                                param=0.5)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= TOL
    assert _rel(got[1], want[1]) <= TOL_SUM
    assert _rel(got[2], want[2]) <= TOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bs,nbr,nbc,ell", BSR_MULTI_SHAPES)
def test_fused_grad_bsr_multi_slots_are_independent(dev, dtype, bs, nbr, nbc,
                                                    ell):
    """A request gets the same bits alone (k = 1), in slot 0 among 7 random
    neighbours, in slot 5 among 31 others, in slot 17 among 39 and in slot
    41 among 99; zero-weight slots (the upper half) give exactly zero f
    and g."""
    a = _random_bell(dev, nbr, nbc, ell, bs, dtype, 5)
    x, t, w = _bsr_multi_inputs(dev, a, 1, "logistic", 6)
    alone = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss="logistic")
    for k, slot in ((8, 0), (32, 5), (40, 17), (100, 41)):
        x2, t2, w2 = _bsr_multi_inputs(dev, a, k, "logistic", 7 + k)
        x2[slot], t2[slot], w2[slot] = x[0], t[0], w[0]
        w2[k // 2:] = 0.0
        group = fusedgrad.fused_grad_bsr_multi(a, x2, t2, w2,
                                               loss="logistic")
        torch.cuda.synchronize()
        for u, v in zip(alone, group):
            assert torch.equal(u[0], v[slot]), k
        assert bool((group[0][k // 2:] == 0).all())
        assert bool((group[1][k // 2:] == 0).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_grad_bsr_multi_bits_do_not_depend_on_alignment(dev, dtype):
    """An X or blocks that start off a 16-byte boundary are copied to an
    aligned tensor before the staged kernel runs: the same bits as aligned
    operands, never another path."""
    a = _random_bell(dev, 150, 16, 16, 32, dtype, 19)
    x, t, w = _bsr_multi_inputs(dev, a, 8, "quad", 20)
    want = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss="quad")
    got = fusedgrad.fused_grad_bsr_multi(a, _off_boundary(x), t, w,
                                         loss="quad")
    shifted = bsr.BlockELL(_off_boundary(a.data), a.cols, a.shape)
    moved = fusedgrad.fused_grad_bsr_multi(shifted, x, t, w, loss="quad")
    torch.cuda.synchronize()
    for u, v, s in zip(want, got, moved):
        assert torch.equal(u, v) and torch.equal(u, s)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 32])
def test_bsr_kernels_take_blocks_off_a_16_byte_boundary(dev, storage, bs):
    """BlockELL data that starts off a 16-byte boundary (a view one element
    into its storage) runs through bsr_matvec, bsr_matmul, bsr_rmatmul and,
    for exact storage, fused_grad_bsr and fused_grad_bsr_multi: the same
    bits as the aligned blocks, and close to the plain versions."""
    a = _random_bell(dev, 37, 13, 5, bs, storage, 29 + bs)
    shifted = bsr.BlockELL(_off_boundary(a.data), a.cols, a.shape, a.scales)
    m, n = a.shape
    g = _gen(dev, 31)
    x = torch.randn(n, generator=g, device=dev)
    X = torch.randn(n, 16, generator=g, device=dev)
    U = torch.randn(m, 16, generator=g, device=dev)
    for kern, plain, arg, tol in (
            (bsr.bsr_matvec, bsr.bsr_matvec_plain, x, TOL),
            (bsr.bsr_matmul, bsr.bsr_matmul_plain, X, TOL),
            (bsr.bsr_rmatmul, bsr.bsr_rmatmul_plain, U, TOL_SUM)):
        got = kern(shifted, arg)
        want = kern(a, arg)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kern.__name__
        assert _rel(got, plain(a, arg)) <= tol, kern.__name__
    if storage == "int8":
        return
    xs, t, w = _bsr_multi_inputs(dev, a, 3, "logistic", 32)
    for got, want in (
            (fusedgrad.fused_grad_bsr(shifted, xs[0], t[0], w[0],
                                      loss="logistic"),
             fusedgrad.fused_grad_bsr(a, xs[0], t[0], w[0], loss="logistic")),
            (fusedgrad.fused_grad_bsr_multi(shifted, xs, t, w,
                                            loss="logistic"),
             fusedgrad.fused_grad_bsr_multi(a, xs, t, w, loss="logistic"))):
        torch.cuda.synchronize()
        for u, v in zip(got, want):
            assert torch.equal(u, v)


def test_fused_grad_bsr_multi_refuses_what_it_does_not_take(dev):
    """No slot count is refused but none; 33 slots (once past the cap)
    run against their plain version."""
    a = _random_bell(dev, 10, 6, 2, 8, "f32", 1)
    x, t, w = _bsr_multi_inputs(dev, a, 33, "quad", 2)
    got = fusedgrad.fused_grad_bsr_multi(a, x, t, w, loss="quad")
    want = fusedgrad.fused_grad_bsr_multi_plain(a, x, t, w, loss="quad")
    torch.cuda.synchronize()
    assert _rel(got[1], want[1]) <= TOL_SUM and _rel(got[2], want[2]) <= TOL
    with pytest.raises(ValueError, match="one slot or more"):
        fusedgrad.fused_grad_bsr_multi(a, x[:0], t[:0], w[:0], loss="quad")
    with pytest.raises(ValueError, match="shapes"):
        fusedgrad.fused_grad_bsr_multi(a, x[:2], t[:3], w[:2], loss="quad")
    with pytest.raises(ValueError, match="int8"):
        fusedgrad.fused_grad_bsr_multi(a.quantize_int8(), x[:2], t[:2],
                                       w[:2], loss="quad")


# The kernel a 40-slot group launches: a SparseRowMatrix dispatches as
# plan("sparse_matmul") decides.  At 40% density nearly every block-row
# stores all 6 block columns (ELL width 6 of 6), so the dense product wins
# and the group takes fused_grad_multi; one or two stored blocks a
# block-row (ELL width 2, ragged, the short rows padded) keep BlockELL.
FORTY_SLOT_KERNEL = {"dense": "fused_grad_multi",
                     "sparse": "fused_grad_multi",
                     "sparse_ragged": "fused_grad_bsr_multi"}


@pytest.mark.parametrize("matrix", ["dense", "sparse", "sparse_ragged"])
def test_forty_slot_group_launches_once_a_pass(dev, matrix):
    """A SolverServer group of 40 acc_rb requests on the card: one fused
    kernel launch for each of the server's A-passes (every 40-slot pass is
    one launch), and every answer close to the float64 least squares."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
    from repro_torch.launch.serve import SolverServer

    rng = np.random.default_rng(40)
    m, n, k = 4096, 96, 40
    a = rng.normal(size=(m, n)) / np.sqrt(n)
    if matrix == "sparse":
        a *= np.kron(rng.random((m // 16, n // 16)) < 0.4, np.ones((16, 16)))
    elif matrix == "sparse_ragged":
        mask = np.zeros((m // 16, n // 16), bool)
        for i in range(m // 16):
            mask[i, rng.choice(n // 16, rng.integers(1, 3),
                               replace=False)] = True
        a *= np.kron(mask, np.ones((16, 16)))
    a = a.astype(np.float32)
    B = (a @ rng.normal(size=(n, k)) + 0.01 * rng.normal(size=(m, k))).T
    B = B.astype(np.float32)
    A = (RowMatrix.create(torch.from_numpy(a), device=dev) if matrix == "dense"
         else SparseRowMatrix.from_dense(a, 16, device=dev))
    L0 = float(np.linalg.norm(a, 2)) ** 2
    srv = SolverServer(slots=k)
    ids = [srv.submit(api.SolveRequest(
        A=A, b=torch.from_numpy(b).to(dev), method="acc_rb", L0=L0,
        tol=1e-9, max_iters=300, device=dev)) for b in B]
    ops.reset_launch_counts()
    srv.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    kernel = FORTY_SLOT_KERNEL[matrix]
    other = ({"fused_grad_multi", "fused_grad_bsr_multi"} - {kernel}).pop()
    assert counts[kernel] == srv.stats["a_passes"] > 0
    assert counts[other] == 0
    X = np.linalg.lstsq(a.astype(np.float64), B.T.astype(np.float64),
                        rcond=None)[0]
    for j, rid in enumerate(ids):
        r = srv.result(rid)
        assert r.info["plan"] == "fused-group"
        assert float(np.abs(r.x.double().cpu().numpy() - X[:, j]).max()) \
            < 1e-3


def test_fused_grad_bsr_multi_int8_composes(dev):
    """int8 blocks compose bsr_matmul at nx = k, the residual and
    bsr_rmatmul, as the reference does."""
    a = _random_bell(dev, 70, 9, 3, 16, "int8", 4)
    x, t, w = _bsr_multi_inputs(dev, a, 8, "poisson", 5)
    ops.reset_launch_counts()
    got = ops.fused_grad_bsr_multi(a, x, t, w, loss="poisson", param=0.5)
    want = fusedgrad.fused_grad_bsr_multi_plain(a, x, t, w, loss="poisson",
                                                param=0.5)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= TOL
    assert _rel(got[1], want[1]) <= TOL_SUM
    assert _rel(got[2], want[2]) <= TOL
    counts = ops.launch_counts()
    assert (counts["bsr_matmul"], counts["bsr_rmatmul"],
            counts["fused_grad_bsr_multi"]) == (1, 1, 0)


@pytest.mark.parametrize("loss", fusedgrad.LOSSES)
def test_fused_grad_bsr_multi_int8_slot_bits(dev, loss):
    """An int8 request has the same f, g and z bits alone, in slot 0 and in
    slot 7 of an eight-slot group: bsr_matmul's and bsr_rmatmul's columns
    do not depend on nx, and the loss is summed a slot at a time."""
    a = _random_bell(dev, 300, 9, 3, 32, "int8", 6)
    x, t, w = _bsr_multi_inputs(dev, a, 8, loss, 7)
    alone = ops.fused_grad_bsr_multi(a, x[:1], t[:1], w[:1], loss=loss,
                                     param=0.5)
    x2, t2, w2 = _bsr_multi_inputs(dev, a, 8, loss, 8)
    for slot in (0, 7):
        x3, t3, w3 = x2.clone(), t2.clone(), w2.clone()
        x3[slot], t3[slot], w3[slot] = x[0], t[0], w[0]
        grp = ops.fused_grad_bsr_multi(a, x3, t3, w3, loss=loss, param=0.5)
        torch.cuda.synchronize()
        for u, v in zip(alone, grp):
            assert torch.equal(u[0], v[slot]), slot


# bf16 attention: the kernel rounds the softmax weights to bf16 before the
# PV product (as the reference kernel does) and the plain version does not;
# each weight moves by up to 2^-9 relative, and the output is rounded to
# bf16 (2^-9) on both sides.
TOL_ATTN_BF16 = 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 63), (2049, 2049),
                                   (63, 130), (130, 63), (1, 100),
                                   (2048, 2049), (2049, 2048)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_matches_plain(dev, D, group, causal, sq, sk, dtype):
    g = _gen(dev, D + 7 * group + sq + 3 * sk)
    bkv = 2
    q = torch.randn(bkv * group, sq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(bkv, sk, D, generator=g, device=dev).to(dtype)
    v = torch.randn(bkv, sk, D, generator=g, device=dev).to(dtype)
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          q_heads_per_kv=group)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 q_heads_per_kv=group)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, want) <= (TOL if dtype == torch.float32
                               else TOL_ATTN_BF16)


def _attn_inputs(dev, bkv, group, sq, sk, D, dtype, seed):
    g = _gen(dev, seed)
    return (torch.randn(bkv * group, sq, D, generator=g, device=dev).to(dtype),
            torch.randn(bkv, sk, D, generator=g, device=dev).to(dtype),
            torch.randn(bkv, sk, D, generator=g, device=dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_repeats_bit_for_bit(dev, D, dtype):
    """Fixed sum orders and no atomics: two launches, the same bits."""
    q, k, v = _attn_inputs(dev, 2, 3, 300, 300, D, dtype, seed=D)
    got = flash_attention.flash_attention(q, k, v, q_heads_per_kv=3)
    again = flash_attention.flash_attention(q, k, v, q_heads_per_kv=3)
    assert torch.equal(got, again)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", [127, 129, 200, 383])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_ragged_key_tile_bf16(dev, D, sk, causal):
    """Key lengths off the tensor-core kernel's 128-key tile: the last
    tile's missing keys arrive as zeros and must not count."""
    q, k, v = _attn_inputs(dev, 2, 3, 256, sk, D, torch.bfloat16,
                           seed=D + sk)
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          q_heads_per_kv=3)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 q_heads_per_kv=3)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL_ATTN_BF16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_large_logits(dev, D, dtype):
    """Scores up to about 50 in size, so the running max moves by tens
    from one key tile to the next and the rescale of O and l counts."""
    q, k, v = _attn_inputs(dev, 2, 3, 520, 520, D, torch.float32, seed=5)
    # s = q·k / sqrt(D) is N(0, 1) for unit normals; q * 10 makes it
    # N(0, 100), whose largest of 3 · 520² draws is near 50.
    q, k, v = (q * 10.0).to(dtype), k.to(dtype), v.to(dtype)
    scores = (q[:3].float() @ k[:1].float().transpose(1, 2)) / D ** 0.5
    assert scores.abs().max() >= 40.0
    got = flash_attention.flash_attention(q, k, v, q_heads_per_kv=3)
    want = flash_attention.flash_attention_plain(q, k, v, q_heads_per_kv=3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= (TOL if dtype == torch.float32
                               else TOL_ATTN_BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kv_row_across_heads(dev, dtype):
    """Four KV heads, three q heads each: q head h reads KV head h // 3.
    Each q head alone against its KV head gives the same bits as the
    grouped launch, and the KV heads differ, so a wrong row would show."""
    q, k, v = _attn_inputs(dev, 4, 3, 200, 200, 128, dtype, seed=11)
    scale = torch.arange(1, 5, device=dev, dtype=dtype)[:, None, None]
    k, v = (k * scale).contiguous(), (v * scale).contiguous()
    got = flash_attention.flash_attention(q, k, v, q_heads_per_kv=3)
    for h in range(12):
        alone = flash_attention.flash_attention(
            q[h:h + 1].contiguous(), k[h // 3:h // 3 + 1].contiguous(),
            v[h // 3:h // 3 + 1].contiguous())
        assert torch.equal(got[h:h + 1], alone), h
    want = flash_attention.flash_attention_plain(q, k, v, q_heads_per_kv=3)
    torch.cuda.synchronize()
    assert _rel(got, want) <= (TOL if dtype == torch.float32
                               else TOL_ATTN_BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_counts_its_variant(dev, dtype):
    """A bf16 call launches the tensor-core variant alone, an f32 call the
    CUDA-core one; ops.reset_launch_counts zeroes both counts."""
    q, k, v = _attn_inputs(dev, 1, 2, 70, 70, 64, dtype, seed=1)
    ops.reset_launch_counts()
    assert set(flash_attention.flash_attention.variant_launches.values()) \
        == {0}
    flash_attention.flash_attention(q, k, v, q_heads_per_kv=2)
    mine = flash_attention.VARIANTS[dtype]
    assert flash_attention.flash_attention.variant_launches == {
        name: int(name == mine) for name in
        flash_attention.VARIANTS.values()}
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_counts_its_mask(dev, causal):
    """A launch counts under "causal" or "non_causal";
    ops.reset_launch_counts zeroes both."""
    q, k, v = _attn_inputs(dev, 1, 2, 70, 50, 64, torch.bfloat16, seed=2)
    ops.reset_launch_counts()
    assert set(flash_attention.flash_attention.mask_launches.values()) == {0}
    flash_attention.flash_attention(q, k, v, causal=causal,
                                    q_heads_per_kv=2)
    assert flash_attention.flash_attention.mask_launches == {
        "causal": int(causal), "non_causal": int(not causal)}


def test_flash_attention_dispatch_counts_launches(dev):
    g = _gen(dev, 3)
    q = torch.randn(2, 6, 100, 64, generator=g, device=dev)
    k = torch.randn(2, 2, 100, 64, generator=g, device=dev)
    v = torch.randn(2, 2, 100, 64, generator=g, device=dev)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert ops.launch_counts()["flash_attention"] == 1
    assert _rel(got.cpu(), want) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_takes_views_off_a_16_byte_boundary(dev, D, dtype):
    """q, k and v that start one element past a 16-byte boundary (as
    ``x[1:]`` views can) are copied to aligned tensors: the same bits as
    aligned inputs, through the wrapper and through ops."""
    q, k, v = _attn_inputs(dev, 2, 3, 130, 200, D, dtype, seed=D + 3)
    want = flash_attention.flash_attention(q, k, v, q_heads_per_kv=3)
    qs, ks, vs = (_off_boundary(t) for t in (q, k, v))
    got = flash_attention.flash_attention(qs, ks, vs, q_heads_per_kv=3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = flash_attention.flash_attention_plain(q, k, v, q_heads_per_kv=3)
    assert _rel(got, plain) <= (TOL if dtype == torch.float32
                                else TOL_ATTN_BF16)
    q4, k4, v4 = (t.view(2, -1, t.shape[1], D) for t in (qs, ks, vs))
    assert torch.equal(ops.flash_attention(q4, k4, v4).view(q.shape), want)


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.randn(4, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.randn(4, 16, 256, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.randn(4, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q, q, q)
    q = torch.randn(4, 64, 16, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q, q, q)
    q = torch.randn(4, 16, 64, device=dev)
    with pytest.raises(ValueError, match="conform"):
        flash_attention.flash_attention(q, q[:3], q[:3], q_heads_per_kv=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(2048, 2048), (2049, 2049), (2048, 2049),
                                   (65, 63)])
def test_flash_attention_mla_prefill_shape(dev, sq, sk, dtype):
    """DeepSeek's MLA prefill: D = 192 (128 + 64 rotary columns), one q
    head a KV head, the rotary key's columns the same in every head and v
    zero past column 128, scale 1/sqrt(192): the padded output columns are
    exactly 0 and the rest within the limits of plain."""
    H = 8
    g = _gen(dev, sq + 3 * sk)
    q = torch.randn(H, sq, 192, generator=g, device=dev)
    k = torch.randn(H, sk, 192, generator=g, device=dev)
    k[:, :, 128:] = k[:1, :, 128:]
    v = torch.zeros(H, sk, 192, device=dev)
    v[:, :, :128] = torch.randn(H, sk, 128, generator=g, device=dev)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    scale = 1.0 / 192 ** 0.5
    got = flash_attention.flash_attention(q, k, v, scale=scale)
    want = flash_attention.flash_attention_plain(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert not got[..., 128:].any()
    assert _rel(got, want) <= (TOL if dtype == torch.float32
                               else TOL_ATTN_BF16)


def test_mla_prefill_refuses_the_smoke_head_on_the_card(dev):
    """The smoke MLA's materialized head (32 + 16 = 48) is not one of
    HEAD_DIMS: its prefill raises on the card, with no plain fallback."""
    from repro_torch import configs
    from repro_torch.models import build, smoke_config

    cfg = smoke_config(configs.get("deepseek-v2-236b"))
    model = build(cfg, device=dev)
    params = model.init(_gen(dev, 0))
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 48"):
        model.prefill(params, {"tokens": toks}, model.init_caches(2, 10))
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch,counts,non_causal", [
    ("zamba2-1.2b", {"selective_scan": 4, "flash_attention": 2}, 0),
    ("seamless-m4t-large-v2", {"flash_attention": 6}, 4)])
def test_smoke_hybrid_and_encdec_on_the_card(dev, arch, counts, non_causal):
    """The smoke zamba2 (4 Mamba2 layers in 2 groups) and seamless (2 + 2
    layers, 8 frames) with the CPU's weights: prefill (its kernel
    launches, by mask) and 2 decode steps (no launch) within TOL of the
    CPU's plain path."""
    import copy

    from repro_torch import configs
    from repro_torch.models import build, smoke_config

    cfg = smoke_config(configs.get(arch))
    cpu, card = build(cfg, device="cpu"), build(cfg, device=dev)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_card = copy.deepcopy(p_cpu).to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 19),
                         generator=torch.Generator().manual_seed(1))
    frames = torch.randn(2, 8, cfg.d_model,
                         generator=torch.Generator().manual_seed(2)) * 0.02
    outs = []
    for model, params, d in ((cpu, p_cpu, "cpu"), (card, p_card, dev)):
        batch = {"tokens": toks[:, :17].to(d)}
        if cfg.family == "encdec":
            batch["frontend_embeds"] = frames.to(d)
            caches = model.init_caches(2, 19, 8)
        else:
            caches = model.init_caches(2, 19)
        ops.reset_launch_counts()
        logits, caches = model.prefill(params, batch, caches)
        got = [logits]
        if d != "cpu":
            torch.cuda.synchronize()
            want = dict.fromkeys(ops.launch_counts(), 0) | counts
            assert ops.launch_counts() == want
            mask = flash_attention.flash_attention.mask_launches
            assert mask["non_causal"] == non_causal
            ops.reset_launch_counts()
        for i in range(2):
            logits, caches = model.decode_step(
                params, toks[:, 17 + i:18 + i].to(d), caches, 17 + i)
            got.append(logits)
        if d != "cpu":
            torch.cuda.synchronize()
            assert not any(ops.launch_counts().values())
        outs.append(torch.cat(got, 1)[..., :cfg.vocab_size].cpu())
    assert _rel(outs[1], outs[0]) <= TOL


def _scan_args(dev, Bt, S, d, N, seed):
    g = _gen(dev, seed)
    return (torch.randn(Bt, S, d, generator=g, device=dev),
            torch.rand(Bt, S, d, generator=g, device=dev) * 0.1,
            -torch.rand(d, N, generator=g, device=dev) - 0.1,
            torch.randn(Bt, S, N, generator=g, device=dev),
            torch.randn(Bt, S, N, generator=g, device=dev),
            torch.randn(d, generator=g, device=dev))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 37, 300])
@pytest.mark.parametrize("N", selective_scan.STATE_DIMS)
@pytest.mark.parametrize("Bt,d", [(1, 128), (3, 200), (2, 1000)])
def test_selective_scan_matches_plain(dev, Bt, d, N, S, with_h0):
    args = _scan_args(dev, Bt, S, d, N, seed=Bt * d + N + S)
    h0 = (torch.randn(Bt, d, N, generator=_gen(dev, 1), device=dev)
          if with_h0 else None)
    y, h = selective_scan.selective_scan(*args, h0=h0)
    y0, h0_ = selective_scan.selective_scan_plain(*args, h0=h0)
    torch.cuda.synchronize()
    assert y.shape == (Bt, S, d) and h.shape == (Bt, d, N)
    assert _rel(y, y0) <= TOL
    assert _rel(h, h0_) <= TOL


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("d", [1, 100, 200, 1000])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 300, 2049])
@pytest.mark.parametrize("N", selective_scan.STATE_DIMS)
def test_selective_scan_edges_match_plain(dev, N, S, d, with_h0):
    """S on both sides of the 16-step tile and the 3-stage ring (1, 31, 32,
    33, 300, 2049), d of one channel, off the 16- to 128-channel block
    (100, 200, 1000), from zero and from a nonzero state: y and the final
    state within TOL of plain, and the same bits twice."""
    args = _scan_args(dev, 2, S, d, N, seed=7 * S + d + N)
    h0 = (torch.randn(2, d, N, generator=_gen(dev, 3), device=dev)
          if with_h0 else None)
    y, h = selective_scan.selective_scan(*args, h0=h0)
    y0, h0_ = selective_scan.selective_scan_plain(*args, h0=h0)
    torch.cuda.synchronize()
    assert y.shape == (2, S, d) and h.shape == (2, d, N)
    assert _rel(y, y0) <= TOL
    assert _rel(h, h0_) <= TOL
    y2, h2 = selective_scan.selective_scan(*args, h0=h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_selective_scan_dispatch_counts_launches(dev):
    args = _scan_args(dev, 2, 40, 130, 16, seed=9)
    ops.reset_launch_counts()
    y, h = ops.selective_scan(*args)
    y0, h0 = ops.selective_scan(*(a.cpu() for a in args))
    assert ops.launch_counts()["selective_scan"] == 1
    assert _rel(y.cpu(), y0) <= TOL and _rel(h.cpu(), h0) <= TOL


def test_selective_scan_refuses_what_it_does_not_take(dev):
    x, dt, A, B, C, D = _scan_args(dev, 1, 8, 64, 16, seed=2)
    with pytest.raises(TypeError, match="float32"):
        selective_scan.selective_scan(x.bfloat16(), dt, A, B, C, D)
    with pytest.raises(ValueError, match="state dim"):
        selective_scan.selective_scan(x, dt, A[:, :4].contiguous(),
                                      B[..., :4].contiguous(),
                                      C[..., :4].contiguous(), D)
    with pytest.raises(ValueError, match="shape"):
        selective_scan.selective_scan(x, dt[:, :4], A, B, C, D)


# -- the §2 matrix types and the Figure-1 problems on the card ---------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1000, 777, 1333), (4096, 4096, 4096)])
def test_block_multiply_runs_gemm(dev, dtype, m, k, n):
    """BlockMatrix.multiply is one gemm launch, f32 accumulation, A's type
    out; the same bits twice."""
    from repro_torch.core.distmat import BlockMatrix
    g = torch.Generator(device=dev).manual_seed(31)
    a = torch.randn(m, k, generator=g, device=dev).to(dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(dtype)
    A, B = BlockMatrix.create(a, device=dev), BlockMatrix.create(b, device=dev)
    ops.reset_launch_counts()
    got = A.multiply(B)
    assert ops.launch_counts()["gemm"] == 1
    want = gemm.gemm_plain(a, b, torch.float32).to(dtype)
    torch.cuda.synchronize()
    assert got.data.dtype == dtype and got.shape == (m, n)
    assert _rel(got.data, want) <= _gemm_tol(dtype)
    assert torch.equal(got.data, A.multiply(B).data)


def test_coordinate_products_and_conversion_on_the_card(dev):
    import numpy as np
    from repro_torch.core.distmat import CoordinateMatrix
    rng = np.random.default_rng(32)
    m, n, nnz = 3000, 700, 40000
    ri, ci = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    va = rng.normal(size=nnz).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=m).astype(np.float32))
    gpu = CoordinateMatrix.create(ri, ci, va, (m, n), device=dev)
    cpu = CoordinateMatrix.create(ri, ci, va, (m, n), device="cpu")
    assert _rel(gpu.matvec(x.to(dev)).cpu(), cpu.matvec(x)) <= TOL
    assert _rel(gpu.rmatvec(y.to(dev)).cpu(), cpu.rmatvec(y)) <= TOL
    # Sorted runs summed by segment_reduce: the same bits every call.
    assert torch.equal(gpu.matvec(x.to(dev)), gpu.matvec(x.to(dev)))
    assert torch.equal(gpu.rmatvec(y.to(dev)), gpu.rmatvec(y.to(dev)))
    for bs in (8, 32):
        s_gpu, s_cpu = gpu.to_sparse_row_matrix(bs), cpu.to_sparse_row_matrix(bs)
        assert s_gpu.device == dev
        assert torch.equal(s_gpu.cols.cpu(), s_cpu.cols)
        # Duplicate entries add up by atomics on the card: their sums may
        # round apart.
        assert _rel(s_gpu.data.cpu(), s_cpu.data) <= 1e-6
        assert s_gpu.nnz == s_cpu.nnz
        ops.reset_launch_counts()
        # Uniform entries fill most blocks: dispatch="auto" would take the
        # dense product here, so the BlockELL kernel is asked for.
        got = s_gpu.matvec(x.to(dev), dispatch="bsr")
        assert ops.launch_counts()["bsr_matvec"] == 1
        assert _rel(got.cpu()[:m], cpu.matvec(x)) <= TOL


def test_make_problem_lipschitz_on_the_card(dev):
    from repro_torch.core import optim
    for name in ("linear", "logistic_l2"):
        gpu = optim.make_problem(name, m=3000, n=200, device=dev)
        cpu = optim.make_problem(name, m=3000, n=200, device="cpu")
        assert gpu.linop.device == dev
        assert torch.equal(gpu.linop.A.rows.cpu(), cpu.linop.A.rows)
        assert abs(gpu.L - cpu.L) <= 1e-9 * cpu.L
