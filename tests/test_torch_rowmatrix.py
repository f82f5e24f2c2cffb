"""The port's RowMatrix against the reference's, method by method, on the CPU.

The same numpy rows go into ``repro.core.distmat.RowMatrix`` (one CPU
device) and, through ``repro_torch.convert``, into the port's RowMatrix on
``device="cpu"``.  A padded copy (zero rows past ``n_rows``, as a matrix
laid out over several devices carries) must give the same answers on the
true rows.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.distmat import RowMatrix as JRowMatrix
from repro.core.tfocs import SmoothHuber as JHuber
from repro.core.tfocs import SmoothLogLoss as JLog
from repro.core.tfocs import SmoothPoisson as JPoisson
from repro.core.tfocs import SmoothQuad as JQuad
from repro_torch import convert
from repro_torch.core.distmat import RowMatrix, pad_rows
from repro_torch.core.distmat import types as T
from repro_torch.core.tfocs import (SmoothHuber, SmoothLogLoss,
                                    SmoothPoisson, SmoothQuad)

M, N = 150, 36
STORE = {"f32": None, "bf16": jnp.bfloat16}
TORCH_STORE = {"f32": None, "bf16": torch.bfloat16}


def _rows(seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)


def _pair(store="f32", seed=0, pad=0):
    """(reference RowMatrix, port RowMatrix) over the same rows; the port's
    copy carries `pad` zero rows past n_rows."""
    a = _rows(seed)
    ref = JRowMatrix.create(jnp.asarray(a), store_dtype=STORE[store])
    rows = np.asarray(ref.rows)
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, N), rows.dtype)])
    port = convert.rowmatrix_from_numpy(rows, ref.n_rows, device="cpu")
    return ref, port


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_create_matches_reference_layout(store):
    a = _rows(1)
    ref = JRowMatrix.create(jnp.asarray(a), store_dtype=STORE[store])
    port = RowMatrix.create(a, device="cpu", store_dtype=TORCH_STORE[store])
    assert port.shape == ref.shape == (M, N)
    assert port.n_rows == ref.n_rows
    assert port.rows.dtype == (torch.float32 if store == "f32"
                               else torch.bfloat16)
    assert port.out_dtype == torch.float32
    assert np.dtype(ref.out_dtype) == np.float32
    # Same stored values, bf16 rounding included.
    _close(port.rows, np.asarray(ref.rows, np.float32), 0.0)
    assert port.device == torch.device("cpu")


def test_create_refuses_other_storage_and_missing_card(monkeypatch):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        RowMatrix.create(_rows(), device="cpu", store_dtype=torch.float16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RowMatrix.create(_rows())            # device defaults to the card


def test_astype_store_and_row_mask():
    ref, port = _pair(pad=6)
    assert port.astype_store(torch.float32) is port
    low = port.astype_store(torch.bfloat16)
    assert low.rows.dtype == torch.bfloat16 and low.n_rows == port.n_rows
    want = np.asarray(ref.astype_store(jnp.bfloat16).rows, np.float32)
    _close(low.rows[:M], want, 0.0)
    mask = port._row_mask()
    assert mask.shape == (M + 6,) and mask.dtype == torch.float32
    assert mask[:M].eq(1).all() and mask[M:].eq(0).all()
    _close(mask[:M], ref._row_mask())


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("pad", [0, 10])
def test_gram_matvec_rmatvec(store, pad):
    ref, port = _pair(store, seed=2, pad=pad)
    port = port.astype_store(TORCH_STORE[store] or torch.float32)
    G = port.gram()
    assert G.dtype == torch.float32 and G.shape == (N, N)
    _close(G, ref.gram(chunks=1), 1e-4)
    rng = np.random.default_rng(3)
    v = rng.normal(size=N).astype(np.float32)
    y = port.matvec(torch.from_numpy(v))
    assert y.shape == (M + pad,)
    _close(y[:M], ref.matvec(jnp.asarray(v)), 1e-5)
    assert y[M:].eq(0).all()
    u = rng.normal(size=M).astype(np.float32)
    up = np.concatenate([u, rng.normal(size=pad).astype(np.float32)])
    # Padding rows are zero, so whatever u holds there adds nothing.
    _close(port.rmatvec(torch.from_numpy(up)), ref.rmatvec(jnp.asarray(u)),
           1e-5)


def test_chunks_other_than_one_wait_for_multi_gpu():
    """Since the cluster path landed, chunks > 1 runs the overlapped
    bodies on one device too: the chunked Gram and fused gradient against
    the reference's chunked bodies and the port's eager ones, within
    tolerance (queue 3: not bit for bit); "auto" on one shard is eager."""
    ref, port = _pair()
    _close(port.gram(chunks=2), ref.gram(chunks=2), 5e-5)
    _close(port.gram(chunks=4), port.gram(chunks=1), 5e-5)
    assert torch.equal(port.gram(chunks="auto"), port.gram(chunks=1))
    rng = np.random.default_rng(7)
    x = (0.1 * rng.normal(size=N)).astype(np.float32)
    b = rng.normal(size=M).astype(np.float32)
    f, g, z = port.fused_grad(torch.from_numpy(x),
                              SmoothQuad(torch.from_numpy(b)), chunks=3)
    jf, jg, jz = ref.fused_grad(jnp.asarray(x), JQuad(jnp.asarray(b)),
                                chunks=3)
    _close(f, jf, 1e-5)
    _close(g, jg, 1e-4)
    _close(z[:M], np.asarray(jz)[:M], 1e-4)
    ef, eg, ez = port.fused_grad(torch.from_numpy(x),
                                 SmoothQuad(torch.from_numpy(b)),
                                 chunks="auto")
    assert torch.equal(ef, f) and torch.equal(ez, z)
    _close(g, eg, 1e-5)


SMOOTHS = {
    "quad": (lambda b, w: SmoothQuad(b, weights=w),
             lambda b, w: JQuad(b, weights=w)),
    "logistic": (lambda b, w: SmoothLogLoss(b, weights=w),
                 lambda b, w: JLog(b, weights=w)),
    "huber": (lambda b, w: SmoothHuber(b, delta=0.4, weights=w),
              lambda b, w: JHuber(b, delta=0.4, weights=w)),
    "poisson": (lambda b, w: SmoothPoisson(b, weights=w),
                lambda b, w: JPoisson(b, weights=w)),
}


@pytest.mark.parametrize("loss", sorted(SMOOTHS))
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_grad_pads_targets_and_masks_padding(loss, weighted):
    ref, port = _pair(seed=4, pad=7)
    rng = np.random.default_rng(5)
    b = rng.normal(size=M).astype(np.float32)
    if loss == "logistic":
        b = np.sign(b) + (b == 0)
    if loss == "poisson":
        b = rng.poisson(1.0, M).astype(np.float32)
    w = rng.random(M).astype(np.float32) if weighted else None
    x = rng.normal(size=N).astype(np.float32)
    mk, jmk = SMOOTHS[loss]
    f, g, z = port.fused_grad(
        torch.from_numpy(x),
        mk(torch.from_numpy(b), None if w is None else torch.from_numpy(w)))
    jf, jg, jz = ref.fused_grad(
        jnp.asarray(x), jmk(jnp.asarray(b),
                            None if w is None else jnp.asarray(w)), chunks=1)
    assert z.shape == (M + 7,)
    _close(f, jf, 1e-5)
    _close(g, jg, 1e-4)
    _close(z[:M], jz, 1e-4)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_multiply_local_keeps_storage_type(store):
    ref, port = _pair(store, seed=6, pad=3)
    B = np.random.default_rng(7).normal(size=(N, 5)).astype(np.float32)
    out = port.multiply_local(torch.from_numpy(B))
    want = ref.multiply_local(jnp.asarray(B))
    assert out.rows.dtype == port.rows.dtype and out.n_rows == M
    assert out.rows.shape == (M + 3, 5)
    _close(out.to_local(), np.asarray(want.to_local(), np.float32),
           1e-5 if store == "f32" else 1e-2)


def test_column_stats_and_frobenius_norm():
    ref, port = _pair(seed=8, pad=5)
    got, want = port.column_stats(), ref.column_stats()
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], 1e-5)
    _close(port.frobenius_norm(), ref.frobenius_norm(), 1e-5)
    _close(port.to_local(), ref.to_local(), 0.0)
    assert port.to_local().shape == (M, N)


def test_pad_rows_and_row_separable_inputs():
    x, m = pad_rows(torch.ones(5, 3), 4)
    assert m == 5 and x.shape == (8, 3) and x[5:].eq(0).all()
    b = torch.arange(5.0)
    kind, t, w, prm = T.row_separable_inputs(
        SmoothHuber(b, delta=0.3), 8, lambda: torch.ones(8))
    assert (kind, prm) == ("huber", pytest.approx(0.3))
    assert t.shape == w.shape == (8,) and t[5:].eq(0).all()
    _, _, w, _ = T.row_separable_inputs(
        SmoothQuad(b, weights=torch.full((5,), 2.0)), 8, None)
    assert w.tolist() == [2.0] * 5 + [0.0] * 3
    with pytest.raises(ValueError, match="row-separable"):
        T.row_separable_inputs(object(), 8, None)


def test_bf16_crosses_by_bit_pattern():
    a = (np.random.default_rng(9).normal(size=(7, 3))
         .astype(ml_dtypes.bfloat16))
    t = convert.tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          a.view(np.int16))
    v = convert.vector_from_numpy(np.arange(4, dtype=np.float64),
                                  device="cpu")
    assert v.dtype == torch.float32 and v.tolist() == [0.0, 1.0, 2.0, 3.0]
