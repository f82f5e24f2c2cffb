"""float8_e5m2 storage in the port against the reference on the CPU.

tests/test_torch_fp8.py's shared tests run here on float8_e5m2 (this
module's `fp8` fixture overrides that module's): the cast
(kernels/dtypes.to_e5m2) bit for bit against jax's ``astype`` at the
edges (±57344, the overflow midpoint 61440, past it, ±inf, NaNs of
several payloads and signs, -0, the subnormal steps), on random f32 and
bf16 values and on every bf16 bit pattern; the reference's e5m2 arrays
carried across by convert; the plain versions of the four kernels e5m2
reaches on the main path (fused_grad, fused_grad_multi, tsgram, gemm)
against the reference's CPU dispatch, tsgram and gemm also against its
Pallas kernels in interpret mode (randsketch: tests/test_torch_sketch_fp8.py);
RowMatrix.create and astype_store (the reference's bits), the Gram and
the Gram SVD (U in e5m2), api.solve on each engine, loss and reg the e4m3
tests run, one trace through both servers; every path the reference
refuses raising TypeError with no launch; one two-rank gloo mesh.  Here
besides: the planner prices each e5m2 route as its e4m3 twin."""
import pytest
import torch

import test_torch_fp8 as F
from fp8_types import TYPE_E5M2, Fp8
from repro_torch.kernels import autotune as at
from repro_torch.launch import planner
from test_torch_fp8 import (  # noqa: F401  (collected here on e5m2)
    _isolated, e4m3_pair, test_cast_is_the_references_bit_for_bit,
    test_cast_keeps_shape_and_is_idempotent,
    test_cast_takes_every_bf16_pattern,
    test_fused_grad_multi_plain_matches_reference,
    test_fused_grad_plain_matches_reference,
    test_gemm_plain_matches_reference_and_its_kernel,
    test_gram_and_gram_svd_match_reference,
    test_refused_where_the_reference_raises, test_server_matches_reference,
    test_solve_matches_reference, test_storage_takes_the_references_bits,
    test_tsgram_plain_matches_reference_and_its_kernel,
    test_two_rank_mesh_matches_one_rank)

E5M2 = torch.float8_e5m2

test_e5m2_arrays_cross_by_their_bits = F.test_e4m3_arrays_cross_by_their_bits
test_explicit_bf16_recasts_e5m2_storage = \
    F.test_explicit_bf16_recasts_e4m3_storage


@pytest.fixture(scope="module")
def fp8() -> Fp8:
    """The fp8 type the shared tests run on here."""
    return TYPE_E5M2


def test_plans_price_e5m2_as_e4m3():
    """Every e5m2 route priced as its e4m3 twin: the fused kernel (f32
    FMA), tsgram's f16 products, gemm's TF32 products, randsketch's one
    TF32 product for fp8 A and Q (two for f32 Q); the chunked schedules
    compete on a mesh, the unfused route is never chosen."""
    E4M3 = torch.float8_e4m3fn
    m, n = 1 << 21, 1024
    for op in ("grad", "gram"):
        p5 = planner.plan(op, {"m": m, "n": n}, E5M2, backend="cuda")
        p4 = planner.plan(op, {"m": m, "n": n}, E4M3, backend="cuda")
        assert p5.terms == p4.terms and p5.cost_s == p4.cost_s
    assert p5.terms["route"] == "bf16"
    for kernel, dims in (("gemm", {"m": m, "k": n, "n": 16}),
                         ("randsketch", {"m": m, "n": n, "r": 26}),
                         ("randsketch", {"m": m, "n": n, "r": 512,
                                         "q_itemsize": 1})):
        blocks = at.legacy(kernel, dims, E5M2)
        assert at.cost_terms(kernel, blocks, dims, E5M2) == \
            at.cost_terms(kernel, blocks, dims, E4M3)
    sk = at.cost_terms("randsketch", {}, {"m": m, "n": n, "r": 26}, E5M2)
    assert sk.route == "tf32" and sk.flops == 2 * 2.0 * m * n * 26
    sk1 = at.cost_terms("randsketch", {}, {"m": m, "n": n, "r": 26,
                                           "q_itemsize": 1}, E5M2)
    assert sk1.flops == 2.0 * m * n * 26
    ctx = {"axes": (64,)}
    grad = planner.plan("grad", {"m": 4096, "n": 4096}, E5M2, context=ctx)
    assert grad.choice == "fused"
    assert "unfused" in dict(grad.alternatives)
    assert any(lb.startswith("fused-overlap") for lb, _ in grad.alternatives)
