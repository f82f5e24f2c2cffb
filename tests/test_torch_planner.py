"""The port's execution planner (src/repro_torch/launch/planner.py) on the
CPU: plan("svd") against the reference's on a grid, the counterparts of
tests/test_planner.py whose assertions are not goldens of the reference's
TPU instance, goldens of the H100 instance (each derived in a comment from
the data sheet's figures), and the check that at efficiency 1 the model's
time of each kernel at PERF.md §6's shapes is that row's bound."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import planner as jplanner
from repro_torch.core.distmat import RowMatrix, SparseRowMatrix
from repro_torch.core.linalg.svd import auto_mode
from repro_torch.core.tfocs import solver as tsolver
from repro_torch.core.tfocs.linop import LinopMatrix
from repro_torch.core.tfocs.smooth import SmoothQuad
from repro_torch.kernels import autotune as at
from repro_torch.launch import machine as pm
from repro_torch.launch import planner


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    at.reset()
    yield
    at.reset()


A = {"m": 1 << 21, "n": 1024}
S = {"m": 1 << 22, "n": 1 << 14, "nx": 1, "ell": 16, "bs": 32}
HBM = 3.35e12


# -- plan("svd") against the reference ------------------------------------------

SVD_GRID = [({"m": m, "n": n, "k": k}, ctx)
            for m in (1000, 100000)
            for n in (512, 8192, 8193, 20000)
            for k in (8, 128, 129)
            for ctx in ({"kind": "row"}, {"kind": "other"},
                        {"kind": "sparse", "nnz": 40000},
                        {"kind": "row", "gram_threshold": 1024},
                        {"kind": "row", "randomized_k_threshold": 8})
            if k <= min(m, n)]


@pytest.mark.parametrize("dims,ctx", SVD_GRID)
def test_svd_mode_matches_the_reference(dims, ctx):
    want = jplanner.plan("svd", dims, context=ctx).choice
    got = planner.plan("svd", dims, context=ctx)
    assert got.choice == want
    kind = ctx["kind"]
    assert auto_mode(dims["n"], dims["k"], kind=kind, m=dims["m"],
                     nnz=ctx.get("nnz"),
                     **{k: v for k, v in ctx.items()
                        if k.endswith("threshold")}) == want


def test_svd_plan_prices_every_mode():
    p = planner.plan("svd", {"m": 1 << 18, "n": 16384, "k": 16},
                     context={"kind": "row"})
    assert p.choice == "randomized"
    assert dict(p.alternatives).keys() == {"gram", "randomized", "lanczos"}
    assert p.cost_s == dict(p.alternatives)["randomized"]


# -- precision ---------------------------------------------------------------------

def test_no_tol_means_no_sweep():
    p = planner.plan("grad", A)
    assert p.precision == ""
    q = planner.plan("grad", A, context={"tol": 1e-9})
    assert q.precision == "f32"
    assert q.choice == p.choice and dict(q.blocks) == dict(p.blocks)
    assert q.cost_s == p.cost_s


@pytest.mark.parametrize("op,dims", [("grad", A), ("gram", A),
                                     ("matvec", A), ("sparse_matmul", S)])
@pytest.mark.parametrize("tol", [1e-12, 1e-9, 9.99e-6])
def test_tol_under_every_guard_gives_f32(op, dims, tol):
    assert planner.plan(op, dims, context={"tol": tol}).precision == "f32"


@pytest.mark.parametrize("op,dims", [("grad", {"m": 64, "n": 32}),
                                     ("gram", {"m": 64, "n": 32}),
                                     ("matvec", {"m": 64, "n": 32}),
                                     ("sparse_matmul", {"m": 256, "n": 256,
                                                        "nx": 1, "ell": 2,
                                                        "bs": 32})])
def test_tiny_shapes_stay_f32(op, dims):
    """The savings floor: max(20% of the f32 time, 2 µs)."""
    assert planner.plan(op, dims, context={"tol": 1e-2}).precision == "f32"


@pytest.mark.parametrize("op,dims,tol,want", [
    ("grad", A, 1e-4, "bf16"), ("matvec", A, 1e-4, "bf16"),
    # tsgram is compute-bound: three TF32 products at 495e12 in f32, one
    # bf16 product at 989e12 in bf16, a sixth of the time.
    ("gram", {"m": 1 << 16, "n": 8192}, 1e-4, "bf16"),
    ("sparse_matmul", S, 1e-3, "int8"), ("sparse_matmul", S, 1e-4, "bf16"),
    ("sparse_matmul", S, 1e-6, "f32"),
    ("gram", {"m": 512, "n": 8192}, 5e-6, "psum8")])
def test_precision_is_the_argmin_of_its_alternatives(op, dims, tol, want):
    ctx = {"tol": tol}
    if want == "psum8":
        ctx["axes"] = (64,)
    p = planner.plan(op, dims, context=ctx)
    assert p.precision == want, p.explain()
    assert p.dtype == "float32"
    alts = {k: v for k, v in p.alternatives if k.startswith("precision:")}
    assert f"precision:{p.precision}" == min(alts, key=alts.get)
    text = p.explain()
    assert f"precision: {p.precision}" in text
    if want != "f32":
        assert "saved" in text and "modeled bytes" in text


def test_bf16_halves_the_grads_hbm_bytes():
    """At A (bandwidth-bound, 2.57 ms) bf16 storage halves A's bytes:
    (2^31·2 + 4·(1024 + 2·2^21) + 4·(2^21 + 1024 + 1)) / 3.35e12 s."""
    f32 = planner.plan("grad", A)
    bf = planner.plan("grad", A, "bfloat16")
    assert bf.terms["hbm_bytes"] == pytest.approx(
        f32.terms["hbm_bytes"] - (1 << 31) * 2, rel=1e-15)
    assert f32.cost_s / bf.cost_s == pytest.approx(1.994, abs=1e-3)
    p = planner.plan("grad", A, context={"tol": 1e-4})
    assert p.precision == "bf16" and p.cost_s == bf.cost_s


# -- the decisions ---------------------------------------------------------------

def test_sparse_break_even_moves_with_density():
    """Monotone in ell: once the dense gemm wins it keeps winning.  At
    nx = 128 the BlockELL product reads its blocks once a 32-column tile
    (4 reads) against the dense gemm's 4 reads of A, so dense wins once
    ell·(bs²·4 + 4) > nbc·bs²·4, at the full block row."""
    flips = [planner.plan("sparse_matmul",
                          {"m": 4096, "n": 2048, "nx": 128, "ell": ell,
                           "bs": 128}).choice for ell in range(1, 17)]
    assert flips[0] == "bsr" and flips[-1] == "dense"
    first = flips.index("dense")
    assert all(c == "dense" for c in flips[first:])


@pytest.mark.parametrize("m,n", [(8, 512), (16, 1024), (64, 512),
                                 (10000, 1024), (1 << 21, 1024),
                                 (1 << 18, 16384), (100, 4096)])
def test_the_fused_boundary(m, n):
    """Neither side pads on the H100, so the fused pass (one read of A)
    never models slower than apply + adjoint (two): the boundary the
    reference drew at tiny shards (lane padding) is not there."""
    p = planner.plan("grad", {"m": m, "n": n})
    alt = dict(p.alternatives)
    assert p.choice == "fused" and alt["fused"] <= alt["unfused"]
    one = planner._pass_terms(m, n, "float32")
    assert alt["unfused"] == pytest.approx(
        2 * pm.H100.time(one, "float32"), rel=1e-15)


def test_bs_auto_matches_the_direct_argmin():
    ell_by_bs = {8: 80, 16: 44, 32: 24, 64: 14, 128: 8}
    p = planner.plan("bsr_bs", {"m": 4096, "n": 2048, "nx": 128},
                     context={"ell_by_bs": ell_by_bs})
    direct = min(ell_by_bs, key=lambda bs: pm.H100.time(
        planner.bsr_bs_terms(4096, 2048, 128, ell_by_bs[bs], bs, "float32"),
        "float32"))
    assert p.blocks["bs"] == direct
    assert len(p.alternatives) == len(ell_by_bs)


def test_dispatch_sites_consult_the_planner():
    rng = np.random.default_rng(0)
    mask = rng.random((8, 16)) < 0.1
    dense = (np.kron(mask, np.ones((64, 64)))
             * rng.normal(size=(512, 1024))).astype(np.float32)
    srm = SparseRowMatrix.from_dense(dense, bs=64, device="cpu")
    for nx in (1, 16, 1024):
        want = planner.plan("sparse_matmul",
                            {"m": srm.m_pad, "n": srm.n_pad, "nx": nx,
                             "ell": srm.ell, "bs": srm.bs}).choice
        assert srm._use_bsr(nx, "auto") == (want == "bsr")
    # bs="auto" is plan("bsr_bs") on the matrix's own ELL widths.
    auto = SparseRowMatrix.from_dense(dense, device="cpu", nx_hint=16)
    ells = {}
    for bs in planner.BS_CANDIDATES:
        ells[bs] = SparseRowMatrix.from_dense(dense, bs=bs, device="cpu").ell
    want = planner.plan("bsr_bs", {"m": 512, "n": 1024, "nx": 16},
                        context={"ell_by_bs": ells}).blocks["bs"]
    assert auto.bs == want
    # fused="auto" and precision="auto" are the grad plan's.
    rm = RowMatrix.create(dense, device="cpu")
    lin = LinopMatrix(rm)
    smooth = SmoothQuad(b=torch.zeros(512))
    assert tsolver.fused_gradient_enabled(smooth, lin, "auto") == (
        planner.plan("grad", {"m": 512, "n": 1024}).choice == "fused")
    opts = tsolver.TfocsOptions(tol=1e-3)
    assert tsolver.resolve_precision(lin, opts) == (planner.plan(
        "grad", {"m": 512, "n": 1024}, context={"tol": 1e-3}).precision)


@pytest.mark.parametrize("op,dims,ctx", [
    ("gemm", {"m": 1 << 21, "k": 1024, "n": 16}, None),
    ("tsgram", A, None), ("fused_grad_multi", dict(A, k=8), None),
    ("sparse_matmul", S, None), ("grad", A, None), ("grad", A, {"axes": (4,)}),
    ("bsr_bs", {"m": 512, "n": 512, "nx": 128},
     {"ell_by_bs": {8: 20, 64: 4}}),
    ("svd", {"m": 100000, "n": 4096, "k": 32}, {"kind": "row"}),
    ("gram", A, {"axes": (8,)}), ("matvec", A, {"axes": (16, 16)})])
def test_explain_works_for_every_op(op, dims, ctx):
    p = planner.plan(op, dims, context=ctx, top=3)
    text = p.explain()
    assert f"plan({p.op})" in text and p.choice in text
    assert "roofline:" in text and "-bound" in text and " us" in text
    assert "h100-sxm (builtin constants)" in text


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown op"):
        planner.plan("nonsense", {"m": 1})


# -- calibration -------------------------------------------------------------------

CAL_SHAPES = [("gemm", {"m": 1 << 20, "k": 1024, "n": 16}),
              ("tsgram", {"m": 1 << 20, "n": 1024}),
              ("fused_grad", {"m": 1 << 20, "n": 1024}),
              ("fused_grad_multi", {"m": 1 << 20, "n": 1024, "k": 40}),
              ("randsketch", {"m": 1 << 18, "n": 4096, "r": 26})]


def test_calibration_tightens_the_error_and_flips_plans():
    """Records of a card 4x slower on HBM: the fit recovers hbm_eff near
    0.25, the error falls, the fit is kept and later plans use it."""
    slow = pm.MachineModel.from_dict(dict(pm.H100.as_dict(),
                                          hbm_eff={"float32": 0.25}))
    records = [planner.calibration_record(
        k, d, at.legacy(k, d, "float32"), "float32",
        at.model_time(k, at.legacy(k, d, "float32"), d, "float32",
                      machine=slow)) for k, d in CAL_SHAPES]
    before = planner.plan("fused_grad", {"m": 1 << 20, "n": 1024},
                          backend="cuda")
    fitted, err0, err1 = planner.calibrate(records, backend="cuda")
    assert err1 < err0 and err1 < 0.35
    assert fitted.hbm_eff["float32"] == pytest.approx(0.25, rel=0.3)
    after = planner.plan("fused_grad", {"m": 1 << 20, "n": 1024},
                         backend="cuda")
    assert after.calibrated and not before.calibrated
    assert after.cost_s > 2 * before.cost_s
    saved = json.loads(pm.calibration_path().read_text())
    assert saved["backends"]["cuda"]["source"] == "calibrated"
    # The CPU backend keeps the built-in model until it is fitted itself.
    assert not planner.plan("fused_grad", {"m": 1 << 20, "n": 1024},
                            backend="cpu").calibrated


def test_plans_prefer_calibrated_constants():
    """A fit kept for "cuda" prices the card's plans: a card whose HBM
    runs at a twentieth of the data sheet makes the bf16 copy of A worth
    it at a size the built-in model leaves f32 (the savings floor)."""
    dims = {"m": 4096, "n": 512}
    assert planner.plan("grad", dims, backend="cuda",
                        context={"tol": 1e-4}).precision == "f32"
    slow = pm.MachineModel.from_dict(dict(
        pm.H100.as_dict(), hbm_eff={"float32": 0.05, "bfloat16": 0.05},
        source="calibrated"))
    pm.save_calibration("cuda", slow)
    at.reset()
    p = planner.plan("grad", dims, backend="cuda", context={"tol": 1e-4})
    assert p.calibrated and p.precision == "bf16"
    assert not planner.plan("grad", dims, backend="cpu").calibrated


def test_actual_records_feed_calibrate():
    from repro_torch.launch import telemetry
    rec = telemetry.Recorder()
    for k, d in CAL_SHAPES:
        p = planner.plan(k, d)
        rec.record_plan_actual(p, 2.0 * p.cost_s, source="test")
    p = planner.plan("grad", A)
    rec.record_plan_actual(p, 3.0 * p.cost_s)
    pa = rec.plan_actual()
    assert len(pa) == len(CAL_SHAPES) + 1
    assert all(r["ratio"] == pytest.approx(r["measured_s"] / r["modeled_s"])
               for r in pa)
    recs = rec.calibration_records()
    assert len(recs) == len(pa) and all("flops" in r for r in recs)
    fitted, err0, err1 = planner.calibrate(recs, backend="cuda", write=False)
    assert err1 <= err0
    assert not pm.calibration_path().exists()
    assert telemetry.NULL.record_plan_actual(p, 1.0) == {}


# -- collectives -------------------------------------------------------------------

def test_ring_tree_selection_by_payload():
    big = pm.H100.collective(4 * 2**20, (8,), "float32")
    small = pm.H100.collective(256.0, (256,), "float32")
    assert big["algorithm"] == "ring" and small["algorithm"] == "tree"
    two = pm.H100.collective(4 * 2**20, (4, 4), "float32")
    assert two["comm_s"] > pm.H100.collective(4 * 2**20, (4,),
                                              "float32")["comm_s"]


def test_comm_fraction_grows_with_the_device_count():
    fracs = []
    for dev in (1, 4, 16, 64):
        p = planner.plan("gram", {"m": 1_000_000 // dev, "n": 1024},
                         context={"axes": (dev,)})
        b = p.breakdown
        serial = max(b["compute_s"], b["memory_s"]) + b["step_s"] \
            + b.get("comm_s", 0.0)
        fracs.append(b.get("comm_s", 0.0) / serial)
    assert fracs[0] == 0.0 and all(b > a for a, b in zip(fracs, fracs[1:]))


def test_grad_and_matvec_plans_with_axes():
    p = planner.plan("grad", {"m": 4096, "n": 1024},
                     context={"axes": (4, 4)})
    assert p.breakdown["comm_s"] > 0 and p.terms["comm_bytes"] > 0
    assert "chunks" in p.blocks and "comm:" in p.explain()
    local = planner.plan("matvec", A, context={"axes": (4,),
                                               "reduce": False})
    assert local.choice == "local"
    ring = planner.plan("matvec", A, context={"axes": (4,)})
    assert ring.choice in ("ring", "tree")
    assert dict(ring.alternatives).keys() == {"ring", "tree"}


# -- H100 goldens --------------------------------------------------------------------

def test_h100_goldens():
    # fused_grad at A = 2^21 x 1024 f32: A once (2^31·4 bytes) plus x, t,
    # w, z, g and f: (8589934592 + 4·(1024 + 2·2097152) + 4·(2097152 +
    # 1024 + 1)) / 3.35e12 = 2.5716 ms, against 4·2^31 flops / 67e12 =
    # 0.128 ms: memory-bound.
    g = planner.plan("grad", A)
    nbytes = (1 << 33) + 4 * (1024 + 2 * (1 << 21)) + 4 * ((1 << 21) + 1025)
    assert g.cost_s == pytest.approx(nbytes / HBM, rel=1e-12)
    assert g.breakdown["bound"] == "memory"
    # tsgram at A: 3 TF32 products of m·n·(n+1) flops at 495e12 =
    # 3·2^21·1024·1025 / 495e12 = 13.340 ms: compute-bound.
    t = planner.plan("tsgram", A)
    assert t.cost_s == pytest.approx(3 * (1 << 21) * 1024 * 1025 / 495e12,
                                     rel=1e-12)
    assert t.breakdown["bound"] == "compute"
    # gemm at A x 16: one 16-column tile reads A once: (2^33 + 1024·16·4
    # + 4·2^21·16) / 3.35e12 = 2.604 ms.
    m = planner.plan("gemm", {"m": 1 << 21, "k": 1024, "n": 16})
    assert m.blocks == {"bn": 16}
    assert m.cost_s == pytest.approx(
        ((1 << 33) + 1024 * 16 * 4 + 4 * (1 << 21) * 16) / HBM, rel=1e-12)
    # S: 2^17 block-rows of 16 stored 32 x 32 blocks, f32: 2^17·16·1024·4
    # block bytes + 4 a block's column + x and y: 2.572 ms for
    # bsr_matvec, against the dense gemm's 2^36·4 bytes (82 ms): bsr.
    # In int8 a quarter of the block bytes and a 4-byte scale a block:
    # (2^31 + 2^21·8 + 4·(2^14 + 2^22)) / 3.35e12 = 0.651 ms.
    p = planner.plan("sparse_matmul", S)
    assert p.choice == "bsr"
    blocks = (1 << 17) * 16
    assert p.cost_s == pytest.approx(
        (blocks * 1024 * 4 + 4 * blocks + 4 * ((1 << 14) + (1 << 22))) / HBM,
        rel=1e-12)
    q = planner.plan("sparse_matmul", S, context={"tol": 1e-3})
    assert q.precision == "int8" and q.cost_s == pytest.approx(
        (blocks * 1024 + 8 * blocks + 4 * ((1 << 14) + (1 << 22))) / HBM,
        rel=1e-12)
    # flash_attention at the llama prefill (96 query heads, 32 KV heads,
    # 2048 x 2048, D 128, causal): 4·128·96·(2048·2049/2) flops at the
    # bf16 rate, 989e12 = 0.104 ms.
    f = planner.plan("flash_attention",
                     {"bh": 96, "bkv": 32, "sq": 2048, "sk": 2048, "d": 128,
                      "causal": 1}, "bfloat16")
    assert f.cost_s == pytest.approx(4 * 128 * 96 * 2048 * 2049 / 2
                                     / 989e12, rel=1e-12)
    # selective_scan at the falcon prefill: 4·2048·8192·16 exponentials at
    # 67e12 / 16 a second = 0.256 ms.
    s = planner.plan("selective_scan",
                     {"bt": 4, "s": 2048, "d": 8192, "n": 16})
    assert s.cost_s == pytest.approx(4 * 2048 * 8192 * 16 / (67e12 / 16),
                                     rel=1e-12)


# PERF.md §6's bound column (ms, NVIDIA H100 SXM data-sheet peaks), each
# row at its shape: the model at efficiency 1 must give it within 1%.
BOUND_ROWS = [
    ("fused_grad", A, "float32", 2.572),
    ("tsgram", A, "float32", 13.340),
    ("gemm", {"m": 1 << 21, "k": 1024, "n": 16}, "float32", 2.604),
    ("fused_grad_multi", dict(A, k=8), "float32", 2.624),
    ("randsketch", {"m": 1 << 18, "n": 16384, "r": 26}, "float32", 5.137),
    ("bsr_matvec", S, "float32", 2.572),
    ("bsr_matmul", dict(S, nx=16), "float32", 2.647),
    ("bsr_rmatmul", S, "float32", 2.572),
    ("fused_grad_bsr", S, "float32", 2.582),
    ("fused_grad_bsr_multi", dict(S, k=8), "float32", 2.687),
    ("flash_attention", {"bh": 96, "bkv": 32, "sq": 2048, "sk": 2048,
                         "d": 128, "causal": 1}, "bfloat16", 0.104),
    ("selective_scan", {"bt": 4, "s": 2048, "d": 8192, "n": 16}, "float32",
     0.256),
    ("fused_grad", {"m": 1 << 18, "n": 16384}, "float32", 5.129),
    ("fused_grad", {"m": 1 << 18, "n": 16384}, "bfloat16", 2.565),
    ("fused_grad_multi", dict(A, k=40), "float32", 5.128),
    ("gemm", {"m": 1 << 18, "k": 16384, "n": 26}, "float32", 5.137),
    ("gemm", {"m": 1 << 18, "k": 16384, "n": 26}, "bfloat16", 2.573),
    ("gemm", {"m": 1 << 21, "k": 1024, "n": 16}, "bfloat16", 1.322),
    ("randsketch", {"m": 1 << 18, "n": 16384, "r": 26}, "bfloat16", 2.573),
    ("tsgram", A, "bfloat16", 2.226),
    ("bsr_rmatmul", dict(S, nx=512), "float32", 13.327),
]


@pytest.mark.parametrize("kernel,dims,dtype,bound_ms", BOUND_ROWS)
def test_model_at_efficiency_one_is_the_bound(kernel, dims, dtype, bound_ms):
    model_ms = at.model_time(kernel, at.legacy(kernel, dims, dtype), dims,
                             dtype, machine=pm.H100) * 1e3
    assert model_ms == pytest.approx(bound_ms, rel=0.01)
