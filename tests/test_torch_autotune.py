"""The port's autotuner (src/repro_torch/kernels/autotune.py): the
counterparts of tests/test_autotune.py for the CUDA kernels' launch
choices.  gemm's tile widths fit shared memory and every other kernel has
its one launch; the ranking never models worse than the legacy choice and
its ties go to it; buckets, the cache round trip and explicit overrides;
tune="off"; a second call skips the ranking; ``sweep`` picks the fastest
choice; a multi-slot kernel's key and choice do not depend on k.  The
shape buckets and cache keys are held to the reference's."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune as at
import dataclasses

from repro_torch.kernels import gemm, ops
from repro_torch.launch import machine as pm


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    at.reset()
    yield
    at.reset()


S = {"m": 1 << 22, "n": 1 << 14, "bs": 32, "ell": 16}
# Each kernel at the shapes chip_smoke.py's paths run it.
SHAPES = [
    ("gemm", {"m": 1 << 21, "k": 1024, "n": 16}),
    ("gemm", {"m": 1 << 18, "k": 16384, "n": 26}),
    ("gemm", {"m": 1 << 18, "k": 26, "n": 26}),
    ("gemm", {"m": 8192, "k": 8192, "n": 8192}),
    ("tsgram", {"m": 1 << 21, "n": 1024}),
    ("tsgram", {"m": 1 << 21, "n": 1023}),
    ("tsgram", {"m": 1 << 20, "n": 4096}),
    ("randsketch", {"m": 1 << 18, "n": 16384, "r": 26}),
    ("fused_grad", {"m": 1 << 21, "n": 1024}),
    ("fused_grad", {"m": 1 << 18, "n": 16384}),
    ("fused_grad", {"m": 10000, "n": 250}),
    ("fused_grad_multi", {"m": 1 << 21, "n": 1024, "k": 8}),
    ("bsr_matvec", dict(S, nx=1)),
    ("bsr_matmul", dict(S, nx=16)),
    ("bsr_matmul", dict(S, nx=8)),
    ("bsr_rmatmul", dict(S, nx=1)),
    ("bsr_rmatmul", dict(S, nx=16)),
    ("bsr_rmatmul", dict(S, nx=512)),
    ("fused_grad_bsr", S),
    ("fused_grad_bsr_multi", dict(S, k=8)),
    ("flash_attention", {"bh": 96, "bkv": 32, "sq": 2048, "sk": 2048,
                         "d": 128, "causal": 1}),
    ("selective_scan", {"bt": 4, "s": 2048, "d": 8192, "n": 16}),
]
DTYPES = {"gemm": ("float32", "bfloat16"), "tsgram": ("float32", "bfloat16"),
          "randsketch": ("float32", "bfloat16"),
          "fused_grad": ("float32", "bfloat16"),
          "fused_grad_multi": ("float32", "bfloat16"),
          "bsr_matvec": ("float32", "bfloat16", "int8"),
          "bsr_matmul": ("float32", "bfloat16", "int8"),
          "bsr_rmatmul": ("float32", "bfloat16", "int8"),
          "fused_grad_bsr": ("float32", "bfloat16"),
          "fused_grad_bsr_multi": ("float32", "bfloat16"),
          "flash_attention": ("bfloat16", "float32"),
          "selective_scan": ("float32",)}
CASES = [(k, d, dt) for k, d in SHAPES for dt in DTYPES[k]]
IDS = [f"{k}-{'x'.join(str(v) for v in d.values())}-{dt}"
       for k, d, dt in CASES]


@pytest.mark.parametrize("kernel,dims,dtype", CASES, ids=IDS)
def test_candidates_respect_shared_memory_and_what_the_kernel_takes(
        kernel, dims, dtype):
    cands = at.candidates(kernel, dims, dtype)
    assert cands, kernel
    for b in cands:
        assert at.estimate_smem(kernel, b, dims, dtype) <= at.SMEM_BLOCK_MAX
        assert set(b) == set(at.KERNELS[kernel].knobs)
    if kernel == "gemm":
        # Every width's ring holds at least two stages of 256 rows.
        assert [b["bn"] for b in cands] == [8, 16, 32]
        assert all(at.gemm_smem(b["bn"], pm.itemsize(dtype))[0] >= 2
                   for b in cands)
    else:
        # One launch: the wrapper's own rule.
        assert cands == [{}] and at.KERNELS[kernel].knobs == ()


@pytest.mark.parametrize("kernel,dims,dtype", CASES, ids=IDS)
def test_ranking_is_never_worse_than_legacy_and_ties_go_to_it(
        kernel, dims, dtype):
    ranked = at.rank(kernel, dims, dtype, machine=pm.H100)
    old = at.legacy(kernel, dims, dtype)
    legacy_s = at.model_time(kernel, old, dims, dtype, machine=pm.H100)
    assert ranked[0][0] <= legacy_s
    # On the built-in model every kernel launches as it did before the
    # autotuner: its legacy choice models best or ties the best.
    assert ranked[0][1] == old
    assert [s for s, _ in ranked] == sorted(s for s, _ in ranked)


def test_ties_go_to_legacy_whatever_its_order(monkeypatch):
    """At n = 8 every gemm tile width reads A once and A's bytes bound
    all three: they model the same, and the legacy width comes first,
    whichever of them it is, not the smallest."""
    dims = {"m": 1 << 21, "k": 1024, "n": 8}
    ranked = at.rank("gemm", dims, "float32", machine=pm.H100)
    assert len({s for s, _ in ranked}) == 1
    assert ranked[0][1] == {"bn": 8}
    monkeypatch.setitem(at.KERNELS, "gemm", dataclasses.replace(
        at.KERNELS["gemm"], legacy=lambda d, t: {"bn": 32}))
    assert at.rank("gemm", dims, "float32",
                   machine=pm.H100)[0][1] == {"bn": 32}


def test_a_calibrated_model_can_prefer_another_choice():
    """A choice's terms differ where the kernel's work differs: gemm's
    32-column tile pads a 16-column B with zeros (twice the products), and
    its 8-column tile reads A twice.  On the built-in model A's bytes bound
    all three at n = 16 and the legacy 16 wins the tie; with the tensor
    cores slowed 30x the padded tile turns compute-bound and ranks last,
    and with HBM slowed the 8-column tile's second read ranks last."""
    dims = {"m": 1 << 21, "k": 1024, "n": 16}
    base = {s: b["bn"] for s, b in at.rank("gemm", dims, "float32",
                                           machine=pm.H100)}
    assert at.rank("gemm", dims, "float32", machine=pm.H100)[0][1]["bn"] == 16
    slow = pm.MachineModel.from_dict(dict(pm.H100.as_dict(),
                                          mxu_eff={"float32": 1 / 30}))
    ranked = at.rank("gemm", dims, "float32", machine=slow)
    assert ranked[0][1]["bn"] == 16 and ranked[-1][1]["bn"] == 32
    hbm = pm.MachineModel.from_dict(dict(pm.H100.as_dict(),
                                         hbm_eff={"float32": 0.5}))
    assert at.rank("gemm", dims, "float32", machine=hbm)[-1][1]["bn"] == 8
    assert len(base) == 2        # 16 and 32 tie, 8 reads A twice


@pytest.mark.parametrize("x", [0, 1, 2, 3, 7, 8, 9, 1000, 1024, 1025,
                               (1 << 21) - 1, 1 << 21])
def test_buckets_match_the_reference(x):
    assert at.bucket(x) == jat.bucket(x)


def test_shape_bucketing():
    a = at.cache_key("gemm", "cuda", "float32",
                     {"m": 1000, "k": 1000, "n": 1000})
    b = at.cache_key("gemm", "cuda", torch.float32,
                     {"m": 1024, "k": 1024, "n": 1024})
    c = at.cache_key("gemm", "cuda", "float32",
                     {"m": 1025, "k": 1024, "n": 1024})
    assert a == b != c
    # The reference's key format: kernel|backend|dtype|bucketed dims.
    assert a == jat.cache_key("gemm", "cuda", jnp.float32,
                              {"m": 1000, "k": 1000, "n": 1000})
    assert at.cache_key("gemm", "cuda", "bfloat16",
                        {"m": 1024, "k": 1024, "n": 1024}) != a


def test_cache_round_trip(tmp_path):
    dims = {"m": 1 << 20, "k": 1024, "n": 16}
    key = at.record("gemm", dims, "float32", {"bn": 32}, backend="cuda",
                    us=123.4567)
    data = json.loads(at.user_cache_path().read_text())
    assert data["entries"][key] == {"blocks": {"bn": 32},
                                    "source": "swept", "us": 123.457}
    at.reset()
    assert at.get_config("gemm", dims, "float32", backend="cuda") == \
        {"bn": 32}
    assert at.stats["cache_hits"] == 1 and at.stats["ranked"] == 0
    # Another shape of the same bucket reads the same winner ...
    near = dict(dims, m=(1 << 20) - 5)
    assert at.resolve("gemm", near, "float32", backend="cuda")["bn"] == 32
    # ... and the cache is per backend.
    assert at.get_config("gemm", dims, "float32", backend="cpu") == \
        {"bn": 16}


def test_a_cached_choice_the_shape_cannot_take_is_ranked_instead():
    dims = {"m": 1 << 20, "k": 1024, "n": 16}
    # A 24-column tile is no width the kernel takes (a hand-edited or
    # stale cache entry).
    at.record("gemm", dims, "float32", {"bn": 24}, backend="cuda")
    at.reset()
    assert at.get_config("gemm", dims, "float32", backend="cuda") == \
        {"bn": 16}
    assert at.stats["ranked"] == 1


def test_resolve_explicit_overrides_win():
    dims = {"m": 1 << 21, "k": 1024, "n": 16}
    assert at.resolve("gemm", dims, "float32", {"bn": 32}) == {"bn": 32}
    assert at.resolve("gemm", dims, "float32", {"bn": None}) == {"bn": 16}
    assert at.resolve("gemm", dims, "float32", {"bn": 8},
                      tune="off") == {"bn": 8}
    with pytest.raises(ValueError, match="cannot launch"):
        at.resolve("gemm", dims, "float32", {"bn": 12})
    with pytest.raises(ValueError, match="takes no"):
        at.resolve("gemm", dims, "float32", {"bm": 256})
    # A kernel with one launch takes no launch choice at all.
    with pytest.raises(ValueError, match="takes no"):
        at.resolve("fused_grad", {"m": 4096, "n": 2048}, "float32",
                   {"staged": 1})


@pytest.mark.parametrize("kernel,dims,dtype", CASES, ids=IDS)
def test_resolve_tune_off_is_legacy_and_auto_is_today(kernel, dims, dtype):
    """With no sweep and no calibration tune="auto" resolves to the
    launch each wrapper made before the autotuner (tune="off")."""
    off = at.resolve(kernel, dims, dtype, {}, tune="off")
    auto = at.resolve(kernel, dims, dtype, {}, tune="auto", backend="cuda")
    assert off == auto
    assert auto == ({"bn": gemm.tile_width(dims["n"])} if kernel == "gemm"
                    else {})
    with pytest.raises(ValueError, match="tune must be"):
        at.resolve(kernel, dims, dtype, {}, tune="fast")


def test_ops_second_call_skips_ranking():
    a = torch.randn(300, 40)
    b = torch.randn(40, 12)
    ops.gemm(a, b)
    assert at.stats["ranked"] == 1
    ops.gemm(a, b)
    assert at.stats["ranked"] == 1 and at.stats["memo_hits"] >= 1
    ops.gemm(a, b, tune="off")
    assert at.stats["ranked"] == 1


def test_ops_tile_arguments():
    a, b = torch.randn(64, 16), torch.randn(16, 8)
    torch.testing.assert_close(ops.gemm(a, b, bn=32), a @ b)
    torch.testing.assert_close(ops.gemm(a, b, tune="off"), a @ b)
    with pytest.raises(ValueError, match="cannot launch"):
        ops.gemm(a, b, bn=24)
    with pytest.raises(ValueError, match="tune must be"):
        ops.gemm(a, b, tune="fast")


def test_fixed_designs_reject_tile_arguments():
    """flash_attention's and selective_scan's tiles are their designs'
    own: a reference tile argument raises and says why."""
    q = torch.randn(1, 2, 16, 32)
    with pytest.raises(NotImplementedError, match="128 queries by 128"):
        ops.flash_attention(q, q, q, bq=64)
    x = torch.randn(1, 4, 8)
    with pytest.raises(NotImplementedError, match="16 time steps"):
        ops.selective_scan(x, x, torch.randn(8, 4), torch.randn(1, 4, 4),
                           torch.randn(1, 4, 4), torch.randn(8), q=32)


def test_bsr_block_size():
    """Uniform scatter at 1% density: small blocks store less; at full
    density every block size stores every element and the cheapest
    gathers of X (the widest blocks) win; tune="off" is the reference's
    legacy 8."""
    assert ops.bsr_block_size(4096, 2048, 4096 * 2048 // 100, nx=1) == 8
    assert ops.bsr_block_size(4096, 2048, 4096 * 2048, nx=128) == 128
    assert ops.bsr_block_size(4096, 2048, 100, tune="off") == \
        int(jat.KERNELS["bsr"].legacy["bs"])


def test_sweep_selects_fastest_candidate():
    dims = {"m": 1 << 21, "k": 1024, "n": 16}
    fake = {8: 3e-3, 16: 2e-3, 32: 1e-3}
    calls = []

    def run(choice):
        calls.append(choice["bn"])
        return fake[choice["bn"]]

    timed = at.sweep("gemm", dims, "float32", run, top_n=3, reps=3)
    assert timed[0][1]["bn"] == 32 and [t for t, _ in timed] == [1e-3, 2e-3,
                                                                 3e-3]
    assert at.stats["swept"] == 1
    assert sorted(set(calls)) == [8, 16, 32] and len(calls) == 12

    # A run_fn that returns nothing is timed on the host clock.
    def host(choice):
        return None

    assert len(at.sweep("gemm", dims, "float32", host, top_n=1, reps=2)) == 1


@pytest.mark.parametrize("kernel,dims", [
    ("fused_grad_multi", {"m": 1 << 21, "n": 1024}),
    ("fused_grad_multi", {"m": 10000, "n": 4096}),
    ("fused_grad_bsr_multi", S)])
def test_multi_slot_keys_and_choices_do_not_depend_on_k(kernel, dims):
    keys = {at.cache_key(kernel, "cuda", "float32", dict(dims, k=k))
            for k in (1, 8, 40)}
    assert len(keys) == 1 and "|" in keys.pop()
    choices = [at.resolve(kernel, dict(dims, k=k), "float32", {},
                          backend="cuda") for k in (1, 8, 40, 100)]
    # One launch whatever k: nothing is ranked or looked up.
    assert choices == [{}] * 4
    assert at.stats["ranked"] == at.stats["memo_hits"] == 0
