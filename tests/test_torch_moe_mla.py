"""The port's MoE FFN, MLA attention and the MLA prefill's flash_attention
at head dim 192 against the reference, on the CPU.

Smoke deepseek-v2-236b (q_lora_rank set) and deepseek-v3-671b (and v2
with q_lora_rank None) in f32, the reference's weights carried across by
``convert.lm_params_from_numpy``, the same numpy inputs on both sides:

- ``apply_moe``'s output and auxiliary loss at capacity_factor 8 (no
  drops) and 1.25 (drops; the port's ``RoutingTally`` must count some), and
  the reference's mesh branch raising on the port's side;
- the port-only properties of tests/test_moe_properties.py: dispatch with
  unbounded capacity against a dense per-token mixture, a smaller
  capacity only removing contributions, the Switch loss at least 1;
- ``mla_attention`` without a cache (the port's prefill through
  ``ops.flash_attention`` on the materialized q, k and padded v), and a
  prefill into a cache then 4 decode steps in both decode modes: the
  port's materialized prefill against the reference's absorbed one;
- ``flash_attention_plain`` at D = 192 with v zero-padded from 128, f32
  and bf16, causal, S ragged, against the reference's Pallas kernel in
  interpret mode and its kernels/ref.py.

Tolerances: 1e-5 (absolute and relative) for the f32 layers, the
reference's attention limits (tests/test_kernels.py: f32 1e-4 / 3e-4,
bf16 3e-2 / 5e-2) for the kernel's plain version.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build as jbuild, smoke_config as jsmoke
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.models import smoke_config
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 2, 16, 4
ARCHES = {"v2": ("deepseek-v2-236b", {}),
          "v3": ("deepseek-v3-671b", {}),
          "v2_full_rank_q": ("deepseek-v2-236b", {"q_lora_rank": None})}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return convert.tensor_from_numpy(a, device="cpu")


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(np.asarray(v))
            for k, v in tree.items()}


class Pair:
    """One smoke configuration in both packages with the reference's
    weights; `jlayer`/`layer` are the first MoE block's (its MLA is the
    same as a dense-prefix block's)."""

    def __init__(self, name, **cfg_kw):
        arch, mla_kw = ARCHES[name]
        jcfg, cfg = jsmoke(jconfigs.get(arch)), smoke_config(configs.get(arch))
        if mla_kw:
            jcfg = jcfg.scaled(mla=dataclasses.replace(jcfg.mla, **mla_kw))
            cfg = cfg.scaled(mla=dataclasses.replace(cfg.mla, **mla_kw))
        self.jcfg, self.cfg = jcfg.scaled(**cfg_kw), cfg.scaled(**cfg_kw)
        params = jbuild(self.jcfg).init(jax.random.PRNGKey(0))
        self.jlayer = jax.tree.map(lambda a: a[0], params["moe_blocks"])
        self.layer = _tree(jax.tree.map(np.asarray, self.jlayer))


@pytest.fixture(scope="module")
def pairs():
    built: dict = {}

    def get(name, **cfg_kw) -> Pair:
        key = (name, tuple(sorted(cfg_kw.items())))
        if key not in built:
            built[key] = Pair(name, **cfg_kw)
        return built[key]
    return get


def _with_capacity(pair_cfg, cf):
    return pair_cfg.scaled(moe=dataclasses.replace(pair_cfg.moe,
                                                   capacity_factor=cf))


# ------------------------------------------------------------------ MoE ----
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("name", ["v2", "v3"])
def test_apply_moe_matches_reference(pairs, name, cf):
    pair = pairs(name)
    jcfg, cfg = _with_capacity(pair.jcfg, cf), _with_capacity(pair.cfg, cf)
    x = np.random.default_rng(1).normal(size=(B, S, cfg.d_model)
                                        ).astype(np.float32)
    want, want_aux = JMOE.apply_moe(pair.jlayer["ffn"], jnp.asarray(x), jcfg)
    with MOE.RoutingTally() as tally:
        got, aux = MOE.apply_moe(pair.layer["ffn"], _t(x), cfg)
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert tally.pairs == B * S * cfg.moe.top_k
    # capacity max(int(32 · 2 · 1.25 / 8), 4) = 10 drops pairs; 8 none
    assert (tally.dropped > 0) == (cf == 1.25), tally.dropped


def test_apply_moe_on_a_mesh_raises(pairs):
    pair = pairs("v2")
    x = torch.zeros(1, 2, pair.cfg.d_model)
    with pytest.raises(NotImplementedError, match="item 13"):
        MOE.apply_moe(pair.layer["ffn"], x, pair.cfg, mesh=object())


def _expert(p, e, xt):
    h = torch.nn.functional.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])
    return h @ p["w_down"][e]


@pytest.mark.parametrize("T,seed", [(4, 0), (17, 3), (64, 5)])
def test_dispatch_matches_dense_reference(pairs, T, seed):
    """Capacity-unconstrained dispatch equals the dense per-token expert
    mixture (tests/test_moe_properties.py's property, the port's side)."""
    pair = pairs("v2")
    cfg, p = pair.cfg, pair.layer["ffn"]
    m = cfg.moe
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(T, cfg.d_model)).astype(np.float32))
    out, _ = MOE._moe_local(x, p, cfg, 0, m.num_experts,
                            capacity=T * m.top_k)
    probs = torch.softmax(x @ p["router"], -1)
    gates, eidx = torch.topk(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros(T, cfg.d_model)
    for t in range(T):
        for j in range(m.top_k):
            want[t] += gates[t, j] * _expert(p, int(eidx[t, j]), x[t])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("capacity", [1, 2, 5, 8])
def test_capacity_bound_is_respected(pairs, capacity):
    """No expert takes more than `capacity` tokens: a token-expert pair
    either contributes what it does without the bound or nothing, so the
    capped output is the full one minus whole pairs."""
    pair = pairs("v2")
    cfg, p = pair.cfg, pair.layer["ffn"]
    m = cfg.moe
    T = 32
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(T, cfg.d_model)).astype(np.float32))
    full, _ = MOE._moe_local(x, p, cfg, 0, m.num_experts, T * m.top_k)
    with MOE.RoutingTally() as tally:
        capped, _ = MOE._moe_local(x, p, cfg, 0, m.num_experts, capacity)
    assert T * m.top_k - tally.dropped <= m.num_experts * capacity
    assert float(capped.norm()) <= float(full.norm()) * 1.5 + 1e-6
    probs = torch.softmax(x @ p["router"], -1)
    gates, eidx = torch.topk(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    # pairs in stable order by expert, the first `capacity` of each kept
    seen = torch.zeros(m.num_experts, dtype=torch.long)
    want = torch.zeros_like(full)
    for t in range(T):
        for j in range(m.top_k):
            e = int(eidx[t, j])
            if seen[e] < capacity:
                want[t] += gates[t, j] * _expert(p, e, x[t])
            seen[e] += 1
    np.testing.assert_allclose(capped.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_aux_loss_uniform_routing_lower_bound(pairs):
    """The Switch loss E · Σ f_e P_e is at least 1 near uniform routing."""
    pair = pairs("v2")
    cfg, m = pair.cfg, pair.cfg.moe
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, cfg.d_model)).astype(np.float32))
    _, aux = MOE._moe_local(x, pair.layer["ffn"], cfg, 0, m.num_experts,
                            64 * m.top_k)
    assert float(aux) >= 0.99


# ------------------------------------------------------------------ MLA ----
def _hidden(cfg, seed, n=S):
    return np.random.default_rng(seed).normal(
        size=(B, n, cfg.d_model)).astype(np.float32)


def _pos(n, start=0):
    return (start + np.arange(n, dtype=np.int32))[None].repeat(B, 0)


@pytest.mark.parametrize("name", list(ARCHES))
def test_mla_without_cache(pairs, name):
    """The port's flash prefill on the materialized form against the
    reference's cache-free (materialized, einsum) attention."""
    pair = pairs(name)
    x = _hidden(pair.cfg, 2)
    want, _ = JMLA.mla_attention(pair.jlayer["attn"], jnp.asarray(x),
                                 jnp.asarray(_pos(S)), pair.jcfg)
    got, cache = MLA.mla_attention(pair.layer["attn"], _t(x), _t(_pos(S)),
                                   pair.cfg)
    assert cache is None
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL)


@pytest.mark.parametrize("mode", ["absorbed", "materialize"])
@pytest.mark.parametrize("name", list(ARCHES))
def test_mla_prefill_then_decode(pairs, name, mode):
    """Prefill into a cache (the port's flash path; the reference's
    `mode` prefill: absorbed or materialized) then STEPS decode steps in
    `mode` on both sides: outputs and the latent cache."""
    pair = pairs(name, mla_decode_mode=mode)
    jp, pp = pair.jlayer["attn"], pair.layer["attn"]
    T = S + STEPS
    jc, _ = JMLA.init_mla_cache(pair.jcfg, B, T)
    pc = MLA.init_mla_cache(pair.cfg, B, T, "cpu")
    x = _hidden(pair.cfg, 3, T)
    for sl, at in [(slice(0, S), 0)] + [(slice(S + i, S + i + 1), S + i)
                                        for i in range(STEPS)]:
        n = sl.stop - sl.start
        want, jc = JMLA.mla_attention(jp, jnp.asarray(x[:, sl]),
                                      jnp.asarray(_pos(n, at)), pair.jcfg,
                                      cache=jc, cache_pos=jnp.int32(at),
                                      decode_mode=mode)
        got, pc = MLA.mla_attention(pp, _t(x[:, sl]), _t(_pos(n, at)),
                                    pair.cfg, cache=pc, cache_pos=at,
                                    decode_mode=mode)
        np.testing.assert_allclose(_np32(got), _np32(want), **TOL)
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(_np32(pc[key]), _np32(jc[key]), **TOL)


def test_mla_decode_chunks_queries_as_the_reference(pairs):
    """A prompt continued at an offset > 0 takes the plain path, its
    queries chunked by attn_q_chunk (8 here: two chunks of 8)."""
    pair = pairs("v3", attn_q_chunk=8)
    jp, pp = pair.jlayer["attn"], pair.layer["attn"]
    T = 4 + S
    jc, _ = JMLA.init_mla_cache(pair.jcfg, B, T)
    pc = MLA.init_mla_cache(pair.cfg, B, T, "cpu")
    x = _hidden(pair.cfg, 4, T)
    for sl, at in ((slice(0, 4), 0), (slice(4, T), 4)):
        n = sl.stop - sl.start
        want, jc = JMLA.mla_attention(jp, jnp.asarray(x[:, sl]),
                                      jnp.asarray(_pos(n, at)), pair.jcfg,
                                      cache=jc, cache_pos=jnp.int32(at))
        got, pc = MLA.mla_attention(pp, _t(x[:, sl]), _t(_pos(n, at)),
                                    pair.cfg, cache=pc, cache_pos=at)
        np.testing.assert_allclose(_np32(got), _np32(want), **TOL)


def test_mla_flash_inputs_are_the_prefills(pairs):
    """flash_inputs gives the (B, H, S, D) q, k, v and scale the prefill
    launches: D = qk_nope + qk_rope, the rotary key the same in every
    head, v zero past v_head_dim; attention on them is the prefill's."""
    pair = pairs("v2")
    cfg, c = pair.cfg, pair.cfg.mla
    x = _hidden(cfg, 5)
    q, k, v, scale = MLA.flash_inputs(pair.layer["attn"], _t(x),
                                      _t(_pos(S)), cfg)
    D = c.qk_nope_head_dim + c.qk_rope_head_dim
    assert q.shape == k.shape == v.shape == (B, cfg.num_heads, S, D)
    assert scale == 1.0 / math.sqrt(D)
    assert torch.equal(k[..., c.qk_nope_head_dim:],
                       k[:, :1, :, c.qk_nope_head_dim:].expand_as(
                           k[..., c.qk_nope_head_dim:]))
    assert not v[..., c.v_head_dim:].any()
    o = ops.flash_attention(q, k, v, scale=scale)[..., :c.v_head_dim]
    want, _ = MLA.mla_attention(pair.layer["attn"], _t(x), _t(_pos(S)), cfg)
    got = o.transpose(1, 2).reshape(B, S, -1) @ pair.layer["attn"]["wo"]
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL)


# ------------------------------------------------ flash at head dim 192 ----
F32 = dict(rtol=1e-4, atol=3e-4)
BF16 = dict(rtol=3e-2, atol=5e-2)


def _mla_qkv(h, s, dtype, seed):
    """q, k, v (1, h, s, 192) as MLA's prefill makes them: k's last 64
    columns shared by every head, v zero past column 128."""
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    q = rng.normal(size=(1, h, s, 192))
    k = rng.normal(size=(1, h, s, 192))
    k[..., 128:] = k[:, :1, :, 128:]
    v = np.zeros((1, h, s, 192))
    v[..., :128] = rng.normal(size=(1, h, s, 128))
    return [a.astype(npdt) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [16, 50, 129])
def test_flash_attention_plain_at_head_dim_192(s, dtype):
    q, k, v = _mla_qkv(4, s, dtype, seed=s)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert got.shape == (1, 4, s, 192) and got.dtype == _t(q).dtype
    assert not got[..., 128:].float().any()
    tol = F32 if dtype == "f32" else BF16
    want = jref.flash_attention_ref(*(jnp.asarray(a).reshape(4, s, 192)
                                      for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(_np32(got), _np32(want).reshape(got.shape),
                               **tol)
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, bq=16, bk=128,
                                force_pallas=True)
    np.testing.assert_allclose(_np32(got), _np32(kern), **tol)
