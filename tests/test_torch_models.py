"""The port's LM serving path against the reference's, on the CPU.

Smoke configurations of llama3.2-3b (dense, with num_kv_heads=2 so that
GQA 2:1 is exercised, and once at vocab_size=500 for the padded-vocab
mask), falcon-mamba-7b (Mamba1), deepseek-v2-236b and deepseek-v3-671b
(moe: MLA attention, a dense prefix then MoE FFN layers, v3 with MTP
weights; capacity_factor 8, so no token is dropped) and llava-next-34b
(vlm, with numpy frontend embeddings in its first positions) in f32,
with the reference's weights carried across by
``convert.lm_params_from_numpy``.  Each layer function is
held against its JAX twin, then the whole model: prefill logits and caches
and 4 decode steps (dense within 1e-4 of the largest logit, Mamba within
1e-3: the reference's prefill scan is a chunked associative scan, the
port's the sequential one), the port's decode against its own forward (the
reference's tests/test_models.py:45 check), and ``generate``'s greedy
tokens against examples/serve_llm.py's loop.  One bf16 case holds the
dense model to 4e-2 of the largest logit, ten bf16 steps (2^-8): both
sides round activations to bf16 after every matmul, norm and residual add,
in different orders, and the port's plain prefill attention does not
round the softmax weights to bf16 where the reference does (1.5e-2 seen).
Logits are compared over the real vocabulary; the padded columns must
hold the mask value.
On the CPU the prefill attention and scan take the kernels' plain
versions; the reference runs XLA attention and its chunked scan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild, smoke_config as jsmoke
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro_torch import configs, convert
from repro_torch.launch.serve_llm import generate
from repro_torch.models import build, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF

B, S, STEPS = 2, 16, 4
CASES = {
    "dense": ("llama3.2-3b", dict(num_kv_heads=2)),
    "dense_v500": ("llama3.2-3b", dict(num_kv_heads=2, vocab_size=500)),
    "ssm": ("falcon-mamba-7b", {}),
    "dense_bf16": ("llama3.2-3b", dict(num_kv_heads=2, dtype="bfloat16")),
    "moe_v2": ("deepseek-v2-236b", {}),
    "moe_v3": ("deepseek-v3-671b", {}),
    "vlm": ("llava-next-34b", {}),
}
TOL = {"dense": 1e-4, "dense_v500": 1e-4, "ssm": 1e-3, "dense_bf16": 4e-2,
       "moe_v2": 1e-4, "moe_v3": 1e-4, "vlm": 1e-4}
# The configurations the port registers: all ten.
PORTED = ("deepseek-coder-33b", "qwen3-4b", "llama3.2-3b", "qwen2.5-32b",
          "llava-next-34b", "deepseek-v2-236b", "deepseek-v3-671b",
          "falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-large-v2")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the parallel test run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return convert.tensor_from_numpy(a, device="cpu")


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    got, want = _np32(got), _np32(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


class Case:
    """One configuration in both packages, the reference's weights in
    both, and the reference's prefill and decode steps."""

    def __init__(self, name):
        arch, kw = CASES[name]
        self.name = name
        self.jcfg = jsmoke(jconfigs.get(arch)).scaled(**kw)
        self.cfg = smoke_config(configs.get(arch)).scaled(**kw)
        self.jmodel = jbuild(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.model = build(self.cfg, device="cpu")
        self.params = convert.lm_params_from_numpy(self.np_params, self.cfg,
                                                   device="cpu")
        rng = np.random.default_rng(len(name))
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (B, S + STEPS)).astype(np.int32)
        # The frontend stub's embeddings (vlm), as examples/serve_llm.py
        # draws them: frontend_len positions, normal x 0.02.
        self.fe = (rng.normal(size=(B, self.cfg.frontend_len,
                                    self.cfg.d_model)) * 0.02
                   ).astype(np.float32) if self.cfg.frontend else None
        self._ref = None

    def batch(self, n=S):
        """The port's prefill batch of the first n tokens."""
        out = {"tokens": torch.from_numpy(self.tokens[:, :n]).long()}
        if self.fe is not None:
            out["frontend_embeds"] = _t(self.fe)
        return out

    def fe_t(self):
        return None if self.fe is None else _t(self.fe)

    def ref(self):
        """The reference's prefill logits and caches, then its decode
        steps' logits and caches."""
        if self._ref is None:
            prefill = jax.jit(self.jmodel.prefill)
            decode = jax.jit(self.jmodel.decode_step)
            caches, _ = self.jmodel.init_caches(B, S + STEPS)
            toks = jnp.asarray(self.tokens)
            batch = {"tokens": toks[:, :S]}
            if self.fe is not None:
                batch["frontend_embeds"] = jnp.asarray(self.fe)
            logits, caches = prefill(self.jparams, batch, caches)
            steps = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
            for i in range(STEPS):
                logits, caches = decode(self.jparams, toks[:, S + i:S + i + 1],
                                        caches, jnp.int32(S + i))
                steps.append((np.asarray(logits),
                              jax.tree.map(np.asarray, caches)))
            self._ref = steps
        return self._ref


@pytest.fixture(scope="module")
def cases():
    """Each case built once for the module, at its first use."""
    built: dict = {}

    def get(name) -> Case:
        if name not in built:
            built[name] = Case(name)
        return built[name]
    return get


# -------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", jconfigs.ARCHES)
def test_configs_copy_the_reference(arch):
    assert set(PORTED) == set(jconfigs.ARCHES) == set(configs.ARCHES)
    want = jconfigs.get(arch)
    got = configs.get(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke_config(got)) == \
        dataclasses.asdict(jsmoke(want))


def test_unported_families_raise():
    """Every family builds now: zamba2's hybrid (Mamba2 groups led by the
    shared attention block) and seamless's encdec on the CPU, beside the
    moe family with MTP's weights.  What still raises is encdec's
    train_loss, which waits for training (ROADMAP.md queue 1 item 15),
    and a family the port does not know."""
    from repro_torch.models import encdec as ED

    hybrid = build(smoke_config(configs.get("zamba2-1.2b")), device="cpu")
    params = hybrid.init(torch.Generator().manual_seed(0))
    assert {"groups", "shared_attn"} <= set(params._modules)
    assert set(params["shared_attn"]._modules) == {"norm1", "attn", "norm2",
                                                   "ffn"}
    encdec = build(smoke_config(configs.get("seamless-m4t-large-v2")),
                   device="cpu")
    params = encdec.init(torch.Generator().manual_seed(0))
    assert set(params._modules) == {"embed", "encoder", "decoder",
                                    "enc_norm", "final_norm"}
    with pytest.raises(NotImplementedError, match="item 15"):
        ED.train_loss(params, {}, encdec.cfg)
    cfg = smoke_config(configs.get("llama3.2-3b"))
    with pytest.raises(ValueError, match="family"):
        build(cfg.scaled(family="audio"), device="cpu")
    with pytest.raises(ValueError, match="needs cfg.ssm"):
        build(cfg.scaled(family="hybrid"), device="cpu")
    build(smoke_config(configs.get("deepseek-v3-671b")), device="cpu")
    model = build(cfg.scaled(mtp_depth=1), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params["mtp"]._modules) == {"block", "norm"}
    assert params["mtp"]["proj"].shape == (2 * cfg.d_model, cfg.d_model)


def test_build_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(smoke_config(configs.get("llama3.2-3b")))


@pytest.mark.parametrize("arch", PORTED)
def test_every_ported_arch_builds_on_the_card_by_default(monkeypatch, arch):
    """build's default device is the card for every registered config; it
    raises without one and builds with device="cpu"."""
    cfg = smoke_config(configs.get(arch))
    assert build(cfg, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    cfg = smoke_config(configs.get("llama3.2-3b")).scaled(norm_type=norm_type)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.normal(size=cfg.d_model).astype(np.float32),
         "bias": rng.normal(size=cfg.d_model).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jsmoke(jconfigs.get("llama3.2-3b"))
                         .scaled(norm_type=norm_type))
    got = L.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-5, atol=1e-5)


def test_rms_head_norm():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    s = rng.normal(size=32).astype(np.float32)
    np.testing.assert_allclose(
        _np32(L.rms_head_norm(_t(s), _t(x), 1e-6)),
        _np32(JL.rms_head_norm(jnp.asarray(s), jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope(offset):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = (offset + np.arange(7, dtype=np.int32))[None].repeat(2, 0)
    np.testing.assert_allclose(
        _np32(L.apply_rope(_t(x), _t(pos), 5e5)),
        _np32(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np32(L.rope_freqs(32, 5e5)),
                               _np32(JL.rope_freqs(32, 5e5)), rtol=1e-6)


def _hidden(case, seed, n=S):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, n, case.cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("options", [{}, dict(qk_norm=True, qkv_bias=True)])
def test_qkv(cases, options):
    case = cases("dense")
    jcfg, cfg = case.jcfg.scaled(**options), case.cfg.scaled(**options)
    jp = JL.init_attention(jax.random.PRNGKey(2), jcfg)[0]
    # biases and norm scales away from 0 and 1, so that they are read
    jp = jax.tree.map(lambda a: a + 0.3 if a.ndim == 1 else a, jp)
    x = _hidden(case, 4)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    want = JL._qkv(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = L._qkv({k: _t(np.asarray(v)) for k, v in jp.items()}, _t(x),
                 _t(pos), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np32(g), _np32(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_offset,masked,q_chunk", [
    (0, False, 0), (5, True, 0), (9, True, 4)])
def test_mha(q_offset, masked, q_chunk):
    rng = np.random.default_rng(5)
    Sq, T = 8, 20
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    mask = (np.arange(T)[None] < q_offset + Sq).repeat(2, 0) if masked \
        else None
    want = JL.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, q_offset=q_offset,
                  kv_mask=None if mask is None else jnp.asarray(mask),
                  q_chunk=q_chunk)
    got = L.mha(_t(q), _t(k), _t(v), causal=True, q_offset=q_offset,
                kv_mask=None if mask is None else torch.from_numpy(mask),
                q_chunk=q_chunk)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-5, atol=1e-5)


def test_attention_without_cache(cases):
    case = cases("dense")
    x = _hidden(case, 6)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    want, _ = JL.attention(_layer(case.jparams["blocks"], 0)["attn"],
                           jnp.asarray(x), jnp.asarray(pos), case.jcfg)
    got, _ = L.attention(case.params["blocks"][0]["attn"], _t(x), _t(pos),
                         case.cfg)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-4, atol=1e-5)


def test_attention_with_cache_prefill_then_decode(cases):
    case = cases("dense")
    jp = _layer(case.jparams["blocks"], 0)["attn"]
    pp = case.params["blocks"][0]["attn"]
    jc, _ = JL.init_attention_cache(case.jcfg, B, S + 1)
    pc = L.init_attention_cache(case.cfg, B, S + 1, "cpu")
    x = _hidden(case, 7, S + 1)
    pos = np.arange(S + 1, dtype=np.int32)[None].repeat(B, 0)
    for sl, at in ((slice(0, S), 0), (slice(S, S + 1), S)):
        want, jc = JL.attention(jp, jnp.asarray(x[:, sl]),
                                jnp.asarray(pos[:, sl]), case.jcfg, cache=jc,
                                cache_pos=jnp.int32(at))
        got, pc = L.attention(pp, _t(x[:, sl]), _t(pos[:, sl]), case.cfg,
                              cache=pc, cache_pos=at)
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-4,
                                   atol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np32(pc[key]), _np32(jc[key]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_apply_mlp(mlp_type):
    jcfg = jsmoke(jconfigs.get("llama3.2-3b")).scaled(mlp_type=mlp_type)
    cfg = smoke_config(configs.get("llama3.2-3b")).scaled(mlp_type=mlp_type)
    jp = JL.init_mlp(jax.random.PRNGKey(3), jcfg)[0]
    # nonzero biases, so that they are read
    jp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, jp)
    x = np.random.default_rng(8).normal(size=(2, 5, cfg.d_model)
                                        ).astype(np.float32)
    want = JL.apply_mlp(jp, jnp.asarray(x), jcfg)
    got = L.apply_mlp({k: _t(np.asarray(v)) for k, v in jp.items()}, _t(x),
                      cfg)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["dense", "dense_v500"])
def test_embed_and_logits(cases, name):
    case = cases(name)
    toks = case.tokens[:, :S]
    fe = np.random.default_rng(9).normal(size=(B, 3, case.cfg.d_model)
                                         ).astype(np.float32)
    for f in (None, fe):
        want = JL.embed(case.jparams["embed"], jnp.asarray(toks), case.jcfg,
                        None if f is None else jnp.asarray(f))
        got = L.embed(case.params["embed"], torch.from_numpy(toks).long(),
                      case.cfg, None if f is None else _t(f))
        np.testing.assert_array_equal(_np32(got), _np32(want))
    h = _hidden(case, 10)
    for tied in (True, False):
        jcfg = case.jcfg.scaled(tie_embeddings=tied)
        cfg = case.cfg.scaled(tie_embeddings=tied)
        jp = JL.init_embedding(jax.random.PRNGKey(1), jcfg)[0]
        want = JL.lm_logits(jp, jnp.asarray(h), jcfg)
        got = L.lm_logits({k: _t(np.asarray(v)) for k, v in jp.items()},
                          _t(h), cfg)
        assert got.shape[-1] == L.padded_vocab(cfg) == JL.padded_vocab(jcfg)
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-4,
                                   atol=1e-5)


def test_causal_conv_and_conv_step():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    np.testing.assert_allclose(
        _np32(SSM._causal_conv(_t(x), _t(w), _t(b))),
        _np32(JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32)
    got = SSM._conv_step(_t(state), _t(x[:, 0]), _t(w), _t(b))
    want = JSSM._conv_step(jnp.asarray(state), jnp.asarray(x[:, 0]),
                           jnp.asarray(w), jnp.asarray(b))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(_np32(g), _np32(wv), rtol=1e-5, atol=1e-5)


def test_mamba1_block(cases):
    """Cache-free forward, prefill into a cache, then one decode step."""
    case = cases("ssm")
    jp = _layer(case.jparams["blocks"], 0)["mixer"]
    pp = case.params["blocks"][0]["mixer"]
    x = _hidden(case, 12, S + 1)
    want, _ = JSSM.mamba1_block(jp, jnp.asarray(x[:, :S]), case.jcfg)
    got, _ = SSM.mamba1_block(pp, _t(x[:, :S]), case.cfg)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-3, atol=1e-4)
    jc, _ = JSSM.init_mamba1_cache(case.jcfg, B)
    pc = SSM.init_mamba1_cache(case.cfg, B, "cpu")
    for sl in (slice(0, S), slice(S, S + 1)):
        want, jc = JSSM.mamba1_block(jp, jnp.asarray(x[:, sl]), case.jcfg,
                                     cache=jc)
        got, pc = SSM.mamba1_block(pp, _t(x[:, sl]), case.cfg, cache=pc)
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-3,
                                   atol=1e-4)
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np32(pc[key]), _np32(jc[key]),
                                       rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------- whole model ----
def _caches_close(got, want, tol):
    assert set(got) == set(want)
    for name, layers in got.items():
        for i, layer in enumerate(layers):
            for key, t in layer.items():
                w = want[name][key][i]
                assert _rel(t, w) <= tol, (name, i, key, _rel(t, w))


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_reference(cases, name):
    case = cases(name)
    steps = case.ref()
    tol = TOL[name]
    toks = torch.from_numpy(case.tokens).long()
    caches = case.model.init_caches(B, S + STEPS)
    V = case.cfg.vocab_size
    logits, caches = case.model.prefill(case.params, case.batch(), caches)
    assert logits.shape == (B, 1, L.padded_vocab(case.cfg))
    for i in range(STEPS + 1):
        if i:
            logits, caches = case.model.decode_step(
                case.params, toks[:, S + i - 1:S + i], caches, S + i - 1)
        want_logits, want_caches = steps[i]
        err = _rel(logits[..., :V], want_logits[..., :V])
        assert err <= tol, (i, err)
        _caches_close(caches, want_caches, tol)
        np.testing.assert_array_equal(_np32(logits[..., V:]),
                                      want_logits[..., V:])


@pytest.mark.parametrize("name", ["dense", "ssm", "moe_v2", "moe_v3", "vlm"])
def test_decode_matches_forward(cases, name):
    """The port's own prefill + decode steps against its cache-free
    forward (tests/test_models.py's decode_matches_forward)."""
    case = cases(name)
    toks = torch.from_numpy(case.tokens).long()
    total = S + 3
    caches = case.model.init_caches(B, total)
    logits, caches = case.model.prefill(case.params, case.batch(), caches)
    dec = [logits]
    for i in range(2):
        lg, caches = case.model.decode_step(
            case.params, toks[:, S + i:S + i + 1], caches, S + i)
        dec.append(lg)
    dec = torch.cat(dec, 1)
    h, _ = TF.forward(case.params, toks[:, :total - 1], case.cfg,
                      frontend_embeds=case.fe_t())
    want = L.lm_logits(case.params["embed"], h, case.cfg)[:, S - 1:]
    assert _rel(dec, want) < 2e-2


@pytest.mark.parametrize("name", ["dense", "ssm", "moe_v2", "moe_v3", "vlm"])
def test_generate_matches_reference_loop(cases, name):
    """Greedy tokens of `generate` against examples/serve_llm.py's loop."""
    case = cases(name)
    gen = 5
    prefill = jax.jit(case.jmodel.prefill)
    decode = jax.jit(case.jmodel.decode_step)
    caches, _ = case.jmodel.init_caches(B, S + gen)
    batch = {"tokens": jnp.asarray(case.tokens[:, :S])}
    if case.fe is not None:
        batch["frontend_embeds"] = jnp.asarray(case.fe)
    logits, caches = prefill(case.jparams, batch, caches)
    out = [jnp.argmax(logits[:, -1], -1)[:, None]]
    pos = jnp.int32(S)
    for _ in range(gen - 1):
        logits, caches = decode(case.jparams, out[-1], caches, pos)
        out.append(jnp.argmax(logits[:, -1], -1)[:, None])
        pos = pos + 1
    want = np.asarray(jnp.concatenate(out, 1))
    got, times = generate(case.model, case.params,
                          torch.from_numpy(case.tokens[:, :S]).long(), gen,
                          frontend_embeds=case.fe_t())
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(times) == {"prefill_ms", "decode_ms_per_token"}


def test_generate_forwards_frontend_embeds(cases):
    """generate's prefill sees frontend_embeds: its logits are a direct
    prefill's with them and differ from one without them; decode steps
    take none."""
    case = cases("vlm")
    seen = []

    def prefill(params, batch, caches):
        logits, caches = case.model.prefill(params, batch, caches)
        seen.append((dict(batch), logits))
        return logits, caches

    def decode_step(params, tokens, caches, pos):
        seen.append(("decode", tokens.shape))
        return case.model.decode_step(params, tokens, caches, pos)

    spy = dataclasses.replace(case.model, prefill=prefill,
                              decode_step=decode_step)
    toks = torch.from_numpy(case.tokens[:, :S]).long()
    generate(spy, case.params, toks, 3, frontend_embeds=case.fe_t())
    (batch, logits), *decodes = seen
    assert torch.equal(batch["frontend_embeds"], case.fe_t())
    assert decodes == [("decode", (B, 1))] * 2
    with torch.inference_mode():
        with_fe, _ = case.model.prefill(case.params, case.batch(),
                                        case.model.init_caches(B, S + 3))
        without, _ = case.model.prefill(case.params, {"tokens": toks},
                                        case.model.init_caches(B, S + 3))
    assert torch.equal(logits, with_fe)
    assert _rel(logits, without) > 1e-3


def test_serve_llm_main_draws_frontend_embeds(monkeypatch):
    """serve_llm.main gives a vlm configuration frontend_len positions of
    f32 embeddings, normal x 0.02, and a dense one none."""
    from repro_torch.launch import serve_llm

    seen = []

    def spy(model, params, tokens, gen, frontend_embeds=None):
        seen.append(frontend_embeds)
        return torch.zeros(tokens.shape[0], gen, dtype=torch.long), {
            "prefill_ms": 0.0, "decode_ms_per_token": 0.0}

    monkeypatch.setattr(serve_llm, "generate", spy)
    for arch in ("llava-next-34b", "qwen3-4b"):
        serve_llm.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "3", "--prompt-len", "16", "--gen", "2"])
    fe, none = seen
    cfg = smoke_config(configs.get("llava-next-34b"))
    assert none is None
    assert fe.shape == (3, cfg.frontend_len, cfg.d_model)
    assert fe.dtype == torch.float32
    assert 0.015 < float(fe.std()) < 0.025


def test_convert_carries_every_leaf(cases):
    """Every leaf of the reference's tree (v3: the dense prefix, the MoE
    blocks with their stacked experts, and the MTP block) crosses to the
    port's parameters bit for bit."""
    case = cases("moe_v3")
    stacks = {name: n for name, n, _ in TF.lm_structure(case.cfg)}
    leaves = jax.tree_util.tree_flatten_with_path(case.np_params)[0]
    assert any(p[0].key == "mtp" for p, _ in leaves)
    port = dict(case.params.named_parameters())
    for path, want in leaves:
        keys = [k.key for k in path]
        rows = range(stacks[keys[0]]) if keys[0] in stacks else [None]
        for i in rows:
            name = ".".join(keys[:1] + ([str(i)] if i is not None else [])
                            + keys[1:])
            w = want if i is None else want[i]
            np.testing.assert_array_equal(_np32(port.pop(name)), _np32(w))
    assert not port, sorted(port)
