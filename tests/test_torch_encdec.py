"""The encdec family (seamless-m4t-large-v2) of the port against the
reference, on the CPU.

The same numpy inputs go through both packages; the reference's
parameters cross through ``convert``.  (d) flash_attention's plain
version, non-causal at D = 64 with Sq ≠ Sk (16 queries against 12 keys, 1
against 33), against the reference's Pallas kernel in interpret mode,
whose key tile is Sk there: its wrapper refuses non-causal attention over
a padded key tile (ROADMAP.md queue 3).  ``layers.attention``'s
non-causal and cross-attention forms against the reference's.  (e) on
smoke seamless, with an encoder of 8 frames and a prompt of 16 tokens:
``encode``, ``decode_forward`` without a cache, and ``prefill`` followed by
4 decode steps (logits and every cache), the port's decode against its own
forward, ``generate`` against examples/serve_llm.py's loop, and the
parameters through ``convert``.

Tolerances, normwise relative (‖got − want‖ / ‖want‖): 1e-4 in f32 (no
scan is on this path), and tests/test_kernels.py's bf16 rtol 3e-2 where
the plain flash runs in bf16.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import build as jbuild, smoke_config as jsmoke
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch.serve_llm import frontend_embeds, generate
from repro_torch.models import build, smoke_config
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L

TOL = 1e-4
TOL_BF16 = 3e-2
B, S, ENC, STEPS = 2, 16, 8, 4


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
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


# ----------------------------------------- (d) non-causal flash at D = 64 --
def _qkv(B_, hq, hkv, sq, sk, D, dtype, seed):
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    return [rng.normal(size=(B_, h, s, D)).astype(npdt)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("sq,sk", [(16, 12), (1, 33), (12, 16)])
def test_noncausal_flash_at_d64_against_pallas(sq, sk, group, dtype):
    q, k, v = _qkv(2, 2 * group, 2, sq, sk, 64, dtype,
                   seed=sq * 100 + sk + group)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    assert got.shape == (2, 2 * group, sq, 64) and got.dtype == _t(q).dtype
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, bq=16, bk=sk,
                                force_pallas=True)
    assert _rel(got, kern) <= (TOL if dtype == "f32" else TOL_BF16)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False)
    assert _rel(got, want) <= (TOL if dtype == "f32" else TOL_BF16)


def test_reference_pallas_refuses_a_padded_noncausal_key_tile():
    """The reference-side limit the test above works around: with the
    default key tile (Sk rounded up to 128) a ragged Sk would be padded,
    which its wrapper refuses for non-causal attention."""
    q, k, v = _qkv(1, 2, 2, 16, 12, 64, "f32", seed=1)
    with pytest.raises(NotImplementedError, match="non-causal"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, bq=16, bk=128, force_pallas=True)


# ------------------------------------------------ the attention layer ----
def _layer_setup(seed):
    jcfg = jsmoke(jconfigs.get("seamless-m4t-large-v2"))
    cfg = smoke_config(configs.get("seamless-m4t-large-v2"))
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg)[0]
    pp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, pp


def _hidden(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)


def test_noncausal_self_attention():
    jcfg, cfg, jp, pp = _layer_setup(1)
    x = _hidden(cfg, 2, S)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    want, _ = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                           causal=False)
    got, cache = L.attention(pp, _t(x), _t(pos), cfg, causal=False)
    assert cache is None
    assert _rel(got, want) <= TOL
    causal, _ = L.attention(pp, _t(x), _t(pos), cfg)
    assert _rel(causal, want) > 1e-2


@pytest.mark.parametrize("sk", [ENC, 33, 1])
def test_cross_attention(sk):
    """Keys and values from the memory (no RoPE, no cache), Sq = 16
    against Sk."""
    jcfg, cfg, jp, pp = _layer_setup(3)
    x, mem = _hidden(cfg, 4, S), _hidden(cfg, 5, sk)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    want, wc = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                            xattn_kv=jnp.asarray(mem))
    got, cache = L.attention(pp, _t(x), _t(pos), cfg, xattn_kv=_t(mem))
    assert wc is None and cache is None
    assert _rel(got, want) <= TOL


# --------------------------------------------------- (e) the whole model --
class Seamless:
    """Smoke seamless in both packages with the reference's weights in
    both (its zero biases and unit norm scales moved, so that each is
    read), ENC frames and a prompt of S tokens."""

    def __init__(self):
        self.jcfg = jsmoke(jconfigs.get("seamless-m4t-large-v2"))
        self.cfg = smoke_config(configs.get("seamless-m4t-large-v2"))
        self.jmodel = jbuild(self.jcfg)
        rng = np.random.default_rng(9)
        self.np_params = jax.tree.map(
            lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1
                                       ).astype(a.dtype)
            if a.ndim == 1 else np.asarray(a),
            self.jmodel.init(jax.random.PRNGKey(0)))
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.model = build(self.cfg, device="cpu")
        self.params = convert.lm_params_from_numpy(self.np_params, self.cfg,
                                                   device="cpu")
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (B, S + STEPS)).astype(np.int32)
        self.frames = (rng.normal(size=(B, ENC, self.cfg.d_model)) * 0.02
                       ).astype(np.float32)
        self._ref = None

    def toks(self, a=0, b=S):
        return torch.from_numpy(self.tokens[:, a:b]).long()

    def ref(self):
        if self._ref is None:
            prefill = jax.jit(self.jmodel.prefill)
            decode = jax.jit(self.jmodel.decode_step)
            caches, _ = self.jmodel.init_caches(B, S + STEPS, ENC)
            toks = jnp.asarray(self.tokens)
            logits, caches = prefill(
                self.jparams, {"tokens": toks[:, :S],
                               "frontend_embeds": jnp.asarray(self.frames)},
                caches)
            steps = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
            for i in range(STEPS):
                logits, caches = decode(self.jparams,
                                        toks[:, S + i:S + i + 1], caches,
                                        jnp.int32(S + i))
                steps.append((np.asarray(logits),
                              jax.tree.map(np.asarray, caches)))
            self._ref = steps
        return self._ref


@pytest.fixture(scope="module")
def seamless():
    return Seamless()


def test_encode(seamless):
    want = JED.encode(seamless.jparams, jnp.asarray(seamless.frames),
                      seamless.jcfg)
    got = ED.encode(seamless.params, _t(seamless.frames), seamless.cfg)
    assert _rel(got, want) <= TOL


def test_decode_forward_without_cache(seamless):
    mem = JED.encode(seamless.jparams, jnp.asarray(seamless.frames),
                     seamless.jcfg)
    want, wc = JED.decode_forward(seamless.jparams,
                                  jnp.asarray(seamless.tokens[:, :S]), mem,
                                  seamless.jcfg)
    got, cache = ED.decode_forward(seamless.params, seamless.toks(),
                                   _t(np.asarray(mem)), seamless.cfg)
    assert wc is None and cache is None
    assert _rel(got, want) <= TOL


def _caches_close(got, want):
    layers = got["decoder"]
    assert set(got) == {"decoder"} and len(layers) == \
        want["self"]["k"].shape[0]
    for i, c in enumerate(layers):
        for key in ("k", "v"):
            assert _rel(c["self"][key], want["self"][key][i]) <= TOL, (i, key)
        for key in ("cross_k", "cross_v"):
            assert _rel(c[key], want[key][i]) <= TOL, (i, key)


def test_prefill_and_decode_match_reference(seamless):
    """Logits and every cache after the prefill (ENC frames ≠ S prompt
    tokens) and after each of 4 decode steps."""
    steps = seamless.ref()
    caches = seamless.model.init_caches(B, S + STEPS, ENC)
    V = seamless.cfg.vocab_size
    logits, caches = seamless.model.prefill(
        seamless.params, {"tokens": seamless.toks(),
                          "frontend_embeds": _t(seamless.frames)}, caches)
    assert logits.shape == (B, 1, L.padded_vocab(seamless.cfg))
    for i in range(STEPS + 1):
        if i:
            logits, caches = seamless.model.decode_step(
                seamless.params, seamless.toks(S + i - 1, S + i), caches,
                S + i - 1)
        want_logits, want_caches = steps[i]
        assert _rel(logits[..., :V], want_logits[..., :V]) <= TOL, i
        _caches_close(caches, want_caches)
        np.testing.assert_array_equal(_np32(logits[..., V:]),
                                      want_logits[..., V:])


def test_decode_matches_forward(seamless):
    """The port's prefill and 2 decode steps against its cache-free
    decoder pass over the same memory."""
    caches = seamless.model.init_caches(B, S + 3, ENC)
    logits, caches = seamless.model.prefill(
        seamless.params, {"tokens": seamless.toks(),
                          "frontend_embeds": _t(seamless.frames)}, caches)
    dec = [logits]
    for i in range(2):
        lg, caches = seamless.model.decode_step(
            seamless.params, seamless.toks(S + i, S + i + 1), caches, S + i)
        dec.append(lg)
    mem = ED.encode(seamless.params, _t(seamless.frames), seamless.cfg)
    h, _ = ED.decode_forward(seamless.params, seamless.toks(0, S + 2), mem,
                             seamless.cfg)
    want = L.lm_logits(seamless.params["embed"], h, seamless.cfg)[:, S - 1:]
    V = seamless.cfg.vocab_size
    assert _rel(torch.cat(dec, 1)[..., :V], want[..., :V]) <= TOL


def test_generate_matches_reference_loop(seamless):
    """Greedy tokens of `generate` (its encdec caches sized by the
    frames) against examples/serve_llm.py's loop."""
    gen = 5
    prefill = jax.jit(seamless.jmodel.prefill)
    decode = jax.jit(seamless.jmodel.decode_step)
    caches, _ = seamless.jmodel.init_caches(B, S + gen, ENC)
    logits, caches = prefill(
        seamless.jparams, {"tokens": jnp.asarray(seamless.tokens[:, :S]),
                           "frontend_embeds": jnp.asarray(seamless.frames)},
        caches)
    out = [jnp.argmax(logits[:, -1], -1)[:, None]]
    for i in range(gen - 1):
        logits, caches = decode(seamless.jparams, out[-1], caches,
                                jnp.int32(S + i))
        out.append(jnp.argmax(logits[:, -1], -1)[:, None])
    got, times = generate(seamless.model, seamless.params, seamless.toks(),
                          gen, frontend_embeds=_t(seamless.frames))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(out, 1)))
    assert set(times) == {"prefill_ms", "decode_ms_per_token"}


def test_init_caches_default_enc_len_and_layout(seamless):
    """init_caches(batch, max_len) sizes the cross K/V for max_len encoder
    positions, as the reference's registry does; the shapes are the
    reference's per layer."""
    got = seamless.model.init_caches(B, 20)
    want, _ = seamless.jmodel.init_caches(B, 20)
    for c in got["decoder"]:
        for key in ("k", "v"):
            assert tuple(c["self"][key].shape) == want["self"][key].shape[1:]
        for key in ("cross_k", "cross_v"):
            assert tuple(c[key].shape) == want[key].shape[1:]
    assert len(got["decoder"]) == seamless.cfg.num_layers


def test_convert_carries_every_leaf(seamless):
    """Every leaf of the reference's encdec tree crosses bit for bit (the
    encoder and decoder stacks unstacked), and nothing else is there."""
    port = dict(seamless.params.named_parameters())
    for path, want in jax.tree_util.tree_flatten_with_path(
            seamless.np_params)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("encoder", "decoder"):
            for i in range(want.shape[0]):
                name = ".".join([keys[0], str(i)] + keys[1:])
                np.testing.assert_array_equal(_np32(port.pop(name)),
                                              _np32(want[i]))
        else:
            np.testing.assert_array_equal(_np32(port.pop(".".join(keys))),
                                          _np32(want))
    assert not port, sorted(port)


def test_train_loss_waits_for_training(seamless):
    with pytest.raises(NotImplementedError, match="item 15"):
        ED.train_loss(seamless.params, {"tokens": seamless.toks(),
                                        "frontend_embeds":
                                        _t(seamless.frames)}, seamless.cfg)


def test_serve_llm_main_sizes_the_encoder_by_the_prompt(monkeypatch):
    """serve_llm.main gives seamless the prompt's length of frames, and
    generate sizes the cross caches by them."""
    from repro_torch.launch import serve_llm

    seen = []
    real = serve_llm.generate

    def spy(model, params, tokens, gen, frontend_embeds=None):
        seen.append(frontend_embeds.shape)
        return real(model, params, tokens, gen, frontend_embeds)

    monkeypatch.setattr(serve_llm, "generate", spy)
    serve_llm.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device",
                    "cpu", "--batch", "2", "--prompt-len", "12", "--gen",
                    "2"])
    cfg = smoke_config(configs.get("seamless-m4t-large-v2"))
    assert seen == [(2, 12, cfg.d_model)]
    fe = frontend_embeds(cfg, 3, 7, torch.Generator().manual_seed(0))
    assert fe.shape == (3, 7, cfg.d_model)
