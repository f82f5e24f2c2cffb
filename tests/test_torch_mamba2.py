"""Mamba2 and the hybrid family (zamba2-1.2b) of the port against the
reference, on the CPU.

The same numpy inputs go through both packages; the reference's
parameters cross through ``convert``.  (a) ``selective_scan`` (its plain
version on CPU tensors) at the state sizes Mamba2 brings, N = 32 and 64,
against the reference's Pallas kernel in interpret mode and its oracle,
S off the 16-step tile included.  (b) ``mamba2_block`` without a cache,
and prefill followed by 4 decode steps with the caches, at N = 16 (the
smoke config) and N = 64 (its ``scaled`` copy), S = 24 with chunk 16, so
that the reference's chunked SSD takes chunks of 12.  (c) the hybrid model
at 5 layers (2 groups of 2 and a tail of 1): prefill and 4 decode steps
with every cache, the port's decode against its own forward, and
``generate`` against examples/serve_llm.py's loop.

Tolerances, normwise relative (‖got − want‖ / ‖want‖) in f32: 1e-4 for
the kernels' plain versions (tests/test_kernels.py's scan bound) and for
what involves no scan; 1e-3 (tests/test_torch_models.py's "ssm" value)
wherever the port's sequential scan meets the reference's chunked SSD.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build as jbuild, smoke_config as jsmoke
from repro.models import ssm as JSSM
from repro.models import transformer as JTF
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch.serve_llm import generate
from repro_torch.models import build, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF

TOL_PLAIN = 1e-4      # the plain versions, and paths without a scan
TOL_SSD = 1e-3        # the sequential scan against the chunked SSD
B, S, STEPS = 2, 24, 4
HYBRID_LAYERS = 5     # attn_every 2: two groups and a tail of one


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


def _configs(n_state: int):
    """The smoke zamba2 in both packages, at state size n_state."""
    jcfg = jsmoke(jconfigs.get("zamba2-1.2b"))
    cfg = smoke_config(configs.get("zamba2-1.2b"))
    if n_state != jcfg.ssm.state_dim:
        jcfg = jcfg.scaled(ssm=dataclasses.replace(jcfg.ssm,
                                                   state_dim=n_state))
        cfg = cfg.scaled(ssm=dataclasses.replace(cfg.ssm, state_dim=n_state))
    return jcfg, cfg


def _perturbed(tree, seed):
    """The tree's 1-D leaves (A_log, dt_bias, D, biases, norm scales)
    moved off their initial zeros and ones, so that each is read; as
    numpy arrays."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.ndim == 1:
            return (a + rng.normal(size=a.shape) * 0.3).astype(a.dtype)
        return a
    return jax.tree.map(move, tree)


# ------------------------------------------------- (a) the scan kernel ----
def _scan_inputs(Bt, S_, d, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bt, S_, d)).astype(np.float32),
            (np.abs(rng.normal(size=(Bt, S_, d))) * 0.1).astype(np.float32),
            (-np.abs(rng.normal(size=(d, N))) - 0.1).astype(np.float32),
            rng.normal(size=(Bt, S_, N)).astype(np.float32),
            rng.normal(size=(Bt, S_, N)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


@pytest.mark.parametrize("Bt,S_,d,N", [(1, 32, 128, 32), (2, 17, 96, 32),
                                        (1, 32, 128, 64), (2, 50, 70, 64),
                                        (1, 33, 130, 64)])
def test_selective_scan_at_mamba2_state_sizes(Bt, S_, d, N):
    args = _scan_inputs(Bt, S_, d, N, seed=Bt * 1000 + S_ + N)
    y, h = ops.selective_scan(*map(_t, args))
    assert y.shape == (Bt, S_, d) and h.shape == (Bt, d, N)
    want = jref.selective_scan_ref(*map(jnp.asarray, args))
    assert _rel(y, want) <= TOL_PLAIN
    kern = jops.selective_scan(*map(jnp.asarray, args), q=16,
                               force_pallas=True)
    assert _rel(y, kern) <= TOL_PLAIN


def test_selective_scan_head_layout_is_mamba2s_recurrence():
    """dt, A and D repeated over a head's Pd channels make the Mamba1
    recurrence Mamba2's: y and the state (channel h·Pd + p, state n) equal
    the per-head recurrence h_t = exp(dt_h A_h) h_{t-1} + dt_h B_t x_tᵀ
    written out step by step."""
    rng = np.random.default_rng(4)
    Bt, S_, H, Pd, N = 2, 9, 3, 4, 64
    x = rng.normal(size=(Bt, S_, H * Pd)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(Bt, S_, H))) * 0.3).astype(np.float32)
    A = (-np.abs(rng.normal(size=H)) - 0.1).astype(np.float32)
    Bm = rng.normal(size=(Bt, S_, N)).astype(np.float32)
    Cm = rng.normal(size=(Bt, S_, N)).astype(np.float32)
    Dh = rng.normal(size=H).astype(np.float32)
    y, h = ops.selective_scan(
        _t(x), _t(np.repeat(dt, Pd, -1)),
        _t(np.repeat(A, Pd)[:, None].repeat(N, 1)), _t(Bm), _t(Cm),
        _t(np.repeat(Dh, Pd)))
    hh = np.zeros((Bt, H, N, Pd))
    xh = x.reshape(Bt, S_, H, Pd)
    ys = []
    for t in range(S_):
        hh = np.exp(dt[:, t] * A)[..., None, None] * hh + np.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], xh[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], hh)
                  + Dh[None, :, None] * xh[:, t])
    assert _rel(y, np.stack(ys, 1).reshape(Bt, S_, H * Pd)) <= TOL_PLAIN
    assert _rel(h.reshape(Bt, H, Pd, N).permute(0, 1, 3, 2), hh) <= TOL_PLAIN


# ------------------------------------------------ (b) the Mamba2 block ----
def _block_params(jcfg, seed):
    jp = _perturbed(JSSM.init_mamba2(jax.random.PRNGKey(seed), jcfg)[0],
                    seed)
    return (jax.tree.map(jnp.asarray, jp),
            {k: _t(v) for k, v in jp.items()})


def _hidden(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("n_state", [16, 64])
def test_init_mamba2_shapes_and_distributions(n_state):
    jcfg, cfg = _configs(n_state)
    want = JSSM.init_mamba2(jax.random.PRNGKey(0), jcfg)[0]
    got = SSM.init_mamba2(torch.Generator().manual_seed(0), cfg)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        if k in ("dt_bias", "conv_b", "convB_b", "convC_b", "A_log"):
            assert not g.any(), k
        elif k in ("D", "norm_scale"):
            assert bool((g == 1).all()), k
        else:   # normal draws at the reference's scale
            ws = float(np.std(np.asarray(w, np.float32)))
            assert 0.7 * ws < float(g.float().std()) < 1.3 * ws, k


@pytest.mark.parametrize("n_state", [16, 64])
def test_mamba2_block_without_cache(n_state):
    jcfg, cfg = _configs(n_state)
    jp, pp = _block_params(jcfg, 1)
    x = _hidden(cfg, 2, S)
    want, _ = JSSM.mamba2_block(jp, jnp.asarray(x), jcfg)
    got, cache = SSM.mamba2_block(pp, _t(x), cfg)
    assert cache is None
    assert _rel(got, want) <= TOL_SSD


@pytest.mark.parametrize("n_state", [16, 64])
def test_mamba2_block_prefill_then_decode(n_state):
    """Prefill S = 24 into the cache, then 4 one-token steps: the outputs
    and every cache entry (conv windows, the state in the reference's (B,
    H, N, Pd) layout) against the reference's."""
    jcfg, cfg = _configs(n_state)
    jp, pp = _block_params(jcfg, 3)
    x = _hidden(cfg, 4, S + STEPS)
    jc, _ = JSSM.init_mamba2_cache(jcfg, B)
    pc = SSM.init_mamba2_cache(cfg, B, "cpu")
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: v.shape for k, v in jc.items()}
    cuts = [slice(0, S)] + [slice(S + i, S + i + 1) for i in range(STEPS)]
    for sl in cuts:
        want, jc = JSSM.mamba2_block(jp, jnp.asarray(x[:, sl]), jcfg,
                                     cache=jc)
        got, pc = SSM.mamba2_block(pp, _t(x[:, sl]), cfg, cache=pc)
        assert _rel(got, want) <= TOL_SSD, sl
        for key in ("conv", "convB", "convC"):
            assert _rel(pc[key], jc[key]) <= TOL_PLAIN, (sl, key)
        assert _rel(pc["h"], jc["h"]) <= TOL_SSD, sl


def test_continued_prefill_pads_its_convolutions_with_zeros():
    """A reference-side behaviour the port mirrors (ROADMAP.md queue 3): a
    prompt continued at an offset (a second S > 1 call on a cache) starts
    from the cached state but pads its three convolutions with zeros
    rather than the cached windows.  The port's two calls equal the
    reference's, and both differ from one call over the whole prompt."""
    jcfg, cfg = _configs(16)
    jp, pp = _block_params(jcfg, 5)
    x = _hidden(cfg, 6, S)
    jc, _ = JSSM.init_mamba2_cache(jcfg, B)
    pc = SSM.init_mamba2_cache(cfg, B, "cpu")
    for sl in (slice(0, 16), slice(16, S)):
        want, jc = JSSM.mamba2_block(jp, jnp.asarray(x[:, sl]), jcfg,
                                     cache=jc)
        got, pc = SSM.mamba2_block(pp, _t(x[:, sl]), cfg, cache=pc)
        assert _rel(got, want) <= TOL_SSD
    whole, _ = SSM.mamba2_block(pp, _t(x), cfg)
    assert _rel(got, whole[:, 16:]) > 1e-2


# ------------------------------------------------ (c) the hybrid model ----
class Hybrid:
    """Smoke zamba2 at HYBRID_LAYERS layers in both packages, with the
    reference's (perturbed) weights in both."""

    def __init__(self):
        self.jcfg = jsmoke(jconfigs.get("zamba2-1.2b")).scaled(
            num_layers=HYBRID_LAYERS)
        self.cfg = smoke_config(configs.get("zamba2-1.2b")).scaled(
            num_layers=HYBRID_LAYERS)
        self.jmodel = jbuild(self.jcfg)
        self.np_params = _perturbed(self.jmodel.init(jax.random.PRNGKey(0)),
                                    7)
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.model = build(self.cfg, device="cpu")
        self.params = convert.lm_params_from_numpy(self.np_params, self.cfg,
                                                   device="cpu")
        self.tokens = np.random.default_rng(8).integers(
            0, self.cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
        self._ref = None

    def ref(self):
        """The reference's prefill logits and caches, then its decode
        steps' (as numpy)."""
        if self._ref is None:
            prefill = jax.jit(self.jmodel.prefill)
            decode = jax.jit(self.jmodel.decode_step)
            caches, _ = self.jmodel.init_caches(B, S + STEPS)
            toks = jnp.asarray(self.tokens)
            logits, caches = prefill(self.jparams, {"tokens": toks[:, :S]},
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
def hybrid():
    return Hybrid()


def test_hybrid_structure():
    """zamba2-1.2b: 6 groups of 6 Mamba2 layers, then a tail of 2; the
    smoke copy at 5 layers: 2 groups of 2 and a tail of 1, as the
    reference's lm_structure says."""
    for cfg, jcfg in ((configs.get("zamba2-1.2b"),
                       jconfigs.get("zamba2-1.2b")),
                      (smoke_config(configs.get("zamba2-1.2b")).scaled(
                          num_layers=5),
                       jsmoke(jconfigs.get("zamba2-1.2b")).scaled(
                           num_layers=5))):
        assert TF.lm_structure(cfg) == JTF.lm_structure(jcfg)
    assert TF.lm_structure(configs.get("zamba2-1.2b")) == [
        ("groups", 6, "hybrid_group"), ("tail", 2, "mamba2")]


def _hybrid_caches_close(got, want, tol_attn, tol_ssm):
    assert set(got) == set(want) == {"groups", "tail"}
    for g, group in enumerate(got["groups"]):
        for key in ("k", "v"):
            assert _rel(group["attn"][key],
                        want["groups"]["attn"][key][g]) <= tol_attn, (g, key)
        for j, layer in enumerate(group["mamba"]):
            for key, t in layer.items():
                w = want["groups"]["mamba"][key][g, j]
                tol = tol_ssm if key == "h" else tol_attn
                assert _rel(t, w) <= tol, (g, j, key)
    for i, layer in enumerate(got["tail"]):
        for key, t in layer.items():
            tol = tol_ssm if key == "h" else tol_attn
            assert _rel(t, want["tail"][key][i]) <= tol, (i, key)


def test_hybrid_prefill_and_decode_match_reference(hybrid):
    """Logits and every cache after the prefill and after each of 4 decode
    steps.  After the first group the activations carry the scan's
    differences, so every comparison takes TOL_SSD."""
    steps = hybrid.ref()
    toks = torch.from_numpy(hybrid.tokens).long()
    caches = hybrid.model.init_caches(B, S + STEPS)
    V = hybrid.cfg.vocab_size
    logits, caches = hybrid.model.prefill(
        hybrid.params, {"tokens": toks[:, :S]}, caches)
    assert logits.shape == (B, 1, L.padded_vocab(hybrid.cfg))
    for i in range(STEPS + 1):
        if i:
            logits, caches = hybrid.model.decode_step(
                hybrid.params, toks[:, S + i - 1:S + i], caches, S + i - 1)
        want_logits, want_caches = steps[i]
        assert _rel(logits[..., :V], want_logits[..., :V]) <= TOL_SSD, i
        _hybrid_caches_close(caches, want_caches, TOL_SSD, TOL_SSD)
        np.testing.assert_array_equal(_np32(logits[..., V:]),
                                      want_logits[..., V:])


def test_hybrid_decode_matches_forward(hybrid):
    """The port's prefill and 2 decode steps against its cache-free
    forward (tests/test_models.py's decode_matches_forward)."""
    toks = torch.from_numpy(hybrid.tokens).long()
    caches = hybrid.model.init_caches(B, S + 3)
    logits, caches = hybrid.model.prefill(
        hybrid.params, {"tokens": toks[:, :S]}, caches)
    dec = [logits]
    for i in range(2):
        lg, caches = hybrid.model.decode_step(
            hybrid.params, toks[:, S + i:S + i + 1], caches, S + i)
        dec.append(lg)
    h, _ = TF.forward(hybrid.params, toks[:, :S + 2], hybrid.cfg)
    want = L.lm_logits(hybrid.params["embed"], h, hybrid.cfg)[:, S - 1:]
    V = hybrid.cfg.vocab_size
    assert _rel(torch.cat(dec, 1)[..., :V], want[..., :V]) <= TOL_PLAIN


def test_hybrid_generate_matches_reference_loop(hybrid):
    """Greedy tokens of `generate` against examples/serve_llm.py's loop."""
    gen = 5
    prefill = jax.jit(hybrid.jmodel.prefill)
    decode = jax.jit(hybrid.jmodel.decode_step)
    caches, _ = hybrid.jmodel.init_caches(B, S + gen)
    logits, caches = prefill(
        hybrid.jparams, {"tokens": jnp.asarray(hybrid.tokens[:, :S])},
        caches)
    out = [jnp.argmax(logits[:, -1], -1)[:, None]]
    for i in range(gen - 1):
        logits, caches = decode(hybrid.jparams, out[-1], caches,
                                jnp.int32(S + i))
        out.append(jnp.argmax(logits[:, -1], -1)[:, None])
    got, _ = generate(hybrid.model, hybrid.params,
                      torch.from_numpy(hybrid.tokens[:, :S]).long(), gen)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(out, 1)))


def test_hybrid_convert_carries_every_leaf(hybrid):
    """Every leaf of the reference's hybrid tree (the groups' Mamba2
    layers stacked (G, per, ...), the tail, the shared attention block)
    crosses to the port's parameters bit for bit, and nothing else is
    there."""
    port = dict(hybrid.params.named_parameters())
    G, per = HYBRID_LAYERS // 2, 2
    for path, want in jax.tree_util.tree_flatten_with_path(
            hybrid.np_params)[0]:
        keys = [k.key for k in path]
        if keys[0] == "groups":
            for g in range(G):
                for j in range(per):
                    name = ".".join(["groups", str(g), "mamba", str(j)]
                                    + keys[2:])
                    np.testing.assert_array_equal(_np32(port.pop(name)),
                                                  _np32(want[g, j]))
        elif keys[0] == "tail":
            for i in range(want.shape[0]):
                name = ".".join(["tail", str(i)] + keys[1:])
                np.testing.assert_array_equal(_np32(port.pop(name)),
                                              _np32(want[i]))
        else:
            np.testing.assert_array_equal(_np32(port.pop(".".join(keys))),
                                          _np32(want))
    assert not port, sorted(port)


def test_hybrid_init_caches_layout(hybrid):
    """One attention cache a group and one Mamba2 cache a layer, the
    shapes of the reference's stacked caches."""
    got = hybrid.model.init_caches(B, 40)
    want, _ = hybrid.jmodel.init_caches(B, 40)
    assert len(got["groups"]) == want["groups"]["attn"]["k"].shape[0]
    for group in got["groups"]:
        for key in ("k", "v"):
            assert tuple(group["attn"][key].shape) == \
                want["groups"]["attn"][key].shape[1:]
        assert len(group["mamba"]) == want["groups"]["mamba"]["h"].shape[1]
        for key, t in group["mamba"][0].items():
            assert tuple(t.shape) == want["groups"]["mamba"][key].shape[2:]
    assert len(got["tail"]) == want["tail"]["h"].shape[0]
