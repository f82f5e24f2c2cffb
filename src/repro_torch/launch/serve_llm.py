"""LM serving: batched prefill into caches, then token-by-token greedy
decode.

Counterpart of examples/serve_llm.py, on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve_llm --arch llama3.2-3b \
        --batch 4 --prompt-len 2048 --gen 32

The prefill runs the hand-written kernels: flash_attention once a layer
(dense, vlm, and the moe family's MLA at head dim 192), selective_scan
once a layer (Mamba1 at N = 16), for zamba2 (hybrid) selective_scan once
a Mamba2 layer (N = 64) and flash_attention once a group (the shared
attention block), and for seamless (encdec) flash_attention three times a
layer pair (the encoder's non-causal self-attention, the decoder's causal
self-attention and its non-causal cross-attention); decode steps take the
plain one-token paths.  Weights are drawn from a seeded generator (no
checkpoint is read); a configuration with a frontend stub gets
precomputed embeddings, normal × 0.02, as examples/serve_llm.py draws
them: `frontend_len` positions of vlm patches, or the prompt's length of
encdec frames, which size the encoder and its cross K/V caches.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.distmat.types import MULTI_GPU_ITEM, resolve_device
from repro_torch.models import build, smoke_config


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def generate(model, params, tokens: torch.Tensor, gen: int,
             frontend_embeds: torch.Tensor | None = None):
    """Prefill `tokens` (B, S) into fresh caches, then decode `gen` − 1
    steps, each feeding back the argmax of the last logits.  The prefill
    batch carries `frontend_embeds` (B, n, d) when given (the first n
    positions' embeddings; for encdec the encoder's n frames, and its
    cross K/V caches hold n positions); decode steps take none, as in the
    reference.
    Returns (the `gen` greedy tokens (B, gen), {"prefill_ms",
    "decode_ms_per_token"} on the host clock around synchronized work)."""
    B, S = tokens.shape
    if model.cfg.family == "encdec":
        caches = model.init_caches(B, S + gen, frontend_embeds.shape[1])
    else:
        caches = model.init_caches(B, S + gen)
    batch = {"tokens": tokens}
    if frontend_embeds is not None:
        batch["frontend_embeds"] = frontend_embeds
    _sync(model.device)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, caches)
    out = [logits[:, -1].argmax(-1, keepdim=True)]
    _sync(model.device)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = model.decode_step(params, out[-1], caches, S + i)
        out.append(logits[:, -1].argmax(-1, keepdim=True))
    _sync(model.device)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, 1), {
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_token": t_decode / max(gen - 1, 1) * 1e3}


def frontend_embeds(cfg, batch: int, prompt_len: int,
                    gen: torch.Generator) -> torch.Tensor | None:
    """The frontend stub's embeddings for `cfg` (None without a frontend):
    `frontend_len` positions (the prompt's length for encdec), normal ×
    0.02, f32, drawn on gen's device."""
    if not cfg.frontend:
        return None
    flen = prompt_len if cfg.family == "encdec" else cfg.frontend_len
    return torch.randn(batch, flen, cfg.d_model, generator=gen,
                       device=gen.device) * 0.02


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        raise NotImplementedError("the port serves on one device; a mesh "
                                  f"waits for {MULTI_GPU_ITEM}")

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    dev = resolve_device(args.device)
    model = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    B, S = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    out, times = generate(model, params, tokens, args.gen,
                          frontend_embeds(cfg, B, S, gen))
    print(f"prefill: {times['prefill_ms']:.1f}ms for {B}x{S} tokens")
    print(f"decode : {times['decode_ms_per_token']:.1f}ms/token "
          f"(batch {B})")
    print("generated token ids (first row):", out[0, :16].tolist())


if __name__ == "__main__":
    main()
