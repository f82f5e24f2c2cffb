#!/usr/bin/env python3
"""Where the moe family's bf16 prefill and decode part, on one card.

    PYTHONPATH=src python3 tools/diagnose_moe_pvd.py [--arch deepseek-v2-236b]

Builds deepseek-v2-236b and deepseek-v3-671b (or --arch) as chip_smoke.py's
phase 8 does (full width, 4 layers, bf16, weights and tokens from its seed)
at capacity_factor 8, so that no token-expert pair is dropped, and for
each MLA decode mode (absorbed, materialize) and each way of forming the
decode's attention scores (the reference's: bf16 products rounded to bf16
before the f32 softmax; or f32 products from the same bf16 operands)
compares prefill(S + 1) with prefill(S) then one decode step, as
chip_smoke.prefill_vs_decode does.  For each MoE layer it prints the
decoded token's hidden state against the same token's in the long
prefill (normwise relative), how many of the LM_BATCH rows were routed
to another expert set, and each row's gap between the k-th and (k+1)-th
router probability (a gap this small flips under rounding).  One line
per mode with the card's name and power limit from nvidia-smi.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as c  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

ARCHES = ("deepseek-v2-236b", "deepseek-v3-671b")


def attend_f32_scores(p, q_nope, q_rope, ckv, kr, cfg, *, q_offset, valid,
                      absorbed):
    """MLA._attend_plain with the scores formed in f32 from the same bf16
    operands (the reference's dense mha does this; its MLA rounds them to
    bf16)."""
    m = cfg.mla
    B, S, H, _ = q_nope.shape
    T = ckv.shape[1]
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    rope = torch.einsum("bshn,btn->bhst", q_rope.float(), kr.float())
    if absorbed:
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
        logits = torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
    else:
        k_nope = torch.einsum("btr,rhn->bthn", ckv, w_uk)
        logits = torch.einsum("bshn,bthn->bhst", q_nope.float(),
                              k_nope.float())
    logits = (logits + rope) * MLA._scale(cfg)
    qpos = q_offset + torch.arange(S, device=ckv.device)[:, None]
    kpos = torch.arange(T, device=ckv.device)[None, :]
    logits = logits.masked_fill(~(qpos >= kpos), -1e30)
    w = torch.softmax(logits.masked_fill(~valid, -1e30), dim=-1)
    if absorbed:
        o_lat = torch.einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv)
        return torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
    v = torch.einsum("btr,rhv->bthv", ckv, w_uv)
    return torch.einsum("bhst,bthv->bshv", w.to(v.dtype), v)


def routed(record):
    """A _moe_local stand-in that records each call's tokens and their
    router's top k + 1 (indices of the top k sorted, probabilities)."""
    inner = MOE._moe_local

    def spy(xt, p, cfg, e_start, e_local, capacity):
        probs = torch.softmax(xt.float() @ p["router"], -1)
        top = torch.topk(probs, cfg.moe.top_k + 1, -1)
        record.append((xt.clone(), top.indices[:, :-1].sort(-1).values,
                       top.values))
        return inner(xt, p, cfg, e_start, e_local, capacity)
    return spy


def diagnose(arch: str, dev) -> None:
    cfg = configs.get(arch).scaled(num_layers=c.LM_MOE_LAYERS[arch])
    cfg = cfg.scaled(moe=dataclasses.replace(
        cfg.moe, capacity_factor=c.PVD_CAPACITY_FACTOR))
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 8)
    params = build(cfg, device=dev).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (c.LM_BATCH, c.LM_PROMPT + 1),
                           generator=gen, device=dev)
    B, S1 = tokens.shape
    rows = torch.arange(B, device=dev) * S1 + S1 - 1
    plain, local = MLA._attend_plain, MOE._moe_local
    record: list = []
    MOE._moe_local = routed(record)
    try:
        for mode in ("absorbed", "materialize"):
            for scores, fn in (("bf16", plain), ("f32", attend_f32_scores)):
                MLA._attend_plain = fn
                model = build(cfg.scaled(mla_decode_mode=mode), device=dev)
                record.clear()
                with torch.inference_mode():
                    want, _ = model.prefill(params, {"tokens": tokens},
                                            model.init_caches(B, S1))
                    n = len(record)
                    _, caches = model.prefill(
                        params, {"tokens": tokens[:, :-1]},
                        model.init_caches(B, S1))
                    start = len(record)
                    got, _ = model.decode_step(params, tokens[:, -1:],
                                               caches, S1 - 1)
                torch.cuda.synchronize()
                V = cfg.vocab_size
                print(f"[{arch}] decode {mode}, scores {scores}: prefill "
                      f"against decode {c.rel_err(got[..., :V], want[..., :V]):.3e}",
                      flush=True)
                for layer, ((xa, ia, pa), (xb, ib, _)) in enumerate(
                        zip(record[:n], record[start:])):
                    flips = int((ia[rows] != ib).any(-1).sum())
                    gaps = (pa[rows, -2] - pa[rows, -1]).tolist()
                    print(f"    MoE layer {layer}: hidden "
                          f"{c.rel_err(xb, xa[rows]):.3e}, rows on another "
                          f"expert set {flips} of {B}, k-th minus (k+1)-th "
                          f"probability {['%.2e' % g for g in gaps]}",
                          flush=True)
                del model, caches, want, got
    finally:
        MOE._moe_local, MLA._attend_plain = local, plain
    del params, tokens
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHES, action="append")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diagnose_moe_pvd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(c.card()["nvidia_smi"])
    dev = torch.device("cuda", 0)
    for arch in args.arch or ARCHES:
        diagnose(arch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
