"""Mixture-of-Experts FFN (DeepSeek style: routed experts with capacity,
plus shared experts).

Counterpart of src/repro/models/moe.py, its one-device path: every expert
on this device, tokens routed by an f32 router and softmax, top_k experts
a token with renormalized gates, the Switch auxiliary loss, and a
capacity of max(int(B·S·top_k·capacity_factor / E), 4) tokens an expert.
Token-expert pairs are sorted by expert with a *stable* sort, so within an
expert tokens keep their order and the ones past capacity are dropped,
the same ones as in the reference.  The expert products are batched
matrix products over (E, C, D) × (E, D, F), as the reference leaves them
to XLA (no Pallas kernel).  The combine gathers, for each token, its ≤ k
slot outputs (each gate product rounded to x's dtype, as the reference's
scatter-add operands are) and sums them in top-k order in f32, then rounds
to x's dtype: no float atomics (the reference's scatter-add), so repeated
runs give the same bits.  ``torch.topk`` orders equal probabilities
otherwise than ``jax.lax.top_k`` (lower index first); with real-valued
router weights ties do not occur, and nothing here works around them.

The reference's mesh branches (experts sharded over "model", and
``moe_2d``'s F-sharded experts) raise: the LM on a mesh waits for
ROADMAP.md queue 1 item 13.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.distmat.types import MULTI_GPU_ITEM
from .config import ModelConfig
from .layers import _dense_init, pdtype


def _expert_init(gen: torch.Generator, shape, dtype,
                 scale: float) -> torch.Tensor:
    """A stacked (E, ·, ·) weight drawn one expert at a time, so that the
    f32 draw alive at once is one expert's, not the whole stack's (15 GB
    for one deepseek-v3-671b layer's w_gate)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = _dense_init(gen, shape[1:], dtype, scale)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = pdtype(cfg)
    p = {"router": _dense_init(gen, (d, E), torch.float32),
         "w_gate": _expert_init(gen, (E, d, f), dt, 1.0 / math.sqrt(d)),
         "w_up": _expert_init(gen, (E, d, f), dt, 1.0 / math.sqrt(d)),
         "w_down": _expert_init(gen, (E, f, d), dt, 1.0 / math.sqrt(f))}
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p |= {"ws_gate": _dense_init(gen, (d, fs), dt),
              "ws_up": _dense_init(gen, (d, fs), dt),
              "ws_down": _dense_init(gen, (fs, d), dt)}
    return p


class RoutingTally:
    """What the router did in every ``_moe_local`` call made inside
    ``with RoutingTally() as t:``.  When the block exits, ``t.calls`` holds
    a dict a call, in call order: "pairs" (token-expert pairs routed),
    "dropped" (those past capacity), "max_load" (the largest expert's
    pairs), "capacity", and "experts" (each token's top_k experts, sorted,
    (T, k) on the device); ``t.pairs`` and ``t.dropped`` are the sums.  One
    host sync at the exit, none inside."""

    active: "RoutingTally | None" = None

    def __enter__(self):
        self._calls = []
        RoutingTally.active = self
        return self

    def __exit__(self, *exc):
        RoutingTally.active = None
        self.calls = [{"pairs": n, "dropped": n - int(kept),
                       "max_load": int(top), "capacity": cap,
                       "experts": experts}
                      for n, kept, top, cap, experts in self._calls]
        self.pairs = sum(c["pairs"] for c in self.calls)
        self.dropped = sum(c["dropped"] for c in self.calls)
        return False


def _moe_local(xt: torch.Tensor, p, cfg: ModelConfig, e_start: int,
               e_local: int, capacity: int):
    """Token dispatch and expert products for experts [e_start, e_start +
    e_local).  xt: (T, D) tokens.  Returns (output (T, D), aux loss)."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.num_experts, m.top_k
    dev = xt.device

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (T, E)
    gates, eidx = torch.topk(probs, k, dim=-1)                   # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # Load-balancing auxiliary loss (Switch-style): E · Σ_e f_e · P_e
    counts = torch.bincount(eidx.reshape(-1), minlength=E).float()
    aux = E * torch.sum(counts / (T * k) * probs.mean(0))

    N = T * k
    flat_e = eidx.reshape(-1)
    flat_g = gates.reshape(-1).to(xt.dtype)
    flat_t = torch.arange(N, device=dev) // k
    local = (flat_e >= e_start) & (flat_e < e_start + e_local)
    le = torch.where(local, flat_e - e_start, e_local)            # trash
    sorted_le, perm = torch.sort(le, stable=True)
    first = torch.searchsorted(sorted_le,
                               torch.arange(e_local + 1, device=dev))
    pos = torch.arange(N, device=dev) - first[sorted_le]
    keep = (sorted_le < e_local) & (pos < capacity)
    n_slots = e_local * capacity
    slot = torch.where(keep, sorted_le * capacity + pos, n_slots)
    if RoutingTally.active is not None:
        RoutingTally.active._calls.append((N, keep.sum(), counts.max(),
                                           capacity,
                                           eidx.sort(-1).values))

    # The slot → token map (kept slots are distinct; every dropped pair
    # lands on the trash slot n_slots, which is cut off).
    slot_token = torch.zeros(n_slots + 1, dtype=torch.long, device=dev)
    slot_token[slot] = flat_t[perm]
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    slot_valid[slot] = keep
    slot_token, slot_valid = slot_token[:-1], slot_valid[:-1]

    # The (E_l, C, ·) buffers are the layer's largest (7.5 GB of bf16 for
    # deepseek-v3-671b at capacity 2048), so each is made once and worked
    # on in place.
    disp = xt[slot_token]
    disp.masked_fill_(~slot_valid[:, None], 0)
    disp = disp.reshape(e_local, capacity, D)
    h = F.silu(torch.bmm(disp, p["w_gate"]), inplace=True)
    h.mul_(torch.bmm(disp, p["w_up"]))
    del disp
    out_e = torch.empty(n_slots + 1, D, dtype=xt.dtype, device=dev)
    torch.bmm(h, p["w_down"], out=out_e[:n_slots].view(e_local, capacity, D))
    out_e[n_slots] = 0                        # what the trash slot reads
    del h

    # Combine: each pair's slot, gated in x's dtype and summed over the k
    # choices in top-k order in f32.
    pair_slot = torch.empty(N, dtype=torch.long, device=dev)
    pair_slot[perm] = slot
    pair_slot, g = pair_slot.reshape(T, k), flat_g.reshape(T, k)
    acc = torch.zeros(T, D, dtype=torch.float32, device=dev)
    for j in range(k):
        acc += (out_e[pair_slot[:, j]] * g[:, j, None]).float()
    return acc.to(xt.dtype), aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, *, mesh=None):
    """x: (B, S, D).  Returns (out, aux_loss); on one device only."""
    if mesh is not None:
        raise NotImplementedError(
            "the MoE FFN on a mesh (experts sharded over 'model', moe_2d) "
            f"waits for {MULTI_GPU_ITEM}")
    m = cfg.moe
    B, S, D = x.shape
    cap = max(int(B * S * m.top_k * m.capacity_factor / m.num_experts), 4)
    out, aux = _moe_local(x.reshape(B * S, D), p, cfg, 0, m.num_experts, cap)
    out = out.reshape(B, S, D)
    if m.num_shared_experts:
        h = F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
        out = out + h @ p["ws_down"]
    return out, aux * m.router_aux_loss
