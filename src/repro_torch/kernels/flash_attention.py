"""Causal (or full) flash attention, forward, with native GQA.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` (``_flash_kernel``): prefill attention of the LM serving
path.  On the H100 it is bound by operations (4·D flops a live query–key
pair against one read of q, k, v and one write of o).
``csrc/flash_attention.cu`` has two variants, chosen by dtype.  bf16 (the
prefill's type) runs on the tensor cores: a block of two consumer
warpgroups owns a (b·hq, 128-query tile) and walks the key tiles
(skipping those past the causal diagonal), which one producer warp brings
in by TMA through a two-stage ring; QKᵀ and PV are both ``wgmma``, with p
rounded to bf16 as the A fragment of PV, and the online-softmax state and
the output tile stay in registers.  Key tiles are 128 keys up to D = 128
and 64 at D = 192 (DeepSeek's MLA prefill), where a 128-key ring would not
fit in shared memory beside Q and the output tile takes 96 registers a
thread.  f32 runs on the CUDA cores (f32 FMA,
64-query blocks), as the tensor cores have no f32 product at f32
precision.  The KV row of a query row is bh // group, so repeated KV heads
are never materialized; query and key lengths may differ (Sq against Sk,
the causal mask top-left as in the reference's ``tril((Sq, Sk))``), and
the ragged edges of both are masked in the kernel.

``flash_attention_plain`` is the same function in plain torch: explicit
(Sq × Sk) scores, f32 softmax, GQA by ``repeat_interleave``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from . import ref as _ref

HEAD_DIMS = (32, 64, 128, 192)
# The kernel variant each dtype launches.
VARIANTS = {torch.bfloat16: "wgmma_bf16", torch.float32: "fma_f32"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float | None = None, causal: bool = True,
                          q_heads_per_kv: int = 1) -> torch.Tensor:
    """q: (B·Hq, Sq, D); k, v: (B·Hkv, Sk, D).  Returns (B·Hq, Sq, D) in
    q.dtype."""
    return _ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                    q_heads_per_kv=q_heads_per_kv)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    q_heads_per_kv: int = 1) -> torch.Tensor:
    """Launch csrc/flash_attention.cu on contiguous CUDA q (B·Hq, Sq, D)
    and k, v (B·Hkv, Sk, D) of one dtype (f32 or bf16), D in HEAD_DIMS and
    B·Hq = B·Hkv · q_heads_per_kv (a view that starts off a 16-byte
    boundary is copied to one that does); returns o (B·Hq, Sq, D) in
    q.dtype.  Counts the launch in
    ``flash_attention.launches``, in ``flash_attention.variant_launches``
    under its variant (``VARIANTS``) and in ``flash_attention.mask_launches``
    under "causal" or "non_causal"."""
    dev = _build.check_device(q, k, v)
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bhq, sq, d = q.shape
    sk = k.shape[1]
    if k.shape[2] != d or bhq != k.shape[0] * q_heads_per_kv:
        raise ValueError(f"k {tuple(k.shape)} does not conform to q "
                         f"{tuple(q.shape)} with {q_heads_per_kv} q heads a "
                         f"KV head")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    code = _build.dtype_code(q, "q")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    _build.check(_build.lib().repro_flash_attention(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        code, bhq, sq, sk, d, q_heads_per_kv, scale, int(causal),
        _build.stream(dev)), "flash_attention launch")
    flash_attention.launches += 1
    flash_attention.variant_launches[VARIANTS[q.dtype]] += 1
    flash_attention.mask_launches["causal" if causal else "non_causal"] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS.values(), 0)
flash_attention.mask_launches = {"causal": 0, "non_causal": 0}
