"""Carry the reference's state across: numpy arrays in, port objects out.

The JAX package's arrays leave it as numpy (`np.asarray(jax_array)`); these
helpers put them on a device as torch tensors.  bfloat16, float8_e4m3fn
and float8_e5m2 arrays (numpy's ml_dtypes extension types) cross by bit
pattern, since torch does not read those types: bfloat16 → view as int16
→ torch.int16 → view as bfloat16, the fp8 types likewise through uint8
(types.tensor_from_array).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distmat import types as T
from repro_torch.core.distmat.rowmatrix import RowMatrix
from repro_torch.core.distmat.sparserow import SparseRowMatrix
from repro_torch.kernels.dtypes import cast


def tensor_from_numpy(arr, *, device, dtype=None) -> torch.Tensor:
    """`arr` on `device` with the same values; bfloat16 and the fp8 types
    keep their bits.  A cast to `dtype` goes through kernels/dtypes.cast
    (the fp8 types with the reference's rounding)."""
    arr = np.asarray(arr)
    dev = T.resolve_device(device)
    t = T.tensor_from_array(np.array(arr)).to(dev)
    return t if dtype is None else cast(t, dtype)


def rowmatrix_from_numpy(rows, n_rows: int, *, device,
                         store_dtype=None) -> RowMatrix:
    """A RowMatrix from the reference's stored rows (`np.asarray(rm.rows)`,
    padding included) and its true row count `rm.n_rows`."""
    t = tensor_from_numpy(rows, device=device, dtype=store_dtype)
    return RowMatrix(rows=t.contiguous(), n_rows=int(n_rows))


def vector_from_numpy(v, *, device) -> torch.Tensor:
    """A data- or solution-space vector (b, x0, targets, weights) as f32."""
    return tensor_from_numpy(v, device=device, dtype=torch.float32)


def sparserow_from_numpy(data, cols, dims, nnz: int, scales=None, *,
                         device) -> SparseRowMatrix:
    """A SparseRowMatrix from the reference's stored arrays
    (`np.asarray(srm.data)`, `srm.cols`, padding block-rows included), its
    true dims and nnz; int8 data and its f32 `scales` cross as they are."""
    return SparseRowMatrix(
        tensor_from_numpy(data, device=device).contiguous(),
        tensor_from_numpy(np.asarray(cols, np.int32),
                          device=device).contiguous(),
        dims=tuple(int(d) for d in dims), nnz=int(nnz),
        scales=None if scales is None else tensor_from_numpy(
            np.asarray(scales, np.float32), device=device).contiguous())


def lm_params_from_numpy(params, cfg, *, device):
    """The port's LM parameters (`models.transformer.Params`) from the
    reference's parameter pytree as numpy arrays
    (`jax.tree.map(np.asarray, model.init(key))`).  Each layer stack's
    leading layer axis (the reference's vmap-stacked init) is unstacked
    into one module a layer (a MoE layer's experts stay stacked, (E, d, f)
    tensors); a hybrid model's groups are stacked twice, (G, per, ...),
    and unstacked twice.  The MTP subtree and the hybrid's shared
    attention block, one block each, cross as they are.  An encdec tree
    (embed, the encoder and decoder stacks, enc_norm, final_norm) crosses
    the same way."""
    from repro_torch.models import transformer as TF

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return tensor_from_numpy(tree, device=device)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    def unstack(tree, n):
        return [tensors(layer(tree, i)) for i in range(n)]

    out = {"embed": tensors(params["embed"]),
           "final_norm": tensors(params["final_norm"])}
    if cfg.family == "encdec":
        out["enc_norm"] = tensors(params["enc_norm"])
        out["encoder"] = unstack(params["encoder"], cfg.encoder_layers)
        out["decoder"] = unstack(params["decoder"], cfg.num_layers)
        stacks = []
    else:
        stacks = TF.lm_structure(cfg)
    for name, n, kind in stacks:
        if kind == "hybrid_group":
            mamba = params[name]["mamba"]
            out[name] = [{"mamba": unstack(layer(mamba, g),
                                           cfg.ssm.attn_every)}
                         for g in range(n)]
        else:
            out[name] = unstack(params[name], n)
    if cfg.mtp_depth:
        out["mtp"] = tensors(params["mtp"])
    if cfg.family == "hybrid":
        out["shared_attn"] = tensors(params["shared_attn"])
    extra = sorted(set(params) - set(out))
    if extra:
        raise NotImplementedError(f"parameters {extra} belong to parts of "
                                  "the model that are not ported yet")
    return TF.Params(out)
