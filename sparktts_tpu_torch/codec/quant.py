"""Weight-only int8 quantization of the BiCodec param tree.

Port of `sparktts_tpu/codec/quant.py`: every {"w", "b"?} leaf dict (linear,
conv and transposed-conv kernels) becomes {"w_q": int8, "scale": fp32 (out,),
"b"?}, symmetric per output channel, the scale applied to the OUTPUT of the
matmul or conv (`nn/layers.py`).  Codebooks, snake alphas, norm params and
the Perceiver's latent queries stay in full precision.  Usage:

    pipe.bicodec_params = quantize_bicodec_int8(pipe.bicodec_params)

An int8 tree's ResidualUnits run the unfused unit
(`codec/wave_generator.py`): the vocoder kernel takes fp32 weights only.
"""

from __future__ import annotations

import torch

#: keys of leaves (or sub-trees) that are never quantized
_SKIP_KEYS = {"codebook", "alpha", "gamma", "beta", "mean", "var", "latents"}


def quantize_weight_int8(w: torch.Tensor) -> dict:
    """(..., out) weight -> {"w_q": int8, "scale": fp32 (out,)}; the scale
    reduces over every axis but the last (linears and WIO conv kernels)."""
    w = w.float()
    scale = w.abs().amax(dim=tuple(range(w.dim() - 1))) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale}


def _is_weight_dict(node) -> bool:
    return isinstance(node, dict) and "w" in node and not isinstance(node["w"], dict)


def quantize_bicodec_int8(params):
    """Quantize every {"w", "b"?} leaf dict of a BiCodec tree, or of any
    sub-tree of it (for instance only `params["decoder"]`)."""
    if _is_weight_dict(params):
        out = quantize_weight_int8(params["w"])
        if "b" in params:
            out["b"] = params["b"]
        return out
    if isinstance(params, dict):
        return {k: v if k in _SKIP_KEYS else quantize_bicodec_int8(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_bicodec_int8(v) for v in params)
    return params


def quantized_bytes(tree) -> int:
    """Parameter memory of a tree in bytes."""
    if isinstance(tree, dict):
        return sum(quantized_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0
