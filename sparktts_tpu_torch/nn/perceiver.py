"""Perceiver resampler: learned latents cross-attend over ECAPA features.

Port of `sparktts_tpu/nn/perceiver.py`.  The keys and values include the
latents themselves (`cat([latents, context])`), the feed-forward is GEGLU,
and the output goes through `l2norm_scale` with sqrt(dim).
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.nn.layers import gelu, l2norm_scale_apply, linear_apply, matmul


def attention_apply(p, x: torch.Tensor, context: torch.Tensor, heads: int) -> torch.Tensor:
    """x: (B, N, D) latents; context: (B, M, D) -> (B, N, D)."""
    ctx = torch.cat([x, context], dim=1)
    q = linear_apply(p["to_q"], x)
    k, v = linear_apply(p["to_kv"], ctx).chunk(2, dim=-1)
    b, n, inner = q.shape
    dim_head = inner // heads

    def split(t):
        return t.reshape(b, -1, heads, dim_head).transpose(1, 2)

    sim = matmul(split(q), split(k).transpose(-1, -2)) * dim_head**-0.5
    out = matmul(torch.softmax(sim, dim=-1), split(v))
    return linear_apply(p["to_out"], out.transpose(1, 2).reshape(b, n, inner))


def feed_forward_apply(p, x: torch.Tensor) -> torch.Tensor:
    a, gate = linear_apply(p["w1"], x).chunk(2, dim=-1)
    return linear_apply(p["w2"], gelu(gate) * a)


def perceiver_resampler_apply(p, x: torch.Tensor, heads: int = 8) -> torch.Tensor:
    """x: (B, M, dim_context) -> (B, num_latents, dim)."""
    if "proj_context" in p:
        x = linear_apply(p["proj_context"], x)
    dim = p["latents"].shape[-1]
    latents = p["latents"].expand(x.shape[0], *p["latents"].shape)
    for layer in p["layers"]:
        latents = attention_apply(layer["attn"], latents, x, heads) + latents
        latents = feed_forward_apply(layer["ff"], latents) + latents
    return l2norm_scale_apply(p["norm"], latents, float(dim) ** 0.5)
