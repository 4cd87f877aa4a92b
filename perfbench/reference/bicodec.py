"""A plain BiCodec decoder in float32: global and semantic ids to a waveform.

The decode half of Spark-TTS's BiCodec (`sparktts/models/bicodec.py`
`detokenize`): the factorized VQ's codebook lookup and out-projection, the
speaker FSQ's codes projected to a d-vector, the prenet (a Vocos backbone
with AdaLayerNorm on the d-vector), the d-vector added, and the
WaveGenerator (snake, transposed convs, residual units at dilations 1, 3,
9, tanh).  `torch.nn.functional` convolutions, one call each.

Weights are a tree with these keys: a linear {"w": (in, out), "b"}, a conv
{"w": (K, Cin / groups, Cout), "b"} applied as a cross-correlation, a
transposed conv stored as the flipped forward kernel (K, Cin, Cout).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

DILATIONS = (1, 3, 9)


def linear(p, x):
    return x @ p["w"] + p["b"]


def conv(p, x, padding=0, dilation=1, groups=1):
    """(B, T, C) -> (B, T', Cout)."""
    y = F.conv1d(x.transpose(1, 2), p["w"].permute(2, 1, 0), p["b"], padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose(p, x, stride, padding, output_padding=0, groups=1):
    k, cin_g, cout = p["w"].shape
    w = p["w"].flip(0).reshape(k, cin_g, groups, cout // groups)
    w = w.permute(2, 1, 3, 0).reshape(groups * cin_g, cout // groups, k)
    y = F.conv_transpose1d(x.transpose(1, 2), w, p["b"], stride=stride, padding=padding,
                           output_padding=output_padding, groups=groups)
    return y.transpose(1, 2)


def layer_norm(p, x, cond=None, eps=1e-6):
    y = F.layer_norm(x, x.shape[-1:], eps=eps)
    if cond is None:
        return y * p["gamma"] + p["beta"]
    return y * linear(p["scale"], cond)[:, None] + linear(p["shift"], cond)[:, None]


def snake(alpha, x):
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def vocos(p, x, cond=None):
    x = layer_norm(p["norm"], conv(p["embed"], x, padding=3), cond)
    for blk in p["blocks"]:
        y = conv(blk["dwconv"], x, padding=3, groups=x.shape[-1])
        y = layer_norm(blk["norm"], y, cond)
        y = linear(blk["pwconv2"], F.gelu(linear(blk["pwconv1"], y)))
        x = x + blk["gamma"] * y
    return layer_norm(p["final_layer_norm"], x)


def feat_decoder(p, x, ratios: Sequence[int], cond):
    x = linear(p["linear_pre"], x)
    for stage, r in zip(p["upsample"], ratios):
        # the SamplingBlock: (repeat + deconv) + repeat + (repeat + deconv),
        # which is x + x + x at ratio 1
        repeat = torch.repeat_interleave(x, r, dim=1) if r > 1 else x
        merged = repeat
        if r > 1:
            merged = repeat + conv_transpose(
                stage["sampler"]["de_conv_upsampler"], F.leaky_relu(x, 0.2), stride=r,
                padding=r // 2 + r % 2, output_padding=r % 2, groups=x.shape[-1])
        x = vocos(stage["vocos"], merged + repeat + merged)
    return linear(p["linear"], vocos(p["vocos_backbone"], x, cond))


def wave_generator(p, x, rates: Sequence[int], kernels: Sequence[int]):
    x = conv(p["conv_in"], x, padding=3)
    for blk, s, k in zip(p["blocks"], rates, kernels):
        x = conv_transpose(blk["upsample"], snake(blk["snake"]["alpha"], x), stride=s,
                           padding=(k - s) // 2)
        for ru, d in zip(blk["res_units"], DILATIONS):
            y = conv(ru["conv1"], snake(ru["snake1"]["alpha"], x), padding=3 * d, dilation=d)
            x = x + conv(ru["conv2"], snake(ru["snake2"]["alpha"], y))
    x = snake(p["snake_out"]["alpha"], x)
    return torch.tanh(conv(p["conv_out"], x, padding=3))[..., 0]


def speaker_vector(p, ids: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """(B, N) speaker ids -> (B, out_dim): each id's mixed-radix digits as
    codes in [-1, 1], projected out, flattened in (token, latent) order."""
    lv = torch.as_tensor(list(levels), device=ids.device)
    basis = torch.as_tensor(np.cumprod([1] + list(levels[:-1])), device=ids.device)
    digits = torch.div(ids[..., None], basis, rounding_mode="floor") % lv
    half = (lv // 2).float()
    codes = (digits.float() - half) / half
    q = p["quantizer"]
    if "project_out" in q:
        codes = linear(q["project_out"], codes)
    return linear(p["project"], codes.reshape(codes.shape[0], -1))


@torch.no_grad()
def decode(p: Dict, cfg: Dict, speaker: torch.Tensor, semantic: torch.Tensor,
           bucket: int) -> torch.Tensor:
    """speaker (N,) and semantic (T,) ids -> float32 waveform (T * hop,).
    The ids are edge-replicated to a multiple of `bucket` before decoding and
    the waveform cut back to T ids' worth of samples, as a served vocode pads."""
    t = semantic.shape[0]
    pad = torch.arange(-(-t // bucket) * bucket, device=semantic.device).clamp(max=t - 1)
    z = p["quantizer"]["codebook"][semantic[pad]][None]
    if "out_project" in p["quantizer"]:
        z = linear(p["quantizer"]["out_project"], z)
    d = speaker_vector(p["speaker_encoder"], speaker[None], cfg["speaker_encoder"]["fsq_levels"])
    x = feat_decoder(p["prenet"], z, cfg["prenet"]["sample_ratios"], d) + d[:, None]
    dec = cfg["decoder"]
    wav = wave_generator(p["decoder"], x, dec["rates"], dec["kernel_sizes"])[0]
    hop = int(np.prod(dec["rates"])) * int(np.prod(cfg["prenet"]["sample_ratios"]))
    return wav[: t * hop]
