"""ECAPA-TDNN speaker x-vector network, channels-last.

Port of `sparktts_tpu/nn/ecapa.py` with its attentive statistics pooling
(ASTP, global-context variant).  Each conv block is conv -> ReLU ->
BatchNorm (eval form, in that order); the Res2 split uses scale 8; the SE
block squeezes over time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparktts_tpu_torch.nn.layers import batch_norm_apply, conv1d_apply, linear_apply

RES2_SCALE = 8


def _conv_relu_bn_apply(p, x: torch.Tensor, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    x = conv1d_apply(p["conv"], x, padding=padding, dilation=dilation)
    return batch_norm_apply(p["bn"], torch.relu(x))


def _res2_apply(p, x: torch.Tensor, padding: int, dilation: int) -> torch.Tensor:
    """Multi-scale Res2 convolutions over 8 channel splits."""
    splits = torch.chunk(x, RES2_SCALE, dim=-1)
    out = []
    sp = splits[0]
    for i, (conv, bn) in enumerate(zip(p["convs"], p["bns"])):
        if i >= 1:
            sp = sp + splits[i]
        sp = conv1d_apply(conv, sp, padding=padding, dilation=dilation)
        sp = batch_norm_apply(bn, torch.relu(sp))
        out.append(sp)
    out.append(splits[-1])
    return torch.cat(out, dim=-1)


def _se_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excite over time."""
    s = torch.relu(linear_apply(p["l1"], x.mean(dim=1)))
    s = torch.sigmoid(linear_apply(p["l2"], s))
    return x * s[:, None, :]


def _se_res2_block_apply(p, x: torch.Tensor, padding: int, dilation: int) -> torch.Tensor:
    y = _conv_relu_bn_apply(p["in_conv"], x)
    y = _res2_apply(p["res2"], y, padding, dilation)
    y = _conv_relu_bn_apply(p["out_conv"], y)
    return x + _se_apply(p["se"], y)


def astp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Attentive statistics pooling with global context: (B, T, F) ->
    (B, 2F) attentive mean || std.  The context std uses the unbiased
    variance (correction 1), as torch.var does in the reference."""
    mean = x.mean(dim=1, keepdim=True)
    std = torch.sqrt(x.var(dim=1, keepdim=True, correction=1) + 1e-7)
    x_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    alpha = torch.tanh(linear_apply(p["linear1"], x_in))
    alpha = torch.softmax(linear_apply(p["linear2"], alpha), dim=1)  # over time
    pooled_mean = torch.sum(alpha * x, dim=1)
    pooled_var = torch.sum(alpha * x * x, dim=1) - pooled_mean**2
    pooled_std = torch.sqrt(torch.clamp(pooled_var, min=1e-7))
    return torch.cat([pooled_mean, pooled_std], dim=-1)


def ecapa_tdnn_apply(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, feat_dim) mels -> (x_vector (B, embed_dim), latent (B, T, latent_dim))."""
    out1 = _conv_relu_bn_apply(p["layer1"], x, padding=2)
    out2 = _se_res2_block_apply(p["layer2"], out1, padding=2, dilation=2)
    out3 = _se_res2_block_apply(p["layer3"], out2, padding=3, dilation=3)
    out4 = _se_res2_block_apply(p["layer4"], out3, padding=4, dilation=4)
    latent = torch.relu(conv1d_apply(p["conv"], torch.cat([out2, out3, out4], dim=-1)))
    pooled = batch_norm_apply(p["bn"], astp_apply(p["pool"], latent))
    return linear_apply(p["linear"], pooled), latent
