"""Vocos / ConvNeXt-1D backbone on channels-last tensors.

Port of `sparktts_tpu/nn/vocos.py`: depthwise k7 conv, LayerNorm or AdaLN
(speaker-conditioned), two pointwise linears with GELU, layer scale,
residual.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.nn.layers import (
    ada_layer_norm_apply,
    conv1d_apply,
    layer_norm_apply,
    linear_apply,
)


def _norm(p, x: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
    return layer_norm_apply(p, x) if cond is None else ada_layer_norm_apply(p, x, cond)


def convnext_block_apply(p, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, C) -> (B, T, C)."""
    residual = x
    x = conv1d_apply(p["dwconv"], x, padding=3, groups=x.shape[-1])
    x = _norm(p["norm"], x, cond)
    x = linear_apply(p["pwconv2"], F.gelu(linear_apply(p["pwconv1"], x)))
    if "gamma" in p:
        x = p["gamma"] * x
    return residual + x


def vocos_backbone_apply(p, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, C_in) -> (B, T, dim)."""
    x = conv1d_apply(p["embed"], x, padding=3)
    x = _norm(p["norm"], x, cond)
    for blk in p["blocks"]:
        x = convnext_block_apply(blk, x, cond)
    return layer_norm_apply(p["final_layer_norm"], x)
