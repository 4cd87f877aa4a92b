"""Feat decoder (the BiCodec prenet): latents -> features, speaker-conditioned
through AdaLN.

Port of `feat_decoder_apply` of `sparktts_tpu/codec/feat_decoder.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparktts_tpu_torch.config import DecoderConfig
from sparktts_tpu_torch.nn.layers import linear_apply
from sparktts_tpu_torch.nn.sampling import sampling_block_apply
from sparktts_tpu_torch.nn.vocos import vocos_backbone_apply


def feat_decoder_apply(
    p, x: torch.Tensor, cfg: DecoderConfig, cond: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x: (B, T, input_channels), cond: (B, condition_dim) or None
    -> (B, T * prod(sample_ratios), out_channels)."""
    x = linear_apply(p["linear_pre"], x)
    for stage, ratio in zip(p["upsample"], cfg.sample_ratios):
        x = sampling_block_apply(stage["sampler"], x, groups=cfg.vocos_dim, upsample_scale=ratio)
        x = vocos_backbone_apply(stage["vocos"], x)
    x = vocos_backbone_apply(p["vocos_backbone"], x, cond)
    x = linear_apply(p["linear"], x)
    return torch.tanh(x) if cfg.use_tanh_at_final else x
