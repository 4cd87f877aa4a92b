"""Feat encoder: wav2vec2 features -> quantizer-ready latents.

Port of `feat_encoder_apply` of `sparktts_tpu/codec/feat_encoder.py`.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.config import EncoderConfig
from sparktts_tpu_torch.nn.layers import linear_apply
from sparktts_tpu_torch.nn.sampling import sampling_block_apply
from sparktts_tpu_torch.nn.vocos import vocos_backbone_apply


def feat_encoder_apply(p, x: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """x: (B, T, input_channels) -> (B, T / prod(sample_ratios), out_channels)."""
    x = vocos_backbone_apply(p["encoder"], x)
    for stage, ratio in zip(p["downsample"], cfg.sample_ratios):
        x = sampling_block_apply(stage["sampler"], x, groups=cfg.vocos_dim, downsample_scale=ratio)
        x = vocos_backbone_apply(stage["vocos"], x)
    return linear_apply(p["project"], x)
