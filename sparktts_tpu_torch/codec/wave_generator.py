"""WaveGenerator vocoder: DAC-style transposed-conv upsampling stack.

Port of `wave_generator_apply` of `sparktts_tpu/codec/wave_generator.py`
with the plain ResidualUnit (snake -> dilated k7 conv -> snake -> 1x1 conv,
residual).  The fused ResidualUnit kernel of the JAX package
(`kernels/vocoder_fusion.py`) is off by default there and not ported yet.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.config import WaveGeneratorConfig
from sparktts_tpu_torch.nn.layers import conv1d_apply, conv_transpose1d_apply, snake_apply

DILATIONS = (1, 3, 9)


def _residual_unit_apply(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = snake_apply(p["snake1"], x)
    y = conv1d_apply(p["conv1"], y, padding=3 * dilation, dilation=dilation)
    y = snake_apply(p["snake2"], y)
    y = conv1d_apply(p["conv2"], y)
    return x + y


def _decoder_block_apply(p, x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    y = snake_apply(p["snake"], x)
    y = conv_transpose1d_apply(p["upsample"], y, stride=stride, padding=(kernel_size - stride) // 2)
    for ru, dil in zip(p["res_units"], DILATIONS):
        y = _residual_unit_apply(ru, y, dil)
    return y


def wave_generator_apply(p, x: torch.Tensor, cfg: WaveGeneratorConfig) -> torch.Tensor:
    """x: (B, T, input_channel) -> (B, T * prod(rates), d_out) in [-1, 1]."""
    x = conv1d_apply(p["conv_in"], x, padding=3)
    for blk, k, s in zip(p["blocks"], cfg.kernel_sizes, cfg.rates):
        x = _decoder_block_apply(blk, x, k, s)
    x = snake_apply(p["snake_out"], x)
    return torch.tanh(conv1d_apply(p["conv_out"], x, padding=3))
