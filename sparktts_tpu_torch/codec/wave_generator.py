"""WaveGenerator vocoder: DAC-style transposed-conv upsampling stack.

Port of `wave_generator_apply` of `sparktts_tpu/codec/wave_generator.py`.
Every ResidualUnit goes through `kernels/vocoder_fusion.fused_residual_unit`:
the hand-written CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.config import WaveGeneratorConfig
from sparktts_tpu_torch.kernels.vocoder_fusion import fused_residual_unit
from sparktts_tpu_torch.nn.layers import conv1d_apply, conv_transpose1d_apply, snake_apply

DILATIONS = (1, 3, 9)


def _decoder_block_apply(p, x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    y = snake_apply(p["snake"], x)
    y = conv_transpose1d_apply(p["upsample"], y, stride=stride, padding=(kernel_size - stride) // 2)
    y = y.contiguous()  # the kernel reads (B, T, C) rows; the conv returns a transposed view
    for ru, dil in zip(p["res_units"], DILATIONS):
        y = fused_residual_unit(ru, y, dil)
    return y


def wave_generator_apply(p, x: torch.Tensor, cfg: WaveGeneratorConfig) -> torch.Tensor:
    """x: (B, T, input_channel) -> (B, T * prod(rates), d_out) in [-1, 1]."""
    x = conv1d_apply(p["conv_in"], x, padding=3)
    for blk, k, s in zip(p["blocks"], cfg.kernel_sizes, cfg.rates):
        x = _decoder_block_apply(blk, x, k, s)
    x = snake_apply(p["snake_out"], x)
    return torch.tanh(conv1d_apply(p["conv_out"], x, padding=3))
