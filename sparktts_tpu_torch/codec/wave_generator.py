"""WaveGenerator vocoder: DAC-style transposed-conv upsampling stack.

Port of `wave_generator_apply` of `sparktts_tpu/codec/wave_generator.py`.
Every ResidualUnit with float weights goes through
`kernels/vocoder_fusion.fused_residual_unit`: the hand-written CUDA kernel on
the card, its plain version on the CPU.  A unit of an int8 tree
(`codec/quant.py`) runs the unfused unit, as in the JAX package: the kernel
takes fp32 weights only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sparktts_tpu_torch.config import WaveGeneratorConfig
from sparktts_tpu_torch.kernels.vocoder_fusion import (
    fused_residual_unit,
    fused_residual_unit_plain,
)
from sparktts_tpu_torch.nn.layers import conv1d_apply, conv_transpose1d_apply, snake_apply

DILATIONS = (1, 3, 9)


def _decoder_block_apply(p, x: torch.Tensor, kernel_size: int, stride: int,
                         unit: Optional[Callable] = None) -> torch.Tensor:
    """`unit`: the ResidualUnit function for every unit of the block (the
    vocoder bench times both); None takes the kernel module for float
    weights, the unfused unit for an int8 tree."""
    y = snake_apply(p["snake"], x)
    y = conv_transpose1d_apply(p["upsample"], y, stride=stride, padding=(kernel_size - stride) // 2)
    y = y.contiguous()  # the kernel reads (B, T, C) rows; the conv returns a transposed view
    for ru, dil in zip(p["res_units"], DILATIONS):
        f = unit or (fused_residual_unit if "w" in ru["conv1"] else fused_residual_unit_plain)
        y = f(ru, y, dil)
    return y


def wave_generator_apply(p, x: torch.Tensor, cfg: WaveGeneratorConfig,
                         unit: Optional[Callable] = None) -> torch.Tensor:
    """x: (B, T, input_channel) -> (B, T * prod(rates), d_out) in [-1, 1].
    `unit`: as `_decoder_block_apply`'s."""
    x = conv1d_apply(p["conv_in"], x, padding=3)
    for blk, k, s in zip(p["blocks"], cfg.kernel_sizes, cfg.rates):
        x = _decoder_block_apply(blk, x, k, s, unit)
    x = snake_apply(p["snake_out"], x)
    return torch.tanh(conv1d_apply(p["conv_out"], x, padding=3))
