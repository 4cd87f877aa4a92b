"""Up/down-sampling block of the feat decoder and feat encoder.

Port of `sparktts_tpu/nn/sampling.py` (`sampling_block_apply`): upsampling
is repeat-interleave plus a depthwise transposed conv; downsampling is a
strided depthwise conv plus two average-pool skips.  With both scales 1 the
block returns x + x + x, as the reference's SamplingBlock does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.nn.layers import conv1d_apply, conv_transpose1d_apply


def avg_pool_downsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, T, C) average pool, kernel = stride = scale, ragged tail dropped."""
    return F.avg_pool1d(x.transpose(1, 2), scale).transpose(1, 2)


def sampling_block_apply(
    p, x: torch.Tensor, groups: int, upsample_scale: int = 1, downsample_scale: int = 1
) -> torch.Tensor:
    """x: (B, T, C) -> (B, T * upsample_scale // downsample_scale, C)."""
    if upsample_scale > 1:
        repeat_res = torch.repeat_interleave(x, upsample_scale, dim=1)
        deconv_res = conv_transpose1d_apply(
            p["de_conv_upsampler"],
            F.leaky_relu(x, 0.2),
            stride=upsample_scale,
            padding=upsample_scale // 2 + upsample_scale % 2,
            output_padding=upsample_scale % 2,
            groups=groups,
        )
        upmerge_res = repeat_res + deconv_res
    else:
        upmerge_res = repeat_res = x
    if downsample_scale > 1:
        conv_res = conv1d_apply(
            p["conv_downsampler"],
            F.leaky_relu(upmerge_res, 0.2),
            stride=downsample_scale,
            padding=downsample_scale // 2 + downsample_scale % 2,
            groups=groups,
        )
        return (
            conv_res
            + avg_pool_downsample(repeat_res, downsample_scale)
            + avg_pool_downsample(upmerge_res, downsample_scale)
        )
    return upmerge_res + repeat_res + upmerge_res
