"""Up-sampling block of the feat decoder.

Port of the upsample path of `sparktts_tpu/nn/sampling.py`
(`sampling_block_apply`): repeat-interleave plus a depthwise transposed
conv.  With a scale of 1 the block returns x + x + x, as the reference's
SamplingBlock does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.nn.layers import conv_transpose1d_apply


def sampling_block_apply(p, x: torch.Tensor, groups: int, upsample_scale: int = 1) -> torch.Tensor:
    """x: (B, T, C) -> (B, T * upsample_scale, C)."""
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
    # no downsampling on the decode path: conv and skip paths are identities
    return upmerge_res + repeat_res + upmerge_res
