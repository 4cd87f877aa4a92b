"""Speaker encoder, decode side: global token ids -> d-vector.

Port of `speaker_encoder_detokenize` of `sparktts_tpu/codec/speaker_encoder.py`.
The encode side (ECAPA-TDNN, Perceiver, FSQ quantize) belongs to voice
cloning and is not ported yet.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.codec.fsq import residual_fsq_output_from_indices
from sparktts_tpu_torch.config import SpeakerEncoderConfig
from sparktts_tpu_torch.nn.layers import linear_apply


def speaker_encoder_detokenize(p, indices: torch.Tensor, cfg: SpeakerEncoderConfig) -> torch.Tensor:
    """(B, token_num) ids -> d_vector (B, out_dim).  Latents are flattened in
    (token, latent) order, as in the JAX package."""
    if indices.ndim == 2:
        indices = indices[..., None]  # (B, N, Q=1)
    zq = residual_fsq_output_from_indices(
        p["quantizer"], indices, cfg.fsq_levels, cfg.fsq_num_quantizers
    )
    return linear_apply(p["project"], zq.reshape(zq.shape[0], -1))
