"""Speaker encoder: ECAPA x-vector + Perceiver latents + residual FSQ tokens.

Port of `speaker_encoder_tokenize` (mels -> global token ids) and
`speaker_encoder_detokenize` (global ids -> d-vector) of
`sparktts_tpu/codec/speaker_encoder.py`.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.codec.fsq import residual_fsq_apply, residual_fsq_output_from_indices
from sparktts_tpu_torch.config import SpeakerEncoderConfig
from sparktts_tpu_torch.nn.ecapa import ecapa_tdnn_apply
from sparktts_tpu_torch.nn.layers import linear_apply
from sparktts_tpu_torch.nn.perceiver import perceiver_resampler_apply


def speaker_encoder_latents(p, mels: torch.Tensor, cfg: SpeakerEncoderConfig) -> torch.Tensor:
    """mels (B, T, n_mels) -> Perceiver latents (B, token_num, latent_dim),
    the input of the FSQ rounding."""
    _, features = ecapa_tdnn_apply(p["speaker_encoder"], mels)
    return perceiver_resampler_apply(p["perceiver_sampler"], features, cfg.perceiver_heads)


def speaker_encoder_tokenize(p, mels: torch.Tensor, cfg: SpeakerEncoderConfig) -> torch.Tensor:
    """mels (B, T, n_mels) -> global token ids (B, token_num) (with more than
    one quantizer, (B, token_num, Q))."""
    latents = speaker_encoder_latents(p, mels, cfg)
    _, indices = residual_fsq_apply(p["quantizer"], latents, cfg.fsq_levels, cfg.fsq_num_quantizers)
    return indices[..., 0] if cfg.fsq_num_quantizers == 1 else indices


def speaker_encoder_detokenize(p, indices: torch.Tensor, cfg: SpeakerEncoderConfig) -> torch.Tensor:
    """(B, token_num) ids -> d_vector (B, out_dim).  Latents are flattened in
    (token, latent) order, as in the JAX package."""
    if indices.ndim == 2:
        indices = indices[..., None]  # (B, N, Q=1)
    zq = residual_fsq_output_from_indices(
        p["quantizer"], indices, cfg.fsq_levels, cfg.fsq_num_quantizers
    )
    return linear_apply(p["project"], zq.reshape(zq.shape[0], -1))
