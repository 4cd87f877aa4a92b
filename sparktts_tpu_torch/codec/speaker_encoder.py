"""Speaker encoder: ECAPA x-vector + Perceiver latents + residual FSQ tokens.

Port of `speaker_encoder_tokenize` (mels -> global token ids),
`speaker_encoder_detokenize` (global ids -> d-vector), the eval forward
`speaker_encoder_forward` (x-vector and d-vector) and the torch model's
`get_codes_from_indices` / `get_indices` of
`sparktts_tpu/codec/speaker_encoder.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparktts_tpu_torch.codec.fsq import (
    fsq_indices_to_codes,
    residual_fsq_apply,
    residual_fsq_output_from_indices,
    residual_fsq_scales,
)
from sparktts_tpu_torch.config import SpeakerEncoderConfig
from sparktts_tpu_torch.nn.ecapa import ecapa_tdnn_apply
from sparktts_tpu_torch.nn.layers import linear_apply
from sparktts_tpu_torch.nn.perceiver import perceiver_resampler_apply


def _x_vector_and_latents(p, mels: torch.Tensor, cfg: SpeakerEncoderConfig):
    x_vector, features = ecapa_tdnn_apply(p["speaker_encoder"], mels)
    return x_vector, perceiver_resampler_apply(p["perceiver_sampler"], features,
                                               cfg.perceiver_heads)


def speaker_encoder_latents(p, mels: torch.Tensor, cfg: SpeakerEncoderConfig) -> torch.Tensor:
    """mels (B, T, n_mels) -> Perceiver latents (B, token_num, latent_dim),
    the input of the FSQ rounding."""
    return _x_vector_and_latents(p, mels, cfg)[1]


def speaker_encoder_forward(
    p, mels: torch.Tensor, cfg: SpeakerEncoderConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mels (B, T, n_mels) -> (x_vector, d_vector (B, out_dim)): the
    quantized latents flattened in (token, latent) order and projected."""
    x_vector, latents = _x_vector_and_latents(p, mels, cfg)
    zq, _ = residual_fsq_apply(p["quantizer"], latents, cfg.fsq_levels, cfg.fsq_num_quantizers)
    return x_vector, linear_apply(p["project"], zq.reshape(zq.shape[0], -1))


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


def speaker_encoder_get_codes_from_indices(
    p, indices: torch.Tensor, cfg: SpeakerEncoderConfig
) -> torch.Tensor:
    """(B, token_num) ids -> the scaled FSQ codes summed over quantizers,
    (B, token_num, levels), before any projection."""
    if indices.ndim == 2:
        indices = indices[..., None]
    scales = residual_fsq_scales(cfg.fsq_levels, cfg.fsq_num_quantizers)
    total = None
    for q in range(cfg.fsq_num_quantizers):
        codes = fsq_indices_to_codes(indices[..., q], cfg.fsq_levels) * torch.as_tensor(
            scales[q], dtype=torch.float32, device=indices.device)
        total = codes if total is None else total + codes
    return total


def speaker_encoder_get_indices(p, mels: torch.Tensor, cfg: SpeakerEncoderConfig) -> torch.Tensor:
    """mels -> quantizer indices (`speaker_encoder_tokenize`)."""
    return speaker_encoder_tokenize(p, mels, cfg)
