"""BiCodec: (wav2vec2 features, reference wav) <-> (semantic, global) token
ids <-> waveform.

Port of `bicodec_tokenize` and `bicodec_detokenize` of
`sparktts_tpu/codec/bicodec.py`.  Both run in fp32 under `full_fp32`, so
their numbers do not depend on the caller's TF32 settings.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparktts_tpu_torch.codec.feat_decoder import feat_decoder_apply
from sparktts_tpu_torch.codec.feat_encoder import feat_encoder_apply
from sparktts_tpu_torch.codec.fvq import fvq_detokenize, fvq_tokenize
from sparktts_tpu_torch.codec.speaker_encoder import (
    speaker_encoder_detokenize,
    speaker_encoder_tokenize,
)
from sparktts_tpu_torch.codec.wave_generator import wave_generator_apply
from sparktts_tpu_torch.config import BiCodecConfig
from sparktts_tpu_torch.dsp.mel import make_mel_basis, mel_spectrogram
from sparktts_tpu_torch.nn.layers import full_fp32


@full_fp32()
def bicodec_tokenize(
    p, cfg: BiCodecConfig, feat: torch.Tensor, ref_wav: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feat (B, T50, 1024), ref_wav (B, T16k)) -> (semantic (B, T50 / enc_ratio),
    global (B, token_num)) token ids."""
    mel = mel_spectrogram(ref_wav, make_mel_basis(cfg.mel_params))
    semantic = fvq_tokenize(p["quantizer"], feat_encoder_apply(p["encoder"], feat, cfg.encoder))
    return semantic, speaker_encoder_tokenize(p["speaker_encoder"], mel, cfg.speaker_encoder)


@full_fp32()
def bicodec_detokenize(
    p, cfg: BiCodecConfig, semantic_tokens: torch.Tensor, global_tokens: torch.Tensor
) -> torch.Tensor:
    """(semantic (B, T), global (B, N)) -> waveform (B, T * hop)."""
    z_q = fvq_detokenize(p["quantizer"], semantic_tokens)
    d_vector = speaker_encoder_detokenize(p["speaker_encoder"], global_tokens, cfg.speaker_encoder)
    x = feat_decoder_apply(p["prenet"], z_q, cfg.prenet, cond=d_vector)
    x = x + d_vector[:, None, :]
    return wave_generator_apply(p["decoder"], x, cfg.decoder)[..., 0]
