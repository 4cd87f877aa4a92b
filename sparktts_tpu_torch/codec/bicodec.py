"""BiCodec, decode side: (semantic, global) token ids -> waveform.

Port of `bicodec_detokenize` of `sparktts_tpu/codec/bicodec.py`.  Runs in
the params dtype (fp32).  `bicodec_tokenize` (voice cloning) is not ported
yet.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.codec.feat_decoder import feat_decoder_apply
from sparktts_tpu_torch.codec.fvq import fvq_detokenize
from sparktts_tpu_torch.codec.speaker_encoder import speaker_encoder_detokenize
from sparktts_tpu_torch.codec.wave_generator import wave_generator_apply
from sparktts_tpu_torch.config import BiCodecConfig


def bicodec_detokenize(
    p, cfg: BiCodecConfig, semantic_tokens: torch.Tensor, global_tokens: torch.Tensor
) -> torch.Tensor:
    """(semantic (B, T), global (B, N)) -> waveform (B, T * hop)."""
    z_q = fvq_detokenize(p["quantizer"], semantic_tokens)
    d_vector = speaker_encoder_detokenize(p["speaker_encoder"], global_tokens, cfg.speaker_encoder)
    x = feat_decoder_apply(p["prenet"], z_q, cfg.prenet, cond=d_vector)
    x = x + d_vector[:, None, :]
    return wave_generator_apply(p["decoder"], x, cfg.decoder)[..., 0]
