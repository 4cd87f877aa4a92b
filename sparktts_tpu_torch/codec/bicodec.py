"""BiCodec: (wav2vec2 features, reference wav) <-> (semantic, global) token
ids <-> waveform.

Port of `bicodec_tokenize`, `bicodec_detokenize`, the eval forward
`bicodec_forward` (reconstruction and codebook statistics) and
`detokenize_receptive_field` of `sparktts_tpu/codec/bicodec.py`.  The first
three run in fp32 under `full_fp32`, so their numbers do not depend on the
caller's TF32 settings.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from sparktts_tpu_torch.codec.feat_decoder import feat_decoder_apply
from sparktts_tpu_torch.codec.feat_encoder import feat_encoder_apply
from sparktts_tpu_torch.codec.fvq import fvq_detokenize, fvq_forward, fvq_tokenize
from sparktts_tpu_torch.codec.speaker_encoder import (
    speaker_encoder_detokenize,
    speaker_encoder_forward,
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


@full_fp32()
def bicodec_forward(
    p, cfg: BiCodecConfig, feat: torch.Tensor, ref_wav: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """The torch model's eval forward: (feat (B, T50, 1024), ref_wav) ->
    the reconstruction `recons` (B, T * hop), the postnet's `pred_feat`,
    `x_vector`, `d_vector`, the semantic codebook's `perplexity` and
    `cluster_size` (codes used), and the `semantic_indices`."""
    mel = mel_spectrogram(ref_wav, make_mel_basis(cfg.mel_params))
    vq = fvq_forward(p["quantizer"], feat_encoder_apply(p["encoder"], feat, cfg.encoder))
    x_vector, d_vector = speaker_encoder_forward(p["speaker_encoder"], mel, cfg.speaker_encoder)
    x = feat_decoder_apply(p["prenet"], vq["z_q"], cfg.prenet, cond=d_vector)
    pred_feat = feat_decoder_apply(p["postnet"], x, cfg.postnet)
    x = x + d_vector[:, None, :]
    return {
        "recons": wave_generator_apply(p["decoder"], x, cfg.decoder)[..., 0],
        "pred_feat": pred_feat,
        "x_vector": x_vector,
        "d_vector": d_vector,
        "perplexity": vq["perplexity"],
        "cluster_size": vq["active_num"],
        "semantic_indices": vq["indices"],
    }


def detokenize_receptive_field(cfg: BiCodecConfig) -> int:
    """One-sided receptive field of `bicodec_detokenize`, in input latent
    frames (rounded up): an output sample at time t depends on input frames
    [t - RF, t + RF] only, since the detokenize path is convolutional (the
    FVQ/FSQ lookups and the d-vector conditioning are per frame or global).
    A streaming server can vocode a token window with RF frames of left
    context and emit a tail equal to a full-prefix recompute.

    An upper bound: a conv with one-sided reach r samples in a domain
    upsampled `up` times relative to the input frames reaches r / up input
    frames.  The prenet's Vocos backbones are an embed conv k7 plus k7
    depthwise convs; its sampler deconv (k = 2 ratio, pad = ceil(ratio / 2),
    stride ratio) reaches (k - 1 - pad) / ratio frames of its own input; the
    WaveGenerator's blocks are a transposed conv (k, s) and three residual
    units k7 at dilations 1, 3, 9, between two k7 convs."""

    def vocos_rf(num_layers: int) -> float:
        return 3.0 + 3.0 * num_layers

    rf, up = 0.0, 1.0
    pre = cfg.prenet
    for ratio in pre.sample_ratios:
        if ratio > 1:
            pad = ratio // 2 + ratio % 2
            rf += ((2 * ratio - 1 - pad) / ratio) / up
            up *= ratio
        rf += vocos_rf(2) / up  # per-stage 2-layer backbone
    rf += vocos_rf(pre.vocos_num_layers) / up
    dec = cfg.decoder
    rf += 3.0 / up  # conv_in k7
    for k, s in zip(dec.kernel_sizes, dec.rates):
        rf += (k / s) / up  # transposed conv, one-sided bound
        up *= s
        rf += (3.0 * (1 + 3 + 9)) / up  # residual units k7, d = 1/3/9
    rf += 3.0 / up  # conv_out k7
    return int(math.ceil(rf))
