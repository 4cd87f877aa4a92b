"""Synthesis quality metrics: mel distance, speaker similarity and semantic
consistency.

Port of `sparktts_tpu/bench/metrics.py`.  BASELINE.md's parity bar is
"mel-distance / speaker-similarity parity vs the PyTorch fp32 reference";
these metrics make it measurable:

  * `mel_distance`: L1/L2 distance between log-mel spectrograms (the usual
    mel-cepstral-style reconstruction metric);
  * `speaker_similarity`: cosine similarity of ECAPA x-vectors computed with
    the codec's own speaker encoder weights;
  * `semantic_consistency`: the share of semantic ids one synthesis round
    trip keeps.

They run in fp32 in a `codec_fp32()` scope (the codec's own kernels on the
card, whatever the TF32 flags), on the device of
the pipeline they are given, or for `mel_distance` on `device` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from sparktts_tpu_torch.config import MelParams
from sparktts_tpu_torch.dsp.mel import make_mel_basis, mel_spectrogram
from sparktts_tpu_torch.nn.layers import codec_fp32


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def mel_distance(
    wav_a: np.ndarray,
    wav_b: np.ndarray,
    mel_params: MelParams | None = None,
    order: Literal[1, 2] = 1,
    log_floor: float = 1e-5,
    device: str | torch.device = "cuda",
) -> float:
    """Mean L1 (or L2) distance between log-mel spectrograms.  Signals are
    truncated to the common length."""
    mel_params = mel_params or MelParams()
    n = min(len(wav_a), len(wav_b))
    if n < mel_params.n_fft:
        raise ValueError("signals too short for a mel frame")
    basis = make_mel_basis(mel_params)
    wavs = torch.from_numpy(np.stack([np.asarray(wav_a[:n], np.float32),
                                      np.asarray(wav_b[:n], np.float32)])).to(_device(device))
    with torch.inference_mode(), codec_fp32():
        log_mels = torch.log(torch.clamp(mel_spectrogram(wavs, basis), min=log_floor))
        diff = log_mels[0] - log_mels[1]
        if order == 1:
            return float(diff.abs().mean())
        return float(torch.sqrt((diff**2).mean()))


def x_vector(pipeline, wav: np.ndarray) -> np.ndarray:
    """ECAPA x-vector of a waveform using the pipeline's speaker encoder."""
    from sparktts_tpu_torch.nn.ecapa import ecapa_tdnn_apply

    cfg = pipeline.config.bicodec
    basis = make_mel_basis(cfg.mel_params)
    x = torch.from_numpy(np.asarray(wav, np.float32))[None, :].to(pipeline.device)
    with torch.inference_mode(), codec_fp32():
        mel = mel_spectrogram(x, basis)
        vec, _ = ecapa_tdnn_apply(pipeline.bicodec_params["speaker_encoder"]["speaker_encoder"],
                                  mel)
        return vec[0].cpu().numpy()


def speaker_similarity(pipeline, wav_a: np.ndarray, wav_b: np.ndarray) -> float:
    """Cosine similarity of x-vectors (1.0 = same-speaker identical)."""
    va, vb = x_vector(pipeline, wav_a), x_vector(pipeline, wav_b)
    denom = np.linalg.norm(va) * np.linalg.norm(vb)
    if denom == 0:
        return 0.0
    return float(np.dot(va, vb) / denom)


def semantic_consistency(pipeline, wav: np.ndarray) -> float:
    """Fraction of semantic tokens preserved by one synthesis round trip:
    tokenize(detokenize(tokenize(wav))) vs tokenize(wav).  An ASR-free proxy
    for the reference benchmark's WER check (no ASR model ships here):
    content-destroying codec or quantization regressions drop it."""
    g, s = pipeline.tokenize_audio(np.asarray(wav, np.float32))
    recon = pipeline.detokenize(g, s)
    _, s2 = pipeline.tokenize_audio(recon)
    n = min(s.shape[1], s2.shape[1])
    if n == 0:
        return 0.0
    return float(np.mean(np.asarray(s)[0, :n] == np.asarray(s2)[0, :n]))
