"""Mel spectrogram as a framed matmul-RFFT.

Port of `sparktts_tpu/dsp/mel.py`: the reference's torchaudio
MelSpectrogram (power 1, slaney norm and mel scale, center=True with reflect
padding) as frame -> window -> RFFT by two fp32 matmuls -> magnitude -> mel
filterbank matmul.  The matmul form is kept rather than `torch.stft`, so the
port does the same arithmetic as the JAX package.  The constants are built in
numpy, as there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sparktts_tpu_torch.config import MelParams


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default)."""
    n = np.arange(win_length)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


def _hz_to_mel_slaney(freq):
    """Slaney hz -> mel: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        freq / f_sp,
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels
    )


def mel_filterbank(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """Slaney-normalised slaney-scale triangular filterbank, (n_freqs, n_mels)
    (torchaudio's `melscale_fbanks(norm='slaney', mel_scale='slaney')`)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])  # 2 / bandwidth
    return fb * enorm[None, :]


class MelBasis(NamedTuple):
    window: np.ndarray     # (n_fft,): the win_length window centred in n_fft
    rfft_real: np.ndarray  # (n_fft, n_freqs)
    rfft_imag: np.ndarray  # (n_fft, n_freqs)
    mel_fb: np.ndarray     # (n_freqs, n_mels)
    n_fft: int
    hop_length: int


@functools.lru_cache(maxsize=8)
def make_mel_basis(params: MelParams) -> MelBasis:
    n_fft = params.n_fft
    n_freqs = n_fft // 2 + 1
    f_max = params.mel_fmax if params.mel_fmax is not None else params.sample_rate / 2.0
    left = (n_fft - params.win_length) // 2
    window = np.zeros(n_fft)
    window[left : left + params.win_length] = hann_window(params.win_length)
    angle = -2.0 * np.pi * np.arange(n_freqs)[:, None] * np.arange(n_fft)[None, :] / n_fft
    mel_fb = mel_filterbank(n_freqs, params.mel_fmin, f_max, params.num_mels, params.sample_rate)
    return MelBasis(
        window=window.astype(np.float32),
        rfft_real=np.cos(angle).T.astype(np.float32),
        rfft_imag=np.sin(angle).T.astype(np.float32),
        mel_fb=mel_fb.astype(np.float32),
        n_fft=n_fft,
        hop_length=params.hop_length,
    )


def mel_spectrogram(wav: torch.Tensor, basis: MelBasis) -> torch.Tensor:
    """(B, T) -> (B, num_frames, n_mels) fp32 magnitude mel, channels-last."""
    dev = wav.device
    pad = basis.n_fft // 2
    x = F.pad(wav.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, basis.n_fft, basis.hop_length)  # (B, F, n_fft)
    frames = frames * torch.from_numpy(basis.window).to(dev)
    real = frames @ torch.from_numpy(basis.rfft_real).to(dev)
    imag = frames @ torch.from_numpy(basis.rfft_imag).to(dev)
    magnitude = torch.sqrt(real * real + imag * imag + 1e-12)
    return magnitude @ torch.from_numpy(basis.mel_fb).to(dev)
