"""Host-side audio I/O and DSP (numpy and scipy only).

A copy of the parts of `sparktts_tpu/io/audio.py` that voice cloning reads:
wav read/write, polyphase resampling, loudness normalisation, and the 6 s
reference clip.  The JAX package's optional C++ host library is not carried
over; this module always takes the scipy paths, which that package uses
when its library is not built.
"""

from __future__ import annotations

from math import gcd
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Read a wav file to float64 mono in [-1, 1] (first channel only)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(str(path))
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        audio = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float64) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float64) - 128.0) / 128.0
    else:  # float32/float64 wavs
        audio = data.astype(np.float64)
    return audio, int(sr)


def write_wav(path: PathLike, audio: np.ndarray, sample_rate: int) -> None:
    """Write float audio in [-1, 1] as a 16-bit PCM wav."""
    from scipy.io import wavfile

    clipped = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    wavfile.write(str(path), sample_rate, (clipped * 32767.0).astype(np.int16))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (scipy's kaiser-windowed `resample_poly`)."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g)


def _quantile_band_mean(values: np.ndarray, lo_frac: float, hi_frac: float) -> float:
    """Mean of the ascending-order [lo_frac, hi_frac) slice of `values`, by a
    partial partition: the slice between the pinned endpoints holds exactly
    the values a full sort would place there."""
    n = values.size
    lo, hi = int(lo_frac * n), int(hi_frac * n)
    if hi <= lo:
        hi = lo + 1
    band = np.partition(values, (lo, hi - 1))[lo:hi]
    return float(band.mean())


def audio_volume_normalize(audio: np.ndarray, coeff: float = 0.2) -> np.ndarray:
    """Normalise perceived loudness toward `coeff`.

    A near-silent input (peak < 0.1) is first rescaled to a peak of 0.1.
    Loudness is the mean of the 90th-99th percentile band of the original
    magnitudes above 0.01; the audio is scaled by coeff / loudness, clamped
    to [0.1, 10], and its peak then clamped to 1.  Inputs with at most 10
    samples above 0.01 skip the loudness step.
    """
    mag = np.abs(audio)
    peak = float(mag.max()) if mag.size else 0.0
    out = audio
    if peak < 0.1:
        out = audio * (0.1 / max(peak, 1e-3))

    significant = mag[mag > 0.01]
    if significant.size <= 10:
        return out

    loudness = _quantile_band_mean(significant, 0.90, 0.99)
    out = out * float(np.clip(coeff / loudness, 0.1, 10.0))
    out_peak = float(np.abs(out).max())
    if out_peak > 1.0:
        out = out / out_peak
    return out


def load_audio(
    adfile: PathLike, sampling_rate: int | None = None, volume_normalize: bool = False
) -> np.ndarray:
    """Read a wav, resample it to `sampling_rate` and optionally normalise its
    loudness.  (The JAX package's random segment selection and silence trim
    are not on the voice-cloning path and are not copied.)"""
    audio, sr = read_wav(adfile)
    if sampling_rate is not None and sr != sampling_rate:
        audio = resample(audio, sr, sampling_rate)
    if volume_normalize:
        audio = audio_volume_normalize(audio)
    return audio


def get_ref_clip(
    wav: np.ndarray, sample_rate: int, ref_segment_duration: float, latent_hop_length: int
) -> np.ndarray:
    """The reference clip for the speaker encoder: `ref_segment_duration`
    seconds truncated to a multiple of the latent hop, the wav tiled first
    when it is shorter."""
    ref_segment_length = (
        int(sample_rate * ref_segment_duration) // latent_hop_length * latent_hop_length
    )
    wav_length = len(wav)
    if ref_segment_length > wav_length:
        wav = np.tile(wav, ref_segment_length // wav_length + 1)
    return wav[:ref_segment_length]
