"""Host-side audio I/O and DSP.

A copy of `sparktts_tpu/io/audio.py`: wav read/write, polyphase resampling,
loudness normalisation, random segment selection, silence trimming and the
6 s reference clip.  As there, wav read/write and resampling go through the
native C++ host library (`io/native.py`, built with g++ at first use) where
it builds, and through numpy and scipy otherwise; `backend()` says which,
and the first call logs it.
"""

from __future__ import annotations

from math import gcd
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from sparktts_tpu_torch.io import native

PathLike = Union[str, Path]


def backend() -> str:
    """The host audio path: `native.status()`, "native (...)" or "scipy (...)"."""
    return native.status()


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Read a wav file to float64 mono in [-1, 1] (first channel only)."""
    res = native.read_wav(path)
    if res is not None:
        return res
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
    if native.write_wav(path, np.asarray(audio, dtype=np.float64), sample_rate):
        return
    from scipy.io import wavfile

    clipped = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    wavfile.write(str(path), sample_rate, (clipped * 32767.0).astype(np.int16))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (scipy's kaiser-windowed `resample_poly`)."""
    if orig_sr == target_sr:
        return audio
    g = gcd(orig_sr, target_sr)
    res = native.resample(audio, target_sr // g, orig_sr // g)
    if res is not None:
        return res
    from scipy.signal import resample_poly

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


def random_select_audio_segment(
    audio: np.ndarray, length: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """A uniformly placed `length`-sample window (a short input is
    zero-padded first)."""
    if audio.shape[0] < length:
        audio = np.pad(audio, (0, int(length - audio.shape[0])))
    rng = rng or np.random.default_rng()
    start = int(rng.integers(0, audio.shape[0] - length + 1))
    return audio[start : start + length]


def load_audio(
    adfile: PathLike,
    sampling_rate: int | None = None,
    length: int | None = None,
    volume_normalize: bool = False,
    segment_duration: float | None = None,
    remove_silence: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Read a wav and resample it to `sampling_rate`; then optionally a
    random `segment_duration` window (drawn from `rng`), silence trimmed at
    both ends, loudness normalised, and cropped or zero-padded to `length`
    samples (which must lie within 1000 of the audio's)."""
    audio, sr = read_wav(adfile)
    if sampling_rate is not None and sr != sampling_rate:
        audio = resample(audio, sr, sampling_rate)
        sr = sampling_rate
    if segment_duration is not None:
        audio = random_select_audio_segment(audio, int(sr * segment_duration), rng)
    if remove_silence:
        audio = remove_silence_on_both_ends(audio, sr)
    if volume_normalize:
        audio = audio_volume_normalize(audio)
    if length is not None:
        if abs(audio.shape[0] - length) >= 1000:
            raise ValueError(f"load_audio: {audio.shape[0]} samples, asked for {length}")
        if audio.shape[0] > length:
            audio = audio[:length]
        else:
            audio = np.pad(audio, (0, int(length - audio.shape[0])))
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


def frame_rms(wav: np.ndarray, frame: int, hop: int) -> np.ndarray:
    """Per-frame RMS over windows of `frame` samples every `hop`, from a
    cumulative sum of squares."""
    sq = np.concatenate([[0.0], np.cumsum(np.square(wav, dtype=np.float64))])
    starts = np.arange(0, len(wav) - frame + 1, hop)
    return np.sqrt(np.maximum(sq[starts + frame] - sq[starts], 0.0) / frame)


def detect_speech_boundaries(
    wav: np.ndarray,
    sample_rate: int,
    window_duration: float = 0.1,
    energy_threshold: float = 0.01,
    margin_factor: int = 2,
) -> Tuple[int, int]:
    """(start, end) samples: the first and last `window_duration` frame
    (hopped at a tenth of a frame) whose RMS reaches `energy_threshold`,
    widened by `margin_factor` frames.  Raises ValueError on silence."""
    frame = int(window_duration * sample_rate)
    hop = max(frame // 10, 1)
    voiced = np.flatnonzero(frame_rms(wav, frame, hop) >= energy_threshold)
    if voiced.size == 0:
        raise ValueError("No speech detected in audio (only silence)")
    margin = margin_factor * frame
    start = max(int(voiced[0]) * hop - margin, 0)
    end = min(int(voiced[-1]) * hop + margin, len(wav))
    return start, end


def remove_silence_on_both_ends(
    wav: np.ndarray,
    sample_rate: int,
    window_duration: float = 0.1,
    volume_threshold: float = 0.01,
) -> np.ndarray:
    """The wav with its leading and trailing silence trimmed."""
    bounds = detect_speech_boundaries(wav, sample_rate, window_duration, volume_threshold)
    return wav[slice(*bounds)]
