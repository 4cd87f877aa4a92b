"""Named-voice registry + OpenAI-compatible audio encoding helpers.

The reference stack has no voice registry: every clone request re-uploads
prompt audio (reference `runtime/triton_trtllm/client_http.py` sends
`reference_wav` per request).  This module adds a production-serving layer
on top of the same pipeline: register a prompt wav once under a name, then
synthesize by name — over the OpenAI `/v1/audio/speech` wire protocol, so
off-the-shelf OpenAI SDK clients can talk to the server.  Combined with the
pipeline's voice cache (`SparkTTSPipeline(voice_cache_size=N)`), a named
voice pays audio tokenization once and every later request admits in one
device dispatch.

Everything here is host-side bookkeeping and byte packing — no device code.
A copy of `sparktts_tpu/serve/voices.py`.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# built-in creation-mode voices (controllable synthesis, no prompt audio)
BUILTIN_VOICES = ("female", "male")


def pcm16_bytes(audio: np.ndarray) -> bytes:
    """Float waveform in [-1, 1] → little-endian 16-bit PCM bytes."""
    clipped = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


def wav_header(n_pcm_bytes: int, sample_rate: int) -> bytes:
    """44-byte canonical RIFF/WAVE header for mono 16-bit PCM.

    For streamed responses (total length unknown when the header is sent)
    pass `n_pcm_bytes=WAV_STREAM_SIZE`; decoders read to EOF.
    """
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + n_pcm_bytes, b"WAVE",
        b"fmt ", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16,
        b"data", n_pcm_bytes,
    )


# "unknown length" marker for streamed WAV: the largest size the RIFF u32
# fields can carry; players treat over-long declared sizes as read-to-EOF
WAV_STREAM_SIZE = 0xFFFFFFFF - 36


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """Float waveform → complete in-memory 16-bit PCM WAV file."""
    pcm = pcm16_bytes(audio)
    return wav_header(len(pcm), sample_rate) + pcm


def openai_speed_level(speed: float) -> str:
    """OpenAI's continuous `speed` (0.25–4.0 playback rate) → the model's
    discrete speed attribute level (reference token vocabulary,
    `sparktts/utils/token_parser.py` LEVELS_MAP)."""
    speed = float(speed)
    if not 0.25 <= speed <= 4.0:
        raise ValueError("speed must be in [0.25, 4.0]")
    if speed <= 0.5:
        return "very_low"
    if speed <= 0.8:
        return "low"
    if speed < 1.25:
        return "moderate"
    if speed < 2.0:
        return "high"
    return "very_high"


class VoiceRegistry:
    """Thread-safe name → (prompt wav, prompt text) store.

    Registration is cheap (host memory only); tokenization happens on first
    use and is memoized by the pipeline's voice cache when enabled.
    """

    def __init__(self, max_voices: int = 256):
        self.max_voices = max_voices
        self._voices: Dict[str, Tuple[np.ndarray, Optional[str]]] = {}
        self._lock = threading.Lock()

    def register(
        self, name: str, wav: np.ndarray, prompt_text: Optional[str] = None
    ) -> None:
        name = str(name).strip()
        if not name:
            raise ValueError("voice name must be non-empty")
        if name in BUILTIN_VOICES:
            raise ValueError(f"'{name}' is a built-in voice")
        wav = np.ascontiguousarray(np.asarray(wav, dtype=np.float32).reshape(-1))
        if wav.size == 0:
            raise ValueError("voice prompt audio is empty")
        with self._lock:
            if name not in self._voices and len(self._voices) >= self.max_voices:
                raise ValueError(f"voice registry full ({self.max_voices})")
            self._voices[name] = (wav, prompt_text)

    def get(self, name: str) -> Tuple[np.ndarray, Optional[str]]:
        with self._lock:
            if name not in self._voices:
                raise KeyError(name)
            return self._voices[name]

    def remove(self, name: str) -> bool:
        with self._lock:
            return self._voices.pop(name, None) is not None

    def describe(self, sample_rate: int) -> List[dict]:
        """Listing payload: built-ins first, then registered clones."""
        out = [{"name": n, "kind": "builtin"} for n in BUILTIN_VOICES]
        with self._lock:
            for name, (wav, prompt_text) in self._voices.items():
                out.append(
                    {
                        "name": name,
                        "kind": "clone",
                        "duration_s": round(len(wav) / sample_rate, 3),
                        "has_prompt_text": prompt_text is not None,
                    }
                )
        return out
