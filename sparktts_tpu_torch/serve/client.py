"""HTTP client for the TTS server (role of reference
`runtime/triton_trtllm/client_http.py`): single-utterance offline request via
the JSON API, stdlib-only.  A copy of `sparktts_tpu/serve/client.py` that
reads and writes wavs with the port's `io/audio.py`; it talks to either
package's server.

    python -m sparktts_tpu_torch.serve.client --port 8000 --text "hello" \
        [--prompt-wav voice.wav] [--stream] --output out.wav
"""

from __future__ import annotations

import argparse
import base64
import json
import urllib.request
from typing import Optional

import numpy as np


def synthesize(
    host: str,
    port: int,
    text: str,
    prompt_wav: Optional[np.ndarray] = None,
    prompt_text: Optional[str] = None,
    gender: Optional[str] = None,
    pitch: Optional[str] = None,
    speed: Optional[str] = None,
    timeout: float = 300.0,
) -> tuple:
    """POST /tts → (wav float32 array, sample_rate, stats dict)."""
    payload = {"text": text}
    if prompt_wav is not None:
        payload["prompt_wav_b64"] = base64.b64encode(
            np.asarray(prompt_wav, np.float32).tobytes()
        ).decode()
    if prompt_text:
        payload["prompt_text"] = prompt_text
    if gender:
        payload.update(gender=gender, pitch=pitch, speed=speed)

    req = urllib.request.Request(
        f"http://{host}:{port}/tts",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = json.loads(resp.read())
    wav = np.frombuffer(base64.b64decode(body["wav_b64"]), np.float32)
    stats = {k: body[k] for k in ("queue_ms", "infer_ms") if k in body}
    return wav, body["sample_rate"], stats


def synthesize_stream(
    host: str,
    port: int,
    text: str,
    prompt_wav: Optional[np.ndarray] = None,
    prompt_text: Optional[str] = None,
    gender: Optional[str] = None,
    pitch: Optional[str] = None,
    speed: Optional[str] = None,
    max_new_tokens: Optional[int] = None,
    timeout: float = 300.0,
):
    """POST /tts_stream → generator of (wav_chunk float32, sample_rate).

    Network counterpart of the reference's decoupled streaming transactions
    (reference `client_grpc.py:332-433`): audio chunks arrive over chunked
    transfer encoding as NDJSON lines while synthesis is still running, so the
    caller observes true first-chunk latency through the wire.
    """
    payload = {"text": text}
    if prompt_wav is not None:
        payload["prompt_wav_b64"] = base64.b64encode(
            np.asarray(prompt_wav, np.float32).tobytes()
        ).decode()
    if prompt_text:
        payload["prompt_text"] = prompt_text
    if gender:
        payload.update(gender=gender, pitch=pitch, speed=speed)
    if max_new_tokens is not None:
        payload["max_new_tokens"] = max_new_tokens

    req = urllib.request.Request(
        f"http://{host}:{port}/tts_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            if not line.strip():
                continue
            obj = json.loads(line)
            if obj.get("done"):
                return
            if "error" in obj:
                raise RuntimeError(f"server stream error: {obj['error']}")
            yield np.frombuffer(base64.b64decode(obj["wav_b64"]), np.float32), obj[
                "sample_rate"
            ]


def get_stats(host: str, port: int) -> dict:
    with urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=10) as resp:
        return json.loads(resp.read())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--text", required=True)
    parser.add_argument("--prompt-wav", default=None, help="wav path for voice cloning")
    parser.add_argument("--prompt-text", default=None)
    parser.add_argument("--gender", default=None)
    parser.add_argument("--pitch", default="moderate")
    parser.add_argument("--speed", default="moderate")
    parser.add_argument("--output", default="output.wav")
    parser.add_argument(
        "--stream", action="store_true", help="use the chunked /tts_stream endpoint"
    )
    args = parser.parse_args()

    prompt_wav = None
    if args.prompt_wav:
        from sparktts_tpu_torch.io.audio import load_audio

        prompt_wav = load_audio(args.prompt_wav, sampling_rate=16000, volume_normalize=True)

    if args.stream:
        import time

        t0 = time.perf_counter()
        chunks, sr = [], 16000
        for chunk, sr in synthesize_stream(
            args.host,
            args.port,
            args.text,
            prompt_wav=prompt_wav,
            prompt_text=args.prompt_text,
            gender=args.gender,
            pitch=args.pitch,
            speed=args.speed,
        ):
            if not chunks:
                print(f"first chunk after {(time.perf_counter() - t0) * 1000:.0f} ms")
            chunks.append(chunk)
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        stats = {"chunks": len(chunks)}
    else:
        wav, sr, stats = synthesize(
            args.host,
            args.port,
            args.text,
            prompt_wav=prompt_wav,
            prompt_text=args.prompt_text,
            gender=args.gender,
            pitch=args.pitch,
            speed=args.speed,
        )
    from sparktts_tpu_torch.io.audio import write_wav

    write_wav(args.output, wav, sr)
    print(f"saved {len(wav) / sr:.2f}s to {args.output} ({stats})")


if __name__ == "__main__":
    main()
