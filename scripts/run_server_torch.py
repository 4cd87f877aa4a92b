#!/usr/bin/env python
"""Start the port's TTS server (role of the reference's
runtime/triton_trtllm/run.sh stages 3-4): load a checkpoint directory,
register the voices of `--voices_dir`, warm up, and serve HTTP (and gRPC on
`--grpc_port`) through `sparktts_tpu_torch.serve.server.serve_http`.

    python scripts/run_server_torch.py --model_dir pretrained_models/Spark-TTS-0.5B \
        --port 8000 --max_batch 16 --warmup

The counterpart of `scripts/run_server.py`: the same options and defaults,
plus `--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a
card unless the CPU is asked for).  Without `--model_dir` it serves the
random-init tiny config (a smoke run).  `main(argv, control)` passes
`control` to `serve_http`, so a caller can run the server in a thread and
stop it with `control["stop"]()`.
"""
import argparse
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default=None, help="checkpoint dir (random-init if omitted)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=3000)
    parser.add_argument("--paged_kv", action="store_true",
                        help="paged KV cache for the streaming engine")
    parser.add_argument("--speculative_k", type=int, default=0,
                        help="draft-k-then-verify speculative decoding (0 = off)")
    parser.add_argument("--no_guided", action="store_true",
                        help="disable guided decoding (full-vocab sampling)")
    parser.add_argument("--warmup", action="store_true",
                        help="run the hot serving paths once before the socket opens "
                             "(first request then runs warm)")
    parser.add_argument("--grpc_port", type=int, default=None,
                        help="also serve gRPC on this port, sharing the HTTP streaming "
                             "engine (one decode batch)")
    parser.add_argument("--voice_cache", type=int, default=0,
                        help="LRU size of the speaker-prompt token cache (0 = off): repeat "
                             "requests with the same prompt voice skip the audio-tokenize "
                             "stack")
    parser.add_argument("--voices_dir", default=None,
                        help="directory of <name>.wav prompt files to pre-register as named "
                             "clone voices for the OpenAI-compatible /v1/audio/speech endpoint")
    parser.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    return parser.parse_args(argv)


def load_voices(voices_dir, sample_rate: int):
    """A VoiceRegistry holding every <name>.wav of `voices_dir`."""
    from sparktts_tpu_torch.io.audio import load_audio
    from sparktts_tpu_torch.serve.voices import VoiceRegistry

    voices = VoiceRegistry()
    for wav_path in sorted(Path(voices_dir).glob("*.wav")):
        voices.register(wav_path.stem, load_audio(wav_path, sampling_rate=sample_rate))
        logging.info("registered voice %r from %s", wav_path.stem, wav_path)
    return voices


def main(argv=None, control=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    from sparktts_tpu_torch.cli import load_pipeline
    from sparktts_tpu_torch.serve.server import serve_http

    pipe = load_pipeline(args.model_dir, args.max_new_tokens, args.device,
                         guided=not args.no_guided, speculative_k=args.speculative_k,
                         voice_cache_size=args.voice_cache)
    voices = load_voices(args.voices_dir, pipe.sample_rate) if args.voices_dir else None
    serve_http(
        pipe, host=args.host, port=args.port, max_batch=args.max_batch,
        paged_kv=args.paged_kv, warmup=args.warmup, grpc_port=args.grpc_port,
        voices=voices, control=control,
    )


if __name__ == "__main__":
    main()
