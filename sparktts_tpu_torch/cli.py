"""Command-line inference (parity with reference `cli/inference.py:28-116`).

Port of `sparktts_tpu/cli.py`: the same arguments, plus `--device` (default
$SPARKTTS_PLATFORM, else "cuda"; it raises without a card unless the CPU is
asked for).

Usage:
    python -m sparktts_tpu_torch.cli --text "..." --prompt_speech_path p.wav \
        --model_dir pretrained_models/Spark-TTS-0.5B --save_dir example/results

Without `--model_dir` it runs the random-init tiny config (a smoke run).
"""

from __future__ import annotations

import argparse
import logging
import os
from datetime import datetime


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run TTS inference (PyTorch/CUDA).")
    parser.add_argument(
        "--model_dir",
        type=str,
        default=None,
        help="Checkpoint dir (config.yaml + BiCodec/ + LLM/ + wav2vec2). "
        "Omit for a random-init smoke run.",
    )
    parser.add_argument("--save_dir", type=str, default="example/results")
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--prompt_text", type=str, default=None)
    parser.add_argument("--prompt_speech_path", type=str, default=None)
    parser.add_argument("--gender", choices=["male", "female"], default=None)
    parser.add_argument(
        "--pitch", choices=["very_low", "low", "moderate", "high", "very_high"], default=None
    )
    parser.add_argument(
        "--speed", choices=["very_low", "low", "moderate", "high", "very_high"], default=None
    )
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top_k", type=int, default=50)
    parser.add_argument("--top_p", type=float, default=0.95)
    parser.add_argument("--max_new_tokens", type=int, default=3000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stream", action="store_true", help="use the streaming synthesizer")
    parser.add_argument(
        "--longform", action="store_true",
        help="sentence-segmented synthesis with one stable voice for texts "
             "longer than the generation budget",
    )
    parser.add_argument(
        "--max_segment_chars", type=int, default=400,
        help="longform segment size (characters, sentence-aligned)",
    )
    parser.add_argument(
        "--device", choices=["cpu", "cuda"], default=None,
        help="torch device (default: $SPARKTTS_PLATFORM, else cuda)",
    )
    return parser.parse_args(argv)


def load_pipeline(model_dir=None, max_new_tokens: int = 3000, device=None):
    """The checkpoint's pipeline, or the random-init tiny config's without
    `model_dir`, on `device` (default: `apply_platform_env()`)."""
    from sparktts_tpu_torch.config import tiny_test_config
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.utils.platform import apply_platform_env

    device = device or apply_platform_env()
    if model_dir is None:
        return SparkTTSPipeline(config=tiny_test_config(), max_new_tokens=max_new_tokens,
                                device=device)
    return SparkTTSPipeline(model_dir=model_dir, max_new_tokens=max_new_tokens, device=device)


def run_tts(args) -> str:
    import numpy as np

    from sparktts_tpu_torch.io.audio import write_wav

    logging.info("initializing model...")
    model = load_pipeline(args.model_dir, args.max_new_tokens, args.device)

    os.makedirs(args.save_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d%H%M%S")
    save_path = os.path.join(args.save_dir, f"{timestamp}.wav")

    logging.info("starting inference...")
    kwargs = dict(
        prompt_speech_path=args.prompt_speech_path,
        prompt_text=args.prompt_text,
        gender=args.gender,
        pitch=args.pitch,
        speed=args.speed,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        seed=args.seed,
    )
    if args.longform:
        wav = model.inference_long(
            args.text, max_segment_chars=args.max_segment_chars, **kwargs
        )
    elif args.stream:
        from sparktts_tpu_torch.serve.streaming import StreamingSynthesizer

        syn = StreamingSynthesizer(model)
        chunks = list(syn.stream(args.text, **kwargs))
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    else:
        wav = model.inference(args.text, **kwargs)

    write_wav(save_path, wav, model.sample_rate)
    logging.info(f"audio saved at: {save_path}")
    return save_path


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )
    run_tts(parse_args(argv))


if __name__ == "__main__":
    main()
