#!/usr/bin/env python
"""Benchmark runner of the PyTorch/CUDA port (role of the reference's run.sh
stage 5 + client_grpc.py): offline and streaming RTF and latency over a
jsonl manifest or synthetic tasks.  The counterpart of
`scripts/benchmark.py`, over `sparktts_tpu_torch.bench.harness`.

    python scripts/benchmark_torch.py --model_dir ... --manifest data.jsonl \
        --mode offline --concurrency 2

Without `--model_dir` it benchmarks the full Spark-TTS-0.5B architecture on
random weights (seed 0), or the tiny config with `--tiny` (a smoke run, as
`scripts/deploy_torch.sh` runs it without a checkpoint); `--ignore_eos`
fixes the token budget, since random weights sample EOS at chance level.
It runs on the card unless `--device cpu` is given, and raises without one.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--manifest", default=None, help="jsonl with target_text/reference_wav_path")
    parser.add_argument("--mode", choices=["offline", "streaming"], default="offline")
    parser.add_argument("--concurrency", type=int, default=1)
    parser.add_argument("--num_synthetic", type=int, default=4)
    parser.add_argument("--max_new_tokens", type=int, default=3000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the random-init tiny config (without --model_dir)")
    parser.add_argument("--output", default=None, help="write stats JSON here")
    parser.add_argument(
        "--ignore_eos", action="store_true",
        help="fixed token budget (random weights sample EOS at chance level, "
        "making RTF meaningless otherwise)",
    )
    args = parser.parse_args()

    import numpy as np

    from sparktts_tpu_torch.bench.harness import (
        BenchTask,
        load_manifest,
        run_offline_benchmark,
        run_streaming_benchmark,
    )
    from sparktts_tpu_torch.config import SparkTTSConfig, tiny_test_config
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    pipe = SparkTTSPipeline(
        model_dir=args.model_dir,
        config=None if args.model_dir else tiny_test_config() if args.tiny else SparkTTSConfig(),
        device=args.device,
        max_new_tokens=args.max_new_tokens,
    )
    if args.ignore_eos:
        pipe.tokenizer.eos_ids = ()
    pipe.vocode_bucket = args.max_new_tokens  # one vocode shape per budget

    if args.manifest:
        tasks = load_manifest(args.manifest)
    else:
        sr = 16000
        t = np.arange(2 * sr) / sr
        wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        tasks = [BenchTask(text=f"synthetic utterance {i}", prompt_wav=wav)
                 for i in range(args.num_synthetic)]

    if args.mode == "offline":
        stats = run_offline_benchmark(pipe, tasks, concurrency=args.concurrency)
    else:
        stats = run_streaming_benchmark(pipe, tasks)

    line = json.dumps(stats, indent=2)
    print(line)
    if args.output:
        Path(args.output).write_text(line)


if __name__ == "__main__":
    main()
