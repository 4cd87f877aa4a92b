#!/usr/bin/env python3
"""Time the codec's two calls of one checkout on the card: a vocode and an
audio tokenize at the full Spark-TTS-0.5B widths (random weights, seed 0).

    python3 scripts/time_torch_codec.py [--tree DIR] [--tokens 500] [--seconds 6]
    python3 scripts/time_torch_codec.py --tiny --device cpu

* vocode: `SparkTTSPipeline.detokenize` of `--tokens` random semantic ids
  and 32 random global ids (seed 0);
* tokenize: the device half of audio tokenization (`codec_tokenize`:
  wav2vec2 features, then the BiCodec encoder, quantizer and speaker
  encoder) on a `--seconds` voice-like signal (the one `chip_smoke.py`
  writes as its prompt wav), host-prepared once, so the voice cache is not
  in the way.

Each is host clock around a call that ends in `torch.cuda.synchronize()`,
after one warm-up, the median of `--runs`.  `--trace` adds one profiled
call of each (torch.profiler): its device kernels' summed time (`busy_ms`)
beside their span from the first kernel's start to the last one's end, so
a wall set by the host's launches shows as a span well above busy.  `--tree DIR` imports the port
from another checkout (an older commit, unpacked), so two commits are
compared in one call, each in a process of its own: run parent, change,
change, parent.  Prints the card's `nvidia-smi` line, one line a call, and
as the last line one JSON object (`--out` also writes it, under
chiprun_out/).  Needs a card unless `--device cpu` is asked for.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import card_line, write_result  # noqa: E402


def prompt_signal(seconds: float, sr: int = 16000, seed: int = 0):
    """chip_smoke.make_prompt_wav's signal: four harmonics of a 140 Hz
    fundamental with slow vibrato under a syllable-rate envelope, plus low
    noise (16-bit PCM rounding left out)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(140.0 * (1 + 0.05 * np.sin(2 * np.pi * 0.5 * t))) / sr
    voice = sum(a * np.sin(k * phase) for k, a in enumerate((0.5, 0.25, 0.12, 0.06), start=1))
    envelope = 0.2 + 0.8 * np.sin(np.pi * 3.0 * t) ** 2
    return 0.4 * envelope * voice + 0.003 * rng.standard_normal(t.size)


def device_busy(fn, sync, cuda: bool):
    """(summed device-kernel ms, kernels, ms from the first kernel's start to
    the last one's end) of one profiled call of `fn`."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        sync()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kernels:
        return 0.0, 0, 0.0
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    return sum(e["dur"] for e in kernels) / 1e3, len(kernels), span / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None, help="time the port of the checkout in DIR")
    ap.add_argument("--tokens", type=int, default=500)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny test config (CPU rehearsal)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", action="store_true", help="one profiled call: device busy ms")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    tree = REPO if args.tree is None else args.tree.resolve()
    sys.path.insert(0, str(tree))
    from sparktts_tpu_torch.config import tiny_test_config
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline, codec_tokenize

    dev = torch.device(args.device)
    smi = card_line(dev)
    print(smi, flush=True)
    kw = dict(config=tiny_test_config(), lm_dtype=torch.float32) if args.tiny else {}
    pipe = SparkTTSPipeline(device=dev, seed=0, **kw)
    cfg = pipe.config
    rng = np.random.default_rng(0)
    glob = rng.integers(0, 8 if args.tiny else 4096, (1, cfg.bicodec.speaker_encoder.token_num))
    sem = rng.integers(0, cfg.bicodec.quantizer.codebook_size, (1, args.tokens))
    _, tok_args, _, _ = pipe.tokenize_host_prep(prompt_signal(args.seconds))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.inference_mode()
    def tokenize():
        return codec_tokenize(*tok_args[:2], cfg, *tok_args[2:])

    def vocode():
        return pipe.detokenize(glob, sem)

    result = {"card": smi, "device": str(dev), "tree": str(tree), "tokens": args.tokens,
              "seconds": args.seconds}
    for name, fn in (("vocode", vocode), ("tokenize", tokenize)):
        fn()
        times = []
        for _ in range(args.runs):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        result[f"{name}_ms"] = statistics.median(times)
        result[f"{name}_ms_all"] = times
        print(f"{name}: median {result[f'{name}_ms']} ms of {times} | {smi}", flush=True)
        if args.trace:
            result[f"{name}_busy_ms"], result[f"{name}_kernels"], result[f"{name}_span_ms"] = (
                device_busy(fn, sync, dev.type == "cuda"))
            print(f"{name}: {result[f'{name}_kernels']} device kernels, busy "
                  f"{result[f'{name}_busy_ms']} ms over a span of {result[f'{name}_span_ms']} ms",
                  flush=True)
    wav = vocode()
    if not (np.isfinite(wav).all() and wav.size == args.tokens * pipe._wave_upsample):
        raise AssertionError(f"vocode: {wav.shape} samples, finite {np.isfinite(wav).all()}")
    if args.out:
        write_result(args.out, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
