#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: single-stream offline synthesis RTF
on one CUDA card.

    python3 bench_torch.py [--runs N]

The port's counterpart of `bench.py` (the JAX package's TPU headline), on
the same workload: RTF = wall-clock synthesis time / synthesized audio
duration, at the full Spark-TTS-0.5B widths with random weights, with a
fixed token budget so that random weights cannot stop early at EOS:

  * the LM (Qwen2.5-0.5B) from `init_qwen` with seed 0 in bf16, quantized
    to weight-only int8 (`quantize_qwen_int8`); the BiCodec from seed 1;
  * 128 random prompt ids (numpy seed 0, ids in [100, 5000));
  * 500 new tokens (10 s of audio at 50 tokens a second) with no EOS,
    sampled (T 0.8, top-k 50, top-p 0.95) under guided decoding over the
    8192 semantic ids plus EOS (the real checkpoint's layout: semantic base
    151665, EOS 151645);
  * then `bicodec_detokenize` of the 500 ids, and one fetch of the tokens
    and the audio to the host.

The codec runs in fp32, as the port's `bicodec_detokenize` pins it
(`nn/layers.full_fp32`), not in bf16 as `bench.py` casts it: the port has
no bf16 codec path.  The decode replays the port's captured decode units
(`lm/graphs.py`), so the first run captures its unit; two warm runs come
first, and the result is the median of `--runs` timed runs.

Earlier lines print the card's `nvidia-smi` name and power limit, the stage
split (LM ms and tokens/s, vocode ms), the full-vocabulary LM ms (the
reference samples the whole vocabulary) and the dispatch probe
(`bench/relay_probe.py`).  The last line is one JSON object with
`bench.py`'s keys: {"metric": "offline_rtf_single_stream", "value", "unit":
"rtf", "vs_baseline", "dispatch_tax_ms"}; `vs_baseline` is BASELINE_RTF /
value, against the reference's NVIDIA L20 number (BASELINE.md).  Without a
CUDA card, or on any error, it exits non-zero and prints no result.  It
writes no file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BASELINE_RTF = 0.1362  # reference README.md:212, single L20, offline concurrency 1
PROMPT_LEN = 128
NEW_TOKENS = 500  # 500 semantic tokens at 50 Hz: 10 s of audio
FRAME_RATE = 50
SEM_BASE, N_SEM, EOS = 151665, 8192, 151645
KERNELS = ("flash_attention", "decode_attention", "vocoder_fusion", "int8_mlp")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=7, help="timed runs after two warm ones")
    args = parser.parse_args()

    repo = Path(__file__).resolve().parent
    if not (repo / "sparktts_tpu_torch").is_dir():
        print("bench_torch.py: the sparktts_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch.py: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from sparktts_tpu_torch.bench.relay_probe import measure_dispatch_tax
    from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize
    from sparktts_tpu_torch.config import SparkTTSConfig
    from sparktts_tpu_torch.kernels import build
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.weights import init_bicodec, init_qwen

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    cfg = SparkTTSConfig()
    with torch.inference_mode():
        llm = quantize_qwen_int8(init_qwen(cfg.llm, torch.Generator(device=dev).manual_seed(0),
                                           torch.bfloat16, dev))
        bc = init_bicodec(cfg.bicodec, torch.Generator(device=dev).manual_seed(1), dev)
    ids = torch.from_numpy(
        np.random.default_rng(0).integers(100, 5000, size=(1, PROMPT_LEN))).to(dev)
    mask = torch.ones((1, PROMPT_LEN), dtype=torch.bool, device=dev)
    global_t = torch.zeros((1, cfg.bicodec.speaker_encoder.token_num), dtype=torch.long,
                           device=dev)
    units = graphs.UnitCache("bench_torch")
    audio_seconds = NEW_TOKENS / FRAME_RATE

    def run_llm(seed, guided=True):
        tokens, lengths = generate(
            llm, cfg.llm, ids, mask, torch.Generator(device=dev).manual_seed(seed),
            max_new_tokens=NEW_TOKENS, cache_len=PROMPT_LEN + NEW_TOKENS,
            temperature=0.8, top_k=50, top_p=0.95, eos_ids=(), pad_id=0,
            vocab_slice=(SEM_BASE, SEM_BASE + N_SEM) if guided else None,
            extra_ids=(EOS,) if guided else (), units=units,
        )
        if int(lengths[0]) != NEW_TOKENS:
            raise AssertionError(f"{int(lengths[0])} tokens, want {NEW_TOKENS}")
        return tokens

    @torch.inference_mode()
    def run_chained(seed):
        """generate, semantic ids on the card, vocode, ONE fetch of both."""
        tokens = run_llm(seed)
        sem = torch.clamp(tokens - SEM_BASE, 0, N_SEM - 1)
        wav = bicodec_detokenize(bc, cfg.bicodec, sem, global_t)
        flat = torch.cat([tokens.reshape(-1).to(torch.int32),
                          wav.reshape(-1).float().view(torch.int32)]).cpu()
        out = flat.numpy()
        wav_np = out[NEW_TOKENS:].view(np.float32)
        if wav_np.size != NEW_TOKENS * 320 or not np.isfinite(wav_np).all():
            raise AssertionError(f"waveform of {wav_np.size} samples, finite "
                                 f"{np.isfinite(wav_np).all()}")
        return out[:NEW_TOKENS], wav_np

    def timed(fn, *a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(*a, **kw)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    warm = [timed(run_chained, seed) for seed in (0, 100)]  # the first captures the unit
    print(f"warm runs (the first captures the decode unit): "
          f"{[round(t * 1e3, 3) for t in warm]} ms")
    probe = measure_dispatch_tax()
    print(f"dispatch probe: {json.dumps(probe)}")
    times = [timed(run_chained, i + 1) for i in range(args.runs)]
    t_chained = statistics.median(times)
    print(f"chained LM + vocode, one fetch: median {t_chained * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in times]}")

    semantic = torch.zeros((1, NEW_TOKENS), dtype=torch.long, device=dev)

    @torch.inference_mode()
    def run_vocoder():
        bicodec_detokenize(bc, cfg.bicodec, semantic, global_t).cpu()

    llm_times = [timed(lambda s: run_llm(s).cpu(), i + 1) for i in range(args.runs)]
    voc_times = [timed(run_vocoder) for _ in range(args.runs)]
    t_llm, t_voc = statistics.median(llm_times), statistics.median(voc_times)
    print(f"stage split: LM {t_llm * 1e3:.3f} ms ({NEW_TOKENS / t_llm:.1f} tokens/s), "
          f"vocode {t_voc * 1e3:.3f} ms, audio {audio_seconds:.1f} s")
    timed(lambda: run_llm(0, guided=False).cpu())  # the full-vocab unit's capture
    t_full = statistics.median([timed(lambda s: run_llm(s, guided=False).cpu(), 50 + i)
                                for i in range(3)])
    print(f"full-vocab LM {t_full * 1e3:.3f} ms ({NEW_TOKENS / t_full:.1f} tokens/s)")

    rtf = t_chained / audio_seconds
    print(json.dumps({
        "metric": "offline_rtf_single_stream",
        "value": rtf,
        "unit": "rtf",
        "vs_baseline": BASELINE_RTF / rtf,
        "dispatch_tax_ms": probe["roundtrip_ms"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
