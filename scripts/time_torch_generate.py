#!/usr/bin/env python3
"""Time the port's LM generate at B = 1 and, where the tree has it, at B = 4.

    python3 scripts/time_torch_generate.py [--tree DIR] [--reps N]

Full Spark-TTS-0.5B widths, random weights (seed 0), 500 new tokens a row,
bf16, on one CUDA card:

* B = 1: `SparkTTSPipeline.generate_tokens` of the voice-creation prompt
  (44 tokens, bucket 64) and of a clone prompt with its transcript (32
  global and 299 semantic ids, random: 419 tokens, bucket 448), each after
  one warm-up call (which captures its decode unit); ms a generated token
  and tokens/s, host clock around a synchronised call, median of N;
* B = 4: `generate_tokens_batch` of four clone prompts of the lengths of
  chip_smoke's batch phase (419, 64, 419 and 213 tokens, random codec ids;
  rows 0 and 2 one prompt; per-row seeds [7, 9, 7, 5]) in the same way,
  aggregate tokens/s, when the tree's pipeline has it.

`--tree DIR` imports the port and chip_smoke.py from another checkout (an
older commit, unpacked), so two commits are compared in one call, each in a
process of its own: run parent, change, change, parent.  The last line is
one JSON object with all of it.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MAX_NEW = 500
SEEDS = [7, 9, 7, 5]
SEMANTIC_IDS = (299, 199, 299, 149)  # 6, 4, 6 and 3 s of prompt wav


def _median_s(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--tree", type=Path, default=REPO, help="checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_torch_generate.py: no CUDA card", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke
    from sparktts_tpu_torch.kernels import build
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.prompt import build_clone_prompt, build_control_prompt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    build.build_all(["flash_attention", "decode_attention", "vocoder_fusion"])
    pipe = SparkTTSPipeline(device="cuda", seed=0)
    tok = pipe.tokenizer
    creation = build_control_prompt(tok, chip_smoke.TEXT, **chip_smoke.VOICE)
    rng = torch.Generator().manual_seed(1)

    def clone_prompt(text, n_semantic, prompt_text):
        """A clone prompt of random codec ids (32 global, n_semantic)."""
        glob = torch.randint(0, tok.n_global, (32,), generator=rng).numpy()
        sem = torch.randint(0, tok.n_semantic, (n_semantic,), generator=rng).numpy()
        return build_clone_prompt(tok, text, glob, sem, prompt_text)

    clone = clone_prompt(chip_smoke.TEXT, SEMANTIC_IDS[0], chip_smoke.PROMPT_TEXT)
    result = {"card": smi, "device": torch.cuda.get_device_name(0), "tree": str(tree),
              "max_new_tokens": MAX_NEW}
    for name, prompt, mode in (("creation", creation, "control"), ("clone", clone, "clone")):
        s = _median_s(lambda: pipe.generate_tokens(prompt, seed=0, max_new_tokens=MAX_NEW,
                                                   mode=mode), args.reps)
        n = len(pipe.generate_tokens(prompt, seed=0, max_new_tokens=MAX_NEW, mode=mode))
        result[f"b1_{name}"] = dict(prompt_tokens=len(prompt), s=s, tokens=n,
                                    ms_per_token=s * 1e3 / n, tokens_per_s=n / s)
        print(name, json.dumps(result[f"b1_{name}"]))
    if hasattr(pipe, "generate_tokens_batch"):
        prompts = [clone_prompt(text, n, pt) for text, n, pt in
                   zip(chip_smoke.BATCH_TEXTS, SEMANTIC_IDS, chip_smoke.BATCH_PROMPT_TEXTS)]
        prompts[2] = prompts[0]
        s = _median_s(lambda: pipe.generate_tokens_batch(prompts, seed=SEEDS,
                                                         max_new_tokens=MAX_NEW), args.reps)
        n = sum(len(x) for x in pipe.generate_tokens_batch(prompts, seed=SEEDS,
                                                           max_new_tokens=MAX_NEW))
        result["b4_clone"] = dict(prompt_tokens=[len(p) for p in prompts], s=s, tokens=n,
                                  tokens_per_s=n / s,
                                  over_b1=n / s / result["b1_clone"]["tokens_per_s"])
        print("batch", json.dumps(result["b4_clone"]))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
