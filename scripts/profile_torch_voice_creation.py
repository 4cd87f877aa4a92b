#!/usr/bin/env python3
"""Where the time of voice creation goes in the PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_voice_creation.py [--steps 32] [--lm bf16|int8|int4]

Builds `sparktts_tpu_torch.SparkTTSPipeline` at the full Spark-TTS-0.5B
widths with random weights (seed 0), with the LM in bf16 or quantized
weight-only to int8 or int4 (group 128) as a user would
(`pipe.llm_params = quantize_qwen_int8(pipe.llm_params)`), runs the request
of `chip_smoke.py`
once unprofiled, then traces three windows with `torch.profiler`: one
prefill, `--steps` decode steps, and the vocoder over the request's
semantic tokens.  For each window it prints the host-clock wall time, the
time the device was busy (the union of kernel, memcpy and memset intervals
in the trace), the device's idle share, the kernels launched, and the
kernels that took the most device time.  The last line is one JSON object
with all of it.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT_DIR = REPO / "chiprun_out"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_stats(trace_path: Path, wall_ms: float, top: int = 12) -> dict:
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0), e["name"], e["cat"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    )
    kernels = [s for s in spans if s[3] == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the device")
    busy_us, end = 0.0, float("-inf")
    for t0, t1, _, _ in spans:  # union of intervals
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    by_name = defaultdict(lambda: [0, 0.0])
    for t0, t1, name, _ in kernels:
        by_name[name][0] += 1
        by_name[name][1] += t1 - t0
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    busy_ms = busy_us / 1e3
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_launched": len(kernels),
        "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
        "top_kernels": [
            {"name": name[:120], "count": n, "device_ms": us / 1e3} for name, (n, us) in ranked
        ],
    }


def _profile(name: str, fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device only: less host overhead
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / f"_trace_{name}.json"
    prof.export_chrome_trace(str(path))
    try:
        return _trace_stats(path, wall_ms)
    finally:
        path.unlink()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=32, help="decode steps to trace")
    ap.add_argument("--lm", choices=("bf16", "int8", "int4"), default="bf16",
                    help="the LM's weights: bf16, or weight-only int8 or int4")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from sparktts_tpu_torch.lm.generate import decode_step, prefill
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int4, quantize_qwen_int8
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.prompt import (
        build_control_prompt,
        extract_semantic_ids,
        padded_global_tokens,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    pipe = SparkTTSPipeline(device=dev, seed=smoke.SEED)
    if args.lm == "int8":
        pipe.llm_params = quantize_qwen_int8(pipe.llm_params)
    elif args.lm == "int4":
        pipe.llm_params = quantize_qwen_int4(pipe.llm_params, group=smoke.INT4_GROUP)
    cfg, tok = pipe.config.llm, pipe.tokenizer

    # the chip_smoke request, unprofiled: warms every shape and gives the
    # semantic tokens the vocoder window decodes
    prompt = build_control_prompt(tok, smoke.TEXT, **smoke.VOICE)
    generated = pipe.generate_tokens(prompt, seed=smoke.SEED, max_new_tokens=smoke.MAX_NEW_TOKENS)
    semantic = extract_semantic_ids(tok, generated)
    glob = padded_global_tokens(tok, generated, pipe.config.bicodec.speaker_encoder.token_num)
    pipe.detokenize(glob, semantic[None, :])

    ids_t, mask_t = pipe.prompt_inputs(prompt)
    t_pad = ids_t.shape[1]
    vs, ex = pipe.guided_constraint()
    sampling = (0.8, 50, 0.95)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    cache_len = aligned_cache_len(t_pad + smoke.MAX_NEW_TOKENS)
    state = {}

    def run_prefill():
        cache = init_kv_cache(cfg, 1, cache_len, pipe.lm_dtype, dev)
        state["s"] = prefill(pipe.llm_params, cfg, ids_t, mask_t, cache, gen, *sampling,
                             vocab_slice=vs, extra_ids=ex)

    def run_decode():
        s = state["s"]
        for _ in range(args.steps):
            s = decode_step(pipe.llm_params, cfg, s, t_pad, gen, *sampling, tok.eos_ids,
                            tok.pad_id, vocab_slice=vs, extra_ids=ex)
        state["s"] = s

    result = {"card": smi, "device": torch.cuda.get_device_name(0), "lm": args.lm,
              "decode_steps": args.steps, "semantic_tokens": int(semantic.size)}
    with torch.inference_mode():
        result["prefill"] = _profile("prefill", run_prefill)
        result["decode"] = _profile("decode", run_decode)
    result["vocode"] = _profile("vocode", lambda: pipe.detokenize(glob, semantic[None, :]))
    dec = result["decode"]
    dec["wall_ms_per_step"] = dec["wall_ms"] / args.steps
    dec["device_ms_per_step"] = dec["device_busy_ms"] / args.steps
    dec["kernels_per_step"] = dec["kernels_launched"] / args.steps

    for name in ("prefill", "decode", "vocode"):
        r = result[name]
        print(f"{name}: wall {r['wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
              f"idle share {r['device_idle_share']:.4f}, {r['kernels_launched']} kernels")
        for k in r["top_kernels"][:8]:
            print(f"    {k['device_ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
