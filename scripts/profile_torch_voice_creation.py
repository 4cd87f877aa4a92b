#!/usr/bin/env python3
"""Where the time of voice creation goes in the PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_voice_creation.py [--steps 32] [--lm bf16|int8|int4]
                                                    [--units 1,2,4,8,16,32]

Builds `sparktts_tpu_torch.SparkTTSPipeline` at the full Spark-TTS-0.5B
widths with random weights (seed 0), with the LM in bf16 or quantized
weight-only to int8 or int4 (group 128) as a user would
(`pipe.llm_params = quantize_qwen_int8(pipe.llm_params)`), runs the request
of `chip_smoke.py`
once unprofiled, then traces four windows with `torch.profiler`: one
prefill, `--steps` decode steps as `generate` runs them (replays of its
captured decode unit of 8 steps, `lm/graphs.py`), the same steps as the
eager loop of `decode_step`s, and the vocoder over the request's semantic
tokens.  For each window it prints the host-clock wall time, the time the
device was busy (the union of kernel, memcpy and memset intervals in the
trace), the device's idle share, the kernels run, the host's launch calls
(kernel and graph launches, copies and sets, from the trace's CUDA runtime
events), and the kernels that took the most device time.  Before the
traces, for each unit size in `--units`, it captures that decode unit and
times 64 steps of its replays (host clock, synchronized, untraced: the
profiler's per-kernel records slow a traced graph window): capture ms,
graph-pool MiB, wall ms a step and the host time of one replay call.  The
last line is one JSON object with all of it.  Needs a CUDA card; exits 2
without one.
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
HOST_LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")


def _trace_stats(trace_path: Path, wall_ms: float, top: int = 12) -> dict:
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0), e["name"], e["cat"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    )
    host = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and any(w in e.get("name", "") for w in HOST_LAUNCH_CALLS)]
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
        # None where the trace holds no CUDA runtime events
        "host_launch_calls": len(host) if any(e.get("cat") == "cuda_runtime" for e in events)
        else None,
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
    ap.add_argument("--units", default="1,2,4,8,16,32",
                    help="decode unit sizes to capture and time (comma-separated; '' for none)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from sparktts_tpu_torch.lm.generate import DONE_CHECK_EVERY, decode_step, decode_unit, prefill
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

    def unit_of(steps):
        return decode_unit(pipe.llm_params, cfg, 1, cache_len, pipe.lm_dtype, dev, t_pad, steps,
                           sampling[1], False, vs, ex, tuple(tok.eos_ids), tok.pad_id)

    def run_prefill(cache=None):
        cache = init_kv_cache(cfg, 1, cache_len, pipe.lm_dtype, dev) if cache is None else cache
        state["s"] = prefill(pipe.llm_params, cfg, ids_t, mask_t, cache, gen, *sampling,
                             vocab_slice=vs, extra_ids=ex)

    def run_decode_eager():
        s = state["s"]
        temperature, top_p = (torch.full((), v, dtype=torch.float32, device=dev)
                              for v in (sampling[0], sampling[2]))
        for _ in range(args.steps):
            s = decode_step(pipe.llm_params, cfg, s, t_pad, gen, temperature, sampling[1], top_p,
                            tok.eos_ids, tok.pad_id, vocab_slice=vs, extra_ids=ex)
        state["s"] = s

    def replay_steps(unit, n):
        """n decode steps from state["s"] as `generate` runs them: unit
        replays, the done flag read after each."""
        with unit.bound(state["s"], gen):
            unit.inputs["temperature"].fill_(sampling[0])
            unit.inputs["top_p"].fill_(sampling[2])
            for _ in range(n // unit.steps):
                unit.replay().clone()
                bool(unit.state.done.all())

    # the unit sizes first, untraced
    units = []
    for steps in (int(u) for u in args.units.split(",") if u):
        with torch.inference_mode():
            u = unit_of(steps)
            run_prefill(u.state.cache)
            replay_steps(u, 64)  # first replays
            run_prefill(u.state.cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replay_steps(u, 64)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            u.graph.replay()  # the host's part of one replay: the graph launch call
            launch_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        item = dict(steps=steps, capture_ms=u.capture_ms, pool_mib=u.pool_bytes / 2**20,
                    wall_ms_per_step=wall / 64, replay_launch_ms=launch_ms)
        print("decode unit:", json.dumps(item))
        units.append(item)

    result = {"card": smi, "device": torch.cuda.get_device_name(0), "lm": args.lm,
              "decode_steps": args.steps, "semantic_tokens": int(semantic.size), "units": units}
    with torch.inference_mode():
        unit = unit_of(DONE_CHECK_EVERY)  # captured by the request above
        result["prefill"] = _profile("prefill", run_prefill)
        run_prefill(unit.state.cache)
        result["decode"] = _profile("decode_graph", lambda: replay_steps(unit, args.steps))
        run_prefill()
        result["decode_eager"] = _profile("decode_eager", run_decode_eager)
    result["vocode"] = _profile("vocode", lambda: pipe.detokenize(glob, semantic[None, :]))
    for name in ("decode", "decode_eager"):
        dec = result[name]
        dec["wall_ms_per_step"] = dec["wall_ms"] / args.steps
        dec["device_ms_per_step"] = dec["device_busy_ms"] / args.steps
        dec["kernels_per_step"] = dec["kernels_launched"] / args.steps
        if dec["host_launch_calls"] is not None:
            dec["host_launches_per_step"] = dec["host_launch_calls"] / args.steps

    for name in ("prefill", "decode", "decode_eager", "vocode"):
        r = result[name]
        print(f"{name}: wall {r['wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
              f"idle share {r['device_idle_share']:.4f}, {r['kernels_launched']} kernels, "
              f"{r['host_launch_calls']} host launch calls")
        for k in r["top_kernels"][:8]:
            print(f"    {k['device_ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
