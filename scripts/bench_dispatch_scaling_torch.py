#!/usr/bin/env python
"""How the port's continuous engine's cost a decode step scales with the
dispatch size: `ContinuousBatchingEngine.step(n)` replays the engine's
decode units (CUDA graphs of 4 steps over its slots) n / 4 times, then
fetches the step result once, so a larger dispatch spreads the fetch and the
host's scheduling over more steps.  This sizes the DISPATCH_LADDER's
economics: a larger rung is a win only while ms a step stays flat.

The counterpart of `scripts/bench_dispatch_scaling.py` (the int8
full-width LM on random weights, 8 slots, a 2048-token cache, `--active`
live requests whose budget never ends mid-timing): its arguments, plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for), `--tiny` (the tiny config's LM, fp32) and
`--out` (under chiprun_out/).  Prints each rung's line as the JAX script
does, then one JSON object.

    python scripts/bench_dispatch_scaling_torch.py --rungs 64,128,256,512 --iters 3
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import write_result  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rungs", default="64,128,256,512")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max_slots", type=int, default=8)
    ap.add_argument("--active", type=int, default=1)
    ap.add_argument("--cache_len", type=int, default=2048)
    ap.add_argument("--tiny", action="store_true", help="the tiny config's LM, fp32")
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from sparktts_tpu_torch.config import QwenConfig, tiny_test_config
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.utils.platform import apply_platform_env, require_device
    from sparktts_tpu_torch.weights import init_qwen

    dev = require_device(args.device or apply_platform_env(), "bench_dispatch_scaling_torch")
    if args.tiny:
        cfg, dtype = tiny_test_config().llm, torch.float32
        vocab_slice = (cfg.vocab_size // 4, cfg.vocab_size // 2)
    else:
        cfg, dtype = QwenConfig(), torch.bfloat16
        vocab_slice = (151665, 151665 + 8192)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_qwen(cfg, gen, dtype, dev)
    if not args.tiny:
        params = quantize_qwen_int8(params)
    rungs = [int(r) for r in args.rungs.split(",")]

    def fresh_engine():
        eng = ContinuousBatchingEngine(
            params, cfg, max_slots=args.max_slots, cache_len=args.cache_len, prompt_pad=64,
            eos_ids=(cfg.eos_token_id,), pad_id=0, vocab_slice=vocab_slice,
            extra_ids=(cfg.eos_token_id,), max_dispatch=max(rungs), cache_dtype=dtype,
            device=dev)
        for _ in range(args.active):
            # budget = the whole cache, so the device stop never fires mid-timing
            eng.submit(list(range(10, 42)), max_new_tokens=args.cache_len - 64)
        return eng

    def step(eng, n):
        with torch.inference_mode():
            eng.step(n)

    # every rung once: its unit captures and first runs outside the timed loop
    eng = fresh_engine()
    warm = {}
    for n in rungs:
        t0 = time.perf_counter()
        step(eng, n)
        warm[n] = (time.perf_counter() - t0) * 1e3
        print(f"warm n={n}: {warm[n]:.0f} ms", flush=True)
    eng.close()

    rows = []
    for n in rungs:
        eng = fresh_engine()
        step(eng, rungs[0])  # settle
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            step(eng, n)
            times.append(time.perf_counter() - t0)
        eng.close()
        best = min(times)
        print(f"n_steps={n:4d}: best {best * 1e3:8.1f} ms  {best / n * 1e3:6.3f} ms/step  (all: "
              + ", ".join(f"{t * 1e3:.0f}" for t in times) + ")", flush=True)
        rows.append({"n_steps": n, "best_ms": best * 1e3, "ms_per_step": best / n * 1e3,
                     "all_ms": [t * 1e3 for t in times], "warm_ms": warm[n]})
    results = {"backend": dev.type, "dims": "tiny" if args.tiny else "production (0.5B, int8 LM)",
               "max_slots": args.max_slots, "active": args.active, "cache_len": args.cache_len,
               "iters": args.iters, "rungs": rows}
    if args.out:
        write_result(args.out, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
