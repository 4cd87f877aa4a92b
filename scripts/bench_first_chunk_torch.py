#!/usr/bin/env python
"""First-chunk latency A/B of the PyTorch/CUDA port: the fused admission
(tokenize, prompt assembly and prefill in one device chain) against the
chained three-step admission, and the voice cache (every task sharing one
prompt wav per duration bucket: assembled admissions, no tokenize), through
the continuous server (role of the reference's streaming first-chunk
measurement, reference `runtime/triton_trtllm/client_grpc.py:332-433`).

The counterpart of `scripts/bench_first_chunk.py`: its arguments, plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for) and `--out` (under chiprun_out/).  Each mode is
warmed with the full task list at concurrency 2 and at the timed
concurrency; the whole mode loop runs twice, the first pass (cold_pass)
absorbing every cross-mode first run, the second reported.

    python scripts/bench_first_chunk_torch.py --tasks 8
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import write_result  # noqa: E402

MODES = ("fused", "chained", "voice_cache")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=1)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--max_new_tokens", type=int, default=500)
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from sparktts_tpu_torch.bench.harness import (
        BenchTask,
        make_tasks,
        run_continuous_benchmark,
        script_pipeline,
    )
    from sparktts_tpu_torch.bench.relay_probe import probe_record

    if args.tiny:
        pipe = script_pipeline(True, args.device, 32)
        tasks = make_tasks(args.tasks, (16, 24, 32), (1,))
    else:
        pipe = script_pipeline(False, args.device, args.max_new_tokens)
        tasks = make_tasks(args.tasks, (args.max_new_tokens,), (3, 6))
    pipe.vocode_bucket = 125
    dev = pipe.device

    # voice-cache mode: one voice, many texts -- every task shares one
    # prompt wav per duration bucket, so steady state is all cache hits
    shared = {t.prompt_wav.shape: t.prompt_wav for t in tasks}
    vc_tasks = [BenchTask(text=t.text, prompt_wav=shared[t.prompt_wav.shape],
                          max_new_tokens=t.max_new_tokens) for t in tasks]

    def run_mode(key: str):
        fused = key != "chained"
        pipe.voice_cache_size = 8 if key == "voice_cache" else 0
        if key != "voice_cache":
            pipe._voice_cache.clear()
        mode_tasks = vc_tasks if key == "voice_cache" else tasks
        # warm with the full task list (every shape the mode needs; it also
        # fills the voice cache) at the warm and the timed concurrency
        for conc in (2, args.concurrency):
            run_continuous_benchmark(pipe, mode_tasks, concurrency=conc, streaming=True,
                                     fused_admission=fused)
        pipe.voice_cache_stats.update(hits=0, misses=0)
        stats = run_continuous_benchmark(pipe, mode_tasks, concurrency=args.concurrency,
                                         streaming=True, fused_admission=fused)
        out = {k: v for k, v in stats.items()
               if "first_chunk" in k or k in ("rtf", "p50_latency_ms", "per_task", "stage_stats")}
        out["server_stats"] = stats["server_stats"]
        if key == "voice_cache":
            out["voice_cache_stats"] = dict(pipe.voice_cache_stats)
        return out

    cold = {key: run_mode(key) for key in MODES}
    results = {"dispatch_tax_session_start": probe_record("post-cold-pass", device=dev)}
    for key in MODES:
        results[key] = run_mode(key)
        results[key]["dispatch_tax"] = probe_record(device=dev)
        # the cold pass's headline numbers, for attribution only
        results[key]["cold_pass"] = {k: cold[key][k] for k in ("rtf", "first_chunk_p90_ms")
                                     if k in cold[key]}
        print(json.dumps({key: {k: v for k, v in results[key].items() if k != "stage_stats"}}),
              file=sys.stderr)
    if args.out:
        write_result(args.out, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
