#!/usr/bin/env python
"""Dense against paged-KV serving, an A/B of the PyTorch/CUDA port: the same
tasks through the same continuous server, over the dense engine (kernel 2)
and over the paged engine (kernel 6, half the dense worst case of pages),
offline and streamed, at each concurrency (reference paged-KV role:
runtime/triton_trtllm/run.sh:65).

The counterpart of `scripts/bench_paged_ab.py`: its arguments, plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for); `--out` is written under chiprun_out/.  Each
arm is warmed at every timed concurrency first.  After the timed rows,
`agreement` serves the tasks greedily once through each engine and compares
every request's ids: equal on the CPU; on the card the two attention kernels
sum in another order, and a request's ids may part at a near tie of its
logits.  At each request's first differing step `agreement` gives the top
two guided logits of one plain forward over the prompt and the common
prefix, and whether they lie within LOGITS_REL_TOL of the largest logit
(chip_smoke's near-tie rule, which its phase 26 holds the servers to).

    python scripts/bench_paged_ab_torch.py --tasks 8 --out PAGED_AB_torch.json
"""
import argparse
import asyncio
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import write_result  # noqa: E402

LOGITS_REL_TOL = 5e-2  # chip_smoke's near-tie rule: top-2 gap within 5% of max |logit|


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--concurrency", default="1,4")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--max_new_tokens", type=int, default=500)
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    return ap.parse_args(argv)


def greedy_ids(pipe, tasks, paged: bool) -> list:
    """Each task's ids through a greedy ContinuousTTSServer over the dense
    or the paged engine, the tasks submitted together (in task order)."""
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    async def run():
        server = ContinuousTTSServer(pipe, greedy=True, paged=paged, fused_warm="sync")
        ids, finish = {}, server._finish

        def record(req_id, tokens):  # the request's ids as the server commits them
            ids[server.inflight[req_id].text] = [int(t) for t in tokens]
            return finish(req_id, tokens)

        server._finish = record
        await server.start()
        try:
            await asyncio.gather(*(server.synthesize(t.text, prompt_wav=t.prompt_wav,
                                                     prompt_text=t.prompt_text,
                                                     max_new_tokens=t.max_new_tokens)
                                   for t in tasks))
        finally:
            await server.stop()
        return [ids[t.text] for t in tasks]

    return asyncio.new_event_loop().run_until_complete(run())


def near_tie(pipe, task, ids, step) -> dict:
    """The witness at a request's first differing `step`: one plain forward
    (`qwen_forward`, the dense path) over the request's clone prompt and
    ids[:step], its top two guided logits at the last position and their
    token ids, their gap over the largest |logit|, and whether that is a
    near tie."""
    import torch

    from sparktts_tpu_torch.lm.qwen import init_kv_cache, qwen_forward
    from sparktts_tpu_torch.prompt import build_clone_prompt

    g, s = pipe.tokenize_audio(task.prompt_wav)
    prompt = build_clone_prompt(pipe.tokenizer, task.text, g,
                                s if task.prompt_text is not None else None, task.prompt_text)
    vocab_slice, extra_ids = pipe.guided_constraint("clone")
    seq = torch.tensor([list(prompt) + [int(t) for t in ids[:step]]], device=pipe.device)
    t = seq.shape[1]
    with torch.inference_mode():
        idx = torch.arange(t, device=pipe.device)
        bias = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9).float()[None]
        cache = init_kv_cache(pipe.config.llm, 1, t, pipe.lm_dtype, pipe.device)
        logits, _ = qwen_forward(pipe.llm_params, pipe.config.llm, seq, idx[None], cache, 0,
                                 bias, vocab_slice=vocab_slice, extra_ids=extra_ids,
                                 logits_last_only=True)
    last = logits[0, -1].float()
    top = last.topk(2)
    lo, hi = vocab_slice
    top_ids = [lo + c if c < hi - lo else extra_ids[c - (hi - lo)] for c in top.indices.tolist()]
    rel_gap = float(top.values[0] - top.values[1]) / float(last.abs().max())
    return {"step": step, "top2": top.values.tolist(), "top2_ids": top_ids, "rel_gap": rel_gap,
            "near_tie": rel_gap <= LOGITS_REL_TOL}


def main(argv=None):
    args = parse_args(argv)
    from sparktts_tpu_torch.bench.harness import (
        make_tasks,
        run_continuous_benchmark,
        script_pipeline,
    )
    from sparktts_tpu_torch.bench.relay_probe import probe_record

    if args.tiny:
        pipe = script_pipeline(True, args.device, 32)
        tasks = make_tasks(args.tasks, (16, 24, 32), (1,))
        pipe.vocode_bucket = 32
    else:
        pipe = script_pipeline(False, args.device, args.max_new_tokens)
        tasks = make_tasks(args.tasks, (args.max_new_tokens,), (3, 6))
        pipe.vocode_bucket = args.max_new_tokens
    dev = pipe.device

    concs = [int(c) for c in args.concurrency.split(",") if c]
    results = {
        "bench": "paged_vs_dense_serving",
        "dims": "tiny" if args.tiny else "production (0.5B, int8 LM)",
        "backend": dev.type,
        "tasks": len(tasks),
        "runs": [],
    }
    results["dispatch_tax_session_start"] = probe_record("session start", device=dev)
    for engine in ("dense", "paged"):
        paged = engine == "paged"
        for streaming in (False, True):
            # a warm pass at every timed concurrency: batch compositions first
            # formed at one would otherwise run first in its timed row
            for conc in sorted(set([2] + concs)):
                run_continuous_benchmark(pipe, tasks, concurrency=conc, streaming=streaming,
                                         paged=paged)
            for conc in concs:
                s = run_continuous_benchmark(pipe, tasks, concurrency=conc, streaming=streaming,
                                             paged=paged)
                row = {
                    "engine": engine,
                    "streaming": streaming,
                    "concurrency": conc,
                    "rtf": s["rtf"],
                    "avg_latency_ms": s["avg_latency_ms"],
                    "p90_latency_ms": s["p90_latency_ms"],
                    "deferrals": s["server_stats"].get("deferrals", 0),
                    "dispatch_tax": probe_record(device=dev),
                }
                for k in ("first_chunk_p50_ms", "first_chunk_p90_ms"):
                    if k in s:
                        row[k] = s[k]
                print(json.dumps(row), file=sys.stderr)
                results["runs"].append(row)
    dense, paged = greedy_ids(pipe, tasks, False), greedy_ids(pipe, tasks, True)
    # kernels 2 and 6 sum in another order, so on the card a request's ids
    # may part at a near tie: each request's first differing step
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       None if len(a) == len(b) else min(len(a), len(b)))
                  for a, b in zip(dense, paged)]
    witnesses = [None if a == b else near_tie(pipe, task, a, step)
                 for task, a, b, step in zip(tasks, dense, paged, first_diff)]
    results["agreement"] = {
        "greedy_ids_equal": dense == paged,
        "requests": len(tasks),
        "requests_equal": sum(a == b for a, b in zip(dense, paged)),
        "first_diff": first_diff,
        "near_ties": witnesses,
        "splits_all_near_ties": all(w["near_tie"] for w in witnesses if w),
        "tokens": sum(len(a) for a in dense),
    }
    print(json.dumps(results, indent=2))
    if args.out:
        write_result(args.out, results)
    return results


if __name__ == "__main__":
    main()
