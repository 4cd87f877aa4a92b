#!/usr/bin/env python
"""Dataset-scale benchmark of the PyTorch/CUDA port (role of the reference's
26-pair seed_tts run, reference client_grpc.py:608-820): a 20+ utterance
manifest with varied prompt and target lengths, offline at concurrency
{1,2,4} (the window-batching TTSServer and the continuous server) and
streaming at {1,2,4} through ContinuousTTSServer, then longform, gRPC and
(optionally) HTTP streaming rows and the codec's quality metrics, each with
avg/P50/P90/P99 latency and RTF.  Writes one JSON document.

The counterpart of `scripts/run_dataset_bench.py`: its arguments, plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for).  The synthetic manifest is
`bench.harness.make_tasks`; `--hf_dataset` reads a seed_tts-protocol dataset
saved on disk (`bench.harness.load_hf_dataset_tasks`).  `--out` is written
under chiprun_out/ (ignored by git).

    python scripts/run_dataset_bench_torch.py --out BENCH_DATASET_torch.json
    python scripts/run_dataset_bench_torch.py --tiny --tasks 6 --device cpu
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
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default=None)
    parser.add_argument(
        "--hf_dataset", default=None,
        help="seed_tts-protocol huggingface dataset saved on disk (reference "
        "client_grpc.py --huggingface-dataset); replaces the synthetic manifest",
    )
    parser.add_argument("--hf_split", default="wenetspeech4tts")
    parser.add_argument("--tasks", type=int, default=24)
    parser.add_argument("--out", default="BENCH_DATASET_torch.json",
                        help="JSON document, under chiprun_out/ when relative")
    parser.add_argument("--tiny", action="store_true", help="tiny CPU config")
    parser.add_argument("--offline_conc", default="1,2,4")
    parser.add_argument("--streaming_conc", default="1,2,4")
    parser.add_argument("--max_slots", type=int, default=8)
    parser.add_argument(
        "--grpc_conc", default="1",
        help="comma-separated concurrencies for the gRPC-transport streaming sweep ('' disables)",
    )
    parser.add_argument(
        "--http_conc", default="",
        help="comma-separated concurrencies for the real-HTTP streaming sweep (chunked "
        "transfer through serve_http and the stdlib client; '' disables)",
    )
    parser.add_argument(
        "--longform_requests", type=int, default=8,
        help="number of longform (3-segment) streaming requests to record (0 disables)",
    )
    parser.add_argument("--no_int8_lm", action="store_true")
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument(
        "--no_vocode_batch", action="store_true",
        help="disable cross-stream batched vocoding in the continuous server (A/B lever; "
        "default on, as in production)",
    )
    parser.add_argument(
        "--stream_vocode_bucket", type=int, default=125,
        help="finer vocoder padding bucket for the streaming phase (offline keeps the one "
        "full-budget bucket)",
    )
    parser.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    return parser.parse_args(argv)


def warm_fused_windows(pipe, tasks, max_conc: int) -> int:
    """Run the offline server's fused clone path once at every (batch, prompt
    bucket, wav bucket) window the timed runs can form from `tasks`, up to
    `max_conc` rows (`TTSServer._execute_batch` pins the window's
    composition; distinct seeds take the per-row-generator path).  Returns
    the number of windows run."""
    from sparktts_tpu_torch.prompt import clone_prompt_scaffold
    from sparktts_tpu_torch.serve.server import TTSRequest, TTSServer

    warm_srv = TTSServer(pipe)

    def warm_window(idxs):
        reqs = [TTSRequest(text=tasks[i].text, prompt_wav=tasks[i].prompt_wav,
                           prompt_text=tasks[i].prompt_text, seed=i) for i in idxs]
        for out in warm_srv._execute_batch(reqs):
            if isinstance(out, Exception):
                raise out

    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    tpad_of, dur_of = {}, {}
    for i, t in enumerate(tasks):
        _, plen, _, _ = clone_prompt_scaffold(pipe.tokenizer, t.text, n_glob, 0, t.prompt_text)
        tpad_of[i] = -(-plen // pipe.prompt_bucket) * pipe.prompt_bucket
        dur_of[i] = len(t.prompt_wav)
    n_warm = 0
    for b in range(1, max_conc + 1):
        for tp in sorted(set(tpad_of.values())):
            for d in sorted(set(dur_of.values())):
                # a window whose largest prompt bucket is tp and largest wav
                # d needs an anchor of each; the rest are tasks below both
                both = next((i for i in tpad_of if tpad_of[i] == tp and dur_of[i] == d), None)
                if both is not None:
                    anchors = [both]
                else:
                    a_t = next((i for i in tpad_of if tpad_of[i] == tp and dur_of[i] <= d), None)
                    a_d = next((i for i in dur_of if dur_of[i] == d and tpad_of[i] <= tp), None)
                    if a_t is None or a_d is None:
                        continue  # no run can form this window either
                    anchors = [a_t, a_d]
                if len(anchors) > b:
                    continue
                window = anchors + [i for i in tpad_of if i not in anchors
                                    and tpad_of[i] <= tp and dur_of[i] <= d]
                if len(window) >= b:
                    warm_window(window[:b])
                    n_warm += 1
    return n_warm


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from sparktts_tpu_torch.bench.harness import (
        make_tasks,
        run_continuous_benchmark,
        run_offline_benchmark,
        script_pipeline,
    )
    from sparktts_tpu_torch.bench.relay_probe import probe_record
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    if args.tiny:
        max_new_choices, prompt_secs = (16, 24, 32), (1,)
        pipe = script_pipeline(True, args.device, max(max_new_choices))
    else:
        max_new_choices, prompt_secs = (200, 350, 500), (3, 6)
        pipe = script_pipeline(False, args.device, 500, int8=not args.no_int8_lm,
                               model_dir=args.model_dir)
    dev = pipe.device
    # one vocoder shape per budget wherever EOS lands
    pipe.vocode_bucket = max(max_new_choices)

    if args.hf_dataset:
        from sparktts_tpu_torch.bench.harness import load_hf_dataset_tasks

        tasks = load_hf_dataset_tasks(args.hf_dataset, args.hf_split)[: args.tasks]
    else:
        tasks = make_tasks(args.tasks, max_new_choices, prompt_secs)
    results = {"tasks": len(tasks), "dataset": args.hf_dataset or "synthetic",
               "backend": dev.type, "runs": []}
    offline_concs = [int(c) for c in args.offline_conc.split(",") if c]
    streaming_concs = [int(c) for c in args.streaming_conc.split(",") if c]
    max_conc = max(offline_concs + streaming_concs, default=1)
    vocode_batch = not args.no_vocode_batch

    # warm-up: the first runs (admissions, vocode shapes, cuDNN/cuBLAS
    # algorithm choices) before the timed runs.  The dispatch ladder needs
    # none: each server's start() captures every rung's decode unit before
    # its timed region
    if not args.no_warmup:
        t0 = time.time()
        from sparktts_tpu_torch.serve.continuous_server import (
            warm_admit_batches,
            warm_vocode_batches_seen,
        )

        warm_b = ContinuousTTSServer(pipe, max_slots=args.max_slots, fused_warm="sync")
        n_ab = warm_admit_batches(warm_b, tasks, min(args.max_slots, max_conc))
        warm_b.engine.close()
        del warm_b
        print(f"warmed {n_ab} batched-admission signatures", file=sys.stderr)
        for streaming in (False, True):
            run_continuous_benchmark(
                pipe, tasks[: max(3, len(max_new_choices) * len(prompt_secs))],
                concurrency=2, streaming=streaming, max_slots=args.max_slots,
                vocode_batch=vocode_batch)
        if vocode_batch:
            n_voc = warm_vocode_batches_seen(pipe, min(args.max_slots, 2 * max_conc))
            print(f"warmed {n_voc} batched-vocode signatures", file=sys.stderr)
        n_warm = warm_fused_windows(pipe, tasks, max(offline_concs, default=1))
        print(f"warm-up done in {time.time() - t0:.1f} s ({n_warm} fused windows)",
              file=sys.stderr)

    results["dispatch_tax_session_start"] = probe_record("session start", device=dev)

    def record(stats):
        # after every timed run, so a later failure keeps the runs done
        stats["dispatch_tax"] = probe_record(device=dev)
        print(json.dumps(stats), file=sys.stderr)
        results["runs"].append(stats)
        write_result(str(args.out) + ".partial", results)

    for conc in offline_concs:
        record(run_offline_benchmark(pipe, tasks, concurrency=conc))
        record(run_continuous_benchmark(pipe, tasks, concurrency=conc, streaming=False,
                                        max_slots=args.max_slots, vocode_batch=vocode_batch))

    if streaming_concs and args.stream_vocode_bucket:
        # streaming: finer vocode buckets (chunk lengths follow the chunk
        # schedule, so the set of shapes stays small), warmed first
        pipe.vocode_bucket = args.stream_vocode_bucket
        if not args.no_warmup:
            from sparktts_tpu_torch.serve.continuous_server import warm_vocode_batches_seen

            run_continuous_benchmark(pipe, tasks[:4], concurrency=2, streaming=True,
                                     max_slots=args.max_slots, vocode_batch=vocode_batch)
            if vocode_batch:
                n_voc = warm_vocode_batches_seen(
                    pipe, min(args.max_slots, 2 * max(streaming_concs)))
                print(f"warmed {n_voc} batched-vocode signatures (stream bucket "
                      f"{pipe.vocode_bucket})", file=sys.stderr)
    if streaming_concs and not args.no_warmup:
        # the vocode window cap closes the scalar streaming shape set, and
        # each (batch, target, rung) speculative first-chunk chain is a shape
        from sparktts_tpu_torch.serve.continuous_server import (
            default_stream_ctx,
            vocode_window_cap,
            warm_spec_chains,
            warm_stream_windows,
        )

        n_win = warm_stream_windows(pipe, vocode_window_cap(pipe) + default_stream_ctx(pipe))
        warm_c = ContinuousTTSServer(pipe, max_slots=args.max_slots)
        n_spec = warm_spec_chains(warm_c, min(args.max_slots, max(streaming_concs, default=1)))
        warm_c.engine.close()
        del warm_c
        print(f"warmed {n_win} stream windows, {n_spec} speculative chains", file=sys.stderr)
    for conc in streaming_concs:
        if conc > 2 and not args.no_warmup:
            # warm at the timed concurrency too: batch compositions first
            # formed at it would otherwise run first inside the timed run
            run_continuous_benchmark(pipe, tasks[: min(len(tasks), 2 * conc)], concurrency=conc,
                                     streaming=True, max_slots=args.max_slots,
                                     vocode_batch=vocode_batch)
        record(run_continuous_benchmark(pipe, tasks, concurrency=conc, streaming=True,
                                        max_slots=args.max_slots, vocode_batch=vocode_batch))

    if args.longform_requests:
        # 3-segment texts through synthesize_streaming_long (voice-stable
        # segment chaining); one unrecorded request first, as every phase
        from sparktts_tpu_torch.bench.harness import run_longform_benchmark

        if not args.no_warmup:
            run_longform_benchmark(pipe, tasks, n_requests=1, segments=3,
                                   max_slots=args.max_slots)
        record(run_longform_benchmark(pipe, tasks, n_requests=args.longform_requests,
                                      segments=3, max_slots=args.max_slots))

    if args.grpc_conc:
        from sparktts_tpu_torch.bench.harness import run_grpc_streaming_benchmark

        for conc in [int(c) for c in args.grpc_conc.split(",") if c]:
            record(run_grpc_streaming_benchmark(pipe, tasks, concurrency=conc,
                                                max_slots=args.max_slots))

    if args.http_conc:
        # chunked /tts_stream through serve_http and the stdlib client
        import threading
        import urllib.request

        from sparktts_tpu_torch.bench.harness import run_network_streaming_benchmark
        from sparktts_tpu_torch.serve.server import serve_http

        control: dict = {}
        th = threading.Thread(target=serve_http, daemon=True, kwargs=dict(
            pipeline=pipe, host="127.0.0.1", port=0, stream_max_slots=args.max_slots,
            control=control))
        th.start()
        while "stop" not in control:
            time.sleep(0.1)
        port = control["httpd"].server_address[1]
        try:
            for _ in range(600):  # /tts_stream answers once its units are captured
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5):
                        break
                except OSError:
                    time.sleep(0.5)
            run_network_streaming_benchmark("127.0.0.1", port, tasks[:4], concurrency=2)
            for conc in [int(c) for c in args.http_conc.split(",") if c]:
                record(run_network_streaming_benchmark("127.0.0.1", port, tasks, concurrency=conc))
        finally:
            control["stop"]()

    # quality metrics: the codec's round trip (mel distance, speaker
    # similarity, semantic consistency) on a few prompts; on random weights
    # stable for a seed, not meaningful in themselves
    from sparktts_tpu_torch.bench.metrics import (
        mel_distance,
        semantic_consistency,
        speaker_similarity,
    )

    qual = []
    for t in tasks[:3]:
        g, s = pipe.tokenize_audio(t.prompt_wav)
        recon = pipe.detokenize(g, s)
        n = min(len(recon), len(t.prompt_wav))
        ref = np.asarray(t.prompt_wav[:n], np.float32)
        qual.append({
            "mel_distance_l1": round(mel_distance(ref, recon[:n], device=dev), 4),
            "speaker_similarity": round(speaker_similarity(pipe, ref, recon[:n]), 4),
            "semantic_consistency": round(semantic_consistency(pipe, t.prompt_wav), 4),
        })
    results["codec_quality"] = {
        "per_prompt": qual,
        "mel_distance_l1_mean": round(float(np.mean([q["mel_distance_l1"] for q in qual])), 4),
        "speaker_similarity_mean": round(float(np.mean([q["speaker_similarity"]
                                                        for q in qual])), 4),
    }
    results["dispatch_tax_session_end"] = probe_record("session end", device=dev)
    write_result(args.out, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
