#!/usr/bin/env python
"""Long-stream vocode scaling A/B of the PyTorch/CUDA port: the windowed
streaming vocode (each chunk re-renders only [emitted - receptive field,
upto), equal to a full-prefix vocode) against a full-prefix recompute (the
reference streaming BLS's way, whose per-chunk cost grows with the stream),
over one long clone stream through the continuous server.

The counterpart of `scripts/bench_long_stream.py`: its arguments, plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for) and `--out` (under chiprun_out/).  Prints one
JSON object: each arm's RTF, first chunk, inter-chunk gap percentiles and
the server's vocode stage stats (last pass), and the sha256 of the arm's
waveform (the two arms must give the same samples).  The engine's cache
holds the long prompt and the whole budget.

    python scripts/bench_long_stream_torch.py --max_new_tokens 2000
"""
import argparse
import asyncio
import hashlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import write_result  # noqa: E402

TEXT = "long stream vocode scaling " * 40


async def run_stream(server, text, prompt_wav, max_new_tokens):
    t0 = time.perf_counter()
    arrivals, chunks = [], []
    async for chunk in server.synthesize_streaming(text, prompt_wav=prompt_wav,
                                                   max_new_tokens=max_new_tokens):
        arrivals.append(time.perf_counter() - t0)
        chunks.append(chunk)
    return arrivals, chunks


def run_arm(pipe, ctx, text, prompt_wav, max_new_tokens, passes=2):
    """A fresh server with the given stream context (None: the receptive
    field's window; 10**9: the full prefix); the last of `passes` streams is
    the warm measurement."""
    import numpy as np

    from sparktts_tpu_torch.prompt import clone_prompt_scaffold
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    _, plen, _, _ = clone_prompt_scaffold(pipe.tokenizer, text, n_glob, 0, None)
    t_pad = -(-plen // pipe.prompt_bucket) * pipe.prompt_bucket
    out = {}

    async def go():
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=512,
                                     cache_len=t_pad + max_new_tokens, fused_warm="sync",
                                     stream_context_frames=ctx)
        await server.start()
        try:
            for _ in range(passes):
                server.stage_stats.reset()
                t0 = time.perf_counter()
                arrivals, chunks = await run_stream(server, text, prompt_wav, max_new_tokens)
                wall = time.perf_counter() - t0
        finally:
            await server.stop()
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        audio_s = wav.size / pipe.sample_rate
        gaps = np.diff(np.asarray(arrivals)) * 1000
        out.update(
            chunks=len(arrivals),
            audio_s=round(audio_s, 2),
            wall_s=round(wall, 3),
            rtf=round(wall / max(audio_s, 1e-9), 5),
            first_chunk_ms=round(arrivals[0] * 1000, 1) if arrivals else None,
            # gaps need two chunks at least (short budgets, an early EOS)
            gap_p50_ms=round(float(np.percentile(gaps, 50)), 1) if gaps.size else None,
            gap_p90_ms=round(float(np.percentile(gaps, 90)), 1) if gaps.size else None,
            gap_max_ms=round(float(gaps.max()), 1) if gaps.size else None,
            vocode_stats=server.stage_stats.summary().get("vocode", {}),
            samples=int(wav.size),
            audio_sha256=hashlib.sha256(np.ascontiguousarray(wav, np.float32).tobytes())
            .hexdigest(),
        )

    asyncio.new_event_loop().run_until_complete(go())
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max_new_tokens", type=int, default=2000)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from sparktts_tpu_torch.bench.harness import script_pipeline

    pipe = script_pipeline(args.tiny, args.device, args.max_new_tokens)
    if not args.tiny:
        pipe.vocode_bucket = 125
    prompt_wav = np.random.default_rng(0).standard_normal(3 * 16000).astype(np.float32) * 0.1

    results = {"max_new_tokens": args.max_new_tokens}
    results["windowed"] = run_arm(pipe, None, TEXT, prompt_wav, args.max_new_tokens, args.passes)
    results["full_prefix"] = run_arm(pipe, 10**9, TEXT, prompt_wav, args.max_new_tokens,
                                     args.passes)
    results["same_audio"] = (results["windowed"]["audio_sha256"]
                             == results["full_prefix"]["audio_sha256"])
    if args.out:
        write_result(args.out, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
