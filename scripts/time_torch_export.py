#!/usr/bin/env python3
"""Time a reloaded `lm_decode` program eagerly and replayed as a CUDA graph.

    python3 scripts/time_torch_export.py [--layers 24] [--lm bf16,int8]

Full Spark-TTS-0.5B widths, random weights (seed 0): for each LM tree
(bf16, and int8 through `quantize_qwen_int8`), cut to its first `--layers`
layers, `export_pipeline_artifacts` writes `lm_prefill` and `lm_decode`
(prompt `--prompt_len`, cache prompt + `--decode_len`) to a temporary
directory and `load_program` reloads them.  A random prompt is prefilled,
then `--new_tokens` greedy ids are decoded twice from the same prefill, as
chip_smoke's phase 33 does: once through the program's module run eagerly
(the graph walked op by op), once through `LoadedProgram`, which replays a
CUDA graph captured at its first call.  Each decode step is a program call,
an argmax and its host read; ms a step is the wall of the steps after the
first id / their count.  Also: the replayed ids' first step apart from the
eager ids (null: equal), the first decode step's logits gap over max|logit|,
the capture's ms, and the replayed steps' kernel launches (on the card it
fails unless they are the program's kernel ops once a step).

Arguments: `--device` (default $SPARKTTS_PLATFORM, else cuda; it raises
without a card unless the CPU is asked for; on the CPU both runs are eager),
`--tiny` (the tiny config, fp32) and `--out` (under chiprun_out/).  Prints
the card's `nvidia-smi` line, one line a tree, then one JSON document.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import card_line, write_result  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24, help="the LM's first layers exported")
    ap.add_argument("--lm", default="bf16,int8")
    ap.add_argument("--prompt_len", type=int, default=128)
    ap.add_argument("--decode_len", type=int, default=512)
    ap.add_argument("--new_tokens", type=int, default=48)
    ap.add_argument("--tiny", action="store_true", help="the tiny config, fp32")
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def greedy(prefill, decode, ids, n):
    """n greedy ids from the two programs (no left padding), the first
    decode step's logits, and the ms of a decode step."""
    import torch

    dev = ids.device
    t = ids.shape[1]
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    logits, k, v = prefill(ids, torch.ones(ids.shape, dtype=torch.bool, device=dev))
    toks, first = [int(logits.argmax(-1)[0])], None
    t0 = time.perf_counter()
    for i in range(n - 1):
        logits, k, v = decode(torch.tensor([toks[-1]], device=dev),
                              torch.tensor([t + i], device=dev), start, k, v,
                              torch.tensor(t + i, dtype=torch.int32, device=dev))
        toks.append(int(logits.argmax(-1)[0]))
        first = logits if first is None else first
    return toks, first, (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from sparktts_tpu_torch import export as E
    from sparktts_tpu_torch.config import tiny_test_config
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.lm.speculative import draft_config, draft_from_layers
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.utils.platform import apply_platform_env, require_device

    dev = require_device(args.device or apply_platform_env(), "time_torch_export")
    smi = card_line(dev)
    print(smi, flush=True)
    if args.tiny:
        pipe = SparkTTSPipeline(config=tiny_test_config(), device=dev, lm_dtype=torch.float32)
    else:
        pipe = SparkTTSPipeline(device=dev)
    cfg = pipe.config
    layers = min(args.layers, cfg.llm.num_hidden_layers)
    pipe.config = dataclasses.replace(cfg, llm=draft_config(cfg.llm, layers))
    full = pipe.llm_params
    trees = {"bf16": lambda: full, "int8": lambda: quantize_qwen_int8(full)}
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, cfg.llm.vocab_size, (1, args.prompt_len), generator=gen, device=dev)
    doc = {"card": smi, "backend": dev.type, "layers": layers, "prompt_len": args.prompt_len,
           "cache_len": args.prompt_len + args.decode_len, "new_tokens": args.new_tokens}
    for lm in args.lm.split(","):
        pipe.llm_params = draft_from_layers(trees[lm](), layers)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            E.export_pipeline_artifacts(pipe, d, prompt_len=args.prompt_len,
                                        decode_len=args.decode_len,
                                        graphs=("lm_prefill", "lm_decode"))
            export_s = time.perf_counter() - t0
            prefill = E.load_program(Path(d) / "lm_prefill.pt2")
            decode = E.load_program(Path(d) / "lm_decode.pt2")

        want, want_logits, eager_ms = greedy(prefill, decode.eager, ids, args.new_tokens)
        t0 = time.perf_counter()
        greedy(prefill, decode, ids, 2)  # the capture, off the clock
        first_call_ms = (time.perf_counter() - t0) * 1e3
        graphs.reset_launches()
        got, got_logits, replayed_ms = greedy(prefill, decode, ids, args.new_tokens)
        launched = {k: n for k, n in graphs.launches().items() if n}
        want_launches = {op: n * (args.new_tokens - 1) for op, n in decode.ops.items()}
        if dev.type == "cuda" and launched != want_launches:
            raise AssertionError(f"{lm}: the replayed decode steps launched {launched}, want "
                                 f"{want_launches}")
        apart = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        row = {"eager_ms": eager_ms, "replayed_ms": replayed_ms,
               "first_call_ms": first_call_ms,
               "capture_ms": [c.capture_ms for c in decode.captured.values()],
               "first_apart": apart[0] if apart else None,
               "logits_rel_err": float((got_logits - want_logits).abs().max()
                                       / want_logits.abs().max()),
               "export_s": export_s, "ops": decode.ops, "replayed_launches": launched}
        doc[lm] = row
        print(lm, json.dumps(row), flush=True)
        del prefill, decode
    pipe.llm_params, pipe.config = full, cfg
    if args.out:
        write_result(args.out, doc)
    print(json.dumps(doc, indent=2))
    return doc


if __name__ == "__main__":
    main()
