#!/usr/bin/env python
"""Microbenchmark the port's decode step at production dims (Qwen2.5-0.5B,
int8 weights, guided decoding: the 8192 semantic rows plus EOS, B = 1, a
2048-token cache) to attribute the per-step time budget.

The counterpart of `scripts/bench_decode_step.py`.  The JAX script sweeps
the layer scan's unroll factor; the port's layer loop is plain Python,
unrolled, and what sits where JAX's scan boundary sat is the decode unit:
U steps captured as one CUDA graph (`lm/generate.decode_chunk(unit_steps=U)`,
`lm/graphs.py`), replayed n / U times.  So the knobs swept are

  * the unit's steps U (`--units`, each dividing `--n_steps`), against an
    `eager` row per sampling mode: the same steps through
    `generate._decode_scan`, no graph;
  * greedy vs sampled (the sampler's cost).

Each row (`unit{U}_{greedy|sampled}`, `eager_{greedy|sampled}`) starts from
its own prefill (kernel 1) of the same random prompt, runs one chunk of
`--n_steps` steps to warm up (for a unit: its warm-up and capture, the
row's `compile_s`), then times `--iters` chunks continuing the same state:
host wall from the call to a `torch.cuda.synchronize()`, the minimum taken.
`greedy_first_diff` gives, for each greedy row, the first step of the warm
chunk whose id differs from the eager row's (null: all equal).

With `--sweep_steps` it records ms a token against the chunk length instead
(U = 8, the unit `generate` replays; each length a multiple of 8), each
timed chunk from a fresh prefill (`fresh_state`), and fits
t(n) = dispatch_tax + n * per_step_floor by least squares.

Arguments are the JAX script's, `--units` for `--unrolls`, plus `--device`
(default $SPARKTTS_PLATFORM, else cuda; it raises without a card unless the
CPU is asked for), `--tiny` (the tiny config's LM, fp32, int8-quantized;
the guided rows a quarter of its vocabulary) and `--out` (under
chiprun_out/).  Prints the card's `nvidia-smi` line, the JAX script's lines,
then one JSON document.  On the card it fails unless every timed chunk
launched kernels 2 and 4 once a layer a step.

    python scripts/bench_decode_step_torch.py --n_steps 128 --iters 5
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import card_line, write_result  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_steps", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--t_pad", type=int, default=256)
    ap.add_argument("--cache_len", type=int, default=2048)
    ap.add_argument("--units", default="1,2,4,8,32",
                    help="decode unit sizes U (steps a CUDA graph), each dividing --n_steps")
    ap.add_argument("--no_guided", action="store_true")
    ap.add_argument("--sweep_steps", default=None,
                    help="comma-separated chunk lengths, multiples of 8 (e.g. "
                    "32,64,128,256,512): ms/token against chunk length at U = 8, and the "
                    "fit t(n) = dispatch_tax + n*per_step_floor")
    ap.add_argument("--tiny", action="store_true", help="the tiny config's LM, fp32")
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from sparktts_tpu_torch.config import QwenConfig, tiny_test_config
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import _decode_scan, decode_chunk, prefill
    from sparktts_tpu_torch.lm.qwen import init_kv_cache
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.utils.platform import apply_platform_env, require_device
    from sparktts_tpu_torch.weights import init_qwen

    dev = require_device(args.device or apply_platform_env(), "bench_decode_step_torch")
    smi = card_line(dev)
    print(smi, flush=True)
    if args.tiny:
        cfg, dtype = tiny_test_config().llm, torch.float32
        sem = (cfg.vocab_size // 4, cfg.vocab_size // 2)
    else:
        cfg, dtype = QwenConfig(), torch.bfloat16
        sem = (151665, 151665 + 8192)
    # clone-mode guided constraint shape: the semantic rows + EOS
    vocab_slice = None if args.no_guided else sem
    extra_ids = () if args.no_guided else (cfg.eos_token_id,)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = quantize_qwen_int8(init_qwen(cfg, gen, dtype, dev))

    b, t_pad = args.batch, args.t_pad
    ids = torch.randint(0, 1000 if not args.tiny else cfg.vocab_size, (b, t_pad),
                        generator=gen, device=dev)
    mask = torch.ones((b, t_pad), dtype=torch.bool, device=dev)
    sampling = dict(temperature=0.8, top_k=50, top_p=0.95)
    units = graphs.UnitCache("bench_decode_step_torch")
    n_layers = cfg.num_hidden_layers

    def fresh_state(greedy):
        g = torch.Generator(device=dev).manual_seed(1)
        cache = init_kv_cache(cfg, b, args.cache_len, dtype, dev)
        with torch.inference_mode():
            state = prefill(params, cfg, ids, mask, cache, g, **sampling, greedy=greedy,
                            vocab_slice=vocab_slice, extra_ids=extra_ids)
        return state, g

    def chunk(state, g, n_steps, greedy, unit):
        """n_steps steps from `state`; (state, tokens).  unit None: eager."""
        kw = dict(eos_ids=(), pad_id=0, greedy=greedy, vocab_slice=vocab_slice,
                  extra_ids=extra_ids)
        if unit is None:
            with torch.inference_mode():
                state, toks, _ = _decode_scan(params, cfg, state, t_pad, n_steps, g,
                                              sampling["temperature"], sampling["top_k"],
                                              sampling["top_p"], **kw)
            return state, toks
        state, toks, _ = decode_chunk(params, cfg, state, t_pad, n_steps, g, **sampling,
                                      unit_steps=unit, units=units, **kw)
        return state, toks

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, out

    def check_launches(label, n_steps, launched):
        if dev.type != "cuda":
            return  # on the CPU the wrappers run their plain versions, uncounted
        want = n_layers * n_steps
        got = {k: launched[k] for k in ("dense_decode_attention", "int8_mlp_matvec")}
        if any(n != want for n in got.values()):
            raise AssertionError(f"{label}: a chunk of {n_steps} steps launched {got}, want "
                                 f"{want} of each (one a layer a step)")

    if args.sweep_steps:
        steps_list = [int(s) for s in args.sweep_steps.split(",")]
        rows = []
        for n_steps in steps_list:
            state, g = fresh_state(False)
            chunk(state, g, n_steps, False, 8)  # warm: the unit's capture
            times = []
            for _ in range(args.iters):
                # each measured chunk starts from the same cache position (a long
                # sweep would otherwise overflow cache_len across iterations)
                state, g = fresh_state(False)
                graphs.reset_launches()
                dt, _ = timed(lambda: chunk(state, g, n_steps, False, 8))
                check_launches(f"sweep n={n_steps}", n_steps, graphs.launches())
                times.append(dt)
            best = min(times)
            rows.append({"scan_steps": n_steps, "ms_total": best * 1e3,
                         "ms_per_token": best / n_steps * 1e3, "tok_s": n_steps / best})
            print(json.dumps(rows[-1]), flush=True)
        # least-squares fit t(n) = a + b*n: `a` is the fixed cost of a chunk
        # (the state copied into the unit's buffers and back, the host's
        # replays, the fetch), `b` the per-step floor (device work a step)
        ns = np.asarray([r["scan_steps"] for r in rows], float)
        ts = np.asarray([r["ms_total"] for r in rows], float)
        bfit, afit = np.polyfit(ns, ts, 1)
        doc = {
            "bench": "decode_step_attribution",
            "dims": f"batch {b}, int8, guided={not args.no_guided}, cache {args.cache_len}, "
                    f"unit 8",
            "rows": rows,
            "fit": {"dispatch_tax_ms": float(afit), "per_step_floor_ms": float(bfit),
                    "note": "t(n) = dispatch_tax + n*per_step_floor (least squares)"},
            "backend": dev.type, "card": smi,
        }
    else:
        doc, first = {}, {}
        for unit in [None] + [int(u) for u in args.units.split(",")]:
            for greedy in (False, True):
                name = f"{'eager' if unit is None else f'unit{unit}'}_" \
                       f"{'greedy' if greedy else 'sampled'}"
                state, g = fresh_state(greedy)
                # warm (for a unit: its warm-up and capture)
                compile_s, (state, toks) = timed(
                    lambda: chunk(state, g, args.n_steps, greedy, unit))
                first[name] = toks.cpu()
                times = []
                for _ in range(args.iters):
                    graphs.reset_launches()
                    dt, (state, _) = timed(lambda: chunk(state, g, args.n_steps, greedy, unit))
                    check_launches(name, args.n_steps, graphs.launches())
                    times.append(dt)
                best = min(times)
                doc[name] = {"ms_per_token": best / args.n_steps * 1e3,
                             "tok_s": args.n_steps / best, "compile_s": compile_s}
                print(name, json.dumps(doc[name]), flush=True)
        doc["greedy_first_diff"] = {}
        for name, toks in first.items():
            if name.endswith("_greedy") and name != "eager_greedy":
                apart = (toks != first["eager_greedy"]).any(0).nonzero()
                doc["greedy_first_diff"][name] = int(apart[0]) if len(apart) else None
        doc.update(backend=dev.type, card=smi,
                   dims=f"batch {b}, int8, guided={not args.no_guided}, cache "
                        f"{args.cache_len}, {args.n_steps} steps a chunk")
    units.clear()
    if args.out:
        write_result(args.out, doc)
    print(json.dumps(doc, indent=2))
    return doc


if __name__ == "__main__":
    main()
