#!/usr/bin/env python
"""Ablation attribution of the port's decode step's per-token time budget.

The counterpart of `scripts/bench_decode_ablate.py`: n-step loops of
progressively stripped step bodies at production dims (int8 weights, B = 1,
a 2048-token cache, writes from position 700, the guided head over the
semantic rows [151665, 151665 + 8192) cast to bf16 once, outside the loop):

  full       the port's production decode step: 24 layers (qkv + RoPE, the
             K/V write, attention through kernel 2, o, the MLP through
             kernel 4), the guided head, top-k/top-p sampling
  layers     the layer stack only: constant next token, no head or sampler
  no_attn    layers with the attention core (kernel 2) replaced by a
             broadcast of v: the same weight streaming, no cache read or
             softmax (`project_qkv` and its RoPE kept)
  mm_only    just the 4 weight matmuls a layer (`linear_apply` on qkv, o,
             gateup, down, with the int8 weights' per-call cast to bf16, as
             the port's linears do)
  sampler    the guided head matmul + top-k/top-p sampling
             (`lm/sample.sample_token`) with the script's own generator
  empty      the loop's own floor

Unlike the JAX script, whose layers call `mlp_block` unfused, `full`,
`layers` and `no_attn` run the MLP as the port's decode step does
(`mlp_block(..., decode_fused=True)`: kernel 4 on the int8 tree), so
`full` measures the port's production step; the script fails on the card
unless a replay of `full` launches kernels 2 and 4 24 x n_steps times each.

Each variant's `--n_steps` steps are captured as one CUDA graph
(`graphs.CapturedCall`) over buffers of the script's own, refilled (x, the
cache zeroed, the positions, the generator's state) before each replay; the
time is the host wall from the replay to a `torch.cuda.synchronize()`, the
minimum over `--iters`, per token.  Arguments are the JAX script's plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for) and `--out` (under chiprun_out/); `--tiny` is
the tiny config's LM in fp32, int8-quantized, a cache of at most 128 and
the whole vocabulary as the head.  Prints the card's `nvidia-smi` line, one
line a variant, then one JSON document: ms a token by variant, and each
variant's launches a replay.

    python scripts/bench_decode_ablate_torch.py --n_steps 128 --iters 5
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import card_line, write_result  # noqa: E402

VARIANTS = ("full", "layers", "no_attn", "mm_only", "sampler", "empty")
WRITE_POS = 700


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_steps", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cache_len", type=int, default=2048)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tiny", action="store_true", help="tiny dims (CPU smoke)")
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from sparktts_tpu_torch.config import QwenConfig, tiny_test_config
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.qwen import (
        KVCache,
        _attention_block,
        init_kv_cache,
        mlp_block,
        project_qkv,
        rope_cos_sin,
        unstack_layers,
    )
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.lm.sample import sample_token
    from sparktts_tpu_torch.nn.layers import linear_apply, rms_norm_apply
    from sparktts_tpu_torch.utils.platform import apply_platform_env, require_device
    from sparktts_tpu_torch.weights import init_qwen

    dev = require_device(args.device or apply_platform_env(), "bench_decode_ablate_torch")
    smi = card_line(dev)
    print(smi, flush=True)
    if args.tiny:
        cfg, dtype = tiny_test_config().llm, torch.float32
        args.cache_len = min(args.cache_len, 128)
        sem_base, n_sem = 0, cfg.vocab_size
        write_pos = args.cache_len - args.n_steps - 1
    else:
        cfg, dtype = QwenConfig(), torch.bfloat16
        sem_base, n_sem = 151665, 8192
        write_pos = WRITE_POS
    gen = torch.Generator(device=dev).manual_seed(0)
    params = quantize_qwen_int8(init_qwen(cfg, gen, dtype, dev))
    layers = unstack_layers(params["layers"])
    S, B = args.cache_len, 1
    eps = cfg.rms_norm_eps
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    group = nh // cfg.num_key_value_heads
    q_dim = nh * hd

    # the guided head: the embedding's semantic rows, dequantized, cast once
    embed = params["embed"]
    rows = slice(sem_base, sem_base + n_sem)
    if isinstance(embed, dict):  # int8-quantized embedding {w_q, scale}
        head_w = embed["w_q"][rows].to(dtype) * embed["scale"][rows].to(dtype)
    else:
        head_w = embed[rows]
    head_w = head_w.to(dtype).contiguous()

    def norm(p, x):
        return rms_norm_apply(p, x, eps=eps)

    def layer_full(x, cache, li, layer, rope, wp, start):
        att = _attention_block(layer, norm(layer["ln1"], x), rope, cache, li, wp, None, cfg,
                               decode_window=(start, wp))
        x = x + att
        return x + mlp_block(layer, norm(layer["ln2"], x), decode_fused=True)

    def layer_no_attn(x, layer, rope):
        q, k, v = project_qkv(layer, norm(layer["ln1"], x), rope, cfg)
        out = v.repeat_interleave(group, dim=2).reshape(B, 1, q_dim).to(x.dtype)
        x = x + linear_apply(layer["o"], out)
        return x + mlp_block(layer, norm(layer["ln2"], x), decode_fused=True)

    def layer_mm_only(x, layer):
        y = linear_apply(layer["qkv"], x)
        z = linear_apply(layer["o"], y[..., :q_dim])
        g = linear_apply(layer["gateup"], z)
        d = linear_apply(layer["down"], g[..., : cfg.intermediate_size])
        return x + d * 1e-3

    def stack(x, k, v, wp, pos):
        cache, start = KVCache(k, v), torch.zeros((B,), dtype=torch.int32, device=dev)
        rope = rope_cos_sin(pos[:, None], cfg)
        h = x
        for li, layer in enumerate(layers):
            h = layer_full(h, cache, li, layer, rope, wp, start)
        return h

    def sample(h, generator):
        logits = h[:, -1].float() @ head_w.float().T
        return sample_token(generator, logits, 0.8, 50, 0.95)

    def make_step(variant, generator):
        """step(x, k, v, wp, pos) -> (x, wp, pos); k, v are written in place."""
        def step_full(x, k, v, wp, pos):
            h = norm(params["final_ln"], stack(x, k, v, wp, pos))
            tok = sample(h, generator)
            return x + tok[:, None, None].to(x.dtype) * 0.0, wp + 1, pos + 1  # keep the dep

        def step_layers(x, k, v, wp, pos):
            return x + stack(x, k, v, wp, pos) * 1e-6, wp + 1, pos + 1

        def step_no_attn(x, k, v, wp, pos):
            rope, h = rope_cos_sin(pos[:, None], cfg), x
            for layer in layers:
                h = layer_no_attn(h, layer, rope)
            return x + h * 1e-6, wp + 1, pos + 1

        def step_mm_only(x, k, v, wp, pos):
            h = x
            for layer in layers:
                h = layer_mm_only(h, layer)
            return x + h * 1e-6, wp + 1, pos + 1

        def step_sampler(x, k, v, wp, pos):
            tok = sample(x, generator)
            return x + tok[:, None, None].to(x.dtype) * 0.0, wp + 1, pos + 1

        def step_empty(x, k, v, wp, pos):
            return x * 1.0000001, wp + 1, pos + 1

        return {"full": step_full, "layers": step_layers, "no_attn": step_no_attn,
                "mm_only": step_mm_only, "sampler": step_sampler, "empty": step_empty}[variant]

    def fresh():
        cache = init_kv_cache(cfg, B, S, dtype, dev)
        return (torch.zeros((B, 1, cfg.hidden_size), dtype=dtype, device=dev) + 0.01,
                cache.k, cache.v, torch.full((B,), write_pos, dtype=torch.int32, device=dev),
                torch.full((B,), write_pos, dtype=torch.int32, device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results, per_replay = {}, {}
    with torch.inference_mode():
        for variant in args.variants.split(","):
            generator = torch.Generator(device=dev).manual_seed(1)
            seed_state = generator.get_state()
            step = make_step(variant, generator)

            def run(x, k, v, wp, pos):
                for _ in range(args.n_steps):
                    x, wp, pos = step(x, k, v, wp, pos)
                return x

            call = graphs.CapturedCall(run, fresh(), generators=(generator,))
            times = []
            for _ in range(args.iters):
                # rebuilt every replay: the loop writes the cache and moves the positions
                for mine, theirs in zip(call.inputs, fresh()):
                    mine.copy_(theirs)
                generator.set_state(seed_state)
                sync()
                graphs.reset_launches()
                t0 = time.perf_counter()
                call.replay()
                sync()
                times.append(time.perf_counter() - t0)
                launched = graphs.launches()
            per_replay[variant] = {k: n for k, n in launched.items() if n}
            results[variant] = min(times) / args.n_steps * 1e3
            print(variant, results[variant], flush=True)
            del call
            if variant == "full" and dev.type == "cuda":
                want = cfg.num_hidden_layers * args.n_steps
                got = {k: launched[k] for k in ("dense_decode_attention", "int8_mlp_matvec")}
                if any(n != want for n in got.values()):
                    raise AssertionError(f"full: a replay launched {got}, want {want} of each "
                                         f"(24 layers x {args.n_steps} steps)")
    results.update(launches_per_replay=per_replay, backend=dev.type, card=smi,
                   dims=f"batch {B}, int8, cache {S}, write position {write_pos}, head "
                        f"{n_sem} rows, {args.n_steps} steps a replay")
    if args.out:
        write_result(args.out, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
