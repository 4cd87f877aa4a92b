#!/usr/bin/env python
"""Stage attribution of the port's WaveGenerator vocoder time budget.

The counterpart of `scripts/bench_vocoder.py`: each decoder stage timed
apart (`conv_in`, each `block{i}_x{rate}_c{channels}`, `out`, and the
whole stack `full`; `stages`), with the JAX script's FLOP count a stage
(`flops`: the matmul work, elementwise excluded), across ResidualUnit
implementations (`--modes`):

  kernel   kernel 3 (`kernels/vocoder_fusion.fused_residual_unit`, 3xTF32
           on the tensor cores);
  plain    its plain version (snake, cuDNN's dilated and 1x1 convs, snake),
           the yardstick for what kernel 3 saves a stage.

JAX's `xla`, `carry` and `tiles` modes and its SPARKTTS_VOCODER_KERNEL have
no counterpart: the mode is passed to `codec/wave_generator` as its `unit`.

Precision differs from the JAX script, which casts the vocoder to bf16: the
port's codec runs in fp32 and kernel 3 takes fp32 only, so every stage runs
in fp32 inside `nn/layers.codec_fp32()`, as `detokenize` does: its
convolutions are kernels 7 and 8 (`kernels/codec_gemm.py`,
`kernels/depthwise_conv.py`), in both modes (the plain unit's two
convolutions too).  Each stage runs `--iters` calls captured in one CUDA graph
(`graphs.CapturedCall`); the time is the host wall from the replay to a
`torch.cuda.synchronize()`, the minimum over `--reps`, per call.  Output a
stage: `ms`, `gflop`, `tflops` (unrounded).  `bound` gives kernel 3's
3xTF32 bound over the `full` stage's 12 units (three TF32 products of their
matmul work at 495 TFLOP/s) and its share of the kernel arm's `full` time.
On the card it fails unless the kernel arm's `full` launches kernel 3 once
a unit a call and the plain arm not at all.

Arguments are the JAX script's plus `--device` (default $SPARKTTS_PLATFORM,
else cuda; it raises without a card unless the CPU is asked for) and
`--out` (under chiprun_out/).  Prints the card's `nvidia-smi` line, one line
a stage, then one JSON document.

    python scripts/bench_vocoder_torch.py                  # production dims
    python scripts/bench_vocoder_torch.py --batch 8
    python scripts/bench_vocoder_torch.py --tiny --device cpu
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import card_line, write_result  # noqa: E402

TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (3xTF32 runs three products)
TINY = dict(input_channel=32, channels=48, rates=(2, 2), kernel_sizes=(4, 4))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--t_in", type=int, default=500, help="latent frames (tokens)")
    ap.add_argument("--iters", type=int, default=16, help="calls captured in one graph")
    ap.add_argument("--reps", type=int, default=5, help="timed replays (min taken)")
    ap.add_argument("--modes", default="kernel,plain",
                    help="comma list of ResidualUnit impls: kernel (kernel 3), plain")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    ap.add_argument("--out", default=None, help="JSON document, under chiprun_out/ when relative")
    return ap.parse_args(argv)


def unit_fn(mode: str):
    """The ResidualUnit function of a mode: kernel 3's wrapper, or its plain
    version."""
    from sparktts_tpu_torch.kernels import vocoder_fusion

    return {"kernel": vocoder_fusion.fused_residual_unit,
            "plain": vocoder_fusion.fused_residual_unit_plain}[mode]


def stages(cfg, batch: int, t_in: int, unit=None):
    """[(name, fn(params, x) -> y, input shape (B, T, C))] as the JAX
    script's, the ResidualUnits through `unit`."""
    import torch

    from sparktts_tpu_torch.codec.wave_generator import (
        _decoder_block_apply,
        wave_generator_apply,
    )
    from sparktts_tpu_torch.nn.layers import conv1d_apply, snake_apply

    out = [("conv_in", lambda p, x: conv1d_apply(p["conv_in"], x, padding=3),
            (batch, t_in, cfg.input_channel))]
    t = t_in
    for i, (k, s) in enumerate(zip(cfg.kernel_sizes, cfg.rates)):
        cin = cfg.channels // 2**i

        def blk(p, x, i=i, k=k, s=s):
            return _decoder_block_apply(p["blocks"][i], x, k, s, unit)

        out.append((f"block{i}_x{s}_c{cin}", blk, (batch, t, cin)))
        t *= s
    cout = cfg.channels // 2 ** len(cfg.rates)

    def out_stage(p, x):
        y = snake_apply(p["snake_out"], x)
        return torch.tanh(conv1d_apply(p["conv_out"], y, padding=3))

    out.append(("out", out_stage, (batch, t, cout)))
    out.append(("full", lambda p, x: wave_generator_apply(p, x, cfg, unit),
                (batch, t_in, cfg.input_channel)))
    return out


def flops(cfg, stage_list, name, shape) -> int:
    """MACs*2 for the matmul work of a stage (elementwise excluded): the JAX
    script's `flops`."""
    b, t_in_s, cin = shape
    if name == "conv_in":
        return 2 * b * t_in_s * cin * cfg.channels * 7
    if name == "out":
        return 2 * b * t_in_s * cin * cfg.d_out * 7
    if name == "full":
        return sum(flops(cfg, stage_list, n, s) for n, _, s in stage_list if n != "full")
    i = int(name.split("_")[0][5:])
    k, s = cfg.kernel_sizes[i], cfg.rates[i]
    co = cin // 2
    up = 2 * b * t_in_s * cin * co * k
    res = 3 * (2 * b * t_in_s * s * co * co * (7 + 1))
    return up + res


def unit_flops(cfg, stage_list) -> int:
    """The matmul work of the `full` stage's ResidualUnits alone."""
    total = 0
    for name, _, (b, t, cin) in stage_list:
        if name.startswith("block"):
            co, s = cin // 2, cfg.rates[int(name.split("_")[0][5:])]
            total += 3 * (2 * b * t * s * co * co * (7 + 1))
    return total


def main(argv=None):
    args = parse_args(argv)
    import torch

    from sparktts_tpu_torch.config import WaveGeneratorConfig
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.nn.layers import codec_fp32
    from sparktts_tpu_torch.utils.platform import apply_platform_env, require_device
    from sparktts_tpu_torch.weights import init_wave_generator

    dev = require_device(args.device or apply_platform_env(), "bench_vocoder_torch")
    smi = card_line(dev)
    print(smi, flush=True)
    if args.tiny:
        cfg = WaveGeneratorConfig(**TINY)
        args.t_in = min(args.t_in, 16)
        args.iters = min(args.iters, 2)
        args.reps = min(args.reps, 2)
    else:
        cfg = WaveGeneratorConfig()
    params = init_wave_generator(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_units = 3 * len(cfg.rates)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results, launches = {}, {}
    with torch.inference_mode(), codec_fp32():
        for mode in args.modes.split(","):
            stage_list = stages(cfg, args.batch, args.t_in, unit_fn(mode))
            res = {}
            for name, fn, shape in stage_list:
                def run(x, fn=fn):
                    for _ in range(args.iters):
                        y = fn(params, x)
                    return y

                call = graphs.CapturedCall(run, (torch.zeros(shape, device=dev) + 0.01,))
                times = []
                for _ in range(args.reps):
                    sync()
                    graphs.reset_launches()
                    t0 = time.perf_counter()
                    call.replay()
                    sync()
                    times.append(time.perf_counter() - t0)
                launched = graphs.launches()["fused_residual_unit"]
                del call
                ms = min(times) / args.iters * 1e3
                gf = flops(cfg, stage_list, name, shape) / 1e9
                res[name] = {"ms": ms, "gflop": gf, "tflops": gf / ms if ms > 0 else None}
                print(mode, name, res[name], flush=True)
                if name == "full":
                    launches[mode] = launched / args.iters
                    want = n_units if mode == "kernel" else 0
                    if dev.type == "cuda" and launches[mode] != want:
                        raise AssertionError(f"{mode} full: kernel 3 launched {launches[mode]} "
                                             f"times a call, want {want}")
            results[mode] = res
    bound_ms = 3 * unit_flops(cfg, stages(cfg, args.batch, args.t_in)) / TF32_FLOPS * 1e3
    results["bound"] = {"kernel3_3xtf32_ms": bound_ms,
                        "share_of_kernel_full": (bound_ms / results["kernel"]["full"]["ms"]
                                                 if "kernel" in results else None)}
    results.update(unit_calls_per_full_call=launches, backend=dev.type, card=smi,
                   dims=f"batch {args.batch}, {args.t_in} tokens, fp32 (TF32 off), "
                        f"{args.iters} calls a replay")
    if args.out:
        write_result(args.out, results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
