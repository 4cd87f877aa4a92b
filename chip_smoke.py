#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparktts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the voice-creation path from
   sparktts_tpu_torch/kernels/csrc/ for sm_90a, one nvcc per source, in
   parallel (nvcc's register/shared-memory report goes to chiprun_out/);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes voice creation gives it, within a stated bf16 tolerance, and time
   kernel, plain version and the PyTorch library call that computes the same
   function (scaled_dot_product_attention, a yardstick only);
4. one prefill of the full-width LM (Qwen2.5-0.5B, random weights) with the
   flash kernel and with the plain dense attention: last-position logits
   must agree;
5. voice creation end to end at the full Spark-TTS-0.5B widths through
   SparkTTSPipeline.inference, with every launch counter set to 0 just
   before and read just after: 24 flash launches for the one prefill and 24
   decode launches per decode step; the waveform must be finite, non-empty
   and 320 samples per semantic token.  Then the same request once more in
   parts (generate_tokens, prefill, detokenize) for the time breakdown.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA card, or run
from a directory without the sparktts_tpu_torch package, it exits 2 and
prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

TEXT = "Spark TTS speaks from one H100 card."
VOICE = dict(gender="female", pitch="moderate", speed="moderate")
MAX_NEW_TOKENS = 500
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Kernel vs plain version, both on the card from the same bf16 inputs: the
# plain version also accumulates in fp32, so the two differ by the bf16
# rounding of the output (2^-8 relative, on values of magnitude <= ~4 here)
# plus fp32 summation order.
KERNEL_ATOL = 2e-2
# Last-position logits of the 24-layer bf16 LM, flash kernel vs dense
# attention: the dense path rounds attention probabilities to bf16 before
# P.V (as the JAX package does) and the kernel does not, and bf16 rounding
# differences compound through 24 residual layers.  Held relative to the
# logits' own scale.
LOGITS_REL_TOL = 5e-2


def _time_ms(fn, dev, iters=20, reps=10) -> float:
    """Device milliseconds per call of `fn`: `iters` calls captured in one
    CUDA graph, replayed `reps` times between CUDA events, so the host's
    per-call overhead is not in the number (inputs stay L2-resident, as they
    are on the main path, where each is written just before it is read).
    On the CPU (rehearsal only) a host clock."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * iters)


def _eager_ms(fn, dev, iters=50) -> float:
    """Host-clock milliseconds per eager call, synchronized at the end: what
    one call costs the eager decode loop, host overhead included."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(dev, cfg, t_main: int, start_main: int):
    """Flash prefill kernel vs plain at the main path's shapes; returns its
    kernels-line entry (without launches)."""
    import torch
    import torch.nn.functional as F

    from sparktts_tpu_torch.kernels import flash_attention as fa

    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    scale = d**-0.5
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, t, starts):
        q, k, v = (
            torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
            for h in (hq, hkv, hkv)
        )
        return q, k, v, torch.tensor(starts, dtype=torch.int32, device=dev)

    cases = [(1, t_main, [start_main]), (1, 2 * t_main, [start_main + t_main // 2]),
             (4, 77, [0, 3, 40, 76])]
    max_err = 0.0
    for b, t, starts in cases:
        q, k, v, st = inputs(b, t, starts)
        got = fa.flash_attention_prefill(q, k, v, st, sm_scale=scale).float()
        want = fa.flash_attention_plain(q, k, v, st, sm_scale=scale).float()
        _sync(dev)
        rows = torch.arange(t, device=dev)[None, :] >= st[:, None]  # (B, T) non-pad rows
        err = float((got - want).abs()[rows[:, None, :, None].expand_as(got)].max())
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash kernel: non-finite output at B={b} T={t}")
        print(f"flash_attention_prefill B={b} T={t} starts={starts}: max_abs_err={err:.3e} "
              f"(tol {KERNEL_ATOL})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"flash kernel disagrees with its plain version: {err}")
        max_err = max(max_err, err)

    # timing at the main path's shape
    q, k, v, st = inputs(1, t_main, [start_main])
    kernel = functools.partial(fa.flash_attention_prefill, q, k, v, st, sm_scale=scale)
    plain = functools.partial(fa.flash_attention_plain, q, k, v, st, sm_scale=scale)
    ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
    print(f"flash_attention_prefill B=1 T={t_main}: device {ms:.4f} ms (plain {plain_ms:.4f}); "
          f"eager call {_eager_ms(kernel, dev):.4f} ms (plain {_eager_ms(plain, dev):.4f})")
    row = torch.arange(t_main, device=dev)
    mask = (row[None, :] <= row[:, None]) & (row[None, :] >= start_main)
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                               enable_gqa=True), dev)
    pairs = sum(max(0, t - start_main + 1) for t in range(t_main))  # valid (query, key) pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4
    bound_ms, bound_by = _bound(nbytes, 4 * d * hq * pairs)
    return dict(name="flash_attention_prefill", route="cuda", source=fa.SOURCE,
                replaces=fa.REPLACES, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_decode(dev, cfg, s_main: int, start_main: int, pos_main: int):
    """Decode kernel vs plain on the full stacked cache shape of the main
    path; returns its kernels-line entry (without launches)."""
    import torch
    import torch.nn.functional as F

    from sparktts_tpu_torch.kernels import decode_attention as da

    hq, hkv, d, n_layers = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                            cfg.num_hidden_layers)
    scale = d**-0.5
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(b):
        shape = (n_layers, b, s_main, hkv, d)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        return q, ck, cv

    s = s_main
    cases = [
        (1, [start_main], [pos_main]),
        (8, [0, 5, 9, 60, 0, 1, 63, 40], [s - 1, 100, 9, 70, 1, s - 2, 62, 450]),
    ]
    max_err = 0.0
    for b, starts, poss in cases:
        q, ck, cv = inputs(b)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        po = torch.tensor(poss, dtype=torch.int32, device=dev)
        for layer in (0, n_layers - 1):
            got = da.dense_decode_attention(q, ck, cv, layer, st, po, sm_scale=scale).float()
            want = da.dense_decode_plain(q, ck, cv, layer, st, po, sm_scale=scale).float()
            _sync(dev)
            err = float((got - want).abs().max())
            if not torch.isfinite(got).all():
                raise AssertionError("decode kernel: non-finite output")
            print(f"dense_decode_attention B={b} S={s} layer={layer} windows="
                  f"{[p - a + 1 for a, p in zip(starts, poss)]}: max_abs_err={err:.3e} "
                  f"(tol {KERNEL_ATOL})")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"decode kernel disagrees with its plain version: {err}")
            max_err = max(max_err, err)

    q, ck, cv = inputs(1)
    st = torch.tensor([start_main], dtype=torch.int32, device=dev)
    po = torch.tensor([pos_main], dtype=torch.int32, device=dev)
    layer = n_layers // 2
    kernel = functools.partial(da.dense_decode_attention, q, ck, cv, layer, st, po, sm_scale=scale)
    plain = functools.partial(da.dense_decode_plain, q, ck, cv, layer, st, po, sm_scale=scale)
    ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
    print(f"dense_decode_attention B=1 S={s} window={pos_main - start_main + 1}: device "
          f"{ms:.4f} ms (plain {plain_ms:.4f}); eager call {_eager_ms(kernel, dev):.4f} ms "
          f"(plain {_eager_ms(plain, dev):.4f})")
    kv = (ck[layer].permute(0, 2, 1, 3), cv[layer].permute(0, 2, 1, 3))  # (B, Hkv, S, D) views
    j = torch.arange(s, device=dev)
    mask = ((j >= start_main) & (j <= pos_main))[None, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, *kv, attn_mask=mask, scale=scale,
                                               enable_gqa=True), dev)
    window = pos_main - start_main + 1
    nbytes = 2 * (2 * q.numel() + 2 * window * hkv * d) + 8
    bound_ms, bound_by = _bound(nbytes, 4 * d * hq * window)
    return dict(name="dense_decode_attention", route="cuda", source=da.SOURCE,
                replaces=da.REPLACES, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_lm_prefill(pipe, prompt_ids):
    """Full-width LM prefill with the flash kernel and with the plain dense
    attention; last-position logits must agree."""
    import torch

    from sparktts_tpu_torch.lm.qwen import init_kv_cache, prefill_inputs, qwen_forward

    dev, cfg = pipe.device, pipe.config.llm
    ids, mask = pipe.prompt_inputs(prompt_ids)
    t_pad = ids.shape[1]
    start = torch.tensor([t_pad - len(prompt_ids)], dtype=torch.int32, device=dev)
    logits = {}
    with torch.inference_mode():
        for name in ("kernel", "plain"):
            cache = init_kv_cache(cfg, 1, t_pad, pipe.lm_dtype, dev)
            positions, bias = prefill_inputs(mask, t_pad)
            out, _ = qwen_forward(
                pipe.llm_params, cfg, ids, positions, cache, 0,
                None if name == "kernel" else bias,
                flash_start=start if name == "kernel" else None, logits_last_only=True,
            )
            logits[name] = out[0, -1]
    scale = float(logits["plain"].abs().max())
    err = float((logits["kernel"] - logits["plain"]).abs().max())
    same_top = int(logits["kernel"].argmax()) == int(logits["plain"].argmax())
    print(f"LM prefill (T={t_pad}, {cfg.num_hidden_layers} layers, vocab {cfg.vocab_size}): "
          f"last-position logits max|kernel - plain| = {err:.4e}, max|logit| = {scale:.4e}, "
          f"relative {err / scale:.3e} (tol {LOGITS_REL_TOL}), same argmax: {same_top}")
    if not (math.isfinite(err) and err <= LOGITS_REL_TOL * scale):
        raise AssertionError("LM prefill: flash-kernel logits disagree with plain attention")


def run_main_path(pipe, kernel_modules):
    """Voice creation through SparkTTSPipeline.inference with the launch
    counters set to 0 just before; returns (launches by kernel module,
    summary dict)."""
    import numpy as np
    import torch

    from sparktts_tpu_torch.lm.generate import prefill
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache
    from sparktts_tpu_torch.prompt import (
        build_control_prompt,
        extract_semantic_ids,
        padded_global_tokens,
    )

    dev, n_layers = pipe.device, pipe.config.llm.num_hidden_layers
    fa, da = kernel_modules
    # warm-up with the identical request: first use of each shape builds
    # cuBLAS/cuDNN plans and grows the allocator's pools
    pipe.inference(TEXT, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **VOICE)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    fa.launches = da.launches = 0
    t0 = time.perf_counter()
    wav = pipe.inference(TEXT, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **VOICE)
    _sync(dev)
    total_s = time.perf_counter() - t0
    launches = {"flash_attention_prefill": fa.launches, "dense_decode_attention": da.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")

    # the same request in parts, for the time breakdown
    prompt = build_control_prompt(pipe.tokenizer, TEXT, **VOICE)
    d0 = da.launches
    t0 = time.perf_counter()
    generated = pipe.generate_tokens(prompt, seed=SEED, max_new_tokens=MAX_NEW_TOKENS)
    _sync(dev)
    generate_ms = (time.perf_counter() - t0) * 1e3
    decode_steps = (da.launches - d0) // n_layers

    ids_t, mask_t = pipe.prompt_inputs(prompt)
    t_pad = ids_t.shape[1]
    vs, ex = pipe.guided_constraint()
    cache_len = aligned_cache_len(t_pad + MAX_NEW_TOKENS)

    def one_prefill():
        with torch.inference_mode():
            cache = init_kv_cache(pipe.config.llm, 1, cache_len, pipe.lm_dtype, dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            prefill(pipe.llm_params, pipe.config.llm, ids_t, mask_t, cache, gen, 0.8, 50, 0.95,
                    vocab_slice=vs, extra_ids=ex)
        _sync(dev)

    t0 = time.perf_counter()
    for _ in range(5):
        one_prefill()
    prefill_ms = (time.perf_counter() - t0) * 1e3 / 5

    semantic = extract_semantic_ids(pipe.tokenizer, generated)
    glob = padded_global_tokens(pipe.tokenizer, generated, pipe.config.bicodec.speaker_encoder.token_num)
    t0 = time.perf_counter()
    wav2 = pipe.detokenize(glob, semantic[None, :])
    _sync(dev)
    vocode_ms = (time.perf_counter() - t0) * 1e3

    audio_s = len(wav) / pipe.sample_rate
    summary = dict(
        prompt_tokens=len(prompt), prompt_bucket=t_pad, generated_tokens=int(len(generated)),
        semantic_tokens=int(semantic.size), decode_steps=decode_steps,
        wav_samples=int(len(wav)), audio_s=audio_s, inference_s=total_s,
        rtf=total_s / audio_s if audio_s else float("inf"),
        prefill_ms=prefill_ms, generate_ms=generate_ms,
        decode_ms_per_token=(generate_ms - prefill_ms) / max(decode_steps, 1),
        vocode_ms=vocode_ms, peak_mem_gib=peak_gib,
    )
    print("voice creation:", json.dumps(summary))
    print("launch counters over the inference call:", json.dumps(launches))

    steps_main = launches["dense_decode_attention"] / n_layers
    if launches["flash_attention_prefill"] != n_layers:
        raise AssertionError(f"expected {n_layers} flash launches for one prefill: {launches}")
    if launches["dense_decode_attention"] == 0 or steps_main != int(steps_main):
        raise AssertionError(f"expected {n_layers} decode launches per step: {launches}")
    if not (wav.size > 0 and np.isfinite(wav).all()):
        raise AssertionError("waveform is empty or not finite")
    if len(wav) != semantic.size * 320 or len(wav2) != len(wav):
        raise AssertionError(
            f"waveform of {len(wav)} samples for {semantic.size} semantic tokens (want x320)")
    return launches, summary


def main() -> int:
    if not (REPO / "sparktts_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the sparktts_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sparktts_tpu_torch.kernels import build
    from sparktts_tpu_torch.kernels import decode_attention as da
    from sparktts_tpu_torch.kernels import flash_attention as fa
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.prompt import build_control_prompt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # fp32 stays fp32 (the codec runs in fp32; TF32 would change its numbers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build.build_all(["flash_attention", "decode_attention"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernel_build.log").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in logs.items()))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    pipe = SparkTTSPipeline(device=dev, seed=SEED)
    cfg = pipe.config.llm
    prompt = build_control_prompt(pipe.tokenizer, TEXT, **VOICE)
    t_main = pipe.prompt_inputs(prompt)[0].shape[1]
    start_main = t_main - len(prompt)
    s_main = aligned_cache_len(t_main + MAX_NEW_TOKENS)
    pos_main = t_main + MAX_NEW_TOKENS // 2  # the middle decode step's last key

    entries = [check_flash(dev, cfg, t_main, start_main),
               check_decode(dev, cfg, s_main, start_main, pos_main)]
    check_lm_prefill(pipe, prompt)
    launches, _ = run_main_path(pipe, (fa, da))
    for e in entries:
        e["launches"] = launches[e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
