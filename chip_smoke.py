#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparktts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the two main paths from
   sparktts_tpu_torch/kernels/csrc/ for sm_90a, one nvcc per source, in
   parallel (nvcc's register/shared-memory report goes to chiprun_out/);
3. voice creation end to end at the full Spark-TTS-0.5B widths through
   SparkTTSPipeline.inference, with every launch counter set to 0 just
   before and read just after: 24 flash launches for the one prefill, 24
   decode launches per decode step and 12 vocoder unit calls (each two
   CUDA launches) for the one vocode; the waveform must be finite and 320
   samples per semantic token.  Then the same request once more in parts
   for the time breakdown;
4. voice cloning the same way, from a 6 s prompt wav made here from a seed
   (written to the output directory) with its transcript: the same launch
   counts, 32 global and 299 semantic prompt ids in range, then the
   breakdown (tokenize, prefill at the clone prompt's bucket, decode,
   vocode);
5. the prompt wav's tokenization on the card and on the CPU (the same
   weights): ids must agree in at least 95% of positions;
6. hold each kernel against its plain PyTorch version on the card, at the
   shapes each request of phases 3 and 4 gave it, within a stated
   tolerance, and time kernel, plain version and, where one exists, the
   PyTorch library call that computes the same function
   (scaled_dot_product_attention, a yardstick only): flash prefill at each
   prompt's bucket and left-pad start, decode over each request's cache at
   its middle and last step's window, both in bf16; the vocoder's
   ResidualUnit in fp32 at the 12 (channels, length, dilation) of each
   request's bucketed vocode and at one ragged length;
7. one prefill of the full-width LM (Qwen2.5-0.5B, random weights) on each
   request's prompt with the flash kernel and with the plain dense
   attention: last-position logits must agree.

The line before the last is a JSON object with one entry per kernel (its
launches are the sum over the runs of phases 3 and 4, its times those of
the voice-creation shapes); the last line is
{"ok": true, "device": {...}}.  Without a CUDA card, or run from a directory
without the sparktts_tpu_torch package, it exits 2 and prints no result.
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor FLOP/s,
# fp32 FLOP/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

PROMPT_TEXT = "This is the voice to clone, six seconds of it."
PROMPT_SECONDS = 6.0
VOCODER_UNITS = 12  # ResidualUnit calls per vocode: 4 decoder blocks x 3 dilations

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
# ResidualUnit kernel vs plain version, both fp32 with TF32 off: they differ
# only in the order of the 7C + C-term sums.
VOCODER_REL_TOL = 1e-4
# Tokenize on the card vs on the CPU: near-ties of the FVQ argmax and the FSQ
# rounding may flip a few ids under another summation order; a layout bug
# agrees almost nowhere.
TOKENIZE_AGREEMENT = 0.95


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


def _bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(dev, cfg, mains):
    """Flash prefill kernel vs plain at each main path's (T, start), given
    in `mains`, plus a longer and a batched ragged case; each main shape is
    timed.  Returns the kernels-line entry (without launches) with the
    times of the first main shape."""
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

    t0, start0 = mains[0]
    cases = [(1, t, [start]) for t, start in mains]
    cases += [(1, 2 * t0, [start0 + t0 // 2]), (4, 77, [0, 3, 40, 76])]
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

    timed = []
    for t_main, start_main in mains:
        q, k, v, st = inputs(1, t_main, [start_main])
        kernel = functools.partial(fa.flash_attention_prefill, q, k, v, st, sm_scale=scale)
        plain = functools.partial(fa.flash_attention_plain, q, k, v, st, sm_scale=scale)
        ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
        row = torch.arange(t_main, device=dev)
        mask = (row[None, :] <= row[:, None]) & (row[None, :] >= start_main)
        library_ms = _time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                                   enable_gqa=True), dev)
        pairs = sum(max(0, t - start_main + 1) for t in range(t_main))  # valid (query, key) pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4
        bound_ms, bound_by = _bound(nbytes, 4 * d * hq * pairs)
        print(f"flash_attention_prefill B=1 T={t_main} start={start_main}: device {ms:.4f} ms "
              f"(plain {plain_ms:.4f}, SDPA {library_ms:.4f}, bound {bound_ms:.3e} by {bound_by}); "
              f"eager call {_eager_ms(kernel, dev):.4f} ms (plain {_eager_ms(plain, dev):.4f})")
        timed.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms))
    return dict(name="flash_attention_prefill", route="cuda", source=fa.SOURCE,
                replaces=fa.REPLACES, max_abs_err=max_err, **timed[0])


def check_decode(dev, cfg, mains):
    """Decode kernel vs plain on the full stacked cache of each main path,
    given in `mains` as (cache length S, start, prompt bucket T, decode
    steps): at the middle and the last decode step's window, plus a batch of
    mixed windows.  The middle step of each main path is timed.  Returns the
    kernels-line entry (without launches) with the times of the first."""
    import torch
    import torch.nn.functional as F

    from sparktts_tpu_torch.kernels import decode_attention as da

    hq, hkv, d, n_layers = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                            cfg.num_hidden_layers)
    scale = d**-0.5
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(b, s):
        shape = (n_layers, b, s, hkv, d)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        return q, ck, cv

    # decode step k attends to keys [start, T + k]
    mid = [(s, start, t + steps // 2) for s, start, t, steps in mains]
    cases = [(s, [start], [pos]) for s, start, pos in mid]
    cases += [(s, [start], [t + steps - 1]) for s, start, t, steps in mains]
    s0 = mains[0][0]
    cases.append((s0, [0, 5, 9, 60, 0, 1, 63, 40], [s0 - 1, 100, 9, 70, 1, s0 - 2, 62, 450]))
    max_err = 0.0
    for s, starts, poss in cases:
        b = len(starts)
        q, ck, cv = inputs(b, s)
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

    timed = []
    for s, start_main, pos_main in mid:
        q, ck, cv = inputs(1, s)
        st = torch.tensor([start_main], dtype=torch.int32, device=dev)
        po = torch.tensor([pos_main], dtype=torch.int32, device=dev)
        layer = n_layers // 2
        kernel = functools.partial(da.dense_decode_attention, q, ck, cv, layer, st, po,
                                   sm_scale=scale)
        plain = functools.partial(da.dense_decode_plain, q, ck, cv, layer, st, po, sm_scale=scale)
        ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
        kv = (ck[layer].permute(0, 2, 1, 3), cv[layer].permute(0, 2, 1, 3))  # (B, Hkv, S, D)
        j = torch.arange(s, device=dev)
        mask = ((j >= start_main) & (j <= pos_main))[None, None, None, :]
        q4 = q[:, :, None, :]
        library_ms = _time_ms(
            lambda: F.scaled_dot_product_attention(q4, *kv, attn_mask=mask, scale=scale,
                                                   enable_gqa=True), dev)
        window = pos_main - start_main + 1
        nbytes = 2 * (2 * q.numel() + 2 * window * hkv * d) + 8
        bound_ms, bound_by = _bound(nbytes, 4 * d * hq * window)
        print(f"dense_decode_attention B=1 S={s} window={window}: device {ms:.4f} ms "
              f"(plain {plain_ms:.4f}, SDPA {library_ms:.4f}, bound {bound_ms:.3e} by {bound_by}); "
              f"eager call {_eager_ms(kernel, dev):.4f} ms (plain {_eager_ms(plain, dev):.4f})")
        timed.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms))
    return dict(name="dense_decode_attention", route="cuda", source=da.SOURCE,
                replaces=da.REPLACES, max_abs_err=max_err, **timed[0])


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


def check_vocoder(dev, wg_cfg, token_counts):
    """The ResidualUnit kernel vs its plain version at the 12 (C, T,
    dilation) of one full-width vocode of each of `token_counts` (semantic
    tokens as the vocoder gets them, bucketed), plus a ragged T, each vocode
    timed.  Returns the kernels-line entry (without launches); its ms,
    plain_ms and bound_ms are sums over the 12 unit calls of the vocode of
    the first count."""
    import torch

    from sparktts_tpu_torch.codec.wave_generator import DILATIONS
    from sparktts_tpu_torch.kernels import vocoder_fusion as vf

    gen = torch.Generator(device=dev).manual_seed(3)

    def unit(c):
        def rnd(*shape, scale=1.0, shift=0.0):
            return scale * torch.randn(shape, generator=gen, device=dev) + shift

        return {"snake1": {"alpha": 0.5 + torch.rand(c, generator=gen, device=dev)},
                "conv1": {"w": rnd(7, c, c, scale=0.02), "b": rnd(c, scale=0.1)},
                "snake2": {"alpha": 0.5 + torch.rand(c, generator=gen, device=dev)},
                "conv2": {"w": rnd(1, c, c, scale=0.02), "b": rnd(c, scale=0.1)}}

    def vocode_shapes(n_tokens):
        shapes, t = [], n_tokens
        for i, rate in enumerate(wg_cfg.rates):
            t *= rate
            shapes.append((wg_cfg.channels // 2 ** (i + 1), t))
        return shapes

    cases = [(n, c, t, d) for n in token_counts for c, t in vocode_shapes(n) for d in DILATIONS]
    cases.append((None, 192, 4321, 9))  # ragged, off the path
    max_err = 0.0
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0) for n in token_counts}
    bound_by = {"bytes": 0.0, "operations": 0.0}  # bound ms by what bounds each unit
    for n, c, t, dil in cases:
        p = unit(c)
        x = torch.randn((1, t, c), generator=gen, device=dev)
        got = vf.fused_residual_unit(p, x, dil)
        want = vf.fused_residual_unit_plain(p, x, dil)
        _sync(dev)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        line = (f"fused_residual_unit C={c} T={t} dilation={dil}: max_abs_err={err:.3e}, "
                f"max|plain|={scale:.3e}, relative {err / scale:.3e} (tol {VOCODER_REL_TOL})")
        if not (bool(torch.isfinite(got).all()) and err <= VOCODER_REL_TOL * scale):
            raise AssertionError(f"vocoder kernel disagrees with its plain version: {line}")
        max_err = max(max_err, err)
        if n is not None:
            ms = _time_ms(lambda: vf.fused_residual_unit(p, x, dil), dev, iters=3, reps=3)
            plain_ms = _time_ms(lambda: vf.fused_residual_unit_plain(p, x, dil), dev, iters=3,
                                reps=3)
            nbytes = 4 * (2 * t * c + 8 * c * c + 4 * c)  # x in, out, both kernels, biases, alphas
            bound_ms, by = _bound(nbytes, 16 * t * c * c, FP32_FLOPS)
            if n == token_counts[0]:
                bound_by[by] += bound_ms
            line += f"; device {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f})"
            totals[n]["ms"] += ms
            totals[n]["plain_ms"] += plain_ms
            totals[n]["bound_ms"] += bound_ms
        print(line)
    for n, total in totals.items():
        print(f"fused_residual_unit over one {n}-token vocode "
              f"({len(vocode_shapes(n)) * len(DILATIONS)} unit calls): "
              f"device {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
              f"bound {total['bound_ms']:.4f} ms")
    return dict(name="fused_residual_unit", route="cuda", source=vf.SOURCE, replaces=vf.REPLACES,
                max_abs_err=max_err, bound_by=max(bound_by, key=bound_by.get), library_ms=None,
                **totals[token_counts[0]])


def make_prompt_wav(path: Path, seconds: float = PROMPT_SECONDS, sr: int = 16000) -> Path:
    """A voice-like test signal from SEED: four harmonics of a 140 Hz
    fundamental with slow vibrato, under a syllable-rate envelope, plus low
    noise; written as 16-bit PCM with the port's `write_wav`."""
    import numpy as np

    from sparktts_tpu_torch.io.audio import write_wav

    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(140.0 * (1 + 0.05 * np.sin(2 * np.pi * 0.5 * t))) / sr
    voice = sum(a * np.sin(k * phase) for k, a in enumerate((0.5, 0.25, 0.12, 0.06), start=1))
    envelope = 0.2 + 0.8 * np.sin(np.pi * 3.0 * t) ** 2
    write_wav(path, 0.4 * envelope * voice + 0.003 * rng.standard_normal(t.size), sr)
    return path


def _request(pipe, modules, **request):
    """One SparkTTSPipeline.inference call after a warm-up with the identical
    request (first use of each shape builds cuBLAS/cuDNN plans and grows the
    allocator's pools), with every launch counter set to 0 just before and
    read just after; returns (wav, launches by kernel, seconds, peak GiB)."""
    import torch

    dev = pipe.device
    pipe.inference(TEXT, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **request)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    wav = pipe.inference(TEXT, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **request)
    _sync(dev)
    total_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    return wav, launches, total_s, peak_gib


def _breakdown(pipe, modules, prompt, mode: str, global_ids_of):
    """The request in parts: generate, prefill alone at the prompt's bucket
    (mean of 5), and the vocode of the generated tokens."""
    import torch

    from sparktts_tpu_torch.lm.generate import prefill
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache
    from sparktts_tpu_torch.prompt import extract_semantic_ids

    dev, n_layers = pipe.device, pipe.config.llm.num_hidden_layers
    da = modules["dense_decode_attention"]
    d0 = da.launches
    t0 = time.perf_counter()
    generated = pipe.generate_tokens(prompt, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, mode=mode)
    _sync(dev)
    generate_ms = (time.perf_counter() - t0) * 1e3
    decode_steps = (da.launches - d0) // n_layers

    ids_t, mask_t = pipe.prompt_inputs(prompt)
    vs, ex = pipe.guided_constraint(mode)
    cache_len = aligned_cache_len(ids_t.shape[1] + MAX_NEW_TOKENS)

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
    t0 = time.perf_counter()
    wav = pipe.detokenize(global_ids_of(generated), semantic[None, :])
    _sync(dev)
    vocode_ms = (time.perf_counter() - t0) * 1e3
    return dict(prompt_tokens=len(prompt), prompt_bucket=int(ids_t.shape[1]),
                generated_tokens=int(len(generated)), semantic_tokens=int(semantic.size),
                decode_steps=decode_steps, prefill_ms=prefill_ms, generate_ms=generate_ms,
                decode_ms_per_token=(generate_ms - prefill_ms) / max(decode_steps, 1),
                vocode_ms=vocode_ms, wav_samples_in_parts=int(len(wav)))


def _check_request(label, pipe, wav, launches, summary):
    import numpy as np

    n_layers = pipe.config.llm.num_hidden_layers
    print(f"{label}:", json.dumps(summary))
    print(f"launch counters over the {label} inference call:", json.dumps(launches))
    steps = launches["dense_decode_attention"] / n_layers
    if launches["flash_attention_prefill"] != n_layers:
        raise AssertionError(f"{label}: expected {n_layers} flash launches for one prefill")
    if launches["dense_decode_attention"] == 0 or steps != int(steps):
        raise AssertionError(f"{label}: expected {n_layers} decode launches per step")
    if launches["fused_residual_unit"] != VOCODER_UNITS:
        raise AssertionError(f"{label}: expected {VOCODER_UNITS} vocoder launches for one vocode")
    if not (wav.size > 0 and np.isfinite(wav).all()):
        raise AssertionError(f"{label}: waveform is empty or not finite")
    bc = pipe.config.bicodec
    hop = int(np.prod(bc.decoder.rates) * np.prod(bc.prenet.sample_ratios))  # 320 at full width
    if len(wav) != summary["semantic_tokens"] * hop or summary["wav_samples_in_parts"] != len(wav):
        raise AssertionError(f"{label}: waveform of {len(wav)} samples for "
                             f"{summary['semantic_tokens']} semantic tokens (want x{hop})")


def run_voice_creation(pipe, modules):
    """Voice creation end to end; returns (its launch counts, its prompt
    ids, its breakdown)."""
    from sparktts_tpu_torch.prompt import build_control_prompt, padded_global_tokens

    wav, launches, total_s, peak_gib = _request(pipe, modules, **VOICE)
    token_num = pipe.config.bicodec.speaker_encoder.token_num
    prompt = build_control_prompt(pipe.tokenizer, TEXT, **VOICE)
    summary = _breakdown(pipe, modules, prompt, "control",
                         lambda g: padded_global_tokens(pipe.tokenizer, g, token_num))
    audio_s = len(wav) / pipe.sample_rate
    summary.update(wav_samples=int(len(wav)), audio_s=audio_s, inference_s=total_s,
                   rtf=total_s / audio_s if audio_s else float("inf"), peak_mem_gib=peak_gib)
    _check_request("voice creation", pipe, wav, launches, summary)
    return launches, prompt, summary


def run_voice_cloning(pipe, modules, wav_path: Path):
    """Voice cloning end to end from the prompt wav; returns (its launch
    counts, its prompt ids, its breakdown)."""
    import numpy as np

    from sparktts_tpu_torch.nn.wav2vec2 import feature_lengths
    from sparktts_tpu_torch.prompt import build_clone_prompt

    request = dict(prompt_speech_path=wav_path, prompt_text=PROMPT_TEXT)
    wav, launches, total_s, peak_gib = _request(pipe, modules, **request)
    tok, cfg = pipe.tokenizer, pipe.config
    t0 = time.perf_counter()
    for _ in range(3):
        glob, sem = pipe.tokenize_audio(wav_path)
    _sync(pipe.device)
    tokenize_ms = (time.perf_counter() - t0) * 1e3 / 3
    n_sem = feature_lengths(cfg.wav2vec2, int(PROMPT_SECONDS * pipe.sample_rate))
    n_sem //= int(np.prod(cfg.bicodec.encoder.sample_ratios))
    if glob.shape != (1, cfg.bicodec.speaker_encoder.token_num) or sem.shape != (1, n_sem):
        raise AssertionError(f"voice cloning: prompt ids of shapes {glob.shape} {sem.shape}")
    if not (0 <= glob.min() and glob.max() < tok.n_global and 0 <= sem.min()
            and sem.max() < tok.n_semantic):
        raise AssertionError("voice cloning: prompt ids out of range")
    prompt = build_clone_prompt(tok, TEXT, glob, sem, PROMPT_TEXT)
    summary = _breakdown(pipe, modules, prompt, "clone", lambda _: glob)
    audio_s = len(wav) / pipe.sample_rate
    summary.update(prompt_global_ids=int(glob.shape[1]), prompt_semantic_ids=int(sem.shape[1]),
                   tokenize_ms=tokenize_ms, wav_samples=int(len(wav)), audio_s=audio_s,
                   inference_s=total_s, rtf=total_s / audio_s if audio_s else float("inf"),
                   peak_mem_gib=peak_gib)
    _check_request("voice cloning", pipe, wav, launches, summary)
    return launches, prompt, summary


def check_tokenize_on_cpu(pipe, wav_path: Path):
    """The port's audio tokenization on the card and on the CPU (its plain
    path, the same weights moved with .cpu()): ids must agree in at least
    TOKENIZE_AGREEMENT of positions."""
    import numpy as np
    import torch

    from sparktts_tpu_torch.pipeline import codec_tokenize

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        return tree.cpu()

    glob, sem = pipe.tokenize_audio(wav_path)
    *arrays, true_sem = pipe.tokenize_host_prep(wav_path)
    t0 = time.perf_counter()
    with torch.inference_mode():
        glob_cpu, sem_cpu = codec_tokenize(cpu(pipe.w2v_params), cpu(pipe.bicodec_params),
                                           pipe.config, *(torch.from_numpy(a) for a in arrays))
    cpu_s = time.perf_counter() - t0
    glob_cpu, sem_cpu = glob_cpu.numpy(), sem_cpu[:, :true_sem].numpy()
    agree = {"global": float(np.mean(glob == glob_cpu)), "semantic": float(np.mean(sem == sem_cpu))}
    print(f"tokenize card vs CPU ({cpu_s:.1f} s on the CPU): global ids agree at "
          f"{int((glob == glob_cpu).sum())}/{glob.size}, semantic ids at "
          f"{int((sem == sem_cpu).sum())}/{sem.size} (need {TOKENIZE_AGREEMENT})")
    if min(agree.values()) < TOKENIZE_AGREEMENT:
        raise AssertionError(f"tokenize: card and CPU disagree: {agree}")


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
    from sparktts_tpu_torch.kernels import vocoder_fusion as vf
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len
    from sparktts_tpu_torch.pipeline import VOCODE_BUCKET, SparkTTSPipeline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # fp32 stays fp32 for the plain versions this script calls directly (the
    # codec's entry points pin it themselves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build.build_all(["flash_attention", "decode_attention", "vocoder_fusion"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernel_build.log").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in logs.items()))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    pipe = SparkTTSPipeline(device=dev, seed=SEED)
    modules = {"flash_attention_prefill": fa, "dense_decode_attention": da,
               "fused_residual_unit": vf}
    creation = run_voice_creation(pipe, modules)
    wav_path = make_prompt_wav(OUT_DIR / "clone_prompt.wav")
    cloning = run_voice_cloning(pipe, modules, wav_path)
    check_tokenize_on_cpu(pipe, wav_path)

    # every kernel at the shapes the two requests gave it (creation first)
    runs = [summary for _, _, summary in (creation, cloning)]
    starts = [r["prompt_bucket"] - r["prompt_tokens"] for r in runs]
    cfg = pipe.config.llm
    entries = [
        check_flash(dev, cfg, [(r["prompt_bucket"], a) for r, a in zip(runs, starts)]),
        check_decode(dev, cfg, [(aligned_cache_len(r["prompt_bucket"] + MAX_NEW_TOKENS), a,
                                 r["prompt_bucket"], r["decode_steps"])
                                for r, a in zip(runs, starts)]),
        check_vocoder(dev, pipe.config.bicodec.decoder,
                      list(dict.fromkeys(-(-r["semantic_tokens"] // VOCODE_BUCKET) * VOCODE_BUCKET
                                         for r in runs))),  # the vocoder's bucketed lengths
    ]
    for _, prompt, _ in (creation, cloning):
        check_lm_prefill(pipe, prompt)
    for e in entries:
        e["launches"] = creation[0][e["name"]] + cloning[0][e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
