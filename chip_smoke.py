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
6. voice cloning with the weight-only int8 LM (`quantize_qwen_int8` of the
   same bf16 params, on the card): 24 int8 MLP kernel launches per decode
   step, no int4 launch, the same attention and vocoder counts, a finite
   waveform of 320 samples per semantic token, and its breakdown;
7. voice creation with the int4 LM (`quantize_qwen_int4`, group 128): 96
   int4 matvec launches per decode step (qkv, o, gate/up, down in 24
   layers), none at prefill, no int8 MLP launch;
8. the int8 codec (`quantize_bicodec_int8`): phase 6's tokens vocoded with
   it must stay within 0.05 relative L2 of the fp32 vocode, with no vocoder
   kernel launch (int8 ResidualUnits take the unfused unit);
9. hold each kernel against its plain PyTorch version on the card, at the
   shapes the requests gave it, within a stated tolerance, and time kernel,
   plain version and, where one exists, the PyTorch library call that
   computes the same function (scaled_dot_product_attention, a yardstick
   only): flash prefill at each prompt's bucket and left-pad start, decode
   over each request's cache at its middle and last step's window, both in
   bf16; the vocoder's ResidualUnit in fp32 at the 12 (channels, length,
   dilation) of each request's bucketed vocode and at one ragged length;
   the int8 MLP at 1, 4 and 16 rows and the int4 matvec at the four layer
   shapes, bf16, on the quantized LMs' own weights, timed over all 24
   layers' weights in turn (as a decode step streams them from HBM);
10. one prefill of the full-width LM (Qwen2.5-0.5B, random weights) on each
   request's prompt with the flash kernel and with the plain dense
   attention: last-position logits must agree;
11. one full-width decode step of the int8 and of the int4 LM on the card
   and on the CPU (the same weights moved with .cpu(), each side prefilled
   from the same prompt): guided logits must agree, with the same argmax.

The line before the last is a JSON object with one entry per kernel (its
launches are the sum over the four requests of phases 3, 4, 6 and 7, its
times those of the voice-creation shapes, for the int8 MLP one call at one
row, for the int4 matvec the four calls of one layer at one row); the last
line is {"ok": true, "device": {...}}.  Without a CUDA card, or run from a
directory without the sparktts_tpu_torch package, it exits 2 and prints no
result.
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
# Fused int8 MLP kernel vs plain, bf16, relative to max|plain|: the two sum
# in another order, so a bf16 value of h may round one ulp (2^-8) apart and
# carry into the down projection.
INT8_MLP_REL_TOL = 2e-2
# int4 matvec kernel vs plain, bf16 output, relative to max|plain|: the
# output's bf16 rounding plus fp32 summation order.
INT4_REL_TOL = 1e-2
# int8 codec vs fp32 codec on the same tokens: the JAX package's gate
# (tests/test_codec_quant.py).
CODEC_INT8_REL_L2 = 0.05
INT4_GROUP = 128


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
    (mean of 5), and the vocode of the generated tokens.  Returns (the
    breakdown, the (global, semantic) ids it vocoded)."""
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
    global_ids = global_ids_of(generated)
    t0 = time.perf_counter()
    wav = pipe.detokenize(global_ids, semantic[None, :])
    _sync(dev)
    vocode_ms = (time.perf_counter() - t0) * 1e3
    summary = dict(prompt_tokens=len(prompt), prompt_bucket=int(ids_t.shape[1]),
                   generated_tokens=int(len(generated)), semantic_tokens=int(semantic.size),
                   decode_steps=decode_steps, prefill_ms=prefill_ms, generate_ms=generate_ms,
                   decode_ms_per_token=(generate_ms - prefill_ms) / max(decode_steps, 1),
                   vocode_ms=vocode_ms, wav_samples_in_parts=int(len(wav)))
    return summary, (global_ids, semantic[None, :])


def _check_request(label, pipe, wav, launches, summary, mlp_per_layer=0, int4_per_layer=0):
    """Launch counts of one inference call: per decode step, one decode
    attention launch per layer, plus `mlp_per_layer` int8 MLP and
    `int4_per_layer` int4 matvec launches per layer (none at prefill); the
    finite waveform of 320 samples per semantic token."""
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
    for name, per_layer in (("int8_mlp_matvec", mlp_per_layer), ("int4_matvec", int4_per_layer)):
        if launches[name] != per_layer * n_layers * steps:
            raise AssertionError(f"{label}: {launches[name]} {name} launches, expected "
                                 f"{per_layer} per layer and decode step ({steps:.0f} steps)")
    if not (wav.size > 0 and np.isfinite(wav).all()):
        raise AssertionError(f"{label}: waveform is empty or not finite")
    bc = pipe.config.bicodec
    hop = int(np.prod(bc.decoder.rates) * np.prod(bc.prenet.sample_ratios))  # 320 at full width
    if len(wav) != summary["semantic_tokens"] * hop or summary["wav_samples_in_parts"] != len(wav):
        raise AssertionError(f"{label}: waveform of {len(wav)} samples for "
                             f"{summary['semantic_tokens']} semantic tokens (want x{hop})")


def run_voice_creation(pipe, modules, label="voice creation", **expected):
    """Voice creation end to end; returns (its launch counts, its prompt
    ids, its breakdown, the ids it vocoded).  `expected`: per-layer launch
    counts of the quantized kernels (`_check_request`)."""
    from sparktts_tpu_torch.prompt import build_control_prompt, padded_global_tokens

    wav, launches, total_s, peak_gib = _request(pipe, modules, **VOICE)
    token_num = pipe.config.bicodec.speaker_encoder.token_num
    prompt = build_control_prompt(pipe.tokenizer, TEXT, **VOICE)
    summary, tokens = _breakdown(pipe, modules, prompt, "control",
                                 lambda g: padded_global_tokens(pipe.tokenizer, g, token_num))
    audio_s = len(wav) / pipe.sample_rate
    summary.update(wav_samples=int(len(wav)), audio_s=audio_s, inference_s=total_s,
                   rtf=total_s / audio_s if audio_s else float("inf"), peak_mem_gib=peak_gib)
    _check_request(label, pipe, wav, launches, summary, **expected)
    return launches, prompt, summary, tokens


def run_voice_cloning(pipe, modules, wav_path: Path, label="voice cloning", **expected):
    """Voice cloning end to end from the prompt wav; returns (its launch
    counts, its prompt ids, its breakdown, the ids it vocoded)."""
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
    summary, tokens = _breakdown(pipe, modules, prompt, "clone", lambda _: glob)
    audio_s = len(wav) / pipe.sample_rate
    summary.update(prompt_global_ids=int(glob.shape[1]), prompt_semantic_ids=int(sem.shape[1]),
                   tokenize_ms=tokenize_ms, wav_samples=int(len(wav)), audio_s=audio_s,
                   inference_s=total_s, rtf=total_s / audio_s if audio_s else float("inf"),
                   peak_mem_gib=peak_gib)
    _check_request(label, pipe, wav, launches, summary, **expected)
    return launches, prompt, summary, tokens


def _cpu(tree):
    """A param tree's tensors moved to the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu()


def check_tokenize_on_cpu(pipe, wav_path: Path):
    """The port's audio tokenization on the card and on the CPU (its plain
    path, the same weights moved with .cpu()): ids must agree in at least
    TOKENIZE_AGREEMENT of positions."""
    import numpy as np
    import torch

    from sparktts_tpu_torch.pipeline import codec_tokenize

    glob, sem = pipe.tokenize_audio(wav_path)
    *arrays, true_sem = pipe.tokenize_host_prep(wav_path)
    t0 = time.perf_counter()
    with torch.inference_mode():
        glob_cpu, sem_cpu = codec_tokenize(_cpu(pipe.w2v_params), _cpu(pipe.bicodec_params),
                                           pipe.config, *(torch.from_numpy(a) for a in arrays))
    cpu_s = time.perf_counter() - t0
    glob_cpu, sem_cpu = glob_cpu.numpy(), sem_cpu[:, :true_sem].numpy()
    agree = {"global": float(np.mean(glob == glob_cpu)), "semantic": float(np.mean(sem == sem_cpu))}
    print(f"tokenize card vs CPU ({cpu_s:.1f} s on the CPU): global ids agree at "
          f"{int((glob == glob_cpu).sum())}/{glob.size}, semantic ids at "
          f"{int((sem == sem_cpu).sum())}/{sem.size} (need {TOKENIZE_AGREEMENT})")
    if min(agree.values()) < TOKENIZE_AGREEMENT:
        raise AssertionError(f"tokenize: card and CPU disagree: {agree}")


def check_int8_codec(pipe, modules, tokens):
    """Vocode `tokens` ((global, semantic) ids) with the fp32 codec and with
    its weight-only int8 tree: relative L2 within CODEC_INT8_REL_L2, and no
    vocoder kernel launch in the int8 call."""
    import numpy as np

    from sparktts_tpu_torch.codec.quant import quantize_bicodec_int8, quantized_bytes

    fp32_params = pipe.bicodec_params
    want = pipe.detokenize(*tokens).astype(np.float64)
    pipe.bicodec_params = quantize_bicodec_int8(fp32_params)
    try:
        pipe.detokenize(*tokens)  # warm-up
        _sync(pipe.device)
        vf = modules["fused_residual_unit"]
        before = vf.launches
        t0 = time.perf_counter()
        got = pipe.detokenize(*tokens).astype(np.float64)
        vocode_ms = (time.perf_counter() - t0) * 1e3
        unit_launches = vf.launches - before
        int8_bytes = quantized_bytes(pipe.bicodec_params)
    finally:
        pipe.bicodec_params = fp32_params
    rel = float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))
    print(f"int8 codec: vocode of {tokens[1].shape[1]} semantic tokens {vocode_ms:.2f} ms, "
          f"relative L2 to fp32 {rel:.4e} (gate {CODEC_INT8_REL_L2}), params "
          f"{int8_bytes / 2**20:.1f} MiB (fp32 {quantized_bytes(fp32_params) / 2**20:.1f}), "
          f"vocoder kernel launches {unit_launches}")
    if not (got.shape == want.shape and np.isfinite(got).all() and rel < CODEC_INT8_REL_L2):
        raise AssertionError(f"int8 codec: waveform off the fp32 one (relative L2 {rel})")
    if unit_launches != 0:
        raise AssertionError("int8 codec: an int8 ResidualUnit went to the fp32 vocoder kernel")


def _rotating(fns):
    """One callable that calls fns[0], fns[1], ... in turn: timed over the
    24 layers' weights, a graph of 24 calls streams them from HBM as a
    decode step does (one layer's 13 MB would stay in the 50 MB L2)."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()

    return call


def _check_close(label, got, want, rel_tol):
    import torch

    _sync(got.device)
    err, scale = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    line = (f"{label}: max_abs_err={err:.3e}, max|plain|={scale:.3e}, relative "
            f"{err / scale:.3e} (tol {rel_tol})")
    print(line)
    if not (bool(torch.isfinite(got).all()) and err <= rel_tol * scale):
        raise AssertionError(f"kernel disagrees with its plain version: {line}")
    return err


def check_int8_mlp(dev, int8_layers):
    """The fused int8 MLP kernel vs its plain version at 1, 4 and 16 rows on
    the int8 LM's own layers (bf16 x), plus a ragged intermediate width;
    each row count timed over the 24 layers.  Returns the kernels-line
    entry (without launches) with the times of one row."""
    import torch

    from sparktts_tpu_torch.kernels import int8_mlp as i8

    gen = torch.Generator(device=dev).manual_seed(4)
    weights = [(lay["gateup"]["w_q"], lay["gateup"]["scale"], lay["down"]["w_q"],
                lay["down"]["scale"]) for lay in int8_layers]
    k, i = weights[0][2].shape[1], weights[0][2].shape[0]
    max_err, timed = 0.0, {}
    for r in (1, 4, 16):
        x = torch.randn((r, k), generator=gen, device=dev).to(torch.bfloat16)
        for w in (weights[0], weights[-1]):
            max_err = max(max_err, _check_close(f"int8_mlp_matvec R={r} K={k} I={i}",
                                                i8.int8_mlp_matvec(x, *w),
                                                i8.int8_mlp_matvec_plain(x, *w), INT8_MLP_REL_TOL))
        ms = _time_ms(_rotating([functools.partial(i8.int8_mlp_matvec, x, *w) for w in weights]),
                      dev, iters=len(weights), reps=10)
        plain_ms = _time_ms(_rotating([functools.partial(i8.int8_mlp_matvec_plain, x, *w)
                                       for w in weights]), dev, iters=len(weights), reps=3)
        nbytes = 3 * i * k + 4 * (2 * i + k) + 2 * 2 * r * k  # int8 weights, scales, x in, out
        bound_ms, bound_by = _bound(nbytes, 6 * r * k * i)
        print(f"int8_mlp_matvec R={r}: device {ms:.4f} ms per call over {len(weights)} layers' "
              f"weights (plain {plain_ms:.4f}, bound {bound_ms:.4f} by {bound_by}, "
              f"{nbytes / ms / 1e6:.1f} GB/s)")
        timed[r] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    # a ragged intermediate width (no 32- or 256-column tiling) at 3 rows
    g = torch.Generator(device=dev).manual_seed(5)
    i_r = 1000
    gu = torch.randint(-127, 128, (k, 2 * i_r), generator=g, device=dev, dtype=torch.int8)
    dq = torch.randint(-127, 128, (i_r, k), generator=g, device=dev, dtype=torch.int8)
    gs = 1e-3 * (1 + torch.rand(2 * i_r, generator=g, device=dev))
    ds = 1e-3 * (1 + torch.rand(k, generator=g, device=dev))
    x = torch.randn((3, k), generator=g, device=dev).to(torch.bfloat16)
    max_err = max(max_err, _check_close(f"int8_mlp_matvec R=3 K={k} I={i_r} (ragged)",
                                        i8.int8_mlp_matvec(x, gu, gs, dq, ds),
                                        i8.int8_mlp_matvec_plain(x, gu, gs, dq, ds),
                                        INT8_MLP_REL_TOL))
    return dict(name="int8_mlp_matvec", route="cuda", source=i8.SOURCE, replaces=i8.REPLACES,
                max_abs_err=max_err, library_ms=None, **timed[1])


def check_int4(dev, int4_layers):
    """The int4 matvec kernel vs its plain version at the four layer shapes
    of the int4 LM (its own weights, B = 1), down at B = 32 and one ragged
    `out`; each B = 1 shape timed over the 24 layers.  Returns the
    kernels-line entry (without launches): times summed over one layer's
    four calls at B = 1."""
    import torch

    from sparktts_tpu_torch.kernels import int4_matmul as i4

    gen = torch.Generator(device=dev).manual_seed(6)
    max_err = 0.0
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for name in ("qkv", "o", "gateup", "down"):
        weights = [(lay[name]["w_p4"], lay[name]["gscale"]) for lay in int4_layers]
        (half, d_out), groups = weights[0][0].shape, weights[0][1].shape[0]
        batches = (1, 32) if name == "down" else (1,)
        for b in batches:
            x = torch.randn((b, 2 * half), generator=gen, device=dev).to(torch.bfloat16)
            for w in (weights[0], weights[-1]):
                max_err = max(max_err, _check_close(
                    f"int4_matvec {name} B={b} in={2 * half} out={d_out} groups={groups}",
                    i4.int4_matvec(x, *w), i4.int4_matvec_plain(x, *w), INT4_REL_TOL))
            ms = _time_ms(_rotating([functools.partial(i4.int4_matvec, x, *w) for w in weights]),
                          dev, iters=len(weights), reps=10)
            plain_ms = _time_ms(_rotating([functools.partial(i4.int4_matvec_plain, x, *w)
                                           for w in weights]), dev, iters=len(weights), reps=3)
            nbytes = half * d_out + 4 * groups * d_out + 2 * b * (2 * half + d_out)
            bound_ms, bound_by = _bound(nbytes, 4 * b * half * d_out)
            print(f"int4_matvec {name} B={b}: device {ms:.4f} ms per call over {len(weights)} "
                  f"layers' weights (plain {plain_ms:.4f}, bound {bound_ms:.5f} by {bound_by}, "
                  f"{nbytes / ms / 1e6:.1f} GB/s)")
            if b == 1:
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total["bound_ms"] += bound_ms
    g = torch.Generator(device=dev).manual_seed(7)
    packed = torch.randint(-128, 128, (448, 1000), generator=g, device=dev, dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((7, 1000), generator=g, device=dev))
    x = torch.randn((3, 896), generator=g, device=dev).to(torch.bfloat16)
    max_err = max(max_err, _check_close("int4_matvec B=3 in=896 out=1000 (ragged)",
                                        i4.int4_matvec(x, packed, gscale),
                                        i4.int4_matvec_plain(x, packed, gscale), INT4_REL_TOL))
    print(f"int4_matvec, one layer's four calls at B=1: device {total['ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms")
    return dict(name="int4_matvec", route="cuda", source=i4.SOURCE, replaces=i4.REPLACES,
                max_abs_err=max_err, bound_by="bytes", library_ms=None, **total)


def check_decode_step_on_cpu(pipe, params, label, prompt, mode):
    """One full-width decode step of `params` (a quantized LM) on the card,
    through its kernels, and on the CPU, through the plain versions (the
    same weights moved with .cpu()); each side prefills its own cache from
    `prompt` first.  Guided logits must agree within LOGITS_REL_TOL of the
    largest logit, with the same argmax."""
    import torch

    from sparktts_tpu_torch.kernels import int4_matmul as i4
    from sparktts_tpu_torch.kernels import int8_mlp as i8
    from sparktts_tpu_torch.lm.qwen import (
        aligned_cache_len,
        init_kv_cache,
        prefill_positions,
        qwen_forward,
    )

    cfg = pipe.config.llm
    ids, mask = (t.cpu() for t in pipe.prompt_inputs(prompt))
    t_pad = ids.shape[1]
    vocab_slice, extra_ids = pipe.guided_constraint(mode)
    start = (t_pad - mask.sum(1)).to(torch.int32)
    token = torch.tensor([[pipe.tokenizer.semantic_base + 7]])
    logits, launches = {}, {}
    t0 = time.perf_counter()
    for side, dev, p in (("card", pipe.device, params), ("cpu", torch.device("cpu"), _cpu(params))):
        with torch.inference_mode():
            cache = init_kv_cache(cfg, 1, aligned_cache_len(t_pad + 1), pipe.lm_dtype, dev)
            qwen_forward(p, cfg, ids.to(dev), prefill_positions(mask).to(dev), cache, 0, None,
                         flash_start=start.to(dev), vocab_slice=vocab_slice, extra_ids=extra_ids,
                         logits_last_only=True)
            counts = (i8.launches, i4.launches)
            out, _ = qwen_forward(
                p, cfg, token.to(dev), mask.sum(1, keepdim=True).to(dev), cache, t_pad, None,
                decode_window=(start.to(dev), torch.full_like(start, t_pad).to(dev)),
                vocab_slice=vocab_slice, extra_ids=extra_ids,
            )
            launches[side] = (i8.launches - counts[0], i4.launches - counts[1])
        logits[side] = out[0, -1].float().cpu()
    card, cpu = logits["card"], logits["cpu"]
    scale, err = float(cpu.abs().max()), float((card - cpu).abs().max())
    same_top = int(card.argmax()) == int(cpu.argmax())
    print(f"{label} decode step, card vs CPU ({time.perf_counter() - t0:.1f} s; card launches "
          f"int8_mlp/int4 {launches['card']}): guided logits max|card - cpu| = {err:.4e}, "
          f"max|logit| = {scale:.4e}, relative {err / scale:.3e} (tol {LOGITS_REL_TOL}), "
          f"same argmax: {same_top}")
    if not (math.isfinite(err) and err <= LOGITS_REL_TOL * scale and same_top):
        raise AssertionError(f"{label}: the decode step on the card disagrees with the CPU")
    if launches["card"] == (0, 0):
        raise AssertionError(f"{label}: the card's decode step launched no quantized kernel")


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
    from sparktts_tpu_torch.kernels import int4_matmul as i4
    from sparktts_tpu_torch.kernels import int8_mlp as i8
    from sparktts_tpu_torch.kernels import vocoder_fusion as vf
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int4, quantize_qwen_int8
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, unstack_layers
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
    logs = build.build_all(["flash_attention", "decode_attention", "vocoder_fusion", "int8_mlp",
                            "int4_matmul"])
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
               "fused_residual_unit": vf, "int8_mlp_matvec": i8, "int4_matvec": i4}
    creation = run_voice_creation(pipe, modules)
    wav_path = make_prompt_wav(OUT_DIR / "clone_prompt.wav")
    cloning = run_voice_cloning(pipe, modules, wav_path)
    check_tokenize_on_cpu(pipe, wav_path)

    # the weight-only quantized LMs, quantized on the card from the same bf16
    # params, through the same entry point
    bf16_params = pipe.llm_params
    int8_params = quantize_qwen_int8(bf16_params)
    int4_params = quantize_qwen_int4(bf16_params, group=INT4_GROUP)
    pipe.llm_params = int8_params
    cloning_int8 = run_voice_cloning(pipe, modules, wav_path, label="voice cloning, int8 LM",
                                     mlp_per_layer=1)
    pipe.llm_params = int4_params
    creation_int4 = run_voice_creation(pipe, modules, label="voice creation, int4 LM",
                                       int4_per_layer=4)
    pipe.llm_params = bf16_params
    check_int8_codec(pipe, modules, cloning_int8[3])

    # every kernel at the shapes the requests gave it (creation first)
    runs = [summary for _, _, summary, _ in (creation, cloning)]
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
    entries.append(check_int8_mlp(dev, unstack_layers(int8_params["layers"])))
    entries.append(check_int4(dev, unstack_layers(int4_params["layers"])))
    for _, prompt, _, _ in (creation, cloning):
        check_lm_prefill(pipe, prompt)
    check_decode_step_on_cpu(pipe, int8_params, "int8 LM", creation[1], "control")
    check_decode_step_on_cpu(pipe, int4_params, "int4 LM", creation[1], "control")
    requests = (creation, cloning, cloning_int8, creation_int4)
    for e in entries:
        e["launches"] = sum(r[0][e["name"]] for r in requests)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
