#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparktts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error.  Every
decode loop runs as replays of captured decode units (CUDA graphs,
`sparktts_tpu_torch/lm/graphs.py`); a launch count is the wrappers' eager
launches plus each unit's replays times its launches a unit (its warm-up
and capture are set-up, counted apart).

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the main paths from
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
   computes the same function (scaled_dot_product_attention,
   torch._weight_int4pack_mm; yardsticks only): flash prefill at each
   prompt's bucket and left-pad start, decode over each request's cache at
   its middle and last step's window (also against
   `dense_decode_split_plain`, the CPU model of its split, run on the
   card), both in bf16 and each bit-equal over two calls; the decode kernel
   on two streams at once (each merging on its own arrival counters); the
   vocoder's ResidualUnit in fp32 at the 12 (channels, length, dilation) of
   each request's bucketed vocode and at one ragged length (also against
   `residual_unit_3xtf32_plain`, the CPU model of its three products, run on
   the card), two calls bit-equal, its bound both that of 3xTF32 on the
   tensor cores and that of fp32 on the CUDA cores; the int8 MLP at 1, 4, 8
   and 16 rows (also against its tiled model; one device kernel a call, from
   a profiler trace; beside the library's int8 matmul and a bf16 MLP as
   yardsticks) and the int4 matvec at the four layer shapes at 1 and 8 rows,
   down also at 32 (two calls bit-equal), bf16, on the quantized LMs' own
   weights, timed over all 24 layers' weights in turn (as a decode step
   streams them from HBM);
10. one prefill of the full-width LM (Qwen2.5-0.5B, random weights) on each
   request's prompt with the flash kernel and with the plain dense
   attention: last-position logits must agree;
11. one full-width decode step of the int8 and of the int4 LM on the card
   and on the CPU (the same weights moved with .cpu(), each side prefilled
   from the same prompt): guided logits must agree, with the same argmax;
12. continuous batching, paged: the PagedContinuousEngine sized as
   ContinuousTTSServer(paged=True) sizes it (8 slots, 256-token pages, 4
   pages a slot, a pool of 17 pages: half the worst case), bf16, the
   control superset with clone narrowing, sampling, serves eight requests
   (four voice creations, four clones of phase 4's prompt wav, two with its
   transcript): six submitted at once, two after the first 64-step
   dispatch, each AdmissionDeferred retried after every step.  Counters are
   0 just before and read just after: 24 paged-kernel launches per decode
   step, no other attention kernel; every request ends with 500 ids (or at
   an EOS that sampling drew), all in its mode's guided set; at least one
   deferral; every page back in the pool;
   one creation and one clone vocoded to finite waveforms of 320 samples
   per semantic token;
13. continuous batching, dense: the ContinuousBatchingEngine (cache 960)
   serves the same eight requests with the same checks, its 24 decode
   launches per step on the dense kernel; KV bytes against the pool's;
14. one decode step's guided logits through each engine's forward from its
   state after the first dispatch, on the card and on the CPU (params and
   state moved with .cpu()): within 5e-2 of the largest logit on every live
   row, and each row's argmax on the card the CPU's or, where the row's top
   logits lie closer than that, within 5e-2 of the CPU's top logit;
15. the paged kernel against its plain version and its split model on the
   paged engine's own pools, table and lengths after that dispatch, and at
   lengths 1, P, P + 1, the full table and one past it, and at a late state
   (every slot near the full table), two calls of each bit-equal; timed at
   the engine's and the late state.  The decode
   kernel against its plain version and its split model on the dense
   engine's own cache, starts and clamped positions after its first
   dispatch, timed there beside SDPA over the same windows.
16. After each of phases 3, 4, 6 and 7, the graph path against the eager
   loop (`eager_generate`: prefill, then `decode_step` in a Python loop):
   greedy ids bit-equal, sampled ids with one seed equal twice through the
   graphs and against the loop, and the loop's ms a step beside the graph
   path's; after phase 4, `generate_tokens` from three threads at once,
   each thread's ids those of its request alone.  In phase 13, greedy
   engines serve the burst through their units and as the eager loop
   (`eager_dispatch`): ids bit-equal, ms a step of each.
17. voice creation streamed (`StreamingSynthesizer`, the default schedule,
   counters 0 just before and read just after): one prefill, decode by unit
   replays only, whole vocodes, at least 3 finite chunks; its first-chunk
   ms and its length against the offline path of the same seed;
18. every captured unit (capture ms, graph-pool MiB, replays, launches a
   unit); a capture with a host read inside must raise.
19. a checkpoint: a full-width Spark-TTS-0.5B directory with torch names
   written to chiprun_out/ckpt/ from SEED (the fixture config files, a
   byte-level BPE tokenizer with the Spark-TTS and codec tokens, the LLM
   in BF16, the BiCodec and wav2vec2 in fp32, each file by this script's
   own safetensors writer), loaded with SparkTTSPipeline(model_dir=...):
   read, convert and upload seconds, peak memory, every tree with the init's
   keys, shapes and dtypes; one creation and one clone request with the
   launch counts of phases 3 and 4; prefill logits of the 64-token bucket
   card vs the same directory loaded on the CPU (5e-2 of the largest logit).
   The directory is deleted after;
20. the untied head: the creation request on the LM with
   tie_word_embeddings=False (a random bf16 lm_head), 100 greedy ids
   through the decode unit equal to the eager loop's; one decode step of
   the int8 and of the int4 LM (head quantized too) card vs CPU;
21. the batch surfaces at B = 4: four clone prompts of three lengths (rows
   0 and 2 one prompt) tokenized as one batch and assembled on the device
   (equal to build_clone_prompt); generate_tokens_batch with per-row seeds
   [7, 9, 7, 5] and detokenize_batch (one prefill, 24 decode launches a
   step, one vocode); rows 0 and 2 equal; the rows swapped with their
   seeds give each row's ids again, sampled and greedy; greedy ids equal
   generate_and_vocode_batch's, whose waveforms are finite with 320 samples
   a token; aggregate tokens/s beside B = 1's; kernels 1, 2 and 3 at these
   shapes against their plain versions, two calls bit-equal, timed;
22. longform: inference_long of a three-sentence creation text, 3
   segments, the clone prompts of segments 2 and 3 carrying exactly
   segment 1's 32 global ids, the length the segments' plus two gaps; RTF;
23. the voice cache (size 2): one clone request twice from one wav, one
   miss then one hit, the hit running no tokenize and giving the same ids;
24. the continuous-batching server (`ContinuousTTSServer`, dense, cache
   960, 8 slots, bf16, sampled, 500 tokens), after its warm-up passes
   (batched admissions, speculative chains, stream windows, a
   representative burst, the vocode batches it saw): eight requests through
   `synthesize`/`synthesize_streaming` in two waves (three creations, a
   clone of the 6 s prompt with its transcript, a streamed creation; then
   that clone again, which hits the voice cache, a clone of a 4 s prompt,
   which takes the fused admission, a streamed clone), counts 0 just before
   and read after: 8 completed, no failure, finite waveforms of 320 samples
   a semantic id, every stream window within WINDOW_REL_TOL of the
   full-prefix vocode at its end and every speculative first chunk of the
   plain vocode path at its chain's batch, fused and voice-cache admissions,
   no decode unit captured in the burst, the TF32 flags as the caller set
   them; aggregate tokens/s beside phase 13's bare engine, first-chunk ms,
   stages; the same burst traced for the device's idle share;
25. the same on the paged server (the half pool): deferrals, every page
   back; kernels 2, 6 and 3 at the servers' state and batched windows;
26. greedy servers, dense and paged at dispatch depth 1 and 2, and a dense
   one on the int8 LM (kernel 4): every request's ids the bare dense
   engine's greedy ids of its prompt, or first apart at a near tie (phase
   14's rule);
27. a decode unit captured by a background thread while the vocode worker
   renders: the live dispatches' unit lookups wait less than the capture,
   and the ids equal a run without it.
28. the HTTP front door (`serve/server.serve_http`, dense, voice cache on,
   warm-up with one wav bucket) over a full-width pipeline of its own,
   driven over the socket by the port's client and raw HTTP, counts 0 after
   warm-up and read after the routes: /health; /tts creation and clone (16
   kHz, 320 samples a semantic id); four concurrent /tts creations in fewer
   than four batches; /tts_stream NDJSON ending {"done": true};
   /v1/audio/speech as wav, pcm and a stream (ms to its first audio byte);
   a voice registered, used and deleted; a text over 600 characters through
   longform; 400 for malformed JSON, the OpenAI 404 envelope for an unknown
   voice; a greedy (top_k 1) /tts equal to generate_tokens_batch (greedy)
   + detokenize_batch within WINDOW_REL_TOL of the peak; the front's cost
   over the same request by a direct call; kernels 1, 2 and 3 launched.
   Then the leak check: stopped and dropped, its pipeline and servers leave
   memory_allocated within LEAK_MARGIN_MIB of its value before the phase,
   and none of their decode units.
29. speculative decoding through `SparkTTSPipeline(speculative_k=4)`
   (`lm/speculative.py`: captured units of rounds, each k draft decode
   steps, one verify forward of k tokens, the acceptance on the card), 500
   new tokens on the creation and clone prompts of phases 3 and 4: (a)
   greedy with draft_layers=24 (draft = target): ids vanilla greedy's or
   first apart at a near tie (phase 14's rule), k - 1 proposals accepted a
   round but where the draft's decode path and the verify's dense attention
   pick apart: every emission where a round stopped on a rejected proposal
   is a near tie of the output's dense logits; (b) draft_layers=6, greedy
   to the same rule, and sampled:
   `inference` gives finite waveforms of 320 samples a semantic id; (c)
   greedy, draft 6, on the int8 and the int4 LM to the same rule.  Each
   speculative call with counts 0 just before and read after: one flash
   prefill a layer of target and draft, kernel 2 in every draft step, kernel
   4 in every int8 draft step, kernel 5 in every int4 draft step and verify.
   Prints acceptance, ms a token beside vanilla decode's, each unit's
   capture ms and graph MiB;
30. the benchmark harness (`sparktts_tpu_torch/bench/`) over a full-width
   pipeline of its own, 200-token budgets: run_offline_benchmark (three
   requests, concurrency 3), run_streaming_benchmark,
   run_continuous_benchmark dense and paged, offline and streaming,
   run_longform_benchmark, run_grpc_streaming_benchmark (framed) and
   run_network_streaming_benchmark over serve_http: each prints its stats,
   with num_tasks its task count and rtf > 0; counts 0 before the first and
   read after the last (kernels 1, 2, 3 and 6 launched); then
   measure_dispatch_tax, the speaker similarity and semantic consistency of
   one cloned request, and phase 28's leak check with the pipeline dropped.

The line before the last is a JSON object with one entry per kernel (its
launches are the sum over the main-path runs of phases 3, 4, 6, 7, 12, 13,
17, 19 to 23, the server bursts of 24 to 27, phase 28's routes, phase
29's speculative calls and phase 30's runners, its
times those of the voice-creation shapes, for the int8 MLP one call at one
row, for the int4 matvec the four calls of one layer at
one row, for the paged kernel one layer at the paged engine's state; the
flash, decode, vocoder and paged entries list every timed shape in
`by_shape`: both requests' and the B = 4 batch's and, for decode, the dense
engine's state, for paged the engine's and the late state, and the
servers' shapes); the last line
is {"ok": true, "device": {...}}.  Without a CUDA card, or run from a
directory without the sparktts_tpu_torch package, it exits 2 and prints no
result.  `--front-only`, `--servers-only`, `--spec-only` and `--bench-only`
run phase 28, phases 24-27, phase 29 or phase 30 alone (after the build),
with no kernels line and no result line.
"""

from __future__ import annotations

import contextlib
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
# fp32 FLOP/s on the CUDA cores, dense TF32 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12

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
# ResidualUnit kernel vs plain version, both fp32-accurate (the kernel in
# 3xTF32, the plain version with TF32 off): they differ in the order of the
# 7C + C-term sums and in the dropped lo x lo term (~2^-22 of each product).
VOCODER_REL_TOL = 1e-4
# ResidualUnit kernel vs `residual_unit_3xtf32_plain` (its three tf32 products
# summed by cuBLAS in fp32, TF32 off), relative to max|model|, at C channels:
# they differ in the accumulation alone, which the tensor cores round toward
# zero at each mma step, so the gap grows with C (on an H100, 8.6e-7 at
# C = 96 to 3.5e-5 at C = 768, `scripts/check_torch_vocoder_accumulation.py`);
# a product left out of the split moves the unit by 4.3e-5 at C = 96 to
# 2.2e-4 at C = 768, above this limit at every C.
def vocoder_model_tol(c: int) -> float:
    return 7e-5 * (c / 768) ** 1.5


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
# The library's int4 matmul (timed as a yardstick) vs the plain version,
# relative to max|plain|: it takes the group scales in bf16 (2^-9 relative
# each) and sums in its own order; a wrong weight layout misses by O(1).
INT4_LIBRARY_REL_TOL = 2e-2
# int8 codec vs fp32 codec on the same tokens: the JAX package's gate
# (tests/test_codec_quant.py).
CODEC_INT8_REL_L2 = 0.05
INT4_GROUP = 128

# The engine phases, sized as ContinuousTTSServer sizes its engines (8 slots,
# 256-token pages); the dense cache holds the clone prompt's bucket (448)
# and the budget, which the server's default of 768 would refuse.
ENGINE_SLOTS = 8
PAGE_SIZE = 256
DENSE_CACHE_LEN = 960
ENGINE_DISPATCH = 64
ENGINE_CREATIONS = (
    (TEXT, ("female", "moderate", "moderate")),
    ("Eight voices share one card and none of them waits.", ("male", "low", "high")),
    ("Pages come and go as the requests run.", ("female", "high", "low")),
    ("A burst of requests, served together.", ("male", "very_low", "moderate")),
)
# at most TEXT's length: with the transcript, the prompt stays in the 448 bucket
ENGINE_CLONE_TEXTS = (TEXT, "One card serves eight voices here.")


_capture = {}


def _capture_stream():
    """The one stream that every timing graph is captured on (and warmed up
    on).  Kernels 2, 4, 5 and 6 merge on per-stream arrival counters
    (`kernels/arrivals.py`), which are never made during a capture, so this
    stream's counters are made once, here, before its first capture."""
    import torch

    from sparktts_tpu_torch.kernels import arrivals

    if "stream" not in _capture:
        _capture["stream"] = torch.cuda.Stream()
        arrivals.prepare(_capture["stream"])
    return _capture["stream"]


def _time_ms(fn, dev, iters=20, reps=10) -> float:
    """Device milliseconds per call of `fn`: `iters` calls captured in one
    CUDA graph on `_capture_stream()`, replayed `reps` times between CUDA
    events, so the host's per-call overhead is not in the number (inputs stay
    L2-resident, as they are on the main path, where each is written just
    before it is read).  On the CPU (rehearsal only) a host clock."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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


def _reset_counts():
    """Every kernel's launch count to 0: the wrappers' eager counts and the
    launches of graph replays (`lm/graphs.py`)."""
    from sparktts_tpu_torch.lm import graphs

    graphs.reset_launches()


def _counts() -> dict:
    """Launches of each kernel since `_reset_counts`: eager launches plus,
    for each captured decode unit, its replays times its launches a unit."""
    from sparktts_tpu_torch.lm import graphs

    return graphs.launches()


def _bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_inputs(dev, cfg, gen, b, t, starts):
    """Random bf16 q (B, Hq, T, D), k and v (B, Hkv, T, D) and int32 starts."""
    import torch

    q, k, v = (
        torch.randn((b, h, t, cfg.head_dim), generator=gen, device=dev).to(torch.bfloat16)
        for h in (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.num_key_value_heads)
    )
    return q, k, v, torch.tensor(starts, dtype=torch.int32, device=dev)


def _check_flash_case(dev, q, k, v, st, scale):
    """Kernel 1 vs its plain version on the non-pad rows, two calls
    bit-equal; returns the error."""
    import torch

    from sparktts_tpu_torch.kernels import flash_attention as fa

    b, _, t, _ = q.shape
    starts = st.tolist()
    got = fa.flash_attention_prefill(q, k, v, st, sm_scale=scale)
    again = fa.flash_attention_prefill(q, k, v, st, sm_scale=scale)
    want = fa.flash_attention_plain(q, k, v, st, sm_scale=scale).float()
    _sync(dev)
    if not torch.equal(got, again):
        raise AssertionError(f"flash kernel: two calls differ at B={b} T={t}")
    got = got.float()
    rows = torch.arange(t, device=dev)[None, :] >= st[:, None]  # (B, T) non-pad rows
    err = float((got - want).abs()[rows[:, None, :, None].expand_as(got)].max())
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash kernel: non-finite output at B={b} T={t}")
    print(f"flash_attention_prefill B={b} T={t} starts={starts}: max_abs_err={err:.3e} "
          f"(tol {KERNEL_ATOL}), two calls bit-equal")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"flash kernel disagrees with its plain version: {err}")
    return err


def _time_flash(dev, q, k, v, st, scale, label):
    """Kernel 1 at one shape, timed beside its plain version and SDPA (a
    yardstick), with its bound over the valid (query, key) pairs.  Returns
    a `by_shape` item."""
    import torch
    import torch.nn.functional as F

    from sparktts_tpu_torch.kernels import flash_attention as fa

    b, hq, t, d = q.shape
    kernel = functools.partial(fa.flash_attention_prefill, q, k, v, st, sm_scale=scale)
    plain = functools.partial(fa.flash_attention_plain, q, k, v, st, sm_scale=scale)
    ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
    row = torch.arange(t, device=dev)
    mask = ((row[None, None, :] <= row[None, :, None])
            & (row[None, None, :] >= st[:, None, None]))[:, None]  # (B, 1, T, T)
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                               enable_gqa=True), dev)
    pairs = sum(max(0, i - a + 1) for a in st.tolist() for i in range(t))  # valid (query, key)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b
    bound_ms, bound_by = _bound(nbytes, 4 * d * hq * pairs)
    print(f"flash_attention_prefill {label}: device {ms:.4f} ms "
          f"(plain {plain_ms:.4f}, SDPA {library_ms:.4f}, bound {bound_ms:.3e} by {bound_by}); "
          f"eager call {_eager_ms(kernel, dev):.4f} ms (plain {_eager_ms(plain, dev):.4f})")
    return dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def check_flash(dev, cfg, mains):
    """Flash prefill kernel vs plain at each main path's (T, start), given
    in `mains`, plus a longer and a batched ragged case; each main shape is
    timed, and two calls at each must give the same bits.  Returns the
    kernels-line entry (without launches) with the times of the first main
    shape, and every main shape's in `by_shape`."""
    import torch

    from sparktts_tpu_torch.kernels import flash_attention as fa

    scale = cfg.head_dim**-0.5
    gen = torch.Generator(device=dev).manual_seed(1)
    t0, start0 = mains[0]
    cases = [(1, t, [start]) for t, start in mains]
    cases += [(1, 2 * t0, [start0 + t0 // 2]), (4, 77, [0, 3, 40, 76])]
    max_err = max(_check_flash_case(dev, *_flash_inputs(dev, cfg, gen, b, t, starts), scale)
                  for b, t, starts in cases)
    timed = [_time_flash(dev, *_flash_inputs(dev, cfg, gen, 1, t, [start]), scale,
                         f"B=1 T={t} start={start}") for t, start in mains]
    first = {k: v for k, v in timed[0].items() if k != "shape"}
    return dict(name="flash_attention_prefill", route="cuda", source=fa.SOURCE,
                replaces=fa.REPLACES, max_abs_err=max_err, by_shape=timed, **first)


def _time_decode(dev, q, ck, cv, layer, st, po, scale, label):
    """Kernel 2 at one state, timed: the kernel, its plain version, SDPA over
    the same cache plane and windows (a yardstick only) and the bound over
    the windows' valid keys (each key's K and V rows read once).  Returns a
    `by_shape` item."""
    import torch
    import torch.nn.functional as F

    from sparktts_tpu_torch.kernels import decode_attention as da

    b, hq, d = q.shape
    s, hkv = ck.shape[2], ck.shape[3]
    kernel = functools.partial(da.dense_decode_attention, q, ck, cv, layer, st, po, sm_scale=scale)
    plain = functools.partial(da.dense_decode_plain, q, ck, cv, layer, st, po, sm_scale=scale)
    ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
    kv = (ck[layer].permute(0, 2, 1, 3), cv[layer].permute(0, 2, 1, 3))  # (B, Hkv, S, D)
    j = torch.arange(s, device=dev)[None, :]
    hi = torch.clamp(po, max=s - 1)
    mask = ((j >= st[:, None]) & (j <= hi[:, None]))[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, *kv, attn_mask=mask, scale=scale,
                                               enable_gqa=True), dev)
    keys = int(torch.clamp(hi - st + 1, min=0).sum())
    nbytes = 2 * (2 * q.numel() + 2 * keys * hkv * d) + 8 * b
    bound_ms, bound_by = _bound(nbytes, 4 * d * hq * keys)
    print(f"dense_decode_attention {label}: device {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
          f"{library_ms:.4f}, bound {bound_ms:.3e} by {bound_by}); eager call "
          f"{_eager_ms(kernel, dev):.4f} ms (plain {_eager_ms(plain, dev):.4f})")
    return dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def _check_decode_case(dev, q, ck, cv, layer, st, po, scale, label):
    """Kernel 2 vs its plain version and vs the CPU model of its split (run
    here on the card at the built kernel's chunk), and two calls bit-equal;
    returns the error against the plain version."""
    import torch

    from sparktts_tpu_torch.kernels import decode_attention as da

    got = da.dense_decode_attention(q, ck, cv, layer, st, po, sm_scale=scale)
    again = da.dense_decode_attention(q, ck, cv, layer, st, po, sm_scale=scale)
    want = da.dense_decode_plain(q, ck, cv, layer, st, po, sm_scale=scale).float()
    split = da.dense_decode_split_plain(q, ck, cv, layer, st, po, sm_scale=scale,
                                        chunk=da.kernel_chunk()).float()
    _sync(dev)
    if not torch.equal(got, again):
        raise AssertionError(f"decode kernel: two calls differ ({label})")
    got = got.float()
    err = float((got - want).abs().max())
    err_split = float((got - split).abs().max())
    if not torch.isfinite(got).all():
        raise AssertionError(f"decode kernel: non-finite output ({label})")
    print(f"dense_decode_attention {label}: max_abs_err={err:.3e}, vs the split model "
          f"{err_split:.3e} (tol {KERNEL_ATOL}), two calls bit-equal")
    if not max(err, err_split) <= KERNEL_ATOL:
        raise AssertionError(f"decode kernel disagrees with its plain version: {err}, "
                             f"{err_split} ({label})")
    return err


def check_decode(dev, cfg, mains):
    """Decode kernel vs plain (and the split model) on the full stacked cache
    of each main path, given in `mains` as (cache length S, start, prompt
    bucket T, decode steps): at the middle and the last decode step's
    window, plus a batch of mixed windows.  The middle step of each main
    path is timed.  Returns the kernels-line entry (without launches) with
    the times of the first, and each main path's in `by_shape`."""
    import torch

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

    def window(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

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
        for layer in (0, n_layers - 1):
            label = (f"B={b} S={s} layer={layer} windows="
                     f"{[p - a + 1 for a, p in zip(starts, poss)]}")
            max_err = max(max_err, _check_decode_case(dev, q, ck, cv, layer, window(starts),
                                                      window(poss), scale, label))

    timed = []
    for s, start_main, pos_main in mid:
        q, ck, cv = inputs(1, s)
        timed.append(_time_decode(dev, q, ck, cv, n_layers // 2, window([start_main]),
                                  window([pos_main]), scale,
                                  f"B=1 S={s} window={pos_main - start_main + 1}"))
    first = {k: v for k, v in timed[0].items() if k != "shape"}
    return dict(name="dense_decode_attention", route="cuda", source=da.SOURCE,
                replaces=da.REPLACES, max_abs_err=max_err, by_shape=timed, **first)


def check_dense_engine_decode(dev, cfg, snapshot):
    """Kernel 2 on the dense engine's own cache, starts and clamped write
    positions after its first dispatch (the windows `dense_step_logits`
    gives it): vs plain and the split model at the first and last layer,
    then timed at the middle layer.  Returns a `by_shape` item."""
    import torch

    d, n_layers = cfg.head_dim, cfg.num_hidden_layers
    scale = d**-0.5
    ck, cv = snapshot.cache.k, snapshot.cache.v
    b, s = ck.shape[1], ck.shape[2]
    st, po = snapshot.start, snapshot.write_pos.clamp(max=s - 1)
    q = torch.randn((b, cfg.num_attention_heads, d), generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev).to(torch.bfloat16)
    windows = (po - st + 1).tolist()
    for layer in (0, n_layers - 1):
        _check_decode_case(dev, q, ck, cv, layer, st, po, scale,
                           f"dense engine state B={b} S={s} layer={layer} windows={windows}")
    return _time_decode(dev, q, ck, cv, n_layers // 2, st, po, scale,
                        f"dense engine state B={b} S={s} keys={sum(max(w, 0) for w in windows)}")


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


def check_vocoder(dev, wg_cfg, token_counts, batch=1):
    """The ResidualUnit kernel vs its plain version at the 12 (C, T,
    dilation) of one full-width vocode of `batch` rows of each of
    `token_counts` (semantic tokens as the vocoder gets them, bucketed),
    plus a ragged T, each vocode timed.  Returns the kernels-line entry
    (without launches); its ms, plain_ms and bound_ms are sums over the 12
    unit calls of the vocode of the first count, which is also its
    `by_shape` item."""
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
    if batch == 1:
        cases.append((None, 192, 4321, 9))  # ragged, off the path
    max_err = 0.0
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_fp32_ms=0.0)
              for n in token_counts}
    bound_by = {"bytes": 0.0, "operations": 0.0}  # bound ms by what bounds each unit
    for n, c, t, dil in cases:
        p = unit(c)
        x = torch.randn((batch, t, c), generator=gen, device=dev)
        got = vf.fused_residual_unit(p, x, dil)
        if not torch.equal(got, vf.fused_residual_unit(p, x, dil)):
            raise AssertionError(f"vocoder kernel: two calls differ (B={batch} C={c} T={t} "
                                 f"dilation={dil})")
        want = vf.fused_residual_unit_plain(p, x, dil)
        model = vf.residual_unit_3xtf32_plain(p, x, dil)  # TF32 is off (main)
        _sync(dev)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        model_gap = float((got - model).abs().max()) / float(model.abs().max())
        line = (f"fused_residual_unit B={batch} C={c} T={t} dilation={dil}: "
                f"max_abs_err={err:.3e}, "
                f"max|plain|={scale:.3e}, relative {err / scale:.3e} (tol {VOCODER_REL_TOL}); "
                f"vs its 3xTF32 model {model_gap:.3e} (tol {vocoder_model_tol(c):.3e})")
        if not (bool(torch.isfinite(got).all()) and err <= VOCODER_REL_TOL * scale):
            raise AssertionError(f"vocoder kernel disagrees with its plain version: {line}")
        if not model_gap <= vocoder_model_tol(c):
            raise AssertionError(f"vocoder kernel disagrees with its 3xTF32 model: {line}")
        max_err = max(max_err, err)
        if n is not None:
            ms = _time_ms(lambda: vf.fused_residual_unit(p, x, dil), dev, iters=3, reps=3)
            plain_ms = _time_ms(lambda: vf.fused_residual_unit_plain(p, x, dil), dev, iters=3,
                                reps=3)
            # x in, out, both kernels, biases, alphas
            nbytes = 4 * (2 * batch * t * c + 8 * c * c + 4 * c)
            # the least time of fp32-accurate work on the tensor cores (3xTF32:
            # three products each), and at the fp32 CUDA-core rate
            bound_ms, by = _bound(nbytes, 3 * 16 * batch * t * c * c, TF32_FLOPS)
            bound_fp32_ms = _bound(nbytes, 16 * batch * t * c * c, FP32_FLOPS)[0]
            if n == token_counts[0]:
                bound_by[by] += bound_ms
            line += (f"; device {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} "
                     f"3xTF32, {bound_fp32_ms:.4f} fp32)")
            totals[n]["ms"] += ms
            totals[n]["plain_ms"] += plain_ms
            totals[n]["bound_ms"] += bound_ms
            totals[n]["bound_fp32_ms"] += bound_fp32_ms
        print(line)
    for n, total in totals.items():
        print(f"fused_residual_unit over one {n}-token vocode of B={batch} "
              f"({len(vocode_shapes(n)) * len(DILATIONS)} unit calls): "
              f"device {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
              f"bound {total['bound_ms']:.4f} ms 3xTF32 ({total['bound_ms'] / total['ms']:.3f} "
              f"of it), {total['bound_fp32_ms']:.4f} ms fp32 CUDA cores "
              f"({total['bound_fp32_ms'] / total['ms']:.3f})")
    first = totals[token_counts[0]]
    timing = dict(ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                  bound_by=max(bound_by, key=bound_by.get), library_ms=None)
    shape = f"B={batch}, the 12 units of a {token_counts[0]}-token vocode"
    return dict(name="fused_residual_unit", route="cuda", source=vf.SOURCE, replaces=vf.REPLACES,
                max_abs_err=max_err, by_shape=[dict(shape=shape, **timing)], **timing)


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


def _request(pipe, **request):
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
    _reset_counts()
    t0 = time.perf_counter()
    wav = pipe.inference(TEXT, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **request)
    _sync(dev)
    total_s = time.perf_counter() - t0
    launches = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    return wav, launches, total_s, peak_gib


def _breakdown(pipe, prompt, mode: str, global_ids_of):
    """The request in parts: generate, prefill alone at the prompt's bucket
    (mean of 5), and the vocode of the generated tokens.  Returns (the
    breakdown, the (global, semantic) ids it vocoded)."""
    import torch

    from sparktts_tpu_torch.lm.generate import prefill
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache
    from sparktts_tpu_torch.prompt import extract_semantic_ids

    dev, n_layers = pipe.device, pipe.config.llm.num_hidden_layers
    d0 = _counts()["dense_decode_attention"]
    t0 = time.perf_counter()
    generated = pipe.generate_tokens(prompt, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, mode=mode)
    _sync(dev)
    generate_ms = (time.perf_counter() - t0) * 1e3
    decode_steps = (_counts()["dense_decode_attention"] - d0) // n_layers

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
    if launches["paged_decode_attention"] != 0:
        raise AssertionError(f"{label}: the pipeline launched the paged kernel")
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


def run_voice_creation(pipe, label="voice creation", **expected):
    """Voice creation end to end; returns (its launch counts, its prompt
    ids, its breakdown, the ids it vocoded).  `expected`: per-layer launch
    counts of the quantized kernels (`_check_request`)."""
    from sparktts_tpu_torch.prompt import build_control_prompt, padded_global_tokens

    wav, launches, total_s, peak_gib = _request(pipe, **VOICE)
    token_num = pipe.config.bicodec.speaker_encoder.token_num
    prompt = build_control_prompt(pipe.tokenizer, TEXT, **VOICE)
    summary, tokens = _breakdown(pipe, prompt, "control",
                                 lambda g: padded_global_tokens(pipe.tokenizer, g, token_num))
    audio_s = len(wav) / pipe.sample_rate
    summary.update(wav_samples=int(len(wav)), audio_s=audio_s, inference_s=total_s,
                   rtf=total_s / audio_s if audio_s else float("inf"), peak_mem_gib=peak_gib)
    _check_request(label, pipe, wav, launches, summary, **expected)
    return launches, prompt, summary, tokens


def run_voice_cloning(pipe, wav_path: Path, label="voice cloning", **expected):
    """Voice cloning end to end from the prompt wav; returns (its launch
    counts, its prompt ids, its breakdown, the ids it vocoded)."""
    import numpy as np

    from sparktts_tpu_torch.nn.wav2vec2 import feature_lengths
    from sparktts_tpu_torch.prompt import build_clone_prompt

    request = dict(prompt_speech_path=wav_path, prompt_text=PROMPT_TEXT)
    wav, launches, total_s, peak_gib = _request(pipe, **request)
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
    summary, tokens = _breakdown(pipe, prompt, "clone", lambda _: glob)
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
    _, (_, _, *arrays), true_sem, _ = pipe.tokenize_host_prep(wav_path)
    t0 = time.perf_counter()
    with torch.inference_mode():
        glob_cpu, sem_cpu = codec_tokenize(_cpu(pipe.w2v_params), _cpu(pipe.bicodec_params),
                                           pipe.config, *(a.cpu() for a in arrays))
    cpu_s = time.perf_counter() - t0
    glob_cpu, sem_cpu = glob_cpu.numpy(), sem_cpu[:, :true_sem].numpy()
    agree = {"global": float(np.mean(glob == glob_cpu)), "semantic": float(np.mean(sem == sem_cpu))}
    print(f"tokenize card vs CPU ({cpu_s:.1f} s on the CPU): global ids agree at "
          f"{int((glob == glob_cpu).sum())}/{glob.size}, semantic ids at "
          f"{int((sem == sem_cpu).sum())}/{sem.size} (need {TOKENIZE_AGREEMENT})")
    if min(agree.values()) < TOKENIZE_AGREEMENT:
        raise AssertionError(f"tokenize: card and CPU disagree: {agree}")


def check_int8_codec(pipe, tokens):
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
        before = _counts()["fused_residual_unit"]
        t0 = time.perf_counter()
        got = pipe.detokenize(*tokens).astype(np.float64)
        vocode_ms = (time.perf_counter() - t0) * 1e3
        unit_launches = _counts()["fused_residual_unit"] - before
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


def _device_kernels(fn, dev, label):
    """Names of the device kernels that one call of `fn` launched, from a
    torch.profiler trace (written to the output directory).  A trace with
    no device activity at all recorded nothing, since the call ran on the
    card (the profiler now and then drops a session's device records: one
    of four sessions of one H100 run came back empty), so it is taken
    again, at most three sessions in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(dev)
    for session in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            _sync(dev)
        path = OUT_DIR / f"{label}_launch_trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
        if any(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for e in events):
            return [e["name"] for e in events if e.get("cat") == "kernel"]
        print(f"{label}: profiler session {session + 1} recorded no device activity")
    return []


def int8_library_mlps(x, gu_q, gu_scale, down_q, down_scale):
    """Two yardsticks for the fused int8 MLP on the same weights (the port
    calls neither): the library's int8 weight-only matmul
    (`torch._weight_int8pack_mm`, bf16 scales) for gate/up and down with
    silu * mul between, and the same MLP with the weights dequantized to
    bf16 once, here, through `F.linear`.  Returns the two calls."""
    import torch
    import torch.nn.functional as F

    i = down_q.shape[0]
    wgu, wd = gu_q.t().contiguous(), down_q.t().contiguous()  # (2I, K), (K, I)
    sgu, sd = gu_scale.to(torch.bfloat16), down_scale.to(torch.bfloat16)
    dgu = (wgu.float() * gu_scale[:, None]).to(torch.bfloat16)
    dd = (wd.float() * down_scale[:, None]).to(torch.bfloat16)

    def int8pack():
        gu = torch._weight_int8pack_mm(x, wgu, sgu)
        return torch._weight_int8pack_mm(F.silu(gu[:, :i]) * gu[:, i:], wd, sd)

    def dense():
        gu = F.linear(x, dgu)
        return F.linear(F.silu(gu[:, :i]) * gu[:, i:], dd)

    return int8pack, dense


def check_int8_mlp(dev, int8_layers):
    """The fused int8 MLP kernel vs its plain version and its tiled model at
    1, 4, 8 and 16 rows on the int8 LM's own layers (bf16 x), two calls
    bit-equal, plus a ragged intermediate width; one call is one device
    kernel (profiler trace); each row count timed over the 24 layers beside
    the two yardsticks of `int8_library_mlps` (held to the plain version
    first; an error of the library call is recorded in its place).  Returns
    the kernels-line entry (without launches) with the times of one row."""
    import torch

    from sparktts_tpu_torch.kernels import int8_mlp as i8

    gen = torch.Generator(device=dev).manual_seed(4)
    weights = [(lay["gateup"]["w_q"], lay["gateup"]["scale"], lay["down"]["w_q"],
                lay["down"]["scale"]) for lay in int8_layers]
    k, i = weights[0][2].shape[1], weights[0][2].shape[0]
    max_err, timed = 0.0, {}
    for r in (1, 4, 8, 16):
        x = torch.randn((r, k), generator=gen, device=dev).to(torch.bfloat16)
        for w in (weights[0], weights[-1]):
            got = i8.int8_mlp_matvec(x, *w)
            if not torch.equal(got, i8.int8_mlp_matvec(x, *w)):
                raise AssertionError(f"int8 MLP kernel: two calls differ (R={r})")
            label = f"int8_mlp_matvec R={r} K={k} I={i}, two calls bit-equal"
            max_err = max(max_err, _check_close(label, got, i8.int8_mlp_matvec_plain(x, *w),
                                                INT8_MLP_REL_TOL))
            _check_close(f"{label}, vs its tiled model", got, i8.int8_mlp_tiled_plain(x, *w),
                         INT8_MLP_REL_TOL)
        if dev.type == "cuda":
            kernels = _device_kernels(functools.partial(i8.int8_mlp_matvec, x, *weights[0]), dev,
                                      f"int8_mlp_R{r}")
            if len(kernels) != 1 or "int8_mlp" not in kernels[0]:
                raise AssertionError(f"int8 MLP: one call launched {kernels}, not one kernel")
        ms = _time_ms(_rotating([functools.partial(i8.int8_mlp_matvec, x, *w) for w in weights]),
                      dev, iters=len(weights), reps=10)
        plain_ms = _time_ms(_rotating([functools.partial(i8.int8_mlp_matvec_plain, x, *w)
                                       for w in weights]), dev, iters=len(weights), reps=3)
        nbytes = 3 * i * k + 4 * (2 * i + k) + 2 * 2 * r * k  # int8 weights, scales, x in, out
        bound_ms, bound_by = _bound(nbytes, 6 * r * k * i)
        line = (f"int8_mlp_matvec R={r}: device {ms:.4f} ms per call over {len(weights)} layers' "
                f"weights, one kernel a call (plain {plain_ms:.4f}, bound {bound_ms:.4f} by "
                f"{bound_by}, {nbytes / ms / 1e6:.1f} GB/s)")
        yardsticks = {}
        pairs = [int8_library_mlps(x, *w) for w in weights]
        for n, name in enumerate(("torch._weight_int8pack_mm", "bf16 F.linear")):
            try:
                _check_close(f"{name} MLP R={r} vs plain", pairs[0][n](),
                             i8.int8_mlp_matvec_plain(x, *weights[0]), INT8_MLP_REL_TOL)
                yardsticks[name] = _time_ms(_rotating([p[n] for p in pairs]), dev,
                                            iters=len(weights), reps=10)
                line += f"; {name} {yardsticks[name]:.4f}"
            except (RuntimeError, NotImplementedError) as e:
                yardsticks[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
                line += f"; {name} raised {yardsticks[name]}"
        del pairs
        print(line)
        timed[r] = dict(rows=r, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        yardsticks=yardsticks)
    # a ragged intermediate width (no 16-column tiling, a padded cluster) at 3 rows
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
    one = {key: v for key, v in timed[1].items() if key != "rows"}
    return dict(name="int8_mlp_matvec", route="cuda", source=i8.SOURCE, replaces=i8.REPLACES,
                max_abs_err=max_err, library_ms=None, by_shape=list(timed.values()), **one)


def int4_library_call(x, packed, gscale):
    """One `torch._weight_int4pack_mm` call computing int4_matvec's function
    on the same weights, as a yardstick only (the port never calls it): the
    weights converted once, here, to the library's layout (signed nibble +
    8, two to a byte, converted by `torch._convert_weight_to_int4pack`), the
    group scales rounded to bf16 beside zero points of 0.  Returns the call."""
    import torch

    from sparktts_tpu_torch.lm.quant import unpack_int4

    w = unpack_int4(packed).t().to(torch.int32) + 8  # (out, in), 0..15
    w4 = torch._convert_weight_to_int4pack(((w[:, ::2] << 4) | w[:, 1::2]).to(torch.uint8)
                                           .contiguous(), 8)
    scales_zeros = torch.stack([gscale, torch.zeros_like(gscale)], dim=-1).to(torch.bfloat16)
    group = 2 * packed.shape[0] // gscale.shape[0]
    return functools.partial(torch._weight_int4pack_mm, x, w4, group, scales_zeros.contiguous())


def check_int4(dev, int4_layers):
    """The int4 matvec kernel vs its plain version at the four layer shapes
    of the int4 LM (its own weights) at B = 1 and 8 (the engines' eight
    slots), down also at B = 32 (the most rows it takes), and one ragged
    `out`, two calls of each bit-equal; each timed over the 24 layers beside
    the library's int4 matmul (`int4_library_call`, held to the plain
    version first).  Returns the kernels-line entry (without launches):
    times summed over one layer's four calls at B = 1."""
    import torch

    from sparktts_tpu_torch.kernels import int4_matmul as i4

    gen = torch.Generator(device=dev).manual_seed(6)
    max_err = 0.0
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)

    def check(label, x, packed, gscale):
        got = i4.int4_matvec(x, packed, gscale)
        if not torch.equal(got, i4.int4_matvec(x, packed, gscale)):
            raise AssertionError(f"int4 kernel: two calls differ ({label})")
        return _check_close(f"{label}, two calls bit-equal", got,
                            i4.int4_matvec_plain(x, packed, gscale), INT4_REL_TOL)

    for name in ("qkv", "o", "gateup", "down"):
        weights = [(lay[name]["w_p4"], lay[name]["gscale"]) for lay in int4_layers]
        (half, d_out), groups = weights[0][0].shape, weights[0][1].shape[0]
        batches = (1, 8, 32) if name == "down" else (1, 8)
        for b in batches:
            x = torch.randn((b, 2 * half), generator=gen, device=dev).to(torch.bfloat16)
            for w in (weights[0], weights[-1]):
                max_err = max(max_err, check(
                    f"int4_matvec {name} B={b} in={2 * half} out={d_out} groups={groups}", x, *w))
            ms = _time_ms(_rotating([functools.partial(i4.int4_matvec, x, *w) for w in weights]),
                          dev, iters=len(weights), reps=10)
            plain_ms = _time_ms(_rotating([functools.partial(i4.int4_matvec_plain, x, *w)
                                           for w in weights]), dev, iters=len(weights), reps=3)
            nbytes = half * d_out + 4 * groups * d_out + 2 * b * (2 * half + d_out)
            bound_ms, bound_by = _bound(nbytes, 4 * b * half * d_out)
            line = (f"int4_matvec {name} B={b}: device {ms:.4f} ms per call over {len(weights)} "
                    f"layers' weights (plain {plain_ms:.4f}, bound {bound_ms:.5f} by {bound_by}, "
                    f"{nbytes / ms / 1e6:.1f} GB/s)")
            calls = [int4_library_call(x, *w) for w in weights]
            _check_close(f"torch._weight_int4pack_mm {name} B={b} (bf16 scales) vs plain",
                         calls[0](), i4.int4_matvec_plain(x, *weights[0]), INT4_LIBRARY_REL_TOL)
            library_ms = _time_ms(_rotating(calls), dev, iters=len(weights), reps=10)
            line += f"; torch._weight_int4pack_mm {library_ms:.4f}"
            if b == 1:
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total["bound_ms"] += bound_ms
                total["library_ms"] += library_ms
            print(line)
    g = torch.Generator(device=dev).manual_seed(7)
    packed = torch.randint(-128, 128, (448, 1000), generator=g, device=dev, dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((7, 1000), generator=g, device=dev))
    x = torch.randn((3, 896), generator=g, device=dev).to(torch.bfloat16)
    max_err = max(max_err, check("int4_matvec B=3 in=896 out=1000 (ragged)", x, packed, gscale))
    print(f"int4_matvec, one layer's four calls at B=1: device {total['ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, torch._weight_int4pack_mm {total['library_ms']:.4f} ms, "
          f"bound {total['bound_ms']:.5f} ms")
    if total["library_ms"] < total["ms"]:
        print("int4_matvec: the library call is faster than the kernel")
    return dict(name="int4_matvec", route="cuda", source=i4.SOURCE, replaces=i4.REPLACES,
                max_abs_err=max_err, bound_by="bytes", **total)


def check_decode_step_on_cpu(pipe, params, label, prompt, mode, near_tie_ok=False):
    """One full-width decode step of `params` (a quantized LM) on the card,
    through its kernels, and on the CPU, through the plain versions (the
    same weights moved with .cpu()); each side prefills its own cache from
    `prompt` first.  Guided logits must agree within LOGITS_REL_TOL of the
    largest logit, with the same argmax; with `near_tie_ok`, the rule of the
    engines' forward check instead (phase 14): the card's pick the CPU's or,
    where the top logits lie closer than that tolerance, within it of the
    CPU's top logit."""
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
    shortfall = float(cpu.max() - cpu[card.argmax()])
    print(f"{label} decode step, card vs CPU ({time.perf_counter() - t0:.1f} s; card launches "
          f"int8_mlp/int4 {launches['card']}): guided logits max|card - cpu| = {err:.4e}, "
          f"max|logit| = {scale:.4e}, relative {err / scale:.3e} (tol {LOGITS_REL_TOL}), "
          f"same argmax: {same_top} (the card's pick {shortfall:.4e} below the CPU's top)")
    if near_tie_ok:
        same_top = same_top or shortfall <= LOGITS_REL_TOL * scale
    if not (math.isfinite(err) and err <= LOGITS_REL_TOL * scale and same_top):
        raise AssertionError(f"{label}: the decode step on the card disagrees with the CPU")
    if launches["card"] == (0, 0):
        raise AssertionError(f"{label}: the card's decode step launched no quantized kernel")


def engine_requests(pipe, wav_path: Path):
    """The eight requests of the engine phases, in submission order: four
    voice creations (different texts and attributes), then four clones of
    the prompt wav, two with its transcript (the 419-token prompt) and two
    without.  Each is (label, prompt ids, mode)."""
    from sparktts_tpu_torch.prompt import build_clone_prompt, build_control_prompt

    tok = pipe.tokenizer
    glob, sem = pipe.tokenize_audio(wav_path)
    out = [(f"creation {i}", build_control_prompt(tok, text, *voice), "control")
           for i, (text, voice) in enumerate(ENGINE_CREATIONS)]
    for i, text in enumerate(ENGINE_CLONE_TEXTS):
        out.append((f"clone {i}, transcript", build_clone_prompt(tok, text, glob, sem, PROMPT_TEXT),
                    "clone"))
        out.append((f"clone {i}, no transcript", build_clone_prompt(tok, text, glob), "clone"))
    return out, glob


def _engine_kwargs(pipe, greedy=False):
    """What ContinuousTTSServer passes both engines: one engine serves both
    modes under the control superset, clone slots narrowed per slot."""
    from sparktts_tpu_torch.pipeline import PROMPT_BUCKET

    vocab_slice, extra_ids = pipe.guided_constraint("control")
    clone_slice, clone_extras = pipe.guided_constraint("clone")
    return dict(prompt_pad=PROMPT_BUCKET, eos_ids=tuple(pipe.tokenizer.eos_ids),
                pad_id=pipe.tokenizer.pad_id, cache_dtype=pipe.lm_dtype, vocab_slice=vocab_slice,
                extra_ids=extra_ids, clone_slice=clone_slice, clone_extras=clone_extras,
                seed=SEED, greedy=greedy, device=pipe.device)


def _clone_state(state, device=None):
    """A copy of an engine state (nested NamedTuples of tensors), on
    `device` when given."""
    if isinstance(state, tuple):
        return type(state)(*(_clone_state(x, device) for x in state))
    return state.clone() if device is None else state.to(device)


def serve_burst(label, pipe, eng, requests, glob, vocode=True):
    """The engine phases' main path: submit the first six requests, dispatch
    ENGINE_DISPATCH steps through the three-phase step protocol, queue the
    other two, and after every step retry the waiting requests in order
    (each AdmissionDeferred counts once), as the server does, until all are
    done; then (`vocode`) vocode one creation and one clone (the clone with
    the prompt wav's global ids `glob`).  Every launch counter is 0 just before and
    read just after.  Returns a summary with the finished ids, the
    launches, the state after the first dispatch and the metrics."""
    import torch

    from sparktts_tpu_torch.lm.continuous import AdmissionDeferred
    from sparktts_tpu_torch.prompt import extract_semantic_ids, padded_global_tokens

    dev = pipe.device
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    waiting, req_ids = list(range(6)), {}
    deferrals = steps = dispatches = 0
    step_s, snapshot = 0.0, None

    def admit():
        nonlocal deferrals
        while waiting:
            i = waiting[0]
            try:
                req_ids[i] = eng.submit(requests[i][1], MAX_NEW_TOKENS, mode=requests[i][2])
            except AdmissionDeferred:
                deferrals += 1
                return
            waiting.pop(0)

    t0 = time.perf_counter()
    admit()
    while waiting or any(o is not None for o in eng.owner):
        ts = time.perf_counter()
        handle = eng.step_begin(ENGINE_DISPATCH)
        if handle is None:
            raise AssertionError(f"{label}: requests wait but no slot is live")
        eng.step_commit(handle, eng.step_fetch(handle))
        step_s += time.perf_counter() - ts
        steps += handle[2]
        dispatches += 1
        if snapshot is None:
            snapshot = _clone_state(eng.slots)
            waiting += [6, 7]
        admit()
    _sync(dev)
    serve_s = time.perf_counter() - t0
    finished = {i: eng.finished[r] for i, r in req_ids.items()}
    tok = pipe.tokenizer
    token_num = pipe.config.bicodec.speaker_encoder.token_num
    wavs = {}
    for i in (0, 4) if vocode else ():  # one creation, one clone
        semantic = extract_semantic_ids(tok, finished[i])
        voice = padded_global_tokens(tok, finished[i], token_num) if i == 0 else glob
        wavs[i] = (pipe.detokenize(voice, semantic[None, :]), semantic.size)
    _sync(dev)
    launches = _counts()
    n_tokens = sum(len(v) for v in finished.values())
    summary = dict(requests=len(requests), tokens=n_tokens, decode_steps=steps,
                   dispatches=dispatches, deferrals=deferrals, serve_s=serve_s,
                   tokens_per_s=n_tokens / serve_s, ms_per_step=step_s * 1e3 / steps,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30
                   if dev.type == "cuda" else float("nan"))
    return dict(summary=summary, finished=finished, launches=launches, snapshot=snapshot,
                wavs=wavs)


def check_burst(label, pipe, run, requests, kernel, n_layers):
    """The engine phases' checks: every request finishes, with
    MAX_NEW_TOKENS ids or at its first EOS, all in its mode's guided set
    (clone: semantic ids and EOS only); `kernel` launched n_layers times per
    decode step and no other
    attention kernel; each vocoded waveform finite at 320 samples per
    semantic token."""
    import numpy as np

    launches, steps = run["launches"], run["summary"]["decode_steps"]
    print(f"{label}:", json.dumps(run["summary"]))
    print(f"launch counters over the {label} run:", json.dumps(launches))
    tok = pipe.tokenizer
    for i, (name, _, mode) in enumerate(requests):
        ids = run["finished"].get(i)
        if ids is None:
            raise AssertionError(f"{label}: {name} did not finish")
        # sampling may draw EOS, rarely, from random weights: a request ends
        # at its budget or at its one EOS, which it keeps
        eos = np.isin(ids, tok.eos_ids)
        ended = len(ids) == MAX_NEW_TOKENS or (len(ids) < MAX_NEW_TOKENS and bool(eos[-1]))
        if not ended or eos[:-1].any():
            raise AssertionError(f"{label}: {name} finished with {len(ids)} ids, EOS at "
                                 f"{np.flatnonzero(eos).tolist()}")
        if len(ids) < MAX_NEW_TOKENS:
            print(f"{label}: {name} drew EOS after {len(ids) - 1} ids")
        (lo, hi), extras = pipe.guided_constraint(mode)
        legal = ((ids >= lo) & (ids < hi)) | np.isin(ids, extras)
        if mode == "clone":
            legal &= ((ids >= tok.semantic_base) & (ids < tok.semantic_base + tok.n_semantic)
                      ) | np.isin(ids, tok.eos_ids)
        if not legal.all():
            raise AssertionError(f"{label}: {name} emitted ids outside its guided set")
    others = ("flash_attention_prefill", "dense_decode_attention", "paged_decode_attention")
    for name in others:
        want = n_layers * steps if name == kernel else 0
        if launches[name] != want:
            raise AssertionError(f"{label}: {launches[name]} {name} launches, expected {want}")
    if launches["int8_mlp_matvec"] or launches["int4_matvec"]:
        raise AssertionError(f"{label}: a quantized kernel launched in a bf16 run")
    if launches["fused_residual_unit"] != 2 * VOCODER_UNITS:
        raise AssertionError(f"{label}: expected {2 * VOCODER_UNITS} vocoder launches")
    bc = pipe.config.bicodec
    hop = int(np.prod(bc.decoder.rates) * np.prod(bc.prenet.sample_ratios))
    for i, (wav, n_sem) in run["wavs"].items():
        if not (n_sem > 0 and np.isfinite(wav).all() and len(wav) == n_sem * hop):
            raise AssertionError(f"{label}: {requests[i][0]} vocoded to {len(wav)} samples for "
                                 f"{n_sem} semantic tokens (want x{hop}, finite)")


def check_engine_forward(label, eng, snapshot, step_logits):
    """One decode step's guided logits through the engine's forward
    (`step_logits`) from the state after the first dispatch, on the card
    (its kernels) and on the CPU (the plain versions; params and state moved
    with .cpu()): within LOGITS_REL_TOL of the largest logit on every live
    row, and the card's argmax of each row within it of the CPU's top."""
    import torch

    from sparktts_tpu_torch.lm.sample import NEG_INF

    t0 = time.perf_counter()
    live = (snapshot.active & ~snapshot.done).cpu()
    allowed = eng.clone_allowed
    with torch.inference_mode():
        card = step_logits(eng.params, eng.cfg, _clone_state(snapshot), eng.vocab_slice,
                           eng.extra_ids, allowed).float().cpu()
        cpu = step_logits(_cpu(eng.params), eng.cfg, _clone_state(snapshot, "cpu"),
                          eng.vocab_slice, eng.extra_ids, allowed.cpu()).float()
    card, cpu = card[live], cpu[live]
    # clone rows hold -1e9 outside semantic ids and EOS: compare the rest
    legal = cpu > NEG_INF / 2
    if not torch.equal(legal, card > NEG_INF / 2):
        raise AssertionError(f"{label}: the card and the CPU mask different logits")
    scale, err = float(cpu[legal].abs().max()), float((card - cpu)[legal].abs().max())
    # random weights give near-flat logits over ~12k ids, where the top two
    # of a row may lie closer than bf16 noise: the card's pick must be the
    # CPU's, or within the tolerance of the CPU's largest logit of its row
    top_card, top_cpu = card.argmax(-1), cpu.argmax(-1)
    shortfall = cpu.max(-1).values - cpu.gather(1, top_card[:, None])[:, 0]
    print(f"{label} forward, card vs CPU, {int(live.sum())} live rows "
          f"({time.perf_counter() - t0:.1f} s): guided logits max|card - cpu| = {err:.4e}, "
          f"max|logit| = {scale:.4e}, relative {err / scale:.3e} (tol {LOGITS_REL_TOL}); "
          f"same argmax on {int((top_card == top_cpu).sum())} rows, the card's pick at most "
          f"{float(shortfall.max()):.4e} below the CPU's top logit of its row")
    if not (math.isfinite(err) and err <= LOGITS_REL_TOL * scale
            and float(shortfall.max()) <= LOGITS_REL_TOL * scale):
        raise AssertionError(f"{label}: the engine's forward on the card disagrees with the CPU")


def _time_paged(dev, q, kp, vp, table, lengths, layer, scale, label):
    """Kernel 6 at one state, timed: the kernel, its plain version, SDPA over
    a pre-gathered copy (the gather left out; a yardstick only, not the same
    function) and the bound over the valid keys.  Returns a `by_shape` item."""
    import torch
    import torch.nn.functional as F

    from sparktts_tpu_torch.kernels import paged_attention as pa

    b, hq, d = q.shape
    pps, page, hkv = table.shape[1], kp.shape[3], kp.shape[1]
    kernel = functools.partial(pa.paged_decode_attention, q, kp, vp, table, lengths, layer,
                               sm_scale=scale)
    plain = functools.partial(pa.paged_decode_plain, q, kp, vp, table, lengths, layer,
                              sm_scale=scale)
    ms, plain_ms = _time_ms(kernel, dev), _time_ms(plain, dev)
    idx = table.long()
    gathered = [x[layer][:, idx].transpose(0, 1).reshape(b, hkv, pps * page, d).contiguous()
                for x in (kp, vp)]
    mask = (torch.arange(pps * page, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], *gathered, attn_mask=mask, scale=scale, enable_gqa=True), dev)
    keys = int(torch.clamp(lengths, 0, pps * page).sum())
    nbytes = 2 * (2 * q.numel() + 2 * keys * hkv * d) + 4 * (table.numel() + b)
    bound_ms, bound_by = _bound(nbytes, 4 * d * hq * keys)
    print(f"paged_decode_attention {label} B={b} keys={keys}: device {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, SDPA over a pre-gathered copy, gather left out, {sdpa_ms:.4f}; bound "
          f"{bound_ms:.3e} by {bound_by}); eager call {_eager_ms(kernel, dev):.4f} ms "
          f"(plain {_eager_ms(plain, dev):.4f})")
    return dict(shape=f"{label} B={b} P={page} pps={pps} keys={keys}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_paged(dev, cfg, snapshot):
    """The paged kernel vs its plain version and vs the CPU model of its
    split (`paged_decode_split_plain`, run here on the card at the built
    kernel's chunk) on the paged engine's pools, table and lengths after its
    first dispatch; then, over the same pools through a full table of valid
    pages, at lengths 1, P, P + 1, the full table and one past it (a
    finished slot), and at a late state (every slot within a chunk of the
    full table).  Two calls of each case must give the same bits.  The
    engine's and the late state are timed.  Returns the kernels-line entry
    (without launches) with the engine state's times, both in `by_shape`."""
    import torch

    from sparktts_tpu_torch.kernels import paged_attention as pa

    hq, d, n_layers = cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers
    scale = d**-0.5
    kp, vp, table = snapshot.k_pages, snapshot.v_pages, snapshot.page_table
    b, pps = table.shape
    page = kp.shape[3]
    full = pps * page
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = snapshot.write_pos + 1
    # a full table of valid pages (not the trash page), in no order
    full_table = torch.randint(1, kp.shape[2], (b, pps), generator=gen, device=dev,
                               dtype=torch.int32)

    def made(values):
        return torch.tensor(values[:b], dtype=torch.int32, device=dev)

    cases = [("engine", table, lengths),
             ("made", full_table, made([1, page, page + 1, full, full + 1, 0, 2 * page - 1, 3])),
             ("late", full_table, made([full, full - 1, full - 24, full - 63, full + 1, full - 14,
                                        full - 25, full - 7]))]
    max_err = 0.0
    for name, tab, lens in cases:
        for layer in (0, n_layers - 1):
            got = pa.paged_decode_attention(q, kp, vp, tab, lens, layer, sm_scale=scale)
            again = pa.paged_decode_attention(q, kp, vp, tab, lens, layer, sm_scale=scale)
            want = pa.paged_decode_plain(q, kp, vp, tab, lens, layer, sm_scale=scale).float()
            split = pa.paged_decode_split_plain(q, kp, vp, tab, lens, layer, sm_scale=scale,
                                                chunk=pa.kernel_chunk()).float()
            _sync(dev)
            if not torch.equal(got, again):
                raise AssertionError(f"paged kernel: two calls differ ({name}, layer {layer})")
            got = got.float()
            err = float((got - want).abs().max())
            err_split = float((got - split).abs().max())
            print(f"paged_decode_attention {name} B={b} P={page} pps={pps} layer={layer} "
                  f"lengths={lens.tolist()}: max_abs_err={err:.3e}, vs the split model "
                  f"{err_split:.3e} (tol {KERNEL_ATOL}), two calls bit-equal")
            if not (bool(torch.isfinite(got).all()) and max(err, err_split) <= KERNEL_ATOL):
                raise AssertionError(f"paged kernel disagrees with its plain version: {err}, "
                                     f"{err_split} ({name})")
            max_err = max(max_err, err)

    layer = n_layers // 2
    timed = [_time_paged(dev, q, kp, vp, tab, lens, layer, scale, f"{name} state")
             for name, tab, lens in (cases[0], cases[2])]
    first = {k: v for k, v in timed[0].items() if k != "shape"}
    return dict(name="paged_decode_attention", route="cuda", source=pa.SOURCE,
                replaces=pa.REPLACES, max_abs_err=max_err, by_shape=timed, **first)


def check_decode_two_streams(dev, cfg):
    """Kernel 2 on two streams of one card at once, at the dense engine's
    shape (8 rows, S = 960, mixed windows): calls interleaved over the two
    streams, each stream merging on its own arrival counters; every result
    must match the plain version and its stream's first result bit for bit."""
    import torch

    from sparktts_tpu_torch.kernels import arrivals
    from sparktts_tpu_torch.kernels import decode_attention as da

    hq, hkv, d, n_layers = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                            cfg.num_hidden_layers)
    gen = torch.Generator(device=dev).manual_seed(10)
    shape = (n_layers, 8, DENSE_CACHE_LEN, hkv, d)
    start = torch.zeros(8, dtype=torch.int32, device=dev)
    cases = []
    for poss in ([447, 120, 560, 63, 959, 0, 300, 511], [959, 958, 64, 65, 128, 700, 1, 900]):
        q = torch.randn((8, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        ck, cv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        args = (q, ck, cv, n_layers - 1, start, torch.tensor(poss, dtype=torch.int32, device=dev))
        cases.append((args, da.dense_decode_plain(*args, sm_scale=d**-0.5).float()))
    streams = [torch.cuda.Stream() for _ in cases]
    outs = [[] for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(32):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(da.dense_decode_attention(*cases[i][0], sm_scale=d**-0.5))
    _sync(dev)
    if len({arrivals.stream_key(s) for s in streams} & set(arrivals.REGISTRY.keys())) != 2:
        raise AssertionError("decode kernel on two streams: not two sets of arrival counters")
    max_err = 0.0
    for (_, want), got in zip(cases, outs):
        if not all(torch.equal(got[0], o) for o in got):
            raise AssertionError("decode kernel on two streams: repeats differ")
        max_err = max(max_err, max(float((o.float() - want).abs().max()) for o in got))
    print(f"dense_decode_attention on two streams at once, 2 x 32 calls: max_abs_err={max_err:.3e} "
          f"(tol {KERNEL_ATOL}), each stream's calls bit-equal")
    if not max_err <= KERNEL_ATOL:
        raise AssertionError(f"decode kernel on two streams disagrees with plain: {max_err}")
    return max_err


def build_engines(pipe, greedy=False):
    """(paged, dense) engines over the pipeline's LM, sized as
    ContinuousTTSServer sizes them: the paged table holds the prompt region
    (4 prompt buckets, in pages), the budget and one spare page, and the
    pool half the worst case; the dense cache DENSE_CACHE_LEN."""
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
    from sparktts_tpu_torch.lm.paged import PagedContinuousEngine

    cfg, kw = pipe.config.llm, _engine_kwargs(pipe, greedy)
    prompt_cap = -(-4 * kw["prompt_pad"] // PAGE_SIZE)
    pages_per_slot = prompt_cap + -(-MAX_NEW_TOKENS // PAGE_SIZE) + 1
    n_pages = ENGINE_SLOTS * pages_per_slot // 2 + 1
    paged = PagedContinuousEngine(pipe.llm_params, cfg, max_slots=ENGINE_SLOTS, n_pages=n_pages,
                                  page_size=PAGE_SIZE, pages_per_slot=pages_per_slot, **kw)
    dense = ContinuousBatchingEngine(pipe.llm_params, cfg, max_slots=ENGINE_SLOTS,
                                     cache_len=DENSE_CACHE_LEN, **kw)
    return paged, dense


def run_engines(pipe, wav_path: Path):
    """Phases 12-15: the paged engine (as ContinuousTTSServer(paged=True)
    builds it) and the dense engine serve the same eight requests; each
    engine's forward card vs CPU; the paged kernel vs plain; the decode
    kernel at the dense engine's state.  Returns (the paged kernel's
    kernels-line entry, the decode kernel's `by_shape` item at the dense
    engine's state, the launches of the two runs, the dense engine's
    tokens/s)."""
    from sparktts_tpu_torch.lm.continuous import dense_step_logits
    from sparktts_tpu_torch.lm.paged import paged_step_logits

    cfg = pipe.config.llm
    requests, glob = engine_requests(pipe, wav_path)
    paged, dense = build_engines(pipe)
    n_pages, pages_per_slot = paged.slots.k_pages.shape[2], paged.pages_per_slot
    pool_bytes = paged.slots.k_pages.nbytes + paged.slots.v_pages.nbytes
    run_p = serve_burst("paged engine", pipe, paged, requests, glob)
    run_p["summary"].update(pool_bytes=pool_bytes, n_pages=n_pages, pages_per_slot=pages_per_slot,
                            page_size=PAGE_SIZE)
    check_burst("paged engine", pipe, run_p, requests, "paged_decode_attention",
                cfg.num_hidden_layers)
    if run_p["summary"]["deferrals"] < 1:
        raise AssertionError("paged engine: no admission was deferred")
    if paged.pages_in_use() != 0 or len(paged.free_pages) != n_pages - 1:
        raise AssertionError(f"paged engine: {paged.pages_in_use()} pages in use, "
                             f"{len(paged.free_pages)} free at the end")

    dense_bytes = dense.slots.cache.k.nbytes + dense.slots.cache.v.nbytes
    run_d = serve_burst("dense engine", pipe, dense, requests, glob)
    run_d["summary"].update(kv_bytes=dense_bytes, cache_len=DENSE_CACHE_LEN)
    check_burst("dense engine", pipe, run_d, requests, "dense_decode_attention",
                cfg.num_hidden_layers)
    print(f"KV memory: paged pool {pool_bytes / 2**20:.2f} MiB ({n_pages} pages of {PAGE_SIZE}), "
          f"dense cache {dense_bytes / 2**20:.2f} MiB ({ENGINE_SLOTS} x {DENSE_CACHE_LEN}), "
          f"ratio {pool_bytes / dense_bytes:.4f}")

    greedy = check_greedy_bursts(pipe, requests, glob)
    run_p["summary"]["greedy_graph_vs_eager"] = greedy["paged"]
    run_d["summary"]["greedy_graph_vs_eager"] = greedy["dense"]
    check_engine_forward("paged engine", paged, run_p["snapshot"], paged_step_logits)
    check_engine_forward("dense engine", dense, run_d["snapshot"], dense_step_logits)
    entry = check_paged(pipe.device, cfg, run_p["snapshot"])
    dense_state = check_dense_engine_decode(pipe.device, cfg, run_d["snapshot"])
    return (entry, dense_state, (run_p["launches"], run_d["launches"]),
            run_d["summary"]["tokens_per_s"])


def eager_generate(pipe, prompt, mode: str, seed: int, greedy: bool,
                   max_new: int = MAX_NEW_TOKENS):
    """The reference for the graph path: `generate`'s semantics as the step
    functions in a Python loop (prefill, then `decode_step` after
    `decode_step`, the done flag read every DONE_CHECK_EVERY steps), over a
    cache of `generate`'s length, with temperature and top_p as () device
    tensors as the decode unit holds them.  Returns (the ids, decode wall
    seconds after the prefill, decode steps)."""
    import torch

    from sparktts_tpu_torch.lm.generate import DONE_CHECK_EVERY, decode_step, prefill
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache

    dev, cfg, tok = pipe.device, pipe.config.llm, pipe.tokenizer
    ids_t, mask_t = pipe.prompt_inputs(prompt)
    t_pad = ids_t.shape[1]
    vs, ex = pipe.guided_constraint(mode)
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(seed)
        cache = init_kv_cache(cfg, 1, aligned_cache_len(t_pad + max_new), pipe.lm_dtype, dev)
        temperature, top_p = (torch.full((), v, dtype=torch.float32, device=dev)
                              for v in (0.8, 0.95))
        state = prefill(pipe.llm_params, cfg, ids_t, mask_t, cache, gen, 0.8, 50, 0.95, greedy,
                        vocab_slice=vs, extra_ids=ex)
        _sync(dev)
        t0 = time.perf_counter()
        toks, valid, steps = [], [], 0
        for step in range(max_new):
            toks.append(state.cur_token)
            valid.append(~state.done)
            if step + 1 == max_new:
                break
            state = decode_step(pipe.llm_params, cfg, state, t_pad, gen, temperature, 50, top_p,
                                tuple(tok.eos_ids), tok.pad_id, greedy, vs, ex)
            steps += 1
            if steps % DONE_CHECK_EVERY == 0 and bool(state.done.all()):
                break
        n = int(torch.stack(valid, 1)[0].sum())
        ids = torch.stack(toks, 1)[0, :n].cpu().numpy()
        decode_s = time.perf_counter() - t0
    return ids, decode_s, steps


def check_graph_vs_eager(label, pipe, prompt, mode, summary):
    """The graph path (`pipe.generate_tokens`, decode units replayed) against
    the eager loop (`eager_generate`) on one request: greedy ids bit-equal;
    sampled ids with the same seed equal, twice through the graphs and
    against the eager loop.  Adds the eager loop's decode ms a step to
    `summary`, beside the graph path's decode ms a token."""
    import numpy as np

    greedy_graph = pipe.generate_tokens(prompt, max_new_tokens=MAX_NEW_TOKENS, mode=mode,
                                        greedy=True)
    greedy_eager, _, _ = eager_generate(pipe, prompt, mode, SEED, greedy=True)
    sampled = [pipe.generate_tokens(prompt, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, mode=mode)
               for _ in range(2)]
    sampled_eager, eager_s, eager_steps = eager_generate(pipe, prompt, mode, SEED, greedy=False)
    summary.update(eager_decode_ms_per_step=eager_s * 1e3 / eager_steps,
                   eager_decode_steps=eager_steps,
                   graph_speedup_per_step=eager_s * 1e3 / eager_steps
                   / summary["decode_ms_per_token"])
    same = {"greedy graph == eager": np.array_equal(greedy_graph, greedy_eager),
            "sampled graph twice": np.array_equal(sampled[0], sampled[1]),
            "sampled graph == eager": np.array_equal(sampled[0], sampled_eager)}
    print(f"{label}, graph vs eager: {json.dumps(same)} ({len(greedy_graph)} greedy ids, "
          f"{len(sampled_eager)} sampled); decode {summary['decode_ms_per_token']:.3f} ms a token "
          f"through the graphs, {summary['eager_decode_ms_per_step']:.3f} ms a step eager "
          f"({summary['graph_speedup_per_step']:.2f}x)")
    if not all(same.values()):
        raise AssertionError(f"{label}: the graph path and the eager loop disagree: {same}")


def check_threads(pipe, prompts):
    """`generate_tokens` from three threads at once (two requests that share
    one decode unit, one of another): each gets the ids it gets alone."""
    import threading

    import numpy as np

    jobs = [(prompt, mode, SEED + i) for i, (prompt, mode) in enumerate(prompts)]
    alone = [pipe.generate_tokens(p, seed=sd, max_new_tokens=MAX_NEW_TOKENS, mode=m)
             for p, m, sd in jobs]
    got, errors = [None] * len(jobs), []

    def run(i):
        p, m, sd = jobs[i]
        try:
            got[i] = pipe.generate_tokens(p, seed=sd, max_new_tokens=MAX_NEW_TOKENS, mode=m)
        except Exception as e:  # reported below: a thread's error must fail the run
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"generate_tokens from threads: {errors or 'a thread hung'}")
    same = [bool(np.array_equal(a, b)) for a, b in zip(alone, got)]
    print(f"generate_tokens from {len(jobs)} threads at once ({wall:.2f} s): each thread's ids "
          f"equal its request alone: {same}")
    if not all(same):
        raise AssertionError("generate_tokens from threads: ids differ from the requests alone")


@contextlib.contextmanager
def eager_dispatch():
    """Inside the block both engines dispatch as their step functions in a
    Python loop, drawing from the engine's generator (the reference for the
    graph path): `dispatch_steps` replaced for the block, restored after."""
    from sparktts_tpu_torch.lm import continuous, graphs, paged

    def dispatch(kind, params, slots, n_steps, generator, make_step, static, units=None):
        new, toks, valid = continuous.scan_steps(n_steps, slots, make_step(generator))
        for mine, theirs in zip(graphs.tensors(slots), graphs.tensors(new)):
            if mine is not theirs:
                mine.copy_(theirs)
        return slots, continuous.pack_step_result(toks, valid, slots.done)

    saved = continuous.dispatch_steps, paged.dispatch_steps
    continuous.dispatch_steps = paged.dispatch_steps = dispatch
    try:
        yield
    finally:
        continuous.dispatch_steps, paged.dispatch_steps = saved


def check_greedy_bursts(pipe, requests, glob):
    """Greedy engines (paged and dense, built as `build_engines` builds
    them) serve the burst through their decode units and then, fresh, as
    the eager loop (`eager_dispatch`): every request's ids bit-equal.
    Returns {engine: (graph, eager) summaries}."""
    import numpy as np

    runs = {}
    for path in ("graph", "eager"):
        with eager_dispatch() if path == "eager" else contextlib.nullcontext():
            for name, eng in zip(("paged", "dense"), build_engines(pipe, greedy=True)):
                runs[name, path] = serve_burst(f"{name} engine, greedy, {path}", pipe, eng,
                                               requests, glob, vocode=False)
    out = {}
    for name in ("paged", "dense"):
        g, e = runs[name, "graph"]["summary"], runs[name, "eager"]["summary"]
        same = all(np.array_equal(runs[name, "graph"]["finished"][i],
                                  runs[name, "eager"]["finished"][i])
                   for i in range(len(requests)))
        print(f"{name} engine, greedy burst, graph vs eager: ids bit-equal: {same}; "
              f"{g['ms_per_step']:.3f} vs {e['ms_per_step']:.3f} ms a step "
              f"({e['ms_per_step'] / g['ms_per_step']:.2f}x), {g['tokens_per_s']:.1f} vs "
              f"{e['tokens_per_s']:.1f} tokens/s")
        if not same:
            raise AssertionError(f"{name} engine: greedy ids differ between graph and eager")
        out[name] = (g, e)
    return out


def run_streaming(pipe):
    """Voice creation streamed (`StreamingSynthesizer`, the default schedule:
    a 1 s first chunk growing x8, 0.1 s overlap, 25-step dispatches) after
    one warm-up stream, with every launch count 0 just before and read just
    after: one prefill, decode only through unit replays, one vocode per
    chunk; at least 3 finite chunks.  Prints the first-chunk latency and
    the total length against the offline path of the same seed
    (`generate_tokens` + `detokenize`).  Returns (summary, launches)."""
    import numpy as np

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.prompt import (
        build_control_prompt,
        extract_semantic_ids,
        padded_global_tokens,
    )
    from sparktts_tpu_torch.serve.streaming import StreamingSynthesizer

    dev, n_layers = pipe.device, pipe.config.llm.num_hidden_layers
    syn = StreamingSynthesizer(pipe)
    request = dict(seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **VOICE)
    list(syn.stream(TEXT, **request))  # warm-up: captures the streaming unit
    _sync(dev)
    _reset_counts()
    eager0 = graphs.KERNELS["dense_decode_attention"].launches
    chunks, first_s = [], None
    t0 = time.perf_counter()
    for wav in syn.stream(TEXT, **request):
        if first_s is None:
            first_s = time.perf_counter() - t0
        chunks.append(wav)
    total_s = time.perf_counter() - t0
    launches = _counts()
    streamed = np.concatenate(chunks)
    tok = pipe.tokenizer
    generated = pipe.generate_tokens(build_control_prompt(tok, TEXT, **VOICE), seed=SEED,
                                     max_new_tokens=MAX_NEW_TOKENS)
    glob = padded_global_tokens(tok, generated, pipe.config.bicodec.speaker_encoder.token_num)
    offline = pipe.detokenize(glob, extract_semantic_ids(tok, generated)[None, :])
    n = min(len(streamed), len(offline))
    rel = float(np.linalg.norm(streamed[:n] - offline[:n]) / (np.linalg.norm(offline[:n]) + 1e-12))
    audio_s = len(streamed) / pipe.sample_rate
    summary = dict(first_chunk_ms=first_s * 1e3, chunks=len(chunks),
                   chunk_samples=[len(c) for c in chunks], samples=int(len(streamed)),
                   offline_samples=int(len(offline)), relative_l2_to_offline=rel,
                   stream_s=total_s, audio_s=audio_s, rtf=total_s / audio_s)
    print("streaming, voice creation:", json.dumps(summary))
    print("launch counters over the stream:", json.dumps(launches))
    if len(chunks) < 3 or not np.isfinite(streamed).all():
        raise AssertionError(f"streaming: {len(chunks)} chunks, finite: "
                             f"{bool(np.isfinite(streamed).all())}")
    if launches["flash_attention_prefill"] != n_layers:
        raise AssertionError("streaming: expected one prefill")
    decode = launches["dense_decode_attention"]
    eager = graphs.KERNELS["dense_decode_attention"].launches - eager0
    if decode == 0 or decode % n_layers or eager:
        raise AssertionError(f"streaming: {decode} decode launches, not all from unit replays")
    if launches["fused_residual_unit"] == 0 or launches["fused_residual_unit"] % VOCODER_UNITS:
        raise AssertionError("streaming: expected whole vocodes of the chunks")
    return summary, launches


def check_units(n_layers: int):
    """Every captured decode unit: its capture ms, graph-pool MiB, replays,
    its warm-up's launches (set-up on scratch buffers, counted apart), and
    its launches a unit (`n_layers` x U of its attention kernel, a multiple
    of n_layers x U of each other decode kernel, as many as its warm-up
    launched).  Returns the units' summaries."""
    from sparktts_tpu_torch.lm import graphs

    out = []
    for u in graphs.units():
        attn = "paged_decode_attention" if u.name.startswith("paged") else "dense_decode_attention"
        per_unit = {k: v for k, v in u.unit_launches.items() if v}
        item = dict(name=u.name, steps=u.steps, replays=u.replays, capture_ms=u.capture_ms,
                    pool_mib=u.pool_bytes / 2**20, launches_per_unit=per_unit,
                    warm_up_launches={k: v for k, v in u.setup_launches.items() if v})
        print("decode unit:", json.dumps(item))
        out.append(item)
        if (u.unit_launches[attn] != n_layers * u.steps or u.setup_launches != u.unit_launches
                or any(v % (n_layers * u.steps) for v in per_unit.values())):
            raise AssertionError(f"{u.name}: launches a unit {per_unit}")
    return out


def check_failed_capture(dev):
    """A decode unit whose step reads a value on the host (a sync, which a
    capture refuses) raises at capture, and is not kept."""
    import torch

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import GenState

    state = GenState(*(torch.zeros(2, dtype=torch.long, device=dev) for _ in range(6)))

    def make_scan(_generator):
        def scan(s):
            int(s.cur_token[0])  # a host read inside the step
            return s, s.cur_token[:, None], s.done[:, None].bool()
        return scan

    n = graphs.builds()
    try:
        graphs.unit(("failing",), dev, lambda: graphs.DecodeUnit(make_scan, state, 1))
    except RuntimeError as e:
        print(f"a capture with a host read inside raises: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]}")
    else:
        raise AssertionError("a capture with a host read inside did not raise")
    if graphs.builds() != n or ("failing",) in graphs.SHARED:
        raise AssertionError("a failed capture was kept")
    torch.ones(1, device=dev).add_(1)
    _sync(dev)


# ---------------------------------------------------------------------------
# a checkpoint with torch names, written from a seed
# ---------------------------------------------------------------------------

def write_safetensors(path: Path, tensors: dict) -> None:
    """A safetensors file of `tensors`: an 8-byte little-endian header
    length, the JSON header (dtype, shape, byte offsets), then each tensor's
    bytes in order."""
    import struct

    import torch

    from sparktts_tpu_torch.checkpoint import SAFETENSORS_DTYPES

    names = {dtype: name for name, dtype in SAFETENSORS_DTYPES.items()}
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu().reshape(-1)
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype],
                        "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in blobs:
            f.write(t.view(torch.uint8).numpy().data)


SPARK_SPECIAL_TOKENS = (
    ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    + [f"<|task_{t}|>" for t in ("vc", "tts", "asr", "s2s", "t2s", "understand", "cap",
                                 "controllable_tts", "prompt_tts", "edit")]
    + ["<|start_content|>", "<|end_content|>", "<|start_global_token|>", "<|end_global_token|>",
       "<|start_semantic_token|>", "<|end_semantic_token|>", "<|start_style_label|>",
       "<|end_style_label|>"]
    + [f"<|gender_{i}|>" for i in range(2)]
    + [f"<|pitch_label_{i}|>" for i in range(5)]
    + [f"<|speed_label_{i}|>" for i in range(5)]
)


def write_spark_tokenizer(llm_dir: Path, n_semantic: int, n_global: int,
                          merges: int = 20) -> None:
    """A byte-level BPE tokenizer with `merges` merges learned from a fixed
    text, the Spark-TTS special tokens, then `n_semantic` semantic and
    `n_global` global codec tokens (contiguous ids), saved as
    `tokenizer.json` with a `tokenizer_config.json` naming EOS and pad, the
    files of a checkpoint's `LLM/` directory."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    trainer = trainers.BpeTrainer(vocab_size=len(alphabet) + merges, initial_alphabet=alphabet,
                                  show_progress=False)
    tok.train_from_iterator([TEXT, PROMPT_TEXT] * 4, trainer)
    tok.add_special_tokens(SPARK_SPECIAL_TOKENS
                           + [f"<|bicodec_semantic_{i}|>" for i in range(n_semantic)]
                           + [f"<|bicodec_global_{i}|>" for i in range(n_global)])
    llm_dir.mkdir(parents=True, exist_ok=True)
    tok.save(str(llm_dir / "tokenizer.json"))
    (llm_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>", "clean_up_tokenization_spaces": False}))


def qwen_torch_shapes(cfg) -> dict:
    """{name: shape} of an HF Qwen2ForCausalLM state dict of `cfg`
    (`lm_head.weight` when untied)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h), "model.norm.weight": (h,)}
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}"
        for name, out in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
            shapes[f"{pre}.self_attn.{name}.weight"] = (out, h)
            shapes[f"{pre}.self_attn.{name}.bias"] = (out,)
        shapes.update({
            f"{pre}.self_attn.o_proj.weight": (h, q),
            f"{pre}.input_layernorm.weight": (h,),
            f"{pre}.post_attention_layernorm.weight": (h,),
            f"{pre}.mlp.gate_proj.weight": (inter, h),
            f"{pre}.mlp.up_proj.weight": (inter, h),
            f"{pre}.mlp.down_proj.weight": (h, inter),
        })
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (cfg.vocab_size, h)
    return shapes


def wav2vec2_torch_shapes(cfg) -> dict:
    """{name: shape} of an HF Wav2Vec2Model state dict of `cfg` (layer-norm
    feature extractor, weight-normed positional conv)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    shapes, c_in = {}, 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        pre = f"feature_extractor.conv_layers.{i}"
        shapes.update({f"{pre}.conv.weight": (dim, c_in, k), f"{pre}.conv.bias": (dim,),
                       f"{pre}.layer_norm.weight": (dim,), f"{pre}.layer_norm.bias": (dim,)})
        c_in = dim
    k, groups = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    shapes.update({
        "feature_projection.layer_norm.weight": (c_in,),
        "feature_projection.layer_norm.bias": (c_in,),
        "feature_projection.projection.weight": (h, c_in),
        "feature_projection.projection.bias": (h,),
        "encoder.pos_conv_embed.conv.weight_g": (1, 1, k),
        "encoder.pos_conv_embed.conv.weight_v": (h, h // groups, k),
        "encoder.pos_conv_embed.conv.bias": (h,),
        "encoder.layer_norm.weight": (h,),
        "encoder.layer_norm.bias": (h,),
    })
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}.attention.{name}.weight"] = (h, h)
            shapes[f"{pre}.attention.{name}.bias"] = (h,)
        for name in ("layer_norm", "final_layer_norm"):
            shapes[f"{pre}.{name}.weight"] = (h,)
            shapes[f"{pre}.{name}.bias"] = (h,)
        shapes.update({f"{pre}.feed_forward.intermediate_dense.weight": (inter, h),
                       f"{pre}.feed_forward.intermediate_dense.bias": (inter,),
                       f"{pre}.feed_forward.output_dense.weight": (h, inter),
                       f"{pre}.feed_forward.output_dense.bias": (h,)})
    return shapes


def bicodec_torch_shapes(cfg) -> dict:
    """{name: shape} of the BiCodec `model.safetensors` of `cfg` (the torch
    module tree: feat encoder, FVQ, ECAPA + Perceiver + FSQ speaker encoder,
    prenet/postnet feat decoders, the weight-normed WaveGenerator)."""
    shapes = {}

    def lin(pre, i, o, bias=True):
        shapes[f"{pre}.weight"] = (o, i)
        if bias:
            shapes[f"{pre}.bias"] = (o,)

    def conv(pre, ci, co, k, groups=1, transposed=False):
        shapes[f"{pre}.weight"] = (ci, co // groups, k) if transposed else (co, ci // groups, k)
        shapes[f"{pre}.bias"] = (co,)

    def wnconv(pre, ci, co, k, transposed=False):
        shapes[f"{pre}.weight_g"] = (ci if transposed else co, 1, 1)
        shapes[f"{pre}.weight_v"] = (ci, co, k) if transposed else (co, ci, k)
        shapes[f"{pre}.bias"] = (co,)

    def norm(pre, c, stats=False):
        shapes[f"{pre}.weight"] = (c,)
        shapes[f"{pre}.bias"] = (c,)
        if stats:
            shapes[f"{pre}.running_mean"] = (c,)
            shapes[f"{pre}.running_var"] = (c,)

    def vocos(pre, cin, dim, inter, layers, cond=None):
        conv(f"{pre}.embed", cin, dim, 7)
        for b in [f"{pre}.convnext.{i}" for i in range(layers)] + [pre]:
            if cond:
                lin(f"{b}.norm.scale", cond, dim)
                lin(f"{b}.norm.shift", cond, dim)
            else:
                norm(f"{b}.norm", dim)
        for i in range(layers):
            b = f"{pre}.convnext.{i}"
            conv(f"{b}.dwconv", dim, dim, 7, groups=dim)
            lin(f"{b}.pwconv1", dim, inter)
            lin(f"{b}.pwconv2", inter, dim)
            shapes[f"{b}.gamma"] = (dim,)
        norm(f"{pre}.final_layer_norm", dim)

    e = cfg.encoder
    vocos("encoder.encoder", e.input_channels, e.vocos_dim, e.vocos_intermediate_dim,
          e.vocos_num_layers)
    for j, r in enumerate(e.sample_ratios):
        if r > 1:
            conv(f"encoder.downsample.{j}.0.conv_downsampler.1", e.vocos_dim, e.vocos_dim, 2 * r,
                 groups=e.vocos_dim)
        vocos(f"encoder.downsample.{j}.1", e.vocos_dim, e.vocos_dim, e.vocos_intermediate_dim, 2)
    lin("encoder.project", e.vocos_dim, e.out_channels)
    q = cfg.quantizer
    shapes["quantizer.codebook.weight"] = (q.codebook_size, q.codebook_dim)
    wnconv("quantizer.in_project", q.input_dim, q.codebook_dim, 1)
    wnconv("quantizer.out_project", q.codebook_dim, q.input_dim, 1)
    s = cfg.speaker_encoder
    c, ctx = s.ecapa_channels, s.perceiver_dim_context
    pre = "speaker_encoder.speaker_encoder"
    conv(f"{pre}.layer1.conv", s.input_dim, c, 5)
    norm(f"{pre}.layer1.bn", c, stats=True)
    for li in (2, 3, 4):
        b = f"{pre}.layer{li}.se_res2block"
        for part in ("0", "2"):
            conv(f"{b}.{part}.conv", c, c, 1)
            norm(f"{b}.{part}.bn", c, stats=True)
        for i in range(7):
            conv(f"{b}.1.convs.{i}", c // 8, c // 8, 3)
            norm(f"{b}.1.bns.{i}", c // 8, stats=True)
        lin(f"{b}.3.linear1", c, 128)
        lin(f"{b}.3.linear2", 128, c)
    conv(f"{pre}.conv", 3 * c, ctx, 1)
    conv(f"{pre}.pool.linear1", 3 * ctx, 128, 1)
    conv(f"{pre}.pool.linear2", 128, ctx, 1)
    norm(f"{pre}.bn", 2 * ctx, stats=True)
    lin(f"{pre}.linear", 2 * ctx, s.out_dim)
    pp = "speaker_encoder.perceiver_sampler"
    shapes[f"{pp}.latents"] = (s.token_num, s.latent_dim)
    lin(f"{pp}.proj_context", ctx, s.latent_dim)
    inner = s.perceiver_dim_head * s.perceiver_heads
    ff_inner = int(s.latent_dim * s.perceiver_ff_mult * 2 / 3)
    for i in range(s.perceiver_depth):
        lin(f"{pp}.layers.{i}.0.to_q", s.latent_dim, inner, bias=False)
        lin(f"{pp}.layers.{i}.0.to_kv", s.latent_dim, 2 * inner, bias=False)
        lin(f"{pp}.layers.{i}.0.to_out", inner, s.latent_dim, bias=False)
        lin(f"{pp}.layers.{i}.1.0", s.latent_dim, 2 * ff_inner)
        lin(f"{pp}.layers.{i}.1.2", ff_inner, s.latent_dim)
    shapes[f"{pp}.norm.gamma"] = (s.latent_dim,)
    lin("speaker_encoder.quantizer.project_in", s.latent_dim, len(s.fsq_levels))
    lin("speaker_encoder.quantizer.project_out", len(s.fsq_levels), s.latent_dim)
    lin("speaker_encoder.project", s.latent_dim * s.token_num, s.out_dim)
    for name, dc in (("prenet", cfg.prenet), ("postnet", cfg.postnet)):
        lin(f"{name}.linear_pre", dc.input_channels, dc.vocos_dim)
        for j, r in enumerate(dc.sample_ratios):
            if r > 1:
                conv(f"{name}.downsample.{j}.0.de_conv_upsampler.1", dc.vocos_dim, dc.vocos_dim,
                     2 * r, groups=dc.vocos_dim, transposed=True)
            vocos(f"{name}.downsample.{j}.1", dc.vocos_dim, dc.vocos_dim,
                  dc.vocos_intermediate_dim, 2)
        vocos(f"{name}.vocos_backbone", dc.vocos_dim, dc.vocos_dim, dc.vocos_intermediate_dim,
              dc.vocos_num_layers, cond=dc.condition_dim)
        lin(f"{name}.linear", dc.vocos_dim, dc.out_channels)
    w = cfg.decoder
    wnconv("decoder.model.0", w.input_channel, w.channels, 7)
    for i, k in enumerate(w.kernel_sizes):
        ci, co = w.channels // 2**i, w.channels // 2 ** (i + 1)
        b = f"decoder.model.{1 + i}.block"
        shapes[f"{b}.0.alpha"] = (1, ci, 1)
        wnconv(f"{b}.1", ci, co, k, transposed=True)
        for ru in range(3):
            shapes[f"{b}.{2 + ru}.block.0.alpha"] = (1, co, 1)
            wnconv(f"{b}.{2 + ru}.block.1", co, co, 7)
            shapes[f"{b}.{2 + ru}.block.2.alpha"] = (1, co, 1)
            wnconv(f"{b}.{2 + ru}.block.3", co, co, 1)
    last = w.channels // 2 ** len(w.rates)
    shapes[f"decoder.model.{len(w.rates) + 1}.alpha"] = (1, last, 1)
    wnconv(f"decoder.model.{len(w.rates) + 2}", last, w.d_out, 7)
    return shapes


def random_state(shapes: dict, gen, device, dtype, std: float = 0.02) -> dict:
    """Tensors of `shapes` from `gen`, as a freshly built torch model holds
    them: norm gains, BatchNorm variances, snake alphas and weight-norm
    gains 1, biases and running means 0, ConvNeXt layer scales 0.1, the FVQ
    codebook N(0, 1), every other weight N(0, std).  Returned on the CPU."""
    import torch

    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean"):
            t = torch.zeros(shape, device=device)
        elif (leaf in ("running_var", "alpha", "weight_g") or name.endswith("norm.gamma")
              or (leaf == "weight" and len(shape) == 1)):
            t = torch.ones(shape, device=device)
        elif leaf == "gamma":
            t = torch.full(shape, 0.1, device=device)
        else:
            scale = 1.0 if name.endswith("codebook.weight") else std
            t = scale * torch.randn(shape, generator=gen, device=device)
        out[name] = t.to(dtype).cpu()
    return out


def write_config_files(model_dir: Path, config=None) -> None:
    """A checkpoint directory's config files: the Spark-TTS-0.5B fixture's,
    or those of `config` (a SparkTTSConfig, e.g. the tiny test config)."""
    import dataclasses
    import shutil

    files = ("config.yaml", "BiCodec/config.yaml", "LLM/config.json",
             "wav2vec2-large-xlsr-53/config.json")
    for rel in files:
        (model_dir / rel).parent.mkdir(parents=True, exist_ok=True)
    if config is None:
        fixture = REPO / "tests" / "fixtures" / "spark_tts_0.5b"
        for rel in files:
            shutil.copy(fixture / rel, model_dir / rel)
        return
    import yaml

    def plain(obj):
        return json.loads(json.dumps(dataclasses.asdict(obj)))  # tuples -> lists

    root = {k: getattr(config, k) for k in ("sample_rate", "highpass_cutoff_freq",
                                            "latent_hop_length", "ref_segment_duration",
                                            "volume_normalize")}
    (model_dir / files[0]).write_text(yaml.safe_dump(root))
    (model_dir / files[1]).write_text(yaml.safe_dump({"audio_tokenizer": plain(config.bicodec)}))
    (model_dir / files[2]).write_text(json.dumps(plain(config.llm)))
    (model_dir / files[3]).write_text(json.dumps(plain(config.wav2vec2)))


def write_checkpoint(model_dir: Path, dev, seed: int = SEED, config=None, llm_dtype=None,
                     std: float = 0.02) -> dict:
    """A Spark-TTS checkpoint directory with torch names and random weights
    from `seed` (`random_state`, weights N(0, std)): the config files
    (`write_config_files`: the 0.5B fixture's, or `config`'s), a tokenizer
    (`write_spark_tokenizer`), `LLM/model.safetensors` in `llm_dtype`
    (default BF16, the published dtype), `BiCodec/model.safetensors` and
    `wav2vec2-large-xlsr-53/model.safetensors` in fp32.  Returns the bytes
    of each weight file."""
    import torch

    from sparktts_tpu_torch.config import load_spark_config

    write_config_files(model_dir, config)
    cfg = load_spark_config(model_dir)
    bc = cfg.bicodec
    # at least 101 semantic tokens: a tokenizer is checked contiguous up to id 100
    write_spark_tokenizer(model_dir / "LLM", max(bc.quantizer.codebook_size, 101),
                          int(math.prod(bc.speaker_encoder.fsq_levels)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = {}
    for rel, shapes, dtype in (
        ("LLM/model.safetensors", qwen_torch_shapes(cfg.llm), llm_dtype or torch.bfloat16),
        ("BiCodec/model.safetensors", bicodec_torch_shapes(bc), torch.float32),
        ("wav2vec2-large-xlsr-53/model.safetensors", wav2vec2_torch_shapes(cfg.wav2vec2),
         torch.float32),
    ):
        write_safetensors(model_dir / rel, random_state(shapes, gen, dev, dtype, std))
        sizes[rel] = (model_dir / rel).stat().st_size
    return sizes


def _tree_signature(tree, prefix=""):
    """{path: (shape, dtype)} of a param tree's leaves."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _tree_signature(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _tree_signature(sub, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


def check_prefill_on_cpu(pipe, cpu_pipe, prompt, label):
    """Full-vocabulary last-position prefill logits of `prompt` (its bucket
    of 64) through the flash kernel on the card and through its plain
    version on the CPU: within LOGITS_REL_TOL of the largest logit."""
    import torch

    from sparktts_tpu_torch.lm.qwen import init_kv_cache, prefill_positions, qwen_forward

    logits = {}
    for side, p in (("card", pipe), ("cpu", cpu_pipe)):
        ids, mask = p.prompt_inputs(prompt)
        t_pad = ids.shape[1]
        start = (t_pad - mask.sum(1)).to(torch.int32)
        with torch.inference_mode():
            cache = init_kv_cache(p.config.llm, 1, t_pad, p.lm_dtype, p.device)
            out, _ = qwen_forward(p.llm_params, p.config.llm, ids, prefill_positions(mask), cache,
                                  0, None, flash_start=start, logits_last_only=True)
        logits[side] = out[0, -1].float().cpu()
    card, cpu = logits["card"], logits["cpu"]
    scale, err = float(cpu.abs().max()), float((card - cpu).abs().max())
    print(f"{label}: prefill logits of a {len(prompt)}-token prompt (bucket {t_pad}, vocab "
          f"{card.numel()}), card vs CPU: max|card - cpu| = {err:.4e}, max|logit| = {scale:.4e}, "
          f"relative {err / scale:.3e} (tol {LOGITS_REL_TOL}), same argmax: "
          f"{int(card.argmax()) == int(cpu.argmax())}")
    if not (math.isfinite(err) and err <= LOGITS_REL_TOL * scale):
        raise AssertionError(f"{label}: prefill logits on the card disagree with the CPU")


def run_checkpoint(pipe, wav_path: Path):
    """Phase 19: a full-width checkpoint with torch names (`write_checkpoint`)
    loaded through `SparkTTSPipeline(model_dir=...)`: read, convert and
    upload seconds and the card's peak memory; every tree with the keys,
    shapes and dtypes of the random init at full width; one creation and
    one clone request with the launch counts of phases 3 and 4; prefill
    logits card vs the same directory loaded on the CPU.  The directory is
    deleted after.  Returns (summary, [launches of the two requests])."""
    import shutil

    import torch

    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.prompt import build_control_prompt

    dev = pipe.device
    model_dir = OUT_DIR / "ckpt"
    shutil.rmtree(model_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        sizes = write_checkpoint(model_dir, dev)
        write_s = time.perf_counter() - t0
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        cp = SparkTTSPipeline(model_dir=model_dir, device=dev)
        load_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
        summary = dict(write_s=write_s, file_bytes=sizes, load_s=load_s, **cp.load_seconds,
                       peak_load_gib=peak,
                       tokenizer=type(cp.tokenizer).__name__,
                       semantic_base=cp.tokenizer.semantic_base,
                       global_base=cp.tokenizer.global_base)
        print("checkpoint load:", json.dumps(summary))
        for name, got, want in (("LM", cp.llm_params, pipe.llm_params),
                                ("BiCodec", cp.bicodec_params, pipe.bicodec_params),
                                ("wav2vec2", cp.w2v_params, pipe.w2v_params)):
            g, w = _tree_signature(got), _tree_signature(want)
            if g != w:
                diff = sorted(set(g.items()) ^ set(w.items()))[:6]
                raise AssertionError(f"checkpoint: the loaded {name} tree is not the init's: "
                                     f"{diff}")
            print(f"checkpoint: the {name} tree has the init's {len(g)} leaves, shapes and "
                  f"dtypes")
        creation = run_voice_creation(cp, label="checkpoint: voice creation")
        cloning = run_voice_cloning(cp, wav_path, label="checkpoint: voice cloning")
        summary.update(creation_rtf=creation[2]["rtf"], cloning_rtf=cloning[2]["rtf"],
                       peak_request_gib=max(creation[2]["peak_mem_gib"],
                                            cloning[2]["peak_mem_gib"]))
        prompt = build_control_prompt(cp.tokenizer, TEXT, **VOICE)
        t0 = time.perf_counter()
        cpu_pipe = SparkTTSPipeline(model_dir=model_dir, device="cpu")
        summary["cpu_load_s"] = time.perf_counter() - t0
        check_prefill_on_cpu(cp, cpu_pipe, prompt, "checkpoint")
        del cpu_pipe, cp
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    return summary, [creation[0], cloning[0]]


def run_untied(pipe, creation_prompt):
    """Phase 20: the untied LM head.  The creation request on an LM with
    `tie_word_embeddings=False` (the bf16 params plus a random (896, 166000)
    head): 100 greedy ids through the decode unit equal to the eager loop's,
    with the launch counts of a request's generate; then one decode step of
    the int8 and of the int4 LM (head quantized too) card vs CPU.  Returns
    the generate's launches.  (The random head leaves near ties among the
    ~12k guided logits, so the quantized steps take the engines' argmax
    rule, `near_tie_ok`.)"""
    import dataclasses

    import numpy as np
    import torch

    from sparktts_tpu_torch.lm.quant import quantize_qwen_int4, quantize_qwen_int8
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    dev, n_layers, steps = pipe.device, pipe.config.llm.num_hidden_layers, 100
    llm = dataclasses.replace(pipe.config.llm, tie_word_embeddings=False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    head = {"w": (0.02 * torch.randn((llm.hidden_size, llm.vocab_size), generator=gen,
                                     device=dev)).to(pipe.lm_dtype)}
    up = SparkTTSPipeline(config=dataclasses.replace(pipe.config, llm=llm), device=dev,
                          llm_params=dict(pipe.llm_params, lm_head=head),
                          bicodec_params=pipe.bicodec_params, wav2vec2_params=pipe.w2v_params)
    up.generate_tokens(creation_prompt, greedy=True, max_new_tokens=steps)  # captures the unit
    _sync(dev)
    _reset_counts()
    graph = up.generate_tokens(creation_prompt, greedy=True, max_new_tokens=steps)
    _sync(dev)
    launches = _counts()
    eager, _, _ = eager_generate(up, creation_prompt, "control", SEED, greedy=True, max_new=steps)
    same = bool(np.array_equal(graph, eager))
    print(f"untied head, bf16: {len(graph)} greedy ids through the decode unit equal the eager "
          f"loop's: {same}; launches {json.dumps(launches)}")
    if not same or len(graph) == 0:
        raise AssertionError("untied head: the graph path and the eager loop disagree")
    if (launches["flash_attention_prefill"] != n_layers or launches["dense_decode_attention"] == 0
            or launches["dense_decode_attention"] % n_layers):
        raise AssertionError(f"untied head: launches {launches}")
    bf16 = up.llm_params
    for label, params in (("untied int8 LM", quantize_qwen_int8(bf16)),
                          ("untied int4 LM", quantize_qwen_int4(bf16, group=INT4_GROUP))):
        if set(params["lm_head"]) != ({"w_q", "scale"} if "int8" in label else {"w_p4", "gscale"}):
            raise AssertionError(f"{label}: head {sorted(params['lm_head'])}")
        check_decode_step_on_cpu(up, params, label, creation_prompt, "control", near_tie_ok=True)
    return launches


BATCH_SEEDS = [7, 9, 7, 5]
BATCH_TEXTS = (TEXT, "A second voice speaks here.", TEXT, "Four at once.")
BATCH_PROMPT_TEXTS = (PROMPT_TEXT, None, PROMPT_TEXT, "Half as long.")
BATCH_SECONDS = (6.0, 4.0, 6.0, 3.0)


def check_batch_kernels(dev, pipe, shapes):
    """Kernels 1, 2 and 3 at the shapes of the batch phase: flash prefill at
    its B = 4 bucket with the rows' ragged left-pad starts, decode over its
    B = 4 cache at the middle and last step's windows (first and last
    layer; the middle step timed), the ResidualUnit on a B = 4 vocode of
    its longest row's bucket; each against its plain version, two calls
    bit-equal.  Returns {kernel: (error, `by_shape` item)}."""
    import torch

    from sparktts_tpu_torch.lm.qwen import aligned_cache_len

    cfg = pipe.config.llm
    b, t_pad, starts, steps = shapes["batch"], shapes["t_pad"], shapes["starts"], shapes["steps"]
    scale = cfg.head_dim**-0.5
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    inputs = _flash_inputs(dev, cfg, gen, b, t_pad, starts)
    err = _check_flash_case(dev, *inputs, scale)
    out["flash_attention_prefill"] = (err, _time_flash(dev, *inputs, scale,
                                                       f"B={b} T={t_pad} starts={starts}"))
    s = aligned_cache_len(t_pad + MAX_NEW_TOKENS)
    shape = (cfg.num_hidden_layers, b, s, cfg.num_key_value_heads, cfg.head_dim)
    q = torch.randn((b, cfg.num_attention_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    err = 0.0
    for pos in (t_pad + steps // 2, t_pad + steps - 1):
        po = torch.full((b,), pos, dtype=torch.int32, device=dev)
        for layer in (0, cfg.num_hidden_layers - 1):
            err = max(err, _check_decode_case(dev, q, ck, cv, layer, st, po, scale,
                                              f"batch B={b} S={s} layer={layer} pos={pos}"))
    po = torch.full((b,), t_pad + steps // 2, dtype=torch.int32, device=dev)
    out["dense_decode_attention"] = (err, _time_decode(
        dev, q, ck, cv, cfg.num_hidden_layers // 2, st, po, scale,
        f"batch B={b} S={s} pos={t_pad + steps // 2}"))
    voc = check_vocoder(dev, pipe.config.bicodec.decoder, [shapes["vocode_tokens"]], batch=b)
    out["fused_residual_unit"] = (voc["max_abs_err"], voc["by_shape"][0])
    return out


def run_batch(pipe, wav_path: Path, b1_tokens_per_s: float):
    """Phase 21: the batch surfaces at B = 4.  Four clone prompts (rows 0
    and 2 one prompt; the others of other wav and text lengths) tokenized
    as one batch, also assembled on the device (`clone_batch_inputs`, equal
    to `build_clone_prompt`); `generate_tokens_batch` with per-row seeds
    [7, 9, 7, 5] and `detokenize_batch`, counters 0 just before and read
    just after (one prefill, 24 decode launches a step, one vocode).  Rows 0
    and 2 equal; the rows swapped with their seeds give every row's ids
    again, sampled and greedy; greedy ids equal `generate_and_vocode_batch`'s
    (one host fetch), whose waveforms are finite, 320 samples a semantic
    token; kernels 1, 2 and 3 at these shapes against their plain versions.
    Returns (summary, launches, kernel checks)."""
    import numpy as np

    from sparktts_tpu_torch.io.audio import load_audio
    from sparktts_tpu_torch.prompt import build_clone_prompt, extract_semantic_ids

    dev, tok, cfg = pipe.device, pipe.tokenizer, pipe.config
    n_layers, hop = cfg.llm.num_hidden_layers, pipe._wave_upsample
    full = load_audio(wav_path, sampling_rate=pipe.sample_rate,
                      volume_normalize=cfg.volume_normalize)
    wavs = [full[: int(sec * pipe.sample_rate)] for sec in BATCH_SECONDS]
    g_dev, s_dev, counts = pipe.tokenize_audio_batch_device(wavs)
    g_host, s_host = g_dev.cpu().numpy(), s_dev.cpu().numpy()
    prompts = [build_clone_prompt(tok, text, g_host[i], s_host[i, : counts[i]] if pt else None, pt)
               for i, (text, pt) in enumerate(zip(BATCH_TEXTS, BATCH_PROMPT_TEXTS))]
    ids_dev, mask_dev = pipe.clone_batch_inputs(BATCH_TEXTS, g_dev, s_dev, counts,
                                                BATCH_PROMPT_TEXTS)
    assembled = [ids_dev[i][mask_dev[i]].tolist() for i in range(len(prompts))]
    if assembled != prompts or prompts[0] != prompts[2] or len(set(map(len, prompts))) != 3:
        raise AssertionError(f"batch: device-assembled prompts {[len(a) for a in assembled]} vs "
                             f"host {[len(p) for p in prompts]}")
    request = dict(max_new_tokens=MAX_NEW_TOKENS, mode="clone")
    pipe.generate_tokens_batch(prompts, seed=BATCH_SEEDS, **request)  # captures the B = 4 unit
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    sampled = pipe.generate_tokens_batch(prompts, seed=BATCH_SEEDS, **request)
    _sync(dev)
    generate_s = time.perf_counter() - t0
    semantic = [extract_semantic_ids(tok, ids) for ids in sampled]
    t0 = time.perf_counter()
    wavs_out = pipe.detokenize_batch(g_host, semantic)
    vocode_s = time.perf_counter() - t0
    launches = _counts()
    steps = launches["dense_decode_attention"] // n_layers
    tokens = sum(len(ids) for ids in sampled)
    summary = dict(batch=len(prompts), prompt_tokens=[len(p) for p in prompts],
                   t_pad=int(ids_dev.shape[1]), generated_tokens=[len(x) for x in sampled],
                   decode_steps=steps, generate_s=generate_s, vocode_s=vocode_s,
                   tokens_per_s=tokens / generate_s, b1_tokens_per_s=b1_tokens_per_s,
                   speedup_over_b1=tokens / generate_s / b1_tokens_per_s)
    print("batch, B = 4:", json.dumps(summary))
    print("launch counters over generate_tokens_batch + detokenize_batch:", json.dumps(launches))
    if (launches["flash_attention_prefill"] != n_layers or steps == 0
            or launches["dense_decode_attention"] % n_layers
            or launches["fused_residual_unit"] != VOCODER_UNITS):
        raise AssertionError(f"batch: launches {launches}")
    for ids, sem, wav in zip(sampled, semantic, wavs_out):
        if not (len(wav) == len(sem) * hop and np.isfinite(wav).all()):
            raise AssertionError(f"batch: a waveform of {len(wav)} samples for {len(sem)} ids")
    perm = [1, 0, 3, 2]
    greedy = pipe.generate_tokens_batch(prompts, seed=BATCH_SEEDS, greedy=True, **request)
    same = {"rows 0 and 2, sampled": np.array_equal(sampled[0], sampled[2]),
            "rows 0 and 2, greedy": np.array_equal(greedy[0], greedy[2])}
    for label, ref, kw in (("sampled", sampled, {}), ("greedy", greedy, {"greedy": True})):
        swapped = pipe.generate_tokens_batch([prompts[i] for i in perm],
                                             seed=[BATCH_SEEDS[i] for i in perm], **kw, **request)
        same[f"swapped rows, {label}"] = all(np.array_equal(swapped[j], ref[i])
                                             for j, i in enumerate(perm))
    fused_wavs, fused_ids = pipe.generate_and_vocode_batch(
        ids_dev, mask_dev, g_dev, seed=BATCH_SEEDS, greedy=True, max_new_tokens=MAX_NEW_TOKENS)
    same["generate_and_vocode_batch ids == greedy batch ids"] = all(
        np.array_equal(a, b) for a, b in zip(fused_ids, greedy))
    fused_ok = all(len(w) == len(extract_semantic_ids(tok, ids)) * hop and np.isfinite(w).all()
                   for w, ids in zip(fused_wavs, fused_ids))
    print(f"batch gates: {json.dumps(same)}; fused waveforms finite, 320 samples a token: "
          f"{fused_ok}")
    if not (all(same.values()) and fused_ok):
        raise AssertionError(f"batch: {same}, fused waveforms {fused_ok}")
    shapes = dict(batch=len(prompts), t_pad=int(ids_dev.shape[1]),
                  starts=[int(ids_dev.shape[1]) - len(p) for p in prompts], steps=steps,
                  vocode_tokens=-(-max(len(x) for x in semantic) // pipe.vocode_bucket)
                  * pipe.vocode_bucket)
    return summary, launches, check_batch_kernels(dev, pipe, shapes)


LONG_TEXT = ("Spark TTS reads a long text in parts. Each part keeps the voice of the first! "
             "Three parts make this one?")
LONG_SEGMENT_CHARS = 40


def run_longform(pipe):
    """Phase 22: `inference_long` of a three-sentence creation text, segments
    of at most LONG_SEGMENT_CHARS, after one warm-up run; counters 0 just
    before and read just after.  Three segments; the clone prompts of
    segments 2 and 3 carry exactly segment 1's 32 global ids; the length is
    the segments' plus two gaps.  Returns (summary, launches)."""
    import numpy as np

    from sparktts_tpu_torch.prompt import extract_global_ids

    dev, tok, n_layers = pipe.device, pipe.tokenizer, pipe.config.llm.num_hidden_layers
    request = dict(seed=SEED, max_new_tokens=MAX_NEW_TOKENS, max_segment_chars=LONG_SEGMENT_CHARS,
                   **VOICE)
    pipe.inference_long(LONG_TEXT, **request)  # warm-up: captures the segments' units
    _sync(dev)
    segments, prompts = [], []
    synthesize, generate_tokens = pipe._synthesize_segment, pipe.generate_tokens

    def record_segment(*args, **kw):
        out = synthesize(*args, **kw)
        segments.append(out)
        return out

    def record_prompt(prompt_ids, **kw):
        prompts.append(list(prompt_ids))
        return generate_tokens(prompt_ids, **kw)

    pipe._synthesize_segment, pipe.generate_tokens = record_segment, record_prompt
    try:
        _reset_counts()
        t0 = time.perf_counter()
        wav = pipe.inference_long(LONG_TEXT, **request)
        _sync(dev)
        total_s = time.perf_counter() - t0
        launches = _counts()
    finally:
        del pipe._synthesize_segment, pipe.generate_tokens
    gap = int(pipe.sample_rate * 0.1)
    lengths = [len(w) for w, _ in segments]
    first_globals = np.asarray(segments[0][1]).reshape(-1)
    reused = [np.array_equal(extract_global_ids(tok, p), first_globals) for p in prompts[1:]]
    audio_s = len(wav) / pipe.sample_rate
    summary = dict(segments=len(segments), segment_samples=lengths, samples=int(len(wav)),
                   global_ids=int(first_globals.size), later_prompts_carry_them=reused,
                   inference_s=total_s, audio_s=audio_s, rtf=total_s / audio_s)
    print("longform, voice creation:", json.dumps(summary))
    print("launch counters over inference_long:", json.dumps(launches))
    vocoded = sum(1 for n in lengths if n)
    if not (len(segments) == 3 and all(reused) and len(reused) == 2
            and first_globals.size == pipe.config.bicodec.speaker_encoder.token_num
            and len(wav) == sum(lengths) + (vocoded - 1) * gap and vocoded == 3
            and np.isfinite(wav).all()):
        raise AssertionError(f"longform: {summary}")
    if (launches["flash_attention_prefill"] != 3 * n_layers
            or launches["fused_residual_unit"] != 3 * VOCODER_UNITS):
        raise AssertionError(f"longform: launches {launches}")
    return summary, launches


def run_voice_cache(pipe, wav_path: Path):
    """Phase 23: `voice_cache_size=2`; the clone request twice from one wav,
    counters 0 just before and read just after: one miss then one hit, the
    hit running no tokenize (`codec_tokenize` not called) and giving the
    same generated ids.  Returns (summary, launches of the two requests)."""
    import numpy as np

    from sparktts_tpu_torch import pipeline as pipeline_module

    calls = []
    tokenize = pipeline_module.codec_tokenize
    generated = []
    generate_tokens = pipe.generate_tokens

    def counting(*args):
        calls.append(1)
        return tokenize(*args)

    def record(prompt_ids, **kw):
        out = generate_tokens(prompt_ids, **kw)
        generated.append(out)
        return out

    pipe.voice_cache_size = 2
    pipe.voice_cache_stats.update(hits=0, misses=0)
    pipeline_module.codec_tokenize, pipe.generate_tokens = counting, record
    request = dict(prompt_speech_path=wav_path, prompt_text=PROMPT_TEXT, seed=SEED,
                   max_new_tokens=MAX_NEW_TOKENS)
    try:
        _reset_counts()
        times, tokenize_calls = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            pipe.inference(TEXT, **request)
            _sync(pipe.device)
            times.append(time.perf_counter() - t0)
            tokenize_calls.append(len(calls))
        launches = _counts()
        stats = dict(pipe.voice_cache_stats)
    finally:
        pipeline_module.codec_tokenize = tokenize
        del pipe.generate_tokens
        pipe.voice_cache_size = 0
        pipe._voice_cache.clear()
    summary = dict(stats=stats, tokenize_calls=tokenize_calls, request_s=times,
                   same_ids=bool(np.array_equal(generated[0], generated[1])))
    print("voice cache:", json.dumps(summary))
    if not (stats == {"hits": 1, "misses": 1} and tokenize_calls == [1, 1]
            and summary["same_ids"]):
        raise AssertionError(f"voice cache: {summary}")
    return summary, launches


# The server phases (`sparktts_tpu_torch/serve/continuous_server.py`): eight
# requests in two waves; the second prompt wav is shorter (another wav
# bucket), so its clone takes the fused admission while the first wav's
# second clone hits the voice cache.
SERVER_SLOTS = 8
SECOND_PROMPT_SECONDS = 4.0
# A streamed chunk against the plain vocode path's samples (a window against
# the full-prefix vocode at its render end, a speculative first chunk against
# `detokenize_batch` of its chain's rows), relative to the peak: the same math,
# but cuDNN and cuBLAS choose their algorithms (and so their sums' order) by
# shape and by the workspace they find free, so on the card the two are not
# bit-equal as they are on the CPU: on an H100 a window and its full prefix
# differ by up to 6.3e-6 of the peak, batch 2 and batch 1 of one row by 2.4e-6,
# a speculative chunk and the same call after the burst by 5.1e-7 (absolute).
# An off-by-one window, a short left context or wrong speaker ids miss by O(1).
WINDOW_REL_TOL = 1e-4


def _server_wavs(pipe, wav_path: Path):
    """(first prompt wav, second) as float arrays: phase 4's prompt, and a
    shorter one made from the same seed."""
    second = make_prompt_wav(OUT_DIR / "clone_prompt_2.wav", seconds=SECOND_PROMPT_SECONDS)
    return pipe._load_prompt_wav(wav_path), pipe._load_prompt_wav(second)


def make_server(pipe, **kw):
    """A ContinuousTTSServer as the server phases build it: 8 slots, the
    500-token budget, cold admission signatures warmed inline."""
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    return ContinuousTTSServer(pipe, max_slots=SERVER_SLOTS, default_max_new_tokens=MAX_NEW_TOKENS,
                               fused_warm="sync", **kw)


def server_requests(wav_a, wav_b):
    """The eight requests of a server burst: (label, synthesize kwargs,
    streamed, wave).  Texts are unique (the ids are recorded by text)."""
    c = ENGINE_CREATIONS
    voice = lambda i: dict(zip(("gender", "pitch", "speed"), c[i][1]))  # noqa: E731
    return [
        ("creation 0", dict(text=c[0][0], **voice(0)), False, 1),
        ("creation 1", dict(text=c[1][0], **voice(1)), False, 1),
        ("creation 2", dict(text=c[2][0], **voice(2)), False, 1),
        ("clone A, transcript", dict(text="One clone of the first voice, here.",
                                     prompt_wav=wav_a, prompt_text=PROMPT_TEXT), False, 1),
        ("stream creation", dict(text=c[3][0], **voice(3)), True, 1),
        ("clone A again, transcript", dict(text=ENGINE_CLONE_TEXTS[1], prompt_wav=wav_a,
                                           prompt_text=PROMPT_TEXT), False, 2),
        ("clone B", dict(text="The second voice has its own prompt.", prompt_wav=wav_b), False, 2),
        ("stream clone A", dict(text="A streamed clone of the first voice.", prompt_wav=wav_a),
         True, 2),
    ]


def _server_prompts(pipe, requests):
    """Each request's prompt ids and mode, built on the host as the bare
    engine takes them."""
    from sparktts_tpu_torch.prompt import build_clone_prompt, build_control_prompt

    tok, out = pipe.tokenizer, {}
    for label, kw, _, _ in requests:
        if "gender" in kw:
            out[label] = (build_control_prompt(tok, kw["text"], kw["gender"], kw["pitch"],
                                               kw["speed"]), "control")
        else:
            g, s = pipe.tokenize_audio(kw["prompt_wav"])
            pt = kw.get("prompt_text")
            out[label] = (build_clone_prompt(tok, kw["text"], g, s if pt else None, pt), "clone")
    return out


def server_burst(label, server, requests, trace_path=None, before_sync=None):
    """The server phases' main path: start the server (its decode units are
    captured there), then serve `requests` through `synthesize` and
    `synthesize_streaming`: wave 1 at once, wave 2 once wave 1's clone is
    admitted; every launch count 0 just before wave 1 and read after the
    last request.  Records each request's ids, the dispatch with the most
    live slots (its state), the batched vocode shapes and every speculative
    chunk with the chain that rendered it.  Returns the run's record."""
    import asyncio

    import numpy as np

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.utils.profiling import device_busy_ms, device_trace

    pipe, eng = server.pipe, server.engine
    rec = dict(ids={}, pendings={}, windows={}, snapshot=None, live=0, groups={}, chains={},
               specs=[])
    finish, step_begin = server._finish, eng.step_begin
    group, apply_specs = server._vocode_group, server._apply_specs
    chain_multi = pipe.spec_vocode_chain_multi

    def spy_finish(req_id, tokens):
        pending = server.inflight[req_id]
        rec["ids"][pending.text] = np.asarray(tokens)
        rec["pendings"][pending.text] = pending
        return finish(req_id, tokens)

    def spy_step_begin(n_steps, chain_fn=None):
        live = sum(o is not None for o in eng.owner)
        handle = step_begin(n_steps, chain_fn)
        if handle is not None and live > rec["live"]:
            rec["live"], rec["snapshot"] = live, _clone_state(eng.slots)
        return handle

    def spy_group(take, b, out):
        key = (b, -(-max(w[2].size for w in take) // pipe.vocode_bucket) * pipe.vocode_bucket)
        rec["groups"][key] = rec["groups"].get(key, 0) + 1
        return group(take, b, out)

    def spy_chain(specs, batch):
        chain = chain_multi(specs, batch)
        rec["chains"][id(chain)] = (list(specs), batch)
        return chain

    def spy_apply(spec, chained, increments):
        consumed = apply_specs(spec, chained, increments)
        specs, batch = rec["chains"][id(spec[1])]
        up, off, rows = pipe._wave_upsample, 0, []
        for req_id, slot, target, sem_off, control in spec[0]:
            new = increments.get(req_id)
            rows.append(dict(consumed=req_id in consumed, target=target, sem_off=sem_off,
                             ids=None if new is None else np.asarray(new),
                             chunk=chained[off : off + target * up].view(np.float32).copy()))
            off += target * up
        if consumed:
            rec["specs"].append(dict(specs=specs, batch=batch, rows=rows))
        return consumed

    plan = server._plan_stream_chunks

    def spy_plan(pending, new_tokens, final):
        windows = plan(pending, new_tokens, final)
        rec["windows"].setdefault(pending.text, []).extend(windows)
        return windows

    server._plan_stream_chunks = spy_plan
    server._finish, eng.step_begin = spy_finish, spy_step_begin
    server._vocode_group, server._apply_specs = spy_group, spy_apply
    pipe.spec_vocode_chain_multi = spy_chain
    results = {}

    async def one(lbl, kw, streamed):
        t0 = time.perf_counter()
        if not streamed:
            results[lbl] = dict(wav=await server.synthesize(**kw),
                                wall_s=time.perf_counter() - t0)
            return
        chunks, first = [], None
        async for c in server.synthesize_streaming(**kw):
            if first is None:
                first = (time.perf_counter() - t0) * 1e3
            chunks.append(c)
        results[lbl] = dict(chunks=chunks, wav=np.concatenate(chunks) if chunks else
                            np.zeros(0, np.float32), first_chunk_ms=first,
                            wall_s=time.perf_counter() - t0)

    async def go():
        await server.start()
        _sync(pipe.device)
        units = graphs.builds()
        _reset_counts()
        t0 = time.perf_counter()
        tasks = [asyncio.create_task(one(lbl, kw, st)) for lbl, kw, st, w in requests if w == 1]
        while not pipe._voice_cache and all(not t.done() for t in tasks):
            await asyncio.sleep(0.002)
        tasks += [asyncio.create_task(one(lbl, kw, st)) for lbl, kw, st, w in requests
                  if w == 2]
        await asyncio.gather(*tasks)
        if before_sync is not None:
            # a device-wide synchronize during another thread's capture would
            # invalidate that capture: wait for it off the loop first
            await asyncio.get_running_loop().run_in_executor(None, before_sync)
        _sync(pipe.device)
        wall = time.perf_counter() - t0
        launches = _counts()
        new_units = graphs.builds() - units
        await server.stop()
        return wall, launches, new_units

    try:
        with device_trace(trace_path) if trace_path else contextlib.nullcontext():
            wall, launches, new_units = asyncio.new_event_loop().run_until_complete(go())
    finally:
        server._finish, eng.step_begin = finish, step_begin
        server._vocode_group, server._apply_specs = group, apply_specs
        server._plan_stream_chunks = plan
        pipe.spec_vocode_chain_multi = chain_multi
    rec.update(results=results, wall_s=wall, launches=launches, new_units=new_units,
               stats=dict(server.stats), stages=server.stage_stats.summary())
    if trace_path:
        rec["device_busy_ms"] = device_busy_ms(trace_path)
        rec["idle_share"] = 1.0 - rec["device_busy_ms"] / (wall * 1e3)
        Path(trace_path).unlink()
    n_ids = sum(len(v) for v in rec["ids"].values())
    rec["tokens"], rec["tokens_per_s"] = n_ids, n_ids / wall
    return rec


def check_server_burst(label, pipe, run, requests, kernel):
    """Phase (a)/(b) gates: every request completes with no failure; each
    waveform finite at 320 samples a semantic id (a stream's chunks joined
    as long as the offline vocode of its ids); every window of a stream
    within WINDOW_REL_TOL of the full-prefix vocode at its render end, and
    every validated speculative chunk within it of the plain vocode path at
    its chain's batch (`detokenize_batch` of the same rows padded the same
    way), whether bit-equal printed; no decode unit captured in the burst;
    the engine's attention kernel launched n_layers times a decode step, no
    other attention kernel, the vocoder kernel launched.  Prints the run's
    numbers."""
    import numpy as np

    from sparktts_tpu_torch.prompt import extract_semantic_ids
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    tok, up = pipe.tokenizer, pipe._wave_upsample
    n_layers = pipe.config.llm.num_hidden_layers
    st = run["stats"]
    print(f"{label}: {run['tokens']} ids in {run['wall_s']:.3f} s, {run['tokens_per_s']:.1f} "
          f"tokens/s; stats {json.dumps(st)}")
    print(f"{label} stages: {json.dumps(run['stages'])}")
    print(f"launch counters over the {label}:", json.dumps(run["launches"]))
    if st["completed"] != len(requests) or st.get("failures", 0):
        raise AssertionError(f"{label}: {st['completed']} of {len(requests)} completed, "
                             f"{st.get('failures', 0)} failures")
    if run["new_units"]:
        raise AssertionError(f"{label}: {run['new_units']} decode units captured in the burst")
    window_gap, bit_equal = 0.0, True
    for lbl, kw, streamed, _ in requests:
        res, ids = run["results"][lbl], run["ids"].get(kw["text"])
        if ids is None:
            raise AssertionError(f"{label}: no ids recorded for {lbl}")
        sem = extract_semantic_ids(tok, ids)
        wav = res["wav"]
        if not (np.isfinite(wav).all() and len(wav) == sem.size * up):
            raise AssertionError(f"{label}: {lbl} gave {len(wav)} samples for {sem.size} "
                                 f"semantic ids (want x{up}, finite)")
        line = f"{label}: {lbl}: {len(ids)} ids, {len(wav)} samples, wall {res['wall_s']:.3f} s"
        if streamed:
            # the speaker ids the stream was vocoded with: its prompt's, or
            # those it had emitted when its first window was planned
            glob = ContinuousTTSServer._host_globals(run["pendings"][kw["text"]].global_tokens)
            end, gaps = 0, []
            # a window renders [start, render) and emits [emitted, upto): the
            # full prefix to compare with ends at its render (a split piece
            # renders look-ahead past its cut); a speculative first chunk is
            # no planned window and renders what it emits
            render_of = {(w[1], w[2]): w[3] for w in run["windows"].get(kw["text"], [])}
            for chunk in res["chunks"]:
                start, end = end, end + len(chunk)
                render = render_of.get((start // up, end // up), end // up)
                full = pipe.detokenize(glob, sem[None, :render])
                gaps.append(float(np.abs(full[start:end] - chunk).max())
                            / float(np.abs(full).max()))
                bit_equal &= bool(np.array_equal(full[start:end], chunk))
            window_gap = max([window_gap] + gaps)
            line += (f", first chunk {res['first_chunk_ms']:.1f} ms, {len(res['chunks'])} chunks "
                     f"of {[len(c) // up for c in res['chunks']]} tokens (windows "
                     f"{run['windows'].get(kw['text'], [])}), each within "
                     f"{[f'{g:.2e}' for g in gaps]} of the full prefix's peak")
        print(line)
    print(f"{label}: stream windows vs the full-prefix vocode: largest gap {window_gap:.3e} of "
          f"the peak (tol {WINDOW_REL_TOL}), bit-equal: {bit_equal}")
    if not window_gap <= WINDOW_REL_TOL:
        raise AssertionError(f"{label}: a stream window differs from the full-prefix vocode")
    n_spec, spec_gap, spec_equal = 0, 0.0, True
    for sp in run["specs"]:
        n_spec += sum(r["consumed"] for r in sp["rows"])
        for k, row in enumerate(sp["rows"]):
            if row["consumed"]:
                plain = _plain_spec_row(pipe, sp, k)
                spec_gap = max(spec_gap, float(np.abs(plain - row["chunk"]).max())
                               / float(np.abs(plain).max()))
                spec_equal &= bool(np.array_equal(plain, row["chunk"]))
    if not spec_gap <= WINDOW_REL_TOL:
        raise AssertionError(f"{label}: a speculative first chunk differs from the plain vocode "
                             f"path by {spec_gap:.3e} of its peak")
    print(f"{label}: {n_spec} speculative first chunks against the plain vocode path at "
          f"their chain's batch: largest gap {spec_gap:.3e} of the peak (tol {WINDOW_REL_TOL}), "
          f"bit-equal: {spec_equal}; batched vocode shapes (batch, t_pad): "
          f"{ {str(k): v for k, v in run['groups'].items()} }")
    launches = run["launches"]
    steps = launches[kernel] / n_layers
    other = ("dense_decode_attention" if kernel == "paged_decode_attention"
             else "paged_decode_attention")
    if not (steps > 0 and steps == int(steps) and launches[other] == 0):
        raise AssertionError(f"{label}: {launches[kernel]} {kernel} launches (want n_layers a "
                             f"step), {launches[other]} {other}")
    if launches["fused_residual_unit"] == 0:
        raise AssertionError(f"{label}: the vocoder kernel never launched")


def _plain_spec_row(pipe, sp, k):
    """Row k of a speculative chain recomputed by the plain vocode path:
    `detokenize_batch` of the chain's rows (padded to its batch by
    repeating row 0) taken from the fetched ids as the chain takes them from
    the packed result; a row whose ids did not all come back (its request
    ended inside the window) is replaced by row k (rows of one batched call
    do not mix)."""
    import numpy as np

    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    tok, tn = pipe.tokenizer, pipe.config.bicodec.speaker_encoder.token_num
    rows = list(zip(sp["specs"], sp["rows"]))
    rows += [rows[0]] * (sp["batch"] - len(rows))
    globs, sems = [], []
    for (slot, target, sem_off, g), row in rows:
        ids = row["ids"]
        if ids is None or len(ids) < sem_off + target:
            (slot, target, sem_off, g), row = rows[k]
            ids = row["ids"]
        sems.append(np.clip(ids[sem_off : sem_off + target] - tok.semantic_base, 0,
                            tok.n_semantic - 1))
        if g is None:  # a controllable row: the speaker ids it emitted
            g = np.clip(ids[1 : 1 + tn] - tok.global_base, 0, tok.n_global - 1)
        globs.append(ContinuousTTSServer._host_globals(g))
    return pipe.detokenize_batch(np.concatenate(globs), sems)[k]


def _near_tie_ok(pipe, params, prompt, mode, got, want):
    """Phase 14's argmax rule for a greedy stream against a reference: equal,
    or the first difference at a step where the reference's top two guided
    logits (prompt + the common prefix through the dense path, on the card)
    lie closer than LOGITS_REL_TOL of the largest logit.  Returns (ok, the
    first differing step or None)."""
    import numpy as np
    import torch

    from sparktts_tpu_torch.lm.qwen import init_kv_cache, qwen_forward

    n = min(len(got), len(want))
    diff = np.flatnonzero(got[:n] != want[:n])
    if not diff.size and len(got) == len(want):
        return True, None
    step = int(diff[0]) if diff.size else n
    ids = torch.tensor([list(prompt) + [int(t) for t in want[:step]]], device=pipe.device)
    vocab_slice, extra_ids = pipe.guided_constraint(mode)
    t = ids.shape[1]
    with torch.inference_mode():
        idx = torch.arange(t, device=pipe.device)
        bias = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9).float()[None]
        cache = init_kv_cache(pipe.config.llm, 1, t, pipe.lm_dtype, pipe.device)
        logits, _ = qwen_forward(params, pipe.config.llm, ids, idx[None], cache, 0, bias,
                                 vocab_slice=vocab_slice, extra_ids=extra_ids,
                                 logits_last_only=True)
    top = logits[0, -1].float().topk(2).values
    gap, scale = float(top[0] - top[1]), float(logits[0, -1].abs().max())
    return gap <= LOGITS_REL_TOL * scale, step


def _near_ties(pipe, params, prompt, mode, ids):
    """(len(ids),) bool on the host: the emitted positions of a greedy stream
    whose top two guided logits (prompt + the stream's prefix through the
    dense path, one forward on the card) lie closer than LOGITS_REL_TOL of
    the position's largest logit."""
    import torch

    from sparktts_tpu_torch.lm.qwen import init_kv_cache, qwen_forward

    seq = torch.tensor([list(prompt) + [int(t) for t in ids[:-1]]], device=pipe.device)
    vocab_slice, extra_ids = pipe.guided_constraint(mode)
    t = seq.shape[1]
    with torch.inference_mode():
        idx = torch.arange(t, device=pipe.device)
        bias = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9).float()[None]
        cache = init_kv_cache(pipe.config.llm, 1, t, pipe.lm_dtype, pipe.device)
        logits, _ = qwen_forward(params, pipe.config.llm, seq, idx[None], cache, 0, bias,
                                 vocab_slice=vocab_slice, extra_ids=extra_ids)
        emitted = logits[0, len(prompt) - 1:].float()
        top = emitted.topk(2, dim=-1).values
        near = (top[:, 0] - top[:, 1]) <= LOGITS_REL_TOL * emitted.abs().amax(dim=-1)
    return near.cpu().numpy()


def check_greedy_servers(pipe, requests, int8_params):
    """Phase (c): greedy servers, dense and paged, at dispatch depth 1 and 2,
    and a dense server on the int8 LM (kernel 4 on its path): every
    request's ids those of the bare engine of the server's kind (on the same
    LM) run greedily on its prompt, under phase 14's argmax rule.  Returns
    the runs' launches."""
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
    from sparktts_tpu_torch.lm.paged import PagedContinuousEngine

    prompts = _server_prompts(pipe, requests)
    text_of = {lbl: kw["text"] for lbl, kw, _, _ in requests}
    bf16 = pipe.llm_params
    out = []

    def bare(params, paged):
        """The engine of the server's kind alone (a paged one with a pool for
        every request at once), all the prompts submitted together."""
        kw = _engine_kwargs(pipe, True)
        if paged:
            pps = -(-4 * kw["prompt_pad"] // PAGE_SIZE) + -(-MAX_NEW_TOKENS // PAGE_SIZE) + 1
            eng = PagedContinuousEngine(params, pipe.config.llm, max_slots=SERVER_SLOTS,
                                        n_pages=SERVER_SLOTS * pps + 1, page_size=PAGE_SIZE,
                                        pages_per_slot=pps, **kw)
        else:
            eng = ContinuousBatchingEngine(params, pipe.config.llm, max_slots=SERVER_SLOTS,
                                           cache_len=DENSE_CACHE_LEN, **kw)
        reqs = {lbl: eng.submit(p, MAX_NEW_TOKENS, mode=m) for lbl, (p, m) in prompts.items()}
        eng.run_until_done(64)
        return {lbl: eng.finished[r] for lbl, r in reqs.items()}

    for name, params, kw in (
            ("dense, depth 1", bf16, dict(dispatch_depth=1)),
            ("dense, depth 2", bf16, dict(dispatch_depth=2)),
            ("paged, depth 1", bf16, dict(dispatch_depth=1, paged=True)),
            ("paged, depth 2", bf16, dict(dispatch_depth=2, paged=True)),
            ("dense, int8 LM", int8_params, dict(dispatch_depth=2))):
        pipe.llm_params = params
        try:
            want = bare(params, kw.get("paged", False))
            if "paged" not in kw:
                kw["cache_len"] = DENSE_CACHE_LEN
            server = make_server(pipe, greedy=True, **kw)
            pipe._voice_cache.clear()
            run = server_burst(f"greedy server, {name}", server, requests)
        finally:
            pipe.llm_params = bf16
        same, ties = 0, []
        for lbl, (prompt, mode) in prompts.items():
            got = run["ids"][text_of[lbl]]
            ok, step = _near_tie_ok(pipe, params, prompt, mode, got, want[lbl])
            if not ok:
                raise AssertionError(f"greedy server, {name}: {lbl} differs from the bare "
                                     f"engine at step {step}, not at a near tie")
            if step is None:
                same += 1
            else:
                ties.append((lbl, step))
        if "int8" in name and run["launches"]["int8_mlp_matvec"] == 0:
            raise AssertionError("greedy server on the int8 LM launched no int8 MLP kernel")
        print(f"greedy server, {name}: {same} of {len(prompts)} requests' ids equal the bare "
              f"engine's; first differences at near ties: {ties}; {run['tokens_per_s']:.1f} "
              f"tokens/s; launches {json.dumps(run['launches'])}")
        out.append(run["launches"])
    return out


def check_server_threads(pipe, requests):
    """Phase (d): a greedy dense server serves four streams while, once the
    vocode worker renders its first window, a background thread captures a
    new decode unit (another engine's).  The live dispatches' unit lookups
    must each wait less than that capture took, and the ids must equal a run
    of the same server without the capture (phase 14's argmax rule)."""
    import threading

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine

    streams = [(lbl, kw, True, 1) for lbl, kw, _, _ in requests
               if lbl in ("creation 0", "creation 1", "stream creation", "clone B")]
    prompts = _server_prompts(pipe, streams)

    def make():
        return make_server(pipe, greedy=True, cache_len=DENSE_CACHE_LEN)

    pipe._voice_cache.clear()
    alone = server_burst("thread check, alone", make(), streams)
    server = make()
    rendering, captured, waits = threading.Event(), {}, []
    real_unit, real_scalar, real_group = graphs.unit, server._vocode_scalar, server._vocode_group

    def timed_unit(key, device, build, cache=None):
        built = key in cache  # a lookup, not the server's own capture at start
        t0 = time.perf_counter()
        u = real_unit(key, device, build, cache)
        if built and threading.current_thread() is threading.main_thread():
            waits.append((time.perf_counter() - t0) * 1e3)
        return u

    def mark(fn):
        def inner(*a):
            captured.setdefault("during", "batched window" if fn is real_group else "window")
            rendering.set()
            return fn(*a)
        return inner

    def capture():
        import torch

        rendering.wait(timeout=120)
        with torch.inference_mode():
            eng = ContinuousBatchingEngine(pipe.llm_params, pipe.config.llm, max_slots=3,
                                           cache_len=256, **_engine_kwargs(pipe, True))
            eng.warm_units()
            new = [u for u in graphs.units() if u.owner == eng.units.tag]
        captured["ms"] = max(u.capture_ms for u in new) if new else None

    graphs.unit = timed_unit
    server._vocode_scalar, server._vocode_group = mark(real_scalar), mark(real_group)
    worker = threading.Thread(target=capture, name="capture-while-serving")
    worker.start()
    pipe._voice_cache.clear()
    try:
        run = server_burst("thread check, with a capture", server, streams,
                           before_sync=lambda: worker.join(timeout=300))
    finally:
        graphs.unit = real_unit
        worker.join(timeout=300)
    if captured.get("ms") is None:
        raise AssertionError("thread check: the background thread captured no decode unit")
    for lbl, (prompt, mode) in prompts.items():
        text = next(kw["text"] for l2, kw, _, _ in streams if l2 == lbl)
        ok, step = _near_tie_ok(pipe, pipe.llm_params, prompt, mode, run["ids"][text],
                                alone["ids"][text])
        if not ok:
            raise AssertionError(f"thread check: {lbl} differs from the run without the capture "
                                 f"at step {step}")
        print(f"thread check: {lbl}: ids equal the run without the capture: {step is None}")
    wait = max(waits)
    print(f"thread check: a decode unit captured in {captured['ms']:.1f} ms while the vocode "
          f"worker rendered a {captured['during']}; the live dispatches' {len(waits)} unit "
          f"lookups waited at most {wait:.3f} ms")
    if not wait < captured["ms"]:
        raise AssertionError("thread check: a live dispatch waited out the background capture")
    return [alone["launches"], run["launches"]]


def run_servers(pipe, wav_path: Path, bare_tokens_per_s: float, int8_params):
    """Phases 24-27 (ContinuousTTSServer): (a) the dense server's burst after
    the warm-up passes, timed, then traced for the idle share; (b) the paged
    server's burst; (c) greedy servers against the bare engine; (d) a
    decode-unit capture while serving.  Returns (launches of the runs, the
    decode kernel's `by_shape` item at the dense server's state, the paged
    kernel's at the paged server's, the vocoder kernel's at the batched
    windows' shape, and the largest error of those checks by kernel)."""
    import torch

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.serve.continuous_server import (
        warm_admit_batches,
        warm_spec_chains,
        warm_stream_windows,
        warm_vocode_batches_seen,
    )

    dev, cfg = pipe.device, pipe.config.llm
    wav_a, wav_b = _server_wavs(pipe, wav_path)
    requests = server_requests(wav_a, wav_b)
    pipe.voice_cache_size = 2 * SERVER_SLOTS
    flags = (True, True)  # the caller's TF32 setting, which the codec must not disturb
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    launches, items, errs = [], {}, {}

    def server(**kw):
        return make_server(pipe, **kw)

    # (a) the dense server: warm-up passes, one representative burst, then the
    # batched-vocode shapes it saw; then the timed burst and the traced one
    warm = server(cache_len=DENSE_CACHE_LEN)
    t0 = time.perf_counter()
    tasks = [type("Task", (), dict(text=kw["text"], prompt_wav=kw["prompt_wav"],
                                   prompt_text=kw.get("prompt_text")))
             for _, kw, _, _ in requests if "prompt_wav" in kw]
    n_admit = warm_admit_batches(warm, tasks, SERVER_SLOTS)
    n_spec = warm_spec_chains(warm, SERVER_SLOTS)
    n_win = warm_stream_windows(pipe, warm.max_vocode_window + warm.stream_ctx)
    pipe._voice_cache.clear()
    server_burst("dense server warm-up burst", warm, requests)
    n_voc = warm_vocode_batches_seen(pipe, SERVER_SLOTS)
    print(f"server warm-up ({time.perf_counter() - t0:.1f} s): {n_admit} batched admissions, "
          f"{n_spec} speculative chains, {n_win} stream windows, {n_voc} vocode batches; "
          f"{len(graphs.units())} decode units captured so far")
    pipe._voice_cache.clear()
    dense = server_burst("dense server burst", server(cache_len=DENSE_CACHE_LEN), requests)
    check_server_burst("dense server burst", pipe, dense, requests, "dense_decode_attention")
    if not (dense["stats"].get("fused_admissions", 0) >= 1
            and dense["stats"].get("voice_cache_admissions", 0) >= 1):
        raise AssertionError("dense server burst: no fused or no voice-cache admission")
    pipe._voice_cache.clear()
    traced = server_burst("dense server burst, traced", server(cache_len=DENSE_CACHE_LEN),
                          requests, trace_path=OUT_DIR / "_trace_server.json")
    streams = [r for r in dense["results"].values() if "first_chunk_ms" in r]
    print(f"dense server, 8 concurrent requests: {dense['tokens_per_s']:.1f} tokens/s, "
          f"{dense['tokens_per_s'] / bare_tokens_per_s:.4f} of the bare dense engine's "
          f"{bare_tokens_per_s:.1f} (phase 13, same card); first chunks "
          f"{[round(r['first_chunk_ms'], 1) for r in streams]} ms; deferrals "
          f"{dense['stats']['deferrals']}; traced: {traced['tokens_per_s']:.1f} tokens/s, device "
          f"busy {traced['device_busy_ms']:.1f} ms of {traced['wall_s'] * 1e3:.1f}, idle share "
          f"{traced['idle_share']:.4f}")
    launches += [dense["launches"], traced["launches"]]

    # (b) the paged server (the half pool: deferrals)
    pipe._voice_cache.clear()
    paged_server = server(paged=True)
    server_burst("paged server warm-up burst", paged_server, requests)
    pipe._voice_cache.clear()
    paged_server = server(paged=True)
    paged = server_burst("paged server burst", paged_server, requests)
    check_server_burst("paged server burst", pipe, paged, requests, "paged_decode_attention")
    if paged["stats"]["deferrals"] < 1 or paged_server.engine.pages_in_use() != 0:
        raise AssertionError(f"paged server burst: {paged['stats']['deferrals']} deferrals, "
                             f"{paged_server.engine.pages_in_use()} pages in use at the end")
    print(f"paged server, 8 concurrent requests: {paged['tokens_per_s']:.1f} tokens/s, "
          f"{paged['stats']['deferrals']} deferrals, every page back in the pool")
    launches.append(paged["launches"])
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("the server bursts changed the TF32 flags")
    print(f"TF32 flags (cudnn, matmul) before and after the bursts: {flags}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    # the kernels at the servers' shapes
    items["dense_decode_attention"] = check_dense_engine_decode(dev, cfg, dense["snapshot"])
    items["dense_decode_attention"]["shape"] = "dense server " + \
        items["dense_decode_attention"]["shape"]
    paged_entry = check_paged(dev, cfg, paged["snapshot"])
    items["paged_decode_attention"] = dict(paged_entry["by_shape"][0])
    items["paged_decode_attention"]["shape"] = "paged server " + \
        items["paged_decode_attention"]["shape"]
    errs["paged_decode_attention"] = paged_entry["max_abs_err"]
    shapes = dense["groups"]
    if shapes:
        (b, t_pad) = max(shapes, key=shapes.get)
        voc = check_vocoder(dev, pipe.config.bicodec.decoder, [t_pad], batch=b)
        items["fused_residual_unit"] = dict(voc["by_shape"][0],
                                            shape=f"server batched windows: {voc['by_shape'][0]['shape']}")
        errs["fused_residual_unit"] = voc["max_abs_err"]

    # (c) greedy servers against the bare engine; (d) a capture while serving
    launches += check_greedy_servers(pipe, requests, int8_params)
    launches += check_server_threads(pipe, requests)
    pipe.voice_cache_size = 0
    pipe._voice_cache.clear()
    return launches, items, errs


# ---------------------------------------------------------------------------
# phase 28: the HTTP front door (`serve/server.py`) over a real socket
# ---------------------------------------------------------------------------

FRONT_TEXTS = ("The front door speaks over HTTP.", "Four voices at once.",
               "A third one joins.", "And a fourth.")
# more than OPENAI_LONGFORM_AUTO_CHARS (600): /v1/audio/speech takes longform
FRONT_LONG_TEXT = " ".join(
    f"Part {n} of a long text reads on in the same voice, one sentence after another."
    for n in ("one", "two", "three", "four", "five", "six", "seven", "eight"))
FRONT_SEGMENT_CHARS = 120  # a segment's prompt fits the streaming engine's prompt room
# memory_allocated after the phase, its pipeline and servers dropped, against
# before it (cuBLAS's per-stream workspaces cleared at both readings): a
# leaked pipeline holds ~2.5 GiB, a leaked decode unit its 48-68 MiB pool
LEAK_MARGIN_MIB = 64
FRONT_PAIRS = 3  # requests a side for the front's cost, alternating which goes first


def _http(port, path, payload=None, method="POST", raw=None, first_audio_byte=None):
    """One request on a fresh connection: (status, headers, body, wall ms,
    ms to the byte at offset `first_audio_byte` of the body, or None)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    body = raw if raw is not None else (b"" if payload is None else json.dumps(payload).encode())
    t0 = time.perf_counter()
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    first_ms = None
    if first_audio_byte is not None:
        head = resp.read(first_audio_byte + 1)
        first_ms = (time.perf_counter() - t0) * 1e3
        data = head + resp.read()
    else:
        data = resp.read()
    wall_ms = (time.perf_counter() - t0) * 1e3
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, data, wall_ms, first_ms


def _wav_body(data: bytes):
    """(sample rate, int16 samples) of a 16-bit PCM RIFF body."""
    import struct

    import numpy as np

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError("front door: the body is not a RIFF/WAVE file")
    return struct.unpack_from("<I", data, 24)[0], np.frombuffer(data[44:], dtype="<i2")


def _check_audio(label, wav, sr, up=320):
    import numpy as np

    if sr != 16000 or not wav.size or not np.isfinite(wav).all() or wav.size % up:
        raise AssertionError(f"front door: {label}: {wav.size} samples at {sr} Hz, "
                             f"finite {bool(np.isfinite(wav).all())}")


def _allocated() -> int:
    """memory_allocated after a collection, with cuBLAS's workspaces freed."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def run_front_door(wav_path: Path, smi: str):
    """Phase 28: serve_http over a full-width dense pipeline (voice cache on,
    one wav bucket so warm-up runs one clone signature), driven over the
    socket by the port's client and raw http: every route, a greedy /tts
    held to the direct path, the front's cost over direct server calls, and
    the leak check after the servers and the pipeline are dropped.  Returns
    the launches of the routes' requests (counts 0 after warm-up)."""
    import asyncio
    import base64
    import threading

    import numpy as np
    import torch

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.prompt import (
        build_control_prompt,
        extract_semantic_ids,
        padded_global_tokens,
    )
    from sparktts_tpu_torch.serve import client as C
    from sparktts_tpu_torch.serve.server import OPENAI_LONGFORM_AUTO_CHARS, TTSRequest, serve_http

    mem_before = _allocated()
    t0 = time.perf_counter()
    pipe = SparkTTSPipeline(device="cuda", seed=SEED, max_new_tokens=MAX_NEW_TOKENS,
                            wav_bucket_s=PROMPT_SECONDS, voice_cache_size=4)
    prompt = pipe._load_prompt_wav(wav_path).astype(np.float32)
    ctl: dict = {}
    server_thread = threading.Thread(
        target=serve_http, args=(pipe,), name="serve_http",
        kwargs=dict(host="127.0.0.1", port=0, streaming=True, warmup=True, control=ctl))
    server_thread.start()
    while "stop" not in ctl:
        if not server_thread.is_alive():
            raise AssertionError("front door: serve_http ended before it listened")
        time.sleep(0.05)
    port = ctl["httpd"].server_address[1]
    tags = {pipe.units.tag, ctl["cserver"].engine.units.tag}
    print(f"front door: serve_http up on port {port} after {time.perf_counter() - t0:.1f} s "
          f"(pipeline build and warm-up)")
    walls, firsts = {}, {}
    up = pipe._wave_upsample

    def timed(route, fn):
        t = time.perf_counter()
        out = fn()
        walls[route] = (time.perf_counter() - t) * 1e3
        return out

    _sync(pipe.device)
    _reset_counts()
    status, _, body, _, _ = _http(port, "/health", method="GET")
    if status != 200 or json.loads(body) != {"healthy": True}:
        raise AssertionError(f"front door: /health {status} {body!r}")
    creation = dict(gender="female", pitch="moderate", speed="moderate")
    wav, sr, _ = timed("/tts creation", lambda: C.synthesize(
        "127.0.0.1", port, TEXT, timeout=600, **creation))
    _check_audio("/tts creation", wav, sr, up)
    wav, sr, _ = timed("/tts clone", lambda: C.synthesize(
        "127.0.0.1", port, TEXT, prompt_wav=prompt, prompt_text=PROMPT_TEXT, timeout=600))
    _check_audio("/tts clone", wav, sr, up)

    before = C.get_stats("127.0.0.1", port)
    out = [None] * len(FRONT_TEXTS)

    def one(i):
        out[i] = C.synthesize("127.0.0.1", port, FRONT_TEXTS[i], timeout=600,
                              gender="male", pitch="low", speed="moderate")

    burst = [threading.Thread(target=one, args=(i,)) for i in range(len(FRONT_TEXTS))]
    timed("/tts x4 concurrent", lambda: ([t.start() for t in burst], [t.join() for t in burst]))
    stats = C.get_stats("127.0.0.1", port)
    n_batches = stats["batches"] - before["batches"]
    for i, res in enumerate(out):
        _check_audio(f"/tts concurrent {i}", res[0], res[1], up)
    if not (n_batches < len(FRONT_TEXTS) and stats["avg_batch_occupancy"] > 1):
        raise AssertionError(f"front door: four concurrent /tts in {n_batches} batches")
    print(f"front door: four concurrent /tts creations in {n_batches} batches; /stats "
          f"avg_batch_occupancy {stats['avg_batch_occupancy']:.4f}")

    status, headers, body, wall, first = _http(
        port, "/tts_stream", dict(text=TEXT, **creation), first_audio_byte=0)
    lines = [json.loads(x) for x in body.decode().splitlines() if x.strip()]
    chunks = [np.frombuffer(base64.b64decode(x["wav_b64"]), np.float32)
              for x in lines if "wav_b64" in x]
    if (status != 200 or headers.get("Content-Type") != "application/x-ndjson"
            or lines[-1] != {"done": True} or not chunks):
        raise AssertionError(f"front door: /tts_stream {status}, last line {lines[-1:]}")
    _check_audio("/tts_stream", np.concatenate(chunks), 16000, 1)
    walls["/tts_stream"], firsts["/tts_stream"] = wall, first

    for fmt in ("wav", "pcm"):
        status, headers, body, walls[f"/v1/audio/speech {fmt}"], _ = _http(
            port, "/v1/audio/speech", {"input": TEXT, "voice": "female", "response_format": fmt})
        if status != 200 or headers.get("Content-Type") != f"audio/{fmt}":
            raise AssertionError(f"front door: /v1/audio/speech {fmt}: {status}")
        pcm = _wav_body(body)[1] if fmt == "wav" else np.frombuffer(body, "<i2")
        if fmt == "wav" and _wav_body(body)[0] != 16000:
            raise AssertionError("front door: /v1/audio/speech wav: not 16 kHz")
        _check_audio(f"/v1/audio/speech {fmt}", pcm.astype(np.float32), 16000, up)
    status, headers, body, wall, first = _http(
        port, "/v1/audio/speech", {"input": TEXT, "voice": "female", "stream": True},
        first_audio_byte=44)  # past the read-to-EOF RIFF header
    if status != 200 or headers.get("Transfer-Encoding") != "chunked" or body[:4] != b"RIFF":
        raise AssertionError(f"front door: /v1/audio/speech stream: {status}")
    _check_audio("/v1/audio/speech stream", np.frombuffer(body[44:], "<i2").astype(np.float32),
                 16000, 1)
    walls["/v1/audio/speech stream"], firsts["/v1/audio/speech stream"] = wall, first

    status, _, body, walls["POST /v1/voices"], _ = _http(port, "/v1/voices", {
        "name": "prompt", "wav_b64": base64.b64encode(prompt.tobytes()).decode()})
    if status != 200 or json.loads(body)["name"] != "prompt":
        raise AssertionError(f"front door: POST /v1/voices {status} {body!r}")
    status, _, body, walls["/v1/audio/speech voice"], _ = _http(
        port, "/v1/audio/speech", {"input": TEXT, "voice": "prompt"})
    if status != 200:
        raise AssertionError(f"front door: speech by a registered voice: {status}")
    _check_audio("/v1/audio/speech voice", _wav_body(body)[1].astype(np.float32), 16000, up)
    status, _, _, walls["DELETE /v1/voices"], _ = _http(port, "/v1/voices/prompt",
                                                       method="DELETE")
    gone, _, body, _, _ = _http(port, "/v1/audio/speech", {"input": TEXT, "voice": "prompt"})
    if status != 200 or gone != 404 or json.loads(body)["error"]["type"] != \
            "invalid_request_error":
        raise AssertionError(f"front door: DELETE /v1/voices {status}, then {gone}")

    assert len(FRONT_LONG_TEXT) > OPENAI_LONGFORM_AUTO_CHARS
    segs = C.get_stats("127.0.0.1", port)["streaming"].get("longform_segments", 0)
    status, _, body, walls["/v1/audio/speech longform"], _ = _http(
        port, "/v1/audio/speech", {"input": FRONT_LONG_TEXT, "voice": "male",
                                   "max_segment_chars": FRONT_SEGMENT_CHARS})
    segs = C.get_stats("127.0.0.1", port)["streaming"]["longform_segments"] - segs
    if status != 200 or segs < 2:
        raise AssertionError(f"front door: longform {status}, {segs} segments")
    long_pcm = _wav_body(body)[1]
    if not long_pcm.size:
        raise AssertionError("front door: longform gave no audio")

    bad, headers, body, _, _ = _http(port, "/tts", raw=b"{not json")
    if bad != 400 or headers.get("Content-Type") != "application/json" or \
            "bad request" not in json.loads(body)["error"]:
        raise AssertionError(f"front door: malformed JSON gave {bad}")
    unknown, _, body, _, _ = _http(port, "/v1/audio/speech", {"input": TEXT, "voice": "nobody"})
    err = json.loads(body)["error"]
    if unknown != 404 or err["type"] != "invalid_request_error" or "nobody" not in err["message"]:
        raise AssertionError(f"front door: unknown voice gave {unknown} {err}")

    # a greedy (top_k 1) /tts creation, held to the direct path at batch 1
    seed = 11
    wav, sr = timed("/tts creation, top_k 1", lambda: _greedy_tts(port, seed, creation))
    _sync(pipe.device)
    launches = _counts()
    tok = pipe.tokenizer
    ids = pipe.generate_tokens_batch([build_control_prompt(tok, TEXT, **creation)], top_k=1,
                                     greedy=True, seed=[seed], mode="control")[0]
    sem = extract_semantic_ids(tok, ids)
    glob = padded_global_tokens(tok, ids, pipe.config.bicodec.speaker_encoder.token_num)
    direct = pipe.detokenize_batch(glob.reshape(1, -1),
                                   [sem if sem.size else np.zeros(1, np.int32)])[0]
    if wav.shape != direct.shape:
        raise AssertionError(f"front door: greedy /tts {wav.shape} samples, direct path "
                             f"{direct.shape}")
    peak = float(np.abs(direct).max())
    gap = float(np.abs(wav - direct).max())
    if not gap <= WINDOW_REL_TOL * peak:
        raise AssertionError(f"front door: greedy /tts differs from the direct path by {gap} "
                             f"(peak {peak})")
    print(f"front door: greedy /tts = generate_tokens_batch (greedy) + detokenize_batch: "
          f"{wav.size} samples each, largest gap {gap:.3e} of a peak {peak:.4f} "
          f"(tolerance {WINDOW_REL_TOL} of the peak)")

    # the front's cost: the same request over the socket and by a direct
    # call.  Offline, each side's wall less the queue and infer ms the
    # server reports (so the generate's own spread drops out); streamed, the
    # first audio byte against the direct first chunk, alternating sides
    loop, server, cserver = ctl["loop"], ctl["server"], ctl["cserver"]

    def direct_offline():
        t = time.perf_counter()
        res = asyncio.run_coroutine_threadsafe(
            server.synthesize(TTSRequest(text=TEXT, seed=5, **creation)), loop).result(600)
        return (time.perf_counter() - t) * 1e3 - res.queue_ms - res.infer_ms

    def http_offline():
        _, _, body, ms, _ = _http(port, "/tts", dict(text=TEXT, seed=5, **creation))
        res = json.loads(body)
        np.frombuffer(base64.b64decode(res["wav_b64"]), np.float32)  # the client's decode
        return ms - res["queue_ms"] - res["infer_ms"]

    def direct_first():
        async def go():  # drained to its end, as the HTTP side reads its whole body
            t, first = time.perf_counter(), None
            async for _ in cserver.synthesize_streaming(TEXT, **creation):
                first = first if first is not None else (time.perf_counter() - t) * 1e3
            return first
        return asyncio.run_coroutine_threadsafe(go(), loop).result(600)

    def http_first():
        return _http(port, "/v1/audio/speech", {"input": TEXT, "voice": "female", "stream": True},
                     first_audio_byte=44)[4]

    samples = {"offline": ([], []), "first": ([], [])}
    for i in range(FRONT_PAIRS):
        for kind, (h_fn, d_fn) in (("offline", (http_offline, direct_offline)),
                                   ("first", (http_first, direct_first))):
            order = ((0, h_fn), (1, d_fn)) if i % 2 else ((1, d_fn), (0, h_fn))
            for side, fn in order:
                samples[kind][side].append(fn())
    pairs = {kind: (float(np.median(h)), float(np.median(d)))
             for kind, (h, d) in samples.items()}
    ctl["stop"]()
    server_thread.join(60)
    if server_thread.is_alive():
        raise AssertionError("front door: serve_http did not return after stop")
    del pipe, ctl, server, cserver, loop, prompt
    mem_after = _allocated()
    left = [u for u in graphs.units() if u.owner in tags]
    for route, ms in walls.items():
        print(f"front door route {route}: {ms:.3f} ms wall | {smi}")
    for route, ms in firsts.items():
        print(f"front door first audio byte {route}: {ms:.3f} ms | {smi}")
    h, d = pairs["offline"]
    print(f"front door overhead, /tts creation (median of {FRONT_PAIRS}; wall less the "
          f"server's queue and infer ms): {h:.3f} ms over the socket, {d:.3f} ms by a direct "
          f"TTSServer call, {h - d:.3f} ms of HTTP, JSON and base64 | {smi}")
    h, d = pairs["first"]
    print(f"front door overhead, first audio (median of {FRONT_PAIRS}): /v1/audio/speech "
          f"stream {h:.3f} ms to its first audio byte, {d:.3f} ms to the first chunk of a direct "
          f"ContinuousTTSServer stream, {h - d:.3f} ms apart | {smi}")
    path_kernels = ("flash_attention_prefill", "dense_decode_attention", "fused_residual_unit")
    print("front door launches of the routes' requests: "
          + json.dumps({k: launches[k] for k in path_kernels}))
    print(f"front door leak check: memory_allocated {mem_before / 2**20:.1f} MiB before the "
          f"phase, {mem_after / 2**20:.1f} MiB after it (its pipeline and servers dropped), "
          f"{(mem_after - mem_before) / 2**20:+.1f} MiB (margin {LEAK_MARGIN_MIB} MiB); "
          f"decode units of its pipeline and engine left: {len(left)}")
    for name in path_kernels:
        if launches[name] < 1:
            raise AssertionError(f"front door: {name} was not launched by the routes")
    if left or mem_after - mem_before > LEAK_MARGIN_MIB * 2**20:
        raise AssertionError("front door: the dropped pipeline's memory or units stayed")
    return launches


def _greedy_tts(port, seed, creation):
    """A /tts creation with top_k 1 (greedy), through raw urllib."""
    import base64
    import urllib.request

    import numpy as np

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tts",
        data=json.dumps(dict(text=TEXT, top_k=1, seed=seed, **creation)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = json.loads(resp.read())
    return np.frombuffer(base64.b64decode(body["wav_b64"]), np.float32), body["sample_rate"]


# ---------------------------------------------------------------------------
# phase 29: speculative decoding through SparkTTSPipeline(speculative_k=k)
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_DRAFTS = (24, 6)  # draft = target (every proposal accepted), the default early exit


def _spec_call(pipe, prompt, mode, greedy, seed=SEED):
    """One request through the pipeline's speculative branch after a warm
    call of the same request (its unit's capture), counts 0 just before and
    read after; returns (ids, accepted, rounds, the positions where a round
    stopped on a rejected proposal, wall ms, launches)."""
    import torch

    ids_t, mask_t = pipe.prompt_inputs(prompt)
    with torch.inference_mode():  # the warm call: the unit's capture
        pipe._speculative(ids_t, mask_t, seed, MAX_NEW_TOKENS, 0.8, 50, 0.95, greedy, mode)
    _sync(pipe.device)
    _reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        tokens, lengths, accepted, rounds, rejected = pipe._speculative(
            ids_t, mask_t, seed, MAX_NEW_TOKENS, 0.8, 50, 0.95, greedy, mode)
        ids = tokens[0, : int(lengths[0])].cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    where = rejected[0].nonzero()[:, 0].cpu().numpy()
    return ids, int(accepted), int(rounds), where, ms, _counts()


def _vanilla_call(pipe, prompt, mode, greedy, seed=SEED):
    """The same request through vanilla decode (warm first): (ids, wall ms)."""
    k = pipe.speculative_k
    pipe.speculative_k = 0
    try:
        pipe.generate_tokens(prompt, seed=seed, max_new_tokens=MAX_NEW_TOKENS, greedy=greedy,
                             mode=mode)
        _sync(pipe.device)
        t0 = time.perf_counter()
        ids = pipe.generate_tokens(prompt, seed=seed, max_new_tokens=MAX_NEW_TOKENS,
                                   greedy=greedy, mode=mode)
        return ids, (time.perf_counter() - t0) * 1e3
    finally:
        pipe.speculative_k = k


def _check_spec_launches(label, launches, n_layers, draft, lm):
    """One flash prefill a layer of target and draft; kernel 2 in every
    draft step of the replayed rounds; on an int8 LM kernel 4 in every draft
    step; on an int4 LM kernel 5 four times a layer in every draft step and
    in every verify (B k = 4 rows); none otherwise."""
    from sparktts_tpu_torch.lm.speculative import ROUNDS_PER_UNIT

    per_replay = ROUNDS_PER_UNIT * SPEC_K * draft
    dense = launches["dense_decode_attention"]
    replays = dense // per_replay
    want = {"flash_attention_prefill": n_layers + draft,
            "int8_mlp_matvec": dense if lm == "int8" else 0,
            "int4_matvec": (replays * ROUNDS_PER_UNIT * 4 * (SPEC_K * draft + n_layers)
                            if lm == "int4" else 0),
            "paged_decode_attention": 0}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if dense == 0 or dense % per_replay or bad:
        raise AssertionError(f"{label}: launches {json.dumps(launches)}; kernel 2 {dense} "
                             f"(want a multiple of {per_replay}), mismatched (got, want): {bad}")


def run_speculative(pipe, prompts, wav_path: Path, int8_params, int4_params, smi):
    """Phase 29: `SparkTTSPipeline(speculative_k=4)` at 500 new tokens on
    the creation and clone prompts (`prompts`: [(ids, "control"), (ids,
    "clone")], the clone's from `wav_path`).  (a) greedy with draft_layers=24 (the
    draft is the target): ids vanilla greedy's under the near-tie rule, and
    every emission where a round stopped on a rejected proposal a near tie
    of the output's dense logits; (b) draft_layers=6, greedy to the same
    rule, and sampled through `inference` to finite waveforms of 320 samples
    a semantic id; (c) greedy, draft 6, on the int8 (kernel 4) and the int4
    LM (kernel 5), to the same rule.  Prints acceptance, ms a token beside
    vanilla's, the units' capture ms and graph MiB; returns the summed
    launches of its speculative calls."""
    import numpy as np

    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.prompt import extract_semantic_ids

    n_layers = pipe.config.llm.num_hidden_layers
    bf16_params = pipe.llm_params
    total = dict.fromkeys(graphs.KERNELS, 0)
    results, units = [], {}

    def record(launches):
        for name, n in launches.items():
            total[name] += n
        # the units go when llm_params changes: report each while it lives
        for u in graphs.units():
            if u.name.startswith("speculative") and u.name not in units:
                units[u.name] = (u.capture_ms, u.pool_bytes / 2**20)
                print(f"speculative unit {u.name}: capture {u.capture_ms:.1f} ms, graph pool "
                      f"{u.pool_bytes / 2**20:.1f} MiB | {smi}")

    def greedy_case(label, params, lm, draft, prompt, mode):
        pipe.llm_params, pipe.speculative_k, pipe.draft_layers = params, SPEC_K, draft
        want, vanilla_ms = _vanilla_call(pipe, prompt, mode, greedy=True)
        got, accepted, rounds, where, ms, launches = _spec_call(pipe, prompt, mode, greedy=True)
        _check_spec_launches(label, launches, n_layers, draft, lm)
        record(launches)
        ok, step = _near_tie_ok(pipe, params, prompt, mode, got, want)
        # rejected proposals: k - 1 a round less the accepted (an EOS in the
        # last round caps it, which counts here as rejections); `where`: the
        # emissions at which a round stopped on one
        rejected = (SPEC_K - 1) * rounds - accepted
        row = dict(label=label, tokens=len(got), accepted=accepted, rounds=rounds,
                   acceptance=accepted / len(got), accepted_per_round=accepted / max(rounds, 1),
                   rejected=rejected, rejecting_rounds=len(where), ms_per_token=ms / len(got),
                   vanilla_ms_per_token=vanilla_ms / len(want), first_diff=step,
                   launches={k: launches[k] for k in ("flash_attention_prefill",
                                                      "dense_decode_attention",
                                                      "int8_mlp_matvec", "int4_matvec")})
        if draft == n_layers:
            # draft = target: a proposal is rejected only where the draft's
            # decode path and the verify's dense path pick apart, at a near
            # tie of the output's own logits
            near = _near_ties(pipe, params, prompt, mode, got)
            row["near_ties"], row["rejected_at"] = int(near.sum()), where.tolist()
            row["rejected_not_near_tie"] = [int(p) for p in where if not near[p]]
        print(f"speculative {label}: {json.dumps(row)} | {smi}")
        results.append(row)
        if not ok:
            raise AssertionError(f"{label}: speculative greedy ids first differ from vanilla "
                                 f"greedy at step {step}, not at a near tie")
        if draft == n_layers and row["rejected_not_near_tie"]:
            raise AssertionError(f"{label}: draft = target rejected proposals at emissions "
                                 f"{row['rejected_not_near_tie']}, not near ties")

    try:
        for draft in SPEC_DRAFTS:
            for prompt, mode in prompts:
                greedy_case(f"greedy, draft {draft}, {mode}", bf16_params, "bf16", draft, prompt,
                            mode)
        # sampled, the early-exit draft: the waveform of the ids a seed gives
        short = SPEC_DRAFTS[-1]
        pipe.llm_params, pipe.speculative_k, pipe.draft_layers = bf16_params, SPEC_K, short
        up = pipe._wave_upsample
        for (prompt, mode), request in zip(prompts, (dict(**VOICE), None)):
            got, accepted, rounds, _, ms, launches = _spec_call(pipe, prompt, mode, greedy=False)
            _check_spec_launches(f"sampled, draft {short}, {mode}", launches, n_layers, short,
                                 "bf16")
            record(launches)
            _, vanilla_ms = _vanilla_call(pipe, prompt, mode, greedy=False)
            if request is not None:
                wav = pipe.inference(TEXT, seed=SEED, max_new_tokens=MAX_NEW_TOKENS, **request)
            else:
                wav = pipe.inference(TEXT, prompt_speech_path=wav_path,
                                     prompt_text=PROMPT_TEXT, seed=SEED,
                                     max_new_tokens=MAX_NEW_TOKENS)
            n_sem = extract_semantic_ids(pipe.tokenizer, got).size
            row = dict(label=f"sampled, draft {short}, {mode}", tokens=len(got), accepted=accepted,
                       rounds=rounds, acceptance=accepted / len(got), ms_per_token=ms / len(got),
                       vanilla_ms_per_token=vanilla_ms / MAX_NEW_TOKENS,
                       semantic_tokens=int(n_sem), wav_samples=int(wav.size))
            print(f"speculative {row['label']}: {json.dumps(row)} | {smi}")
            results.append(row)
            if not (wav.size == n_sem * up and wav.size and np.isfinite(wav).all()):
                raise AssertionError(f"{row['label']}: {wav.size} samples for {n_sem} semantic "
                                     f"ids (want x{up}), finite {bool(np.isfinite(wav).all())}")
        (c_prompt, c_mode), (k_prompt, k_mode) = prompts
        greedy_case(f"greedy, draft {short}, int8 LM, clone", int8_params, "int8", short,
                    k_prompt, k_mode)
        greedy_case(f"greedy, draft {short}, int4 LM, control", int4_params, "int4", short,
                    c_prompt, c_mode)
    finally:
        pipe.llm_params, pipe.speculative_k, pipe.draft_layers = bf16_params, 0, 6
    print("speculative launches (phase 29): " + json.dumps(total))
    return total


# ---------------------------------------------------------------------------
# phase 30: the benchmark harness at full width
# ---------------------------------------------------------------------------

BENCH_NEW_TOKENS = 200


def _wait_healthy(port, timeout_s=300.0):
    """Poll serve_http's /health until 200: the socket opens while the
    streaming server still captures its units, and answers 503 until then."""
    deadline = time.perf_counter() + timeout_s
    while True:
        status = _http(port, "/health", method="GET")[0]
        if status == 200:
            return
        if time.perf_counter() > deadline:
            raise AssertionError(f"serve_http on port {port}: /health {status} after "
                                 f"{timeout_s:.0f} s")
        time.sleep(0.1)


def run_bench(wav_path: Path, smi: str):
    """Phase 30: the runners of `sparktts_tpu_torch/bench/harness.py` over a
    full-width pipeline of their own, few tasks of ~200 tokens each: offline
    (TTSServer, a clone with the prompt's transcript among them), streaming (StreamingSynthesizer), continuous offline and
    streaming on the dense and the paged engine, longform, gRPC (framed) and
    the network streaming runner over serve_http.  Each returns num_tasks =
    its task count and rtf > 0.  Then the dispatch probe, speaker similarity
    and semantic consistency of one vocoded request, and the leak check of
    phase 28 after the pipeline is dropped.  Returns the runners' launches
    (counts 0 just before the first)."""
    import threading

    import numpy as np

    from sparktts_tpu_torch.bench import harness as H
    from sparktts_tpu_torch.bench.metrics import semantic_consistency, speaker_similarity
    from sparktts_tpu_torch.bench.relay_probe import measure_dispatch_tax
    from sparktts_tpu_torch.config import StreamingConfig
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.serve.server import serve_http

    mem_before = _allocated()
    units_before = {id(u) for u in graphs.units()}
    t_phase = time.perf_counter()
    pipe = SparkTTSPipeline(device="cuda", seed=SEED, max_new_tokens=BENCH_NEW_TOKENS,
                            wav_bucket_s=PROMPT_SECONDS)
    prompt = pipe._load_prompt_wav(wav_path).astype(np.float32)
    clone = H.BenchTask(text=TEXT, prompt_wav=prompt, prompt_text=PROMPT_TEXT)
    plain_clone = H.BenchTask(text="One card serves eight voices here.", prompt_wav=prompt)
    creation = H.BenchTask(text=TEXT, gender="female")
    mixed = [clone, plain_clone, creation]
    # the continuous servers' slots (cache 4 prompt buckets + the budget) hold
    # clone prompts without the 6 s prompt's transcript (419 ids)
    served = [plain_clone, creation, H.BenchTask(text="A third voice.", prompt_wav=prompt)]
    pairs = []

    def check(name, stats, tasks):
        print(f"bench {name}: {json.dumps(stats)} | {smi}")
        if stats["num_tasks"] != len(tasks) or not (stats["rtf"] or 0) > 0:
            raise AssertionError(f"bench {name}: num_tasks {stats['num_tasks']} (want "
                                 f"{len(tasks)}), rtf {stats['rtf']}")
        pairs.append((name, stats["rtf"]))

    _sync(pipe.device)
    _reset_counts()
    check("offline", H.run_offline_benchmark(pipe, mixed, concurrency=3), mixed)
    check("streaming", H.run_streaming_benchmark(pipe, [creation], StreamingConfig()), [creation])
    for paged in (False, True):
        for streaming in (False, True):
            name = f"continuous {'paged' if paged else 'dense'} " + (
                "streaming" if streaming else "offline")
            check(name, H.run_continuous_benchmark(
                pipe, served, concurrency=3, streaming=streaming, max_slots=4,
                max_new_tokens=BENCH_NEW_TOKENS, paged=paged), served)
    check("longform", H.run_longform_benchmark(
        pipe, [plain_clone], n_requests=1, segments=2, max_slots=2,
        segment_max_new_tokens=BENCH_NEW_TOKENS), [plain_clone])
    grpc_tasks = [creation, plain_clone]
    check("grpc framed", H.run_grpc_streaming_benchmark(
        pipe, grpc_tasks, concurrency=2, max_new_tokens=BENCH_NEW_TOKENS, transport="framed",
        max_slots=2), grpc_tasks)
    ctl: dict = {}
    server_thread = threading.Thread(target=serve_http, args=(pipe,), name="serve_http",
                                     kwargs=dict(host="127.0.0.1", port=0, control=ctl))
    server_thread.start()
    while "stop" not in ctl:
        if not server_thread.is_alive():
            raise AssertionError("bench: serve_http ended before it listened")
        time.sleep(0.05)
    try:
        port = ctl["httpd"].server_address[1]
        _wait_healthy(port)
        check("network streaming", H.run_network_streaming_benchmark(
            "127.0.0.1", port, grpc_tasks, concurrency=2, max_new_tokens=BENCH_NEW_TOKENS),
            grpc_tasks)
    finally:
        ctl["stop"]()
        server_thread.join(60)
    launches = _counts()
    print("bench launches of the runners (phase 30): " + json.dumps(launches))
    for name in ("flash_attention_prefill", "dense_decode_attention", "fused_residual_unit",
                 "paged_decode_attention"):
        if launches[name] < 1:
            raise AssertionError(f"bench: {name} was not launched by the runners")
    probe = measure_dispatch_tax()
    print(f"bench dispatch probe: {json.dumps(probe)} | {smi}")
    wav = pipe.inference(TEXT, prompt_speech_path=prompt, prompt_text=PROMPT_TEXT, seed=SEED)
    sim = speaker_similarity(pipe, prompt, wav)
    consistency = semantic_consistency(pipe, wav)
    print(f"bench metrics of one cloned request: speaker_similarity to its prompt {sim:.6f}, "
          f"semantic_consistency {consistency:.6f} | {smi}")
    if not (-1.0 <= sim <= 1.0 and 0.0 <= consistency <= 1.0):
        raise AssertionError(f"bench metrics out of range: {sim}, {consistency}")
    if server_thread.is_alive():
        raise AssertionError("bench: serve_http did not return after stop")
    del pipe, ctl, prompt, clone, plain_clone, creation, mixed, served, grpc_tasks, wav
    mem_after = _allocated()
    left = [u for u in graphs.units() if id(u) not in units_before]
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s; leak check: memory_allocated "
          f"{mem_before / 2**20:.1f} MiB before, {mem_after / 2**20:.1f} MiB after, "
          f"{(mem_after - mem_before) / 2**20:+.1f} MiB (margin {LEAK_MARGIN_MIB} MiB); "
          f"decode units left: {len(left)}")
    if left or mem_after - mem_before > LEAK_MARGIN_MIB * 2**20:
        raise AssertionError("bench: the dropped pipeline's memory or units stayed")
    return launches


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
                            "int4_matmul", "paged_attention"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernel_build.log").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in logs.items()))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    pipe = SparkTTSPipeline(device=dev, seed=SEED)
    n_layers = pipe.config.llm.num_hidden_layers
    if "--front-only" in sys.argv[1:]:
        # a shorter run for working on the front door: phase 28 alone, no
        # kernels line and no result line
        run_front_door(make_prompt_wav(OUT_DIR / "clone_prompt.wav"), smi)
        return 0
    if "--spec-only" in sys.argv[1:]:
        # phase 29 alone (its prompts built here), no kernels line and no
        # result line
        from sparktts_tpu_torch.prompt import build_clone_prompt, build_control_prompt

        wav_path = make_prompt_wav(OUT_DIR / "clone_prompt.wav")
        glob, sem = pipe.tokenize_audio(wav_path)
        prompts = [(build_control_prompt(pipe.tokenizer, TEXT, **VOICE), "control"),
                   (build_clone_prompt(pipe.tokenizer, TEXT, glob, sem, PROMPT_TEXT), "clone")]
        run_speculative(pipe, prompts, wav_path, quantize_qwen_int8(pipe.llm_params),
                        quantize_qwen_int4(pipe.llm_params, group=INT4_GROUP), smi)
        return 0
    if "--bench-only" in sys.argv[1:]:
        # phase 30 alone, no kernels line and no result line
        del pipe
        run_bench(make_prompt_wav(OUT_DIR / "clone_prompt.wav"), smi)
        return 0
    if "--servers-only" in sys.argv[1:]:
        # a shorter run for working on the server phases: no other phase, no
        # bare-engine yardstick, no kernels line and no result line
        run_servers(pipe, make_prompt_wav(OUT_DIR / "clone_prompt.wav"), float("nan"),
                    quantize_qwen_int8(pipe.llm_params))
        return 0
    creation = run_voice_creation(pipe)
    check_graph_vs_eager("voice creation", pipe, creation[1], "control", creation[2])
    wav_path = make_prompt_wav(OUT_DIR / "clone_prompt.wav")
    cloning = run_voice_cloning(pipe, wav_path)
    check_graph_vs_eager("voice cloning", pipe, cloning[1], "clone", cloning[2])
    check_threads(pipe, [(creation[1], "control"), (creation[1], "control"), (cloning[1], "clone")])
    check_tokenize_on_cpu(pipe, wav_path)

    # the weight-only quantized LMs, quantized on the card from the same bf16
    # params, through the same entry point
    bf16_params = pipe.llm_params
    int8_params = quantize_qwen_int8(bf16_params)
    int4_params = quantize_qwen_int4(bf16_params, group=INT4_GROUP)
    pipe.llm_params = int8_params
    cloning_int8 = run_voice_cloning(pipe, wav_path, label="voice cloning, int8 LM",
                                     mlp_per_layer=1)
    check_graph_vs_eager("voice cloning, int8 LM", pipe, cloning_int8[1], "clone",
                         cloning_int8[2])
    pipe.llm_params = int4_params
    creation_int4 = run_voice_creation(pipe, label="voice creation, int4 LM", int4_per_layer=4)
    check_graph_vs_eager("voice creation, int4 LM", pipe, creation_int4[1], "control",
                         creation_int4[2])
    pipe.llm_params = bf16_params
    check_int8_codec(pipe, cloning_int8[3])

    # continuous batching: the paged and the dense engine serve one burst
    paged_entry, dense_state, engine_launches, engine_tokens_per_s = run_engines(pipe, wav_path)
    # token streaming over decode_chunk
    _, stream_launches = run_streaming(pipe)
    # a checkpoint directory, the untied head, the batch surfaces, longform,
    # the voice cache
    _, checkpoint_launches = run_checkpoint(pipe, wav_path)
    untied_launches = run_untied(pipe, creation[1])
    b1_tokens_per_s = cloning[2]["generated_tokens"] / cloning[2]["generate_ms"] * 1e3
    _, batch_launches, batch_kernels = run_batch(pipe, wav_path, b1_tokens_per_s)
    _, long_launches = run_longform(pipe)
    _, cache_launches = run_voice_cache(pipe, wav_path)

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
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"], check_decode_two_streams(dev, cfg))
    entries.append(check_int8_mlp(dev, unstack_layers(int8_params["layers"])))
    entries.append(check_int4(dev, unstack_layers(int4_params["layers"])))
    # the continuous-batching server over both engines, after the launch
    # traces above: when it ran before them, on an H100, none of their later
    # profiler sessions recorded device activity
    server_launches, server_items, server_errs = run_servers(pipe, wav_path, engine_tokens_per_s,
                                                             int8_params)
    # the HTTP front door over a pipeline of its own, dropped after
    front_launches = run_front_door(wav_path, smi)
    # speculative decoding through the pipeline; the benchmark harness over a
    # pipeline of its own, dropped after
    spec_launches = run_speculative(pipe, [(creation[1], "control"), (cloning[1], "clone")],
                                    wav_path, int8_params, int4_params, smi)
    bench_launches = run_bench(wav_path, smi)
    for _, prompt, _, _ in (creation, cloning):
        check_lm_prefill(pipe, prompt)
    check_decode_step_on_cpu(pipe, int8_params, "int8 LM", creation[1], "control")
    check_decode_step_on_cpu(pipe, int4_params, "int4 LM", creation[1], "control")
    del int8_params, int4_params
    torch.cuda.empty_cache()

    entries.append(paged_entry)
    entries[1]["by_shape"].append(dense_state)
    for e in entries:
        if e["name"] in batch_kernels:
            err, item = batch_kernels[e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["by_shape"].append(item)
    for e in entries:
        if e["name"] in server_items:
            e["by_shape"].append(server_items[e["name"]])
            e["max_abs_err"] = max(e["max_abs_err"], server_errs.get(e["name"], 0.0))
    check_units(n_layers)
    check_failed_capture(dev)
    runs = [r[0] for r in (creation, cloning, cloning_int8, creation_int4)] + list(engine_launches)
    runs += [stream_launches, *checkpoint_launches, untied_launches, batch_launches, long_launches,
             cache_launches, *server_launches, front_launches, spec_launches, bench_launches]
    for e in entries:
        e["launches"] = sum(run[e["name"]] for run in runs)
    print("launches of the server phases (24-27):",
          json.dumps({e["name"]: sum(run[e["name"]] for run in server_launches) for e in entries}))
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "yardsticks", "by_shape"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
