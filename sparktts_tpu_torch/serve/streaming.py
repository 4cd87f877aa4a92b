"""Streaming synthesis: a growing chunk schedule and a cross-fade.

Port of `sparktts_tpu/serve/streaming.py`, the reference's Triton BLS
streaming design (chunks grow from 1 s by x8 up to 30 s, 0.1 s overlap)
with a linear cross-fade at each seam.  The LM decodes in dispatches of a
few fixed sizes through `decode_chunk`, each a run of captured decode-unit
replays on the card (`lm/graphs.py`); the host checks for EOS between
dispatches and vocodes each finished token chunk.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np
import torch

from sparktts_tpu_torch.config import StreamingConfig
from sparktts_tpu_torch.lm.generate import decode_chunk, prefill
from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache
from sparktts_tpu_torch.parallel.worker import leader_of
from sparktts_tpu_torch.prompt import (
    build_clone_prompt,
    build_control_prompt,
    extract_semantic_ids,
    padded_global_tokens,
)


def chunk_sizes(cfg: StreamingConfig) -> Iterator[int]:
    """Token chunk schedule (reference `spark_tts/1/model.py:350-375`)."""
    chunk = math.ceil(cfg.audio_chunk_duration * cfg.frame_rate)
    max_chunk = math.ceil(cfg.max_audio_chunk_duration * cfg.frame_rate)
    while True:
        yield chunk
        chunk = min(max_chunk, int(chunk * cfg.audio_chunk_size_scale_factor))


def overlap_tokens(cfg: StreamingConfig) -> int:
    return math.ceil(cfg.audio_chunk_overlap_duration * cfg.frame_rate)


def _emit_with_tail(tail, wav: np.ndarray, overlap_samples: int) -> tuple:
    """Fade the held-back tail of the previous chunk into this chunk's head
    and emit all but this chunk's own tail, held for the next fade: only
    `overlap_samples` of latency are added.  Returns (tail, emit)."""
    ov = overlap_samples
    if tail is not None and ov > 0 and len(wav) >= ov and len(tail) >= ov:
        fade_out = np.linspace(1.0, 0.0, ov, dtype=np.float32)
        fade_in = np.linspace(0.0, 1.0, ov, dtype=np.float32)
        head = tail[-ov:] * fade_out + wav[:ov] * fade_in
        wav = np.concatenate([head.astype(wav.dtype), wav[ov:]])
    if ov > 0 and len(wav) > ov:
        return wav[-ov:], wav[:-ov]
    return None, wav


def cross_fade(prev: np.ndarray, nxt: np.ndarray, overlap_samples: int) -> tuple:
    """Linear cross-fade between consecutive chunks (reference
    `client_grpc.py:391-416`).  Returns (emit_now, carry): `prev` with the
    head of `nxt` faded into its last samples, and the rest of `nxt`."""
    if overlap_samples == 0 or len(prev) == 0:
        return prev, nxt
    ov = min(overlap_samples, len(prev), len(nxt))
    fade_out = np.linspace(1.0, 0.0, ov, dtype=np.float32)
    fade_in = np.linspace(0.0, 1.0, ov, dtype=np.float32)
    merged = prev.copy()
    merged[-ov:] = prev[-ov:] * fade_out + nxt[:ov] * fade_in
    return merged, nxt[ov:]


class StreamingSynthesizer:
    """Token-streaming TTS over a `SparkTTSPipeline`: yields waveform chunks
    as the LM decodes, in dispatches of `steps_per_dispatch` tokens (and two
    other fixed sizes), with the EOS check on the host between dispatches."""

    def __init__(self, pipeline, streaming_cfg: Optional[StreamingConfig] = None,
                 steps_per_dispatch: int = 25):
        self.pipe = pipeline
        self.cfg = streaming_cfg or pipeline.config.streaming
        self.steps = steps_per_dispatch

    @torch.inference_mode()
    def stream(
        self,
        text: str,
        prompt_speech_path=None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
    ) -> Iterator[np.ndarray]:
        pipe = self.pipe
        if leader_of(pipe.llm_params) is not None:
            raise ValueError("StreamingSynthesizer is not mirrored to a tensor-parallel row's "
                             "followers; stream through ContinuousTTSServer")
        tok = pipe.tokenizer
        if gender is not None:
            ids = build_control_prompt(tok, text, gender, pitch, speed)
            global_token_ids = None
        else:
            global_token_ids, semantic_token_ids = pipe.tokenize_audio(prompt_speech_path)
            ids = build_clone_prompt(
                tok, text, global_token_ids,
                semantic_token_ids if prompt_text is not None else None, prompt_text,
            )

        max_new = max_new_tokens or pipe.max_new_tokens
        input_ids, mask = pipe.prompt_inputs(ids)
        t_pad = input_ids.shape[1]

        schedule = chunk_sizes(self.cfg)
        ov_tokens = overlap_tokens(self.cfg)
        target = next(schedule)

        # dispatch sizes: the first covers exactly the first chunk (first-audio
        # latency), later ones are large (throughput); a fixed size set keeps
        # the decode units few, and one unit of their gcd steps serves all
        # three.  The cache carries one dispatch of slack, so the last
        # dispatch needs no clamping to the budget; overshoot tokens are
        # dropped on the host.
        first_dispatch = target
        big_dispatch = max(self.steps, 100)
        slack = max(first_dispatch, big_dispatch)
        unit_steps = math.gcd(first_dispatch, math.gcd(self.steps, big_dispatch))
        cfg = pipe.config
        cache = init_kv_cache(cfg.llm, 1, aligned_cache_len(t_pad + max_new + slack),
                              pipe.lm_dtype, pipe.device)
        vocab_slice, extra_ids = pipe.guided_constraint(
            "control" if gender is not None else "clone")
        eos_ids = tuple(tok.eos_ids)
        generator = torch.Generator(device=pipe.device).manual_seed(seed)
        state = prefill(pipe.llm_params, cfg.llm, input_ids, mask, cache, generator, temperature,
                        top_k, top_p, vocab_slice=vocab_slice, extra_ids=extra_ids)

        token_buf: List[int] = []
        pending: List[np.ndarray] = []  # raw LM ids so far
        tail: Optional[np.ndarray] = None  # overlap samples held for fading
        total_steps = 0
        done = False

        def vocode(sem_ids: np.ndarray) -> np.ndarray:
            nonlocal global_token_ids
            if global_token_ids is None:
                # voice creation: the globals head the raw emitted stream
                raw = np.concatenate(pending) if pending else np.zeros(0, np.int64)
                global_token_ids = padded_global_tokens(
                    tok, raw, cfg.bicodec.speaker_encoder.token_num)
            return pipe.detokenize(global_token_ids, sem_ids[None, :])

        # the sample overlap follows the token overlap at the codec's true
        # token-to-sample ratio, so the fade never duplicates seam audio
        overlap_samples = ov_tokens * pipe._wave_upsample

        while not done and total_steps < max_new:
            need = max(1, target - len(token_buf))
            if total_steps == 0:
                n = first_dispatch
            elif need <= self.steps:
                n = self.steps
            else:
                n = big_dispatch
            state, toks, valid = decode_chunk(
                pipe.llm_params, cfg.llm, state, t_pad, n, generator, temperature, top_k, top_p,
                eos_ids, tok.pad_id, vocab_slice=vocab_slice, extra_ids=extra_ids,
                unit_steps=unit_steps, units=pipe.units,
            )
            # one host transfer for both
            host = torch.stack([toks[0], valid[0].long()]).cpu().numpy()
            toks_h, valid_h = host[0], host[1].astype(bool)
            # drop overshoot beyond the token budget
            raw = toks_h[valid_h][: max_new - total_steps]
            total_steps += n
            pending.append(raw)
            done = not bool(valid_h[-1]) or total_steps >= max_new
            token_buf.extend(extract_semantic_ids(tok, raw).tolist())

            while len(token_buf) >= target:
                wav = vocode(np.asarray(token_buf[:target], np.int64))
                token_buf = token_buf[target - ov_tokens:]
                target = next(schedule)
                tail, emit = _emit_with_tail(tail, wav, overlap_samples)
                if len(emit):
                    yield emit

        if token_buf:
            wav = vocode(np.asarray(token_buf, np.int64))
            tail, emit = _emit_with_tail(tail, wav, overlap_samples)
            if len(emit):
                yield emit
        if tail is not None and len(tail):
            yield tail
