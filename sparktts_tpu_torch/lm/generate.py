"""Autoregressive generation: prefill, then an eager decode loop.

Port of `sparktts_tpu/lm/generate.py`.  JAX runs the decode loop as one XLA
`while_loop` that exits as soon as every row has emitted EOS.  Here the loop
is Python over eager `decode_step`s: the host enqueues each step's kernels
and reads nothing back, except that every `DONE_CHECK_EVERY` steps it reads
whether every row is done.  A row that is done emits `pad_id` with
`valid=False`, so checking late changes no output: it only runs up to
`DONE_CHECK_EVERY - 1` steps whose tokens are discarded, where a check at
every step would stall the host on the device once per token.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm.qwen import (
    KVCache,
    aligned_cache_len,
    init_kv_cache,
    prefill_positions,
    qwen_forward,
)
from sparktts_tpu_torch.lm.sample import Generators, greedy_token, sample_token

DONE_CHECK_EVERY = 8


class GenState(NamedTuple):
    """Decode-loop state.  `step` is a host int (tokens generated so far)."""

    cache: KVCache
    cur_token: torch.Tensor   # (B,) int64, last sampled token
    step: int
    done: torch.Tensor        # (B,) bool
    start: torch.Tensor       # (B,) int32 first valid cache slot (left-pad offset)
    prompt_len: torch.Tensor  # (B,) int64 true prompt lengths


def packed_allowed_mask(
    vocab_slice, extra_ids, allow_slice, allow_extras, device="cpu"
) -> torch.Tensor:
    """(W,) bool over the packed guided logit axis (slice rows then extras):
    True where the packed row's full-vocab id lies in [allow_slice[0],
    allow_slice[1]) or in allow_extras.  The continuous engines sample under
    the control-mode superset and narrow clone-mode slots with this mask to
    semantic ids and EOS."""
    lo, hi = vocab_slice
    ids = torch.cat([torch.arange(lo, hi), torch.tensor(extra_ids, dtype=torch.long)])
    a_lo, a_hi = allow_slice
    allowed = (ids >= a_lo) & (ids < a_hi)
    if allow_extras:
        allowed |= torch.isin(ids, torch.tensor(allow_extras, dtype=torch.long))
    return allowed.to(device)


def expand_constrained(idx: torch.Tensor, vocab_slice, extra_ids) -> torch.Tensor:
    """Packed constrained-logits index (slice rows then extras) -> full-vocab id."""
    if vocab_slice is None:
        return idx
    lo, hi = vocab_slice
    tok = idx + lo
    for i, e in enumerate(extra_ids):
        tok = torch.where(idx == hi - lo + i, e, tok)
    return tok


def _next_token(generator, logits, temperature, top_k, top_p, greedy, vocab_slice, extra_ids):
    if greedy:
        tok = greedy_token(logits)
    else:
        tok = sample_token(generator, logits, temperature, top_k, top_p)
    return expand_constrained(tok, vocab_slice, extra_ids)


def prefill(
    params,
    cfg: QwenConfig,
    input_ids: torch.Tensor,    # (B, T_pad) left-padded
    prompt_mask: torch.Tensor,  # (B, T_pad) bool
    cache: KVCache,
    generator: Generators,
    temperature: float,
    top_k: int,
    top_p: float,
    greedy: bool = False,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
) -> GenState:
    """Run the prompt through the model (attention through the flash
    kernel module) and sample the first new token."""
    t_pad = input_ids.shape[1]
    prompt_len = prompt_mask.long().sum(dim=1)
    start = (t_pad - prompt_len).to(torch.int32)
    logits, cache = qwen_forward(
        params, cfg, input_ids, prefill_positions(prompt_mask), cache, 0, None, flash_start=start,
        vocab_slice=vocab_slice, extra_ids=extra_ids, logits_last_only=True,
    )
    tok = _next_token(generator, logits[:, -1], temperature, top_k, top_p, greedy,
                      vocab_slice, extra_ids)
    done = torch.zeros(input_ids.shape[0], dtype=torch.bool, device=input_ids.device)
    return GenState(cache, tok, 0, done, start, prompt_len)


def decode_step(
    params,
    cfg: QwenConfig,
    state: GenState,
    t_pad: int,
    generator: Generators,
    temperature: float,
    top_k: int,
    top_p: float,
    eos_ids: Sequence[int],
    pad_id: int,
    greedy: bool = False,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
) -> GenState:
    """Feed state.cur_token, sample the next.  Keys are valid in the window
    [start, t_pad + step] (the decode kernel's index compare)."""
    cache_pos = t_pad + state.step
    positions = (state.prompt_len + state.step)[:, None]
    pos = torch.full_like(state.start, cache_pos)
    logits, cache = qwen_forward(
        params, cfg, state.cur_token[:, None], positions, state.cache, cache_pos, None,
        decode_window=(state.start, pos), vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    nxt = _next_token(generator, logits[:, -1], temperature, top_k, top_p, greedy,
                      vocab_slice, extra_ids)
    # `done` flips once the token just consumed was EOS: the EOS itself is
    # part of the output (HF generate semantics)
    is_eos = torch.zeros_like(state.done)
    for e in eos_ids:
        is_eos = is_eos | (state.cur_token == e)
    done = state.done | is_eos
    nxt = torch.where(done, pad_id, nxt)
    return GenState(cache, nxt, state.step + 1, done, state.start, state.prompt_len)


@torch.inference_mode()
def generate(
    params,
    cfg: QwenConfig,
    input_ids: torch.Tensor,    # (B, T_pad) int64, left-padded
    prompt_mask: torch.Tensor,  # (B, T_pad) bool
    generator: Generators,
    max_new_tokens: int,
    cache_len: int,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    greedy: bool = False,
    cache_dtype=torch.bfloat16,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_new_tokens) int64 padded with pad_id after
    EOS, lengths (B,) including the EOS token).  Emission validity is the
    explicit `valid` mask, never inferred from token values (pad_id may be a
    legal sampled id)."""
    b, t_pad = input_ids.shape
    if cache_len < t_pad + max_new_tokens:
        raise ValueError(f"cache_len {cache_len} < {t_pad} + {max_new_tokens}")
    cache = init_kv_cache(cfg, b, aligned_cache_len(cache_len), cache_dtype, input_ids.device)
    state = prefill(
        params, cfg, input_ids, prompt_mask, cache, generator, temperature, top_k, top_p,
        greedy, vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    tokens = torch.full((b, max_new_tokens), pad_id, dtype=torch.long, device=input_ids.device)
    valid = torch.zeros((b, max_new_tokens), dtype=torch.bool, device=input_ids.device)
    for step in range(max_new_tokens):
        tokens[:, step] = torch.where(state.done, pad_id, state.cur_token)
        valid[:, step] = ~state.done
        if step + 1 == max_new_tokens:
            break  # the next token would fall outside the budget
        state = decode_step(
            params, cfg, state, t_pad, generator, temperature, top_k, top_p, eos_ids,
            pad_id, greedy, vocab_slice, extra_ids,
        )
        if (step + 1) % DONE_CHECK_EVERY == 0 and bool(state.done.all()):
            break
    return tokens, valid.sum(dim=1)
