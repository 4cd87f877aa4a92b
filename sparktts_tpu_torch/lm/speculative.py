"""Speculative decoding: draft k tokens, then verify them in one forward.

Port of `sparktts_tpu/lm/speculative.py` (PAPERS.md: "Fast and High-Quality
Auto-Regressive Speech Synthesis via Speculative Decoding", arxiv
2410.21951).  A cheap draft proposes `k` tokens one decode step at a time;
the target scores the whole window in one forward of k tokens; the longest
prefix the target agrees with is accepted, and the target's own prediction
at the first disagreement is taken as a bonus token.  Greedy: the output is
the target's vanilla greedy `generate`, whatever the draft proposes.
Sampled: modified rejection sampling over the warped distributions, so the
output distribution is vanilla sampling's.

The draft can be any Qwen-shaped tree; `draft_from_layers` makes the
self-speculative early-exit draft, the first n layers of the target as views
(the layer params are stacked (L, ...)) with the shared embedding, final
norm and head.

The JAX package runs the loop as one `while_loop`.  The port runs it as
captured units (`lm/graphs.py`): one `DecodeUnit` replays
`ROUNDS_PER_UNIT` rounds, each the k draft decode steps (through the decode
attention kernel module, and on an int8 LM the fused MLP module: the JAX
draft keeps off its kernels only for a Mosaic miscompile on v5e), the
verify (a `qwen_forward` of k tokens with an additive window bias, written
at a (B,) device position) and the acceptance, all on the device.  Its
state, both caches, the device step and the (B, max_new + k + 1) tokens and
validity included, lives in the unit's buffers, and a round writes its
tokens at the device offset `step`.  The host reads the step and the done
flags after each replay, as `generate` reads done after each unit.  Rounds
that run after the budget is spent or every row is done change nothing: their
advance is 0, and their cache and token writes land past every kept slot
(clamped into the buffers).  On the CPU the same rounds run eagerly.

KV-cache staleness on rejection needs no rollback: every slot is written at
exactly one sequence position, attention reads slots up to the current one
only, and rejected slots are overwritten when those positions are
generated for real.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.generate import expand_constrained, prefill
from sparktts_tpu_torch.lm.qwen import KVCache, aligned_cache_len, init_kv_cache, qwen_forward
from sparktts_tpu_torch.lm.sample import greedy_token, sample_token, warped_probs
from sparktts_tpu_torch.parallel.mesh import tp_of

#: Rounds a captured unit runs a replay; the host reads step and done after each.
ROUNDS_PER_UNIT = 4


def draft_from_layers(params, n_layers: int):
    """Early-exit self-speculative draft: the first n layers of the target
    (views) with the shared embedding, final norm and head."""
    draft = dict(params)
    draft["layers"] = {name: {k: t[:n_layers] for k, t in sub.items()}
                       for name, sub in params["layers"].items()}
    return draft


def draft_config(cfg: QwenConfig, n_layers: int) -> QwenConfig:
    return dataclasses.replace(cfg, num_hidden_layers=n_layers)


def _window_bias(start: torch.Tensor, first_pos, t: int, cache_len: int) -> torch.Tensor:
    """(B, t, S) additive fp32 bias for a t-token verify window whose i-th
    query sits at cache slot first_pos + i (an int, or a device tensor of ()
    or (B,)): valid keys are [start[b], first_pos + i]."""
    dev = start.device
    offs = torch.arange(t, device=dev)
    q_pos = offs + (first_pos if isinstance(first_pos, int) else first_pos.reshape(-1, 1))
    k_idx = torch.arange(cache_len, device=dev)[None, None, :]
    valid = (k_idx >= start[:, None, None]) & (k_idx <= q_pos.reshape(-1, t, 1))
    return torch.where(valid, 0.0, -1e9).float()


class SpecState(NamedTuple):
    """The speculative loop's state, all on the device."""

    tgt_cache: KVCache
    drf_cache: KVCache
    cur_token: torch.Tensor   # (B,) int64, the next emission, not yet fed
    step: torch.Tensor        # () int64, tokens emitted so far
    done: torch.Tensor        # (B,) bool
    start: torch.Tensor       # (B,) int32 left-pad offsets
    prompt_len: torch.Tensor  # (B,) int64
    accepted: torch.Tensor    # () int64, draft tokens accepted (telemetry)
    rounds: torch.Tensor      # () int64, rounds that advanced (telemetry)
    tokens: torch.Tensor      # (B, max_new + k + 1) int64 emissions by position
    valid: torch.Tensor       # (B, max_new + k + 1) bool
    rejected: torch.Tensor    # (B, max_new + k + 1) bool: the emissions whose
    #                           proposal the target rejected (telemetry)


def _categorical(generator: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row from (B, W) probabilities, by the Gumbel-max trick
    over their logs (the form `jax.random.categorical` uses)."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2**-24)))
    return torch.argmax(torch.log(probs + 1e-30) + gumbel, dim=-1)


def speculative_round(params, draft_params, cfg: QwenConfig, draft_cfg: QwenConfig,
                      state: SpecState, t_pad: int, k: int, max_new: int,
                      generator: Optional[torch.Generator], temperature, top_k: int, top_p,
                      greedy: bool, eos_ids: Tuple[int, ...], pad_id: int,
                      vocab_slice=None, extra_ids: Tuple[int, ...] = ()) -> SpecState:
    """One round: k draft steps, one verify, the acceptance; the caches and
    the token buffers are written in place, the rest is returned.  No host
    int depends on the state, so a CUDA graph can replay it."""
    b, s_len = state.cur_token.shape[0], state.tgt_cache.k.shape[2]
    dev = state.cur_token.device
    idxk = torch.arange(k, device=dev)
    s0 = state.step
    finished = (s0 >= max_new) | state.done.all()

    # ---- the draft proposes: window[:, i] is the candidate emission s0 + i
    # (window[:, 0] = cur_token is already the true one; the draft feeds
    # each window token to propose the next)
    tok, fed, packed, p_draft = state.cur_token, [], [], []
    for i in range(k):
        pos = (s0 + t_pad + i).clamp(max=s_len - 1).to(torch.int32).expand(b).contiguous()
        positions = (state.prompt_len + s0 + i)[:, None]
        logits, _ = qwen_forward(
            draft_params, draft_cfg, tok[:, None], positions, state.drf_cache, pos, None,
            decode_window=(state.start, pos), vocab_slice=vocab_slice, extra_ids=extra_ids,
        )
        last = logits[:, -1]
        if greedy:
            nxt = greedy_token(last)
        else:
            p_draft.append(warped_probs(last, temperature, top_k, top_p))
            nxt = sample_token(generator, last, temperature, top_k, top_p)
        fed.append(tok)
        packed.append(nxt)
        tok = expand_constrained(nxt, vocab_slice, extra_ids)
    window = torch.stack(fed, dim=1)  # (B, k) full-vocab ids

    # ---- the target scores the whole window in one forward
    first = (s0 + t_pad).clamp(max=s_len - k)
    bias = _window_bias(state.start, first, k, s_len)
    positions = (state.prompt_len + s0)[:, None] + idxk[None, :]
    logits, _ = qwen_forward(
        params, cfg, window, positions, state.tgt_cache,
        first.to(torch.int32).expand(b).contiguous(), bias,
        vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    w = logits.shape[-1]

    if greedy:
        # accept the longest prefix of drafts the target agrees with; the
        # target's prediction after it is the bonus
        preds = expand_constrained(greedy_token(logits.reshape(b * k, w)).reshape(b, k),
                                   vocab_slice, extra_ids)  # target emission s0 + i + 1
        agree = window[:, 1:] == preds[:, :-1]
        n_acc = torch.cumprod(agree.long(), dim=1).sum(dim=1)
        stop_tok = torch.gather(preds, 1, n_acc[:, None])[:, 0]
    else:
        # modified rejection sampling over the k - 1 proposals: x is kept
        # with probability min(1, q(x) / p(x))
        q = warped_probs(logits.reshape(b * k, w), temperature, top_k, top_p).reshape(b, k, w)
        p = torch.stack(p_draft, dim=1)      # (B, k, W): draft dist for s0 + i + 1
        x = torch.stack(packed, dim=1)[:, :-1, None]  # packed ids of the k - 1 proposals
        q_x = torch.gather(q[:, :-1], 2, x)[:, :, 0]
        p_x = torch.gather(p[:, :-1], 2, x)[:, :, 0]
        u = torch.rand((b, k - 1), generator=generator, device=dev)
        n_acc = torch.cumprod((u * p_x < q_x).long(), dim=1).sum(dim=1)
        # the emission at the stop position: from the residual on a
        # rejection, from q on full acceptance (the bonus)
        at = n_acc[:, None, None].expand(b, 1, w)
        q_stop, p_stop = torch.gather(q, 1, at)[:, 0], torch.gather(p, 1, at)[:, 0]
        residual = (q_stop - p_stop).clamp_min(0.0)
        # numerical guard: an empty residual (p covers q) falls back to q
        residual = torch.where(residual.sum(dim=1, keepdim=True) > 1e-9, residual, q_stop)
        dist = torch.where((n_acc == k - 1)[:, None], q_stop, residual)
        stop_tok = expand_constrained(_categorical(generator, dist), vocab_slice, extra_ids)
    n_consume = n_acc + 1

    # EOS inside the consumed prefix caps the row's progress
    is_eos = torch.zeros_like(window, dtype=torch.bool)
    for e in eos_ids:
        is_eos = is_eos | (window == e)
    eos_at = is_eos & (idxk[None, :] < n_consume[:, None])
    has_eos = eos_at.any(dim=1)
    first_eos = eos_at.long().argmax(dim=1)
    n_consume = torch.where(has_eos, first_eos + 1, n_consume)

    # aligned layout: every row advances by the least live consumption (the
    # caches stay position-consistent; rows that verified further re-derive
    # those tokens next round); a finished round advances by 0
    live = ~state.done
    advance = torch.where(live, n_consume, k + 1).min()
    advance = torch.where(finished, 0, advance)

    # emissions s0 + i for i < advance, at the device offset s0 (clamped
    # into the buffer: only a finished round reaches its end, past every
    # valid slot)
    eos_cap = torch.where(has_eos, first_eos, k)
    row_valid = (idxk[None, :] < advance) & live[:, None] & (idxk[None, :] <= eos_cap[:, None])
    cols = (s0 + idxk).clamp(max=state.tokens.shape[1] - 1).expand(b, k)
    state.tokens.scatter_(1, cols, torch.where(row_valid, window, pad_id))
    state.valid.scatter_(1, cols, row_valid)
    # the emission s0 + advance of a row that stopped there on a rejected
    # proposal (not on EOS, not at full acceptance) replaces the draft's
    rej_col = (s0 + advance).clamp(max=state.rejected.shape[1] - 1).expand(b, 1)
    rej = live & ~has_eos & (n_consume == advance) & (n_acc < k - 1)
    state.rejected.scatter_(1, rej_col, torch.gather(state.rejected, 1, rej_col) | rej[:, None])

    done = state.done | (has_eos & (first_eos < advance))
    # the next emission: rows whose consumption ends at `advance` take the
    # stop token (greedy: the bonus; sampled: the fresh draw); rows that
    # accepted further continue from their window and run the acceptance
    # again next round (exact, by the memorylessness of rejection sampling)
    cur_window = torch.gather(window, 1, advance.clamp(max=k - 1).expand(b, 1))[:, 0]
    cur = torch.where(n_consume == advance, stop_tok, cur_window)
    cur = torch.where(done, pad_id, cur)
    accepted = state.accepted + torch.where(live, (advance - 1).clamp_min(0), 0).sum()
    return state._replace(cur_token=cur, step=s0 + advance, done=done, accepted=accepted,
                          rounds=state.rounds + (~finished).long())


def speculative_unit(
    params, draft_params, cfg: QwenConfig, draft_cfg: QwenConfig, batch: int, cache_len: int,
    cache_dtype, device: torch.device, t_pad: int, max_new: int, k: int, top_k: int,
    greedy: bool, vocab_slice, extra_ids: Tuple[int, ...], eos_ids: Tuple[int, ...],
    pad_id: int, units: Optional[graphs.UnitCache] = None,
) -> graphs.DecodeUnit:
    """The unit of `ROUNDS_PER_UNIT` speculative rounds for these static arguments
    (the JAX static argnames, both trees' identities, the caches' shape),
    over buffers of its own, kept in `units` (default `graphs.SHARED`).  A
    replay's `out` holds (B, 2) int32: the step, then each row's done flag.
    Its inputs `temperature` and `top_p` are () fp32."""
    key = ("speculative", cfg, draft_cfg, id(params), id(draft_params), batch, cache_len,
           cache_dtype, device, t_pad, max_new, k, top_k, greedy, vocab_slice, extra_ids,
           eos_ids, pad_id)

    def build() -> graphs.DecodeUnit:
        width = max_new + k + 1

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        state = SpecState(
            init_kv_cache(cfg, batch, cache_len, cache_dtype, device),
            init_kv_cache(draft_cfg, batch, cache_len, cache_dtype, device),
            zeros((batch,), torch.long), zeros((), torch.long), zeros((batch,), torch.bool),
            zeros((batch,), torch.int32), zeros((batch,), torch.long), zeros((), torch.long),
            zeros((), torch.long), torch.full((batch, width), pad_id, dtype=torch.long,
                                              device=device),
            zeros((batch, width), torch.bool), zeros((batch, width), torch.bool),
        )
        inputs = {name: torch.full((), value, dtype=torch.float32, device=device)
                  for name, value in (("temperature", 0.8), ("top_p", 0.95))}

        def make_scan(generator):
            def scan(s):
                for _ in range(ROUNDS_PER_UNIT):
                    s = speculative_round(params, draft_params, cfg, draft_cfg, s, t_pad, k,
                                          max_new, generator, inputs["temperature"], top_k,
                                          inputs["top_p"], greedy, eos_ids, pad_id,
                                          vocab_slice, extra_ids)
                return s, s.step.expand(batch)[:, None], s.done[:, None]
            return scan

        return graphs.DecodeUnit(make_scan, state, ROUNDS_PER_UNIT, inputs,
                                 name=f"speculative B={batch} t_pad={t_pad} S={cache_len} k={k} "
                                 f"draft={draft_cfg.num_hidden_layers} rounds={ROUNDS_PER_UNIT}"
                                 + (" greedy" if greedy else ""), out_width=2)

    return graphs.unit(key, device, build, units)


@torch.inference_mode()
def speculative_decode(
    params, draft_params, cfg: QwenConfig, draft_cfg: QwenConfig,
    input_ids: torch.Tensor, prompt_mask: torch.Tensor, generator: Optional[torch.Generator],
    max_new_tokens: int, cache_len: int, k: int = 4, temperature: float = 0.8, top_k: int = 50,
    top_p: float = 0.95, greedy: bool = False, eos_ids: Tuple[int, ...] = (), pad_id: int = 0,
    vocab_slice: Tuple[int, int] | None = None, extra_ids: Tuple[int, ...] = (),
    cache_dtype=torch.bfloat16, units: Optional[graphs.UnitCache] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both modes of `speculative_generate(_greedy)`, which return its first
    three results; the fourth is the number of rounds that advanced (()
    int64): with `accepted`, what each round accepted; the fifth, (B,
    max_new) bool, marks the emissions where a round stopped on a rejected
    proposal (the target's token stands there).  `generator` may be None
    when greedy."""
    if tp_of(params) is not None:
        raise ValueError("speculative decoding does not run on a tensor-parallel shard")
    b, t_pad = input_ids.shape
    if cache_len < t_pad + max_new_tokens + k:
        raise ValueError(f"cache_len {cache_len} < {t_pad} + {max_new_tokens} + k={k}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    dev = input_ids.device
    extra_ids, eos_ids = tuple(extra_ids), tuple(eos_ids)
    unit = speculative_unit(params, draft_params, cfg, draft_cfg, b, aligned_cache_len(cache_len),
                            cache_dtype, dev, t_pad, max_new_tokens, k, top_k, greedy,
                            vocab_slice, extra_ids, eos_ids, pad_id, units=units)
    if generator is None:  # greedy: the unit's generator is never drawn from
        generator = torch.Generator(device=dev)
    with unit.lock:
        mine = unit.state
        # prefill both models over the prompt; the first token is the target's
        tgt = prefill(params, cfg, input_ids, prompt_mask, mine.tgt_cache, generator,
                      temperature, top_k, top_p, greedy, vocab_slice, extra_ids)
        prefill(draft_params, draft_cfg, input_ids, prompt_mask, mine.drf_cache, generator,
                temperature, top_k, top_p, True, vocab_slice, extra_ids)
        zero = torch.zeros((), dtype=torch.long, device=dev)
        state = SpecState(mine.tgt_cache, mine.drf_cache, tgt.cur_token, zero,
                          torch.zeros((b,), dtype=torch.bool, device=dev), tgt.start,
                          tgt.prompt_len, zero.clone(), zero.clone(),
                          torch.full_like(mine.tokens, pad_id), torch.zeros_like(mine.valid),
                          torch.zeros_like(mine.rejected))
        with unit.bound(state, generator):
            unit.inputs["temperature"].fill_(temperature)
            unit.inputs["top_p"].fill_(top_p)
            # every live round advances at least one token
            for _ in range(math.ceil(max_new_tokens / unit.steps)):
                flags = unit.replay().cpu()
                if int(flags[0, 0]) >= max_new_tokens or bool(flags[:, 1].all()):
                    break
            tokens = unit.state.tokens[:, :max_new_tokens].clone()
            valid = unit.state.valid[:, :max_new_tokens].clone()
            accepted, rounds = unit.state.accepted.clone(), unit.state.rounds.clone()
            rejected = unit.state.rejected[:, :max_new_tokens] & valid
    return torch.where(valid, tokens, pad_id), valid.sum(dim=1), accepted, rounds, rejected


def speculative_generate_greedy(
    params,
    draft_params,
    cfg: QwenConfig,
    draft_cfg: QwenConfig,
    input_ids: torch.Tensor,    # (B, T_pad) int64, left-padded
    prompt_mask: torch.Tensor,  # (B, T_pad) bool
    max_new_tokens: int,
    cache_len: int,
    k: int = 4,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
    cache_dtype=torch.bfloat16,
    units: Optional[graphs.UnitCache] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy speculative decode.  Returns (tokens (B, max_new) int64,
    lengths (B,), accepted () int64, on the device); the ids are the
    target's vanilla greedy `generate`'s.  `units`: the cache that owns the
    unit (`speculative_unit`)."""
    return speculative_decode(params, draft_params, cfg, draft_cfg, input_ids, prompt_mask, None,
                              max_new_tokens, cache_len, k, 1.0, 1, 1.0, True, eos_ids, pad_id,
                              vocab_slice, extra_ids, cache_dtype, units)[:3]


def speculative_generate(
    params,
    draft_params,
    cfg: QwenConfig,
    draft_cfg: QwenConfig,
    input_ids: torch.Tensor,    # (B, T_pad) int64, left-padded
    prompt_mask: torch.Tensor,  # (B, T_pad) bool
    generator: torch.Generator,
    max_new_tokens: int,
    cache_len: int,
    k: int = 4,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
    cache_dtype=torch.bfloat16,
    units: Optional[graphs.UnitCache] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampled speculative decode (Leviathan-style modified rejection
    sampling over the warped distributions, the temperature, top-k, top-p
    chain both models sample from): a drafted x is kept with probability
    min(1, q(x) / p(x)); on a rejection the emission is drawn from
    norm(max(q - p, 0)); on full acceptance the bonus comes from the
    target's last distribution.  The output distribution is vanilla
    sampled `generate`'s.  Draws come from `generator` (updated in place).
    Returns (tokens (B, max_new) int64, lengths (B,), accepted () int64)."""
    return speculative_decode(params, draft_params, cfg, draft_cfg, input_ids, prompt_mask,
                              generator, max_new_tokens, cache_len, k, temperature, top_k, top_p,
                              False, eos_ids, pad_id, vocab_slice, extra_ids, cache_dtype,
                              units)[:3]
