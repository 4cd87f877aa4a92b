"""Autoregressive generation: prefill, then decode in captured units.

Port of `sparktts_tpu/lm/generate.py`.  JAX runs the decode loop as one XLA
program: `generate`'s `_decode_all` (a `while_loop` that exits as soon as
every row has emitted EOS) and `decode_chunk`'s `lax.scan` of n steps.  The
port runs `DecodeUnit`s (`lm/graphs.py`): U decode steps captured as one
CUDA graph over the unit's own state buffers on the card, replayed n / U
times; on the CPU the same steps run eagerly.  Prefill stays one eager
forward (through the flash kernel module).

The state is updated in place, which plays the part of JAX's donation:
`step` is a device tensor, each step writes its K/V at slot `t_pad + step`
of the cache through the (B,) write path, and a replay leaves its state in
the unit's buffers for the next one.  `generate` reads whether every row is
done after each unit of `DONE_CHECK_EVERY` steps.  A row that is done emits
`pad_id` with `valid=False`, so checking late changes no output: it only
runs up to `DONE_CHECK_EVERY - 1` steps whose tokens are discarded, where a
check at every step would stall the host on the device once per token.
Steps past the budget (the last unit's tail) write the cache's last slot,
which no kept token reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.qwen import (
    KVCache,
    aligned_cache_len,
    init_kv_cache,
    prefill_positions,
    qwen_forward,
)
from sparktts_tpu_torch.lm.sample import Generators, PerRow, greedy_token, sample_token
from sparktts_tpu_torch.parallel.mesh import capturable

DONE_CHECK_EVERY = 8


class GenState(NamedTuple):
    """Decode-loop state, all on the device."""

    cache: KVCache
    cur_token: torch.Tensor   # (B,) int64, last sampled token
    step: torch.Tensor        # () int32, tokens generated so far
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
    step = torch.zeros((), dtype=torch.int32, device=input_ids.device)
    return GenState(cache, tok, step, done, start, prompt_len)


def decode_step(
    params,
    cfg: QwenConfig,
    state: GenState,
    t_pad: int,
    generator: Generators,
    temperature: PerRow,
    top_k: int,
    top_p: PerRow,
    eos_ids: Sequence[int],
    pad_id: int,
    greedy: bool = False,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
) -> GenState:
    """Feed state.cur_token, sample the next.  Its K/V land at cache slot
    t_pad + step (clamped to the cache: only steps past the budget reach
    it), and keys are valid in the window [start, t_pad + step] (the decode
    kernel's index compare).  No host int depends on the step."""
    b, s_len = state.cur_token.shape[0], state.cache.k.shape[2]
    pos = (state.step + t_pad).clamp(max=s_len - 1).to(torch.int32).expand(b).contiguous()
    positions = (state.prompt_len + state.step)[:, None]
    logits, cache = qwen_forward(
        params, cfg, state.cur_token[:, None], positions, state.cache, pos, None,
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


def _decode_scan(params, cfg, state, t_pad, n_steps, generator, temperature, top_k, top_p,
                 eos_ids, pad_id, greedy, vocab_slice=None, extra_ids=()):
    """n_steps eager decode steps; returns (state, tokens (B, n), valid (B,
    n) bool).  `valid` is the explicit emission mask: callers must not infer
    liveness from token values (pad_id may be a legitimately sampled id)."""
    toks, valid = [], []
    for _ in range(n_steps):
        toks.append(state.cur_token)
        valid.append(~state.done)
        state = decode_step(params, cfg, state, t_pad, generator, temperature, top_k, top_p,
                            eos_ids, pad_id, greedy, vocab_slice, extra_ids)
    return state, torch.stack(toks, 1), torch.stack(valid, 1)


def decode_unit(
    params,
    cfg: QwenConfig,
    batch: int,
    cache_len: int,
    cache_dtype,
    device: torch.device,
    t_pad: int,
    steps: int,
    top_k: int,
    greedy: bool,
    vocab_slice: Tuple[int, int] | None,
    extra_ids: Tuple[int, ...],
    eos_ids: Tuple[int, ...],
    pad_id: int,
    n_generators: int = 1,
    units: Optional[graphs.UnitCache] = None,
) -> graphs.DecodeUnit:
    """The decode unit of `steps` steps for these static arguments (JAX's
    static argnames of `decode_chunk`, the params' identity, the cache's
    shape, one generator or one per row), over buffers of its own; shared
    by `generate` and `decode_chunk`, kept in `units` (the owner's cache:
    a pipeline's; default `graphs.SHARED`).  Its inputs `temperature` and
    `top_p` are () fp32."""
    key = ("decode", cfg, id(params), batch, cache_len, cache_dtype, device, t_pad, steps, top_k,
           greedy, vocab_slice, extra_ids, eos_ids, pad_id, n_generators)

    def build() -> graphs.DecodeUnit:
        state = GenState(
            init_kv_cache(cfg, batch, cache_len, cache_dtype, device),
            torch.zeros((batch,), dtype=torch.long, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.bool, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.long, device=device),
        )
        inputs = {name: torch.full((), value, dtype=torch.float32, device=device)
                  for name, value in (("temperature", 0.8), ("top_p", 0.95))}

        def make_scan(generator):
            def scan(s):
                return _decode_scan(params, cfg, s, t_pad, steps, generator,
                                    inputs["temperature"], top_k, inputs["top_p"], eos_ids,
                                    pad_id, greedy, vocab_slice, extra_ids)
            return scan

        return graphs.DecodeUnit(make_scan, state, steps, inputs,
                                 name=f"decode B={batch} t_pad={t_pad} S={cache_len} U={steps}"
                                 + (" greedy" if greedy else "")
                                 + (" per-row generators" if n_generators > 1 else ""),
                                 n_generators=n_generators, capture=capturable(params))

    return graphs.unit(key, device, build, units)


def n_generators(generator: Generators) -> int:
    """1 for one generator, else the number of per-row generators."""
    return 1 if isinstance(generator, torch.Generator) else len(generator)


def _fill_sampling(unit: graphs.DecodeUnit, temperature: float, top_p: float) -> None:
    unit.inputs["temperature"].fill_(temperature)
    unit.inputs["top_p"].fill_(top_p)


@torch.inference_mode()
def decode_chunk(
    params,
    cfg: QwenConfig,
    state: GenState,
    t_pad: int,
    n_steps: int,
    generator: Generators,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    greedy: bool = False,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
    unit_steps: Optional[int] = None,
    units: Optional[graphs.UnitCache] = None,
) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
    """Run `n_steps` decode steps and return (state, tokens (B, n_steps),
    valid (B, n_steps) bool), JAX's `decode_chunk` contract.  The state's
    tensors (its cache included) and `generator` are updated in place, which
    plays the part of JAX's donation: chained calls continue one stream.
    The steps run as replays of a decode unit of `unit_steps` steps (default
    n_steps; it must divide n_steps), which has buffers of its own: the state
    is copied into them first and back after.  `units`: the cache that owns
    the unit (`decode_unit`)."""
    unit_steps = unit_steps or n_steps
    b, s_len = state.cur_token.shape[0], state.cache.k.shape[2]
    unit = decode_unit(params, cfg, b, s_len, state.cache.k.dtype, state.cur_token.device, t_pad,
                       unit_steps, top_k, greedy, vocab_slice, tuple(extra_ids), tuple(eos_ids),
                       pad_id, n_generators(generator), units)
    with unit.bound(state, generator):
        _fill_sampling(unit, temperature, top_p)
        tokens, valid = unit.run(n_steps)
    return state, tokens, valid


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
    units: Optional[graphs.UnitCache] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_new_tokens) int64 padded with pad_id after
    EOS, lengths (B,) including the EOS token).  Emission validity is the
    explicit `valid` mask, never inferred from token values (pad_id may be a
    legal sampled id).  `generator` is one generator for the batch, or a
    list of one per row (per-row seeds: a row's draws then depend on its
    own generator alone).  The prompt is prefilled into the cache of the
    decode unit of `DONE_CHECK_EVERY` steps, which then replays until every
    row is done or the budget is spent; the unit is held for the whole call,
    so calls that share it from several threads run one after another.
    `units`: the cache that owns the unit (`decode_unit`)."""
    b, t_pad = input_ids.shape
    if cache_len < t_pad + max_new_tokens:
        raise ValueError(f"cache_len {cache_len} < {t_pad} + {max_new_tokens}")
    unit = decode_unit(params, cfg, b, aligned_cache_len(cache_len), cache_dtype,
                       input_ids.device, t_pad, DONE_CHECK_EVERY, top_k, greedy, vocab_slice,
                       tuple(extra_ids), tuple(eos_ids), pad_id, n_generators(generator), units)
    outs = []
    with unit.lock:
        state = prefill(
            params, cfg, input_ids, prompt_mask, unit.state.cache, generator, temperature, top_k,
            top_p, greedy, vocab_slice=vocab_slice, extra_ids=extra_ids,
        )
        with unit.bound(state, generator):
            _fill_sampling(unit, temperature, top_p)
            while len(outs) * unit.steps < max_new_tokens:
                outs.append(unit.replay().clone())
                if bool(unit.state.done.all()):
                    break
    toks, valid = graphs.unpack(outs, unit.steps)
    tokens = torch.full((b, max_new_tokens), pad_id, dtype=torch.long, device=input_ids.device)
    n = min(toks.shape[1], max_new_tokens)
    tokens[:, :n] = toks[:, :n]
    return tokens, valid[:, :n].sum(dim=1)
