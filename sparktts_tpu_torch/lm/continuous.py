"""Continuous (inflight) batching engine for the speech LM, over a dense KV
cache.

Port of `sparktts_tpu/lm/continuous.py`: the half shared with the paged
engine (`lm/paged.py`) and the dense engine's core.  A fixed pool of
`max_slots` slots shares one stacked `(L, B, S, n_kv, hd)` cache.  Every slot
has its own cache write position, RoPE position, budget limit, done flag,
guided mode and sampling parameters, all (B,) tensors on the device.
`submit` prefills one right-padded prompt and installs it in a free slot;
running slots are untouched.  `step` advances every live slot by up to
n_steps tokens; a slot stops on the device at its budget limit, so a step
larger than the tightest budget is safe.

Where the port differs from the JAX engine:

  * A dispatch of n_steps runs as n_steps / U replays of a decode unit
    (`lm/graphs.py`, `dispatch_steps`): U steps captured as one CUDA graph
    over the engine's own slot buffers on the card, run eagerly on the CPU,
    where JAX runs one jitted scan.  The host reads nothing until the
    step's fetch: `chain_step_result` starts a non_blocking copy of the packed
    result into pinned host memory and records a CUDA event, and
    `step_fetch` waits on that event.  Host values go to the card through
    pinned memory without blocking (`to_device`), so `submit` and
    `step_begin` never wait for the card.
  * The state is written in place (JAX donates it to each program): the
    KV cache by every step, the per-slot vectors at admission and release
    and by the last step of each unit, which copies its results back into
    the buffers the graph binds.  So `self.slots` keeps its tensors, at
    their addresses, for the life of the engine.
  * One engine `torch.Generator`, seeded with `seed`, takes the place of the
    carried rng key.  Each sampled admission prefill and each sampled
    decode step draws once, so a token stream does not depend on how steps
    are split into dispatches (a unit draws from its own generator, set to
    the engine's before a dispatch and copied back after it).  `jax.random`
    and torch draw different numbers: sampled tokens agree with JAX in
    distribution, greedy ids exactly.
  * A slot that finished but is still active keeps write_pos == limit,
    which may equal the cache length.  JAX drops that write; here it is
    clamped to the row's last cache slot, which the next admission
    rewrites before anything reads it.
  * The engine state is built and changed under `torch.inference_mode()`.

  * Admission is eager PyTorch with no host read, as the JAX engine's
    admission programs are one dispatch each: a clone request admits from
    its prompt wav (`submit_fused`) or from the voice cache's device ids
    (`submit_assembled`), alone or as a burst of one shape signature
    (`submit_*_batch`, one `prefill_many`).  In place of JAX's executable
    cache, a signature is ready once it has run on scratch slot state
    (`warm_*`); the registry of ready signatures is shared by the engines
    of one process.  The decode units of every dispatch size are captured
    by `warm_units`, so a server captures none while it serves; they are
    the engine's own (`graphs.UnitCache`) and go with it, or at `close`.
  * Over a tensor-parallel row (`mesh=`, the params a `ShardedTree` of the
    row, `cfg` its shard's config: `pipeline.shard_llm`), each rank keeps
    its own KV heads and the slot vectors whole.  Every admission is then
    one prefill of host prompt ids (`_admit_rows`; a fused clone admission
    tokenizes and assembles on the codec's rank and reads the ids back), so
    that the row's other ranks can make it too: on a leading row each LM
    call of the engine (`_admit_rows`, `_decode`, `release_slot`,
    `_commit_slot_done`, `close`) is announced to the followers first, and
    the ranks' results and slot vectors are checked to agree after it
    (`parallel/worker.py`).  A signature is ready at once on a mesh: its
    first live run builds its plans.  The decode units capture the row's
    all-reduces under NCCL and run eagerly under gloo.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.generate import expand_constrained, packed_allowed_mask
from sparktts_tpu_torch.lm.qwen import KVCache, init_kv_cache, qwen_forward
from sparktts_tpu_torch.lm.sample import NEG_INF, greedy_token, sample_token
from sparktts_tpu_torch.parallel.mesh import capturable, tp_of
from sparktts_tpu_torch.parallel.worker import mirrored
from sparktts_tpu_torch.utils.platform import require_device

#: Fixed decode dispatch-size menu (the JAX engine compiles one program per
#: rung; kept so both engines dispatch the same step counts).  Budget
#: enforcement lives on the device (SlotState.limit), so a dispatch larger
#: than a slot's remaining budget is safe: the slot just stops early.
DISPATCH_LADDER = (4, 8, 16, 32, 64, 128, 256, 512)

#: Steps per captured engine unit: the smallest rung, so a unit divides every
#: rung (a dispatch of another size takes a unit of gcd(size, this) steps).
ENGINE_UNIT = DISPATCH_LADDER[0]

#: How many steps of overshoot a rung may add: every step of a dispatch runs
#: even after each slot stopped, so rounding far up costs real compute.
LADDER_OVERSHOOT_TOLERANCE = 32

MODES = ("control", "clone")

#: Batch sizes of the batched admissions: a burst snaps up to the next one,
#: padded by repeating its row 0, so each shape signature has four warm-ups.
ADMIT_BATCH_LADDER = (2, 4, 8, 16)

# Process-wide registry of the admission signatures that have run once (see
# `ContinuousBatchingEngine.warm_fused`): keyed by everything that shapes
# the work, so a fresh engine over the same pipeline adopts them.
_ADMIT_WARM: set = set()
_ADMIT_WARM_LOCK = threading.Lock()


def snap_to_ladder(
    requested: int,
    max_dispatch: int,
    overshoot: int = LADDER_OVERSHOOT_TOLERANCE,
) -> int:
    """Ladder rung for a `requested` step count, capped at max_dispatch.
    Rounds up to the next rung only when the overshoot stays within
    `overshoot` steps, else takes the largest rung below.  A non-rung
    `max_dispatch` is itself a rung, so the result is always in
    (DISPATCH_LADDER ∪ {max_dispatch}) ∩ [1, max_dispatch]."""
    if max_dispatch in DISPATCH_LADDER:
        rungs = DISPATCH_LADDER
    else:
        rungs = tuple(sorted(set(DISPATCH_LADDER) | {max_dispatch}))
    below = None
    for v in rungs:
        if v > max_dispatch:
            break
        if v >= requested:
            if v - requested <= overshoot:
                return v
            return below if below is not None else v
        below = v
    return below if below is not None else min(rungs[0], max_dispatch)


class AdmissionDeferred(RuntimeError):
    """Raised by `submit` when a request cannot be admitted now without
    risking resource exhaustion mid-decode (paged engine: the page pool
    cannot cover every admitted request's worst-case growth).  A caller
    treats it as backpressure and retries after slots free."""


class RequestTooLong(ValueError):
    """Raised at admission when prompt + generation budget can never fit the
    engine's per-slot capacity: no amount of waiting helps."""


class SlotState(NamedTuple):
    """Per-slot device tensors (all (B,) unless noted)."""

    cache: KVCache
    cur_token: torch.Tensor    # int64, next token to feed
    write_pos: torch.Tensor    # int32, cache slot where cur_token's K/V will be written
    position: torch.Tensor     # int32, RoPE position of cur_token
    start: torch.Tensor        # int32, first valid cache index (0: prompts are right-padded)
    limit: torch.Tensor        # int32, the slot stops once write_pos reaches it
    active: torch.Tensor       # bool, the slot holds a live sequence
    done: torch.Tensor         # bool, the sequence finished (EOS seen / budget hit)
    control: torch.Tensor      # bool, controllable-mode request (full superset
    #                            constraint); False = clone (semantic ids + EOS)
    temperature: torch.Tensor  # fp32 per-slot sampling temperature
    top_p: torch.Tensor        # fp32 per-slot nucleus threshold


def slot_vectors(max_slots: int, device) -> dict:
    """The per-slot vectors both engines' states start from: every slot
    inactive and done."""
    def full(value, dtype):
        return torch.full((max_slots,), value, dtype=dtype, device=device)

    return dict(
        cur_token=full(0, torch.long),
        write_pos=full(0, torch.int32),
        limit=full(0, torch.int32),
        active=full(False, torch.bool),
        done=full(True, torch.bool),
        control=full(True, torch.bool),
        temperature=full(0.8, torch.float32),
        top_p=full(0.95, torch.float32),
    )


def init_slots(
    cfg: QwenConfig, max_slots: int, cache_len: int, cache_dtype=torch.bfloat16, device="cuda",
) -> SlotState:
    return SlotState(
        cache=init_kv_cache(cfg, max_slots, cache_len, cache_dtype, device),
        position=torch.zeros((max_slots,), dtype=torch.int32, device=device),
        start=torch.zeros((max_slots,), dtype=torch.int32, device=device),
        **slot_vectors(max_slots, device),
    )


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`.  On a card the copy goes
    through pinned memory and does not block: a plain host-to-card copy
    would wait for every kernel already queued."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _mode_masked(
    logits: torch.Tensor, control: torch.Tensor, allowed: Optional[torch.Tensor]
) -> torch.Tensor:
    """Narrow packed guided logits (B, W) to `allowed` (W,) for rows whose
    `control` (B,) is False (clone slots).  No-op without a mask."""
    if allowed is None:
        return logits
    return torch.where(control[:, None] | allowed[None, :], logits, NEG_INF)


_NP_DTYPES = {torch.int64: np.int64, torch.int32: np.int32, torch.float32: np.float32,
              torch.bool: np.bool_}


def _rows(values, dtype, device) -> torch.Tensor:
    """A per-row host sequence (or a tensor) as a (B,) tensor on `device`."""
    if isinstance(values, torch.Tensor):
        return values.to(device, dtype)
    return to_device(np.asarray(values, _NP_DTYPES[dtype]), device)


def prefill_many(
    params,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # (B, t_pad) int64, right-padded
    prompt_lens,              # (B,) true lengths
    generator: torch.Generator,
    cache_dtype,
    temperature,              # (B,) fp32
    top_k: int,
    top_p,                    # (B,) fp32
    greedy: bool,
    vocab_slice: Optional[Tuple[int, int]],
    extra_ids: Tuple[int, ...],
    control,                  # (B,) bool
    allowed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Admission prefill of B right-padded prompts in one forward: each row
    through the model with a causal + pad bias (dense attention, not the
    flash kernel: the prompts are right-padded), then each row's first new
    token from its last prompt position, sampled with its own temperature and
    top_p and narrowed to the clone set where its `control` is False.  The
    per-row arguments are host sequences or device tensors; nothing is read
    back to the host.  Returns (first tokens (B,) int64, the prompts' KV cache
    (L, B, t_pad, n_kv, hd))."""
    b, t_pad = input_ids.shape
    dev = input_ids.device
    lens = _rows(prompt_lens, torch.int64, dev)
    idx = torch.arange(t_pad, device=dev)
    tmp_cache = init_kv_cache(cfg, b, t_pad, cache_dtype, dev)
    positions = torch.minimum(idx[None, :], lens[:, None] - 1)
    keep = (idx[None, None, :] <= idx[None, :, None]) & (idx[None, None, :] < lens[:, None, None])
    bias = torch.where(keep, 0.0, NEG_INF).float()  # (B, q, k)
    logits, tmp_cache = qwen_forward(
        params, cfg, input_ids, positions, tmp_cache, 0, bias,
        vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    last = logits[torch.arange(b, device=dev), (lens - 1).clamp_min(0)]
    last = _mode_masked(last, _rows(control, torch.bool, dev), allowed)
    if greedy:
        first = greedy_token(last)
    else:
        first = sample_token(generator, last, _rows(temperature, torch.float32, dev)[:, None],
                             top_k, _rows(top_p, torch.float32, dev)[:, None])
    return expand_constrained(first, vocab_slice, extra_ids), tmp_cache


def prefill_one(
    params,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # (1, t_pad) int64, right-padded
    prompt_len: int,
    generator: torch.Generator,
    cache_dtype,
    temperature: float,
    top_k: int,
    top_p: float,
    greedy: bool,
    vocab_slice: Optional[Tuple[int, int]],
    extra_ids: Tuple[int, ...],
    control: bool = True,
    allowed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Shared single-prompt admission prefill (dense and paged engines):
    `prefill_many` at B = 1.  Returns (first token (1,) int64, the prompt's
    KV cache (L, 1, t_pad, n_kv, hd))."""
    return prefill_many(params, cfg, input_ids, [prompt_len], generator, cache_dtype,
                        [temperature], top_k, [top_p], greedy, vocab_slice, extra_ids,
                        [control], allowed)


def install_slot(slots, slot: int, first_tok: torch.Tensor, prompt_len: int, limit: int,
                 control: bool, temperature: float, top_p: float) -> None:
    """Write an admitted request's per-slot vectors in place (both engines;
    the KV of its prompt is the caller's)."""
    slots.cur_token[slot] = first_tok[0]
    slots.write_pos[slot] = prompt_len
    slots.limit[slot] = limit
    slots.active[slot] = True
    slots.done[slot] = False
    slots.control[slot] = control
    slots.temperature[slot] = temperature
    slots.top_p[slot] = top_p


def admit_prefill(
    params,
    slots: SlotState,
    cfg: QwenConfig,
    slot: int,
    input_ids: torch.Tensor,  # (1, t_pad) right-padded prompt
    prompt_len: int,
    generator: torch.Generator,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    limit: Optional[int] = None,  # cache index decode must stop at
    control: bool = True,
    allowed: Optional[torch.Tensor] = None,
) -> SlotState:
    """Prefill one prompt and install it into `slot`, in place; returns
    `slots`.  The sequence occupies cache [0, prompt_len) and decode
    continues at prompt_len.  Cache slots past it are never read before a
    decode step writes them."""
    first_tok, tmp_cache = prefill_one(
        params, cfg, input_ids, prompt_len, generator, slots.cache.k.dtype,
        temperature, top_k, top_p, greedy, vocab_slice, extra_ids, control, allowed,
    )
    t_pad = input_ids.shape[1]
    slots.cache.k[:, slot, :t_pad] = tmp_cache.k[:, 0]
    slots.cache.v[:, slot, :t_pad] = tmp_cache.v[:, 0]
    install_slot(slots, slot, first_tok, prompt_len,
                 slots.cache.k.shape[2] if limit is None else limit,
                 control, temperature, top_p)
    slots.position[slot] = prompt_len
    slots.start[slot] = 0
    return slots


def install_rows(slots: SlotState, slot_ids, first_toks: torch.Tensor, tmp_cache: KVCache,
                 prompt_lens, limits, temperature, top_p, control=None) -> SlotState:
    """Install the first n = len(slot_ids) rows of a batched admission
    prefill into their slots, in place: each row's prompt K/V into its
    slot's cache row, its per-slot vectors by slot id (`control` per row,
    default clone mode).  Rows past
    n (the ladder's pad rows) are dropped, so no slot is written twice and
    the result does not depend on the order of the writes."""
    dev = first_toks.device
    n = len(slot_ids)
    sid = _rows(slot_ids, torch.int64, dev)
    t_pad = tmp_cache.k.shape[2]
    slots.cache.k[:, sid, :t_pad] = tmp_cache.k[:, :n]
    slots.cache.v[:, sid, :t_pad] = tmp_cache.v[:, :n]
    lens = _rows(prompt_lens, torch.int32, dev)[:n]
    slots.cur_token[sid] = first_toks[:n]
    slots.write_pos[sid] = lens
    slots.position[sid] = lens
    slots.start[sid] = 0
    slots.limit[sid] = _rows(limits, torch.int32, dev)[:n]
    slots.active[sid] = True
    slots.done[sid] = False
    slots.control[sid] = False if control is None else _rows(control, torch.bool, dev)[:n]
    slots.temperature[sid] = _rows(temperature, torch.float32, dev)[:n]
    slots.top_p[sid] = _rows(top_p, torch.float32, dev)[:n]
    return slots


def admit_prefill_fused(
    params,
    slots: SlotState,
    cfg: QwenConfig,
    slot: int,
    tokenize_fn,               # pipeline._tokenize_fn(pad_len, ref_len)
    tok_args: tuple,           # (w2v params, codec params, wav, feature mask, ref wav), on the device
    assemble_fn,               # pipeline._assemble_fn_batch(t_pad, s_pad)
    scaffold,                  # (1, t_pad) int32 host-built prompt scaffold
    g_off: int,
    s_off: int,
    n_sem: int,                # semantic ids the prompt takes (0 = none)
    prompt_len: int,
    generator: torch.Generator,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    limit: Optional[int] = None,
    allowed: Optional[torch.Tensor] = None,
) -> Tuple[SlotState, torch.Tensor, torch.Tensor]:
    """Clone-mode admission with the audio tokenize and the prompt assembly
    in the same chain of device work: wav -> wav2vec2 -> BiCodec tokenize ->
    scaffold gather -> prefill -> slot install, with no host read between
    them.  Returns (slots, global ids (1, N), semantic ids (1, S_pad)), the
    ids left on the device for the vocoder and the voice cache."""
    global_t, semantic = tokenize_fn(*tok_args)
    ids = assemble_fn(scaffold, global_t, semantic, [g_off], [s_off], [n_sem])
    slots = admit_prefill(params, slots, cfg, slot, ids.long(), prompt_len, generator,
                          temperature, top_k, top_p, greedy, vocab_slice, extra_ids,
                          limit=limit, control=False, allowed=allowed)
    return slots, global_t, semantic


def admit_prefill_assembled(
    params,
    slots: SlotState,
    cfg: QwenConfig,
    slot: int,
    global_t: torch.Tensor,    # (1, N) cached voice ids, on the device
    semantic: torch.Tensor,    # (1, S_pad)
    assemble_fn,
    scaffold,
    g_off: int,
    s_off: int,
    n_sem: int,
    prompt_len: int,
    generator: torch.Generator,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    limit: Optional[int] = None,
    allowed: Optional[torch.Tensor] = None,
) -> SlotState:
    """`admit_prefill_fused` for a voice-cache hit: the codec ids are
    already on the device, so the audio tokenize stack is skipped."""
    ids = assemble_fn(scaffold, global_t, semantic, [g_off], [s_off], [n_sem])
    return admit_prefill(params, slots, cfg, slot, ids.long(), prompt_len, generator,
                         temperature, top_k, top_p, greedy, vocab_slice, extra_ids,
                         limit=limit, control=False, allowed=allowed)


def admit_prefill_assembled_batch(
    params, slots: SlotState, cfg: QwenConfig, slot_ids, global_t: torch.Tensor,
    semantic: torch.Tensor, assemble_fn, scaffolds, g_offs, s_offs, n_sems, prompt_lens,
    generator: torch.Generator, temperature, top_k: int, top_p, limits, greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None, extra_ids: Tuple[int, ...] = (),
    allowed: Optional[torch.Tensor] = None,
) -> SlotState:
    """Batched `admit_prefill_assembled`: a burst of voice-cache-hit clone
    admissions of one (S_pad, t_pad) signature as B assemblies, one (B,
    t_pad) prefill and B slot installs.  The per-row arguments hold B rows
    (the burst padded to the ladder by repeating row 0); `slot_ids` holds
    the real rows' slots only (`install_rows`)."""
    ids = assemble_fn(scaffolds, global_t, semantic, g_offs, s_offs, n_sems)
    first, tmp_cache = prefill_many(params, cfg, ids.long(), prompt_lens, generator,
                                    slots.cache.k.dtype, temperature, top_k, top_p, greedy,
                                    vocab_slice, extra_ids, [False] * ids.shape[0], allowed)
    return install_rows(slots, slot_ids, first, tmp_cache, prompt_lens, limits, temperature,
                        top_p)


def admit_prefill_fused_batch(
    params, slots: SlotState, cfg: QwenConfig, slot_ids, tokenize_fn, tok_args: tuple,
    assemble_fn, scaffolds, g_offs, s_offs, n_sems, prompt_lens, generator: torch.Generator,
    temperature, top_k: int, top_p, limits, greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None, extra_ids: Tuple[int, ...] = (),
    allowed: Optional[torch.Tensor] = None,
) -> Tuple[SlotState, torch.Tensor, torch.Tensor]:
    """Batched `admit_prefill_fused`: a burst of first-time clone admissions
    of one (wav bucket, t_pad) signature as one batched audio tokenize, B
    assemblies, one (B, t_pad) prefill and the slot installs.  `tok_args`
    holds the B rows' wavs, masks and reference clips stacked.  Returns
    (slots, global ids (B, N), semantic ids (B, S_pad)) on the device."""
    global_t, semantic = tokenize_fn(*tok_args)
    ids = assemble_fn(scaffolds, global_t, semantic, g_offs, s_offs, n_sems)
    first, tmp_cache = prefill_many(params, cfg, ids.long(), prompt_lens, generator,
                                    slots.cache.k.dtype, temperature, top_k, top_p, greedy,
                                    vocab_slice, extra_ids, [False] * ids.shape[0], allowed)
    slots = install_rows(slots, slot_ids, first, tmp_cache, prompt_lens, limits, temperature,
                         top_p)
    return slots, global_t, semantic


def pack_step_result(toks: torch.Tensor, valid: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Pack (tokens (B, n), valid (B, n), done (B,)) into one int32 tensor
    (B, 2n+1), so the host fetches the whole step result in one transfer."""
    return torch.cat([toks.int(), valid.int(), done[:, None].int()], dim=1)


def unpack_step_result(packed: np.ndarray, n_steps: int):
    """Host-side inverse of `pack_step_result`."""
    toks = packed[:, :n_steps]
    valid = packed[:, n_steps : 2 * n_steps].astype(bool)
    done = packed[:, 2 * n_steps].astype(bool)
    return toks, valid, done


def chain_step_result(packed: torch.Tensor, chain_fn):
    """Attach an optional chained device computation to a dispatch's packed
    result, flattened into one tensor (`chain_fn(packed)` returns the whole
    flat int32 transfer), and start its copy to the host.  Runs at dispatch
    time, behind the decode steps in the stream.  On a card: a non_blocking
    copy into pinned host memory and a CUDA event recorded after it.
    Returns (host or CPU tensor, event or None)."""
    flat = packed.reshape(-1) if chain_fn is None else chain_fn(packed)
    if flat.device.type != "cuda":
        return flat, None
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(flat.device))
    return host, copied


def fetch_step_result(result, chained: bool, max_slots: int, n_steps: int):
    """Blocking fetch of a `chain_step_result` (the copy was started at
    dispatch time: this waits for its event).  Shared by the dense and
    paged engines.  Returns (toks, valid, done, chained output or None)."""
    flat, copied = result
    if copied is not None:
        copied.synchronize()
    flat = flat.numpy()
    cut = max_slots * (2 * n_steps + 1)
    toks, valid, done = unpack_step_result(flat[:cut].reshape(max_slots, -1), n_steps)
    return toks, valid, done, (flat[cut:] if chained else None)


def advance_slots(
    s,
    logits: torch.Tensor,
    generator: torch.Generator,
    top_k: int,
    greedy: bool,
    vocab_slice: Optional[Tuple[int, int]],
    extra_ids: Tuple[int, ...],
    eos_ids: Tuple[int, ...],
    pad_id: int,
):
    """The sampling and done logic of one decode step, shared by both
    engines (`s` is either engine's state).  `logits` are the step's guided
    logits (B, W), narrowed per mode.  Returns (live (B,) bool: the slots
    that emitted s.cur_token this step, next token, new write_pos, done)."""
    live = s.active & ~s.done
    if greedy:
        nxt = greedy_token(logits)
    else:
        # per-slot sampling parameters: requests keep the temperature and
        # top_p they asked for
        nxt = sample_token(generator, logits, s.temperature[:, None], top_k, s.top_p[:, None])
    nxt = expand_constrained(nxt, vocab_slice, extra_ids)
    is_eos = torch.zeros_like(s.done)
    for e in eos_ids:
        is_eos = is_eos | (s.cur_token == e)
    new_write = torch.where(live, s.write_pos + 1, s.write_pos)
    done = s.done | (is_eos & s.active) | (s.active & (new_write >= s.limit))
    nxt = torch.where(live & ~done, nxt, pad_id)
    return live, nxt, new_write, done


def dense_step_logits(
    params,
    cfg: QwenConfig,
    s: SlotState,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    allowed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step's forward over the dense cache: feeds s.cur_token,
    writes each row's K/V at its write_pos in place, and returns the step's
    guided logits (B, W) narrowed per mode.  Keys [start, write_pos] are
    attended through the decode kernel module."""
    # a finished slot may sit at write_pos == limit == cache length
    pos = s.write_pos.clamp(max=s.cache.k.shape[2] - 1)
    logits, _ = qwen_forward(
        params, cfg, s.cur_token[:, None], s.position[:, None], s.cache, pos, None,
        decode_window=(s.start, pos), vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    return _mode_masked(logits[:, -1], s.control, allowed)


def scan_steps(n_steps: int, slots, step_fn):
    """Run `step_fn(slots) -> (slots, emitted, live)` n_steps times; returns
    (slots, emitted (B, n), live (B, n)): a decode unit's scan."""
    toks, valid = [], []
    for _ in range(n_steps):
        slots, emitted, live = step_fn(slots)
        toks.append(emitted)
        valid.append(live)
    return slots, torch.stack(toks, 1), torch.stack(valid, 1)


def decode_unit(kind: str, params, slots, n_steps: int,
                make_step: Callable[[torch.Generator], Callable], static: Tuple,
                units: Optional[graphs.UnitCache] = None) -> graphs.DecodeUnit:
    """The decode unit a dispatch of n_steps replays: bound to the engine's
    own slot buffers (its key holds their addresses, the params' identity
    and the `static` arguments), captured on the card at first use and kept
    in `units` (the engine's cache).  `make_step(generator)` gives the
    engine's one-step function."""
    steps = math.gcd(n_steps, ENGINE_UNIT)
    bufs = graphs.tensors(slots)
    key = (kind, id(params), steps, static, tuple(t.data_ptr() for t in bufs))

    def build() -> graphs.DecodeUnit:
        def make_scan(gen):
            step = make_step(gen)
            return lambda s: scan_steps(steps, s, step)

        return graphs.DecodeUnit(make_scan, slots, steps,
                                 name=f"{kind} B={slots.cur_token.shape[0]} U={steps}",
                                 capture=capturable(params))

    return graphs.unit(key, bufs[0].device, build, units)


def dispatch_steps(kind: str, params, slots, n_steps: int, generator: torch.Generator,
                   make_step: Callable[[torch.Generator], Callable], static: Tuple,
                   units: Optional[graphs.UnitCache] = None) -> Tuple[object, torch.Tensor]:
    """n_steps decode steps of either engine as replays of its decode unit
    (`decode_unit`); returns (slots, packed (B, 2n+1) int32, see
    `pack_step_result`)."""
    unit = decode_unit(kind, params, slots, n_steps, make_step, static, units)
    with unit.bound(slots, generator):
        toks, valid = unit.run(n_steps)
    return slots, pack_step_result(toks, valid, slots.done)


def decode_steps(
    params,
    slots: SlotState,
    cfg: QwenConfig,
    n_steps: int,
    generator: torch.Generator,
    top_k: int = 50,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    allowed: Optional[torch.Tensor] = None,
    capture_only: bool = False,
    units: Optional[graphs.UnitCache] = None,
) -> Tuple[SlotState, Optional[torch.Tensor]]:
    """Advance every active slot by up to n_steps tokens; returns (slots,
    packed (B, 2n+1) int32, see `pack_step_result`).  The validity half of
    the pack is the explicit liveness mask: pad_id may be a legitimately
    sampled id.  A slot whose write_pos reaches its limit stops on the
    device.  `allowed` narrows clone slots (`packed_allowed_mask`).  The
    slots are updated in place (`dispatch_steps`).  `capture_only`: capture
    the dispatch's decode unit and run nothing; returns (slots, None).
    `units`: the engine's cache of decode units."""

    def make_step(gen: torch.Generator):
        def step(s: SlotState):
            logits = dense_step_logits(params, cfg, s, vocab_slice, extra_ids, allowed)
            live, nxt, new_write, done = advance_slots(
                s, logits, gen, top_k, greedy, vocab_slice, extra_ids, eos_ids, pad_id
            )
            new_s = s._replace(
                cur_token=nxt, write_pos=new_write, done=done,
                position=torch.where(live, s.position + 1, s.position),
            )
            return new_s, s.cur_token, live
        return step

    static = (cfg, top_k, eos_ids, pad_id, greedy, vocab_slice, extra_ids,
              None if allowed is None else allowed.data_ptr())
    kind = "dense engine, greedy" if greedy else "dense engine"
    if capture_only:
        decode_unit(kind, params, slots, n_steps, make_step, static, units)
        return slots, None
    return dispatch_steps(kind, params, slots, n_steps, generator, make_step, static, units)


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def engine_device(params, device) -> torch.device:
    """The engine's device: the card unless the caller asks for the CPU.
    Raises without a card, and if the params lie elsewhere."""
    dev = require_device(device, "continuous engine")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    for t in _leaves(params):
        if t.device != dev:
            raise ValueError(f"continuous engine: params lie on {t.device}, the engine on {dev}")
    return dev


class StepProtocolMixin:
    """The engine-independent half of the three-phase step protocol and the
    request bookkeeping, shared by the dense and paged engines (the engines
    supply `step_begin` and `_commit_slot_done`).

    Contract: `step_begin(n_steps, chain_fn)` enqueues one decode dispatch
    and returns an opaque handle `(result, chain_fn, n_steps,
    owner_snapshot)`, or None when no slot is live; `step_fetch(handle)` is
    the only blocking phase (it waits for the host copy and touches no
    engine state); `step_commit(handle, fetched)` does the host bookkeeping
    against the begin-time slot snapshot."""

    def _init_engine(self, params, cfg: QwenConfig, device, max_slots: int, prompt_pad: int,
                     eos_ids, pad_id: int, sampling: Tuple[float, int, float], greedy: bool,
                     seed: int, vocab_slice, extra_ids, clone_slice, clone_extras,
                     max_dispatch: int) -> None:
        """The settings, generator, clone mask and request bookkeeping both
        engines start from."""
        self.device = engine_device(params, device)
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.prompt_pad = prompt_pad
        self.eos_ids = tuple(eos_ids)
        self.pad_id = pad_id
        self.sampling = sampling  # (temperature, top_k, top_p) defaults
        self.greedy = greedy
        self.vocab_slice = vocab_slice
        self.extra_ids = tuple(extra_ids)
        self.max_dispatch = max_dispatch
        self.clone_slice = clone_slice
        self.clone_extras = tuple(clone_extras)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the engine's decode units: they go with the engine, or at `close`
        self.units = graphs.UnitCache(type(self).__name__)
        with torch.inference_mode():
            self.clone_allowed = (
                None if vocab_slice is None or clone_slice is None
                else packed_allowed_mask(vocab_slice, self.extra_ids, clone_slice,
                                         tuple(clone_extras), self.device)
            )
        self.owner: List[Optional[int]] = [None] * max_slots  # request ids
        self.budget = np.zeros(max_slots, np.int64)  # remaining tokens per slot
        self.buffers: Dict[int, List[int]] = {}
        self.finished: Dict[int, np.ndarray] = {}
        self._next_req = 0

    def free_slots(self) -> int:
        return sum(1 for o in self.owner if o is None)

    @torch.inference_mode()
    def warm_units(self) -> None:
        """Capture now the decode unit of every dispatch size the ladder can
        give (on a card; the CPU caches nothing), so that no live dispatch
        waits on a capture.  Runs no step."""
        rungs = {r for r in DISPATCH_LADDER if r <= self.max_dispatch} | {self.max_dispatch}
        for steps in sorted({math.gcd(r, ENGINE_UNIT) for r in rungs}):
            self._decode(steps, capture_only=True)

    def close(self) -> None:
        """Evict the engine's decode units (with the graph pools they hold),
        after their last replays have ended.  The engine stays usable: a
        later dispatch captures its unit again."""
        self.units.clear()

    def _decode(self, n_steps: int, capture_only: bool = False) -> Optional[torch.Tensor]:
        """Engine hook: dispatch n_steps decode steps over the engine's
        state; returns the packed step result (None with capture_only)."""
        raise NotImplementedError

    def _free_slot(self) -> int:
        slot = next((i for i, o in enumerate(self.owner) if o is None), None)
        if slot is None:
            raise RuntimeError("no free slot")
        return slot

    def _prompt_shape(self, prompt_ids, prompt_len: Optional[int], bucket: int) -> Tuple[int, int]:
        """(true length, padded length) of a host id list, or of a device
        tensor (1, t_pad) already right-padded with `prompt_len` given."""
        if isinstance(prompt_ids, torch.Tensor):
            if prompt_ids.dim() != 2 or prompt_ids.shape[0] != 1 or prompt_len is None:
                raise ValueError("a prompt tensor must be (1, t_pad), with prompt_len")
            if prompt_ids.device != self.device:
                raise ValueError(f"prompt on {prompt_ids.device}, the engine on {self.device}")
            n, t_pad = int(prompt_len), prompt_ids.shape[1]
            if t_pad % bucket:
                raise ValueError(f"prompt width {t_pad} is not a multiple of {bucket}")
        else:
            n = len(prompt_ids)
            t_pad = -(-n // bucket) * bucket
        if not 0 < n <= t_pad:
            raise ValueError(f"prompt length {n} outside [1, {t_pad}]")
        return n, t_pad

    def _prompt_array(self, prompt_ids, n: int, t_pad: int) -> np.ndarray:
        """A host id list as a (1, t_pad) right-padded host array."""
        ids = np.full((1, t_pad), self.pad_id, np.int64)
        ids[0, :n] = prompt_ids
        return ids

    def _prompt_tensor(self, prompt_ids, n: int, t_pad: int) -> torch.Tensor:
        if isinstance(prompt_ids, torch.Tensor):
            return prompt_ids.long()
        return to_device(self._prompt_array(prompt_ids, n, t_pad), self.device)

    def _resolve_sampling(self, temperature, top_p):
        eng_temperature, top_k, eng_top_p = self.sampling
        return (
            eng_temperature if temperature is None else temperature,
            top_k,
            eng_top_p if top_p is None else top_p,
        )

    def _register_request(self, slot: int, max_new_tokens: int) -> int:
        req_id = self._next_req
        self._next_req += 1
        self.owner[slot] = req_id
        self.budget[slot] = max_new_tokens
        self.buffers[req_id] = []
        return req_id

    def step(self, n_steps: int = 16) -> Dict[int, np.ndarray]:
        """Advance all active slots by (about) n_steps tokens, snapped to
        the DISPATCH_LADDER; slots stop on the device at their budget limit.
        Returns {req_id: new tokens} for requests that produced tokens;
        finished requests move to `self.finished`."""
        return self.step_chained(n_steps, None)[0]

    def step_chained(
        self, n_steps: int = 16, chain_fn=None
    ) -> Tuple[Dict[int, np.ndarray], Optional[np.ndarray]]:
        """`step`, with an optional device computation `chain_fn(packed) ->
        int32 (L,)` chained onto the dispatch and fetched with its result in
        one transfer.  Returns (increments, chain output or None)."""
        handle = self.step_begin(n_steps, chain_fn)
        if handle is None:
            return {}, None
        return self.step_commit(handle, self.step_fetch(handle))

    def step_fetch(self, handle):
        """Blocking host fetch of a dispatched step's result: the only phase
        that waits for the card, and the only one safe on a worker thread."""
        result, chain_fn, n_steps, _ = handle
        return fetch_step_result(result, chain_fn is not None, self.max_slots, n_steps)

    def step_commit(
        self, handle, fetched
    ) -> Tuple[Dict[int, np.ndarray], Optional[np.ndarray]]:
        """Host bookkeeping for a fetched step, against the slot-to-request
        snapshot taken at step_begin (slots admitted meanwhile are invisible
        to the dispatched steps and stay untouched here)."""
        _, _, _, owner_snapshot = handle
        toks, valid, done, extra = fetched
        out: Dict[int, np.ndarray] = {}
        for slot, req in enumerate(owner_snapshot):
            if req is None or req not in self.buffers:
                # the request left under an earlier commit (a pipelined
                # dispatch still shows its slot as done) or a forced release
                continue
            new = toks[slot][valid[slot]]
            if new.size:
                self.buffers[req].extend(new.tolist())
                out[req] = new
            n_valid = int(valid[slot].sum())
            self.budget[slot] -= n_valid
            self._commit_slot_tokens(slot, n_valid)
            if done[slot]:
                self.finished[req] = np.asarray(self.buffers.pop(req), np.int32)
                self.owner[slot] = None
                self._commit_slot_done(slot)
        return out, extra

    def _commit_slot_tokens(self, slot: int, n_valid: int) -> None:
        """Engine hook: per-slot accounting beyond the budget decrement (the
        paged engine tracks tokens_seen for page growth)."""

    def _commit_slot_done(self, slot: int) -> None:
        """Engine hook: release the device state of a finished slot."""
        raise NotImplementedError

    def run_until_done(self, n_steps: int = 16, max_iters: int = 10_000) -> None:
        for _ in range(max_iters):
            if all(o is None for o in self.owner):
                return
            self.step(n_steps)


class ContinuousBatchingEngine(StepProtocolMixin):
    """Host-side slot manager around admission and decode dispatches (unit
    replays) over the dense slot cache.  Runs on the card unless
    `device="cpu"`.

    Besides `submit` (a host id list or an assembled device prompt), clone
    requests admit in one chain of device work with no host read: from a
    prompt wav (`submit_fused`: tokenize, assembly, prefill) or from the
    voice cache's device ids (`submit_assembled`), one request or a burst
    of one shape signature (`submit_*_batch`, padded up
    ADMIT_BATCH_LADDER).  JAX compiles each signature ahead of time; here a
    signature is *ready* once `warm_*` has run it on scratch slot state (the
    first run builds the kernels and the library plans), and the registry
    of ready signatures is shared by the engines of one process."""

    def __init__(
        self,
        params,
        cfg: QwenConfig,
        max_slots: int = 8,
        cache_len: int = 1024,
        prompt_pad: int = 64,
        eos_ids: Tuple[int, ...] = (),
        pad_id: int = 0,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        greedy: bool = False,
        seed: int = 0,
        cache_dtype=torch.bfloat16,
        vocab_slice: Optional[Tuple[int, int]] = None,
        extra_ids: Tuple[int, ...] = (),
        clone_slice: Optional[Tuple[int, int]] = None,
        clone_extras: Tuple[int, ...] = (),
        max_dispatch: int = DISPATCH_LADDER[-1],
        device="cuda",
        mesh=None,
    ):
        self._init_engine(params, cfg, device, max_slots, prompt_pad, eos_ids, pad_id,
                          (temperature, top_k, top_p), greedy, seed, vocab_slice, extra_ids,
                          clone_slice, clone_extras, max_dispatch)
        if (mesh is None) != (tp_of(params) is None) or (mesh and tp_of(params) is not mesh.tp):
            raise ValueError("a tensor-parallel engine takes the mesh and its row's shard of "
                             "the params (pipeline.shard_llm(mesh), then mesh=pipeline.mesh)")
        self.mesh = mesh
        self.leader = None if mesh is None else mesh.tp.leader
        if self.leader is not None:
            # the followers build the same engine over their shards
            self.leader_id = self.leader.new_engine(dict(
                max_slots=max_slots, cache_len=cache_len, prompt_pad=prompt_pad,
                eos_ids=tuple(eos_ids), pad_id=pad_id, temperature=temperature, top_k=top_k,
                top_p=top_p, greedy=greedy, seed=seed, cache_dtype=cache_dtype,
                vocab_slice=vocab_slice, extra_ids=tuple(extra_ids), clone_slice=clone_slice,
                clone_extras=tuple(clone_extras), max_dispatch=max_dispatch))
        self.cache_len = cache_len
        with torch.inference_mode():
            self.slots = init_slots(cfg, max_slots, cache_len, cache_dtype, self.device)
        self._admit_ready: set = set()  # signatures of this engine that have run once
        self._admit_lock = threading.Lock()
        self._aval_key: Optional[tuple] = None
        self.warm_runs = 0  # warm-ups this engine ran itself (not adopted)

    def _take_slot(self, t_pad: int, max_new_tokens: int) -> int:
        slot = self._free_slot()
        if t_pad + max_new_tokens > self.cache_len:
            raise RequestTooLong(
                f"prompt bucket {t_pad} + {max_new_tokens} new tokens > cache {self.cache_len}"
            )
        return slot

    @torch.inference_mode()
    def submit(
        self,
        prompt_ids,
        max_new_tokens: int = 512,
        mode: str = "control",
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        prompt_len: Optional[int] = None,
    ) -> int:
        """Admit a request; returns its id.  Raises RuntimeError if no slot
        is free and RequestTooLong if prompt + budget exceed the cache.
        `mode` "clone" narrows sampling to clone_slice/clone_extras, "control"
        keeps the engine-wide superset.  temperature/top_p are kept per slot
        (top_k is engine-wide).  `prompt_ids` is a host id list, or a device
        tensor (1, t_pad) right-padded to a prompt_pad multiple with
        `prompt_len` its true length."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        n, t_pad = self._prompt_shape(prompt_ids, prompt_len, self.prompt_pad)
        slot = self._take_slot(t_pad, max_new_tokens)
        temperature, top_k, top_p = self._resolve_sampling(temperature, top_p)
        if self.mesh is not None:
            ids = (prompt_ids.cpu().numpy() if isinstance(prompt_ids, torch.Tensor)
                   else self._prompt_array(prompt_ids, n, t_pad))
            self._admit_rows([slot], ids, [n], [n + max_new_tokens], [temperature], [top_p],
                             [mode == "control"])
            return self._register_request(slot, max_new_tokens)
        self.slots = admit_prefill(
            self.params, self.slots, self.cfg, slot, self._prompt_tensor(prompt_ids, n, t_pad),
            n, self.generator, temperature, top_k, top_p, self.greedy, self.vocab_slice,
            self.extra_ids, limit=n + max_new_tokens, control=mode == "control",
            allowed=self.clone_allowed,
        )
        return self._register_request(slot, max_new_tokens)

    # -- the registry of ready admission signatures ------------------------

    def _global_key(self, key: tuple, tokenize_fn, assemble_fn) -> tuple:
        """`key` extended with everything else that shapes an admission's
        work, so engines over the same pipeline share the registry: the
        pipeline's per-shape tokenize/assemble functions (stable identities),
        the settings, and the params' and state's shapes, dtypes and device."""
        if self._aval_key is None:
            self._aval_key = tuple(
                (tuple(t.shape), str(t.dtype), str(t.device))
                for t in [*_leaves(self.params), *graphs.tensors(self.slots)]
            )
        return (key, tokenize_fn, assemble_fn, self.cfg, self.cache_len, self.sampling[1],
                self.greedy, self.vocab_slice, self.extra_ids, self.clone_slice,
                self.clone_extras, self._aval_key)

    @mirrored
    @torch.inference_mode()
    def _admit_rows(self, slot_ids, ids: np.ndarray, prompt_lens, limits, temperature, top_p,
                    control) -> None:
        """Every admission on a mesh: one prefill of the (B, t_pad) host
        prompt ids, right-padded, and the first len(slot_ids) rows installed
        into those slots (`install_rows`); the per-row lists hold B rows.
        Host arguments only, so the row's followers make the same call."""
        _, top_k, _ = self.sampling
        first, tmp_cache = prefill_many(
            self.params, self.cfg, to_device(np.asarray(ids, np.int64), self.device),
            prompt_lens, self.generator, self.slots.cache.k.dtype, temperature, top_k, top_p,
            self.greedy, self.vocab_slice, self.extra_ids, control, self.clone_allowed)
        install_rows(self.slots, slot_ids, first, tmp_cache, prompt_lens, limits, temperature,
                     top_p, control)

    def _ready(self, key: tuple) -> bool:
        with self._admit_lock:
            return key in self._admit_ready

    def _warm(self, key: tuple, tokenize_fn, assemble_fn, run: Callable) -> None:
        """Mark `key` ready, after running `run(scratch slots, generator)`
        once unless another engine of the process already ran its global
        signature.  Thread-safe and idempotent; runs under inference mode
        in any thread.  On a mesh it runs nothing (a warm-up would be LM
        work the row's other ranks do not make)."""
        if self._ready(key):
            return
        if self.mesh is not None:
            with self._admit_lock:
                self._admit_ready.add(key)
            return
        gkey = self._global_key(key, tokenize_fn, assemble_fn)
        with _ADMIT_WARM_LOCK:
            seen = gkey in _ADMIT_WARM
        if not seen:
            with torch.inference_mode():
                scratch = init_slots(self.cfg, self.max_slots, self.cache_len,
                                     self.slots.cache.k.dtype, self.device)
                run(scratch, torch.Generator(device=self.device).manual_seed(0))
            with _ADMIT_WARM_LOCK:
                _ADMIT_WARM.add(gkey)
            self.warm_runs += 1
        with self._admit_lock:
            self._admit_ready.add(key)

    def _settings(self) -> dict:
        return dict(greedy=self.greedy, vocab_slice=self.vocab_slice, extra_ids=self.extra_ids,
                    allowed=self.clone_allowed)

    # -- fused admission (tokenize + assembly + prefill) -------------------

    def fused_key(self, tok_args: tuple, t_pad: int) -> tuple:
        """Shape signature of a fused admission: the wav bucket, wav2vec2
        frames, reference clip and prompt bucket."""
        _, _, wav, feature_mask, ref_wav = tok_args
        return (tuple(wav.shape), tuple(feature_mask.shape), tuple(ref_wav.shape), t_pad)

    def fused_ready(self, tok_args: tuple, t_pad: int) -> bool:
        return self._ready(self.fused_key(tok_args, t_pad))

    def warm_fused(self, tokenize_fn, assemble_fn, tok_args: tuple, t_pad: int) -> None:
        """Run the fused admission of this signature once on scratch slots,
        so a live one builds nothing.  Thread-safe and idempotent: the
        server calls it from a background thread."""
        temperature, top_k, top_p = self._resolve_sampling(None, None)

        def run(scratch, gen):
            admit_prefill_fused(self.params, scratch, self.cfg, 0, tokenize_fn, tok_args,
                                assemble_fn, np.zeros((1, t_pad), np.int32), 0, 0, 0, 1, gen,
                                temperature, top_k, top_p, limit=1, **self._settings())

        self._warm(self.fused_key(tok_args, t_pad), tokenize_fn, assemble_fn, run)

    @torch.inference_mode()
    def submit_fused(
        self,
        tokenize_fn,
        assemble_fn,
        tok_args: tuple,        # pipeline.tokenize_host_prep's device args
        scaffold: np.ndarray,   # (t_pad,) int32, t_pad % prompt_pad == 0
        g_off: int,
        s_off: int,
        n_sem: int,
        prompt_len: int,
        max_new_tokens: int = 512,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
    ) -> Tuple[int, torch.Tensor, torch.Tensor]:
        """Clone-mode admission from a prompt wav with no host read (audio
        tokenize, prompt assembly and prefill, `admit_prefill_fused`),
        warming the signature first if it is cold.  Returns (req_id, global
        ids (1, N), semantic ids (1, S_pad)), the ids on the device."""
        t_pad = len(scaffold)
        if not 0 < prompt_len <= t_pad:
            raise ValueError(f"prompt length {prompt_len} outside [1, {t_pad}]")
        slot = self._take_slot(t_pad, max_new_tokens)
        temperature, top_k, top_p = self._resolve_sampling(temperature, top_p)
        self.warm_fused(tokenize_fn, assemble_fn, tok_args, t_pad)
        if self.mesh is not None:
            global_t, semantic = tokenize_fn(*tok_args)
            ids = assemble_fn(np.asarray(scaffold, np.int32)[None, :], global_t, semantic,
                              [g_off], [s_off], [n_sem])
            self._admit_rows([slot], ids.cpu().numpy(), [prompt_len],
                             [prompt_len + max_new_tokens], [temperature], [top_p], [False])
            return self._register_request(slot, max_new_tokens), global_t, semantic
        self.slots, global_t, semantic = admit_prefill_fused(
            self.params, self.slots, self.cfg, slot, tokenize_fn, tok_args, assemble_fn,
            np.asarray(scaffold, np.int32)[None, :], g_off, s_off, n_sem, prompt_len,
            self.generator, temperature, top_k, top_p, limit=prompt_len + max_new_tokens,
            **self._settings(),
        )
        return self._register_request(slot, max_new_tokens), global_t, semantic

    # -- assembled admission (a voice-cache hit: ids already on the device) --

    def assembled_key(self, global_t, semantic, t_pad: int) -> tuple:
        return ("asm", tuple(global_t.shape), tuple(semantic.shape), t_pad)

    def assembled_ready(self, global_t, semantic, t_pad: int) -> bool:
        return self._ready(self.assembled_key(global_t, semantic, t_pad))

    def warm_assembled(self, assemble_fn, global_t, semantic, t_pad: int) -> None:
        """`warm_fused` for the assembled admission of this signature."""
        temperature, top_k, top_p = self._resolve_sampling(None, None)

        def run(scratch, gen):
            admit_prefill_assembled(self.params, scratch, self.cfg, 0, global_t, semantic,
                                    assemble_fn, np.zeros((1, t_pad), np.int32), 0, 0, 0, 1,
                                    gen, temperature, top_k, top_p, limit=1, **self._settings())

        self._warm(self.assembled_key(global_t, semantic, t_pad), None, assemble_fn, run)

    @torch.inference_mode()
    def submit_assembled(
        self,
        assemble_fn,
        global_t: torch.Tensor,  # (1, N) cached voice ids, on the device
        semantic: torch.Tensor,  # (1, S_pad)
        scaffold: np.ndarray,
        g_off: int,
        s_off: int,
        n_sem: int,
        prompt_len: int,
        max_new_tokens: int = 512,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
    ) -> int:
        """Clone-mode admission from cached voice ids (assembly + prefill,
        no audio tokenize).  Returns the request id."""
        t_pad = len(scaffold)
        if not 0 < prompt_len <= t_pad:
            raise ValueError(f"prompt length {prompt_len} outside [1, {t_pad}]")
        slot = self._take_slot(t_pad, max_new_tokens)
        temperature, top_k, top_p = self._resolve_sampling(temperature, top_p)
        self.warm_assembled(assemble_fn, global_t, semantic, t_pad)
        if self.mesh is not None:
            ids = assemble_fn(np.asarray(scaffold, np.int32)[None, :], global_t, semantic,
                              [g_off], [s_off], [n_sem])
            self._admit_rows([slot], ids.cpu().numpy(), [prompt_len],
                             [prompt_len + max_new_tokens], [temperature], [top_p], [False])
            return self._register_request(slot, max_new_tokens)
        self.slots = admit_prefill_assembled(
            self.params, self.slots, self.cfg, slot, global_t, semantic, assemble_fn,
            np.asarray(scaffold, np.int32)[None, :], g_off, s_off, n_sem, prompt_len,
            self.generator, temperature, top_k, top_p, limit=prompt_len + max_new_tokens,
            **self._settings(),
        )
        return self._register_request(slot, max_new_tokens)

    # -- batched admissions (a burst of one shape signature) ---------------

    def _take_slots(self, requests) -> List[dict]:
        """Each request row with its sampling resolved and a slot taken (the
        slots stay reserved until `_register_rows`); all or none."""
        rows = []
        try:
            for r in requests:
                r = dict(r)
                r["temperature"], _, r["top_p"] = self._resolve_sampling(
                    r.get("temperature"), r.get("top_p"))
                r["slot"] = self._take_slot(len(r["scaffold"]), r["max_new_tokens"])
                self.owner[r["slot"]] = -1  # reserved before the next row picks
                rows.append(r)
        except Exception:
            for r in rows:
                self.owner[r["slot"]] = None
            raise
        return rows

    def _register_rows(self, rows) -> List[int]:
        req_ids = []
        for r in rows:
            self.owner[r["slot"]] = None
            req_ids.append(self._register_request(r["slot"], r["max_new_tokens"]))
        return req_ids

    @staticmethod
    def _batch_args(rows, b: int) -> dict:
        """The per-row host arguments of a batched admission, `rows` padded
        to `b` by repeating row 0."""
        rows = list(rows) + [rows[0]] * (b - len(rows))
        return dict(
            scaffolds=np.stack([np.asarray(r["scaffold"], np.int32) for r in rows]),
            g_offs=[r["g_off"] for r in rows], s_offs=[r["s_off"] for r in rows],
            n_sems=[r["n_sem"] for r in rows], prompt_lens=[r["prompt_len"] for r in rows],
            temperature=[r["temperature"] for r in rows], top_p=[r["top_p"] for r in rows],
            limits=[r["prompt_len"] + r["max_new_tokens"] for r in rows],
        )

    def assembled_batch_key(self, b: int, n_glob: int, s_pad: int, t_pad: int) -> tuple:
        return ("asmb", b, n_glob, s_pad, t_pad)

    def assembled_batch_ready(self, b: int, n_glob: int, s_pad: int, t_pad: int) -> bool:
        return self._ready(self.assembled_batch_key(b, n_glob, s_pad, t_pad))

    def warm_assembled_batch(self, assemble_fn, b: int, n_glob: int, s_pad: int,
                             t_pad: int) -> None:
        """`warm_fused` for the batched assembled admission of this (batch,
        shape) signature."""
        temperature, top_k, top_p = self._resolve_sampling(None, None)
        row = dict(scaffold=np.zeros(t_pad, np.int32), g_off=0, s_off=0, n_sem=0, prompt_len=1,
                   max_new_tokens=0, temperature=temperature, top_p=top_p)

        def run(scratch, gen):
            zeros = torch.zeros((b, n_glob + s_pad), dtype=torch.int32, device=self.device)
            admit_prefill_assembled_batch(
                self.params, scratch, self.cfg, [0], zeros[:, :n_glob], zeros[:, n_glob:],
                assemble_fn, generator=gen, top_k=top_k, **self._batch_args([row], b),
                **self._settings())

        self._warm(self.assembled_batch_key(b, n_glob, s_pad, t_pad), None, assemble_fn, run)

    @torch.inference_mode()
    def submit_assembled_batch(self, assemble_fn, requests) -> List[int]:
        """Admit a burst of voice-cache-hit clone requests as one batched
        admission.  `requests`: dicts with global_t, semantic (device ids),
        scaffold, g_off, s_off, n_sem, prompt_len, max_new_tokens,
        temperature, top_p (None: the engine's).  The batch pads up
        ADMIT_BATCH_LADDER by repeating row 0.  Returns the request ids in
        order."""
        n = len(requests)
        b = next((x for x in ADMIT_BATCH_LADDER if x >= n), None)
        if n < 1 or b is None:
            raise ValueError(f"a batched admission takes 1..{ADMIT_BATCH_LADDER[-1]} rows, got {n}")
        sigs = {(r["global_t"].shape[-1], r["semantic"].shape[-1], len(r["scaffold"]))
                for r in requests}
        if len(sigs) != 1:
            raise ValueError(f"a batched admission needs one shape signature, got {sigs}")
        (n_glob, s_pad, t_pad), = sigs
        rows = self._take_slots(requests)
        self.warm_assembled_batch(assemble_fn, b, n_glob, s_pad, t_pad)
        padded = rows + [rows[0]] * (b - n)
        g = torch.cat([r["global_t"].reshape(1, -1) for r in padded]).to(self.device, torch.int32)
        s = torch.cat([r["semantic"].reshape(1, -1) for r in padded]).to(self.device, torch.int32)
        _, top_k, _ = self.sampling
        if self.mesh is not None:
            args = self._batch_args(rows, b)
            ids = assemble_fn(args["scaffolds"], g, s, args["g_offs"], args["s_offs"],
                              args["n_sems"])
            self._admit_mesh_batch(rows, ids, args)
            return self._register_rows(rows)
        self.slots = admit_prefill_assembled_batch(
            self.params, self.slots, self.cfg, [r["slot"] for r in rows], g, s, assemble_fn,
            generator=self.generator, top_k=top_k, **self._batch_args(rows, b),
            **self._settings())
        return self._register_rows(rows)

    def _admit_mesh_batch(self, rows, ids: torch.Tensor, args: dict) -> None:
        """A batched clone admission's prefill on a mesh, from its assembled
        (b, t_pad) ids."""
        self._admit_rows([r["slot"] for r in rows], ids.cpu().numpy(), args["prompt_lens"],
                         args["limits"], args["temperature"], args["top_p"],
                         [False] * ids.shape[0])

    def fused_batch_key(self, b: int, tok_args: tuple, t_pad: int) -> tuple:
        _, _, wav, feature_mask, ref_wav = tok_args
        return ("fusb", b, wav.shape[-1], feature_mask.shape[-1], ref_wav.shape[-1], t_pad)

    def fused_batch_ready(self, b: int, tok_args: tuple, t_pad: int) -> bool:
        return self._ready(self.fused_batch_key(b, tok_args, t_pad))

    @staticmethod
    def _stack_tok_args(rows, b: int) -> tuple:
        """The rows' tokenize arguments stacked into one batch of `b` (row 0
        repeated), on the device."""
        rows = list(rows) + [rows[0]] * (b - len(rows))
        w2v, bc = rows[0]["tok_args"][:2]
        return (w2v, bc, *(torch.cat([r["tok_args"][i] for r in rows]) for i in (2, 3, 4)))

    def warm_fused_batch(self, tokenize_fn, assemble_fn, b: int, tok_args: tuple,
                         t_pad: int) -> None:
        """`warm_fused` for the batched fused admission of this (batch,
        wav/ref/prompt shape) signature."""
        temperature, top_k, top_p = self._resolve_sampling(None, None)
        row = dict(tok_args=tok_args, scaffold=np.zeros(t_pad, np.int32), g_off=0, s_off=0,
                   n_sem=0, prompt_len=1, max_new_tokens=0, temperature=temperature,
                   top_p=top_p)

        def run(scratch, gen):
            admit_prefill_fused_batch(
                self.params, scratch, self.cfg, [0], tokenize_fn,
                self._stack_tok_args([row], b), assemble_fn, generator=gen, top_k=top_k,
                **self._batch_args([row], b), **self._settings())

        self._warm(self.fused_batch_key(b, tok_args, t_pad), tokenize_fn, assemble_fn, run)

    @torch.inference_mode()
    def submit_fused_batch(self, tokenize_fn, assemble_fn, requests):
        """Admit a burst of first-time clone requests as one batched fused
        admission (batched audio tokenize, assembly, one prefill).  Rows
        carry tok_args (each request's `tokenize_host_prep` device args) and
        the keys of `submit_assembled_batch` but the ids.  Returns (req_ids,
        global ids (B, N), semantic ids (B, S_pad)) on the device, B the
        padded batch (row i is request i's)."""
        n = len(requests)
        b = next((x for x in ADMIT_BATCH_LADDER if x >= n), None)
        if n < 1 or b is None:
            raise ValueError(f"a batched admission takes 1..{ADMIT_BATCH_LADDER[-1]} rows, got {n}")
        sigs = {self.fused_batch_key(b, r["tok_args"], len(r["scaffold"])) for r in requests}
        if len(sigs) != 1:
            raise ValueError(f"a batched admission needs one shape signature, got {sigs}")
        rows = self._take_slots(requests)
        t_pad = len(rows[0]["scaffold"])
        self.warm_fused_batch(tokenize_fn, assemble_fn, b, rows[0]["tok_args"], t_pad)
        _, top_k, _ = self.sampling
        if self.mesh is not None:
            args = self._batch_args(rows, b)
            global_t, semantic = tokenize_fn(*self._stack_tok_args(rows, b))
            ids = assemble_fn(args["scaffolds"], global_t, semantic, args["g_offs"],
                              args["s_offs"], args["n_sems"])
            self._admit_mesh_batch(rows, ids, args)
            return self._register_rows(rows), global_t, semantic
        self.slots, global_t, semantic = admit_prefill_fused_batch(
            self.params, self.slots, self.cfg, [r["slot"] for r in rows], tokenize_fn,
            self._stack_tok_args(rows, b), assemble_fn, generator=self.generator, top_k=top_k,
            **self._batch_args(rows, b), **self._settings())
        return self._register_rows(rows), global_t, semantic

    # -- the step protocol --------------------------------------------------

    @torch.inference_mode()
    def step_begin(self, n_steps: int, chain_fn=None):
        """Enqueue one decode dispatch of n_steps snapped to the ladder;
        returns a handle for step_fetch/step_commit, or None when no slot is
        live.  Does not wait for the card."""
        if all(o is None for o in self.owner):
            return None
        n_steps = snap_to_ladder(n_steps, self.max_dispatch)
        packed = self._decode(n_steps)
        return (chain_step_result(packed, chain_fn), chain_fn, n_steps, list(self.owner))

    @mirrored
    def _decode(self, n_steps: int, capture_only: bool = False) -> Optional[torch.Tensor]:
        _, top_k, _ = self.sampling
        self.slots, packed = decode_steps(
            self.params, self.slots, self.cfg, n_steps, self.generator, top_k, self.eos_ids,
            self.pad_id, self.greedy, self.vocab_slice, self.extra_ids, self.clone_allowed,
            capture_only, self.units,
        )
        return packed

    @mirrored
    @torch.inference_mode()
    def _commit_slot_done(self, slot: int) -> None:
        self.slots.active[slot] = False

    @mirrored
    def close(self) -> None:
        super().close()

    @mirrored
    @torch.inference_mode()
    def release_slot(self, slot: int) -> None:
        """Forcibly free a slot (failure containment): drops the request's
        buffered tokens and deactivates the slot on the device."""
        req = self.owner[slot]
        if req is not None:
            self.buffers.pop(req, None)
            self.owner[slot] = None
        self.budget[slot] = 0
        self.slots.active[slot] = False
        self.slots.done[slot] = True
