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

The fused, assembled and batched admission programs of the JAX engine and
their executable caches are not ported (the server that calls them is not).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.generate import expand_constrained, packed_allowed_mask
from sparktts_tpu_torch.lm.qwen import KVCache, init_kv_cache, qwen_forward
from sparktts_tpu_torch.lm.sample import NEG_INF, greedy_token, sample_token

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
    """Shared single-prompt admission prefill (dense and paged engines): the
    prompt through the model with a causal + pad bias (dense attention, not
    the flash kernel: the prompt is right-padded), then the first new token
    sampled from the last prompt position.  Returns (first token (1,) int64,
    the prompt's KV cache (L, 1, t_pad, n_kv, hd))."""
    t_pad = input_ids.shape[1]
    dev = input_ids.device
    idx = torch.arange(t_pad, device=dev)
    tmp_cache = init_kv_cache(cfg, 1, t_pad, cache_dtype, dev)
    positions = idx.clamp(max=prompt_len - 1)[None, :]
    keep = (idx[None, :] <= idx[:, None]) & (idx[None, :] < prompt_len)  # (q, k)
    bias = torch.where(keep, 0.0, NEG_INF).float()[None]
    logits, tmp_cache = qwen_forward(
        params, cfg, input_ids, positions, tmp_cache, 0, bias,
        vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    last = logits[:, prompt_len - 1]
    if allowed is not None and not control:
        last = last.masked_fill(~allowed, NEG_INF)
    if greedy:
        first_tok = greedy_token(last)
    else:
        first_tok = sample_token(generator, last, temperature, top_k, top_p)
    return expand_constrained(first_tok, vocab_slice, extra_ids), tmp_cache


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


def dispatch_steps(kind: str, params, slots, n_steps: int, generator: torch.Generator,
                   make_step: Callable[[torch.Generator], Callable], static: Tuple,
                   ) -> Tuple[object, torch.Tensor]:
    """n_steps decode steps of either engine as replays of its decode unit,
    bound to the engine's own slot buffers (the unit's key holds their
    addresses, the params' identity and the `static` arguments); returns
    (slots, packed (B, 2n+1) int32, see `pack_step_result`).
    `make_step(generator)` gives the engine's one-step function."""
    steps = math.gcd(n_steps, ENGINE_UNIT)
    bufs = graphs.tensors(slots)
    key = (kind, id(params), steps, static, tuple(t.data_ptr() for t in bufs))

    def build() -> graphs.DecodeUnit:
        def make_scan(gen):
            step = make_step(gen)
            return lambda s: scan_steps(steps, s, step)

        return graphs.DecodeUnit(make_scan, slots, steps,
                                 name=f"{kind} B={slots.cur_token.shape[0]} U={steps}")

    unit = graphs.unit(key, bufs[0].device, build)
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
) -> Tuple[SlotState, torch.Tensor]:
    """Advance every active slot by up to n_steps tokens; returns (slots,
    packed (B, 2n+1) int32, see `pack_step_result`).  The validity half of
    the pack is the explicit liveness mask: pad_id may be a legitimately
    sampled id.  A slot whose write_pos reaches its limit stops on the
    device.  `allowed` narrows clone slots (`packed_allowed_mask`).  The
    slots are updated in place (`dispatch_steps`)."""

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
    return dispatch_steps(kind, params, slots, n_steps, generator, make_step, static)


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
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "continuous engine: no CUDA device is available; pass device='cpu' to run on the CPU"
            )
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
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
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

    def _prompt_tensor(self, prompt_ids, n: int, t_pad: int) -> torch.Tensor:
        if isinstance(prompt_ids, torch.Tensor):
            return prompt_ids.long()
        ids = np.full((1, t_pad), self.pad_id, np.int64)
        ids[0, :n] = prompt_ids  # right-padded
        return to_device(ids, self.device)

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
    `device="cpu"`."""

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
    ):
        self._init_engine(params, cfg, device, max_slots, prompt_pad, eos_ids, pad_id,
                          (temperature, top_k, top_p), greedy, seed, vocab_slice, extra_ids,
                          clone_slice, clone_extras, max_dispatch)
        self.cache_len = cache_len
        with torch.inference_mode():
            self.slots = init_slots(cfg, max_slots, cache_len, cache_dtype, self.device)

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
        slot = self._free_slot()
        n, t_pad = self._prompt_shape(prompt_ids, prompt_len, self.prompt_pad)
        if t_pad + max_new_tokens > self.cache_len:
            raise RequestTooLong(
                f"prompt bucket {t_pad} + {max_new_tokens} new tokens > cache {self.cache_len}"
            )
        temperature, top_k, top_p = self._resolve_sampling(temperature, top_p)
        self.slots = admit_prefill(
            self.params, self.slots, self.cfg, slot, self._prompt_tensor(prompt_ids, n, t_pad),
            n, self.generator, temperature, top_k, top_p, self.greedy, self.vocab_slice,
            self.extra_ids, limit=n + max_new_tokens, control=mode == "control",
            allowed=self.clone_allowed,
        )
        return self._register_request(slot, max_new_tokens)

    @torch.inference_mode()
    def step_begin(self, n_steps: int, chain_fn=None):
        """Enqueue one decode dispatch of n_steps snapped to the ladder;
        returns a handle for step_fetch/step_commit, or None when no slot is
        live.  Does not wait for the card."""
        if all(o is None for o in self.owner):
            return None
        n_steps = snap_to_ladder(n_steps, self.max_dispatch)
        _, top_k, _ = self.sampling
        self.slots, packed = decode_steps(
            self.params, self.slots, self.cfg, n_steps, self.generator, top_k, self.eos_ids,
            self.pad_id, self.greedy, self.vocab_slice, self.extra_ids, self.clone_allowed,
        )
        return (chain_step_result(packed, chain_fn), chain_fn, n_steps, list(self.owner))

    @torch.inference_mode()
    def _commit_slot_done(self, slot: int) -> None:
        self.slots.active[slot] = False

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
