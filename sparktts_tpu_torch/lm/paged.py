"""Paged-KV continuous batching engine.

Port of `sparktts_tpu/lm/paged.py`.  The dense engine (`lm/continuous.py`)
preallocates max_slots × cache_len of KV per layer, so every admitted
request reserves its worst case.  Here K/V live in a shared page pool:

  * pools: (L, n_kv, n_pages, page_size, hd), page 0 reserved as the trash
    page (slots that are not live write their dead K/V there);
  * each slot holds a row of the (B, pages_per_slot) int32 page table; the
    host allocates pages as decode crosses page boundaries and returns them
    to the free list when a request finishes;
  * decode attention runs through `kernels.paged_attention` (the CUDA kernel
    on a card, its plain version on the CPU), which reads each slot's pages
    through its table row: nothing is gathered into device memory.

Admission reserves each request's worst-case page count and raises
AdmissionDeferred when the pool cannot cover every admitted request's
budget, so a request never runs out of pages mid-decode.  A dispatch runs
as replays of a decode unit over the engine's own buffers
(`paged_decode_steps`, the dense engine's `dispatch_steps`): pools, page
table and slot vectors keep their addresses for the life of the engine, so
page growth copies a new table into the old one.  The engine state is
built and changed under `torch.inference_mode()`, and the protocol and
sampling are the dense engine's (`StepProtocolMixin`, `advance_slots`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.kernels.paged_attention import paged_decode_attention
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.continuous import (
    DISPATCH_LADDER,
    MODES,
    AdmissionDeferred,
    RequestTooLong,
    StepProtocolMixin,
    _mode_masked,
    advance_slots,
    chain_step_result,
    decode_unit,
    dispatch_steps,
    install_slot,
    prefill_one,
    slot_vectors,
    snap_to_ladder,
    to_device,
)
from sparktts_tpu_torch.lm.qwen import (
    embed_lookup,
    mlp_block,
    output_logits,
    project_qkv,
    rope_cos_sin,
    unstack_layers,
)
from sparktts_tpu_torch.nn.layers import linear_apply, rms_norm_apply
from sparktts_tpu_torch.parallel.mesh import tp_of


class PagedSlotState(NamedTuple):
    """Device state: shared page pools and per-slot tensors (B = max_slots)."""

    k_pages: torch.Tensor      # (L, n_kv, n_pages, page_size, hd)
    v_pages: torch.Tensor      # (L, n_kv, n_pages, page_size, hd)
    page_table: torch.Tensor   # (B, pages_per_slot) int32
    cur_token: torch.Tensor    # (B,) int64, next token to feed
    write_pos: torch.Tensor    # (B,) int32, token index the next K/V lands at (its RoPE position)
    limit: torch.Tensor        # (B,) int32, the slot stops at this position
    active: torch.Tensor       # (B,) bool
    done: torch.Tensor         # (B,) bool
    control: torch.Tensor      # (B,) bool, controllable-mode (superset) request
    temperature: torch.Tensor  # (B,) fp32 per-slot sampling temperature
    top_p: torch.Tensor        # (B,) fp32 per-slot nucleus threshold


def init_paged_slots(
    cfg: QwenConfig,
    max_slots: int,
    n_pages: int,
    page_size: int,
    pages_per_slot: int,
    cache_dtype=torch.bfloat16,
    device="cuda",
) -> PagedSlotState:
    pool_shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, n_pages, page_size, cfg.head_dim)
    return PagedSlotState(
        k_pages=torch.zeros(pool_shape, dtype=cache_dtype, device=device),
        v_pages=torch.zeros(pool_shape, dtype=cache_dtype, device=device),
        page_table=torch.zeros((max_slots, pages_per_slot), dtype=torch.int32, device=device),
        **slot_vectors(max_slots, device),
    )


def _write_token_kv(pages: torch.Tensor, new: torch.Tensor, layer: int, page_idx, offset) -> None:
    """Write one token's K or V per slot into the stacked pool, in place.

    pages: (L, n_kv, n_pages, P, hd); new: (B, n_kv, hd); page_idx/offset:
    (B,) int64.  With a host-int layer the two index tensors are adjacent,
    so the target is (n_kv, B, hd) (in JAX the traced layer index is a third
    advanced index and moves B to the front).  Slots that are not live must
    point at the trash page: several of them may write the same place."""
    pages[layer, :, page_idx, offset] = new.transpose(0, 1).to(pages.dtype)


def paged_step_logits(
    params,
    cfg: QwenConfig,
    s: PagedSlotState,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    allowed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step's forward over the paged pools: feeds s.cur_token,
    writes each live slot's K/V at its write_pos (slots that are not live
    write to the trash page), attends to keys [0, write_pos] through the
    page table, and returns the step's guided logits (B, W) narrowed per
    mode."""
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    page_size, pages_per_slot = s.k_pages.shape[3], s.page_table.shape[1]
    live = s.active & ~s.done
    # a finished slot keeps write_pos == limit, which may be one page past
    # its table row (JAX's gather clamps it; the write goes to the trash page)
    table_col = (s.write_pos // page_size).clamp(max=pages_per_slot - 1).long()
    pidx = torch.gather(s.page_table, 1, table_col[:, None])[:, 0].long()
    pidx = torch.where(live, pidx, 0)
    poff = (s.write_pos % page_size).long()
    lengths = s.write_pos + 1  # keys [0, write_pos] valid

    x = embed_lookup(params, s.cur_token[:, None])  # (B, 1, H)
    b = x.shape[0]
    rope = rope_cos_sin(s.write_pos[:, None], cfg)
    for li, layer in enumerate(unstack_layers(params["layers"])):
        y = rms_norm_apply(layer["ln1"], x, eps=cfg.rms_norm_eps)
        q, k, v = project_qkv(layer, y, rope, cfg)
        _write_token_kv(s.k_pages, k[:, 0], li, pidx, poff)
        _write_token_kv(s.v_pages, v[:, 0], li, pidx, poff)
        attn = paged_decode_attention(
            q.reshape(b, nh, hd), s.k_pages, s.v_pages, s.page_table, lengths, li,
            sm_scale=hd**-0.5,
        )
        x = x + linear_apply(layer["o"], attn.reshape(b, 1, nh * hd).to(x.dtype))
        y = rms_norm_apply(layer["ln2"], x, eps=cfg.rms_norm_eps)
        x = x + mlp_block(layer, y, decode_fused=True)
    x = rms_norm_apply(params["final_ln"], x, eps=cfg.rms_norm_eps)
    logits = output_logits(params, cfg, x, vocab_slice, extra_ids)
    return _mode_masked(logits[:, -1], s.control, allowed)


def paged_decode_steps(
    params,
    slots: PagedSlotState,
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
) -> Tuple[PagedSlotState, Optional[torch.Tensor]]:
    """Advance every active slot up to n_steps tokens over the paged pools.
    Returns (slots, packed (B, 2n+1)): the dense engine's `decode_steps`
    contract (budget limit on the device, per-slot mode constraint, one
    packed host transfer, the slots updated in place; `units` the engine's
    cache of decode units)."""

    def make_step(gen: torch.Generator):
        def step(s: PagedSlotState):
            logits = paged_step_logits(params, cfg, s, vocab_slice, extra_ids, allowed)
            live, nxt, new_write, done = advance_slots(
                s, logits, gen, top_k, greedy, vocab_slice, extra_ids, eos_ids, pad_id
            )
            return s._replace(cur_token=nxt, write_pos=new_write, done=done), s.cur_token, live
        return step

    static = (cfg, top_k, eos_ids, pad_id, greedy, vocab_slice, extra_ids,
              None if allowed is None else allowed.data_ptr())
    kind = "paged engine, greedy" if greedy else "paged engine"
    if capture_only:
        decode_unit(kind, params, slots, n_steps, make_step, static, units)
        return slots, None
    return dispatch_steps(kind, params, slots, n_steps, generator, make_step, static, units)


def paged_admit_prefill(
    params,
    slots: PagedSlotState,
    cfg: QwenConfig,
    slot: int,
    input_ids: torch.Tensor,   # (1, t_pad) right-padded, t_pad % page_size == 0
    prompt_len: int,
    page_ids: torch.Tensor,    # (t_pad // page_size,) int64 freshly allocated pages
    table_row: torch.Tensor,   # (pages_per_slot,) int32, the slot's new table row
    generator: torch.Generator,
    temperature: float = 0.8,
    top_k: int = 50,
    top_p: float = 0.95,
    greedy: bool = False,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    limit: int = 2**30,  # token position decode stops at
    control: bool = True,
    allowed: Optional[torch.Tensor] = None,
) -> PagedSlotState:
    """Prefill one prompt densely (the shared `prefill_one`), write its K/V
    into the slot's pages and install the slot, in place; returns `slots`."""
    first_tok, tmp_cache = prefill_one(
        params, cfg, input_ids, prompt_len, generator, slots.k_pages.dtype,
        temperature, top_k, top_p, greedy, vocab_slice, extra_ids, control, allowed,
    )
    t_pad, page_size = input_ids.shape[1], slots.k_pages.shape[3]

    def to_pages(c):  # (L, 1, t_pad, nkv, hd) -> (L, nkv, t_pad / P, P, hd)
        return c[:, 0].transpose(1, 2).reshape(
            cfg.num_hidden_layers, cfg.num_key_value_heads, t_pad // page_size, page_size,
            cfg.head_dim,
        )

    slots.k_pages[:, :, page_ids] = to_pages(tmp_cache.k)
    slots.v_pages[:, :, page_ids] = to_pages(tmp_cache.v)
    slots.page_table[slot] = table_row
    install_slot(slots, slot, first_tok, prompt_len, limit, control, temperature, top_p)
    return slots


class PagedContinuousEngine(StepProtocolMixin):
    """Host-side page allocator and slot manager, with the dense engine's
    public API (submit / step / run_until_done / finished).  Runs on the
    card unless `device="cpu"`."""

    def __init__(
        self,
        params,
        cfg: QwenConfig,
        max_slots: int = 8,
        n_pages: int = 64,
        page_size: int = 256,
        pages_per_slot: int = 16,
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
        if mesh is not None or tp_of(params) is not None:
            # as the JAX server refuses paged=True on a mesh
            raise ValueError("the paged engine does not run on a tensor-parallel mesh; use the "
                             "dense engine")
        # admission pads prompts to a multiple of both buckets (the prefill's
        # K/V is written in whole pages), so one must divide the other
        if prompt_pad % page_size and page_size % prompt_pad:
            raise ValueError(f"prompt_pad {prompt_pad} and page_size {page_size}: "
                             "one must divide the other")
        self._init_engine(params, cfg, device, max_slots, prompt_pad, eos_ids, pad_id,
                          (temperature, top_k, top_p), greedy, seed, vocab_slice, extra_ids,
                          clone_slice, clone_extras, max_dispatch)
        self._admit_bucket = max(prompt_pad, page_size)
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        with torch.inference_mode():
            self.slots = init_paged_slots(cfg, max_slots, n_pages, page_size, pages_per_slot,
                                          cache_dtype, self.device)
        # page 0 is the trash page: never allocated
        self.free_pages: List[int] = list(range(1, n_pages))
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self.tokens_seen = np.zeros(max_slots, np.int64)  # prompt + decoded
        # decode steps dispatched but not yet committed: a caller may begin
        # dispatch N+1 before committing N, and page growth must cover both
        # (tokens_seen alone lags by the uncommitted window and would put
        # live K/V on the trash page)
        self.steps_inflight = np.zeros(max_slots, np.int64)
        # worst-case pages each slot may grow to (reserved at admission)
        self.reserved = np.zeros(max_slots, np.int64)
        self.token_limit = np.zeros(max_slots, np.int64)  # prompt + budget

    def pages_in_use(self) -> int:
        return sum(len(p) for p in self.slot_pages)

    def _alloc(self, n: int) -> List[int]:
        if len(self.free_pages) < n:
            raise RuntimeError(f"page pool exhausted: need {n}, free {len(self.free_pages)}")
        got, self.free_pages = self.free_pages[:n], self.free_pages[n:]
        return got

    def _table_row(self, slot: int) -> np.ndarray:
        row = np.zeros(self.pages_per_slot, np.int32)
        pages = self.slot_pages[slot]
        row[: len(pages)] = pages
        return row

    def _outstanding_growth(self) -> int:
        """Pages the pool must still be able to hand to admitted slots."""
        return int(sum(self.reserved[s] - len(self.slot_pages[s])
                       for s, o in enumerate(self.owner) if o is not None))

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
        """Admit a request (the dense engine's `submit` contract).  Reserves
        its worst-case page count up front: if the pool cannot cover every
        admitted request running to its full budget, raises
        AdmissionDeferred instead of admitting a request that could exhaust
        the pool mid-decode."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        slot = self._free_slot()
        n, t_pad = self._prompt_shape(prompt_ids, prompt_len, self._admit_bucket)
        total_pages = -(-(t_pad + max_new_tokens) // self.page_size)
        if total_pages > self.pages_per_slot:
            raise RequestTooLong(
                f"prompt bucket {t_pad} + {max_new_tokens} new tokens need {total_pages} pages "
                f"> pages_per_slot {self.pages_per_slot}"
            )
        prompt_pages = t_pad // self.page_size
        outstanding = self._outstanding_growth()
        if len(self.free_pages) - prompt_pages < outstanding + total_pages - prompt_pages:
            raise AdmissionDeferred(
                f"page pool cannot reserve {total_pages} pages for this request (free "
                f"{len(self.free_pages)}, outstanding growth {outstanding}): retry after slots free"
            )
        self.slot_pages[slot] = self._alloc(prompt_pages)
        temperature, top_k, top_p = self._resolve_sampling(temperature, top_p)
        self.slots = paged_admit_prefill(
            self.params, self.slots, self.cfg, slot, self._prompt_tensor(prompt_ids, n, t_pad),
            n, to_device(np.asarray(self.slot_pages[slot], np.int64), self.device),
            to_device(self._table_row(slot), self.device), self.generator, temperature, top_k,
            top_p, self.greedy, self.vocab_slice, self.extra_ids, limit=n + max_new_tokens,
            control=mode == "control", allowed=self.clone_allowed,
        )
        self.tokens_seen[slot] = n
        self.token_limit[slot] = n + max_new_tokens
        self.reserved[slot] = total_pages
        return self._register_request(slot, max_new_tokens)

    @torch.inference_mode()
    def _ensure_pages(self, n_steps: int) -> None:
        """Grow page tables so every active slot can absorb n_steps tokens.

        Atomic: per-slot deficits are computed first and their total
        allocated in one `_alloc` call before any slot's page list changes,
        so a failed allocation leaves tables, lists and device state
        coherent.  With the admission-time reservation it fails only if a
        caller bypassed `submit`."""
        deficits: List[Tuple[int, int]] = []
        for slot, req in enumerate(self.owner):
            if req is None:
                continue
            # slots stop on the device at token_limit: pages past it are
            # never written
            tokens_after = min(int(self.tokens_seen[slot] + self.steps_inflight[slot]) + n_steps,
                               int(self.token_limit[slot]))
            need = -(-tokens_after // self.page_size)
            if need > self.pages_per_slot:
                # capping would put live K/V on the shared trash page
                raise RuntimeError(
                    f"slot {slot} needs {need} pages > pages_per_slot={self.pages_per_slot}"
                )
            have = len(self.slot_pages[slot])
            if need > have:
                deficits.append((slot, need - have))
        if not deficits:
            return
        got = self._alloc(sum(d for _, d in deficits))
        for slot, d in deficits:
            self.slot_pages[slot].extend(got[:d])
            got = got[d:]
        table = np.stack([self._table_row(s) for s in range(self.max_slots)])
        # into the table the engine's decode unit binds, never a new tensor
        self.slots.page_table.copy_(to_device(table, self.device))

    def _release(self, slot: int) -> None:
        self.free_pages.extend(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.tokens_seen[slot] = 0
        self.token_limit[slot] = 0
        self.reserved[slot] = 0
        self.slots.page_table[slot] = 0
        self.slots.active[slot] = False
        self.slots.done[slot] = True

    @torch.inference_mode()
    def step_begin(self, n_steps: int, chain_fn=None):
        """Enqueue one decode dispatch (the dense engine's contract), after
        growing the page tables to cover it.  Does not wait for the card."""
        if all(o is None for o in self.owner):
            return None
        n_steps = snap_to_ladder(n_steps, self.max_dispatch)
        self._ensure_pages(n_steps)
        for slot, req in enumerate(self.owner):
            if req is not None:
                self.steps_inflight[slot] += n_steps
        packed = self._decode(n_steps)
        return (chain_step_result(packed, chain_fn), chain_fn, n_steps, list(self.owner))

    def _decode(self, n_steps: int, capture_only: bool = False) -> Optional[torch.Tensor]:
        _, top_k, _ = self.sampling
        self.slots, packed = paged_decode_steps(
            self.params, self.slots, self.cfg, n_steps, self.generator, top_k, self.eos_ids,
            self.pad_id, self.greedy, self.vocab_slice, self.extra_ids, self.clone_allowed,
            capture_only, self.units,
        )
        return packed

    def step_commit(self, handle, fetched):
        # release this dispatch's in-flight step bookings before the shared
        # commit (tokens_seen takes the actual advance through the hook)
        n_steps = handle[2]
        for slot, req in enumerate(handle[3]):
            if req is not None:
                self.steps_inflight[slot] = max(int(self.steps_inflight[slot]) - n_steps, 0)
        return super().step_commit(handle, fetched)

    def _commit_slot_tokens(self, slot: int, n_valid: int) -> None:
        self.tokens_seen[slot] += n_valid

    @torch.inference_mode()
    def _commit_slot_done(self, slot: int) -> None:
        self._release(slot)

    @torch.inference_mode()
    def release_slot(self, slot: int) -> None:
        """Forcibly free a slot (failure containment): drops buffered tokens,
        returns its pages to the pool, deactivates it on the device."""
        req = self.owner[slot]
        if req is not None:
            self.buffers.pop(req, None)
            self.owner[slot] = None
        self.budget[slot] = 0
        self._release(slot)
