"""Draft-model self-distillation for speculative decoding.

Port of `sparktts_tpu/lm/distill.py`: train a small draft LM on sequences
sampled from the target itself (`sample_target_corpus`), then plug it into
`lm/speculative.py`, whose greedy output is the target's whatever the draft
proposes, so a better draft only raises the acceptance rate.

The corpus comes from the port's `generate` (on the card the prefill
through the flash attention kernel, the decode steps through the decode
attention kernel, which take bf16 trees with 64-wide heads), the draft
trains with `lm/train.py`'s step, and `measure_acceptance` runs
`speculative_generate_greedy`.  Prompts and the batch order come from a
`torch.Generator` seeded by `seed`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.lm.speculative import speculative_generate_greedy
from sparktts_tpu_torch.lm.train import init_train_state, make_optimizer, map_tree, train_step
from sparktts_tpu_torch.utils.platform import require_device
from sparktts_tpu_torch.weights import init_qwen, to_torch


def _float_dtype(params) -> torch.dtype:
    """The dtype a (possibly quantized) LM tree computes in: its norm gains'."""
    return params["final_ln"]["gamma"].dtype


def sample_target_corpus(
    target_params,
    cfg: QwenConfig,
    rng: torch.Generator,
    n_seqs: int,
    prompt_len: int,
    gen_len: int,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 1.0,
    greedy: bool = False,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
    prompts=None,
) -> np.ndarray:
    """(n_seqs, prompt_len + gen_len) int64 sequences: prompts continued by
    the target, the draft's training data.  The prompts are drawn from `rng`
    (uniform over the vocabulary, or `vocab_slice`) unless given; the target
    runs on `rng`'s device and samples from it."""
    dev = rng.device
    if prompts is None:
        lo, hi = (0, cfg.vocab_size) if vocab_slice is None else vocab_slice
        prompts = torch.randint(lo, hi, (n_seqs, prompt_len), generator=rng, device=dev)
    prompts = torch.as_tensor(prompts, device=dev).long()
    mask = torch.ones(prompts.shape, dtype=torch.bool, device=dev)
    units = graphs.UnitCache("sample_target_corpus")
    toks, _ = generate(
        target_params, cfg, prompts, mask, rng, max_new_tokens=gen_len,
        cache_len=prompt_len + gen_len, temperature=temperature, top_k=top_k, top_p=top_p,
        eos_ids=(), pad_id=0, greedy=greedy, vocab_slice=vocab_slice, extra_ids=extra_ids,
        units=units,
    )
    units.clear()
    return torch.cat([prompts, toks], dim=1).cpu().numpy()


def distill_draft(
    target_params,
    cfg: QwenConfig,
    draft_cfg: QwenConfig,
    steps: int = 200,
    batch: int = 8,
    prompt_len: int = 4,
    gen_len: int = 28,
    corpus_seqs: int = 256,
    learning_rate: float = 3e-3,
    seed: int = 0,
    greedy_teacher: bool = True,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
    draft_params: Optional[dict] = None,
    temperature: float = 1.0,
    device="cuda",
):
    """Train a draft LM (fp32) to imitate the target on target-generated
    sequences.  Returns (draft_params, loss_curve), the curve the per-step
    cross entropy over the generated region only (the prompt is random
    noise).  A healthy run descends; a flat-zero curve means a degenerate
    teacher corpus (`corpus_stats`), a property of the teacher."""
    dev = require_device(device, "distill_draft")
    rng = torch.Generator(device=dev).manual_seed(seed)
    target = to_torch(target_params, dev, _float_dtype(target_params))
    corpus = sample_target_corpus(
        target, cfg, rng, corpus_seqs, prompt_len, gen_len, greedy=greedy_teacher,
        temperature=temperature, vocab_slice=vocab_slice, extra_ids=extra_ids,
    )
    if draft_params is None:
        draft_params = init_qwen(draft_cfg, rng, dtype=torch.float32, device=dev)
    state = init_train_state(draft_params, make_optimizer(learning_rate), dev)
    loss_mask = torch.zeros((batch, corpus.shape[1]), dtype=torch.bool, device=dev)
    loss_mask[:, prompt_len:] = True  # learn only the target's continuations
    order = torch.randint(0, corpus.shape[0], (steps, batch), generator=rng, device=dev)
    corpus = torch.as_tensor(corpus, device=dev)
    losses: List[torch.Tensor] = []
    for i in range(steps):
        state, loss = train_step(state, draft_cfg, corpus[order[i]], loss_mask)
        losses.append(loss)
    curve = torch.stack(losses).tolist() if losses else []
    return map_tree(state.params, torch.Tensor.detach), curve


def corpus_stats(corpus: np.ndarray, prompt_len: int) -> dict:
    """Degeneracy diagnostics of a teacher corpus: a greedy teacher with
    random weights typically collapses onto one token (`top_token_share`
    near 1), often a different one per prompt (`constant_seq_share`, the
    share of sequences whose generated region is one repeated token)."""
    gen = np.asarray(corpus)[:, prompt_len:]
    flat = gen.reshape(-1)
    uniq, counts = np.unique(flat, return_counts=True)
    per_seq_constant = (gen == gen[:, :1]).all(axis=1)
    return {
        "unique_tokens": int(uniq.size),
        "top_token_share": round(float(counts.max()) / flat.size, 4),
        "constant_seq_share": round(float(per_seq_constant.mean()), 4),
        "gen_tokens": int(flat.size),
    }


def make_cycler_teacher(h: int = 32, shift: int = 1, num_attention_heads: int = 2,
                        num_key_value_heads: int = 1, head_dim: int = 4,
                        dtype: torch.dtype = torch.float32, device="cuda"):
    """Hand-built deterministic teacher whose greedy map is token i ->
    i + shift (mod h): non-constant, fully predictable, not learnable by
    luck.  Hidden = vocab with an identity embedding, attention zeroed, and
    the MLP's saturated gate adds (e_{i+shift} - e_i) to the residual.  The
    JAX package's teacher at the default heads; since its attention is
    zeroed, any head layout gives the same map, and on the card one the
    attention kernels take (14, 2, 64 as Qwen2.5-0.5B, in bf16) lets the
    teacher run through them.  Returns (params, cfg)."""
    dev = require_device(device, "make_cycler_teacher")
    eye = torch.eye(h, dtype=torch.float32, device=dev)
    w_u = torch.roll(eye, shift, dims=1) - eye  # e_i -> e_{i+shift} - e_i
    qkv = (num_attention_heads + 2 * num_key_value_heads) * head_dim

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    layer = {
        "ln1": {"gamma": torch.ones(h, device=dev)},
        "qkv": {"w": zeros(h, qkv), "b": zeros(qkv)},
        "o": {"w": zeros(num_attention_heads * head_dim, h)},
        "ln2": {"gamma": torch.ones(h, device=dev)},
        "gateup": {"w": torch.cat([10.0 * torch.ones(h, h, device=dev), w_u], dim=1)},
        "down": {"w": eye / (10.0 * h)},
    }
    params = {
        "embed": eye,
        "layers": {name: {k: t[None] for k, t in sub.items()} for name, sub in layer.items()},
        "final_ln": {"gamma": torch.ones(h, device=dev)},
    }
    cfg = QwenConfig(
        vocab_size=h, hidden_size=h, intermediate_size=h, num_hidden_layers=1,
        num_attention_heads=num_attention_heads, num_key_value_heads=num_key_value_heads,
        head_dim=head_dim, eos_token_id=h - 1, pad_token_id=0,
    )
    return to_torch(params, dev, dtype), cfg


def measure_acceptance(
    target_params,
    draft_params,
    cfg: QwenConfig,
    draft_cfg: QwenConfig,
    n_prompts: int = 8,
    prompt_len: int = 4,
    gen_len: int = 32,
    k: int = 4,
    seed: int = 0,
    vocab_slice: Tuple[int, int] | None = None,
    extra_ids: Tuple[int, ...] = (),
    device="cuda",
) -> float:
    """Greedy speculative acceptance rate: accepted drafts / emitted tokens
    (0: every proposal rejected; (k - 1) / k: a perfect draft).  The draft
    runs in the target's dtype (the speculative rounds share one cache
    dtype, and on the card the decode kernel takes bf16)."""
    dev = require_device(device, "measure_acceptance")
    dtype = _float_dtype(target_params)
    target = to_torch(target_params, dev, dtype)
    draft = to_torch(draft_params, dev, dtype)
    rng = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = (0, cfg.vocab_size) if vocab_slice is None else vocab_slice
    units = graphs.UnitCache("measure_acceptance")
    accepted = emitted = 0
    for _ in range(n_prompts):
        ids = torch.randint(lo, hi, (1, prompt_len), generator=rng, device=dev)
        _, lengths, acc = speculative_generate_greedy(
            target, draft, cfg, draft_cfg, ids,
            torch.ones((1, prompt_len), dtype=torch.bool, device=dev),
            max_new_tokens=gen_len, cache_len=prompt_len + gen_len + k, k=k,
            eos_ids=(), pad_id=0, vocab_slice=vocab_slice, extra_ids=extra_ids, units=units,
        )
        accepted += int(acc)
        emitted += int(lengths.sum())
    units.clear()
    return accepted / max(emitted, 1)
