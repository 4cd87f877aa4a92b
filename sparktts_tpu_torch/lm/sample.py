"""Token sampling: temperature -> top-k -> top-p (within the top-k) ->
categorical, HF semantics.

Port of `sparktts_tpu/lm/sample.py`.  Random numbers come from an explicit
`torch.Generator`, or from one generator per batch row: a row's draws then
depend only on its own generator, so its sample stream does not change with
the rest of the batch.  `jax.random` and torch give different numbers from
the same seed, so the two packages agree in distribution (`warped_probs`),
not in the tokens drawn.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

NEG_INF = -1e9

Generators = Union[torch.Generator, Sequence[torch.Generator]]
#: A float for the whole batch, or a (B, 1) tensor: one value per row (the
#: continuous engines keep each request's temperature and top_p per slot).
PerRow = Union[float, torch.Tensor]


def _warp(logits: torch.Tensor, temperature: PerRow, top_k: int, top_p: PerRow):
    """(filtered top-k logits with NEG_INF outside the nucleus, their ids)."""
    scaled = logits / temperature
    top_k = min(top_k, logits.shape[-1])
    vals, idx = torch.topk(scaled, top_k, dim=-1)  # descending
    probs = torch.softmax(vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep[:, 0] = True
    return torch.where(keep, vals, NEG_INF), idx


def _uniform(generator: Generators, shape, device) -> torch.Tensor:
    if isinstance(generator, torch.Generator):
        return torch.rand(shape, generator=generator, device=device)
    if len(generator) != shape[0]:
        raise ValueError(f"got {len(generator)} generators for a batch of {shape[0]}")
    return torch.stack([torch.rand(shape[1:], generator=g, device=device) for g in generator])


def sample_token(
    generator: Generators,
    logits: torch.Tensor,   # (B, V) fp32
    temperature: PerRow,
    top_k: int,
    top_p: PerRow,
) -> torch.Tensor:
    """Sampled ids (B,) int64, drawn by the Gumbel-max trick over the warped
    top-k support (the form `jax.random.categorical` uses)."""
    filtered, idx = _warp(logits, temperature, top_k, top_p)
    u = _uniform(generator, filtered.shape, logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2**-24)))
    choice = torch.argmax(filtered + gumbel, dim=-1, keepdim=True)
    return torch.gather(idx, 1, choice)[:, 0]


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def warped_probs(
    logits: torch.Tensor, temperature: PerRow, top_k: int, top_p: PerRow
) -> torch.Tensor:
    """The full (B, V) distribution `sample_token` draws from (zero outside
    the warped support)."""
    filtered, idx = _warp(logits, temperature, top_k, top_p)
    kept = torch.softmax(filtered, dim=-1)
    return torch.zeros_like(logits).scatter(1, idx, kept)
