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

_CHUNK = 2048  # per-chunk width of `topk_two_stage`

Generators = Union[torch.Generator, Sequence[torch.Generator]]
#: A float for the whole batch, or a (B, 1) tensor: one value per row (the
#: continuous engines keep each request's temperature and top_p per slot).
PerRow = Union[float, torch.Tensor]


def topk_two_stage(x: torch.Tensor, k: int):
    """Exact top-k over a large last axis in two stages: a top-k in each
    chunk of max(2048, k) columns (the last padded with NEG_INF), then a
    top-k over the chunk winners.  Exact because every element of the global
    top-k is in its own chunk's top-k.  A utility, as in the JAX package: the
    sampler takes the flat `torch.topk`.  Returns (values, indices) (B, k),
    indices int64."""
    b, v = x.shape
    c = max(_CHUNK, k)
    n = -(-v // c)
    pad = n * c - v
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=NEG_INF)
    vals1, idx1 = torch.topk(x.reshape(b, n, c), k, dim=-1)    # (B, n, k)
    vals2, pos = torch.topk(vals1.reshape(b, n * k), k, dim=-1)  # over the chunk winners
    within = torch.gather(idx1.reshape(b, n * k), 1, pos)
    return vals2, torch.div(pos, k, rounding_mode="floor") * c + within


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
