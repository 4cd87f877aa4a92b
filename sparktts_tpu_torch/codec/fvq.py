"""Factorized VQ: the semantic token codebook.

Port of `fvq_tokenize`, `fvq_detokenize` and the eval forward `fvq_forward`
(with its codebook usage statistics) of `sparktts_tpu/codec/fvq.py`.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.nn.layers import linear_apply


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps): the JAX package's formula, which is not
    `F.normalize`'s (that one clamps the norm instead)."""
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def fvq_nearest_indices(p, z_e: torch.Tensor) -> torch.Tensor:
    """Nearest code by cosine similarity (argmin distance between
    L2-normalised vectors).  z_e: (B, T, codebook_dim) -> (B, T) int64;
    a tie goes to the first maximum, as `jnp.argmax` does."""
    enc = _l2_normalize(z_e.float())
    cb = _l2_normalize(p["codebook"].float())
    sim = torch.einsum("btd,kd->btk", enc, cb)
    return torch.argmax(sim, dim=-1)


def fvq_tokenize(p, z: torch.Tensor) -> torch.Tensor:
    """(B, T, input_dim) encoder latents -> (B, T) code indices."""
    z_e = linear_apply(p["in_project"], z) if "in_project" in p else z
    return fvq_nearest_indices(p, z_e)


def fvq_detokenize(p, indices: torch.Tensor) -> torch.Tensor:
    """(B, T) indices -> (B, T, input_dim) quantized latents."""
    z_q = F.embedding(indices.long(), p["codebook"])
    if "out_project" in p:
        z_q = linear_apply(p["out_project"], z_q)
    return z_q


def fvq_forward(p, z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Eval forward: quantize and project out, plus the codebook's usage
    over the batch: `perplexity` of the code histogram and `active_num`, the
    count of codes used (fp32 scalars)."""
    z_e = linear_apply(p["in_project"], z) if "in_project" in p else z
    indices = fvq_nearest_indices(p, z_e)
    z_q = fvq_detokenize(p, indices)
    counts = torch.bincount(indices.reshape(-1), minlength=p["codebook"].shape[0]).float()
    avg_probs = counts / indices.numel()
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return {
        "z_q": z_q,
        "indices": indices,
        "perplexity": perplexity,
        "active_num": (counts > 0).sum().float(),
    }
