"""Factorized VQ: semantic token ids -> quantized latents.

Port of `fvq_detokenize` of `sparktts_tpu/codec/fvq.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.nn.layers import linear_apply


def fvq_detokenize(p, indices: torch.Tensor) -> torch.Tensor:
    """(B, T) indices -> (B, T, input_dim) quantized latents."""
    z_q = F.embedding(indices.long(), p["codebook"])
    if "out_project" in p:
        z_q = linear_apply(p["out_project"], z_q)
    return z_q
