"""Finite scalar quantization and its residual stack: the global speaker
tokens.

Port of `sparktts_tpu/codec/fsq.py`: quantization (`fsq_bound`,
`fsq_quantize`, `fsq_codes_to_indices`, `fsq_forward`,
`residual_fsq_apply`) and the index -> code side
(`fsq_indices_to_codes`, `residual_fsq_output_from_indices`).  Code
arithmetic runs in fp32 whatever the surrounding dtype; `torch.round`
rounds half to even, as `jnp.round` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.nn.layers import linear_apply


def _basis(levels: Sequence[int]) -> np.ndarray:
    return np.cumprod(np.asarray([1] + list(levels[:-1]), dtype=np.int64))


def fsq_bound(z: torch.Tensor, levels: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    """tanh bound, shifted by atanh(0.5 / half_l) for even levels."""
    lv = torch.as_tensor(np.asarray(levels, np.float32), device=z.device)
    half_l = (lv - 1) * (1 + eps) / 2
    offset = torch.where(lv % 2 == 0, 0.5, 0.0)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Round to the level grid, renormalised to [-1, 1]; fp32 codes."""
    quantized = torch.round(fsq_bound(z.float(), levels))
    half_width = torch.as_tensor(np.asarray(levels, np.int64) // 2, device=z.device).float()
    return quantized / half_width


def fsq_codes_to_indices(codes: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Normalised codes -> mixed-radix flat index (int64)."""
    half_width = torch.as_tensor(np.asarray(levels, np.int64) // 2, device=codes.device).float()
    basis = torch.as_tensor(_basis(levels), device=codes.device).float()
    zhat = codes * half_width + half_width
    return torch.sum(zhat * basis, dim=-1).long()


def fsq_forward(z: torch.Tensor, levels: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """z: (..., len(levels)) -> (fp32 codes of the same shape, indices (...))."""
    codes = fsq_quantize(z, levels)
    return codes, fsq_codes_to_indices(codes, levels)


def fsq_indices_to_codes(indices: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Flat mixed-radix index -> normalized codes in [-1, 1], (..., len(levels))."""
    lv = torch.as_tensor(np.asarray(levels, np.int64), device=indices.device)
    basis = torch.as_tensor(_basis(levels), device=indices.device)
    level_indices = torch.div(indices.long()[..., None], basis, rounding_mode="floor") % lv
    half_width = (lv // 2).float()
    return (level_indices.float() - half_width) / half_width


def residual_fsq_scales(levels: Sequence[int], num_quantizers: int) -> np.ndarray:
    """Per-quantizer code scales: (levels - 1) ** -q."""
    lv = np.asarray(levels, dtype=np.float64)
    return np.stack([(lv - 1.0) ** (-q) for q in range(num_quantizers)]).astype(np.float32)


def residual_fsq_apply(
    p, x: torch.Tensor, levels: Sequence[int], num_quantizers: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, N, dim) -> (quantized (B, N, dim) in x.dtype, indices (B, N, Q))."""
    orig_dtype = x.dtype
    if "project_in" in p:
        x = linear_apply(p["project_in"], x)
    x = x.float()
    scales = torch.as_tensor(residual_fsq_scales(levels, num_quantizers), device=x.device)
    quantized_out = torch.zeros_like(x)
    residual = x
    all_indices = []
    for q in range(num_quantizers):
        codes, indices = fsq_forward(residual / scales[q], levels)
        quantized = codes * scales[q]
        residual = residual - quantized
        quantized_out = quantized_out + quantized
        all_indices.append(indices)
    if "project_out" in p:
        quantized_out = linear_apply(p["project_out"], quantized_out)
    return quantized_out.to(orig_dtype), torch.stack(all_indices, dim=-1)


def residual_fsq_output_from_indices(
    p, indices: torch.Tensor, levels: Sequence[int], num_quantizers: int
) -> torch.Tensor:
    """indices (B, N, Q) -> (B, N, dim): summed scaled codes, projected out."""
    scales = torch.as_tensor(residual_fsq_scales(levels, num_quantizers), device=indices.device)
    total = None
    for q in range(num_quantizers):
        codes = fsq_indices_to_codes(indices[..., q], levels) * scales[q]
        total = codes if total is None else total + codes
    if "project_out" in p:
        total = linear_apply(p["project_out"], total)
    return total
