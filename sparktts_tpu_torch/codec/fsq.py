"""Finite scalar quantization: index -> code side of the residual FSQ that
holds the global speaker tokens.

Port of the decode half of `sparktts_tpu/codec/fsq.py`
(`fsq_indices_to_codes`, `residual_fsq_scales`,
`residual_fsq_output_from_indices`).  Code arithmetic runs in fp32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sparktts_tpu_torch.nn.layers import linear_apply


def _basis(levels: Sequence[int]) -> np.ndarray:
    return np.cumprod(np.asarray([1] + list(levels[:-1]), dtype=np.int64))


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
