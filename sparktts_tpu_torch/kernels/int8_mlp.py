"""Fused weight-only int8 SwiGLU MLP for decode rows: the hand-written CUDA
kernel and its plain version.

Replaces `int8_mlp_matvec` of `sparktts_tpu/kernels/int8_mlp.py`
(`_mlp_kernel`): silu(x Wg sg) * (x Wu su) Wd sd on int8 weights with fp32
per-column scales, rounded to x's dtype at the same places as the unfused
int8 path (`nn/layers.linear_apply` + `lm/qwen.mlp_block`).  The kernel is
`csrc/int8_mlp.cu`; its header says how it is laid out, what bounds it on an
H100 and what the design does about it.

`int8_mlp_matvec` runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  Which calls take it is the
caller's choice (`lm/qwen.mlp_block`: decode steps of at most MAX_ROWS
rows).  `launches` counts calls that launched the kernel; each such call is
three CUDA launches (gate/up + SwiGLU, down partials, their ordered sum).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import build

SOURCE = "sparktts_tpu_torch/kernels/csrc/int8_mlp.cu"
REPLACES = "sparktts_tpu/kernels/int8_mlp.py:107"
MAX_ROWS = 16  # rows of x the kernel takes
DOWN_ROWS_PER_SPLIT = 256  # rows of down_q per block of the kernel's down pass

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("int8_mlp").int8_mlp_matvec_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def int8_mlp_matvec_plain(
    x: torch.Tensor,           # (R, K)
    gu_q: torch.Tensor,        # (K, 2I) int8: gate columns, then up columns
    gu_scale: torch.Tensor,    # (2I,) fp32
    down_q: torch.Tensor,      # (I, K) int8
    down_scale: torch.Tensor,  # (K,) fp32
) -> torch.Tensor:
    """The kernel's arithmetic, with dt = x.dtype: each dot is x times the
    int8 weight (exact in fp32) summed in fp32; g and u are rounded to dt,
    times their dt-rounded scales, rounded to dt; h = dt(dt(silu(g)) * u)
    with silu in fp32; the down dot is rounded to dt, times the dt-rounded
    scale, rounded to dt."""
    dt = x.dtype
    i = down_q.shape[0]
    gu = x.float() @ gu_q.float()
    g = gu[:, :i].to(dt) * gu_scale[:i].to(dt)
    u = gu[:, i:].to(dt) * gu_scale[i:].to(dt)
    h = F.silu(g.float()).to(dt) * u
    return (h.float() @ down_q.float()).to(dt) * down_scale.to(dt)


def int8_mlp_matvec(
    x: torch.Tensor,
    gu_q: torch.Tensor,
    gu_scale: torch.Tensor,
    down_q: torch.Tensor,
    down_scale: torch.Tensor,
) -> torch.Tensor:
    """x (R, K) with R <= MAX_ROWS -> (R, K) in x's dtype."""
    if x.device.type == "cpu":
        return int8_mlp_matvec_plain(x, gu_q, gu_scale, down_q, down_scale)
    global launches
    tensors = (x, gu_q, gu_scale, down_q, down_scale)
    if x.dim() != 2 or gu_q.dim() != 2 or down_q.dim() != 2:
        raise ValueError(f"int8_mlp_matvec: want x (R, K), gu_q (K, 2I), down_q (I, K); got "
                         f"{tuple(x.shape)} {tuple(gu_q.shape)} {tuple(down_q.shape)}")
    r, k = x.shape
    i = down_q.shape[0]
    if any(t.device != x.device for t in tensors):
        raise ValueError("int8_mlp_matvec: x and the weights must be on one device")
    if (x.dtype != torch.bfloat16 or gu_q.dtype != torch.int8 or down_q.dtype != torch.int8
            or gu_scale.dtype != torch.float32 or down_scale.dtype != torch.float32):
        raise TypeError("int8_mlp_matvec: the CUDA kernel takes bf16 x, int8 weights and fp32 "
                        "scales")
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"int8_mlp_matvec: the kernel takes 1..{MAX_ROWS} rows, got {r}")
    if (gu_q.shape != (k, 2 * i) or down_q.shape != (i, k) or gu_scale.shape != (2 * i,)
            or down_scale.shape != (k,)):
        raise ValueError(f"int8_mlp_matvec: shapes do not fit x {tuple(x.shape)}: gu_q "
                         f"{tuple(gu_q.shape)}, gu_scale {tuple(gu_scale.shape)}, down_q "
                         f"{tuple(down_q.shape)}, down_scale {tuple(down_scale.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_mlp_matvec: x, the weights and the scales must be contiguous")
    splits = -(-i // DOWN_ROWS_PER_SPLIT)
    h = torch.empty((r, i), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, r, k), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _kernel()(
        x.data_ptr(), gu_q.data_ptr(), gu_scale.data_ptr(), down_q.data_ptr(),
        down_scale.data_ptr(), h.data_ptr(), ws.data_ptr(), out.data_ptr(), r, k, i,
        DOWN_ROWS_PER_SPLIT, torch.cuda.current_stream(x.device).cuda_stream,
    )
    launches += 1
    if err != 0:
        raise RuntimeError(f"int8_mlp_matvec: CUDA launch failed with error {err}")
    return out
