"""Weight-only int4 matvec: the hand-written CUDA kernel and its plain
version.

Replaces `int4_matvec` of `sparktts_tpu/kernels/int4_matmul.py`
(`_int4_matvec_kernel`): x (B, in) times the nibble-packed int4 weights
(in/2, out) of `lm/quant.quantize_linear_int4`, each group's fp32 partial
dot multiplied by its fp32 group scale, in x's dtype.  The kernel is
`csrc/int4_matmul.cu`; its header says how it is laid out, what bounds it on
an H100 and what the design does about it.

`int4_matvec` runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  Which rows take it is the caller's
choice (`nn/layers.linear_apply`: at most MAX_ROWS rows, the decode
shapes).  `launches` counts calls that launched the kernel; each such call
is two CUDA launches (the group partials, then their ordered sum).
"""

from __future__ import annotations

import ctypes

import torch

from sparktts_tpu_torch.kernels import build
from sparktts_tpu_torch.lm.quant import unpack_int4

SOURCE = "sparktts_tpu_torch/kernels/csrc/int4_matmul.cu"
REPLACES = "sparktts_tpu/kernels/int4_matmul.py:101"
MAX_ROWS = 32  # rows of x the kernel takes

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("int4_matmul").int4_matvec_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def int4_matvec_plain(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ unpack(packed) (in, out) with group scales: per group,
    the fp32 partial dot times the fp32 scale, summed over groups; returned
    in x's dtype.  (bf16 x times the small integer weights is exact in fp32,
    so this is the JAX package's bf16 product with fp32 accumulation.)  Any
    leading dims: the prefill path of `nn/layers.linear_apply` calls it
    directly."""
    g = gscale.shape[-2]
    d_in = 2 * packed.shape[-2]
    xg = x.float().reshape(*x.shape[:-1], g, d_in // g)
    wg = unpack_int4(packed).reshape(g, d_in // g, packed.shape[-1])
    partial = torch.einsum("...gi,gio->...go", xg, wg)
    return (partial * gscale).sum(dim=-2).to(x.dtype)


def int4_matvec(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (B, in) with B <= MAX_ROWS, packed (in/2, out) int8, gscale
    (G, out) fp32 -> (B, out) in x's dtype."""
    if x.device.type == "cpu":
        return int4_matvec_plain(x, packed, gscale)
    global launches
    if x.dim() != 2 or packed.dim() != 2 or gscale.dim() != 2:
        raise ValueError(f"int4_matvec: want x (B, in), packed (in/2, out), gscale (G, out); got "
                         f"{tuple(x.shape)} {tuple(packed.shape)} {tuple(gscale.shape)}")
    b, d_in = x.shape
    half, d_out = packed.shape
    groups = gscale.shape[0]
    if any(t.device != x.device for t in (packed, gscale)):
        raise ValueError("int4_matvec: x, packed and gscale must be on one device")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int8 or gscale.dtype != torch.float32:
        raise TypeError("int4_matvec: the CUDA kernel takes bf16 x, int8 packed, fp32 gscale")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"int4_matvec: the kernel takes 1..{MAX_ROWS} rows, got {b}")
    if d_in != 2 * half or gscale.shape[1] != d_out or d_in % groups or (d_in // groups) % 2:
        raise ValueError(f"int4_matvec: x {tuple(x.shape)}, packed {tuple(packed.shape)} and "
                         f"gscale {tuple(gscale.shape)} do not fit (in = 2 packed rows, even "
                         f"groups)")
    if not all(t.is_contiguous() for t in (x, packed, gscale)):
        raise ValueError("int4_matvec: x, packed and gscale must be contiguous")
    ws = torch.empty((groups, b, d_out), dtype=torch.float32, device=x.device)
    out = torch.empty((b, d_out), dtype=x.dtype, device=x.device)
    err = _kernel()(
        x.data_ptr(), packed.data_ptr(), gscale.data_ptr(), ws.data_ptr(), out.data_ptr(),
        b, d_in, d_out, groups, torch.cuda.current_stream(x.device).cuda_stream,
    )
    launches += 1
    if err != 0:
        raise RuntimeError(f"int4_matvec: CUDA launch failed with error {err}")
    return out
