"""The WaveGenerator's ResidualUnit: the hand-written CUDA kernel and its
plain version.

Replaces `fused_residual_unit` of `sparktts_tpu/kernels/vocoder_fusion.py`
(`_residual_unit_carry_kernel`, `_residual_unit_kernel`): on a (B, T, C)
fp32 tensor, x + conv1x1(snake2(conv_k7,dil(snake1(x)))), with zero padding
of 3 * dilation at the sequence edges.  The kernel is
`csrc/vocoder_fusion.cu`; its header says how it is laid out, what bounds it
on an H100 and what the design does about it.

`fused_residual_unit` runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  `launches` counts unit calls that
launched the kernel; each such call is two CUDA launches (the dilated conv,
then the 1x1), so a vocode's 12 unit calls are 24 launches on the device.
The kernel multiplies in 3xTF32 on the tensor cores; `residual_unit_3xtf32_plain`
is a CPU model of that arithmetic, for the tests.

While `torch.export` traces (`torch.compiler.is_exporting()`), the wrapper
records its `sparktts_torch::` custom op (`kernels/ops.py`) instead, so that
an exported program runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import build, ops
from sparktts_tpu_torch.nn.layers import conv1d_apply, snake_apply

SOURCE = "sparktts_tpu_torch/kernels/csrc/vocoder_fusion.cu"
REPLACES = "sparktts_tpu/kernels/vocoder_fusion.py:217"
CHANNEL_TILE = 96  # the kernel takes C a multiple of this

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("vocoder_fusion").fused_residual_unit_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_residual_unit_plain(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """snake -> dilated k7 conv -> snake -> 1x1 conv, plus x; (B, T, C)."""
    y = snake_apply(p["snake1"], x)
    y = conv1d_apply(p["conv1"], y, padding=3 * dilation, dilation=dilation)
    y = snake_apply(p["snake2"], y)
    y = conv1d_apply(p["conv2"], y)
    return x + y


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (10 explicit mantissa bits), ties away
    from zero, as `cvt.rna.tf32.f32` rounds: half a tf32 ulp added to the
    magnitude's bits, the 13 low bits cleared."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand split into tf32 hi + lo parts: lo.hi + hi.lo +
    hi.hi in fp32 (the products of tf32 values are exact in fp32)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def residual_unit_3xtf32_plain(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """The unit in the kernel's arithmetic: both convolutions as sums of
    3xTF32 products in fp32, seven row-shifted taps over the zero-padded
    snake1 strip; biases and snakes as in the plain version.  (B, T, C)."""
    t, pad = x.shape[1], 3 * dilation
    y = F.pad(snake_apply(p["snake1"], x), (0, 0, pad, pad))
    w1 = p["conv1"]["w"]
    acc = sum(_mm_3xtf32(y[:, k * dilation:k * dilation + t], w1[k]) for k in range(7))
    z = snake_apply(p["snake2"], acc + p["conv1"]["b"])
    return x + (_mm_3xtf32(z, p["conv2"]["w"][0]) + p["conv2"]["b"])


def fused_residual_unit(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """One ResidualUnit on a (B, T, C) tensor; params in the JAX layout."""
    if torch.compiler.is_exporting():  # an export records the op (kernels/ops.py)
        return ops.fused_residual_unit(x, p["snake1"]["alpha"], p["conv1"]["w"],
                                       p["conv1"]["b"], p["snake2"]["alpha"],
                                       p["conv2"]["w"], p["conv2"]["b"], int(dilation))
    if x.device.type == "cpu":
        return fused_residual_unit_plain(p, x, dilation)
    global launches
    w1, b1, w2, b2 = p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"]
    a1, a2 = p["snake1"]["alpha"], p["snake2"]["alpha"]
    tensors = (x, a1, w1, b1, a2, w2, b2)
    if x.dim() != 3:
        raise ValueError(f"fused_residual_unit: x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    if any(v.device != x.device for v in tensors):
        raise ValueError("fused_residual_unit: x and the params must be on one device")
    if any(v.dtype != torch.float32 for v in tensors):
        raise TypeError("fused_residual_unit: the CUDA kernel takes fp32 x and params")
    if c % CHANNEL_TILE or b < 1 or t < 1:
        raise ValueError(f"fused_residual_unit: the kernel is built for C a multiple of "
                         f"{CHANNEL_TILE}, got x {tuple(x.shape)}")
    if (w1.shape != (7, c, c) or w2.shape != (1, c, c)
            or any(v.shape != (c,) for v in (a1, b1, a2, b2))):
        raise ValueError(f"fused_residual_unit: params do not fit C = {c}")
    if int(dilation) < 1:
        raise ValueError(f"fused_residual_unit: dilation {dilation}")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("fused_residual_unit: x and the params must be contiguous")
    if any(v.data_ptr() % 16 for v in (x, w1, w2, a1)):
        raise ValueError("fused_residual_unit: x, the weights and alpha1 must be 16-byte aligned")
    z = torch.empty_like(x)
    out = torch.empty_like(x)
    fn = _kernel()
    with build.launch_stream(x) as stream:
        err = fn(
            x.data_ptr(), a1.data_ptr(), w1.data_ptr(), b1.data_ptr(), a2.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), z.data_ptr(), out.data_ptr(), b, t, c, int(dilation),
            stream,
        )
    launches += 1
    build.note_launch("fused_residual_unit")
    if err != 0:
        raise RuntimeError(f"fused_residual_unit: CUDA launch failed with error {err}")
    return out
