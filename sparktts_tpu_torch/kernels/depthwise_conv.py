"""The codec's depthwise fp32 convolutions: the hand-written CUDA kernel
(kernel 8), its plain versions and a CPU model of its index math.

No Pallas kernel stands behind it: the JAX package leaves grouped
convolutions to XLA (`sparktts_tpu/nn/layers.py`, `conv_general_dilated`
with `feature_group_count`).  On the card they would otherwise be cuDNN
calls; the kernel (`csrc/depthwise_conv.cu`) sums each output element's taps
by `fmaf` in tap order, the same way wherever the element lies.

  * `conv1d(x, w, bias, scale, stride, padding, dilation)`: groups = C on
    x (B, T, C) with the stored kernel (K, 1, C) (the Vocos dwconv, the feat
    encoder's strided downsampler);
  * `conv_transpose1d(x, w, bias, scale, stride, padding, output_padding)`:
    the depthwise ConvTranspose1d of the prenet's upsampler, with the stored
    flipped kernel (K, 1, C).

`scale` (an int8 kernel's) multiplies before the bias.  Each runs its plain
version (today's PyTorch code) for CPU tensors only; for CUDA tensors it
launches the kernel or raises.  `nn/layers.py` routes a depthwise
convolution here inside a `codec_fp32()` scope.  `launches` counts calls
that launched the kernel, one CUDA launch each.  While `torch.export`
traces, each records its `sparktts_torch::` op (`kernels/ops.py`) instead.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import build, ops
from sparktts_tpu_torch.kernels.codec_gemm import conv1d_plain, conv_transpose1d_plain

SOURCE = "sparktts_tpu_torch/kernels/csrc/depthwise_conv.cu"
REPLACES = "sparktts_tpu/nn/layers.py:144"  # XLA's grouped convolution; no Pallas kernel

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("depthwise_conv").depthwise_conv1d_f32
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv1d_plain_dw(x, w, bias=None, scale=None, stride: int = 1, padding: int = 0,
                    dilation: int = 1) -> torch.Tensor:
    """The plain version: `F.conv1d` with groups = channels."""
    return conv1d_plain(x, w, bias, scale, stride, padding, dilation, groups=x.shape[-1])


def conv_transpose1d_plain_dw(x, w, bias=None, scale=None, stride: int = 1, padding: int = 0,
                              output_padding: int = 0) -> torch.Tensor:
    """The plain version: `F.conv_transpose1d` with groups = channels."""
    return conv_transpose1d_plain(x, w, bias, scale, stride, padding, output_padding,
                                  groups=x.shape[-1])


def conv1d_model(x, w, bias=None, scale=None, stride: int = 1, padding: int = 0,
                 dilation: int = 1, transposed: bool = False,
                 output_padding: int = 0) -> torch.Tensor:
    """The kernel's index math on the CPU: per output element, the taps in
    increasing order (for the transposed form, d = 0, 1, ... over the stored
    taps K - 1 - phi - s d), each x element times its channel's weight."""
    b, t, c = x.shape
    k = w.shape[0]
    xp = F.pad(x.float(), (0, 0, 0, 1))  # row t: the zero read for a tap off the sequence
    if not transposed:
        t_out = (t + 2 * padding - dilation * (k - 1) - 1) // stride + 1
        rows = torch.arange(t_out) * stride - padding
        taps = [(rows + tap * dilation, torch.full_like(rows, tap)) for tap in range(k)]
    else:
        t_out = (t - 1) * stride - 2 * padding + k + output_padding
        o = torch.arange(t_out) + padding
        u, phi = torch.div(o, stride, rounding_mode="floor"), o % stride
        taps = [(u - d, k - 1 - phi - stride * d) for d in range(-(-k // stride))]
    y = x.new_zeros((b, t_out, c), dtype=torch.float32)
    for src, tap in taps:
        ok = (src >= 0) & (src < t) & (tap >= 0)
        src = torch.where(ok, src, t)
        y = y + xp[:, src] * (w[tap.clamp(0, k - 1), 0] * ok[:, None])
    if scale is not None:
        y = y * scale
    return y if bias is None else y + bias


def _launch(x, w, bias, scale, stride, padding, dilation, t_out, transposed, name):
    x = x.to(w.dtype)
    tensors = [v for v in (x, w, bias, scale) if v is not None]
    if any(v.device != x.device for v in tensors):
        raise ValueError(f"{name}: x, the weights, bias and scale must be on one device")
    if any(v.dtype != torch.float32 for v in tensors):
        raise TypeError(f"{name}: the CUDA kernel takes fp32 tensors")
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != 1 or w.shape[2] != x.shape[2]:
        raise ValueError(f"{name}: want x (B, T, C) and w (K, 1, C), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if not w.is_contiguous() or any(v is not None and (v.shape != (x.shape[2],)
                                                       or not v.is_contiguous())
                                    for v in (bias, scale)):
        raise ValueError(f"{name}: w, bias and scale must be contiguous, bias and scale (C,)")
    b, t, c = x.shape
    if t_out < 1 or b < 1 or min(stride, dilation) < 1 or padding < 0:
        raise ValueError(f"{name}: x {tuple(x.shape)}, stride {stride}, padding {padding}, "
                         f"dilation {dilation}")
    y = torch.empty((b, t_out, c), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with build.launch_stream(x) as stream:
        err = fn(x.data_ptr(), *x.stride(), w.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(), b, t, c, w.shape[0],
                 t_out, stride, padding, dilation, int(transposed), stream)
    global launches
    launches += 1
    build.note_launch("depthwise_conv")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    return y


def conv1d(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, stride: int = 1,
           padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """Depthwise conv: x (B, T, C), w (K, 1, C) -> (B, T', C)."""
    if torch.compiler.is_exporting():  # an export records the op (kernels/ops.py)
        return ops.depthwise_conv1d(x, w, bias, scale, stride, padding, dilation, False, 0)
    if x.device.type == "cpu":
        return conv1d_plain_dw(x, w, bias, scale, stride, padding, dilation)
    k = w.shape[0]
    t_out = (x.shape[1] + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    return _launch(x, w, bias, scale, stride, padding, dilation, t_out, False,
                   "depthwise conv1d")


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """Depthwise ConvTranspose1d, torch semantics: x (B, T, C), the stored
    flipped kernel (K, 1, C) -> (B, (T - 1) s - 2 p + K + output_padding, C)."""
    if torch.compiler.is_exporting():
        return ops.depthwise_conv1d(x, w, bias, scale, stride, padding, 1, True, output_padding)
    if x.device.type == "cpu":
        return conv_transpose1d_plain_dw(x, w, bias, scale, stride, padding, output_padding)
    t_out = (x.shape[1] - 1) * stride - 2 * padding + w.shape[0] + output_padding
    return _launch(x, w, bias, scale, stride, padding, 1, t_out, True,
                   "depthwise conv_transpose1d")
