"""Functional NN primitives on channels-last `(B, T, C)` tensors.

Port of `sparktts_tpu/nn/layers.py`, plus `codec_fp32`, the scope in which
the codec's convolutions and matrix products run on kernels of the port's
own.  Params are plain dicts of tensors with the JAX package's keys and
layouts:

  * linear weights are `(in, out)`;
  * conv kernels are WIO `(K, Cin // groups, Cout)`;
  * transposed-conv kernels are the equivalent forward-conv kernel, stored
    spatially FLIPPED relative to torch's `ConvTranspose1d` weight.

The `F.conv*` calls below undo those layouts per call, so one param tree
serves both packages.  Weight-only quantized params (`lm/quant.py`,
`codec/quant.py`) take their own paths: int8 `{"w_q", "scale"}` computes in
the activation dtype with the scale on the output, before the bias; int4
`{"w_p4", "gscale"}` linears go through `kernels/int4_matmul.py`.

Inside a `codec_fp32()` scope, `linear_apply`, `conv1d_apply`,
`conv_transpose1d_apply` and `matmul` send float and int8 weights to the
codec's kernels (`kernels/codec_gemm.py`, `kernels/depthwise_conv.py`): on
the card fixed fp32-accurate arithmetic whatever the TF32 flags, on the CPU
the same PyTorch code as outside.  Outside the scope nothing changes (the
LM and its training call the same functions, with autograd).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import codec_gemm, depthwise_conv
from sparktts_tpu_torch.kernels.codec_gemm import conv1d_plain, conv_transpose1d_plain
from sparktts_tpu_torch.kernels.int4_matmul import MAX_ROWS as INT4_MATVEC_ROWS
from sparktts_tpu_torch.kernels.int4_matmul import int4_matvec
from sparktts_tpu_torch.lm.quant import unpack_int4

_CODEC_SCOPE = contextvars.ContextVar("codec_fp32", default=False)


@contextlib.contextmanager
def codec_fp32():
    """Run the codec's convolutions and matrix products inside the block (or
    the decorated function) on the port's own fp32 kernels.  The scope is a
    context variable: it holds for this thread (or asyncio task) alone and
    assigns no `torch.backends` flag, so work in other threads keeps its own
    precision, and a codec call's numbers depend on its inputs alone.  On
    the card a shape the kernels do not take raises; nothing falls back to
    cuDNN or cuBLAS."""
    token = _CODEC_SCOPE.set(True)
    try:
        yield
    finally:
        _CODEC_SCOPE.reset(token)


def in_codec_scope() -> bool:
    """Whether this thread (or asyncio task) is inside a `codec_fp32()` scope."""
    return _CODEC_SCOPE.get()


def _float_or_int8(p, x: torch.Tensor):
    """(weights, bias, scale) of a codec layer: float weights as stored, an
    int8 kernel cast to x's dtype with its scale in x's dtype."""
    if "w_q" in p:
        return p["w_q"].to(x.dtype), p.get("b"), p["scale"].to(x.dtype)
    return p["w"], p.get("b"), None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b; inside a `codec_fp32()` scope by the codec's kernel
    (`codec_gemm.bmm`, at most two batch dims)."""
    return codec_gemm.bmm(a, b) if _CODEC_SCOPE.get() else torch.matmul(a, b)


def int4_linear_wide(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (..., in) times nibble-packed int4 weights (in/2, out) with group
    scales (G, out), for more rows than the int4 matvec kernel takes (the
    prefill): the weights unpacked once, each group's fp32 partial dot times
    its fp32 scale, summed over the groups; in x's dtype.  The JAX
    package's XLA branch of `linear_apply`."""
    g = gscale.shape[-2]
    d_in = 2 * packed.shape[-2]
    xg = x.float().reshape(*x.shape[:-1], g, d_in // g)
    wg = unpack_int4(packed).reshape(g, d_in // g, packed.shape[-1])
    partial = torch.einsum("...gi,gio->...go", xg, wg)
    return (partial * gscale).sum(dim=-2).to(x.dtype)


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Float weights define the compute dtype (bf16 params -> bf16 matmul).

    int4: up to INT4_MATVEC_ROWS rows of x (decode) go through the int4
    matvec kernel module, which streams the packed weights; wider x
    (prefill) unpacks once and sums fp32 group partials times the fp32
    group scales.  int8: x times the weights cast to x's dtype, times the
    per-column scale in x's dtype.  Inside a `codec_fp32()` scope, float and
    int8 weights go through `codec_gemm.linear`."""
    if "w_p4" not in p and _CODEC_SCOPE.get():
        return codec_gemm.linear(x, *_float_or_int8(p, x))
    if "w_p4" in p:
        packed, gscale = p["w_p4"], p["gscale"]
        rows = x.numel() // x.shape[-1]
        if rows <= INT4_MATVEC_ROWS:
            y = int4_matvec(x.reshape(rows, x.shape[-1]).contiguous(), packed, gscale)
            y = y.reshape(*x.shape[:-1], packed.shape[-1])
        else:
            y = int4_linear_wide(x, packed, gscale)
    elif "w_q" in p:
        y = torch.matmul(x, p["w_q"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        w = p["w"]
        y = torch.matmul(x.to(w.dtype), w)
    if "b" in p:
        y = y + p["b"]
    return y


def conv1d_apply(
    p, x: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1
) -> torch.Tensor:
    """x: (B, T, C) -> (B, T', Cout).  `padding` is symmetric, torch-style.
    An int8 kernel is cast to x's dtype, its scale and then its bias applied
    to the output.  Inside a `codec_fp32()` scope a depthwise conv (groups =
    C, one channel each) goes through `depthwise_conv.conv1d`, any other
    through `codec_gemm.conv1d`."""
    w, b, scale = _float_or_int8(p, x)
    if _CODEC_SCOPE.get():
        if groups > 1 and w.shape[1] == 1 and groups == x.shape[-1] == w.shape[2]:
            return depthwise_conv.conv1d(x, w, b, scale, stride, padding, dilation)
        return codec_gemm.conv1d(x, w, b, scale, stride, padding, dilation, groups)
    return conv1d_plain(x, w, b, scale, stride, padding, dilation, groups)


def conv_transpose1d_apply(
    p,
    x: torch.Tensor,
    stride: int,
    padding: int = 0,
    output_padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d on (B, T, C):
    out_len = (T - 1) * stride - 2 * padding + K + output_padding.  Inside a
    `codec_fp32()` scope groups = 1 goes through `codec_gemm`, a depthwise
    one through `depthwise_conv`; other groupings raise there."""
    w, b, scale = _float_or_int8(p, x)
    if _CODEC_SCOPE.get():
        if groups == 1:
            return codec_gemm.conv_transpose1d(x, w, b, scale, stride, padding, output_padding)
        if w.shape[1] == 1 and groups == x.shape[-1] == w.shape[2]:
            return depthwise_conv.conv_transpose1d(x, w, b, scale, stride, padding,
                                                   output_padding)
        raise ValueError(f"conv_transpose1d_apply: no codec kernel for groups = {groups} "
                         f"of {x.shape[-1]} channels")
    return conv_transpose1d_plain(x, w, b, scale, stride, padding, output_padding, groups)


def layer_norm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim, normalized in fp32, cast back."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * p["gamma"] + p["beta"]).to(x.dtype)


def ada_layer_norm_apply(p, x: torch.Tensor, cond: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (B, T, C); cond: (B, condition_dim) -> scale/shift modulated norm."""
    scale = linear_apply(p["scale"], cond)
    shift = linear_apply(p["shift"], cond)
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * scale[:, None, :] + shift[:, None, :]).to(x.dtype)


def rms_norm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Qwen-style RMSNorm: fp32 statistics, cast back, then the gain."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["gamma"]


def batch_norm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-form BatchNorm over the last (channel) dim, running statistics."""
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["gamma"] + p["beta"]


def l2norm_scale_apply(p, x: torch.Tensor, scale: float) -> torch.Tensor:
    """The Perceiver's RMSNorm variant: x / max(||x||, 1e-12) * scale * gamma."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12) * scale * p["gamma"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha, alpha (C,) broadcast."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


def snake_apply(p, x: torch.Tensor) -> torch.Tensor:
    return snake(x, p["alpha"])
