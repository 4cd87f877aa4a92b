"""Functional NN primitives on channels-last `(B, T, C)` tensors.

Port of `sparktts_tpu/nn/layers.py`, plus `full_fp32`, which pins the
codec's precision on the card.  Params are plain dicts of tensors with the
JAX package's keys and layouts:

  * linear weights are `(in, out)`;
  * conv kernels are WIO `(K, Cin // groups, Cout)`;
  * transposed-conv kernels are the equivalent forward-conv kernel, stored
    spatially FLIPPED relative to torch's `ConvTranspose1d` weight.

The `F.conv*` calls below undo those layouts per call, so one param tree
serves both packages.  Weight-only quantized params (`lm/quant.py`,
`codec/quant.py`) take their own paths: int8 `{"w_q", "scale"}` computes in
the activation dtype with the scale on the output, before the bias; int4
`{"w_p4", "gscale"}` linears go through `kernels/int4_matmul.py`.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels.int4_matmul import MAX_ROWS as INT4_MATVEC_ROWS
from sparktts_tpu_torch.kernels.int4_matmul import int4_matvec, int4_matvec_plain


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Float weights define the compute dtype (bf16 params -> bf16 matmul).

    int4: up to INT4_MATVEC_ROWS rows of x (decode) go through the int4
    matvec kernel module, which streams the packed weights; wider x
    (prefill) unpacks once and sums fp32 group partials times the fp32
    group scales.  int8: x times the weights cast to x's dtype, times the
    per-column scale in x's dtype."""
    if "w_p4" in p:
        packed, gscale = p["w_p4"], p["gscale"]
        rows = x.numel() // x.shape[-1]
        if rows <= INT4_MATVEC_ROWS:
            y = int4_matvec(x.reshape(rows, x.shape[-1]).contiguous(), packed, gscale)
            y = y.reshape(*x.shape[:-1], packed.shape[-1])
        else:
            y = int4_matvec_plain(x, packed, gscale)
    elif "w_q" in p:
        y = torch.matmul(x, p["w_q"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        w = p["w"]
        y = torch.matmul(x.to(w.dtype), w)
    if "b" in p:
        y = y + p["b"]
    return y


def _conv_weight(p, x: torch.Tensor):
    """(kernel, bias for F.conv*) of a conv's params; the kernel's dtype is
    the compute dtype.  A float kernel carries its bias; an int8 kernel is
    cast to x's dtype and leaves the bias to `_conv_output`, after the
    scale."""
    if "w_q" in p:
        return p["w_q"].to(x.dtype), None
    return p["w"], p.get("b")


def _conv_output(p, y: torch.Tensor) -> torch.Tensor:
    """(B, Cout, T') conv output -> (B, T', Cout), with an int8 kernel's
    per-out-channel scale and then its bias."""
    y = y.transpose(1, 2)
    if "w_q" in p:
        y = y * p["scale"].to(y.dtype)
        if "b" in p:
            y = y + p["b"]
    return y


def conv1d_apply(
    p, x: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1
) -> torch.Tensor:
    """x: (B, T, C) -> (B, T', Cout).  `padding` is symmetric, torch-style."""
    w, b = _conv_weight(p, x)
    y = F.conv1d(
        x.to(w.dtype).transpose(1, 2),
        w.permute(2, 1, 0),  # WIO -> (Cout, Cin // groups, K)
        b,
        stride=stride,
        padding=padding,
        dilation=dilation,
        groups=groups,
    )
    return _conv_output(p, y)


def _torch_transposed_kernel(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Stored flipped forward kernel (K, Cin // g, Cout) -> torch
    ConvTranspose1d weight (Cin, Cout // g, K): torch tap m is w[K-1-m], and
    input channel g*(Cin//g)+i feeds output g*(Cout//g)+j."""
    k, cin_g, cout = w.shape
    w = w.flip(0).reshape(k, cin_g, groups, cout // groups)
    return w.permute(2, 1, 3, 0).reshape(groups * cin_g, cout // groups, k)


def conv_transpose1d_apply(
    p,
    x: torch.Tensor,
    stride: int,
    padding: int = 0,
    output_padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d on (B, T, C):
    out_len = (T - 1) * stride - 2 * padding + K + output_padding."""
    w, b = _conv_weight(p, x)
    y = F.conv_transpose1d(
        x.to(w.dtype).transpose(1, 2),
        _torch_transposed_kernel(w, groups),
        b,
        stride=stride,
        padding=padding,
        output_padding=output_padding,
        groups=groups,
    )
    return _conv_output(p, y)


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


_fp32_lock = threading.Lock()
_fp32_depth = 0  # full_fp32 blocks open, in all threads
_fp32_saved = None  # (cudnn, matmul) TF32 flags when the first of them opened


@contextlib.contextmanager
def full_fp32():
    """Run fp32 convolutions and matmuls in full fp32 inside the block (or
    the decorated function), and restore the caller's settings after it.
    PyTorch's default lets cuDNN run fp32 convolutions in TF32 (about three
    decimal digits); the codec is meant to be fp32 whoever calls it.

    The two TF32 flags are process-wide, and PyTorch has no per-call fp32
    precision.  So blocks that overlap in several threads share one
    bookkeeping, under a lock: the first to open saves the flags, every
    one that opens clears both, and the last to close restores a flag only
    where it is still False.  So a flag that another thread set to True
    while blocks were open keeps True, unless a block opened after that
    and cleared it again; a flag that another thread set to False cannot be
    told from this one's clearing, and gets the saved value back.  What
    this cannot fix: while any block is open, TF32 work in other threads
    runs in full fp32."""
    global _fp32_depth, _fp32_saved
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        _fp32_depth += 1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                cudnn_saved, matmul_saved = _fp32_saved
                if torch.backends.cudnn.allow_tf32 is False:
                    torch.backends.cudnn.allow_tf32 = cudnn_saved
                if torch.backends.cuda.matmul.allow_tf32 is False:
                    torch.backends.cuda.matmul.allow_tf32 = matmul_saved


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha, alpha (C,) broadcast."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


def snake_apply(p, x: torch.Tensor) -> torch.Tensor:
    return snake(x, p["alpha"])
