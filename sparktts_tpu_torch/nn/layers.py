"""Functional NN primitives on channels-last `(B, T, C)` tensors.

Port of the float paths of `sparktts_tpu/nn/layers.py`, plus `full_fp32`,
which pins the codec's precision on the card.  Params are plain
dicts of tensors with the JAX package's keys and layouts:

  * linear weights are `(in, out)`;
  * conv kernels are WIO `(K, Cin // groups, Cout)`;
  * transposed-conv kernels are the equivalent forward-conv kernel, stored
    spatially FLIPPED relative to torch's `ConvTranspose1d` weight.

The `F.conv*` calls below undo those layouts per call, so one param tree
serves both packages.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Weights define the compute dtype (bf16 params -> bf16 matmul)."""
    w = p["w"]
    y = torch.matmul(x.to(w.dtype), w)
    if "b" in p:
        y = y + p["b"]
    return y


def conv1d_apply(
    p, x: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1
) -> torch.Tensor:
    """x: (B, T, C) -> (B, T', Cout).  `padding` is symmetric, torch-style."""
    w = p["w"]
    y = F.conv1d(
        x.to(w.dtype).transpose(1, 2),
        w.permute(2, 1, 0),  # WIO -> (Cout, Cin // groups, K)
        p.get("b"),
        stride=stride,
        padding=padding,
        dilation=dilation,
        groups=groups,
    )
    return y.transpose(1, 2)


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
    w = p["w"]
    y = F.conv_transpose1d(
        x.to(w.dtype).transpose(1, 2),
        _torch_transposed_kernel(w, groups),
        p.get("b"),
        stride=stride,
        padding=padding,
        output_padding=output_padding,
        groups=groups,
    )
    return y.transpose(1, 2)


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


@contextlib.contextmanager
def full_fp32():
    """Run fp32 convolutions and matmuls in full fp32 inside the block (or
    the decorated function), and restore the caller's settings after it.
    PyTorch's default lets cuDNN run fp32 convolutions in TF32 (about three
    decimal digits); the codec is meant to be fp32 whoever calls it.  The
    flags are process-wide, so the codec's entry points (which run under
    this) are not safe to call while another thread runs TF32 work: that
    thread loses TF32 for the duration, and flags it sets meanwhile are
    overwritten on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha, alpha (C,) broadcast."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


def snake_apply(p, x: torch.Tensor) -> torch.Tensor:
    return snake(x, p["alpha"])
