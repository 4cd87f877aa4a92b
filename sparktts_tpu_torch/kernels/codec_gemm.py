"""The codec's fp32 convolutions and matrix products: the hand-written CUDA
kernel (kernel 7), its plain versions and a CPU model of its index math.

No Pallas kernel stands behind it: the JAX package leaves these ops to XLA
(`sparktts_tpu/nn/layers.py` `linear_apply`, `conv1d_apply`,
`conv_transpose1d_apply`, and the einsums of its attention, FVQ and mel
code).  On the card they would otherwise be cuDNN and cuBLAS calls, whose
precision and algorithm are process-wide state; the kernel
(`csrc/codec_gemm.cu`, whose header says how it is laid out and what bounds
it) computes every output element by one fixed sequence of 3xTF32 products
on the tensor cores, so the same inputs give the same bits at any position,
batch or length, whatever the caller's TF32 flags.

Entry points, each taking fp32 tensors:

  * `linear(x, w, bias, scale)`: x (..., in) @ w (in, out);
  * `conv1d(x, w, bias, scale, stride, padding, dilation, groups)`: x (B, T,
    Cin) with the stored WIO kernel (K, Cin // groups, Cout);
  * `conv_transpose1d(x, w, bias, scale, stride, padding, output_padding)`:
    groups = 1, the stored flipped kernel (K, Cin, Cout);
  * `bmm(a, b)`: (..., M, K) @ (..., K, N) with at most two batch dims,
    broadcast; any strides.

`scale` (an int8 kernel's per-column scale) multiplies the output before the
bias.  Each runs its plain version (today's PyTorch code, which on the CPU
is what the port always ran) for CPU tensors only; for CUDA tensors it
launches the kernel or raises.  `nn/layers.py` routes here inside a
`codec_fp32()` scope.  `launches` counts calls that launched the kernel:
one CUDA launch, or two where the plan gives each k segment a block of its
own and a second pass adds their partials (a workspace the wrapper
allocates).  The plan follows the shape and changes no bit; `forced_plan`
pins it for the card tests and the tile bench.  While `torch.export`
traces, each records its `sparktts_torch::` op (`kernels/ops.py`) instead.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import build, ops

SOURCE = "sparktts_tpu_torch/kernels/csrc/codec_gemm.cu"
REPLACES = "sparktts_tpu/nn/layers.py:104"  # XLA's convolutions and dots; no Pallas kernel
K_CHUNK = 8  # the kernel sums k in chunks of this many, in increasing k ...
K_SEGMENT = 512  # ... within segments of this many, each from zero, added in increasing k

launches = 0
_fns = None
_config = -1  # the kernel's plan: -1 by shape, else a tile index (+ tiles: split k)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN = [_I, _P, _L, ctypes.POINTER(_L), _P]  # config, workspace, its bytes, bytes needed, stream


def _kernel():
    global _fns
    if _fns is None:
        lib = build.load("codec_gemm")
        conv, tconv, bmm_fn = (lib.codec_conv1d_f32, lib.codec_conv_transpose1d_f32,
                               lib.codec_bmm_f32)
        conv.argtypes = [_P, _L, _L, _L, _P, _P, _P, _P] + [_I] * 10 + _PLAN
        tconv.argtypes = [_P, _L, _L, _L, _P, _P, _P, _P] + [_I] * 8 + _PLAN
        bmm_fn.argtypes = [_P] + [_L] * 4 + [_P] + [_L] * 4 + [_P] + [_L] * 4 + [_I] * 5 + _PLAN
        lib.codec_mma_probe.argtypes = [_P] * 4 + [_I, _P]
        for fn in (conv, tconv, bmm_fn, lib.codec_gemm_configs, lib.codec_mma_probe):
            fn.restype = ctypes.c_int
        _fns = conv, tconv, bmm_fn, lib
    return _fns


def configs() -> int:
    """The number of plans the kernel has (tile by shape, with or without a
    block a k segment); `forced_plan` takes 0 .. configs() - 1."""
    return _kernel()[3].codec_gemm_configs()


@contextlib.contextmanager
def forced_plan(config: int):
    """Inside the block every call launches with plan `config` instead of
    the plan by shape (the card tests hold that every plan gives the same
    bits; the tile bench times them)."""
    global _config
    saved, _config = _config, config
    try:
        yield
    finally:
        _config = saved


_needs: dict = {}  # (entry point's shape, plan) -> workspace bytes its plan needs


def _call(fn, t: torch.Tensor, shape: tuple, *args) -> int:
    """Launch `fn(*args, plan...)` on `t`'s card.  A plan that gives each k
    segment a block of its own needs a workspace for their partials: the
    first call of a `shape` asks the kernel (it launches nothing and says
    how many bytes), later calls allocate it up front."""
    key = (shape, _config)
    need = _needs.get(key)
    asked = _L(0)
    with build.launch_stream(t) as stream:
        if need is None:
            err = fn(*args, _config, None, 0, ctypes.byref(asked), stream)
            if err != -1:
                _needs[key] = 0
                return err
            need = _needs[key] = asked.value
        ws = torch.empty(need // 4, dtype=torch.float32, device=t.device) if need else None
        return fn(*args, _config, None if ws is None else ws.data_ptr(), need,
                  ctypes.byref(asked), stream)


def mma_probe(a: torch.Tensor, b: torch.Tensor):
    """a (64, K) @ b (K, 8), fp32 on the card, K a multiple of 8 up to 256,
    by the kernel's 3xTF32 chunks: (through `wgmma`, through `mma.sync`)."""
    if a.shape[0] != 64 or b.shape[1] != 8 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mma_probe: want a (64, K) and b (K, 8), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    a, b = a.float().contiguous(), b.float().contiguous()
    out = torch.empty((2, 64, 8), dtype=torch.float32, device=a.device)
    with build.launch_stream(a) as stream:
        err = _kernel()[3].codec_mma_probe(a.data_ptr(), b.data_ptr(), out[0].data_ptr(),
                                           out[1].data_ptr(), a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"mma_probe: CUDA launch failed with error {err}")
    return out[0], out[1]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _epilogue(y: torch.Tensor, bias, scale) -> torch.Tensor:
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def linear_plain(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None) -> torch.Tensor:
    """x (..., in) @ w (in, out), then the scale and the bias."""
    return _epilogue(torch.matmul(x.to(w.dtype), w), bias, scale)


def conv1d_plain(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """(B, T, Cin) -> (B, T', Cout) by `F.conv1d`; a float kernel's bias goes
    into the call, after a scale it comes after."""
    y = F.conv1d(x.to(w.dtype).transpose(1, 2), w.permute(2, 1, 0),  # WIO -> (Cout, Cin/g, K)
                 bias if scale is None else None, stride=stride, padding=padding,
                 dilation=dilation, groups=groups).transpose(1, 2)
    return y if scale is None else _epilogue(y, bias, scale)


def torch_transposed_kernel(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Stored flipped forward kernel (K, Cin // g, Cout) -> torch
    ConvTranspose1d weight (Cin, Cout // g, K): torch tap m is w[K-1-m], and
    input channel g*(Cin//g)+i feeds output g*(Cout//g)+j."""
    k, cin_g, cout = w.shape
    w = w.flip(0).reshape(k, cin_g, groups, cout // groups)
    return w.permute(2, 1, 3, 0).reshape(groups * cin_g, cout // groups, k)


def conv_transpose1d_plain(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None,
                           stride: int = 1, padding: int = 0, output_padding: int = 0,
                           groups: int = 1) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d on (B, T, C) by `F.conv_transpose1d`:
    out_len = (T - 1) * stride - 2 * padding + K + output_padding."""
    y = F.conv_transpose1d(x.to(w.dtype).transpose(1, 2), torch_transposed_kernel(w, groups),
                           bias if scale is None else None, stride=stride, padding=padding,
                           output_padding=output_padding, groups=groups).transpose(1, 2)
    return y if scale is None else _epilogue(y, bias, scale)


def bmm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# CPU models of the kernel's index math and order of sums
# ---------------------------------------------------------------------------


def _segmented(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in the kernel's order: each segment of
    K_SEGMENT summed from zero over its chunks of K_CHUNK in increasing k,
    the segments' sums added in increasing order."""
    y = None
    for s0 in range(0, a.shape[-1], K_SEGMENT):
        seg = None
        for k0 in range(s0, min(s0 + K_SEGMENT, a.shape[-1]), K_CHUNK):
            part = a[..., k0:k0 + K_CHUNK] @ b[..., k0:k0 + K_CHUNK, :]
            seg = part if seg is None else seg + part
        y = seg if y is None else y + seg
    return y


def conv1d_model(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """The kernel's conv: each group a product of the row-gathered inputs
    (B, T', K Cg), k = tap Cg + c, zero outside the sequence, with the
    group's weights (K Cg, Ng), summed as `_segmented` sums."""
    b, t, cin = x.shape
    k, cg, cout = w.shape
    ng = cout // groups
    t_out = (t + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    xp = F.pad(x.float(), (0, 0, padding, padding))
    rows = torch.arange(t_out)[:, None] * stride + torch.arange(k) * dilation  # (T', K)
    cols = []
    for g in range(groups):
        a = xp[:, rows, g * cg:(g + 1) * cg].reshape(b, t_out, k * cg)
        cols.append(_segmented(a, w[:, :, g * ng:(g + 1) * ng].float().reshape(k * cg, ng)))
    return _epilogue(torch.cat(cols, -1), bias, scale)


def conv_transpose1d_model(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None,
                           stride: int = 1, padding: int = 0,
                           output_padding: int = 0) -> torch.Tensor:
    """The kernel's transposed conv by its phase mapping: output o = s u +
    phi - p (phi = (o + p) mod s) is row u of phase phi's product, whose
    k = d Cin + c takes input x[u - d] (zero outside) and the stored tap
    K - 1 - phi - s d (zero below 0), summed as `_segmented` sums."""
    b, t, cin = x.shape
    k, _, cout = w.shape
    s = stride
    t_out = (t - 1) * s - 2 * padding + k + output_padding
    d_taps = -(-k // s)
    n_u = (t_out - 1 + padding) // s + 1
    u = torch.arange(n_u)
    src = u[:, None] - torch.arange(d_taps)  # (U, D)
    ok = (src >= 0) & (src < t)
    a = (x.float()[:, src.clamp(0, t - 1)] * ok[None, :, :, None]).reshape(b, n_u, d_taps * cin)
    y = x.new_zeros((b, t_out, cout), dtype=torch.float32)
    for phi in range(s):
        tap = k - 1 - phi - s * torch.arange(d_taps)
        wp = w.float()[tap.clamp(0, k - 1)] * (tap >= 0)[:, None, None]  # (D, Cin, Cout)
        o = s * u + phi - padding
        keep = (o >= 0) & (o < t_out)
        y[:, o[keep]] = _segmented(a, wp.reshape(d_taps * cin, cout))[:, keep]
    return _epilogue(y, bias, scale)


def bmm_model(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's product, summed as `_segmented` sums."""
    return _segmented(a, b)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, w: torch.Tensor, bias, scale):
    dev, f32 = x.device, torch.float32
    for t in (w, bias, scale):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: x, the weights, bias and scale must be on one device")
    for t in (x, w, bias, scale):
        if t is not None and t.dtype != f32:
            raise TypeError(f"{name}: the CUDA kernel takes fp32 tensors, got {t.dtype}")
    if not w.is_contiguous():
        raise ValueError(f"{name}: the weights must be contiguous")
    cout = w.shape[-1]
    for t in (bias, scale):
        if t is not None and (t.shape != (cout,) or not t.is_contiguous()):
            raise ValueError(f"{name}: bias and scale must be contiguous ({cout},)")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launched(name: str, err: int) -> None:
    global launches
    launches += 1
    build.note_launch("codec_gemm")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _conv_launch(x, w, bias, scale, stride, padding, dilation, groups, name, x_shape=None,
                 x_strides=None, y_shape=None):
    """The conv entry point on x (B, T, Cin) (or the `x_shape` and
    `x_strides` it is read as) and w (K, Cg, Cout); y (B, T', Cout), or of
    `y_shape`."""
    b, t, cin = x_shape or x.shape
    k, _, cout = w.shape if w.dim() == 3 else (1, *w.shape)
    t_out = (t + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    if t_out < 1 or b < 1:
        raise ValueError(f"{name}: no output for x {tuple(x.shape)} and a kernel of {k} taps")
    y = torch.empty(y_shape or (b, t_out, cout), dtype=torch.float32, device=x.device)
    strides = x_strides or x.stride()
    shape = (0, b, t, cin, cout, k, t_out, stride, padding, dilation, groups)
    err = _call(_kernel()[0], x, shape, x.data_ptr(), *strides, w.data_ptr(), _ptr(scale),
                _ptr(bias), y.data_ptr(), b, t, cin, cout, k, t_out, stride, padding, dilation,
                groups)
    _launched(name, err)
    return y


def linear(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None) -> torch.Tensor:
    """x (..., in) @ w (in, out) (* scale) (+ bias) -> (..., out)."""
    if torch.compiler.is_exporting():  # an export records the op (kernels/ops.py)
        return ops.codec_linear(x, w, bias, scale)
    if x.device.type == "cpu":
        return linear_plain(x, w, bias, scale)
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    _check("codec linear", x, w, bias, scale)
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"codec linear: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit")
    if not x.is_contiguous():
        x = x.contiguous()
    din = x.shape[-1]
    rows = x.numel() // din
    return _conv_launch(x, w, bias, scale, 1, 0, 1, 1, "codec linear", (1, rows, din),
                        (rows * din, din, 1), (*x.shape[:-1], w.shape[1]))


def conv1d(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, stride: int = 1,
           padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x (B, T, Cin), w (K, Cin // groups, Cout) -> (B, T', Cout); `padding`
    symmetric, torch-style."""
    if torch.compiler.is_exporting():
        return ops.codec_conv1d(x, w, bias, scale, stride, padding, dilation, groups)
    if x.device.type == "cpu":
        return conv1d_plain(x, w, bias, scale, stride, padding, dilation, groups)
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    _check("codec conv1d", x, w, bias, scale)
    if (x.dim() != 3 or w.dim() != 3 or groups < 1 or x.shape[2] != w.shape[1] * groups
            or w.shape[2] % groups or min(stride, dilation) < 1 or padding < 0):
        raise ValueError(f"codec conv1d: x {tuple(x.shape)}, w {tuple(w.shape)}, groups "
                         f"{groups}, stride {stride}, padding {padding}, dilation {dilation}")
    return _conv_launch(x, w, bias, scale, stride, padding, dilation, groups, "codec conv1d")


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d, groups = 1: x (B, T, Cin), the stored
    flipped kernel (K, Cin, Cout) -> (B, (T - 1) s - 2 p + K + output_padding,
    Cout)."""
    if torch.compiler.is_exporting():
        return ops.codec_conv_transpose1d(x, w, bias, scale, stride, padding, output_padding)
    if x.device.type == "cpu":
        return conv_transpose1d_plain(x, w, bias, scale, stride, padding, output_padding)
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    _check("codec conv_transpose1d", x, w, bias, scale)
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1] or stride < 1 or padding < 0:
        raise ValueError(f"codec conv_transpose1d: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"stride {stride}, padding {padding}")
    b, t, cin = x.shape
    k, _, cout = w.shape
    t_out = (t - 1) * stride - 2 * padding + k + output_padding
    if t_out < 1 or b < 1:
        raise ValueError(f"codec conv_transpose1d: no output for x {tuple(x.shape)}")
    y = torch.empty((b, t_out, cout), dtype=torch.float32, device=x.device)
    err = _call(_kernel()[1], x, (1, b, t, cin, cout, k, t_out, stride, padding), x.data_ptr(),
                *x.stride(), w.data_ptr(), _ptr(scale), _ptr(bias), y.data_ptr(), b, t, cin,
                cout, k, t_out, stride, padding)
    _launched("codec conv_transpose1d", err)
    return y


def _batch2(t: torch.Tensor, batch) -> torch.Tensor:
    """t (..., R, C) broadcast to (*batch, R, C), with two batch dims."""
    return t.expand(*batch, *t.shape[-2:])[(None,) * (2 - len(batch))]


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) -> (..., M, N), at most two batch dims
    (broadcast), any strides."""
    if torch.compiler.is_exporting():
        return ops.codec_bmm(a, b)
    if a.device.type == "cpu":
        return bmm_plain(a, b)
    if a.device != b.device or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("codec bmm: the CUDA kernel takes fp32 a and b on one device")
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"codec bmm: a {tuple(a.shape)} and b {tuple(b.shape)} do not fit")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if len(batch) > 2:
        raise ValueError(f"codec bmm: at most two batch dims, got {tuple(batch)}")
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty((*batch, m, n), dtype=torch.float32, device=a.device)
    a4, b4, c4 = _batch2(a, batch), _batch2(b, batch), _batch2(out, batch)
    g1, g2 = c4.shape[:2]
    err = _call(_kernel()[2], a, (2, g1, g2, m, k, n), a4.data_ptr(), *a4.stride(),
                b4.data_ptr(), *b4.stride(), c4.data_ptr(), *c4.stride(), g1, g2, m, k, n)
    _launched("codec bmm", err)
    return out
