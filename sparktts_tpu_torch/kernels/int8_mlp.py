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
one CUDA launch.  `int8_mlp_tiled_plain` is a CPU model of the kernel's
summation order (per-tile down partials summed by clusters of tiles, then
runs of clusters, then the runs in order), for the tests.

While `torch.export` traces (`torch.compiler.is_exporting()`), the wrapper
records its `sparktts_torch::` custom op (`kernels/ops.py`) instead, so that
an exported program runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import arrivals, build, ops

SOURCE = "sparktts_tpu_torch/kernels/csrc/int8_mlp.cu"
REPLACES = "sparktts_tpu/kernels/int8_mlp.py:107"
MAX_ROWS = 16  # rows of x the kernel takes
# The kernel's grid, as csrc/int8_mlp.cu fixes it (its entry refuses a
# workspace or counter array sized from other values):
TILE = 16  # intermediate columns per block
CLUSTER = 8  # blocks per cluster: the first level of the ordered down sum
FINAL_RUN = 8  # cluster sums added in order by one thread of the final sum

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("int8_mlp").int8_mlp_matvec_bf16
        p, n = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [n, p, n, p, n, n, n, p]
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
    h = _swiglu(x, gu_q, gu_scale)
    return (h.float() @ down_q.float()).to(x.dtype) * down_scale.to(x.dtype)


def _swiglu(x, gu_q, gu_scale):
    """h of the plain version, in x's dtype."""
    dt, i = x.dtype, gu_q.shape[1] // 2
    gu = x.float() @ gu_q.float()
    g = gu[:, :i].to(dt) * gu_scale[:i].to(dt)
    u = gu[:, i:].to(dt) * gu_scale[i:].to(dt)
    return F.silu(g.float()).to(dt) * u


def _clusters(i: int) -> int:
    """Clusters of the kernel's grid for intermediate width i."""
    return -(-(-(-i // TILE)) // CLUSTER)


def int8_mlp_tiled_plain(x, gu_q, gu_scale, down_q, down_scale) -> torch.Tensor:
    """The plain version with the kernel's order of the down sum: h as in
    `int8_mlp_matvec_plain`; each tile of TILE intermediate columns gives an
    fp32 partial h[:, tile] . down_q[tile, :]; the partials of each cluster
    of CLUSTER tiles (the grid padded with empty tiles) are summed in tile
    order; the clusters' sums are added in runs of FINAL_RUN clusters, each
    run in order, then the runs in order; the result is rounded and scaled
    as in the plain version."""
    i = down_q.shape[0]
    h, w = _swiglu(x, gu_q, gu_scale).float(), down_q.float()
    sums = []
    step = TILE * CLUSTER
    for c0 in range(0, i, step):
        acc = torch.zeros((x.shape[0], down_q.shape[1]), dtype=torch.float32, device=x.device)
        for t0 in range(c0, min(c0 + step, i), TILE):  # empty tiles of the grid add zeros
            acc = acc + h[:, t0:t0 + TILE] @ w[t0:t0 + TILE]
        sums.append(acc)
    total = torch.zeros_like(sums[0])
    for r0 in range(0, len(sums), FINAL_RUN):
        total = total + sum(sums[r0:r0 + FINAL_RUN], torch.zeros_like(total))
    return total.to(x.dtype) * down_scale.to(x.dtype)


def int8_mlp_matvec(
    x: torch.Tensor,
    gu_q: torch.Tensor,
    gu_scale: torch.Tensor,
    down_q: torch.Tensor,
    down_scale: torch.Tensor,
) -> torch.Tensor:
    """x (R, K) with R <= MAX_ROWS -> (R, K) in x's dtype."""
    if torch.compiler.is_exporting():  # an export records the op (kernels/ops.py)
        return ops.int8_mlp_matvec(x, gu_q, gu_scale, down_q, down_scale)
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
    if k % 4:
        raise ValueError(f"int8_mlp_matvec: the kernel takes K a multiple of 4, got {k}")
    if (gu_q.shape != (k, 2 * i) or down_q.shape != (i, k) or gu_scale.shape != (2 * i,)
            or down_scale.shape != (k,)):
        raise ValueError(f"int8_mlp_matvec: shapes do not fit x {tuple(x.shape)}: gu_q "
                         f"{tuple(gu_q.shape)}, gu_scale {tuple(gu_scale.shape)}, down_q "
                         f"{tuple(down_q.shape)}, down_scale {tuple(down_scale.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_mlp_matvec: x, the weights and the scales must be contiguous")
    clusters = _clusters(i)
    ws = torch.empty((clusters, r, k), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _kernel()
    with build.launch_stream(x) as stream:
        counters = arrivals.for_current_stream(x.device, CLUSTER)
        err = fn(
            x.data_ptr(), gu_q.data_ptr(), gu_scale.data_ptr(), down_q.data_ptr(),
            down_scale.data_ptr(), ws.data_ptr(), clusters, counters.data_ptr(),
            counters.numel(), out.data_ptr(), r, k, i, stream,
        )
    launches += 1
    build.note_launch("int8_mlp_matvec")
    if err != 0:
        raise RuntimeError(f"int8_mlp_matvec: CUDA launch failed with error {err}")
    return out
