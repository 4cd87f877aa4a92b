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
is one CUDA launch.  The kernel splits a call's groups into runs of
consecutive groups, one block of a thread block cluster each, and adds the
runs' sums in order through the cluster's shared memory: it needs no
workspace and no counter.  `int4_matvec_split_plain` is the CPU model of
that order (`group_split` gives the runs, as the kernel's plan does).

While `torch.export` traces (`torch.compiler.is_exporting()`), the wrapper
records its `sparktts_torch::` custom op (`kernels/ops.py`) instead, so that
an exported program runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from sparktts_tpu_torch.kernels import build, ops
from sparktts_tpu_torch.lm.quant import unpack_int4

SOURCE = "sparktts_tpu_torch/kernels/csrc/int4_matmul.cu"
REPLACES = "sparktts_tpu/kernels/int4_matmul.py:101"
MAX_ROWS = 32  # rows of x the kernel takes
MAX_SPLIT = 8  # group runs of a call: the blocks of one cluster
RUN_MAX = 12  # groups a run
RUN_BUDGET = 112 * 1024  # a block's bytes for its run's staged x
PLAN_FIELDS = ("n8_tiles", "warps", "run", "split", "stages", "column_blocks", "smem_bytes")

launches = 0
_fn = None


def bind(lib: ctypes.CDLL):
    """The launch function of a built int4_matmul library."""
    fn = lib.int4_matvec_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(b: int, d_in: int, d_out: int, groups: int) -> dict:
    """The built kernel's launch plan for a call's shape (PLAN_FIELDS), from
    its C entry `int4_matvec_plan`; builds the kernel if need be."""
    fields = (ctypes.c_int * len(PLAN_FIELDS))()
    err = build.load("int4_matmul").int4_matvec_plan(b, d_in, d_out, groups, fields)
    if err != 0:
        raise ValueError(f"int4_matvec: the kernel takes no call of shape B={b} in={d_in} "
                         f"out={d_out} groups={groups}")
    return dict(zip(PLAN_FIELDS, fields))


def group_split(groups: int, b: int, group: int) -> tuple:
    """(run, split): the kernel's runs of consecutive groups for a call of
    `b` rows, `run` groups each (the last may be shorter), `split` of them:
    the fewest runs, at most MAX_SPLIT, of at most RUN_MAX groups each, whose
    staged x (b rows of bf16, each group padded to whole k steps of 16) fits
    RUN_BUDGET bytes of a block's shared memory, as the kernel's plan
    chooses them."""
    kpad = 16 * -(-group // 16)
    most, s = min(groups, MAX_SPLIT), 1
    while s < most and (-(-groups // s) > RUN_MAX or b * -(-groups // s) * 2 * kpad > RUN_BUDGET):
        s += 1
    run = -(-groups // s)
    return run, -(-groups // run)


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("int4_matmul"))
    return _fn


def int4_matvec_plain(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ unpack(packed) (in, out) with group scales: per group,
    the fp32 partial dot times the fp32 scale, summed over groups; returned
    in x's dtype.  (bf16 x times the small integer weights is exact in fp32,
    so this is the JAX package's bf16 product with fp32 accumulation.)  Any
    leading dims.  The tests, the wrapper for CPU tensors and the op's CPU
    registration (`kernels/ops.py`) call it; the prefill has its own path
    (`nn/layers.int4_linear_wide`)."""
    g = gscale.shape[-2]
    d_in = 2 * packed.shape[-2]
    xg = x.float().reshape(*x.shape[:-1], g, d_in // g)
    wg = unpack_int4(packed).reshape(g, d_in // g, packed.shape[-1])
    partial = torch.einsum("...gi,gio->...go", xg, wg)
    return (partial * gscale).sum(dim=-2).to(x.dtype)


def int4_matvec_split_plain(x: torch.Tensor, packed: torch.Tensor,
                            gscale: torch.Tensor) -> torch.Tensor:
    """CPU model of the kernel's order of sums for x (B, in): each group's
    fp32 partial dot times its scale (rounded), added in order within each
    run of `group_split` groups from 0, and the runs' sums added in order
    from 0; in x's dtype.  (The kernel's partial dots sum in the tensor
    cores' own order.)"""
    g = gscale.shape[-2]
    d_in = 2 * packed.shape[-2]
    xg = x.float().reshape(*x.shape[:-1], g, d_in // g)
    wg = unpack_int4(packed).reshape(g, d_in // g, packed.shape[-1])
    scaled = torch.einsum("...gi,gio->...go", xg, wg) * gscale
    run, split = group_split(g, x.shape[0], d_in // g)
    total = torch.zeros_like(scaled[..., 0, :])
    for r in range(split):
        acc = torch.zeros_like(total)
        for k in range(r * run, min(g, (r + 1) * run)):
            acc = acc + scaled[..., k, :]
        total = total + acc
    return total.to(x.dtype)


def int4_matvec(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (B, in) with B <= MAX_ROWS, packed (in/2, out) int8, gscale
    (G, out) fp32 -> (B, out) in x's dtype."""
    if torch.compiler.is_exporting():  # an export records the op (kernels/ops.py)
        return ops.int4_matvec(x, packed, gscale)
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
    fn = _kernel()
    out = torch.empty((b, d_out), dtype=x.dtype, device=x.device)
    with build.launch_stream(x) as stream:
        err = fn(x.data_ptr(), packed.data_ptr(), gscale.data_ptr(), out.data_ptr(), b, d_in,
                 d_out, groups, stream)
    launches += 1
    build.note_launch("int4_matvec")
    if err != 0:
        raise RuntimeError(f"int4_matvec: CUDA launch failed with error {err}")
    return out
