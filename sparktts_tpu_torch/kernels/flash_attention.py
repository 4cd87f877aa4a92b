"""Prefill flash attention: the hand-written CUDA kernel and its plain version.

Replaces `flash_attention_prefill` of `sparktts_tpu/kernels/flash_attention.py`
(`_flash_kernel`): causal attention over the prompt with a per-row left-pad
offset `start[b]` (keys before it are invalid) and GQA (query head h reads
KV head h // group, never repeated).  The kernel is
`csrc/flash_attention.cu`, FlashAttention-2's layout on the tensor cores
(`mma.sync`, `cp.async`); its header says how it is laid out, what bounds
it on an H100 and what the design does about it.  Unlike the Pallas kernel it
masks the ragged edge itself, so any prompt length T works.  It rounds the
attention probabilities to bf16 before P V, as the LM's dense path does;
the plain version keeps them in fp32.

Query rows with no valid key (left-pad rows, t < start[b]) are unspecified
in the JAX package; here both versions return zeros for them.

`flash_attention_prefill` runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  `launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from sparktts_tpu_torch.kernels import build

SOURCE = "sparktts_tpu_torch/kernels/csrc/flash_attention.cu"
REPLACES = "sparktts_tpu/kernels/flash_attention.py:134"
HEAD_DIM = 64

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_prefill_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_plain(
    q: torch.Tensor,      # (B, Hq, T, D)
    k: torch.Tensor,      # (B, Hkv, S, D)
    v: torch.Tensor,      # (B, Hkv, S, D)
    start: torch.Tensor,  # (B,) first valid key slot
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Dense fp32 attention with the kernel's mask: key c is valid for query
    row t when start[b] <= c <= t.  Output (B, Hq, T, D) in q.dtype."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, t, d)
    scores = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * sm_scale
    row = torch.arange(t, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    valid = (col <= row)[None] & (col[None] >= start.to(q.device)[:, None, None])  # (B, T, S)
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float()) / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, t, d).to(q.dtype)


def flash_attention_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    start: torch.Tensor,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Causal left-pad-masked GQA attention, (B, Hq, T, D) in q.dtype.  On
    the card, strides with a contiguous head dim are taken as they are when
    every base is 16-byte aligned and every other stride a multiple of 8
    elements; anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, start, sm_scale)
    global launches
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    tensors = (q, k, v, start)
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention_prefill: all inputs must be on one device")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError("flash_attention_prefill: the CUDA kernel takes bf16 q/k/v")
    if d != HEAD_DIM or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_prefill: unsupported shapes {q.shape} {k.shape} {v.shape}")
    if hq % hkv or t < 1 or s < 1:
        raise ValueError(f"flash_attention_prefill: bad head/length counts {q.shape} {k.shape}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention_prefill: the head dim must be contiguous")
    # the kernel copies 16-byte pieces: every row it reads starts 16-byte aligned
    if any(x.data_ptr() % 16 for x in (q, k, v)) or any(
        x.stride(i) % 8 for x in (q, k, v) for i in range(3) if x.shape[i] > 1
    ):
        raise ValueError("flash_attention_prefill: q/k/v need 16-byte aligned bases and "
                         "strides that are multiples of 8 elements")
    if start.dtype != torch.int32 or start.shape != (b,) or not start.is_contiguous():
        raise ValueError("flash_attention_prefill: start must be a contiguous (B,) int32 tensor")
    out = torch.empty((b, hq, t, d), dtype=q.dtype, device=q.device)
    fn = _kernel()
    with build.launch_stream(q) as stream:
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(), out.data_ptr(),
            b, hq, hkv, t, s,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(sm_scale), stream,
        )
    launches += 1
    build.note_launch("flash_attention_prefill")
    if err != 0:
        raise RuntimeError(f"flash_attention_prefill: CUDA launch failed with error {err}")
    return out
