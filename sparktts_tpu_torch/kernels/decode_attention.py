"""Dense-cache decode attention: the hand-written CUDA kernel and its plain
version.

Replaces `dense_decode_attention` of `sparktts_tpu/kernels/decode_attention.py`
(`_decode_kernel`): one query token per batch row against the `layer` plane
of the stacked `(L, B, S, Hkv, D)` KV cache, keys valid in
`[start[b], pos[b]]` (`pos` clamped to S - 1), fp32 accumulation.  An empty
window gives zeros.  The kernel is `csrc/decode_attention.cu`: it splits the
window across blocks, one per `CHUNK` keys of the cache, and merges their
partial softmax states in chunk order within the same launch.  Its header
says what bounds it on an H100 and what the design does about it.
`dense_decode_split_plain` is the CPU model of that split and merge, for the
tests and chip_smoke.py only.

`dense_decode_attention` runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  `launches` counts kernel
launches.  The kernel counts the arrivals of each (row, KV head)'s chunks on
the current stream's int32 counters from `kernels/arrivals.py` (one zeroed
array per stream, left at zero by every launch), so calls on two streams of
one card never share a counter.

While `torch.export` traces (`torch.compiler.is_exporting()`), the wrapper
records its `sparktts_torch::` custom op (`kernels/ops.py`) instead, so that
an exported program runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparktts_tpu_torch.kernels import arrivals, build, ops

SOURCE = "sparktts_tpu_torch/kernels/csrc/decode_attention.cu"
REPLACES = "sparktts_tpu/kernels/decode_attention.py:169"
HEAD_DIM = 64
GROUP = 7  # query heads per KV head the kernel is built for (Qwen2.5-0.5B)

PARTIAL = GROUP * (HEAD_DIM + 2)  # fp32 scratch of one chunk: m, l, acc for each head

launches = 0
_fn = None
_chunk = 0


def bind(lib: ctypes.CDLL):
    """(the launch function, its chunk) of a built decode_attention library."""
    fn = lib.dense_decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dense_decode_chunk.restype = ctypes.c_int
    return fn, lib.dense_decode_chunk()


def _kernel():
    global _fn, _chunk
    if _fn is None:
        _fn, _chunk = bind(build.load("decode_attention"))
    return _fn


def kernel_chunk() -> int:
    """Keys per split of the built kernel (builds it first if needed)."""
    _kernel()
    return _chunk


def dense_decode_plain(
    q: torch.Tensor,        # (B, Hq, D)
    cache_k: torch.Tensor,  # (L, B, S, Hkv, D)
    cache_v: torch.Tensor,
    layer: int,
    start: torch.Tensor,    # (B,) first valid key slot
    pos: torch.Tensor,      # (B,) last valid key slot, inclusive
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Dense fp32 decode attention over cache[layer]; (B, Hq, D) in q.dtype."""
    b, hq, d = q.shape
    ck, cv = cache_k[layer].float(), cache_v[layer].float()  # (B, S, Hkv, D)
    s, hkv = ck.shape[1], ck.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck) * sm_scale
    j = torch.arange(s, device=q.device)[None, :]
    valid = (j >= start.to(q.device)[:, None]) & (j <= pos.to(q.device)[:, None])  # (B, S)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, cv) / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, d).to(q.dtype)


def dense_decode_split_plain(
    q: torch.Tensor,        # (B, Hq, D)
    cache_k: torch.Tensor,  # (L, B, S, Hkv, D)
    cache_v: torch.Tensor,
    layer: int,
    start: torch.Tensor,    # (B,) first valid key slot
    pos: torch.Tensor,      # (B,) last valid key slot, inclusive; clamped to S - 1
    sm_scale: float,
    chunk: int,
) -> torch.Tensor:
    """The kernel's split in fp32: for each `chunk` keys of the cache, the
    partial softmax state (m, l, acc) of the window's keys in it; then the
    partials merged in chunk order, as the kernel's last block merges them.
    (B, Hq, D) in q.dtype; an empty window gives zeros."""
    b, hq, d = q.shape
    ck, cv = cache_k[layer].float(), cache_v[layer].float()  # (B, S, Hkv, D)
    s, hkv = ck.shape[1], ck.shape[2]
    n = -(-s // chunk)
    pad = (0, 0, 0, 0, 0, n * chunk - s)
    ck, cv = F.pad(ck, pad), F.pad(cv, pad)  # (B, n chunk, Hkv, D)
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck) * sm_scale
    j = torch.arange(n * chunk, device=q.device)[None, :]
    lo = start.to(q.device)[:, None]
    hi = torch.clamp(pos.to(q.device), max=s - 1)[:, None]
    valid = ((j >= lo) & (j <= hi))[:, None, None, :]  # (B, 1, 1, n chunk)
    scores = scores.masked_fill(~valid, float("-inf")).unflatten(-1, (n, chunk))
    m = scores.amax(dim=-1)  # (B, Hkv, G, n)
    live = torch.isfinite(m)
    p = torch.exp(scores - torch.where(live, m, torch.zeros_like(m))[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", p, cv.unflatten(1, (n, chunk)))
    top = m.amax(dim=-1)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    total_l = torch.zeros_like(top)
    total = torch.zeros_like(acc[..., 0, :])
    for z in range(n):  # chunk order; a chunk with no valid key adds nothing
        e = torch.where(live[..., z], torch.exp(m[..., z] - top), torch.zeros_like(top))
        total_l = total_l + l[..., z] * e
        total = total + acc[..., z, :] * e[..., None]
    out = total / torch.where(total_l == 0, 1.0, total_l)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def dense_decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    layer: int,
    start: torch.Tensor,
    pos: torch.Tensor,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Decode attention over the dense stacked cache; returns (B, Hq, D)."""
    if torch.compiler.is_exporting():  # an export records the op (kernels/ops.py)
        return ops.dense_decode_attention(q, cache_k, cache_v, int(layer), start, pos,
                                          float(sm_scale))
    if q.device.type == "cpu":
        return dense_decode_plain(q, cache_k, cache_v, layer, start, pos, sm_scale)
    global launches
    b, hq, d = q.shape
    n_layers, cb, s, hkv, cd = cache_k.shape
    if any(x.device != q.device for x in (cache_k, cache_v, start, pos)):
        raise ValueError("dense_decode_attention: all inputs must be on one device")
    if any(x.dtype != torch.bfloat16 for x in (q, cache_k, cache_v)):
        raise TypeError("dense_decode_attention: the CUDA kernel takes bf16 q and cache")
    if d != HEAD_DIM or cd != d or cb != b or cache_v.shape != cache_k.shape:
        raise ValueError(f"dense_decode_attention: unsupported shapes {q.shape} {cache_k.shape}")
    if hq != hkv * GROUP:
        raise ValueError(f"dense_decode_attention: {hq} query heads over {hkv} KV heads")
    if not 0 <= layer < n_layers:
        raise IndexError(f"dense_decode_attention: layer {layer} of {n_layers}")
    if not all(x.is_contiguous() for x in (q, cache_k, cache_v, start, pos)):
        raise ValueError("dense_decode_attention: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, cache_k, cache_v)):
        raise ValueError("dense_decode_attention: q and cache must be 16-byte aligned")
    if any(x.dtype != torch.int32 or x.shape != (b,) for x in (start, pos)):
        raise ValueError("dense_decode_attention: start/pos must be (B,) int32 tensors")
    fn = _kernel()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b, hkv, -(-s // _chunk), PARTIAL), dtype=torch.float32, device=q.device)
    with build.launch_stream(q) as stream:
        counters = arrivals.for_current_stream(q.device, b * hkv)
        err = fn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), start.data_ptr(),
            pos.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(), int(layer), b,
            s, hkv, hq, float(sm_scale), stream,
        )
    launches += 1
    build.note_launch("dense_decode_attention")
    if err != 0:
        raise RuntimeError(f"dense_decode_attention: CUDA launch failed with error {err}")
    return out
