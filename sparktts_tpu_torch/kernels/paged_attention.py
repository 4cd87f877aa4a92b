"""Paged-KV decode attention: the hand-written CUDA kernel and its plain
version.

Replaces `paged_decode_attention` of `sparktts_tpu/kernels/paged_attention.py`
(`_paged_kernel`): one query token per slot against the `layer` plane of the
stacked `(L, Hkv, n_pages, P, D)` K and V pools, keys `[0, lengths[b])` read
through the slot's row of the `(B, pages_per_slot)` int32 page table, fp32
accumulation, output in q's dtype.  A slot of length 0 gives zeros; keys
past the table are not read (a finished slot's length runs one past it).
The kernel is `csrc/paged_attention.cu`: it splits each slot's keys across
blocks, one per `CHUNK` keys of the table, and merges their partial softmax
states in chunk order within the same launch (kernel 2's split, through the
page table).  Its header says what bounds it on an H100 and what the design
does about it.  `paged_decode_split_plain` is the CPU model of that split
and merge, for the tests and chip_smoke.py only.

`paged_decode_attention` runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  `launches` counts kernel
launches (one per call).  The merge counts arrivals on the current stream's
counters from `kernels/arrivals.py`.
"""

from __future__ import annotations

import ctypes

import torch

from sparktts_tpu_torch.kernels import arrivals, build
from sparktts_tpu_torch.kernels.decode_attention import PARTIAL, dense_decode_split_plain

SOURCE = "sparktts_tpu_torch/kernels/csrc/paged_attention.cu"
REPLACES = "sparktts_tpu/kernels/paged_attention.py:158"
HEAD_DIM = 64
GROUP = 7  # query heads per KV head the kernel is built for (Qwen2.5-0.5B)

launches = 0
_fn = None
_chunk = 0


def bind(lib: ctypes.CDLL):
    """(the launch function, its chunk) of a built paged_attention library."""
    fn = lib.paged_decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_decode_chunk.restype = ctypes.c_int
    return fn, lib.paged_decode_chunk()


def _kernel():
    global _fn, _chunk
    if _fn is None:
        _fn, _chunk = bind(build.load("paged_attention"))
    return _fn


def kernel_chunk() -> int:
    """Keys per split of the built kernel (builds it first if needed)."""
    _kernel()
    return _chunk


def _gather(pages: torch.Tensor, page_table: torch.Tensor, layer: int) -> torch.Tensor:
    """Each slot's pages of pool[layer] in table order: (B, Hkv, pps P, D)."""
    p = pages[layer]  # (Hkv, n_pages, P, D)
    b, pps = page_table.shape
    return p[:, page_table.long()].transpose(0, 1).reshape(b, p.shape[0], pps * p.shape[2],
                                                           p.shape[3])


def paged_decode_plain(
    q: torch.Tensor,           # (B, Hq, D)
    k_pages: torch.Tensor,     # (L, Hkv, n_pages, P, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, pages_per_slot) int32
    lengths: torch.Tensor,     # (B,) valid keys per slot
    layer: int,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Gathers each slot's pages of pool[layer] and takes a masked fp32
    softmax (-inf past the length, an empty row gives zeros); (B, Hq, D) in
    q.dtype."""
    b, hq, d = q.shape
    k = _gather(k_pages, page_table, layer).float()  # (B, Hkv, S, D)
    v = _gather(v_pages, page_table, layer).float()
    hkv, s = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * sm_scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]  # (B, S)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v) / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_split_plain(
    q: torch.Tensor,           # (B, Hq, D)
    k_pages: torch.Tensor,     # (L, Hkv, n_pages, P, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, pages_per_slot) int32
    lengths: torch.Tensor,     # (B,) valid keys per slot
    layer: int,
    sm_scale: float,
    chunk: int,
) -> torch.Tensor:
    """The kernel's split in fp32: each slot's keys gathered through its
    table row, the partial softmax state of each `chunk` keys of the table,
    merged in chunk order (`dense_decode_split_plain` over the gathered keys,
    window [0, min(len, pps P) - 1]); an empty slot gives zeros."""
    k = _gather(k_pages, page_table, layer).transpose(1, 2)[None]  # (1, B, S, Hkv, D)
    v = _gather(v_pages, page_table, layer).transpose(1, 2)[None]
    lens = lengths.to(q.device).to(torch.int32)
    return dense_decode_split_plain(q, k, v, 0, torch.zeros_like(lens), lens - 1, sm_scale, chunk)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Decode attention over the paged pools; returns (B, Hq, D)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_table, lengths, layer, sm_scale)
    global launches
    b, hq, d = q.shape
    if k_pages.dim() != 5 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: pools of shapes {k_pages.shape} {v_pages.shape}")
    n_layers, hkv, n_pages, page, pd = k_pages.shape
    if any(x.device != q.device for x in (k_pages, v_pages, page_table, lengths)):
        raise ValueError("paged_decode_attention: all inputs must be on one device")
    if any(x.dtype != torch.bfloat16 for x in (q, k_pages, v_pages)):
        raise TypeError("paged_decode_attention: the CUDA kernel takes bf16 q and pools")
    if d != HEAD_DIM or pd != d:
        raise ValueError(f"paged_decode_attention: unsupported head dim {q.shape} {k_pages.shape}")
    if hq != hkv * GROUP:
        raise ValueError(f"paged_decode_attention: {hq} query heads over {hkv} KV heads")
    if not 0 <= layer < n_layers:
        raise IndexError(f"paged_decode_attention: layer {layer} of {n_layers}")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"paged_decode_attention: page table {page_table.shape}, lengths "
                         f"{lengths.shape} for {b} slots")
    if any(x.dtype != torch.int32 for x in (page_table, lengths)):
        raise ValueError("paged_decode_attention: page_table and lengths must be int32")
    if not all(x.is_contiguous() for x in (q, k_pages, v_pages, page_table, lengths)):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_attention: q and pools must be 16-byte aligned")
    fn = _kernel()
    pps = page_table.shape[1]
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b, hkv, -(-pps * page // _chunk), PARTIAL), dtype=torch.float32,
                       device=q.device)
    with build.launch_stream(q) as stream:
        counters = arrivals.for_current_stream(q.device, b * hkv)
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(), int(layer),
            b, hkv, hq, n_pages, page, pps, float(sm_scale), stream,
        )
    launches += 1
    build.note_launch("paged_decode_attention")
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA launch failed with error {err}")
    return out
