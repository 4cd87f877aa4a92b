"""Qwen2.5 causal LM: prefill and single-token decode over a preallocated
stacked KV cache.

Port of `sparktts_tpu/lm/qwen.py`.  Params keep the JAX tree: layer params
stacked with a leading L dim, linear weights `(in, out)`, q/k/v fused into
one `qkv` block and gate/up into one `gateup` block.  The cache is a pair of
`(L, B, S, n_kv, hd)` tensors written IN PLACE (the JAX version threads it
through a scan carry that XLA aliases).  Prompts are left-padded, so every
row's cache is aligned at the right edge of the prefill window and decode
writes one shared slot per step.  The continuous engine (`lm/continuous.py`)
right-pads instead.  Every decode step passes a (B,) device write position
(each row writes at its own slot; `generate` gives every row the same one),
so no step depends on a host int and a CUDA graph can replay it.

Attention goes through the two kernel modules: prefill through
`kernels.flash_attention` when `flash_start` is given, every decode step
through `kernels.decode_attention`.  Both run their plain version on CPU
tensors and their CUDA kernel on CUDA tensors.  Without `flash_start`,
prefill runs the dense masked-bias attention below.  RoPE runs in fp32 and
logits are fp32; everything else follows the params dtype (for a quantized
tree, the dtype of its norm gains).

Weight-only quantized trees (`lm/quant.py`) run as in the JAX package: int8
or int4 linears through `nn/layers.linear_apply`, an int8 embedding with its
per-row scale in the lookup and the tied logits, and on a decode step an
int8 MLP through the fused kernel module `kernels.int8_mlp`.  An untied
config projects through its own `lm_head` (`head_logits`): bf16, int8 or
int4, its guided columns selected before they are dequantized.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.kernels.decode_attention import dense_decode_attention
from sparktts_tpu_torch.kernels.flash_attention import flash_attention_prefill
from sparktts_tpu_torch.kernels.int8_mlp import MAX_ROWS as MLP_MATVEC_ROWS
from sparktts_tpu_torch.kernels.int8_mlp import int8_mlp_matvec
from sparktts_tpu_torch.lm.quant import unpack_int4
from sparktts_tpu_torch.nn.layers import linear_apply, rms_norm_apply


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, S, n_kv, hd)
    v: torch.Tensor  # (L, B, S, n_kv, hd)


def aligned_cache_len(n: int) -> int:
    """Round a KV-cache length up to 64 (the JAX decode kernel's S-block);
    kept so both packages size the same cache."""
    return ((n + 63) // 64) * 64


def init_kv_cache(
    cfg: QwenConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"
) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def unstack_layers(layers) -> List[dict]:
    """Stacked (L, ...) layer tree -> one tree of views per layer."""
    split = {name: {k: t.unbind(0) for k, t in sub.items()} for name, sub in layers.items()}
    n = len(layers["ln1"]["gamma"])
    return [
        {name: {k: ts[i] for k, ts in sub.items()} for name, sub in split.items()}
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(cfg: QwenConfig) -> np.ndarray:
    hd = cfg.head_dim
    return 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


_INV_FREQ: Dict[Tuple[float, int, torch.device], torch.Tensor] = {}


def rope_inv_freq(cfg: QwenConfig, device: torch.device) -> torch.Tensor:
    """The fp32 RoPE frequencies on `device`, uploaded once per (theta,
    head_dim, device): a host-to-card copy on every step could not be
    captured in a CUDA graph."""
    key = (cfg.rope_theta, cfg.head_dim, device)
    inv_freq = _INV_FREQ.get(key)
    if inv_freq is None:
        inv_freq = torch.as_tensor(rope_frequencies(cfg), dtype=torch.float32, device=device)
        _INV_FREQ[key] = inv_freq
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, cfg: QwenConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, T) -> fp32 cos/sin (B, T, 1, hd/2), shared by all layers."""
    inv_freq = rope_inv_freq(cfg, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF 'neox' rotation over contiguous halves, in fp32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: QwenConfig) -> torch.Tensor:
    """x: (B, T, n_heads, hd); positions: (B, T)."""
    return _rotate(x, *rope_cos_sin(positions, cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def project_qkv(layer, x: torch.Tensor, rope, cfg: QwenConfig):
    """Fused QKV projection + RoPE.  x: (B, T, H) -> q (B, T, nh, hd),
    k/v (B, T, nkv, hd)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = linear_apply(layer["qkv"], x)
    q_dim, kv_dim = nh * hd, nkv * hd
    q = qkv[..., :q_dim].reshape(b, t, nh, hd)
    k = qkv[..., q_dim : q_dim + kv_dim].reshape(b, t, nkv, hd)
    v = qkv[..., q_dim + kv_dim :].reshape(b, t, nkv, hd)
    return _rotate(q, *rope), _rotate(k, *rope), v


def _attention_block(
    layer,
    x: torch.Tensor,
    rope,
    cache: KVCache,
    layer_idx: int,
    write_pos: int | torch.Tensor,
    key_mask_bias: Optional[torch.Tensor],
    cfg: QwenConfig,
    flash_start: Optional[torch.Tensor] = None,
    decode_window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Attention for prefill (T >= 1) and decode (T == 1).

    New K/V are written into cache plane `layer_idx` at [write_pos,
    write_pos + T), in place; a (B,) tensor write_pos writes row b's T keys
    at its own [write_pos[b], write_pos[b] + T), which must lie in [0, S)
    (a decode step, T == 1, or a speculative verify window, T == k), with
    no host read of the position.
    flash_start (B,) int32: prefill from slot 0 through the flash kernel
    module.  decode_window ((B,) start, (B,) pos)
    int32: T == 1 decode through the decode kernel module, keys valid in
    [start, pos].  Otherwise key_mask_bias (B, T, S), an additive fp32 bias
    encoding causality and left padding, masks a dense attention."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = project_qkv(layer, x, rope, cfg)
    if isinstance(write_pos, torch.Tensor):
        if t == 1:  # a decode step: no window offsets to add
            rows, cols, new_k, new_v = (torch.arange(b, device=x.device), write_pos.long(),
                                        k[:, 0], v[:, 0])
        else:
            rows = torch.arange(b, device=x.device)[:, None]
            cols = write_pos.long()[:, None] + torch.arange(t, device=x.device)[None, :]
            new_k, new_v = k, v
        cache.k[layer_idx].index_put_((rows, cols), new_k.to(cache.k.dtype))
        cache.v[layer_idx].index_put_((rows, cols), new_v.to(cache.v.dtype))
    else:
        cache.k[layer_idx, :, write_pos : write_pos + t] = k
        cache.v[layer_idx, :, write_pos : write_pos + t] = v

    if flash_start is not None:
        out = flash_attention_prefill(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), flash_start,
            sm_scale=hd**-0.5,
        ).transpose(1, 2)
    elif decode_window is not None:
        start, pos = decode_window
        out = dense_decode_attention(
            q.reshape(b, nh, hd), cache.k, cache.v, layer_idx, start, pos, sm_scale=hd**-0.5
        )
    else:
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]  # (B, S, nkv, hd)
        qg = q.reshape(b, t, nkv, nh // nkv, hd)
        scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), ck.float()) * hd**-0.5
        scores = scores + key_mask_bias[:, None, None, :, :]
        probs = torch.softmax(scores, dim=-1).to(cv.dtype)
        out = torch.einsum("bkgts,bskh->btkgh", probs, cv)
    out = out.reshape(b, t, nh * hd).to(x.dtype)
    return linear_apply(layer["o"], out)


def mlp_block(layer, x: torch.Tensor, decode_fused: bool = False) -> torch.Tensor:
    """SwiGLU MLP.  On a decode step (`decode_fused`) of at most
    MLP_MATVEC_ROWS rows whose gate/up and down are int8 without biases, the
    fused kernel module computes it (its numbers are the unfused path's up
    to fp32 summation order); otherwise the unfused path below."""
    gu_p, down_p = layer["gateup"], layer["down"]
    b, t, h = x.shape
    if (
        decode_fused
        and "w_q" in gu_p
        and "w_q" in down_p
        and "b" not in gu_p
        and "b" not in down_p
        and b * t <= MLP_MATVEC_ROWS
    ):
        y = int8_mlp_matvec(x.reshape(b * t, h).contiguous(), gu_p["w_q"], gu_p["scale"],
                            down_p["w_q"], down_p["scale"])
        return y.reshape(b, t, h)
    gate, up = linear_apply(gu_p, x).chunk(2, dim=-1)
    return linear_apply(down_p, F.silu(gate) * up)


def qwen_forward(
    params,
    cfg: QwenConfig,
    input_ids: torch.Tensor,    # (B, T) int64
    positions: torch.Tensor,    # (B, T) RoPE positions
    cache: KVCache,
    write_pos: int | torch.Tensor,  # cache slot of input_ids[:, 0]; (B,) per row
    key_mask_bias: Optional[torch.Tensor],  # (B, T, S) additive bias
    flash_start: Optional[torch.Tensor] = None,
    decode_window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
    logits_last_only: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Token ids -> fp32 logits (B, T, V) and the cache (updated in place).

    vocab_slice/extra_ids constrain the OUTPUT vocabulary (guided decoding):
    logits cover embedding rows [lo, hi) then `extra_ids`, in that packed
    order.  logits_last_only computes logits for the final position only."""
    x = embed_lookup(params, input_ids)
    rope = rope_cos_sin(positions, cfg)
    for li, layer in enumerate(unstack_layers(params["layers"])):
        y = rms_norm_apply(layer["ln1"], x, eps=cfg.rms_norm_eps)
        x = x + _attention_block(
            layer, y, rope, cache, li, write_pos, key_mask_bias, cfg,
            flash_start=flash_start, decode_window=decode_window,
        )
        y = rms_norm_apply(layer["ln2"], x, eps=cfg.rms_norm_eps)
        x = x + mlp_block(layer, y, decode_fused=decode_window is not None and y.shape[1] == 1)
    if logits_last_only:
        x = x[:, -1:]
    x = rms_norm_apply(params["final_ln"], x, eps=cfg.rms_norm_eps)
    return output_logits(params, cfg, x, vocab_slice, extra_ids), cache


def output_logits(params, cfg: QwenConfig, x: torch.Tensor, vocab_slice=None,
                  extra_ids: Tuple[int, ...] = ()) -> torch.Tensor:
    """The final hidden states' fp32 logits: through the tied embedding or,
    for an untied config, through `lm_head`."""
    if cfg.tie_word_embeddings:
        return lm_logits(params, x, vocab_slice=vocab_slice, extra_ids=extra_ids)
    return head_logits(params, x, vocab_slice=vocab_slice, extra_ids=extra_ids)


def embed_lookup(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows; an int8 table's rows are cast to the dtype of the norm
    gains and times their row scale in that dtype."""
    emb = params["embed"]
    if isinstance(emb, dict):
        dt = params["final_ln"]["gamma"].dtype
        return emb["w_q"][input_ids].to(dt) * emb["scale"][input_ids].to(dt)
    return F.embedding(input_ids, emb)


def _select_vocab_rows(w: torch.Tensor, vocab_slice, extra_ids) -> torch.Tensor:
    """Rows [lo, hi) then the `extra_ids` rows (host ints: no index upload)."""
    lo, hi = vocab_slice
    rows = [w[lo:hi]] + [w[e : e + 1] for e in extra_ids]
    return torch.cat(rows, dim=0) if extra_ids else rows[0]


def lm_logits(
    params,
    x: torch.Tensor,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Tied-embedding logits in fp32 (products of the params-dtype values,
    summed in fp32).  An int8 table's fp32 row scale multiplies the fp32
    logits; with vocab_slice, the scale rows are selected as the table's."""
    emb = params["embed"]
    w, scale = (emb["w_q"], emb["scale"][:, 0]) if isinstance(emb, dict) else (emb, None)
    if vocab_slice is not None:
        w = _select_vocab_rows(w, vocab_slice, extra_ids)
        if scale is not None:
            scale = _select_vocab_rows(scale, vocab_slice, extra_ids)
    logits = torch.matmul(x.float(), w.float().T)
    return logits if scale is None else logits * scale


def _select_vocab_cols(w: torch.Tensor, vocab_slice, extra_ids) -> torch.Tensor:
    """Columns [lo, hi) then the `extra_ids` columns of a (..., V) table."""
    lo, hi = vocab_slice
    cols = [w[:, lo:hi]] + [w[:, e : e + 1] for e in extra_ids]
    return torch.cat(cols, dim=1) if extra_ids else cols[0]


def head_logits(
    params,
    x: torch.Tensor,
    vocab_slice: Optional[Tuple[int, int]] = None,
    extra_ids: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Untied `lm_head` logits in fp32 (the head is (H, V): guided rows of
    the tied table are guided columns here).  Products of x's dtype summed
    in fp32, as `lm_logits`.  An int4 head (`w_p4`/`gscale`) has its guided
    columns selected first and only those dequantized, since a whole-table
    dequant in every decode step would move hundreds of MB; an int8 head
    (`w_q`/`scale`) multiplies the fp32 logits by its selected scales.
    Without a constraint the head is a plain `linear_apply`."""
    head = params["lm_head"]
    if vocab_slice is None:
        return linear_apply(head, x).float()
    scale = None
    if "w_p4" in head:
        packed = _select_vocab_cols(head["w_p4"], vocab_slice, extra_ids)  # (H/2, W)
        gscale = _select_vocab_cols(head["gscale"], vocab_slice, extra_ids)  # (G, W)
        w_sel = unpack_int4(packed)  # (H, W) fp32
        group = w_sel.shape[0] // gscale.shape[0]
        w = (w_sel * gscale.repeat_interleave(group, dim=0)).T
    elif "w_q" in head:
        w = _select_vocab_cols(head["w_q"], vocab_slice, extra_ids).T
        scale = _select_vocab_cols(head["scale"].reshape(1, -1), vocab_slice, extra_ids)[0]
    else:
        w = _select_vocab_cols(head["w"], vocab_slice, extra_ids).T
    logits = torch.matmul(x.float(), w.to(x.dtype).float().T)
    if scale is not None:
        logits = logits * scale
    if "b" in head:
        logits = logits + _select_vocab_cols(head["b"].reshape(1, -1), vocab_slice, extra_ids)[0]
    return logits


# ---------------------------------------------------------------------------
# masks / positions for the left-padded layout
# ---------------------------------------------------------------------------


def prefill_positions(prompt_mask: torch.Tensor) -> torch.Tensor:
    """prompt_mask (B, T_pad) bool, True on real tokens, left-padded ->
    RoPE positions (B, T_pad) (0 on the pad slots)."""
    return (prompt_mask.long().cumsum(dim=1) - 1).clamp_min(0)


def prefill_inputs(prompt_mask: torch.Tensor, max_cache_len: int):
    """Returns (positions (B, T_pad), key_mask_bias (B, T_pad, S))."""
    b, t = prompt_mask.shape
    dev = prompt_mask.device
    q_idx = torch.arange(t, device=dev)[None, :, None]
    k_idx = torch.arange(max_cache_len, device=dev)[None, None, :]
    causal = k_idx <= q_idx
    pad_ok = F.pad(prompt_mask, (0, max_cache_len - t))[:, None, :]
    bias = torch.where(causal & pad_ok, 0.0, -1e9).float()
    return prefill_positions(prompt_mask), bias
