"""A plain Qwen2.5 forward in float32, under the weight-only int8 scheme the
configuration may state.

Qwen2 as published (`transformers`' `modeling_qwen2.py`): RMSNorm before
attention and MLP, q/k/v with biases, rotary embeddings over contiguous
halves (angles in float64), grouped-query attention, SwiGLU, a final RMSNorm
and the head tied to the embedding.  No cache, no kernels, no batching: one
sequence at a time, causal attention over its whole length.  Run it with
the TF32 flags off (`check.fp32_flags`).

The weights are a tree with these keys (layers stacked on a leading axis):
`embed` (V, H); `layers`: `ln1`/`ln2` `gamma` (L, H), `qkv` `w` (L, H, Q+2K)
and `b` (L, Q+2K), `o` `w` (L, Q, H), `gateup` `w` (L, H, 2I) (gate columns,
then up columns), `down` `w` (L, I, H); `final_ln` `gamma` (H,).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

LINEARS = ("qkv", "o", "gateup", "down")


def dequantize(w: torch.Tensor, scheme: str, axis: int) -> torch.Tensor:
    """`w` in float32 as a weight-only scheme stores it.  'int8': symmetric,
    127 levels, one scale per slice along `axis` (the input axis of a
    linear, so a scale per output column; the hidden axis of the embedding,
    so a scale per row), rounding half to even; 'none': the weight as is."""
    w = w.float()
    if scheme == "none":
        return w
    if scheme != "int8":
        raise ValueError(f"unknown weight scheme {scheme!r}")
    scale = w.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(w / scale), -127.0, 127.0) * scale


def float_weights(tree: Dict, scheme: str) -> Dict:
    """The tree in float32, every linear and the embedding under `scheme`."""
    layers = tree["layers"]
    out = {"embed": dequantize(tree["embed"], scheme, axis=1),
           "final_ln": tree["final_ln"]["gamma"].float(),
           "ln1": layers["ln1"]["gamma"].float(), "ln2": layers["ln2"]["gamma"].float(),
           "qkv_b": layers["qkv"]["b"].float()}
    for k in LINEARS:
        out[k] = dequantize(layers[k]["w"], scheme, axis=-2)
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gamma


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


@torch.no_grad()
def logits(w: Dict, cfg: Dict, ids: torch.Tensor, rows: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Float32 logits of one sequence `ids` (T,) at the sequence positions
    `positions`, over the vocabulary rows `rows` only: (len(positions),
    len(rows)).  `cfg` holds the published config's keys."""
    n_layers, nh = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    nkv = cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    eps = cfg["rms_norm_eps"]
    t = ids.shape[0]
    x = w["embed"][ids]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                    device=ids.device) / hd))
    ang = torch.arange(t, dtype=torch.float64, device=ids.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    causal = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
    for i in range(n_layers):
        y = rms_norm(x, w["ln1"][i], eps)
        qkv = y @ w["qkv"][i] + w["qkv_b"][i]
        q = qkv[:, : nh * hd].reshape(t, nh, hd)
        k = qkv[:, nh * hd : (nh + nkv) * hd].reshape(t, nkv, hd)
        v = qkv[:, (nh + nkv) * hd :].reshape(t, nkv, hd)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
        att = torch.einsum("qhd,khd->hqk", q, k) / hd**0.5 + causal
        o = torch.einsum("hqk,khd->qhd", torch.softmax(att, dim=-1), v).reshape(t, nh * hd)
        x = x + o @ w["o"][i]
        y = rms_norm(x, w["ln2"][i], eps)
        gate, up = (y @ w["gateup"][i]).chunk(2, dim=-1)
        x = x + (F.silu(gate) * up) @ w["down"][i]
    h = rms_norm(x[positions], w["final_ln"], eps)
    return h @ w["embed"][rows].T
