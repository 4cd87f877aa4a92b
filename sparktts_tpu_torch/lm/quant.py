"""Weight-only int8 and int4 quantization of the LM's param tree.

Port of `sparktts_tpu/lm/quant.py`, on tensors of any device.  A user
quantizes by applying a function to the tree, as in the JAX package:

    pipe.llm_params = quantize_qwen_int8(pipe.llm_params)

Schemes (the same keys, shapes, rounding and fp32 scales as the JAX
package, so equal fp32 weights give equal ints and scales):

  * int8 linears: {"w_q": int8 (..., in, out), "scale": fp32 (..., out)},
    symmetric per output channel; the scale multiplies the matmul OUTPUT
    (`nn/layers.linear_apply`).
  * int8 embedding: {"w_q": int8 (V, H), "scale": fp32 (V, 1)}, per row; it
    is the lookup table and, tied, the logits projection.
  * int4 linears: {"w_p4": int8 (..., in/2, out) nibble-packed, "gscale":
    fp32 (..., in/group, out)}, scales per group of `group` input rows.

Rounding is round-half-to-even of an fp32 quotient on both sides
(`torch.round`, `jnp.round`).
"""

from __future__ import annotations

import torch

QUANT_KEYS = ("qkv", "o", "gateup", "down")


def _scale(absmax: torch.Tensor, levels: float) -> torch.Tensor:
    scale = absmax / levels
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def quantize_linear_int8(p: dict) -> dict:
    """{"w": (..., in, out), "b"?} -> {"w_q", "scale", "b"?}: per-out-channel
    scales, for single (in, out) and stacked (L, in, out) weights alike."""
    w = p["w"].float()
    scale = _scale(w.abs().amax(dim=-2), 127.0)  # (..., out)
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_embedding_int8(w: torch.Tensor) -> dict:
    """(V, H) embedding -> {"w_q": int8 (V, H), "scale": fp32 (V, 1)}."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=1, keepdim=True), 127.0)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale}


def _quantize_tree(params: dict, quantize_linear) -> dict:
    layers = params["layers"]
    qlayers = {"ln1": layers["ln1"], "ln2": layers["ln2"]}
    for k in QUANT_KEYS:
        qlayers[k] = quantize_linear(layers[k])
    out = {"final_ln": params["final_ln"], "layers": qlayers}
    emb = params["embed"]
    # an embedding that is already quantized passes through
    out["embed"] = emb if isinstance(emb, dict) else quantize_embedding_int8(emb)
    if "lm_head" in params:
        out["lm_head"] = quantize_linear(params["lm_head"])
    return out


def quantize_qwen_int8(params: dict) -> dict:
    """Quantize every transformer linear and the embedding of an LM tree in
    the stacked-layer layout; norms stay as they are."""
    return _quantize_tree(params, quantize_linear_int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Nibble-packed (..., in/2, out) int8 -> (..., in, out) fp32 values.

    The single source of the packing layout: input row 2i is the low nibble
    of packed row i and input row 2i+1 its high nibble, both sign-extended
    (two's complement, -8..7).  Every consumer in the port (the linear's
    prefill path, the plain version of the int4 matvec kernel) unpacks
    through here; `csrc/int4_matmul.cu` does the same in registers."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4).float()
    hi = torch.bitwise_right_shift(packed, 4).float()
    return torch.stack((lo, hi), dim=-2).reshape(
        *packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1]
    )


def quantize_linear_int4(p: dict, group: int = 128) -> dict:
    """{"w": (..., in, out), "b"?} -> {"w_p4": int8 (..., in/2, out),
    "gscale": fp32 (..., in/group, out), "b"?}: scales per group of `group`
    input rows, values clipped to -7..7 and packed two to a byte."""
    w = p["w"].float()
    d_in = w.shape[-2]
    if d_in % group or group % 2:
        raise ValueError(f"quantize_linear_int4: in {d_in} must split into even groups of {group}")
    wg = w.reshape(*w.shape[:-2], d_in // group, group, w.shape[-1])
    scale = _scale(wg.abs().amax(dim=-2), 7.0)  # (..., G, out)
    w_q = torch.clamp(torch.round(wg / scale[..., None, :]), -7, 7).to(torch.int32)
    w_q = w_q.reshape(w.shape)
    lo = w_q[..., 0::2, :] & 0xF
    hi = (w_q[..., 1::2, :] & 0xF) << 4
    # bytes 128..255 wrap to their int8 two's complement, as JAX's astype does
    out = {"w_p4": (lo | hi).to(torch.uint8).view(torch.int8), "gscale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_qwen_int4(params: dict, group: int = 128) -> dict:
    """Int4 for every transformer linear; the embedding stays per-row int8
    (15 levels over a row degrade the tied logits too far)."""
    return _quantize_tree(params, lambda p: quantize_linear_int4(p, group))
