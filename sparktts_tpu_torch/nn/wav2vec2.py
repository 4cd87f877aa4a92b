"""wav2vec2-large-xlsr-53 forward pass (the semantic feature extractor).

Port of `sparktts_tpu/nn/wav2vec2.py`: a layer-normed conv feature encoder,
a grouped positional conv (k=128, 16 groups, trailing sample trimmed for
the even kernel), and a pre-LN transformer whose `hidden_states` follow
Hugging Face's indexing: entry i is the input to layer i, and the last entry
is the final layer-normed output.  The features are the mean of hidden
states 11, 14 and 16.  Everything runs in fp32.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sparktts_tpu_torch.config import Wav2Vec2Config
from sparktts_tpu_torch.nn.layers import (
    conv1d_apply,
    full_fp32,
    gelu,
    layer_norm_apply,
    linear_apply,
)


def feature_lengths(cfg: Wav2Vec2Config, input_length: int) -> int:
    """Frame count of the conv feature encoder for a wav of `input_length`."""
    length = input_length
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
    return length


def normalize_input(wav: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Per-utterance zero mean, unit variance (the feature extractor's
    `do_normalize`), on the host."""
    mean = wav.mean(axis=-1, keepdims=True)
    var = wav.var(axis=-1, keepdims=True)
    return (wav - mean) / np.sqrt(var + eps)


def _feature_encoder(p, wav: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    """wav (B, T) -> features (B, T', conv_dim[-1]), in the params' dtype."""
    x = wav[..., None]
    for layer, s in zip(p["conv_layers"], cfg.conv_stride):
        x = conv1d_apply(layer["conv"], x, stride=s)
        if cfg.feat_extract_norm == "layer":
            x = layer_norm_apply(layer["ln"], x, eps=cfg.layer_norm_eps)
        x = gelu(x)
    return x


def _pos_conv_embed(p, x: torch.Tensor, cfg: Wav2Vec2Config) -> torch.Tensor:
    k = cfg.num_conv_pos_embeddings
    y = conv1d_apply(p["pos_conv"], x, padding=k // 2, groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        y = y[:, :-1, :]
    return gelu(y)


def _attention(layer, x: torch.Tensor, cfg: Wav2Vec2Config, mask_bias) -> torch.Tensor:
    b, t, h = x.shape
    nh = cfg.num_attention_heads
    hd = h // nh

    def heads(name):
        return linear_apply(layer[name], x).reshape(b, t, nh, hd).transpose(1, 2)

    q = heads("q") * hd**-0.5
    scores = torch.einsum("bhid,bhjd->bhij", q, heads("k"))
    if mask_bias is not None:
        scores = scores + mask_bias
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhij,bhjd->bhid", attn, heads("v")).transpose(1, 2).reshape(b, t, h)
    return linear_apply(layer["o"], out)


def wav2vec2_hidden_states(
    p, wav: torch.Tensor, cfg: Wav2Vec2Config, feature_mask: Optional[torch.Tensor] = None
) -> List[torch.Tensor]:
    """wav (B, T) -> [(B, T', H)] hidden states with Hugging Face's indexing.

    `feature_mask` (B, T') bool marks the true frames of a padded batch: pad
    frames are zeroed before the positional conv and pad keys get a finite
    -1e9 attention bias, exactly as in the JAX package.
    """
    x = layer_norm_apply(p["fp_ln"], _feature_encoder(p, wav, cfg), eps=cfg.layer_norm_eps)
    x = linear_apply(p["fp_proj"], x)

    mask_bias = None
    if feature_mask is not None:
        x = x * feature_mask[..., None].to(x.dtype)
        mask_bias = torch.where(feature_mask, 0.0, -1e9).to(x.dtype)[:, None, None, :]

    x = x + _pos_conv_embed(p, x, cfg)
    hidden_states = [x]
    for layer in p["layers"]:
        y = layer_norm_apply(layer["ln1"], x, eps=cfg.layer_norm_eps)
        x = x + _attention(layer, y, cfg, mask_bias)
        y = layer_norm_apply(layer["ln2"], x, eps=cfg.layer_norm_eps)
        x = x + linear_apply(layer["ff_out"], gelu(linear_apply(layer["ff_in"], y)))
        hidden_states.append(x)
    hidden_states[-1] = layer_norm_apply(p["final_ln"], x, eps=cfg.layer_norm_eps)
    return hidden_states


@full_fp32()
def wav2vec2_features(
    p, wav: torch.Tensor, cfg: Wav2Vec2Config, feature_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The reference's feature mix: the mean of hidden_states[11, 14, 16]."""
    hs = wav2vec2_hidden_states(p, wav, cfg, feature_mask)
    return sum(hs[i] for i in cfg.hidden_state_mix) / len(cfg.hidden_state_mix)
