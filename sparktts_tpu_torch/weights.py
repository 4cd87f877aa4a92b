"""Param trees for the port: conversion from numpy and a random init.

The port's params are nested dicts (and lists) of tensors with the same keys,
shapes and layouts as the JAX package's `init_qwen` (`lm/qwen.py:84`) and
`init_bicodec` (`codec/bicodec.py:36`).  `qwen_state` / `bicodec_state` turn
a numpy tree of those keys (for instance a JAX init passed through
`np.asarray`) into port state; `init_qwen` / `init_bicodec` build random
weights of the same keys and shapes directly in torch, from an explicit
`torch.Generator`, with the JAX init's distributions.

Voice creation runs only the BiCodec decode side, so `bicodec_state` and
`init_bicodec` cover the subtrees in `BICODEC_SLICE`.  The encode-side
subtrees (`encoder`, `postnet`, and the speaker encoder's ECAPA
`speaker_encoder` and `perceiver_sampler`) belong to voice cloning and are
skipped until that slice is ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparktts_tpu_torch.config import BiCodecConfig, DecoderConfig, QwenConfig, WaveGeneratorConfig

# top-level BiCodec subtree -> the keys of it the decode path reads (None: all)
BICODEC_SLICE = {
    "quantizer": None,
    "speaker_encoder": ("quantizer", "project"),
    "prenet": None,
    "decoder": None,
}


def to_torch(tree, device, dtype: Optional[torch.dtype] = None):
    """numpy-like tree -> same tree of tensors on `device`; float leaves cast
    to `dtype` (default: float32)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=device, dtype=dtype or torch.float32)
    return torch.from_numpy(np.array(arr)).to(device)


def bicodec_slice(tree) -> dict:
    """The subtrees of a full BiCodec tree that the decode path reads."""
    return {
        name: tree[name] if keys is None else {k: tree[name][k] for k in keys}
        for name, keys in BICODEC_SLICE.items()
    }


def qwen_state(tree, device, dtype: torch.dtype = torch.bfloat16):
    return to_torch(tree, device, dtype)


def bicodec_state(tree, device):
    return to_torch(bicodec_slice(tree), device, torch.float32)


# ---------------------------------------------------------------------------
# random init (same keys, shapes and distributions as the JAX init)
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, generator: Optional[torch.Generator], device):
        self.g = generator
        self.device = device

    def trunc(self, shape, std: float = 0.02) -> torch.Tensor:
        t = torch.empty(shape, device=self.device)
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=self.g)

    def normal(self, shape, std: float = 1.0) -> torch.Tensor:
        return torch.empty(shape, device=self.device).normal_(0.0, std, generator=self.g)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device)

    def linear(self, d_in: int, d_out: int, bias: bool = True) -> dict:
        p = {"w": self.trunc((d_in, d_out))}
        if bias:
            p["b"] = self.full((d_out,), 0.0)
        return p

    def conv(self, k: int, cin_per_group: int, cout: int) -> dict:
        """Conv or transposed-conv kernel (K, Cin // groups, Cout) + bias."""
        return {"w": self.trunc((k, cin_per_group, cout)), "b": self.full((cout,), 0.0)}

    def layer_norm(self, dim: int) -> dict:
        return {"gamma": self.full((dim,), 1.0), "beta": self.full((dim,), 0.0)}

    def ada_layer_norm(self, cond_dim: int, dim: int) -> dict:
        # scale bias 1 so a zero condition modulates as identity (JAX init)
        return {
            "scale": {"w": self.full((cond_dim, dim), 1.0), "b": self.full((dim,), 1.0)},
            "shift": {"w": self.full((cond_dim, dim), 0.0), "b": self.full((dim,), 0.0)},
        }

    def vocos(self, d_in: int, dim: int, inter: int, layers: int, cond: Optional[int] = None):
        def norm():
            return self.ada_layer_norm(cond, dim) if cond else self.layer_norm(dim)

        return {
            "embed": self.conv(7, d_in, dim),
            "blocks": [
                {
                    "dwconv": self.conv(7, 1, dim),
                    "pwconv1": self.linear(dim, inter),
                    "pwconv2": self.linear(inter, dim),
                    "norm": norm(),
                    "gamma": self.full((dim,), 1.0 / layers),
                }
                for _ in range(layers)
            ],
            "final_layer_norm": self.layer_norm(dim),
            "norm": norm(),
        }

    def feat_decoder(self, cfg: DecoderConfig) -> dict:
        d = cfg.vocos_dim
        return {
            "linear_pre": self.linear(cfg.input_channels, d),
            "upsample": [
                {
                    "sampler": {"de_conv_upsampler": self.conv(2 * r, 1, d)} if r > 1 else {},
                    "vocos": self.vocos(d, d, cfg.vocos_intermediate_dim, 2),
                }
                for r in cfg.sample_ratios
            ],
            "vocos_backbone": self.vocos(
                d, d, cfg.vocos_intermediate_dim, cfg.vocos_num_layers, cfg.condition_dim
            ),
            "linear": self.linear(d, cfg.out_channels),
        }

    def residual_unit(self, dim: int) -> dict:
        return {
            "snake1": {"alpha": self.full((dim,), 1.0)},
            "conv1": self.conv(7, dim, dim),
            "snake2": {"alpha": self.full((dim,), 1.0)},
            "conv2": self.conv(1, dim, dim),
        }

    def wave_generator(self, cfg: WaveGeneratorConfig) -> dict:
        blocks = []
        out_dim = cfg.channels
        for i, k in enumerate(cfg.kernel_sizes):
            in_dim, out_dim = cfg.channels // 2**i, cfg.channels // 2 ** (i + 1)
            blocks.append(
                {
                    "snake": {"alpha": self.full((in_dim,), 1.0)},
                    "upsample": self.conv(k, in_dim, out_dim),
                    "res_units": [self.residual_unit(out_dim) for _ in range(3)],
                }
            )
        return {
            "conv_in": self.conv(7, cfg.input_channel, cfg.channels),
            "blocks": blocks,
            "snake_out": {"alpha": self.full((out_dim,), 1.0)},
            "conv_out": self.conv(7, out_dim, cfg.d_out),
        }


def init_qwen(
    cfg: QwenConfig,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> dict:
    """Random LM params, layers stacked with a leading L dim."""
    ini = _Init(generator, device)
    n, h = cfg.num_hidden_layers, cfg.hidden_size
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
    q_dim, inter = cfg.num_attention_heads * cfg.head_dim, cfg.intermediate_size
    params = {
        "embed": ini.normal((cfg.vocab_size, h), 0.02),
        "layers": {
            "ln1": {"gamma": ini.full((n, h), 1.0)},
            "qkv": {"w": ini.trunc((n, h, qkv)), "b": ini.full((n, qkv), 0.0)},
            "o": {"w": ini.trunc((n, q_dim, h))},
            "ln2": {"gamma": ini.full((n, h), 1.0)},
            "gateup": {"w": ini.trunc((n, h, 2 * inter))},
            "down": {"w": ini.trunc((n, inter, h))},
        },
        "final_ln": {"gamma": ini.full((h,), 1.0)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": ini.trunc((h, cfg.vocab_size))}
    return _cast(params, dtype)


def init_bicodec(
    cfg: BiCodecConfig, generator: Optional[torch.Generator] = None, device="cuda"
) -> dict:
    """Random fp32 params of the BiCodec subtrees in `BICODEC_SLICE`."""
    ini = _Init(generator, device)
    q, se = cfg.quantizer, cfg.speaker_encoder
    quantizer = {"codebook": ini.normal((q.codebook_size, q.codebook_dim))}
    if q.input_dim != q.codebook_dim:
        quantizer["in_project"] = ini.linear(q.input_dim, q.codebook_dim)
        quantizer["out_project"] = ini.linear(q.codebook_dim, q.input_dim)
    fsq = {}
    if len(se.fsq_levels) != se.latent_dim:
        fsq["project_in"] = ini.linear(se.latent_dim, len(se.fsq_levels))
        fsq["project_out"] = ini.linear(len(se.fsq_levels), se.latent_dim)
    return {
        "quantizer": quantizer,
        "speaker_encoder": {
            "quantizer": fsq,
            "project": ini.linear(se.latent_dim * se.token_num, se.out_dim),
        },
        "prenet": ini.feat_decoder(cfg.prenet),
        "decoder": ini.wave_generator(cfg.decoder),
    }


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)
