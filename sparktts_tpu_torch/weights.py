"""Param trees for the port: conversion from numpy and a random init.

The port's params are nested dicts (and lists) of tensors with the same keys,
shapes and layouts as the JAX package's `init_qwen` (`lm/qwen.py:84`),
`init_bicodec` (`codec/bicodec.py:36`, the whole tree, encode side included)
and `init_wav2vec2` (`nn/wav2vec2.py:38`).  `qwen_state` / `bicodec_state` /
`wav2vec2_state` turn a tree of those keys, of numpy arrays (for instance a
JAX init passed through `np.asarray`) or of CPU tensors (a converted
checkpoint, `checkpoint.py`), into port state on a device; `init_qwen` / `init_bicodec` /
`init_wav2vec2` build random weights of the same keys and shapes directly in
torch, from an explicit `torch.Generator`, with the JAX init's
distributions.  Weight-only quantized trees (`lm/quant.py`,
`codec/quant.py`) convert too: int8 leaves stay int8 and scales stay fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparktts_tpu_torch.config import (
    BiCodecConfig,
    DecoderConfig,
    EncoderConfig,
    QwenConfig,
    SpeakerEncoderConfig,
    WaveGeneratorConfig,
    Wav2Vec2Config,
)


# Leaves under these keys are the fp32 scales of a weight-only quantized
# linear (`lm/quant.py`, `codec/quant.py`): they stay fp32 in a tree of any
# dtype, as in the JAX package.
SCALE_KEYS = ("scale", "gscale")


def to_torch(tree, device, dtype: Optional[torch.dtype] = None):
    """numpy-like or tensor tree -> same tree of tensors on `device`; float
    leaves cast to `dtype` (default: float32), except quantization scales
    (fp32); integer leaves (int8 quantized weights, ids) keep their dtype."""
    if isinstance(tree, dict):
        return {
            k: to_torch(v, device, torch.float32 if k in SCALE_KEYS and not _is_tree(v) else dtype)
            for k, v in tree.items()
        }
    if _is_tree(tree):
        return [to_torch(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.to(device=device, dtype=dtype or torch.float32)
        return tree.to(device)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=device, dtype=dtype or torch.float32)
    return torch.from_numpy(np.array(arr)).to(device)


def _is_tree(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def qwen_state(tree, device, dtype: torch.dtype = torch.bfloat16):
    return to_torch(tree, device, dtype)


def fp32_state(tree, device):
    """The codec and wav2vec2 run in fp32 whatever the tree holds."""
    return to_torch(tree, device, torch.float32)


bicodec_state = wav2vec2_state = fp32_state


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

    def feat_encoder(self, cfg: EncoderConfig) -> dict:
        d = cfg.vocos_dim
        return {
            "encoder": self.vocos(cfg.input_channels, d, cfg.vocos_intermediate_dim,
                                  cfg.vocos_num_layers),
            "downsample": [
                {
                    "sampler": {"conv_downsampler": self.conv(2 * r, 1, d)} if r > 1 else {},
                    "vocos": self.vocos(d, d, cfg.vocos_intermediate_dim, 2),
                }
                for r in cfg.sample_ratios
            ],
            "project": self.linear(d, cfg.out_channels),
        }

    def batch_norm(self, dim: int) -> dict:
        """Eval-form BatchNorm: running statistics baked in."""
        return {"gamma": self.full((dim,), 1.0), "beta": self.full((dim,), 0.0),
                "mean": self.full((dim,), 0.0), "var": self.full((dim,), 1.0)}

    def ecapa(self, feat_dim: int, embed_dim: int, channels: int, latent_dim: int) -> dict:
        def conv_bn(cin, cout, k):
            return {"conv": self.conv(k, cin, cout), "bn": self.batch_norm(cout)}

        width = channels // 8  # Res2 scale 8

        def se_res2_block():
            return {
                "in_conv": conv_bn(channels, channels, 1),
                "res2": {"convs": [self.conv(3, width, width) for _ in range(7)],
                         "bns": [self.batch_norm(width) for _ in range(7)]},
                "out_conv": conv_bn(channels, channels, 1),
                "se": {"l1": self.linear(channels, 128), "l2": self.linear(128, channels)},
            }

        return {
            "layer1": conv_bn(feat_dim, channels, 5),
            "layer2": se_res2_block(),
            "layer3": se_res2_block(),
            "layer4": se_res2_block(),
            "conv": self.conv(1, channels * 3, latent_dim),
            "pool": {"linear1": self.linear(latent_dim * 3, 128),
                     "linear2": self.linear(128, latent_dim)},
            "bn": self.batch_norm(latent_dim * 2),
            "linear": self.linear(latent_dim * 2, embed_dim),
        }

    def perceiver(self, cfg: SpeakerEncoderConfig) -> dict:
        dim, inner = cfg.latent_dim, cfg.perceiver_dim_head * cfg.perceiver_heads
        ff_inner = int(dim * cfg.perceiver_ff_mult * 2 / 3)
        p = {
            "latents": self.normal((cfg.token_num, dim), 0.02),
            "layers": [
                {
                    "attn": {"to_q": self.linear(dim, inner, bias=False),
                             "to_kv": self.linear(dim, 2 * inner, bias=False),
                             "to_out": self.linear(inner, dim, bias=False)},
                    "ff": {"w1": self.linear(dim, 2 * ff_inner), "w2": self.linear(ff_inner, dim)},
                }
                for _ in range(cfg.perceiver_depth)
            ],
            "norm": {"gamma": self.full((dim,), 1.0)},
        }
        if cfg.perceiver_dim_context != dim:
            p["proj_context"] = self.linear(cfg.perceiver_dim_context, dim)
        return p

    def speaker_encoder(self, cfg: SpeakerEncoderConfig) -> dict:
        fsq = {}
        if len(cfg.fsq_levels) != cfg.latent_dim:
            fsq["project_in"] = self.linear(cfg.latent_dim, len(cfg.fsq_levels))
            fsq["project_out"] = self.linear(len(cfg.fsq_levels), cfg.latent_dim)
        return {
            "speaker_encoder": self.ecapa(cfg.input_dim, cfg.out_dim, cfg.ecapa_channels,
                                          cfg.perceiver_dim_context),
            "perceiver_sampler": self.perceiver(cfg),
            "quantizer": fsq,
            "project": self.linear(cfg.latent_dim * cfg.token_num, cfg.out_dim),
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


def init_wave_generator(
    cfg: WaveGeneratorConfig, generator: Optional[torch.Generator] = None, device="cuda"
) -> dict:
    """Random fp32 params of the WaveGenerator alone (the vocoder bench's)."""
    return _Init(generator, device).wave_generator(cfg)


def init_bicodec(
    cfg: BiCodecConfig, generator: Optional[torch.Generator] = None, device="cuda"
) -> dict:
    """Random fp32 params of the whole BiCodec tree."""
    ini = _Init(generator, device)
    q = cfg.quantizer
    quantizer = {"codebook": ini.normal((q.codebook_size, q.codebook_dim))}
    if q.input_dim != q.codebook_dim:
        quantizer["in_project"] = ini.linear(q.input_dim, q.codebook_dim)
        quantizer["out_project"] = ini.linear(q.codebook_dim, q.input_dim)
    return {
        "encoder": ini.feat_encoder(cfg.encoder),
        "quantizer": quantizer,
        "speaker_encoder": ini.speaker_encoder(cfg.speaker_encoder),
        "prenet": ini.feat_decoder(cfg.prenet),
        "postnet": ini.feat_decoder(cfg.postnet),
        "decoder": ini.wave_generator(cfg.decoder),
    }


def init_wav2vec2(
    cfg: Wav2Vec2Config, generator: Optional[torch.Generator] = None, device="cuda"
) -> dict:
    """Random fp32 wav2vec2 params."""
    ini = _Init(generator, device)
    h, pos_groups = cfg.hidden_size, cfg.num_conv_pos_embedding_groups
    conv_layers, in_c = [], 1
    for dim, k in zip(cfg.conv_dim, cfg.conv_kernel):
        conv = ini.conv(k, in_c, dim) if cfg.conv_bias else {"w": ini.trunc((k, in_c, dim))}
        conv_layers.append({"conv": conv, "ln": ini.layer_norm(dim)})
        in_c = dim
    return {
        "conv_layers": conv_layers,
        "fp_ln": ini.layer_norm(cfg.conv_dim[-1]),
        "fp_proj": ini.linear(cfg.conv_dim[-1], h),
        "pos_conv": ini.conv(cfg.num_conv_pos_embeddings, h // pos_groups, h),
        "layers": [
            {
                "ln1": ini.layer_norm(h),
                "q": ini.linear(h, h),
                "k": ini.linear(h, h),
                "v": ini.linear(h, h),
                "o": ini.linear(h, h),
                "ln2": ini.layer_norm(h),
                "ff_in": ini.linear(h, cfg.intermediate_size),
                "ff_out": ini.linear(cfg.intermediate_size, h),
            }
            for _ in range(cfg.num_hidden_layers)
        ],
        "final_ln": ini.layer_norm(h),
    }


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def qwen_place(tree, cfg: QwenConfig, mesh, device=None, dtype: torch.dtype = torch.bfloat16):
    """This rank's part of a whole Qwen tree (numpy, a JAX tree passed
    through `np.asarray`, or tensors) on a (dp, tp, pp) mesh (its tp shard,
    then its stage: `parallel.shardings.place`), on `device` (default: the
    mesh's) in `dtype`; returns (part, the part's config).
    `pipeline.shard_llm` does the same to a pipeline's LM at pp = 1."""
    from sparktts_tpu_torch.parallel.shardings import place, placed_config

    whole = qwen_state(tree, mesh.device if device is None else device, dtype)
    return place(whole, cfg, mesh), placed_config(cfg, mesh)
