"""Checkpoint loading: safetensors files and torch-named state dicts -> the
port's param trees.

Port of `sparktts_tpu/checkpoint.py`.  The published Spark-TTS-0.5B layout
holds three torch checkpoints: `LLM/` (an HF Qwen2ForCausalLM, BF16),
`BiCodec/model.safetensors` and `wav2vec2-large-xlsr-53/` (fp32).  The
converters here turn their state dicts into trees with the JAX package's
keys and layouts, on the CPU, in the dtype each file stores:

  * torch Linear (out, in)                  -> (in, out)
  * torch Conv1d (Cout, Cin/g, K)           -> WIO (K, Cin/g, Cout)
  * torch ConvTranspose1d (Cin, Cout/g, K)  -> the forward-conv WIO kernel
    of its lhs-dilated form (K flipped, channels regrouped)
  * weight_norm (g, v)                      -> the folded weight g v / |v|
  * BatchNorm running statistics            -> inference-form params

The reader is the port's own: the format is an 8-byte little-endian header
length, a JSON header of names, dtypes, shapes and byte offsets, then the raw
bytes, read here with `torch.frombuffer`.  BF16 (the published LLM's dtype)
becomes torch.bfloat16 directly: numpy has no bfloat16 of its own, and the
JAX package's `safetensors.numpy` reader reads one only once `ml_dtypes`
(which jax imports) is loaded.

Converted trees can be cached (`save_param_cache` / `load_param_cache`, the
JAX package's orbax cache): one safetensors file per tree, written by the
port's own writer (`save_safetensors`), its leaves under their flattened tree
paths and the tree's shape in the header's metadata.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

State = Dict[str, torch.Tensor]

SAFETENSORS_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path: str | Path) -> State:
    """A safetensors file -> {name: CPU tensor} in the stored dtype.  The
    tensors are views of one buffer that holds the file's data."""
    return read_safetensors(path)[0]


def read_safetensors(path: str | Path) -> Tuple[State, Dict[str, str]]:
    """(`load_safetensors`'s tensors, the header's string metadata)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    metadata = header.pop("__metadata__", None) or {}
    out: State = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader lacks")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count != (int(torch.Size(shape).numel())):
            raise ValueError(f"{path}: {name} holds {count} values for shape {shape}")
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else (
            torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out, metadata


def save_safetensors(path: str | Path, tensors: State,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` as a safetensors file: the 8-byte little-endian header
    length, the JSON header (dtype, shape, byte offsets; `metadata` as its
    `__metadata__` strings), then each tensor's bytes in order.  Tensors on
    a card are copied to the host first."""
    names = {dtype: name for name, dtype in SAFETENSORS_DTYPES.items()}
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset, blobs = 0, []
    for name, t in tensors.items():
        flat = t.detach().contiguous().cpu().reshape(-1)
        nbytes = flat.numel() * flat.element_size()
        header[name] = {"dtype": names[flat.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(flat)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for flat in blobs:
            f.write(flat.view(torch.uint8).numpy().data)


def load_hf_state(model_dir: str | Path) -> State:
    """An HF model directory's weights: `model.safetensors`, else the shards
    `model-*.safetensors`, else `pytorch_model.bin` (tensors only)."""
    model_dir = Path(model_dir)
    single = model_dir / "model.safetensors"
    if single.exists():
        return load_safetensors(single)
    shards = sorted(model_dir.glob("model-*.safetensors"))
    if shards:
        out: State = {}
        for shard in shards:
            out.update(load_safetensors(shard))
        return out
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        return dict(torch.load(bin_path, map_location="cpu", weights_only=True))
    raise FileNotFoundError(f"no weights found under {model_dir}")


# ---------------------------------------------------------------------------
# primitive converters
# ---------------------------------------------------------------------------


def _with_bias(p: dict, state: State, prefix: str) -> dict:
    if f"{prefix}.bias" in state:
        p["b"] = state[f"{prefix}.bias"].clone()
    return p


def t_linear(state: State, prefix: str) -> dict:
    return _with_bias({"w": state[f"{prefix}.weight"].T.contiguous()}, state, prefix)


def t_conv1d(state: State, prefix: str) -> dict:
    return _with_bias({"w": state[f"{prefix}.weight"].permute(2, 1, 0).contiguous()}, state, prefix)


def _wn_weight(state: State, prefix: str, dim: int) -> torch.Tensor:
    """The weight_norm fold g v / |v| (the norm over every dim but `dim`),
    in float64, cast back to v's dtype; a plain `weight` passes through."""
    for g_key, v_key in (
        (f"{prefix}.weight_g", f"{prefix}.weight_v"),
        (
            f"{prefix}.parametrizations.weight.original0",
            f"{prefix}.parametrizations.weight.original1",
        ),
    ):
        if g_key in state:
            g, v = state[g_key], state[v_key]
            axes = tuple(i for i in range(v.ndim) if i != dim)
            v64 = v.double()
            norm = v64.square().sum(dim=axes, keepdim=True).sqrt()
            return (g.double() / norm * v64).to(v.dtype)
    return state[f"{prefix}.weight"]


def t_wn_conv1d(state: State, prefix: str, dim: int = 0) -> dict:
    w = _wn_weight(state, prefix, dim)
    return _with_bias({"w": w.permute(2, 1, 0).contiguous()}, state, prefix)


def convT_to_wio(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """torch ConvTranspose1d weight (Cin, Cout/g, K) -> the forward-conv WIO
    kernel (K, Cin/g, Cout) of `nn/layers.conv_transpose1d_apply`."""
    cin, cout_g, k = w.shape
    cin_g = cin // groups
    w = w.reshape(groups, cin_g, cout_g, k).flip(-1)
    return w.permute(3, 1, 0, 2).reshape(k, cin_g, groups * cout_g).contiguous()


def t_conv_transpose1d(state: State, prefix: str, groups: int = 1) -> dict:
    return _with_bias({"w": convT_to_wio(state[f"{prefix}.weight"], groups)}, state, prefix)


def t_wn_conv_transpose1d(state: State, prefix: str, groups: int = 1, dim: int = 1) -> dict:
    """A weight-normed ConvTranspose1d; `dim` is the one torch's weight_norm
    used (DAC's default 0 on the (Cin, Cout, K) tensor)."""
    w = _wn_weight(state, prefix, dim)
    return _with_bias({"w": convT_to_wio(w, groups)}, state, prefix)


def t_layer_norm(state: State, prefix: str) -> dict:
    return {"gamma": state[f"{prefix}.weight"].clone(), "beta": state[f"{prefix}.bias"].clone()}


def t_batch_norm(state: State, prefix: str) -> dict:
    return {
        "gamma": state[f"{prefix}.weight"].clone(),
        "beta": state[f"{prefix}.bias"].clone(),
        "mean": state[f"{prefix}.running_mean"].clone(),
        "var": state[f"{prefix}.running_var"].clone(),
    }


def stack_trees(trees: List[dict]) -> dict:
    """Per-layer trees of one structure -> one tree of (L, ...) stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# wav2vec2
# ---------------------------------------------------------------------------


def convert_wav2vec2(state: State, cfg) -> dict:
    """HF Wav2Vec2Model state dict -> the `nn/wav2vec2.py` tree."""
    conv_layers = []
    for i, dim in enumerate(cfg.conv_dim):
        pre = f"feature_extractor.conv_layers.{i}"
        layer = {"conv": t_conv1d(state, f"{pre}.conv")}
        if f"{pre}.layer_norm.weight" in state:
            layer["ln"] = t_layer_norm(state, f"{pre}.layer_norm")
        else:
            layer["ln"] = {"gamma": torch.ones(dim), "beta": torch.zeros(dim)}
        conv_layers.append(layer)

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        layers.append(
            {
                "ln1": t_layer_norm(state, f"{pre}.layer_norm"),
                "q": t_linear(state, f"{pre}.attention.q_proj"),
                "k": t_linear(state, f"{pre}.attention.k_proj"),
                "v": t_linear(state, f"{pre}.attention.v_proj"),
                "o": t_linear(state, f"{pre}.attention.out_proj"),
                "ln2": t_layer_norm(state, f"{pre}.final_layer_norm"),
                "ff_in": t_linear(state, f"{pre}.feed_forward.intermediate_dense"),
                "ff_out": t_linear(state, f"{pre}.feed_forward.output_dense"),
            }
        )

    return {
        "conv_layers": conv_layers,
        "fp_ln": t_layer_norm(state, "feature_projection.layer_norm"),
        "fp_proj": t_linear(state, "feature_projection.projection"),
        # HF weight-norms the positional conv over dim 2
        "pos_conv": t_wn_conv1d(state, "encoder.pos_conv_embed.conv", dim=2),
        "layers": layers,
        "final_ln": t_layer_norm(state, "encoder.layer_norm"),
    }


# ---------------------------------------------------------------------------
# Qwen2.5 LM
# ---------------------------------------------------------------------------


def convert_qwen(state: State, cfg) -> dict:
    """HF Qwen2ForCausalLM state dict -> the `lm/qwen.py` tree: layers
    stacked along a leading L dim, q/k/v fused into `qkv` and gate/up into
    `gateup`; `lm_head` when the config is untied."""
    pfx = "model." if "model.embed_tokens.weight" in state else ""
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"{pfx}layers.{i}"
        q, k, v = (t_linear(state, f"{pre}.self_attn.{n}_proj") for n in ("q", "k", "v"))
        gate = t_linear(state, f"{pre}.mlp.gate_proj")
        up = t_linear(state, f"{pre}.mlp.up_proj")
        layers.append(
            {
                "ln1": {"gamma": state[f"{pre}.input_layernorm.weight"].clone()},
                "qkv": {
                    "w": torch.cat([q["w"], k["w"], v["w"]], dim=1),
                    "b": torch.cat([q["b"], k["b"], v["b"]]),
                },
                "o": t_linear(state, f"{pre}.self_attn.o_proj"),
                "ln2": {"gamma": state[f"{pre}.post_attention_layernorm.weight"].clone()},
                "gateup": {"w": torch.cat([gate["w"], up["w"]], dim=1)},
                "down": t_linear(state, f"{pre}.mlp.down_proj"),
            }
        )
    params = {
        "embed": state[f"{pfx}embed_tokens.weight"].clone(),
        "layers": stack_trees(layers),
        "final_ln": {"gamma": state[f"{pfx}norm.weight"].clone()},
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = t_linear(state, "lm_head")
    return params


# ---------------------------------------------------------------------------
# BiCodec
# ---------------------------------------------------------------------------


def _t_conv1x1_as_linear(state: State, prefix: str, weight_normed: bool = False) -> dict:
    """A 1x1 Conv1d (weight-normed or not) -> linear params (in, out)."""
    w = _wn_weight(state, prefix, 0) if weight_normed else state[f"{prefix}.weight"]
    return _with_bias({"w": w[:, :, 0].T.contiguous()}, state, prefix)


def _t_convnext_block(state: State, pre: str, conditioned: bool) -> dict:
    p = {
        "dwconv": t_conv1d(state, f"{pre}.dwconv"),
        "pwconv1": t_linear(state, f"{pre}.pwconv1"),
        "pwconv2": t_linear(state, f"{pre}.pwconv2"),
    }
    if conditioned:
        p["norm"] = {
            "scale": t_linear(state, f"{pre}.norm.scale"),
            "shift": t_linear(state, f"{pre}.norm.shift"),
        }
    else:
        p["norm"] = t_layer_norm(state, f"{pre}.norm")
    if f"{pre}.gamma" in state:
        p["gamma"] = state[f"{pre}.gamma"].clone()
    return p


def _t_vocos_backbone(state: State, pre: str, num_layers: int, conditioned: bool = False) -> dict:
    p = {
        "embed": t_conv1d(state, f"{pre}.embed"),
        "blocks": [
            _t_convnext_block(state, f"{pre}.convnext.{i}", conditioned)
            for i in range(num_layers)
        ],
        "final_layer_norm": t_layer_norm(state, f"{pre}.final_layer_norm"),
    }
    if conditioned:
        p["norm"] = {
            "scale": t_linear(state, f"{pre}.norm.scale"),
            "shift": t_linear(state, f"{pre}.norm.shift"),
        }
    else:
        p["norm"] = t_layer_norm(state, f"{pre}.norm")
    return p


def _t_sampling_block(state: State, pre: str, groups: int, upsample: bool) -> dict:
    """SamplingBlock: Sequential(LeakyReLU, (de)conv), weights at index 1,
    no weight norm."""
    p = {}
    if upsample and f"{pre}.de_conv_upsampler.1.weight" in state:
        p["de_conv_upsampler"] = t_conv_transpose1d(state, f"{pre}.de_conv_upsampler.1", groups)
    if not upsample and f"{pre}.conv_downsampler.1.weight" in state:
        p["conv_downsampler"] = t_conv1d(state, f"{pre}.conv_downsampler.1")
    return p


def _t_feat_encoder(state: State, pre: str, cfg) -> dict:
    return {
        "encoder": _t_vocos_backbone(state, f"{pre}.encoder", cfg.vocos_num_layers),
        "downsample": [
            {
                "sampler": _t_sampling_block(state, f"{pre}.downsample.{j}.0", cfg.vocos_dim,
                                             False),
                "vocos": _t_vocos_backbone(state, f"{pre}.downsample.{j}.1", 2),
            }
            for j in range(len(cfg.sample_ratios))
        ],
        "project": t_linear(state, f"{pre}.project"),
    }


def _t_feat_decoder(state: State, pre: str, cfg) -> dict:
    conditioned = cfg.condition_dim is not None
    return {
        "linear_pre": t_linear(state, f"{pre}.linear_pre"),
        "upsample": [
            {
                "sampler": _t_sampling_block(state, f"{pre}.downsample.{j}.0", cfg.vocos_dim, True),
                "vocos": _t_vocos_backbone(state, f"{pre}.downsample.{j}.1", 2),
            }
            for j in range(len(cfg.sample_ratios))
        ],
        "vocos_backbone": _t_vocos_backbone(
            state, f"{pre}.vocos_backbone", cfg.vocos_num_layers, conditioned
        ),
        "linear": t_linear(state, f"{pre}.linear"),
    }


def _t_snake(state: State, key: str) -> dict:
    return {"alpha": state[key].reshape(-1).clone()}  # (1, C, 1) -> (C,)


def _t_residual_unit(state: State, pre: str) -> dict:
    """ResidualUnit: block = Sequential(Snake, WNConv1d, Snake, WNConv1d)."""
    return {
        "snake1": _t_snake(state, f"{pre}.block.0.alpha"),
        "conv1": t_wn_conv1d(state, f"{pre}.block.1"),
        "snake2": _t_snake(state, f"{pre}.block.2.alpha"),
        "conv2": t_wn_conv1d(state, f"{pre}.block.3"),
    }


def _t_wave_generator(state: State, pre: str, cfg) -> dict:
    """WaveGenerator: model = [WNConv1d, DecoderBlock x n, Snake, WNConv1d,
    Tanh]; DecoderBlock.block = [Snake, WNConvTranspose1d, ResidualUnit x 3]."""
    n_blocks = len(cfg.rates)
    blocks = []
    for i in range(n_blocks):
        bpre = f"{pre}.model.{1 + i}.block"
        blocks.append(
            {
                "snake": _t_snake(state, f"{bpre}.0.alpha"),
                "upsample": t_wn_conv_transpose1d(state, f"{bpre}.1", groups=1, dim=0),
                "res_units": [_t_residual_unit(state, f"{bpre}.{2 + r}") for r in range(3)],
            }
        )
    return {
        "conv_in": t_wn_conv1d(state, f"{pre}.model.0"),
        "blocks": blocks,
        "snake_out": _t_snake(state, f"{pre}.model.{n_blocks + 1}.alpha"),
        "conv_out": t_wn_conv1d(state, f"{pre}.model.{n_blocks + 2}"),
    }


def _t_fvq(state: State, pre: str, cfg) -> dict:
    p = {"codebook": state[f"{pre}.codebook.weight"].clone()}
    if cfg.input_dim != cfg.codebook_dim:
        p["in_project"] = _t_conv1x1_as_linear(state, f"{pre}.in_project", weight_normed=True)
        p["out_project"] = _t_conv1x1_as_linear(state, f"{pre}.out_project", weight_normed=True)
    return p


def _t_conv_relu_bn(state: State, pre: str) -> dict:
    return {"conv": t_conv1d(state, f"{pre}.conv"), "bn": t_batch_norm(state, f"{pre}.bn")}


def _t_se_res2_block(state: State, pre: str) -> dict:
    """SE_Res2Block: Sequential(Conv1dReluBn, Res2Conv1dReluBn (scale 8: 7
    convs), Conv1dReluBn, SE_Connect)."""
    n_res2 = 7
    return {
        "in_conv": _t_conv_relu_bn(state, f"{pre}.se_res2block.0"),
        "res2": {
            "convs": [t_conv1d(state, f"{pre}.se_res2block.1.convs.{i}") for i in range(n_res2)],
            "bns": [t_batch_norm(state, f"{pre}.se_res2block.1.bns.{i}") for i in range(n_res2)],
        },
        "out_conv": _t_conv_relu_bn(state, f"{pre}.se_res2block.2"),
        "se": {
            "l1": t_linear(state, f"{pre}.se_res2block.3.linear1"),
            "l2": t_linear(state, f"{pre}.se_res2block.3.linear2"),
        },
    }


def _t_ecapa(state: State, pre: str) -> dict:
    return {
        "layer1": _t_conv_relu_bn(state, f"{pre}.layer1"),
        "layer2": _t_se_res2_block(state, f"{pre}.layer2"),
        "layer3": _t_se_res2_block(state, f"{pre}.layer3"),
        "layer4": _t_se_res2_block(state, f"{pre}.layer4"),
        "conv": t_conv1d(state, f"{pre}.conv"),
        "pool": {
            "linear1": _t_conv1x1_as_linear(state, f"{pre}.pool.linear1"),
            "linear2": _t_conv1x1_as_linear(state, f"{pre}.pool.linear2"),
        },
        "bn": t_batch_norm(state, f"{pre}.bn"),
        "linear": t_linear(state, f"{pre}.linear"),
    }


def _t_mhastp(state: State, pre: str, layer_num: int = 2, head_num: int = 2) -> dict:
    """MHASTP pooling (`nn/pooling.py`): each head's 1x1 conv attention
    stack as linears."""
    return {
        "heads": [
            [
                _t_conv1x1_as_linear(state, f"{pre}.heads_att_trans.{h}.att_{i}")
                for i in range(layer_num)
            ]
            for h in range(head_num)
        ]
    }


def _t_mqmhastp(
    state: State, pre: str, layer_num: int = 2, query_num: int = 2, head_num: int = 8
) -> dict:
    """MQMHASTP pooling (`nn/pooling.py`): one MHASTP per query."""
    return {
        "queries": [
            _t_mhastp(state, f"{pre}.n_query.{q}", layer_num, head_num)
            for q in range(query_num)
        ]
    }


def _t_perceiver(state: State, pre: str, depth: int) -> dict:
    p = {
        "latents": state[f"{pre}.latents"].clone(),
        "layers": [
            {
                "attn": {
                    "to_q": t_linear(state, f"{pre}.layers.{i}.0.to_q"),
                    "to_kv": t_linear(state, f"{pre}.layers.{i}.0.to_kv"),
                    "to_out": t_linear(state, f"{pre}.layers.{i}.0.to_out"),
                },
                # FeedForward = Sequential(Linear, GEGLU, Linear): indices 0, 2
                "ff": {
                    "w1": t_linear(state, f"{pre}.layers.{i}.1.0"),
                    "w2": t_linear(state, f"{pre}.layers.{i}.1.2"),
                },
            }
            for i in range(depth)
        ],
        "norm": {"gamma": state[f"{pre}.norm.gamma"].clone()},
    }
    if f"{pre}.proj_context.weight" in state:
        p["proj_context"] = t_linear(state, f"{pre}.proj_context")
    return p


def _speaker_project_permuted(state: State, prefix: str, latent_dim: int, token_num: int) -> dict:
    """The torch model flattens the quantized latents channel first (latent,
    token); the port flattens (token, latent), as the JAX package does: the
    Linear's input rows are permuted to match."""
    w = state[f"{prefix}.weight"].T  # (latent_dim * token_num, out), row d * N + n
    out_dim = w.shape[1]
    w = w.reshape(latent_dim, token_num, out_dim).permute(1, 0, 2).reshape(-1, out_dim)
    return _with_bias({"w": w.contiguous()}, state, prefix)


def _t_speaker_encoder(state: State, pre: str, cfg) -> dict:
    p = {
        "speaker_encoder": _t_ecapa(state, f"{pre}.speaker_encoder"),
        "perceiver_sampler": _t_perceiver(state, f"{pre}.perceiver_sampler", cfg.perceiver_depth),
        "quantizer": {},
        "project": _speaker_project_permuted(
            state, f"{pre}.project", cfg.latent_dim, cfg.token_num
        ),
    }
    if len(cfg.fsq_levels) != cfg.latent_dim:
        p["quantizer"] = {
            "project_in": t_linear(state, f"{pre}.quantizer.project_in"),
            "project_out": t_linear(state, f"{pre}.quantizer.project_out"),
        }
    return p


def convert_bicodec(state: State, cfg) -> dict:
    """BiCodec `model.safetensors` state dict -> the whole BiCodec tree of
    `weights.init_bicodec`."""
    return {
        "encoder": _t_feat_encoder(state, "encoder", cfg.encoder),
        "quantizer": _t_fvq(state, "quantizer", cfg.quantizer),
        "speaker_encoder": _t_speaker_encoder(state, "speaker_encoder", cfg.speaker_encoder),
        "prenet": _t_feat_decoder(state, "prenet", cfg.prenet),
        "postnet": _t_feat_decoder(state, "postnet", cfg.postnet),
        "decoder": _t_wave_generator(state, "decoder", cfg.decoder),
    }


# ---------------------------------------------------------------------------
# converted-tree cache
# ---------------------------------------------------------------------------

CACHE_FILE = "tree.safetensors"


def flatten_tree(tree, prefix: str = "") -> Tuple[State, object]:
    """A tree of dicts and lists of tensors -> ({path: tensor}, its shape):
    the shape is the tree with each leaf replaced by its path ('/'-joined
    keys and list indices)."""
    if isinstance(tree, dict):
        flat, shape = {}, {}
        for k, v in tree.items():
            sub, shape[k] = flatten_tree(v, f"{prefix}{k}/")
            flat.update(sub)
        return flat, shape
    if isinstance(tree, (list, tuple)):
        flat, shape = {}, []
        for i, v in enumerate(tree):
            sub, s = flatten_tree(v, f"{prefix}{i}/")
            flat.update(sub)
            shape.append(s)
        return flat, shape
    name = prefix[:-1]
    return {name: tree}, name


def unflatten_tree(shape, flat: State):
    """The inverse of `flatten_tree`."""
    if isinstance(shape, dict):
        return {k: unflatten_tree(v, flat) for k, v in shape.items()}
    if isinstance(shape, list):
        return [unflatten_tree(v, flat) for v in shape]
    return flat[shape]


def save_param_cache(cache_dir: str | Path, tree) -> None:
    """Persist a converted param tree (leaves on any device, in their dtype)
    so later loads skip the conversion.  An existing cache is replaced; the
    file is renamed into place once written whole."""
    path = Path(cache_dir).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    flat, shape = flatten_tree(tree)
    tmp = path / (CACHE_FILE + ".tmp")
    save_safetensors(tmp, flat, {"tree": json.dumps(shape)})
    os.replace(tmp, path / CACHE_FILE)


def load_param_cache(cache_dir: str | Path):
    """The tree `save_param_cache` wrote, as CPU tensors; None if absent."""
    path = Path(cache_dir).absolute() / CACHE_FILE
    if not path.exists():
        return None
    flat, metadata = read_safetensors(path)
    return unflatten_tree(json.loads(metadata["tree"]), flat)
