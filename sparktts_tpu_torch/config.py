"""Configuration tree for the PyTorch/CUDA port.

A copy of the dataclasses of `sparktts_tpu/config.py` that the port's
modules read.  The defaults are the published Spark-TTS-0.5B dims (Qwen2.5-0.5B
LM, BiCodec with a 12-layer prenet and a 1536-channel WaveGenerator), so the
whole stack can be built with random weights without a checkpoint.
`load_spark_config` reads a checkpoint directory's `config.yaml`,
`BiCodec/config.yaml`, `LLM/config.json` and
`wav2vec2-large-xlsr-53/config.json` into the same tree, as the JAX
package's loader does (`sparktts_tpu/config.py:232-339`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# BiCodec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MelParams:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 640
    hop_length: int = 320
    mel_fmin: float = 10.0
    mel_fmax: Optional[float] = None
    num_mels: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    input_channels: int = 1024
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12
    out_channels: int = 1024
    sample_ratios: Tuple[int, ...] = (1, 1)


@dataclass(frozen=True)
class DecoderConfig:
    """Feat decoder used for prenet/postnet."""

    input_channels: int = 1024
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12
    out_channels: int = 1024
    condition_dim: Optional[int] = None
    sample_ratios: Tuple[int, ...] = (1, 1)
    use_tanh_at_final: bool = False


@dataclass(frozen=True)
class WaveGeneratorConfig:
    input_channel: int = 1024
    channels: int = 1536
    rates: Tuple[int, ...] = (8, 5, 4, 2)
    kernel_sizes: Tuple[int, ...] = (16, 11, 8, 4)
    d_out: int = 1


@dataclass(frozen=True)
class QuantizerConfig:
    input_dim: int = 1024
    codebook_size: int = 8192
    codebook_dim: int = 8
    commitment: float = 0.25
    codebook_loss_weight: float = 2.0
    decay: float = 0.99
    threshold_ema_dead_code: float = 0.2


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    input_dim: int = 128
    out_dim: int = 1024
    latent_dim: int = 128
    token_num: int = 32
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4)
    fsq_num_quantizers: int = 1
    ecapa_channels: int = 512
    perceiver_dim_context: int = 512 * 3
    perceiver_depth: int = 2
    perceiver_dim_head: int = 64
    perceiver_heads: int = 8
    perceiver_ff_mult: int = 4


@dataclass(frozen=True)
class BiCodecConfig:
    mel_params: MelParams = field(default_factory=MelParams)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    quantizer: QuantizerConfig = field(default_factory=QuantizerConfig)
    prenet: DecoderConfig = field(
        default_factory=lambda: DecoderConfig(condition_dim=1024)
    )
    postnet: DecoderConfig = field(
        default_factory=lambda: DecoderConfig(vocos_num_layers=6, out_channels=128)
    )
    decoder: WaveGeneratorConfig = field(default_factory=WaveGeneratorConfig)
    speaker_encoder: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)


# ---------------------------------------------------------------------------
# wav2vec2 feature extractor (clone mode)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_proj_layer_norm: bool = True
    hidden_state_mix: Tuple[int, ...] = (11, 14, 16)
    do_normalize: bool = True


# ---------------------------------------------------------------------------
# Qwen2.5 LM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QwenConfig:
    """Qwen2.5-0.5B with the Spark-TTS extended vocabulary."""

    vocab_size: int = 166000
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    eos_token_id: int = 151645
    pad_token_id: int = 151643


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    max_new_tokens: int = 3000


@dataclass(frozen=True)
class StreamingConfig:
    """The streaming chunk schedule (the reference's Triton BLS defaults):
    chunks grow from 1 s by x8 to at most 30 s, 0.1 s overlap, 50 tokens/s."""

    audio_chunk_duration: float = 1.0
    max_audio_chunk_duration: float = 30.0
    audio_chunk_size_scale_factor: float = 8.0
    audio_chunk_overlap_duration: float = 0.1
    frame_rate: int = 50


@dataclass(frozen=True)
class SparkTTSConfig:
    sample_rate: int = 16000
    highpass_cutoff_freq: int = 40
    latent_hop_length: int = 320
    ref_segment_duration: float = 6.0
    volume_normalize: bool = True
    bicodec: BiCodecConfig = field(default_factory=BiCodecConfig)
    wav2vec2: Wav2Vec2Config = field(default_factory=Wav2Vec2Config)
    llm: QwenConfig = field(default_factory=QwenConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)


# ---------------------------------------------------------------------------
# checkpoint config files -> dataclasses
# ---------------------------------------------------------------------------


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """The entries of `d` that are fields of `cls`, lists made tuples
    (training-only keys of the checkpoint's files are dropped)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}


def load_yaml_config(path: str | Path) -> Dict[str, Any]:
    """A checkpoint `config.yaml` as a dict, with a recursive `base_config`
    (a path relative to the file) merged under it."""
    import yaml

    path = Path(path)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop("base_config", None)
    if base:
        base_path = Path(base)
        if not base_path.is_absolute():
            base_path = path.parent / base_path
        merged = load_yaml_config(base_path)
        merged.update(cfg)
        cfg = merged
    return cfg


def bicodec_config_from_dict(cfg: Dict[str, Any]) -> BiCodecConfig:
    """A BiCodecConfig from the `audio_tokenizer` section of a BiCodec
    `config.yaml` (or from the section itself); absent parts keep their
    defaults."""
    at = cfg.get("audio_tokenizer", cfg)
    parts = (
        ("mel_params", MelParams),
        ("encoder", EncoderConfig),
        ("quantizer", QuantizerConfig),
        ("prenet", DecoderConfig),
        ("postnet", DecoderConfig),
        ("decoder", WaveGeneratorConfig),
        ("speaker_encoder", SpeakerEncoderConfig),
    )
    return BiCodecConfig(
        **{name: cls(**_filter_kwargs(cls, at[name])) for name, cls in parts if name in at}
    )


def qwen_config_from_dict(cfg: Dict[str, Any]) -> QwenConfig:
    """A QwenConfig from an HF `config.json` dict (`head_dim` derived when
    absent; the first of a list of EOS ids)."""
    kw = _filter_kwargs(QwenConfig, cfg)
    if "head_dim" not in cfg and "hidden_size" in cfg and "num_attention_heads" in cfg:
        kw["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    eos = cfg.get("eos_token_id")
    if isinstance(eos, list):
        kw["eos_token_id"] = eos[0]
    return QwenConfig(**kw)


def wav2vec2_config_from_dict(cfg: Dict[str, Any]) -> Wav2Vec2Config:
    return Wav2Vec2Config(**_filter_kwargs(Wav2Vec2Config, cfg))


_ROOT_KEYS = (
    "sample_rate",
    "highpass_cutoff_freq",
    "latent_hop_length",
    "ref_segment_duration",
    "volume_normalize",
)


def load_spark_config(model_dir: str | Path) -> SparkTTSConfig:
    """The SparkTTSConfig of a checkpoint directory laid out as the published
    Spark-TTS-0.5B (`config.yaml`, `BiCodec/`, `LLM/`,
    `wav2vec2-large-xlsr-53/`); a missing file leaves its part at the
    defaults."""
    model_dir = Path(model_dir)
    root_kw: Dict[str, Any] = {}
    top_path = model_dir / "config.yaml"
    top: Dict[str, Any] = load_yaml_config(top_path) if top_path.exists() else {}
    root_kw.update({k: top[k] for k in _ROOT_KEYS if k in top})

    bicodec_path = model_dir / "BiCodec" / "config.yaml"
    if bicodec_path.exists():
        root_kw["bicodec"] = bicodec_config_from_dict(load_yaml_config(bicodec_path))
    elif "audio_tokenizer" in top:
        root_kw["bicodec"] = bicodec_config_from_dict(top)

    llm_path = model_dir / "LLM" / "config.json"
    if llm_path.exists():
        root_kw["llm"] = qwen_config_from_dict(json.loads(llm_path.read_text()))

    w2v_path = model_dir / "wav2vec2-large-xlsr-53" / "config.json"
    if w2v_path.exists():
        root_kw["wav2vec2"] = wav2vec2_config_from_dict(json.loads(w2v_path.read_text()))

    return SparkTTSConfig(**root_kw)


def tiny_test_config() -> SparkTTSConfig:
    """A drastically shrunk config for CPU unit tests: same topology, tiny
    dims (the same values as the JAX package's `tiny_test_config`)."""
    return SparkTTSConfig(
        bicodec=BiCodecConfig(
            mel_params=MelParams(num_mels=32),
            encoder=EncoderConfig(
                input_channels=64,
                vocos_dim=32,
                vocos_intermediate_dim=64,
                vocos_num_layers=2,
                out_channels=48,
                sample_ratios=(2, 2),
            ),
            quantizer=QuantizerConfig(input_dim=48, codebook_size=64, codebook_dim=8),
            prenet=DecoderConfig(
                input_channels=48,
                vocos_dim=32,
                vocos_intermediate_dim=64,
                vocos_num_layers=2,
                out_channels=48,
                condition_dim=48,
                sample_ratios=(2, 2),
            ),
            postnet=DecoderConfig(
                input_channels=48,
                vocos_dim=32,
                vocos_intermediate_dim=64,
                vocos_num_layers=2,
                out_channels=32,
            ),
            decoder=WaveGeneratorConfig(
                input_channel=48, channels=64, rates=(4, 2), kernel_sizes=(8, 4)
            ),
            speaker_encoder=SpeakerEncoderConfig(
                input_dim=32,
                out_dim=48,
                latent_dim=16,
                token_num=4,
                fsq_levels=(4, 4, 4),
                ecapa_channels=64,
                perceiver_dim_context=64 * 3,
                perceiver_dim_head=8,
                perceiver_heads=2,
            ),
        ),
        wav2vec2=Wav2Vec2Config(
            conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 3),
            conv_stride=(5, 2, 2),
            hidden_size=64,
            num_hidden_layers=4,
            num_attention_heads=4,
            intermediate_size=128,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
            hidden_state_mix=(1, 2, 3),
        ),
        llm=QwenConfig(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            eos_token_id=0,
            pad_token_id=1,
        ),
    )
