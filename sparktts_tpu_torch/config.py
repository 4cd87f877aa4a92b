"""Configuration tree for the PyTorch/CUDA port.

A copy of the dataclasses of `sparktts_tpu/config.py` that the port's
modules read.  The defaults are the published Spark-TTS-0.5B dims (Qwen2.5-0.5B
LM, BiCodec with a 12-layer prenet and a 1536-channel WaveGenerator), so the
whole stack can be built with random weights without a checkpoint.  There is
no YAML loader: the defaults already equal the checkpoint's `config.yaml`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


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
# wav2vec2 feature extractor (clone mode; its modules are not ported yet)
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
