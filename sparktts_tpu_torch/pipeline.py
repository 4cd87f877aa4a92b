"""End-to-end Spark-TTS: the port's public API.

Port of `SparkTTSPipeline` of `sparktts_tpu/pipeline.py` in its two modes:

  * voice creation (gender/pitch/speed): the control prompt; the Qwen2.5 LM
    emits both the global speaker tokens and the semantic tokens;
  * voice cloning (a prompt wav): wav2vec2 features and the BiCodec encoder
    tokenize the wav into global and semantic ids, which go into the clone
    prompt; the LM emits semantic tokens only.

Both vocode with the BiCodec decoder into a 16 kHz waveform.  The LM's
decode replays captured CUDA graphs on the card (`lm/graphs.py`); token
streaming over the same pipeline is `serve/streaming.py`.  The pipeline
runs on the CUDA card unless the caller passes `device="cpu"`; without a
card the default raises instead of falling back to the CPU.  Weights are
random (from `seed`) unless numpy param trees with the JAX package's keys
are passed in.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize, bicodec_tokenize
from sparktts_tpu_torch.config import SparkTTSConfig
from sparktts_tpu_torch.io.audio import get_ref_clip, load_audio
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.nn.wav2vec2 import feature_lengths, normalize_input, wav2vec2_features
from sparktts_tpu_torch.prompt import (
    SyntheticSparkTokenizer,
    build_clone_prompt,
    build_control_prompt,
    extract_semantic_ids,
    padded_global_tokens,
)
from sparktts_tpu_torch.weights import (
    bicodec_state,
    init_bicodec,
    init_qwen,
    init_wav2vec2,
    qwen_state,
    wav2vec2_state,
)

logger = logging.getLogger(__name__)

PROMPT_BUCKET = 64  # prompts are left-padded to a multiple of this many tokens
VOCODE_BUCKET = 50  # semantic tokens are edge-padded to a multiple of this
MODES = ("control", "clone")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def codec_tokenize(
    w2v_params, bicodec_params, cfg: SparkTTSConfig, wav, feature_mask, ref_wav
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device half of audio tokenization, on the params' device:
    (wav (B, P), feature_mask (B, F), ref_wav (B, R)) -> (global ids
    (B, token_num), semantic ids (B, F / enc_ratio))."""
    feat = wav2vec2_features(w2v_params, wav, cfg.wav2vec2, feature_mask)
    semantic, global_ids = bicodec_tokenize(bicodec_params, cfg.bicodec, feat, ref_wav)
    return global_ids, semantic


class SparkTTSPipeline:
    """Voice creation and voice cloning at the config's widths (default:
    Spark-TTS-0.5B)."""

    def __init__(
        self,
        config: Optional[SparkTTSConfig] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        lm_dtype: torch.dtype = torch.bfloat16,
        max_new_tokens: Optional[int] = None,
        llm_params=None,
        bicodec_params=None,
        wav2vec2_params=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SparkTTSPipeline: no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        self.config = config or SparkTTSConfig()
        bc = self.config.bicodec
        self.tokenizer = SyntheticSparkTokenizer(
            n_semantic=bc.quantizer.codebook_size,
            n_global=int(np.prod(bc.speaker_encoder.fsq_levels)),
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if llm_params is None:
            self.llm_params = init_qwen(self.config.llm, gen, lm_dtype, self.device)
        else:
            self.llm_params = qwen_state(llm_params, self.device, lm_dtype)
        if bicodec_params is None:
            self.bicodec_params = init_bicodec(bc, gen, self.device)
        else:
            self.bicodec_params = bicodec_state(bicodec_params, self.device)
        if wav2vec2_params is None:
            self.w2v_params = init_wav2vec2(self.config.wav2vec2, gen, self.device)
        else:
            self.w2v_params = wav2vec2_state(wav2vec2_params, self.device)

        self.sample_rate = self.config.sample_rate
        self.wav_bucket = self.sample_rate  # prompt wavs are zero-padded to whole seconds
        self.max_new_tokens = max_new_tokens or self.config.sampling.max_new_tokens
        self.lm_dtype = lm_dtype
        self._enc_ratio = int(np.prod(bc.encoder.sample_ratios))  # wav2vec2 frames per semantic id
        self._wave_upsample = int(np.prod(bc.decoder.rates)) * int(np.prod(bc.prenet.sample_ratios))

    def inference(
        self,
        text: str,
        prompt_speech_path: Optional[str | Path] = None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
    ) -> np.ndarray:
        """Text -> 16 kHz waveform (float32), in the voice of
        `prompt_speech_path` (a wav path or a 16 kHz float array; with
        `prompt_text`, its transcript) or of gender/pitch/speed."""
        wav, _ = self._synthesize_segment(
            text,
            prompt_speech_path=prompt_speech_path,
            prompt_text=prompt_text,
            gender=gender,
            pitch=pitch,
            speed=speed,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_new_tokens=max_new_tokens,
            seed=seed,
            greedy=greedy,
        )
        return wav

    def _synthesize_segment(
        self,
        text: str,
        prompt_speech_path=None,
        prompt_text=None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One prompt -> (wav, the codec global ids it was vocoded with: the
        prompt wav's in voice cloning, the LM-emitted ones in voice creation)."""
        if gender is not None:
            ids = build_control_prompt(self.tokenizer, text, gender, pitch, speed)
            mode = "control"
        elif prompt_speech_path is not None:
            global_ids, prompt_semantic = self.tokenize_audio(prompt_speech_path)
            ids = build_clone_prompt(
                self.tokenizer,
                text,
                global_ids,
                prompt_semantic if prompt_text is not None else None,
                prompt_text,
            )
            mode = "clone"
        else:
            raise ValueError(
                "pass prompt_speech_path (voice cloning) or gender/pitch/speed (voice creation)"
            )
        generated = self.generate_tokens(
            ids,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_new_tokens=max_new_tokens,
            seed=seed,
            greedy=greedy,
            mode=mode,
        )
        semantic_ids = extract_semantic_ids(self.tokenizer, generated)
        if mode == "control":
            global_ids = padded_global_tokens(
                self.tokenizer, generated, self.config.bicodec.speaker_encoder.token_num, warn=True
            )
        if semantic_ids.size == 0:
            logger.warning("no semantic tokens generated; returning silence")
            return np.zeros(0, dtype=np.float32), global_ids
        return self.detokenize(global_ids, semantic_ids[None, :]), global_ids

    def tokenize_host_prep(self, audio) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Host half of audio tokenization.  A path is loaded at 16 kHz (with
        the config's loudness normalisation); an array is taken as it is.
        Returns (wav (1, P) float32: the normalised wav zero-padded to whole
        seconds; feature_mask (1, F) bool: its true wav2vec2 frames; ref_wav
        (1, R) float32: the 6 s reference clip; the true semantic id count)."""
        if isinstance(audio, (str, Path)):
            wav = load_audio(
                audio, sampling_rate=self.sample_rate, volume_normalize=self.config.volume_normalize
            )
        else:
            wav = np.asarray(audio, dtype=np.float64)
        cfg = self.config
        ref_wav = get_ref_clip(wav, self.sample_rate, cfg.ref_segment_duration,
                               cfg.latent_hop_length)
        true_len = len(wav)
        pad_len = _round_up(max(true_len, self.wav_bucket), self.wav_bucket)
        wav_in = np.zeros((1, pad_len), np.float32)
        wav_in[0, :true_len] = (
            normalize_input(wav[None, :])[0] if cfg.wav2vec2.do_normalize else wav
        )
        true_frames = feature_lengths(cfg.wav2vec2, true_len)
        feature_mask = np.arange(feature_lengths(cfg.wav2vec2, pad_len))[None, :] < true_frames
        ref = ref_wav.astype(np.float32)[None, :]
        return wav_in, feature_mask, ref, true_frames // self._enc_ratio

    @torch.inference_mode()
    def tokenize_audio(self, audio) -> Tuple[np.ndarray, np.ndarray]:
        """Audio path or float array -> (global ids (1, token_num), semantic
        ids (1, T)), the semantic ids cropped to the wav's true frames."""
        *arrays, true_sem = self.tokenize_host_prep(audio)
        global_ids, semantic = codec_tokenize(
            self.w2v_params, self.bicodec_params, self.config,
            *(torch.from_numpy(a).to(self.device) for a in arrays),
        )
        return global_ids.cpu().numpy(), semantic[:, :true_sem].cpu().numpy()

    def guided_constraint(self, mode: str = "control"):
        """(vocab_slice, extra_ids) for guided decoding.  Voice creation
        ("control") emits global and semantic tokens, their start/end
        markers and EOS; voice cloning ("clone") emits semantic tokens and
        EOS only."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        tok = self.tokenizer
        if mode == "control":
            lo = min(tok.semantic_base, tok.global_base)
            hi = max(tok.semantic_base + tok.n_semantic, tok.global_base + tok.n_global)
            extras = tuple(tok.eos_ids) + tuple(
                tok.token_id(t)
                for t in (
                    "<|start_global_token|>",
                    "<|end_global_token|>",
                    "<|start_semantic_token|>",
                    "<|end_semantic_token|>",
                )
            )
        else:
            lo, hi = tok.semantic_base, tok.semantic_base + tok.n_semantic
            extras = tuple(tok.eos_ids)
        return (lo, hi), tuple(e for e in extras if not lo <= e < hi)

    def generate_tokens(
        self,
        prompt_ids,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
        mode: str = "control",
    ) -> np.ndarray:
        """Run the LM on one prompt under `mode`'s guided vocabulary; returns
        the generated ids (new tokens only, up to and including EOS).  On
        the card the decode replays a captured decode unit (`generate`,
        `lm/graphs.py`), which takes the state of this request's generator,
        seeded with `seed`."""
        max_new = max_new_tokens or self.max_new_tokens
        input_ids, mask = self.prompt_inputs(prompt_ids)
        t_pad = input_ids.shape[1]
        vocab_slice, extra_ids = self.guided_constraint(mode)
        tokens, lengths = generate(
            self.llm_params,
            self.config.llm,
            input_ids,
            mask,
            torch.Generator(device=self.device).manual_seed(seed),
            max_new_tokens=max_new,
            cache_len=t_pad + max_new,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            eos_ids=tuple(self.tokenizer.eos_ids),
            pad_id=self.tokenizer.pad_id,
            greedy=greedy,
            cache_dtype=self.lm_dtype,
            vocab_slice=vocab_slice,
            extra_ids=extra_ids,
        )
        return tokens[0, : int(lengths[0])].cpu().numpy()

    def prompt_inputs(self, prompt_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prompt -> (input_ids (1, T_pad) int64, mask (1, T_pad) bool) on
        the device, left-padded with pad_id to a multiple of PROMPT_BUCKET."""
        n = len(prompt_ids)
        t_pad = _round_up(max(n, 1), PROMPT_BUCKET)
        input_ids = np.full((1, t_pad), self.tokenizer.pad_id, np.int64)
        input_ids[0, t_pad - n :] = prompt_ids
        mask = np.zeros((1, t_pad), bool)
        mask[0, t_pad - n :] = True
        return torch.from_numpy(input_ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @torch.inference_mode()
    def detokenize(self, global_tokens, semantic_tokens) -> np.ndarray:
        """(global (1, N), semantic (1, T)) -> waveform float32 (T * hop,)."""
        semantic = np.asarray(semantic_tokens, np.int64)
        t_true = semantic.shape[1]
        t_pad = _round_up(max(t_true, 1), VOCODE_BUCKET)
        # edge-replicate pad: no spectral discontinuity at the crop point
        padded = np.pad(semantic, ((0, 0), (0, t_pad - t_true)), mode="edge")
        wav = bicodec_detokenize(
            self.bicodec_params,
            self.config.bicodec,
            torch.from_numpy(padded).to(self.device),
            torch.from_numpy(np.asarray(global_tokens, np.int64).reshape(1, -1)).to(self.device),
        )
        return wav[0, : t_true * self._wave_upsample].float().cpu().numpy()
