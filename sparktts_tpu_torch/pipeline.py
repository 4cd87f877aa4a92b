"""End-to-end Spark-TTS voice creation: the port's public API.

Port of `SparkTTSPipeline` of `sparktts_tpu/pipeline.py` in voice-creation
mode (gender/pitch/speed): build the control prompt, generate with the
Qwen2.5 LM (which emits both the global speaker tokens and the semantic
tokens), and vocode with the BiCodec decoder into a 16 kHz waveform.
Voice cloning (a prompt wav, through the codec encode stack) is not ported
yet and raises.

The pipeline runs on the CUDA card unless the caller passes `device="cpu"`;
without a card the default raises instead of falling back to the CPU.
Weights are random (from `seed`) unless numpy param trees with the JAX
package's keys are passed in.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize
from sparktts_tpu_torch.config import SparkTTSConfig
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.prompt import (
    SyntheticSparkTokenizer,
    build_control_prompt,
    extract_semantic_ids,
    padded_global_tokens,
)
from sparktts_tpu_torch.weights import bicodec_state, init_bicodec, init_qwen, qwen_state

logger = logging.getLogger(__name__)

PROMPT_BUCKET = 64  # prompts are left-padded to a multiple of this many tokens
VOCODE_BUCKET = 50  # semantic tokens are edge-padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SparkTTSPipeline:
    """Voice creation at the config's widths (default: Spark-TTS-0.5B)."""

    def __init__(
        self,
        config: Optional[SparkTTSConfig] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        lm_dtype: torch.dtype = torch.bfloat16,
        max_new_tokens: Optional[int] = None,
        llm_params=None,
        bicodec_params=None,
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

        self.sample_rate = self.config.sample_rate
        self.max_new_tokens = max_new_tokens or self.config.sampling.max_new_tokens
        self.lm_dtype = lm_dtype
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
        """Text + voice attributes -> 16 kHz waveform (float32)."""
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
        """One prompt -> (wav, the LM-emitted codec global ids)."""
        if gender is None:
            raise NotImplementedError(
                "voice cloning (prompt_speech_path, the codec encode stack) is not ported yet: "
                "ROADMAP.md lists it as port slice 2; pass gender/pitch/speed for voice creation"
            )
        ids = build_control_prompt(self.tokenizer, text, gender, pitch, speed)
        generated = self.generate_tokens(
            ids,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_new_tokens=max_new_tokens,
            seed=seed,
            greedy=greedy,
        )
        semantic_ids = extract_semantic_ids(self.tokenizer, generated)
        global_ids = padded_global_tokens(
            self.tokenizer, generated, self.config.bicodec.speaker_encoder.token_num, warn=True
        )
        if semantic_ids.size == 0:
            logger.warning("no semantic tokens generated; returning silence")
            return np.zeros(0, dtype=np.float32), global_ids
        return self.detokenize(global_ids, semantic_ids[None, :]), global_ids

    def guided_constraint(self):
        """(vocab_slice, extra_ids) for guided decoding: voice creation emits
        global and semantic tokens, their start/end markers and EOS."""
        tok = self.tokenizer
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
    ) -> np.ndarray:
        """Run the LM on one prompt; returns the generated ids (new tokens
        only, up to and including EOS)."""
        max_new = max_new_tokens or self.max_new_tokens
        input_ids, mask = self.prompt_inputs(prompt_ids)
        t_pad = input_ids.shape[1]
        vocab_slice, extra_ids = self.guided_constraint()
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
