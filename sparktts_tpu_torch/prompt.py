"""Prompt assembly and token-id arithmetic (host code).

A copy of the parts of `sparktts_tpu/prompt.py` and `sparktts_tpu/utils/tokens.py`
that voice creation and voice cloning need.  Every `<|bicodec_semantic_N|>` /
`<|bicodec_global_N|>` is one tokenizer id at a contiguous base offset, so
audio-token <-> LLM-token conversion is addition.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

TASK_TOKEN_MAP = {
    "vc": "<|task_vc|>",
    "tts": "<|task_tts|>",
    "asr": "<|task_asr|>",
    "s2s": "<|task_s2s|>",
    "t2s": "<|task_t2s|>",
    "understand": "<|task_understand|>",
    "caption": "<|task_cap|>",
    "controllable_tts": "<|task_controllable_tts|>",
    "prompt_tts": "<|task_prompt_tts|>",
    "speech_edit": "<|task_edit|>",
}

LEVELS_MAP = {"very_low": 0, "low": 1, "moderate": 2, "high": 3, "very_high": 4}

GENDER_MAP = {"female": 0, "male": 1}

_CONTROL_TOKENS = [
    "<|start_content|>",
    "<|end_content|>",
    "<|start_global_token|>",
    "<|end_global_token|>",
    "<|start_semantic_token|>",
    "<|end_semantic_token|>",
    "<|start_style_label|>",
    "<|end_style_label|>",
]

_SPECIAL_RE = re.compile(r"<\|[^|]+\|>")


class SyntheticSparkTokenizer:
    """Deterministic checkpoint-free tokenizer.

    Layout: [0..255] raw bytes, then control/task/attribute specials, then
    `n_semantic` semantic ids, then `n_global` global ids — the same ids as
    the JAX package's tokenizer of the same name.
    """

    def __init__(self, n_semantic: int = 8192, n_global: int = 4096):
        specials: List[str] = ["<|im_end|>", "<|endoftext|>"]
        specials += list(TASK_TOKEN_MAP.values())
        specials += _CONTROL_TOKENS
        specials += [f"<|gender_{i}|>" for i in range(len(GENDER_MAP))]
        specials += [f"<|pitch_label_{i}|>" for i in range(len(LEVELS_MAP))]
        specials += [f"<|speed_label_{i}|>" for i in range(len(LEVELS_MAP))]
        self._special_to_id: Dict[str, int] = {s: 256 + i for i, s in enumerate(specials)}
        base = 256 + len(specials)
        self.semantic_base = base
        self.n_semantic = n_semantic
        self.global_base = base + n_semantic
        self.n_global = n_global
        self.vocab_size = self.global_base + n_global
        self.eos_ids = (self._special_to_id["<|im_end|>"],)
        self.pad_id = self._special_to_id["<|endoftext|>"]

    def token_id(self, token: str) -> int:
        if token in self._special_to_id:
            return self._special_to_id[token]
        m = re.match(r"<\|bicodec_semantic_(\d+)\|>", token)
        if m:
            return self.semantic_base + int(m.group(1))
        m = re.match(r"<\|bicodec_global_(\d+)\|>", token)
        if m:
            return self.global_base + int(m.group(1))
        raise KeyError(token)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in _SPECIAL_RE.finditer(text):
            ids.extend(text[pos : m.start()].encode("utf-8"))
            ids.append(self.token_id(m.group(0)))
            pos = m.end()
        ids.extend(text[pos:].encode("utf-8"))
        return ids


def build_clone_prompt(
    tok: SyntheticSparkTokenizer,
    text: str,
    global_tokens: np.ndarray,
    semantic_tokens: Optional[np.ndarray] = None,
    prompt_text: Optional[str] = None,
) -> List[int]:
    """Voice-cloning prompt (reference `cli/SparkTTS.py:53-108`): the text
    (after `prompt_text` when given), the prompt wav's codec global ids and,
    with `prompt_text`, its semantic ids, which the LM continues."""
    ids: List[int] = [tok.token_id(TASK_TOKEN_MAP["tts"]), tok.token_id("<|start_content|>")]
    ids.extend(tok.encode(text if prompt_text is None else prompt_text + text))
    ids.append(tok.token_id("<|end_content|>"))
    ids.append(tok.token_id("<|start_global_token|>"))
    ids.extend(int(g) + tok.global_base for g in np.asarray(global_tokens).reshape(-1))
    ids.append(tok.token_id("<|end_global_token|>"))
    if prompt_text is not None and semantic_tokens is not None:
        ids.append(tok.token_id("<|start_semantic_token|>"))
        ids.extend(int(s) + tok.semantic_base for s in np.asarray(semantic_tokens).reshape(-1))
    return ids


def build_control_prompt(
    tok: SyntheticSparkTokenizer, text: str, gender: str, pitch: str, speed: str
) -> List[int]:
    """Controllable voice-creation prompt (reference `cli/SparkTTS.py:110-155`)."""
    if gender not in GENDER_MAP or pitch not in LEVELS_MAP or speed not in LEVELS_MAP:
        raise ValueError(f"unknown voice attributes {gender!r}, {pitch!r}, {speed!r}")
    ids: List[int] = [
        tok.token_id(TASK_TOKEN_MAP["controllable_tts"]),
        tok.token_id("<|start_content|>"),
    ]
    ids.extend(tok.encode(text))
    ids.append(tok.token_id("<|end_content|>"))
    ids.append(tok.token_id("<|start_style_label|>"))
    ids.append(tok.token_id(f"<|gender_{GENDER_MAP[gender]}|>"))
    ids.append(tok.token_id(f"<|pitch_label_{LEVELS_MAP[pitch]}|>"))
    ids.append(tok.token_id(f"<|speed_label_{LEVELS_MAP[speed]}|>"))
    ids.append(tok.token_id("<|end_style_label|>"))
    return ids


def extract_semantic_ids(tok: SyntheticSparkTokenizer, generated: Sequence[int]) -> np.ndarray:
    """Generated LLM ids -> codec semantic ids, order-preserving."""
    g = np.asarray(generated).reshape(-1)
    mask = (g >= tok.semantic_base) & (g < tok.semantic_base + tok.n_semantic)
    return (g[mask] - tok.semantic_base).astype(np.int32)


def extract_global_ids(tok: SyntheticSparkTokenizer, generated: Sequence[int]) -> np.ndarray:
    """Generated LLM ids -> codec global ids (voice creation emits these)."""
    g = np.asarray(generated).reshape(-1)
    mask = (g >= tok.global_base) & (g < tok.global_base + tok.n_global)
    return (g[mask] - tok.global_base).astype(np.int32)


def padded_global_tokens(
    tok: SyntheticSparkTokenizer, generated: Sequence[int], token_num: int, warn: bool = False
) -> np.ndarray:
    """(1, token_num) speaker tokens from a generated stream, zero-padded when
    the LM emitted fewer than token_num globals."""
    g = extract_global_ids(tok, generated)
    if g.size < token_num:
        if warn:
            logging.getLogger(__name__).warning(
                "controllable mode generated %d/%d global tokens; zero-padding",
                g.size, token_num,
            )
        g = np.pad(g, (0, token_num - g.size))
    return g[None, :token_num]
