"""Prompt assembly and token-id arithmetic (host code).

A copy of `sparktts_tpu/prompt.py` and the maps of `sparktts_tpu/utils/tokens.py`.
Every `<|bicodec_semantic_N|>` / `<|bicodec_global_N|>` is one tokenizer id
at a contiguous base offset, so audio-token <-> LLM-token conversion is
addition.  Two tokenizers give those ids: `HFSparkTokenizer`, the
checkpoint's own (`LLM/tokenizer.json`, read with the `tokenizers` package),
and `SyntheticSparkTokenizer`, a byte-level stand-in for random weights.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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


class SparkTokenizerBase:
    """What the pipeline reads of a tokenizer."""

    semantic_base: int
    global_base: int
    n_semantic: int
    n_global: int
    eos_ids: Tuple[int, ...]
    pad_id: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def token_id(self, token: str) -> int:
        raise NotImplementedError


def _special_content(entry) -> Optional[str]:
    """A special token of `tokenizer_config.json`: a string, or a dict with
    its `content`."""
    return entry.get("content") if isinstance(entry, dict) else entry


class HFSparkTokenizer(SparkTokenizerBase):
    """The checkpoint's tokenizer: `LLM/tokenizer.json` through the
    `tokenizers` package, EOS and pad from `LLM/tokenizer_config.json`.  The
    semantic and global id ranges are found once, and checked contiguous so
    that id arithmetic is safe."""

    def __init__(self, model_dir: str | Path, n_semantic: int = 8192, n_global: int = 4096):
        from tokenizers import Tokenizer

        llm_dir = Path(model_dir) / "LLM"
        self.tok = Tokenizer.from_file(str(llm_dir / "tokenizer.json"))
        config_path = llm_dir / "tokenizer_config.json"
        config = json.loads(config_path.read_text()) if config_path.exists() else {}
        self.semantic_base = self.token_id("<|bicodec_semantic_0|>")
        self.global_base = self.token_id("<|bicodec_global_0|>")
        for probe in (1, 100):
            if self.token_id(f"<|bicodec_semantic_{probe}|>") != self.semantic_base + probe:
                raise ValueError("semantic token ids are not contiguous")
        if self.token_id("<|bicodec_global_1|>") != self.global_base + 1:
            raise ValueError("global token ids are not contiguous")
        self.n_semantic = n_semantic
        self.n_global = n_global
        eos = _special_content(config.get("eos_token"))
        if eos is None:
            raise ValueError(f"{config_path} names no eos_token")
        self.eos_ids = (self.token_id(eos),)
        pad = _special_content(config.get("pad_token"))
        self.pad_id = self.token_id(pad) if pad is not None else self.eos_ids[0]

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        """Specials kept; no HF space clean-up (Qwen2's tokenizer config
        turns it off)."""
        return self.tok.decode([int(i) for i in ids], skip_special_tokens=False)

    def token_id(self, token: str) -> int:
        i = self.tok.token_to_id(token)
        if i is None:
            raise KeyError(token)
        return i


class SyntheticSparkTokenizer(SparkTokenizerBase):
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
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
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

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 256:
                byte_buf.append(i)
                continue
            flush()
            if i in self._id_to_special:
                out.append(self._id_to_special[i])
            elif self.semantic_base <= i < self.semantic_base + self.n_semantic:
                out.append(f"<|bicodec_semantic_{i - self.semantic_base}|>")
            elif self.global_base <= i < self.global_base + self.n_global:
                out.append(f"<|bicodec_global_{i - self.global_base}|>")
        flush()
        return "".join(out)


def build_clone_prompt(
    tok: SparkTokenizerBase,
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
    tok: SparkTokenizerBase, text: str, gender: str, pitch: str, speed: str
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


def clone_prompt_scaffold(
    tok: SparkTokenizerBase,
    text: str,
    n_global: int,
    n_semantic: int,
    prompt_text: Optional[str] = None,
    t_pad: Optional[int] = None,
) -> Tuple[np.ndarray, int, int, int]:
    """The host-known half of a clone prompt, for assembly on the device.

    Every id of the clone prompt but the audio tokens is known on the host
    without reading the codec's output (the audio-token counts follow from
    the wav's length), so tokenize -> assemble -> prefill needs no host
    sync.  Returns (scaffold (t_pad,) int32 right-padded with pad_id,
    prompt_len, global_offset, semantic_offset); positions [global_offset,
    global_offset + n_global) and [semantic_offset, semantic_offset +
    n_semantic) hold pad_id placeholders that `assemble_clone_ids` fills.
    The token order is `build_clone_prompt`'s."""
    head: List[int] = [tok.token_id(TASK_TOKEN_MAP["tts"]), tok.token_id("<|start_content|>")]
    head.extend(tok.encode(prompt_text + text if prompt_text is not None else text))
    head.append(tok.token_id("<|end_content|>"))
    head.append(tok.token_id("<|start_global_token|>"))
    g_off = len(head)
    tail: List[int] = [tok.token_id("<|end_global_token|>")]
    if prompt_text is not None:
        tail.append(tok.token_id("<|start_semantic_token|>"))
    else:
        n_semantic = 0
    s_off = g_off + n_global + len(tail)
    prompt_len = s_off + n_semantic
    if t_pad is None:
        t_pad = prompt_len
    if t_pad < prompt_len:
        raise ValueError(f"t_pad {t_pad} < prompt length {prompt_len}")
    scaffold = np.full(t_pad, tok.pad_id, np.int32)
    scaffold[:g_off] = head
    scaffold[g_off + n_global : s_off] = tail
    return scaffold, prompt_len, g_off, s_off


def extract_semantic_ids(tok: SparkTokenizerBase, generated: Sequence[int]) -> np.ndarray:
    """Generated LLM ids -> codec semantic ids, order-preserving."""
    g = np.asarray(generated).reshape(-1)
    mask = (g >= tok.semantic_base) & (g < tok.semantic_base + tok.n_semantic)
    return (g[mask] - tok.semantic_base).astype(np.int32)


def extract_global_ids(tok: SparkTokenizerBase, generated: Sequence[int]) -> np.ndarray:
    """Generated LLM ids -> codec global ids (voice creation emits these)."""
    g = np.asarray(generated).reshape(-1)
    mask = (g >= tok.global_base) & (g < tok.global_base + tok.n_global)
    return (g[mask] - tok.global_base).astype(np.int32)


def padded_global_tokens(
    tok: SparkTokenizerBase, generated: Sequence[int], token_num: int, warn: bool = False
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
