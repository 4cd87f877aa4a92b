"""Spark-TTS's text side and token layout, written out plainly for the reference.

The byte-level synthetic tokenizer that a pipeline without a tokenizer file
uses: ids 0-255 are bytes, then the special tokens in a fixed order, then the
semantic ids, then the global ids.  The controllable (voice creation) prompt
and the extraction of codec ids from an emitted stream follow the published
Spark-TTS inference script (`cli/SparkTTS.py`).  Nothing here imports the
program under test.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

TASKS = ["vc", "tts", "asr", "s2s", "t2s", "understand", "cap", "controllable_tts",
         "prompt_tts", "edit"]
CONTROL_TOKENS = ["start_content", "end_content", "start_global_token", "end_global_token",
                  "start_semantic_token", "end_semantic_token", "start_style_label",
                  "end_style_label"]
GENDERS = {"female": 0, "male": 1}
LEVELS = {"very_low": 0, "low": 1, "moderate": 2, "high": 3, "very_high": 4}


class Layout:
    """Ids of the byte-level vocabulary for `n_semantic` and `n_global` codes."""

    def __init__(self, n_semantic: int, n_global: int):
        specials = ["<|im_end|>", "<|endoftext|>"]
        specials += [f"<|task_{t}|>" for t in TASKS]
        specials += [f"<|{t}|>" for t in CONTROL_TOKENS]
        specials += [f"<|gender_{i}|>" for i in range(len(GENDERS))]
        specials += [f"<|pitch_label_{i}|>" for i in range(len(LEVELS))]
        specials += [f"<|speed_label_{i}|>" for i in range(len(LEVELS))]
        self.special: Dict[str, int] = {s: 256 + i for i, s in enumerate(specials)}
        self.semantic_base = 256 + len(specials)
        self.n_semantic = n_semantic
        self.global_base = self.semantic_base + n_semantic
        self.n_global = n_global
        self.eos = self.special["<|im_end|>"]

    def control_prompt(self, text: str, gender: str, pitch: str, speed: str) -> List[int]:
        s = self.special
        return ([s["<|task_controllable_tts|>"], s["<|start_content|>"]]
                + list(text.encode("utf-8"))
                + [s["<|end_content|>"], s["<|start_style_label|>"],
                   s[f"<|gender_{GENDERS[gender]}|>"], s[f"<|pitch_label_{LEVELS[pitch]}|>"],
                   s[f"<|speed_label_{LEVELS[speed]}|>"], s["<|end_style_label|>"]])

    def control_allowed(self) -> np.ndarray:
        """The ids voice creation may emit: every semantic and global id,
        their start and end markers, and EOS."""
        ids = list(range(self.semantic_base, self.global_base + self.n_global))
        ids += [self.eos] + [self.special[f"<|{t}|>"] for t in CONTROL_TOKENS[2:6]]
        return np.asarray(sorted(set(ids)), np.int64)

    def semantic_ids(self, tokens: Sequence[int]) -> np.ndarray:
        g = np.asarray(tokens, np.int64).reshape(-1)
        keep = (g >= self.semantic_base) & (g < self.semantic_base + self.n_semantic)
        return (g[keep] - self.semantic_base).astype(np.int64)

    def speaker_ids(self, tokens: Sequence[int], token_num: int) -> np.ndarray:
        """The first `token_num` global ids of a stream, zero-padded."""
        g = np.asarray(tokens, np.int64).reshape(-1)
        keep = (g >= self.global_base) & (g < self.global_base + self.n_global)
        ids = (g[keep] - self.global_base)[:token_num]
        return np.pad(ids, (0, token_num - ids.size)).astype(np.int64)

