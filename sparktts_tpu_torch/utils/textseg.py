"""Sentence segmentation for longform synthesis (host string logic).

A copy of `sparktts_tpu/utils/textseg.py`.  One request synthesizes at most
`max_new_tokens` of audio, so `SparkTTSPipeline.inference_long` splits the
text at sentence boundaries, packs sentences into segments that fit that
budget, and synthesizes them one after another in one voice.
"""

from __future__ import annotations

from typing import List

# sentence-final punctuation (Latin + CJK full-width + newline as a hard break)
_ENDERS = frozenset(".!?;…。！？；\n")
# secondary break points for over-long sentences, preferred over raw cuts
_SOFT_BREAKS = frozenset(",:、，： ")


def split_sentences(text: str) -> List[str]:
    """Split into sentences, each keeping its terminating punctuation.

    Runs of terminators ("?!", "...") stay attached to their sentence, as is
    whitespace after a terminator — no spoken content is dropped or
    reordered (only whitespace-only pieces are filtered).
    """
    sentences: List[str] = []
    start = 0
    i = 0
    n = len(text)
    while i < n:
        if text[i] in _ENDERS:
            while i + 1 < n and (text[i + 1] in _ENDERS or text[i + 1].isspace()):
                i += 1
            sentences.append(text[start : i + 1])
            start = i + 1
        i += 1
    if start < n:
        sentences.append(text[start:])
    return [s for s in sentences if s.strip()]


def _hard_split(sentence: str, max_chars: int) -> List[str]:
    """Cut a single over-long sentence at soft break points (comma/space),
    falling back to fixed-width cuts for unbroken runs (unspaced scripts)."""
    pieces: List[str] = []
    rest = sentence
    while len(rest) > max_chars:
        cut = -1
        for j in range(max_chars, 0, -1):
            if rest[j - 1] in _SOFT_BREAKS:
                cut = j
                break
        if cut <= 0:
            cut = max_chars
        pieces.append(rest[:cut])
        rest = rest[cut:]
    if rest.strip():
        pieces.append(rest)
    return pieces


def pack_segments(text: str, max_chars: int = 400) -> List[str]:
    """Sentence-boundary segmentation: greedy-pack whole sentences up to
    `max_chars` per segment; sentences longer than `max_chars` are split at
    soft break points.  Returns non-empty stripped segments whose
    concatenation preserves the spoken content in order."""
    if max_chars <= 0:
        raise ValueError("max_chars must be positive")
    segments: List[str] = []
    current = ""
    for sentence in split_sentences(text):
        for piece in _hard_split(sentence, max_chars) if len(sentence) > max_chars else [sentence]:
            if current and len(current) + len(piece) > max_chars:
                segments.append(current)
                current = piece
            else:
                current += piece
    if current.strip():
        segments.append(current)
    return [s.strip() for s in segments if s.strip()]
