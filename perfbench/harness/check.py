"""The comparison that decides `correct`: what the timed path served,
against the plain reference run on the same inputs after the window.

Numbers compared (each against its limit in the configuration's file):

  * `lm_gap`: over every token the greedy requests of the window were
    served, the largest gap by which its reference logit lies below the
    reference's best over the same guided rows (prompt and served tokens
    fed to the reference's full forward).  A token outside the guided rows
    counts as an infinite gap.
  * `wave_err`: over a sample of the window's requests drawn from the seed
    (the longest among them), the largest |served - reference| over the
    request's samples, as a share of the reference's largest |sample|.  The
    reference renders the whole utterance's semantic ids with the speaker
    ids the request was rendered with.
  * `speaker_bad`: requests whose speaker ids are not the zero-padded first
    global ids of what they were served, or whose audio is not one hop a
    semantic id.  Limit 0.
  * `budget_missed`: requests served another number of ids than their
    budget (the weights leave the end-of-sequence id no chance).  Limit 0.
  * `lost`: requests of the window that failed or never came.  Limit 0.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import bicodec as ref_codec
from perfbench.reference import qwen as ref_lm
from perfbench.reference.prompt import Layout


@contextlib.contextmanager
def fp32_flags(tf32: bool = False):
    """The TF32 flags set for a reference computation (off: full float32),
    and restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lm_gaps(w: Dict, llm: Dict, layout: Layout, prompts: Sequence[List[int]],
            served: Sequence[np.ndarray], device) -> List[float]:
    """The largest gap of each served sequence (see `lm_gap`)."""
    rows = torch.as_tensor(layout.control_allowed(), device=device)
    index = {int(r): i for i, r in enumerate(layout.control_allowed())}
    out = []
    for prompt, toks in zip(prompts, served):
        toks = np.asarray(toks, np.int64)
        if toks.size == 0:
            out.append(0.0)
            continue
        if any(int(t) not in index for t in toks):
            out.append(math.inf)
            continue
        ids = torch.as_tensor(np.concatenate([np.asarray(prompt, np.int64), toks]), device=device)
        pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + toks.size, device=device)
        lg = ref_lm.logits(w, llm, ids, rows, pos)
        cols = torch.as_tensor([index[int(t)] for t in toks], device=device)
        gap = lg.max(dim=1).values - lg.gather(1, cols[:, None])[:, 0]
        out.append(float(gap.max()))
    return out


def speaker_judged(layout: Layout, tokens: np.ndarray, speaker: Optional[np.ndarray],
                   token_num: int) -> bool:
    """Whether `speaker` is the zero-padded first global ids of the served
    tokens."""
    if speaker is None:
        return layout.semantic_ids(tokens).size == 0
    speaker = np.asarray(speaker, np.int64).reshape(-1)
    return np.array_equal(speaker, layout.speaker_ids(tokens, token_num))


def reference_audio(p: Dict, bicodec: Dict, speaker: np.ndarray, semantic: np.ndarray,
                    bucket: int, hop: int, device) -> np.ndarray:
    """The utterance as the reference renders it."""
    if semantic.size == 0:
        return np.zeros(0, np.float32)
    spk = torch.as_tensor(np.asarray(speaker, np.int64), device=device)
    sem = torch.as_tensor(np.asarray(semantic, np.int64), device=device)
    wav = ref_codec.decode(p, bicodec, spk, sem, bucket)
    return wav[: semantic.size * hop].float().cpu().numpy()


def wave_errors(p: Dict, bicodec: Dict, layout: Layout, items: Sequence[Dict], bucket: int,
                hop: int, device, tf32_control: bool = False) -> List[float]:
    """`wave_err` of each item (tokens, speaker, audio).  With
    `tf32_control` the served audio is replaced by the reference's own
    rendering with the TF32 flags on: the control for this number."""
    out = []
    for it in items:
        sem = layout.semantic_ids(it["tokens"])
        with fp32_flags():
            ref = reference_audio(p, bicodec, it["speaker"], sem, bucket, hop, device)
        served = it["audio"]
        if tf32_control:
            with fp32_flags(tf32=True):
                served = reference_audio(p, bicodec, it["speaker"], sem, bucket, hop, device)
        if served.shape != ref.shape:
            out.append(math.inf)
            continue
        scale = float(np.abs(ref).max()) if ref.size else 1.0
        out.append(float(np.abs(served - ref).max()) / max(scale, 1e-12) if ref.size else 0.0)
    return out
