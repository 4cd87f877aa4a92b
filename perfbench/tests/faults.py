"""Faults planted in the timed path, under a whole run of the harness: each
must make the run come out not correct.  Each takes a
`pytest.MonkeyPatch` and patches the program's module (never the
harness), so that the server built afterwards runs the broken code; on a
card the decode units capture it at the server's start."""

from __future__ import annotations

import numpy as np


def alter_token(mp) -> None:
    """A token altered where it is produced: the first of every fetched
    row moves to the next id."""
    import sparktts_tpu_torch.lm.continuous as cont

    real = cont.fetch_step_result

    def fetch(*a, **kw):
        toks, valid, done, extra = real(*a, **kw)
        toks = toks.copy()
        toks[:, 0] += 1
        return toks, valid, done, extra

    mp.setattr(cont, "fetch_step_result", fetch)


def alter_audio(mp) -> None:
    """An answer altered where it is produced: every vocode's samples
    scaled by 0.9."""
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    real = SparkTTSPipeline._vocode
    mp.setattr(SparkTTSPipeline, "_vocode",
               lambda self, g, s: [w * np.float32(0.9) for w in real(self, g, s)])


def stale_cache(mp) -> None:
    """A decode step that returns its state unchanged: its keys and values
    go to a copy of the cache, which is dropped, so every later step
    attends over the prompt and whatever the slot held before."""
    import sparktts_tpu_torch.lm.qwen as qwen

    real = qwen._attention_block

    def block(layer, x, rope, cache, *a, **kw):
        if x.shape[1] == 1:
            cache = type(cache)(k=cache.k.clone(), v=cache.v.clone())
        return real(layer, x, rope, cache, *a, **kw)

    mp.setattr(qwen, "_attention_block", block)


def half_dropped(mp) -> None:
    """Half of the batch left out: the upper half of the slots loses the
    second half of every dispatch's tokens."""
    import sparktts_tpu_torch.lm.continuous as cont

    real = cont.fetch_step_result

    def fetch(*a, **kw):
        toks, valid, done, extra = real(*a, **kw)
        valid = valid.copy()
        half = valid.shape[0] // 2
        valid[half:, valid.shape[1] // 2 :] = False
        return toks, valid, done, extra

    mp.setattr(cont, "fetch_step_result", fetch)


FAULTS = {f.__name__: f for f in (alter_token, alter_audio, stale_cache, half_dropped)}
# the number compared that each fault has to fail
FAILS = {"alter_token": "lm_gap", "alter_audio": "wave_err", "stale_cache": "lm_gap",
         "half_dropped": "budget_missed"}
