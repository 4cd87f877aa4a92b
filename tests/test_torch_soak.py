"""Randomized soak of the port's continuous server: mixed modes, jittered
arrivals, mid-stream abandonment and slot pressure in one run, then the
server must have drained to a clean state (every slot free, no inflight
bookkeeping left behind, accounting consistent).

The counterpart of `tests/test_soak.py`, with its request mix (the same
`random.Random` seeds), its server settings and each of its assertions, on
the port's tiny config on the CPU, with EOS off (the port's random weights
draw it as a first id).  `tests/test_torch_server.py` holds each mechanism
alone; this file interleaves them as live traffic does.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import tiny_test_config
from sparktts_tpu_torch.lm.continuous import RequestTooLong
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer


@pytest.fixture(scope="module")
def pipe():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # batched torch work: one intra-op thread under xdist
    p = SparkTTSPipeline(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32,
                         max_new_tokens=16, prompt_bucket=32)
    # random weights sample EOS at chance level, and a request whose first id
    # is EOS ends with no audio; the budget is fixed, as `benchmark_torch.py
    # --ignore_eos` fixes it, so every request runs its 12 ids
    p.tokenizer.eos_ids = ()
    yield p
    torch.set_num_threads(threads)


def _wav(freq):
    sr = 16000
    t = np.arange(sr) / sr
    return 0.3 * np.sin(2 * np.pi * freq * t)


# (kind, kwargs) templates; texts stay short so every prompt shares one
# 32-token bucket and the soak exercises scheduling, not warm-ups
def _requests(rng):
    reqs = []
    for i in range(12):
        kind = rng.choice(["clone_off", "clone_stream", "ctrl_off",
                           "ctrl_stream", "clone_text", "abandon"])
        base = dict(text=f"soak {i}", max_new_tokens=12)
        if kind in ("clone_off", "clone_stream", "abandon"):
            base["prompt_wav"] = _wav(200 + 20 * (i % 5))
        elif kind == "clone_text":
            base["prompt_wav"] = _wav(260)
            base["prompt_text"] = "short transcript"
        else:
            base.update(gender=rng.choice(["male", "female"]),
                        pitch="moderate", speed="moderate")
        reqs.append((kind, base))
    return reqs


async def _drive(server, rng, jitter, kind, kw):
    await asyncio.sleep(rng.random() * jitter)  # jittered arrival
    if kind in ("clone_stream", "ctrl_stream"):
        chunks = []
        async for c in server.synthesize_streaming(**kw):
            chunks.append(c)
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if kind == "abandon":
        # walk away after the first audio; over the paged engine its
        # reserved pages must come back to the pool
        agen = server.synthesize_streaming(**kw)
        async for _c in agen:
            break
        await agen.aclose()
        return None
    return await server.synthesize(**kw)


async def _drain(server):
    """Every slot free again within a bounded wait."""
    for _ in range(200):
        if server.engine.free_slots() == server.engine.max_slots:
            break
        await asyncio.sleep(0.05)


def _check_results(reqs, results):
    errors = [r for r in results if isinstance(r, Exception)]
    assert not errors, errors
    n_abandoned = sum(1 for kind, _ in reqs if kind == "abandon")
    finished = [r for r in results if isinstance(r, np.ndarray)]
    assert len(finished) == len(reqs) - n_abandoned
    return n_abandoned, finished


def test_randomized_soak_drains_clean(pipe):
    rng = random.Random(7)
    reqs = _requests(rng)

    async def run():
        # 3 slots for 12 requests: constant queue pressure and slot reuse;
        # the cache holds the transcript clones (the longest prompts)
        server = ContinuousTTSServer(pipe, max_slots=3, steps_per_dispatch=4, cache_len=512)
        await server.start()
        results = await asyncio.gather(
            *(_drive(server, rng, 0.8, kind, kw) for kind, kw in reqs),
            return_exceptions=True,
        )
        await _drain(server)
        state = dict(
            free=server.engine.free_slots(),
            max_slots=server.engine.max_slots,
            inflight=len(server.inflight),
            stats=dict(server.stats),
        )
        await server.stop()
        return results, state

    results, state = asyncio.new_event_loop().run_until_complete(run())

    n_abandoned, finished = _check_results(reqs, results)
    for w in finished:
        assert np.isfinite(w).all() and w.size > 0

    # clean drain: no slot leaked, no request bookkeeping left behind
    assert state["free"] == state["max_slots"], state
    assert state["inflight"] == 0, state
    # accounting: every request that was not abandoned completed
    assert state["stats"]["completed"] >= len(reqs) - n_abandoned
    assert state["stats"]["requests"] == len(reqs)


def test_request_too_long_rejected_cleanly(pipe):
    """A prompt and budget that can never fit a slot is rejected with
    RequestTooLong (no capacity assert, no warm-up of the doomed fused
    signature), and the server keeps serving afterwards."""

    async def run():
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4)
        await server.start()
        cap = server._slot_capacity()
        with pytest.raises(RequestTooLong):
            # the transcript clone pushes the prompt past the tiny cache
            await server.synthesize(
                "way too much", prompt_wav=_wav(250),
                prompt_text="long transcript " * 4,
                max_new_tokens=cap,
            )
        # no admission signature was warmed for the doomed request
        assert not server.engine._admit_ready
        # the server still serves a fitting request
        wav = await server.synthesize("still fine", prompt_wav=_wav(300))
        await server.stop()
        return wav

    wav = asyncio.new_event_loop().run_until_complete(run())
    assert np.isfinite(wav).all() and wav.size > 0


def test_randomized_soak_paged_engine(pipe):
    """The same soak over the paged engine (page reservation and deferral
    under the same mixed load), a small page pool to force deferrals."""
    rng = random.Random(11)
    # transcript clones need more room a slot than the tiny page table;
    # their fit or rejection is covered above
    reqs = [(k, kw) for k, kw in _requests(rng) if k != "clone_text"][:8]

    async def run():
        server = ContinuousTTSServer(pipe, max_slots=3, steps_per_dispatch=4, paged=True,
                                     page_size=32)
        await server.start()
        results = await asyncio.gather(
            *(_drive(server, rng, 0.5, kind, kw) for kind, kw in reqs),
            return_exceptions=True,
        )
        await _drain(server)
        state = dict(
            free=server.engine.free_slots(),
            max_slots=server.engine.max_slots,
            pages_free=len(server.engine.free_pages),
            reserved=int(server.engine.reserved.sum()),
            stats=dict(server.stats),
        )
        await server.stop()
        return results, state

    results, state = asyncio.new_event_loop().run_until_complete(run())
    _, finished = _check_results(reqs, results)
    for w in finished:
        assert np.isfinite(w).all()
    assert state["free"] == state["max_slots"], state
    # every reserved page back in the pool (abandoned streams' too)
    assert state["reserved"] == 0, state
