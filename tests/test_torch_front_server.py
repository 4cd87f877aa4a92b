"""The port's batching `TTSServer` (`serve/server.py`) against the JAX
package's, and the ownership of decode units (`lm/graphs.UnitCache`).

One module-scoped pair of servers, JAX and port, over the same weights
(tiny config, fp32, the LM's weights scaled x4 so that greedy decoding of
the random tiny LM does not repeat one id), each running on an event loop
of its own thread.  Greedy requests (top_k = 1) in one batching window, two
clones (with and without a transcript) and a creation: the port's ids equal
the JAX server's bit for bit, on the fused and on the host clone path, and
its waveforms are within WAV_REL_TOL of the JAX ones (the codec tolerance of
the port's pipeline tests: fp32, summed in another order).  Then the
failure and batching semantics of `tests/test_server.py`, the voice-cache
server cases of `tests/test_voice_cache.py` (a cached voice changes no
output, dense and paged), and the decode units' owners: a pipeline's units
go when its `llm_params` is replaced or it is dropped, an engine's at
`close` (the test hook `graphs.CACHED_DEVICE_TYPES` caches units on the CPU,
where `unit()` otherwise builds a fresh one every call).
"""

import asyncio
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import tiny_test_config
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import build_control_prompt
from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer
from sparktts_tpu_torch.serve.server import TTSRequest, TTSServer

WAV_REL_TOL = 1e-4
MAX_NEW = 16


def _wav(freq=300.0, seconds=0.25):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


class _Loop:
    """An event loop on a thread of its own, with the servers started on it."""

    def __init__(self, *servers):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.servers = servers
        for s in servers:
            self.run(s.start())

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def gather(self, server, requests):
        async def go():
            return await asyncio.gather(*(server.synthesize(r) for r in requests),
                                        return_exceptions=True)
        return self.run(go())

    def close(self):
        for s in self.servers:
            self.run(s.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _spy_ids(pipe) -> list:
    """Record the ids of every batched generate of `pipe`: (ids per row) for
    generate_tokens_batch and generate_and_vocode_batch alike."""
    seen = []
    real_tokens, real_fused = pipe.generate_tokens_batch, pipe.generate_and_vocode_batch

    def tokens(prompts, **kw):
        out = real_tokens(prompts, **kw)
        seen.append(("host", kw.get("mode"), kw.get("seed"), [np.asarray(o) for o in out]))
        return out

    def fused(*a, **kw):
        wavs, ids = real_fused(*a, **kw)
        seen.append(("fused", "clone", kw.get("seed"), [np.asarray(o) for o in ids]))
        return wavs, ids

    pipe.generate_tokens_batch, pipe.generate_and_vocode_batch = tokens, fused
    return seen


@pytest.fixture(scope="module")
def servers():
    import jax
    import jax.numpy as jnp

    from sparktts_tpu.config import tiny_test_config as jax_tiny_config
    from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
    from sparktts_tpu.serve.server import TTSServer as JaxServer

    jpipe = JaxPipeline(config=jax_tiny_config(), lm_dtype=jnp.float32, max_new_tokens=MAX_NEW,
                        prompt_bucket=32)
    jpipe.llm_params = jax.tree.map(lambda x: 4 * x, jpipe.llm_params)
    tpipe = SparkTTSPipeline(
        config=tiny_test_config(), device="cpu", lm_dtype=torch.float32,
        max_new_tokens=MAX_NEW, prompt_bucket=32, voice_cache_size=2,
        llm_params=jax.tree.map(np.asarray, jpipe.llm_params),
        bicodec_params=jax.tree.map(np.asarray, jpipe.bicodec_params),
        wav2vec2_params=jax.tree.map(np.asarray, jpipe.w2v_params),
    )
    jserver = JaxServer(jpipe, max_batch=4, batch_window_ms=200.0)
    tserver = TTSServer(tpipe, max_batch=4, batch_window_ms=200.0)
    loop = _Loop(jserver, tserver)
    yield dict(jpipe=jpipe, tpipe=tpipe, jserver=jserver, tserver=tserver, loop=loop,
               jids=_spy_ids(jpipe), tids=_spy_ids(tpipe))
    loop.close()


GREEDY = (
    dict(text="first clone", prompt_wav=_wav(300.0), prompt_text="the prompt words"),
    dict(text="second clone", prompt_wav=_wav(440.0)),
    dict(text="a creation", gender="female", pitch="moderate", speed="moderate"),
)


@pytest.mark.parametrize("fused_clone", [True, False], ids=["fused", "host"])
def test_greedy_requests_equal_the_jax_server(servers, fused_clone):
    s = servers
    results = {}
    for key in ("j", "t"):
        server = s[f"{key}server"]
        server.fused_clone = fused_clone
        s[f"{key}ids"].clear()
        requests = [TTSRequest(top_k=1, seed=i, **r) for i, r in enumerate(GREEDY)]
        results[key] = s["loop"].gather(server, requests)
        assert server.stats_summary()["batches"] >= 1
    for key in ("j", "t"):
        assert not any(isinstance(r, Exception) for r in results[key]), results[key]
    # one group a mode; the fused path takes the clones, the host path all
    paths = sorted((p, m) for p, m, _, _ in s["tids"])
    want = [("fused", "clone"), ("host", "control")] if fused_clone else \
        [("host", "clone"), ("host", "control")]
    assert paths == want
    assert sorted((p, m) for p, m, _, _ in s["jids"]) == want
    by_path = lambda calls: sorted(calls, key=lambda c: c[:2])  # noqa: E731
    for (tp, tm, tseed, tids), (jp, jm, jseed, jids) in zip(by_path(s["tids"]),
                                                            by_path(s["jids"])):
        assert (tp, tm, list(tseed)) == (jp, jm, list(jseed))
        assert len(tids) == len(jids)
        for a, b in zip(tids, jids):
            assert a.size > 1 and len(set(a.tolist())) > 1
            np.testing.assert_array_equal(a, b)
    for got, want in zip(results["t"], results["j"]):
        assert got.sample_rate == want.sample_rate == 16000
        assert got.wav.shape == want.wav.shape and want.wav.size
        peak = max(float(np.abs(want.wav).max()), 1e-6)
        np.testing.assert_allclose(got.wav, want.wav, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)
    servers["tserver"].fused_clone = servers["jserver"].fused_clone = True


@pytest.mark.parametrize("fused_clone", [True, False], ids=["fused", "host"])
def test_bad_prompt_wav_fails_only_its_request(servers, fused_clone):
    server = servers["tserver"]
    server.fused_clone = fused_clone
    before = server.stats["failures"]
    bad = TTSRequest(text="bad", prompt_wav=np.zeros(0, np.float32))
    good = TTSRequest(text="good", prompt_wav=_wav(250.0))
    creation = TTSRequest(text="fine", gender="male", pitch="low", speed="moderate")
    out = servers["loop"].gather(server, [bad, good, creation])
    server.fused_clone = True
    assert isinstance(out[0], ValueError) and "empty prompt audio" in str(out[0])
    for res in out[1:]:
        assert res.sample_rate == 16000 and res.wav.size and np.isfinite(res.wav).all()
    assert server.stats["failures"] == before + 1


def test_distinct_seeds_share_one_group(servers):
    """Seeds are not part of the group key: three clones with seeds 3, 4, 5
    in one window are one batched generate with one generator a row, and a
    row's ids are those of its seed alone (the same seed again gives them
    back in another batch)."""
    s = servers
    s["tids"].clear()
    requests = [TTSRequest(text=f"utterance {i}", prompt_wav=_wav(300.0 + 40 * i), seed=3 + i)
                for i in range(3)]
    batches = s["tserver"].stats["batches"]
    out = s["loop"].gather(s["tserver"], requests)
    assert all(np.isfinite(r.wav).all() for r in out)
    assert s["tserver"].stats["batches"] - batches == 1
    ((path, mode, seeds, ids),) = s["tids"]
    assert (path, mode, list(seeds)) == ("fused", "clone", [3, 4, 5]) and len(ids) == 3
    s["tids"].clear()
    again = s["loop"].gather(s["tserver"], [TTSRequest(text="utterance 1",
                                                       prompt_wav=_wav(340.0), seed=4)])
    np.testing.assert_array_equal(s["tids"][0][3][0], ids[1])
    peak = float(np.abs(out[1].wav).max())  # vocoded at batch 1, not 3
    np.testing.assert_allclose(again[0].wav, out[1].wav, rtol=WAV_REL_TOL,
                               atol=WAV_REL_TOL * peak)


def test_window_batches_concurrent_requests(servers):
    server = servers["tserver"]
    before = dict(server.stats)
    requests = [TTSRequest(text=f"creation {i}", gender="female", pitch="moderate",
                           speed="high", seed=i) for i in range(4)]
    out = servers["loop"].gather(server, requests)
    assert all(r.sample_rate == 16000 and np.isfinite(r.wav).all() for r in out)
    assert server.stats["requests"] - before["requests"] == 4
    assert server.stats["batches"] - before["batches"] <= 2
    assert server.stats_summary()["avg_batch_occupancy"] > 1
    assert server.healthy


def test_server_needs_a_card_unless_the_pipeline_is_on_the_cpu(servers, monkeypatch):
    pipe = servers["tpipe"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pipe, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSServer(pipe)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_server_cached_voice_is_output_transparent(servers, paged):
    """A clone through ContinuousTTSServer with the voice cache off, then on
    (the second request a hit: the assembled admission on the dense engine,
    the chained path on the paged one): the same audio."""
    pipe = servers["tpipe"]

    def reset(size):
        pipe.voice_cache_size = size
        pipe._voice_cache.clear()
        pipe.voice_cache_stats.update(hits=0, misses=0)

    server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4, greedy=True,
                                 cache_len=256, paged=paged, fused_warm="sync")
    loop = _Loop(server)
    wav = _wav(260.0)
    try:
        reset(0)
        base = [loop.run(server.synthesize(t, prompt_wav=wav, max_new_tokens=12))
                for t in ("first text", "second text")]
        reset(2)
        cached = [loop.run(server.synthesize(t, prompt_wav=wav, max_new_tokens=12))
                  for t in ("first text", "second text")]
        hits = pipe.voice_cache_stats["hits"]
    finally:
        loop.close()
        reset(2)
    for got, want in zip(cached, base):
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert hits >= 1
    if not paged:
        assert server.stats.get("voice_cache_admissions", 0) >= 1


def test_decode_units_go_with_their_owner(monkeypatch):
    """With units cached on the CPU (the test hook): a pipeline's generate
    units are its own, listed by `graphs.units()` with its tag, and evicted
    when `llm_params` is replaced; an engine's go at `close` and its server's
    at `stop`; a dropped pipeline takes its units and its LM tree with it."""
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine

    monkeypatch.setattr(graphs, "CACHED_DEVICE_TYPES", ("cuda", "cpu"))
    pipe = SparkTTSPipeline(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32,
                            max_new_tokens=8, prompt_bucket=32)
    tag = pipe.units.tag

    def owned():
        return [u for u in graphs.units() if u.owner == tag]

    prompt = build_control_prompt(pipe.tokenizer, "hi", "female", "moderate", "moderate")
    first = pipe.generate_tokens(prompt, greedy=True)
    assert len(pipe.units) == 1 and len(owned()) == 1
    (unit,) = owned()
    np.testing.assert_array_equal(pipe.generate_tokens(prompt, greedy=True), first)
    assert owned() == [unit] and unit.replays >= 2  # the cached unit again
    old = weakref.ref(pipe.llm_params["embed"])
    pipe.llm_params = {k: v for k, v in pipe.llm_params.items()}  # a new tree, same leaves
    assert len(pipe.units) == 0
    del unit
    gc.collect()
    assert owned() == []
    pipe.generate_tokens(prompt, greedy=True)
    assert len(owned()) == 1

    eng = ContinuousBatchingEngine(pipe.llm_params, pipe.config.llm, max_slots=2,
                                   cache_len=128, prompt_pad=32, device="cpu",
                                   cache_dtype=torch.float32)
    eng.warm_units()
    assert len(eng.units) == 1 and [u.owner for u in graphs.units()].count(eng.units.tag) == 1
    eng.close()
    assert len(eng.units) == 0

    server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4, cache_len=128)
    loop = _Loop(server)
    loop.run(server.synthesize("hi", gender="male", pitch="low", speed="low", max_new_tokens=8))
    assert len(server.engine.units) == 1
    loop.close()
    assert len(server.engine.units) == 0 and not server._units_warm

    del pipe, eng, server, loop
    gc.collect()
    assert owned() == [] and old() is None
