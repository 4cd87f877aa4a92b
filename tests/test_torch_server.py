"""The port's continuous-batching server (`serve/continuous_server.py`).

One greedy case against the JAX package's `ContinuousTTSServer` (tiny
config, fp32, the same weights): three concurrent requests, two clones and
one creation; ids equal and waveforms within 1e-4 of their peak (fp32,
summed in another order).  The rest holds the server against the port's own
offline paths, which the other test files hold against JAX: streaming
against offline and against the plain vocode path (bit for bit), the paged
server against the dense one, failure containment, slots freed by abandoned
streams, dispatch sizing, commit on stop, dispatch depth 2 against 1,
windowed vocodes against the full prefix (bit for bit), the cold vocode
batch, and the thread repairs the server needs (decode units built outside
the global lock, device speaker ids in `detokenize`, the TF32 flags with a
vocode and a tokenize open at once).
"""

import asyncio
import dataclasses
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import tiny_test_config
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.continuous import DISPATCH_LADDER, snap_to_ladder
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.serve.continuous_server import (
    ContinuousTTSServer,
    _Pending,
    _split_first_audio,
    _voc_state,
    default_stream_ctx,
    vocode_window_cap,
    warm_vocode_batch,
)
from sparktts_tpu_torch.utils.profiling import StageStats

WAV_REL_TOL = 1e-4
MAX_NEW = 16


def _config():
    cfg = tiny_test_config()
    # a 4-token first chunk, so a 16-token budget spans several chunks
    return dataclasses.replace(cfg, streaming=dataclasses.replace(cfg.streaming, frame_rate=4))


def _scaled(tree, factor=4):
    """LM weights scaled up, so that greedy decoding of the random tiny LM
    does not repeat one id."""
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return tree * factor


@pytest.fixture(scope="module")
def pipe():
    p = SparkTTSPipeline(config=_config(), device="cpu", lm_dtype=torch.float32, seed=1,
                         max_new_tokens=MAX_NEW, prompt_bucket=32, voice_cache_size=4)
    p.llm_params = _scaled(p.llm_params)
    return p


def _wav(freq=300.0, seconds=0.25):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _record_ids(server) -> dict:
    """Each finished request's ids, by its text."""
    ids, finish = {}, server._finish

    def spy(req_id, tokens):
        ids[server.inflight[req_id].text] = np.asarray(tokens)
        return finish(req_id, tokens)

    server._finish = spy
    return ids


async def _stream(server, **kw):
    chunks = [c async for c in server.synthesize_streaming(**kw)]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32), chunks


REQUESTS = (
    dict(text="first clone", prompt_wav=_wav(300.0), prompt_text="the prompt words"),
    dict(text="second clone", prompt_wav=_wav(440.0)),
    dict(text="a creation", gender="female", pitch="moderate", speed="moderate"),
)


async def _serve(server, requests=REQUESTS):
    await server.start()
    wavs = await asyncio.gather(*(server.synthesize(**r) for r in requests))
    await server.stop()
    return wavs


def test_greedy_server_equals_the_jax_server():
    import jax
    import jax.numpy as jnp

    from sparktts_tpu.config import tiny_test_config as jax_tiny_config
    from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
    from sparktts_tpu.serve.continuous_server import ContinuousTTSServer as JaxServer

    jax.clear_caches()
    jpipe = JaxPipeline(config=jax_tiny_config(), lm_dtype=jnp.float32, max_new_tokens=MAX_NEW,
                        prompt_bucket=32)
    jpipe.llm_params = jax.tree.map(lambda x: 4 * x, jpipe.llm_params)
    tpipe = SparkTTSPipeline(
        config=tiny_test_config(), device="cpu", lm_dtype=torch.float32, max_new_tokens=MAX_NEW,
        prompt_bucket=32, voice_cache_size=4,
        llm_params=jax.tree.map(np.asarray, jpipe.llm_params),
        bicodec_params=jax.tree.map(np.asarray, jpipe.bicodec_params),
        wav2vec2_params=jax.tree.map(np.asarray, jpipe.w2v_params),
    )
    kw = dict(max_slots=4, steps_per_dispatch=8, greedy=True, cache_len=256)
    jserver = JaxServer(jpipe, device_admission=False, spec_first_chunk=False,
                        vocode_batch=False, **kw)
    tserver = ContinuousTTSServer(tpipe, fused_warm="sync", **kw)
    jids, tids = _record_ids(jserver), _record_ids(tserver)
    jwavs = _run(_serve(jserver))
    twavs = _run(_serve(tserver))
    jax.clear_caches()
    assert tserver.stats["completed"] == 3 and tserver.stats.get("fused_admissions", 0) == 2
    assert set(tids) == {r["text"] for r in REQUESTS}
    for text in tids:
        np.testing.assert_array_equal(tids[text], jids[text], err_msg=text)
    for got, want in zip(twavs, jwavs):
        assert got.shape == want.shape and want.size
        peak = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_REL_TOL * peak)


def test_streaming_equals_offline_and_the_plain_path(pipe):
    """A greedy clone stream: its chunks equal the plain path's (host
    tokenize, no speculative chunk, scalar vocodes) bit for bit, the first
    one rendered inside the decode dispatch; its ids are the offline
    request's and its length the offline waveform's."""
    kw = dict(max_slots=2, steps_per_dispatch=8, greedy=True, cache_len=256)
    request = dict(text="stream this text", prompt_wav=_wav(260.0))
    fast = ContinuousTTSServer(pipe, fused_warm="sync", **kw)
    plain = ContinuousTTSServer(pipe, device_admission=False, spec_first_chunk=False,
                                vocode_batch=False, **kw)
    offline = ContinuousTTSServer(pipe, fused_warm="sync", **kw)
    ids = [_record_ids(s) for s in (fast, plain, offline)]

    async def stream(server):
        await server.start()
        out = await _stream(server, **request)
        await server.stop()
        return out

    f_wav, f_chunks = _run(stream(fast))
    p_wav, p_chunks = _run(stream(plain))
    (o_wav,) = _run(_serve(offline, [request]))
    assert fast.stats.get("spec_chunks", 0) >= 1, "the speculative chunk never ran"
    assert len(f_chunks) == len(p_chunks) >= 2
    for a, b in zip(f_chunks, p_chunks):
        np.testing.assert_array_equal(a, b)
    for other in ids[1:]:
        np.testing.assert_array_equal(ids[0][request["text"]], other[request["text"]])
    assert f_wav.shape == o_wav.shape


def test_paged_server_matches_dense(pipe):
    kw = dict(max_slots=2, steps_per_dispatch=8, greedy=True, cache_len=256, vocode_batch=False,
              fused_warm="sync")
    dense = ContinuousTTSServer(pipe, **kw)
    paged = ContinuousTTSServer(pipe, paged=True, page_size=32, **kw)
    d_ids, p_ids = _record_ids(dense), _record_ids(paged)
    d_wavs = _run(_serve(dense))
    p_wavs = _run(_serve(paged))
    for text in d_ids:
        np.testing.assert_array_equal(d_ids[text], p_ids[text], err_msg=text)
    for a, b in zip(d_wavs, p_wavs):
        np.testing.assert_array_equal(a, b)
    assert paged.engine.pages_in_use() == 0
    assert all(int(v) == 0 for v in paged.engine.steps_inflight)


def test_failure_containment(pipe):
    """An admission that fails (too long for a slot) fails its own request
    alone; the server serves the next one."""
    async def run():
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4)
        await server.start()
        bad = asyncio.create_task(server.synthesize("bad", prompt_wav=_wav(seconds=3.0),
                                                    prompt_text="a long transcript"))
        good = asyncio.create_task(server.synthesize("good", gender="male", pitch="low",
                                                     speed="low", max_new_tokens=8))
        with pytest.raises(Exception):
            await bad
        wav = await good
        await server.stop()
        return wav

    assert np.isfinite(_run(run())).all()


def test_abandoned_stream_frees_its_slot(pipe):
    async def run():
        server = ContinuousTTSServer(pipe, max_slots=1, steps_per_dispatch=4, cache_len=256)
        await server.start()
        agen = server.synthesize_streaming("abandoned", prompt_wav=_wav(220.0),
                                           max_new_tokens=64)
        first = None
        async for chunk in agen:
            first = chunk
            break
        await agen.aclose()
        for _ in range(200):
            if server.engine.free_slots() == 1:
                break
            await asyncio.sleep(0.02)
        assert server.engine.free_slots() == 1
        wav = await server.synthesize("after abandon", prompt_wav=_wav(300.0), max_new_tokens=8)
        await server.stop()
        return first, wav

    first, wav = _run(run())
    assert first is not None and np.isfinite(wav).all()


def _pending(**kw):
    base = dict(text="x", prompt_wav=None, prompt_text=None, gender=None, pitch=None,
                speed=None, max_new_tokens=100, future=None)
    base.update(kw)
    return _Pending(**base)


def test_requested_steps_first_chunk_only(pipe):
    """A stream caps the dispatch at its first chunk's distance only; two
    live slots cap it at co_dispatch_cap; recent company at
    anticipation_cap; a lone covered stream asks for its whole budget."""
    server = ContinuousTTSServer(pipe, max_slots=4, steps_per_dispatch=64)
    eng = server.engine
    stream = _pending(chunk_queue=asyncio.Queue(), stream_target=5, first_target=5)
    eng.owner[0], eng.budget[0], server.inflight[1] = 1, 100, stream
    assert server._requested_steps() == 8      # 5 rounded up to its covering rung
    stream.loop_tokens = 3
    assert server._requested_steps() == 4
    stream.loop_tokens = 5
    assert server._requested_steps() == 100
    eng.owner[1], eng.budget[1], server.inflight[2] = 2, 80, _pending(max_new_tokens=80)
    assert server._requested_steps() == 32
    stream.loop_tokens = 0
    assert server._requested_steps() == 5
    eng.owner[1] = None
    server.inflight.pop(2)
    stream.loop_tokens = 5
    assert server._requested_steps() == 16
    server._last_concurrent = float("-inf")
    assert server._requested_steps() == 100


def test_co_dispatch_caps_are_absolute(pipe):
    assert DISPATCH_LADDER[-1] == 512
    assert [snap_to_ladder(*a) for a in ((129, 512), (500, 512), (350, 512), (500, 128),
                                         (200, 200), (230, 200), (130, 200), (180, 200))] == \
        [128, 512, 256, 128, 200, 200, 128, 200]
    server = ContinuousTTSServer(pipe, max_slots=4, steps_per_dispatch=512)
    assert (server.co_dispatch_cap, server.anticipation_cap) == (64, 32)
    eng = server.engine
    eng.owner[0], eng.budget[0], server.inflight[1] = 1, 500, _pending(max_new_tokens=500)
    assert server._requested_steps() == 500
    assert snap_to_ladder(server._requested_steps(), server.steps) == 512
    eng.owner[1], eng.budget[1], server.inflight[2] = 2, 500, _pending(max_new_tokens=500)
    assert server._requested_steps() == 64
    eng.owner[1] = None
    server.inflight.pop(2)
    assert server._requested_steps() == 32


def test_stop_midstep_commits_and_delivers(pipe):
    """stop() while a fetch is in flight commits and delivers that dispatch:
    a stream that survives a stop()/start() gives the uninterrupted audio."""
    async def run(interrupt):
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4, greedy=True,
                                     cache_len=256)
        engine = server.engine
        real_fetch = engine.step_fetch
        loop = asyncio.get_running_loop()
        fetch_started = asyncio.Event()
        release = threading.Event()

        def slow_fetch(handle):
            loop.call_soon_threadsafe(fetch_started.set)
            release.wait(timeout=60)
            return real_fetch(handle)

        if interrupt:
            engine.step_fetch = slow_fetch
        await server.start()
        task = asyncio.create_task(_stream(server, text="restart survivor",
                                           prompt_wav=_wav(260.0), max_new_tokens=14))
        if interrupt:
            await asyncio.wait_for(fetch_started.wait(), timeout=60)
            threading.Timer(0.5, release.set).start()
            await server.stop()
            engine.step_fetch = real_fetch
            await server.start()
        wav, _ = await asyncio.wait_for(task, timeout=60)
        await server.stop()
        return wav

    loop = asyncio.new_event_loop()
    base = loop.run_until_complete(run(False))
    survived = loop.run_until_complete(run(True))
    np.testing.assert_array_equal(survived, base)


def test_dispatch_depth_2_equals_depth_1(pipe):
    def run(depth):
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=6,
                                     dispatch_depth=depth, greedy=True, vocode_batch=False,
                                     cache_len=256)

        async def go():
            await server.start()
            off = asyncio.create_task(server.synthesize("offline words", prompt_wav=_wav(250.0)))
            wav, chunks = await _stream(server, text="stream words", prompt_wav=_wav(330.0))
            out = await off, chunks
            await server.stop()
            return out

        out = _run(go())
        assert all(v == 0 for v in server._planned_ahead)
        return out

    (off1, chunks1), (off2, chunks2) = run(1), run(2)
    np.testing.assert_array_equal(off1, off2)
    assert len(chunks1) == len(chunks2)
    for a, b in zip(chunks1, chunks2):
        np.testing.assert_array_equal(a, b)


def test_longform_keeps_the_first_segments_voice(pipe):
    async def run():
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=8, cache_len=256)
        await server.start()
        wav = await server.synthesize_long(text="One sentence here. Another one there.",
                                           prompt_wav=_wav(300.0), max_segment_chars=20)
        await server.stop()
        return server, wav

    server, wav = _run(run())
    assert server.stats["longform_segments"] == 2 and np.isfinite(wav).all()


# ----------------------------------------------------------- the vocode worker


def _window_pending(n_glob, target):
    p = _pending(max_new_tokens=0)
    p.chunk_queue = object()  # a streaming request
    p.global_tokens = np.zeros((1, n_glob), np.int32)
    p.stream_target = target
    p.stream_schedule = itertools.repeat(target)
    return p


@pytest.mark.parametrize("case", ["context", "cap"])
def test_windowed_vocode_equals_the_full_prefix(pipe, case):
    """`context`: 40-token increments planned as 20-token chunks, each
    window re-rendering stream_ctx of left context; `cap`: one final tail
    split by the smallest legal window cap.  Either way the emitted samples
    equal the full-prefix vocode's bit for bit.  oneDNN is off for the
    test: it picks its convolution algorithm by sequence length, so its sums
    for one output position differ in the last bits between a window and
    the full prefix (the codec's own math does not; on the card
    `chip_smoke.py` holds the windows to the full prefix with cuDNN)."""
    tok, bucket = pipe.tokenizer, pipe.vocode_bucket
    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    ctx = default_stream_ctx(pipe)
    rng = np.random.default_rng(7)
    n = 160 if case == "context" else 7 * bucket + 13
    raw = (tok.semantic_base + rng.integers(0, tok.n_semantic, n)).astype(np.int32)

    def run(stream_ctx, cap):
        server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4, vocode_batch=False,
                                     stream_context_frames=stream_ctx, max_vocode_window=cap)
        if case == "context":
            p, step = _window_pending(n_glob, 20), 40
        else:
            p, step = _window_pending(n_glob, 10**6), n
            windows = server._plan_stream_chunks(_window_pending(n_glob, 10**6), raw, final=True)
        chunks = []
        for start in range(0, n, step):
            res = server._run_vocode_jobs([[p, raw[start : start + step], start + step >= n,
                                            False]])[0]
            assert res["error"] is None
            chunks += res["chunks"]
        if case == "cap" and cap < 10**6:
            assert len(windows) > 1
            emitted = 0
            for start, em, upto, render in windows:
                assert upto - start <= server.max_vocode_window and start % bucket == 0
                assert em == emitted and upto <= render <= n
                emitted = upto
            assert emitted == n
        return np.concatenate(chunks)

    with torch.backends.mkldnn.flags(enabled=False):
        if case == "context":
            got, full = run(ctx, 10**6), run(10**6, 10**6 + 10**6)
        else:
            got, full = run(ctx, ctx + 2 * bucket), run(ctx, 10**6)
    assert got.shape == full.shape == (n * pipe._wave_upsample,)
    np.testing.assert_array_equal(got, full)


def test_vocode_window_cap_floor_and_alignment(pipe):
    bucket, ctx = pipe.vocode_bucket, default_stream_ctx(pipe)
    assert vocode_window_cap(pipe) % bucket == 0
    assert vocode_window_cap(pipe, max_vocode_window=1) == ctx + 2 * bucket
    assert vocode_window_cap(pipe, max_vocode_window=17 * bucket + 1) == 18 * bucket


def _bare_server(pipe, vocode_batch=True):
    """A server shell with the vocode path's state only (no engine)."""
    server = object.__new__(ContinuousTTSServer)
    server.pipe = pipe
    server.stream_ctx = pipe.vocode_bucket
    server.max_vocode_window = 10**9
    server.vocode_batch = vocode_batch
    server._voc_batch_sizes = [2, 4]
    server.stats = {}
    server.stage_stats = StageStats()
    return server


def _vocode_jobs(pipe, n_sem):
    tok, n_glob = pipe.tokenizer, pipe.config.bicodec.speaker_encoder.token_num
    jobs = []
    for seed, streaming in ((1, True), (2, True), (3, False)):
        rng = np.random.default_rng(seed)
        p = _pending(max_new_tokens=0)
        if streaming:
            p.chunk_queue, p.stream_target, p.stream_schedule = object(), n_sem, iter([10**9])
        p.global_tokens = rng.integers(0, 4, size=(1, n_glob)).astype(np.int32)
        ids = (tok.semantic_base + rng.integers(0, tok.n_semantic, n_sem)).astype(np.int32)
        jobs.append([p, ids, seed > 1, not streaming])
    return jobs


def test_cold_vocode_batch_stays_scalar_then_warms_and_batches(pipe):
    n_sem = 3 * pipe.vocode_bucket  # a t_pad no other test warms
    warm = _voc_state(pipe)["warm"]
    assert not any(k[1] == n_sem for k in warm)
    server = _bare_server(pipe)
    scalar = server._run_vocode_jobs(_vocode_jobs(pipe, n_sem))
    assert server.stats.get("vocode_batched_rows", 0) < 3
    deadline = time.time() + 60
    while (4, n_sem) not in warm and time.time() < deadline:
        time.sleep(0.05)
    assert (4, n_sem) in warm, "the background warm-up never landed"
    server2 = _bare_server(pipe)
    batched = server2._run_vocode_jobs(_vocode_jobs(pipe, n_sem))
    assert (server2.stats["vocode_batched_calls"], server2.stats["vocode_batched_rows"]) == (1, 3)
    for a, b in zip(scalar, batched):
        assert a["error"] is None and b["error"] is None
        for x, y in zip([a["wav"]] + a["chunks"], [b["wav"]] + b["chunks"]):
            if x is not None:
                peak = max(float(np.abs(x).max()), 1e-6)
                np.testing.assert_allclose(y, x, rtol=0, atol=WAV_REL_TOL * peak)
    warm_vocode_batch(pipe, 2, n_sem)  # warm is idempotent
    assert (2, n_sem) in warm


def test_vocode_drain_merges_and_prioritizes():
    server = object.__new__(ContinuousTTSServer)
    server._vocode_q = asyncio.Queue()
    server.stats = {}

    def mk(streaming, emitted=0):
        p = _pending(max_new_tokens=0)
        if streaming:
            p.chunk_queue, p.stream_emitted = object(), emitted
        return p

    established, fresh, offline, gone = mk(True, 20), mk(True), mk(False), mk(True)
    gone.cancelled = True
    t = lambda *ids: np.asarray(ids, np.int32)  # noqa: E731
    items = [(established, t(1, 2), False, False), (offline, t(9), True, True),
             (gone, t(7), False, False), (established, t(3), False, False),
             (fresh, t(4), False, False), (fresh, t(5), True, False)]
    for it in items[1:]:
        server._vocode_q.put_nowait(it)
    jobs = server._drain_vocode_jobs(items[0])
    assert len(jobs) == 3 and server.stats["vocode_merged"] == 2
    assert jobs[0][0] is fresh and jobs[0][2] is True
    np.testing.assert_array_equal(jobs[0][1], [4, 5])
    by = {id(j[0]): j for j in jobs}
    np.testing.assert_array_equal(by[id(established)][1], [1, 2, 3])
    run, backlog, deferred = _split_first_audio(jobs, set())
    assert [j[0] for j in backlog] == [established] and deferred == {id(established)}
    assert _split_first_audio(jobs, deferred) == (jobs, [], set())


# --------------------------------------------------------- the thread repairs


def test_unit_lookup_does_not_wait_for_another_keys_capture():
    """graphs.unit builds outside the global lock: while one key's build
    runs, a built key's lookup returns at once, and a second caller of the
    building key waits for that one build."""
    dev = torch.device("cuda")  # `unit` reads only the device type
    ready, release = threading.Event(), threading.Event()
    builds, got = [], {}

    def slow_build():
        builds.append(1)
        ready.set()
        release.wait(timeout=10)
        return "slow unit"

    keys = (("test", "slow"), ("test", "built"))
    try:
        graphs.unit(keys[1], dev, lambda: "built unit")
        slow = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, graphs.unit(keys[0], dev, slow_build))) for i in range(2)]
        slow[0].start()
        assert ready.wait(timeout=10)
        slow[1].start()
        t0 = time.perf_counter()
        assert graphs.unit(keys[1], dev, lambda: "never") == "built unit"
        assert time.perf_counter() - t0 < 0.5
        release.set()
        for t in slow:
            t.join(timeout=10)
        assert got == {0: "slow unit", 1: "slow unit"} and len(builds) == 1
    finally:
        release.set()
        for k in keys:
            graphs.SHARED.pop(k)


def test_detokenize_takes_device_global_ids_without_a_host_read(pipe, monkeypatch):
    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    g = torch.arange(n_glob, dtype=torch.int32)[None] % 4
    sem = np.arange(30) % pipe.tokenizer.n_semantic
    want = pipe.detokenize(g.numpy(), sem[None])
    want_b = pipe.detokenize_batch(np.concatenate([g.numpy()] * 2), [sem, sem[:20]])
    reads = []
    for name in ("numpy", "tolist", "__array__", "cpu", "item"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            if self.data_ptr() == g.data_ptr():
                reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    got = pipe.detokenize(g, sem[None])
    got_b = pipe.detokenize_batch(torch.cat([g, g]), [sem, sem[:20]])
    monkeypatch.undo()
    assert reads == []
    np.testing.assert_array_equal(got, want)
    for a, b in zip(got_b, want_b):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_tf32_flags_come_back_with_a_vocode_and_a_tokenize_open_at_once(pipe, monkeypatch,
                                                                       tf32_flags):
    """The vocode worker renders a window while the loop thread admits a
    clone (its audio tokenize): both codec calls are inside `full_fp32` at
    once, each sees full fp32, and the flags are the caller's after both."""
    from sparktts_tpu_torch.codec import bicodec

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    both, met = threading.Barrier(2, timeout=30), threading.Event()
    seen = []

    def meet(real):
        def inner(*a, **k):
            if not met.is_set():  # the first two calls meet; later ones pass
                both.wait()
                met.set()
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))
            return real(*a, **k)
        return inner

    monkeypatch.setattr(bicodec, "wave_generator_apply", meet(bicodec.wave_generator_apply))
    monkeypatch.setattr(bicodec, "fvq_tokenize", meet(bicodec.fvq_tokenize))
    server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=8, cache_len=256,
                                 fused_warm="sync", vocode_batch=False)
    job = _vocode_jobs(pipe, 10)[2]
    vocode = server._vocode_pool.submit(server._on_worker, server._vocode_stream,
                                        server._run_vocode_jobs, [job])
    server._admit(_pending(text="admitted", prompt_wav=_wav(510.0), max_new_tokens=8))
    res = vocode.result(timeout=30)
    server._vocode_pool.shutdown()
    server._fetch_pool.shutdown()
    assert res[0]["error"] is None and res[0]["wav"].size
    assert seen == [(False, False), (False, False)]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)


def test_launch_tally_counts_the_launches_of_its_own_thread():
    """A capture takes back the launches of its warm-up and capture from the
    wrappers' shared counts: `build.launch_tally` counts only what the thread
    that opened it launches (a server's other threads launch meanwhile), and
    nested tallies both count."""
    from sparktts_tpu_torch.kernels import build

    barrier = threading.Barrier(3, timeout=10)
    got = {}

    def worker(name, n):
        with build.launch_tally() as outer:
            with build.launch_tally() as inner:
                barrier.wait()
                for _ in range(n):
                    build.note_launch(name)
                barrier.wait()
        got[name] = (outer, inner)

    threads = [threading.Thread(target=worker, args=a)
               for a in (("dense_decode_attention", 3), ("fused_residual_unit", 5))]
    for t in threads:
        t.start()
    barrier.wait()
    build.note_launch("dense_decode_attention")  # this thread has no tally open
    barrier.wait()
    for t in threads:
        t.join(timeout=10)
    assert got == {"dense_decode_attention": ({"dense_decode_attention": 3},) * 2,
                   "fused_residual_unit": ({"fused_residual_unit": 5},) * 2}


def test_a_private_arrival_array_serves_its_own_threads_launches_alone():
    """A decode unit's warm-up and capture count their merges on an array of
    their own (`arrivals.private`), so a unit captured on a pooled stream
    that another unit was captured on, or warmed up while that one replays,
    shares no counters with it.  The array serves this thread only, is
    sized at the block's start and is restored on exit."""
    from sparktts_tpu_torch.kernels import arrivals

    cpu, seen = torch.device("cpu"), {}
    with arrivals.private(cpu, 64) as mine:
        assert arrivals.for_current_stream(cpu, 16) is mine and int(mine.abs().sum()) == 0
        other = threading.Thread(
            target=lambda: seen.setdefault("other", getattr(arrivals._private, "array", None)))
        other.start()
        other.join(timeout=10)
        with pytest.raises(RuntimeError):
            arrivals.for_current_stream(cpu, 65)
        with arrivals.private(cpu, 8) as inner:
            assert arrivals.for_current_stream(cpu, 8) is inner
        assert arrivals.for_current_stream(cpu, 16) is mine
    assert seen == {"other": None} and getattr(arrivals._private, "array", None) is None
