"""Benchmark harness: RTF + latency percentiles for offline and streaming
synthesis.

Port of `sparktts_tpu/bench/harness.py`, with its names, signatures and
returned keys, over the port's servers: the reference gRPC bench client's
metrics (reference `runtime/triton_trtllm/client_grpc.py:608-820`: per-task
latency list, RTF = total wall-clock / total synthesized audio seconds,
percentile breakdown, first-chunk latency for streaming) driving the
in-process server/pipeline, or the HTTP and gRPC fronts over a socket.
Every runner that takes a pipeline serves it on its device: the card by
default, and a pipeline built for a missing card raises before anything
starts.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from sparktts_tpu_torch.serve.server import _require_device


@dataclass
class BenchTask:
    text: str
    prompt_wav: Optional[np.ndarray] = None
    prompt_text: Optional[str] = None
    gender: Optional[str] = None
    pitch: str = "moderate"
    speed: str = "moderate"
    max_new_tokens: Optional[int] = None  # per-task target-length override


def make_tasks(n: int, max_new_choices, prompt_secs=(3, 6)) -> List[BenchTask]:
    """Synthetic manifest (a copy of `scripts/run_dataset_bench.py`'s
    `make_tasks`): seeded noise prompts in a few duration buckets and
    per-task generation budgets -- varied prompt and target lengths over a
    bounded set of shapes.  Texts stay short enough that every prompt lands
    in one prompt bucket: batch composition depends on timing, so another
    bucket would put first runs inside timed runs."""
    rng = np.random.default_rng(0)
    sr = 16000
    words = ("the quick brown fox jumps over the lazy dog and runs far away "
             "while birds sing in the tall green trees near the river").split()
    tasks = []
    for i in range(n):
        dur = prompt_secs[i % len(prompt_secs)]
        wav = (0.2 * rng.standard_normal(int(dur * sr))).astype(np.float32)
        n_words = 4 + (i * 3) % 8
        text = " ".join(words[(i * 3 + j) % len(words)] for j in range(n_words))
        tasks.append(BenchTask(text=text, prompt_wav=wav,
                               max_new_tokens=max_new_choices[i % len(max_new_choices)]))
    return tasks


def script_pipeline(tiny: bool, device, max_new_tokens: int, int8: bool = True,
                    model_dir=None):
    """The pipeline a bench script serves (`scripts/*_torch.py`): with `tiny`
    the random-init tiny config (fp32 LM, prompt bucket 32), else the
    checkpoint in `model_dir` or the full Spark-TTS-0.5B config on random
    weights (seed 0), its LM quantized to int8 unless `int8=False`.  On
    `device` (default: $SPARKTTS_PLATFORM, else the card; it raises without
    one)."""
    import torch

    from sparktts_tpu_torch.config import SparkTTSConfig, tiny_test_config
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.utils.platform import apply_platform_env

    device = device or apply_platform_env()
    if tiny:
        return SparkTTSPipeline(config=tiny_test_config(), device=device,
                                lm_dtype=torch.float32, max_new_tokens=max_new_tokens,
                                prompt_bucket=32)
    pipe = SparkTTSPipeline(model_dir=model_dir,
                            config=None if model_dir else SparkTTSConfig(), device=device,
                            max_new_tokens=max_new_tokens)
    if int8:
        from sparktts_tpu_torch.lm.quant import quantize_qwen_int8

        pipe.llm_params = quantize_qwen_int8(pipe.llm_params)
    return pipe


def load_manifest(path: str | Path) -> List[BenchTask]:
    """jsonl manifest: {"target_text": ..., "reference_wav_path": ...,
    "reference_text": ...} per line (same fields the reference's dataset
    loader consumes)."""
    from sparktts_tpu_torch.io.audio import load_audio

    tasks = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            item = json.loads(line)
            wav = None
            if item.get("reference_wav_path"):
                wav = load_audio(item["reference_wav_path"], sampling_rate=16000, volume_normalize=True)
            tasks.append(
                BenchTask(
                    text=item["target_text"],
                    prompt_wav=wav,
                    prompt_text=item.get("reference_text"),
                )
            )
    return tasks


def load_hf_dataset_tasks(
    name: str, split: str = "wenetspeech4tts", sample_rate: int = 16000
) -> List[BenchTask]:
    """Load a seed_tts-protocol huggingface dataset (reference
    `client_grpc.py:641-658`: fields prompt_audio / prompt_text /
    target_text) into bench tasks.  `name` is a dataset already on disk
    (`save_to_disk`); nothing is fetched.  Audio is resampled host-side to
    the pipeline rate.  Requires the `datasets` package."""
    if not Path(name).exists():
        raise FileNotFoundError(f"no dataset saved on disk at {name!r}")
    import datasets

    from sparktts_tpu_torch.io.audio import resample

    ds = datasets.load_from_disk(name)
    if isinstance(ds, datasets.DatasetDict):
        ds = ds[split] if split in ds else next(iter(ds.values()))

    tasks = []
    for item in ds:
        audio = item["prompt_audio"]
        wav = np.asarray(audio["array"], np.float64)
        sr = int(audio["sampling_rate"])
        if sr != sample_rate:
            wav = resample(wav, sr, sample_rate)
        tasks.append(
            BenchTask(
                text=item["target_text"],
                prompt_wav=wav.astype(np.float32),
                prompt_text=item.get("prompt_text"),
            )
        )
    return tasks


def _summarize(latencies: List[float], total_audio_s: float, total_wall_s: float, extra=None) -> Dict[str, Any]:
    lat = np.asarray(latencies)
    stats = {
        "num_tasks": len(latencies),
        "total_audio_s": round(total_audio_s, 3),
        "total_wall_s": round(total_wall_s, 3),
        "rtf": round(total_wall_s / total_audio_s, 5) if total_audio_s else None,
        "avg_latency_ms": round(float(lat.mean()) * 1000, 2),
        "p50_latency_ms": round(float(np.percentile(lat, 50)) * 1000, 2),
        "p90_latency_ms": round(float(np.percentile(lat, 90)) * 1000, 2),
        "p99_latency_ms": round(float(np.percentile(lat, 99)) * 1000, 2),
    }
    if extra:
        stats.update(extra)
    return stats


def run_offline_benchmark(
    pipeline, tasks: List[BenchTask], concurrency: int = 1, max_batch: int = 16
) -> Dict[str, Any]:
    """Offline mode through the batching server at a given concurrency
    (reference `client_grpc.py:517-607` semantics)."""
    _require_device(pipeline, "run_offline_benchmark")
    from sparktts_tpu_torch.serve.server import TTSRequest, TTSServer

    async def run():
        server = TTSServer(pipeline, max_batch=max_batch)
        await server.start()
        latencies: List[float] = []
        audio_s = 0.0
        sem = asyncio.Semaphore(concurrency)

        async def one(task: BenchTask, seed: int):
            nonlocal audio_s
            async with sem:
                t0 = time.perf_counter()
                res = await server.synthesize(
                    TTSRequest(
                        text=task.text,
                        prompt_wav=task.prompt_wav,
                        prompt_text=task.prompt_text,
                        gender=task.gender,
                        pitch=task.pitch if task.gender else None,
                        speed=task.speed if task.gender else None,
                        seed=seed,
                    )
                )
                latencies.append(time.perf_counter() - t0)
                audio_s += len(res.wav) / res.sample_rate

        t0 = time.perf_counter()
        await asyncio.gather(*(one(t, i) for i, t in enumerate(tasks)))
        wall = time.perf_counter() - t0
        await server.stop()
        return _summarize(
            latencies,
            audio_s,
            wall,
            {
                "mode": "offline",
                "concurrency": concurrency,
                "server_stats": server.stats_summary(),
                # per-stage queue-vs-compute breakdown (role of the reference
                # Triton stats dump, client_grpc.py:89-143)
                "stage_stats": _drain_global_stages(),
            },
        )

    from sparktts_tpu_torch.utils.profiling import GLOBAL_STATS

    GLOBAL_STATS.reset()
    return asyncio.new_event_loop().run_until_complete(run())


def _drain_global_stages() -> Dict[str, Any]:
    """Snapshot-and-reset the process-wide pipeline stage registry (tokenize /
    prefill / llm_generate / vocode timings recorded by `utils.profiling.stage`
    inside the pipeline)."""
    from sparktts_tpu_torch.utils.profiling import GLOBAL_STATS

    summary = GLOBAL_STATS.summary()
    GLOBAL_STATS.reset()
    return summary


def run_network_streaming_benchmark(
    host: str, port: int, tasks: List[BenchTask], concurrency: int = 1,
    max_new_tokens: Optional[int] = None,
) -> Dict[str, Any]:
    """Streaming through the HTTP /tts_stream endpoint: first-chunk latency is
    measured through the full network + serving stack (the reference measures
    the same through Triton's decoupled gRPC, `client_grpc.py:332-433`)."""
    from sparktts_tpu_torch.serve import client as C

    def stream_iter(task: BenchTask):
        return C.synthesize_stream(
            host,
            port,
            task.text,
            prompt_wav=task.prompt_wav,
            prompt_text=task.prompt_text,
            gender=task.gender,
            pitch=task.pitch if task.gender else None,
            speed=task.speed if task.gender else None,
            max_new_tokens=max_new_tokens,
        )

    return _streaming_sweep(
        stream_iter, tasks, concurrency,
        {"mode": "network_streaming", "concurrency": concurrency},
    )


def _streaming_sweep(
    stream_iter, tasks: List[BenchTask], concurrency: int, extra: Dict[str, Any]
) -> Dict[str, Any]:
    """Timed worker-pool sweep over a chunk-stream factory: per-task
    first-chunk latency + total latency + audio accounting, one summary.
    Shared by the HTTP and gRPC streaming benches so their metric
    definitions cannot drift."""
    import threading

    latencies: List[float] = []
    first_chunk: List[float] = []
    lock = threading.Lock()
    totals = {"audio_s": 0.0}

    def one(task: BenchTask):
        t0 = time.perf_counter()
        got_first = False
        local_audio = 0.0
        for chunk, sr in stream_iter(task):
            if not got_first:
                first_chunk.append(time.perf_counter() - t0)
                got_first = True
            local_audio += len(chunk) / sr
        with lock:
            totals["audio_s"] += local_audio
            latencies.append(time.perf_counter() - t0)

    wall = _threaded_sweep(tasks, concurrency, one)
    fc = np.asarray(first_chunk) if first_chunk else np.asarray([0.0])
    return _summarize(
        latencies,
        totals["audio_s"],
        wall,
        {
            **extra,
            "first_chunk_p50_ms": round(float(np.percentile(fc, 50)) * 1000, 2),
            "first_chunk_p90_ms": round(float(np.percentile(fc, 90)) * 1000, 2),
        },
    )


def _threaded_sweep(tasks: List[BenchTask], concurrency: int, one) -> float:
    """Run `one(task)` over every task with a fixed worker-pool concurrency
    (the reference bench's task semantics, `client_grpc.py:666-700`); returns
    wall-clock seconds."""
    import threading

    t_start = time.perf_counter()
    idx = {"next": 0}
    idx_lock = threading.Lock()

    def worker():
        while True:
            with idx_lock:
                i = idx["next"]
                if i >= len(tasks):
                    return
                idx["next"] = i + 1
            one(tasks[i])

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t_start


def run_grpc_streaming_benchmark(
    pipeline, tasks: List[BenchTask], concurrency: int = 1,
    max_new_tokens: Optional[int] = None, transport: str = "auto",
    warm: bool = True, **server_kwargs,
) -> Dict[str, Any]:
    """Streaming through the gRPC front-end (`serve/grpc_server.py`) — the
    direct analogue of the reference's decoupled Triton gRPC benchmark
    (`client_grpc.py:332-433`): per-task first-chunk latency and RTF through
    a real socket.  transport="grpcio" uses a grpc.server channel,
    "framed" the dependency-free gRPC-framing TCP transport, "auto" prefers
    grpcio and falls back when it is absent.  warm=True streams each distinct
    task shape once before timing (steady state, same policy as
    run_continuous_benchmark's fused_warm="sync")."""
    _require_device(pipeline, "run_grpc_streaming_benchmark")
    from sparktts_tpu_torch.serve import grpc_server as G

    if transport == "auto":
        try:
            import grpc  # noqa: F401

            transport = "grpcio"
        except ImportError:
            transport = "framed"

    # steady-state measurement: admission warm-ups and unit captures land
    # in the warm pass, and any remaining first-seen signature warms inline
    # (sync), never racing a background thread against the timed region
    server_kwargs.setdefault("fused_warm", "sync")

    if transport == "grpcio":
        server, backend = G.serve_grpc(
            pipeline, host="127.0.0.1", port=0, **server_kwargs
        )
        host, port = "127.0.0.1", server.bound_port
        stream_fn = G.grpc_synthesize_stream
        cserver = backend.server
        close = lambda: (  # noqa: E731
            server.stop(0), backend.close(), G.close_cached_channels(),
        )
    else:
        srv = G.FramedSocketServer(pipeline, **server_kwargs)
        host, port = srv.host, srv.port
        stream_fn = G.framed_synthesize_stream
        cserver = srv.backend.server if hasattr(srv, "backend") else None
        close = srv.close

    def stream_iter(task: BenchTask):
        return stream_fn(
            host,
            port,
            task.text,
            prompt_wav=task.prompt_wav,
            prompt_text=task.prompt_text,
            gender=task.gender,
            pitch=task.pitch if task.gender else None,
            speed=task.speed if task.gender else None,
            max_new_tokens=max_new_tokens or task.max_new_tokens,
        )

    try:
        if warm:
            for task in _distinct_shape_tasks(pipeline, tasks):
                for _ in stream_iter(task):
                    pass
            if cserver is not None:
                cserver.stage_stats.reset()  # drop warm-pass samples
        stats = _streaming_sweep(
            stream_iter, tasks, concurrency,
            {
                "mode": "grpc_streaming",
                "transport": transport,
                "concurrency": concurrency,
            },
        )
        if cserver is not None:
            # per-stage attribution incl. the grpc bridge stages
            # (grpc_bridge_in / grpc_first_chunk_bridge) so a first-chunk
            # delta vs the in-process rows is attributable from the artifact
            stats["stage_stats"] = cserver.stage_stats.summary()
        return stats
    finally:
        close()


def _distinct_shape_tasks(pipeline, tasks: List[BenchTask]) -> List[BenchTask]:
    """One representative task per shape signature (wav pad bucket ×
    prompt bucket × budget: the shapes the admissions and decode units are
    keyed on) — the minimal warm set."""
    from sparktts_tpu_torch.prompt import clone_prompt_scaffold

    seen, out = set(), []
    n_glob = pipeline.config.bicodec.speaker_encoder.token_num
    for t in tasks:
        if t.prompt_wav is None:
            key = ("control", t.max_new_tokens)
        else:
            wav_pad = -(-max(len(t.prompt_wav), pipeline.wav_bucket) // pipeline.wav_bucket)
            _, plen, _, _ = clone_prompt_scaffold(
                pipeline.tokenizer, t.text, n_glob, 0, t.prompt_text
            )
            t_pad = -(-plen // pipeline.prompt_bucket) * pipeline.prompt_bucket
            # transcript clones add wav-dependent semantic ids to the prompt;
            # the wav bucket is in the key, so each (bucket, transcript)
            # combination still warms once — sync fused_warm backstops any
            # residual miss
            key = (wav_pad, t_pad, bool(t.prompt_text), t.max_new_tokens)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def run_continuous_benchmark(
    pipeline,
    tasks: List[BenchTask],
    concurrency: int = 1,
    streaming: bool = False,
    max_slots: int = 8,
    steps_per_dispatch: int = 512,
    max_new_tokens: Optional[int] = None,
    fused_admission: bool = True,
    vocode_batch: bool = True,
    paged: bool = False,
) -> Dict[str, Any]:
    """Dataset benchmark through the continuous (inflight) batching server —
    the closest analogue of the reference's Triton+TRT-LLM serving stack
    (reference `client_grpc.py:517-607` offline / `:332-433` streaming task
    semantics).  `concurrency` bounds how many requests are in flight at
    once; with streaming=True, per-task first-chunk latency is recorded.
    steps_per_dispatch caps the server's adaptive dispatch sizing."""
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    _require_device(pipeline, "run_continuous_benchmark")

    async def run():
        server = ContinuousTTSServer(
            pipeline, max_slots=max_slots, steps_per_dispatch=steps_per_dispatch,
            default_max_new_tokens=max_new_tokens, fused_admission=fused_admission,
            # bench measures steady state: warm inline during the warm pass
            # rather than racing a background warm against the run
            fused_warm="sync", vocode_batch=vocode_batch, paged=paged,
        )
        await server.start()
        latencies: List[float] = []
        first_chunk: List[float] = []
        per_task: List[Dict[str, Any]] = []
        totals = {"audio_s": 0.0}
        sem = asyncio.Semaphore(concurrency)

        async def one(task: BenchTask, seed: int):
            async with sem:
                t0 = time.perf_counter()
                rec: Dict[str, Any] = {"task": seed}
                if streaming:
                    got_first = False
                    async for chunk in server.synthesize_streaming(
                        task.text,
                        prompt_wav=task.prompt_wav,
                        prompt_text=task.prompt_text,
                        gender=task.gender,
                        pitch=task.pitch if task.gender else None,
                        speed=task.speed if task.gender else None,
                        max_new_tokens=task.max_new_tokens or max_new_tokens,
                    ):
                        if not got_first:
                            dt = time.perf_counter() - t0
                            first_chunk.append(dt)
                            rec["first_chunk_ms"] = round(dt * 1000, 1)
                            got_first = True
                        totals["audio_s"] += len(chunk) / pipeline.sample_rate
                else:
                    wav = await server.synthesize(
                        task.text,
                        prompt_wav=task.prompt_wav,
                        prompt_text=task.prompt_text,
                        gender=task.gender,
                        pitch=task.pitch if task.gender else None,
                        speed=task.speed if task.gender else None,
                        max_new_tokens=task.max_new_tokens or max_new_tokens,
                    )
                    totals["audio_s"] += len(wav) / pipeline.sample_rate
                dt = time.perf_counter() - t0
                latencies.append(dt)
                rec["latency_ms"] = round(dt * 1000, 1)
                per_task.append(rec)

        t0 = time.perf_counter()
        await asyncio.gather(*(one(t, i) for i, t in enumerate(tasks)))
        wall = time.perf_counter() - t0
        await server.stop()
        extra: Dict[str, Any] = {
            "mode": "continuous_streaming" if streaming else "continuous_offline",
            "concurrency": concurrency,
            "server_stats": dict(server.stats),
            # queue_wait / admit_prefill / decode_dispatch / vocode breakdown
            # (role of the reference Triton stats dump, client_grpc.py:89-143)
            "stage_stats": server.stage_stats.summary(),
            # per-request attribution (VERDICT r03 item 2: which request ate
            # the tail, and in which stage)
            "per_task": per_task,
        }
        if streaming and first_chunk:
            fc = np.asarray(first_chunk)
            extra["first_chunk_p50_ms"] = round(float(np.percentile(fc, 50)) * 1000, 2)
            extra["first_chunk_p90_ms"] = round(float(np.percentile(fc, 90)) * 1000, 2)
            extra["first_chunk_avg_ms"] = round(float(fc.mean()) * 1000, 2)
        return _summarize(latencies, totals["audio_s"], wall, extra)

    return asyncio.new_event_loop().run_until_complete(run())


def run_longform_benchmark(
    pipeline,
    tasks: List[BenchTask],
    n_requests: int = 2,
    segments: int = 3,
    max_slots: int = 8,
    segment_max_new_tokens: Optional[int] = None,
    concurrency: int = 1,
) -> Dict[str, Any]:
    """Longform streaming through the continuous server: each request's text
    is `segments` sentence-segments long (~segments× the per-request token
    budget), exercising `synthesize_streaming_long`'s voice-stable
    segment chaining (globals-only re-admission, segment-overlapped
    decode).  No reference equivalent — it truncates at the token budget
    (`cli/SparkTTS.py:199`); recorded so the longform machinery has a
    measured number (VERDICT r03 item 7 / r04 item 5)."""
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    _require_device(pipeline, "run_longform_benchmark")

    async def run():
        server = ContinuousTTSServer(
            pipeline, max_slots=max_slots, fused_warm="sync",
            default_max_new_tokens=segment_max_new_tokens,
        )
        await server.start()
        latencies: List[float] = []
        first_chunk: List[float] = []
        totals = {"audio_s": 0.0}
        sem = asyncio.Semaphore(max(concurrency, 1))

        async def one(i: int):
            task = tasks[i % len(tasks)]
            # one sentence per segment: pack_segments splits on sentence
            # boundaries, so joining with '. ' yields `segments` segments
            text = ". ".join([task.text] * segments) + "."
            async with sem:
                t0 = time.perf_counter()
                got_first = False
                async for chunk in server.synthesize_streaming_long(
                    text,
                    prompt_wav=task.prompt_wav,
                    prompt_text=task.prompt_text,
                    max_new_tokens=task.max_new_tokens or segment_max_new_tokens,
                    max_segment_chars=len(task.text) + 2,
                ):
                    if not got_first:
                        first_chunk.append(time.perf_counter() - t0)
                        got_first = True
                    totals["audio_s"] += len(chunk) / pipeline.sample_rate
                latencies.append(time.perf_counter() - t0)

        t_start = time.perf_counter()
        await asyncio.gather(*(one(i) for i in range(n_requests)))
        wall = time.perf_counter() - t_start
        audio_s = totals["audio_s"]
        stats = dict(server.stats)
        await server.stop()
        extra = {
            "mode": "continuous_streaming_longform",
            "segments_per_request": segments,
            "concurrency": concurrency,
            "server_stats": stats,
        }
        if first_chunk:  # a zero-chunk request must not lose the whole run
            fc = np.asarray(first_chunk)
            extra["first_chunk_p50_ms"] = round(float(np.percentile(fc, 50)) * 1000, 2)
            extra["first_chunk_avg_ms"] = round(float(fc.mean()) * 1000, 2)
        return _summarize(latencies, audio_s, wall, extra)

    return asyncio.new_event_loop().run_until_complete(run())


def run_streaming_benchmark(pipeline, tasks: List[BenchTask], streaming_cfg=None) -> Dict[str, Any]:
    """Streaming mode: measures first-chunk latency per task (reference
    `client_grpc.py:332-433`)."""
    from sparktts_tpu_torch.serve.streaming import StreamingSynthesizer

    _require_device(pipeline, "run_streaming_benchmark")
    syn = StreamingSynthesizer(pipeline, streaming_cfg)
    latencies, first_chunk = [], []
    audio_s = 0.0
    t_start = time.perf_counter()
    for i, task in enumerate(tasks):
        t0 = time.perf_counter()
        got_first = False
        for chunk in syn.stream(
            task.text,
            prompt_speech_path=task.prompt_wav,  # array accepted by tokenize_audio
            prompt_text=task.prompt_text,
            gender=task.gender,
            pitch=task.pitch if task.gender else None,
            speed=task.speed if task.gender else None,
            seed=i,
        ):
            if not got_first:
                first_chunk.append(time.perf_counter() - t0)
                got_first = True
            audio_s += len(chunk) / pipeline.sample_rate
        latencies.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_start
    fc = np.asarray(first_chunk) if first_chunk else np.asarray([0.0])
    return _summarize(
        latencies,
        audio_s,
        wall,
        {
            "mode": "streaming",
            "first_chunk_p50_ms": round(float(np.percentile(fc, 50)) * 1000, 2),
            "first_chunk_p90_ms": round(float(np.percentile(fc, 90)) * 1000, 2),
        },
    )
