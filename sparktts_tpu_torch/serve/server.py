"""Asyncio serving layer: dynamic batching + streaming, and the HTTP front
door (the Triton replacement).

Port of `sparktts_tpu/serve/server.py`.  The reference serves through Triton
Inference Server (C++) with dynamic batching (max batch 16) and decoupled
streaming transactions plus a BLS orchestrator (reference
`runtime/triton_trtllm/model_repo/spark_tts/1/model.py`, `run.sh:46-72`).
Here the same roles map to:

  * request queue + batching window  → asyncio queue, batches compatible
    requests into ONE batched generate (`generate_tokens_batch`, one decode
    unit replayed for the batch)
  * decoupled streaming              → `ContinuousTTSServer` streams
  * gRPC/HTTP endpoints              → stdlib ThreadingHTTPServer JSON API
    (`serve_http`), zero extra deps; the gRPC front (`serve/grpc_server.py`)
    is imported only when a gRPC port is asked for

Batching waits up to `batch_window_ms` to fill a batch of `max_batch`
requests, mirroring Triton's scheduling knobs.

Where the port differs: a batch runs on an executor thread, which enters
`torch.inference_mode()` itself (the mode is per thread); the fused clone
path's rows are picked with device index tensors; "warm" (`warmup_servers`)
means run once: decode units captured, cuDNN's and cuBLAS's first choices
of algorithm made, kernels built.  Every entry point runs on the
pipeline's device and raises on a pipeline that names a card when there is
none: nothing falls back to the CPU.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

# /v1/audio/speech inputs longer than this auto-route through longform
# synthesis (sentence-segmented, voice-stable) instead of being truncated at
# the generation budget.  OpenAI itself caps input at 4096 chars; this server
# accepts any length.
OPENAI_LONGFORM_AUTO_CHARS = 600


def _require_device(pipeline, who: str) -> None:
    if pipeline.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; build the pipeline with device='cpu' to "
            "serve from the CPU"
        )


@dataclass
class TTSRequest:
    text: str
    prompt_wav: Optional[np.ndarray] = None       # pre-loaded audio
    prompt_speech_path: Optional[str] = None
    prompt_text: Optional[str] = None
    gender: Optional[str] = None
    pitch: Optional[str] = None
    speed: Optional[str] = None
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    seed: int = 0
    future: Optional[asyncio.Future] = None
    enqueue_time: float = field(default_factory=time.perf_counter)


@dataclass
class TTSResult:
    wav: np.ndarray
    sample_rate: int
    queue_ms: float
    infer_ms: float


class TTSServer:
    """Batching TTS server over a SparkTTSPipeline."""

    def __init__(
        self,
        pipeline,
        max_batch: int = 16,
        batch_window_ms: float = 10.0,
        request_timeout_s: Optional[float] = None,
        fused_clone: bool = True,
    ):
        _require_device(pipeline, "TTSServer")
        self.pipe = pipeline
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        self.request_timeout_s = request_timeout_s
        # fused clone path: tokenize → device prompt assembly → generate →
        # on-device semantic extraction → vocode, ONE host fetch per sampling
        # group instead of three per window.  Guided clone only;
        # controllable-mode requests keep the host path (their globals
        # arrive in the stream).  Off with the codec on a card of its own
        # (`codec_device`), as in the JAX server.
        self.fused_clone = fused_clone and pipeline.guided and pipeline.codec_device is None
        self.queue: asyncio.Queue = asyncio.Queue()
        self._worker_task: Optional[asyncio.Task] = None
        self.stats = {"requests": 0, "batches": 0, "batch_occupancy_sum": 0, "failures": 0}

    async def start(self):
        if self._worker_task is None:
            self._worker_task = asyncio.create_task(self._worker())

    async def stop(self):
        if self._worker_task is not None:
            self._worker_task.cancel()
            try:
                await self._worker_task
            except asyncio.CancelledError:
                pass
            self._worker_task = None

    async def synthesize(self, req: TTSRequest) -> TTSResult:
        req.future = asyncio.get_running_loop().create_future()
        await self.queue.put(req)
        if self.request_timeout_s is not None:
            try:
                return await asyncio.wait_for(req.future, self.request_timeout_s)
            except asyncio.TimeoutError:
                self.stats["failures"] += 1
                raise
        return await req.future

    @property
    def healthy(self) -> bool:
        """Liveness: worker task exists and hasn't crashed."""
        return self._worker_task is not None and not self._worker_task.done()

    async def _worker(self):
        while True:
            batch: List[TTSRequest] = [await self.queue.get()]
            deadline = time.perf_counter() + self.batch_window
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self.queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            try:
                results = await asyncio.get_running_loop().run_in_executor(
                    None, self._execute_batch, batch
                )
                for req, res in zip(batch, results):
                    if req.future.done():
                        continue
                    if isinstance(res, Exception):
                        # per-request failure (bad audio, bad params) — only
                        # the offending request errors, co-batched neighbors
                        # still get their audio
                        self.stats["failures"] += 1
                        req.future.set_exception(res)
                    else:
                        req.future.set_result(res)
            except Exception as e:  # infrastructure failure: everyone errors
                logger.exception("batch failed")
                self.stats["failures"] += len(batch)
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _execute_batch(self, batch: List[TTSRequest]) -> List[Any]:
        """Returns one TTSResult OR Exception per request.  Per-request input
        problems (unreadable audio, bad params) fail only that request; an
        exception raised out of this method is an infrastructure failure that
        the worker applies to the whole batch."""
        from sparktts_tpu_torch.prompt import (
            build_clone_prompt,
            build_control_prompt,
            clone_prompt_scaffold,
            extract_semantic_ids,
            padded_global_tokens,
        )

        t0 = time.perf_counter()
        pipe = self.pipe
        tok = pipe.tokenizer
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["batch_occupancy_sum"] += len(batch)
        outcomes: List[Any] = [None] * len(batch)

        # load + batch all clone-mode prompt audios through ONE tokenize;
        # a request whose audio can't be loaded fails alone
        clone_tokens: Dict[int, tuple] = {}
        clone_idx, wavs = [], []
        for i, r in enumerate(batch):
            if r.gender is not None:
                continue
            try:
                if r.prompt_wav is not None:
                    wav = np.asarray(r.prompt_wav, np.float64)
                else:
                    from sparktts_tpu_torch.io.audio import load_audio

                    wav = load_audio(
                        r.prompt_speech_path,
                        sampling_rate=pipe.sample_rate,
                        volume_normalize=pipe.config.volume_normalize,
                    )
                if wav.size == 0:
                    raise ValueError("empty prompt audio")
                clone_idx.append(i)
                wavs.append(wav)
            except Exception as e:
                logger.warning("request prompt-audio failed: %s", e)
                outcomes[i] = e

        # fused clone path: codec tokens never touch the host — device prompt
        # assembly feeds generate_and_vocode_batch (one fetch per group)
        fused_rows: Dict[int, int] = {}   # batch index → assembled row
        fused_ids = fused_globals = fused_mask = None
        if clone_idx and self.fused_clone:
            g_dev, s_dev, sem_counts = pipe.tokenize_audio_batch_device(wavs)
            scaffs = []
            for j, i in enumerate(clone_idx):
                req = batch[i]
                try:
                    use_sem = sem_counts[j] if req.prompt_text is not None else 0
                    scaffs.append(
                        (i, j, use_sem)
                        + clone_prompt_scaffold(
                            tok, req.text, g_dev.shape[1], use_sem, req.prompt_text
                        )
                    )
                except Exception as e:
                    logger.warning("request prompt build failed: %s", e)
                    outcomes[i] = e
            if scaffs:
                t_pad = max(p for (_, _, _, _, p, _, _) in scaffs)
                t_pad = -(-t_pad // pipe.prompt_bucket) * pipe.prompt_bucket
                nb = len(scaffs)
                rows = np.full((nb, t_pad), tok.pad_id, np.int32)
                mask = np.zeros((nb, t_pad), bool)
                g_offs = np.zeros(nb, np.int64)
                s_offs = np.zeros(nb, np.int64)
                n_sems = np.zeros(nb, np.int64)
                sel = np.zeros(nb, np.int64)
                for r, (i, j, use_sem, scaffold, plen, g_off, s_off) in enumerate(scaffs):
                    shift = t_pad - plen  # LEFT-padded, like generate_tokens_batch
                    rows[r, shift:] = scaffold
                    mask[r, shift:] = True
                    g_offs[r], s_offs[r], n_sems[r] = g_off + shift, s_off + shift, use_sem
                    sel[r] = j
                    fused_rows[i] = r
                sel_dev = torch.from_numpy(sel).to(pipe.device)
                fused_globals = g_dev[sel_dev]
                fused_ids = pipe.assemble_clone_ids_batch(
                    rows, fused_globals, s_dev[sel_dev], g_offs, s_offs, n_sems
                )
                fused_mask = torch.from_numpy(mask).to(pipe.device)
        elif clone_idx:
            for i, gs in zip(clone_idx, pipe.tokenize_audio_batch(wavs)):
                clone_tokens[i] = gs

        prompts: Dict[int, List[int]] = {}
        globals_list: Dict[int, Optional[np.ndarray]] = {}
        for i, req in enumerate(batch):
            if outcomes[i] is not None or i in fused_rows:
                continue
            try:
                if req.gender is not None:
                    prompts[i] = build_control_prompt(
                        tok, req.text, req.gender, req.pitch, req.speed
                    )
                    globals_list[i] = None
                else:
                    g, s = clone_tokens[i]
                    prompts[i] = build_clone_prompt(
                        tok,
                        req.text,
                        g,
                        s if req.prompt_text is not None else None,
                        req.prompt_text,
                    )
                    globals_list[i] = g
            except Exception as e:
                logger.warning("request prompt build failed: %s", e)
                outcomes[i] = e

        # one batched generate per group of identical sampling params
        # (requests in a window may carry different temperature/top_k/top_p).
        # The guided-decoding constraint differs by task — controllable
        # requests must be able to emit global/control tokens — so mode is
        # part of the group key.
        generated: Dict[int, np.ndarray] = {}
        groups: Dict[tuple, List[int]] = {}
        for i in list(prompts) + list(fused_rows):
            req = batch[i]
            mode = "control" if req.gender is not None else "clone"
            # seed is NOT part of the key: generation takes one generator a
            # row, so requests with distinct seeds share one batch instead
            # of serializing b=1 calls within the window
            groups.setdefault(
                (req.temperature, req.top_k, req.top_p, mode), []
            ).append(i)
        for (temperature, top_k, top_p, mode), idxs in groups.items():
            fused_in_group = [i for i in idxs if i in fused_rows]
            if fused_in_group:
                rsel = torch.tensor([fused_rows[i] for i in fused_in_group],
                                    dtype=torch.int64, device=pipe.device)
                wavs_out, _ = pipe.generate_and_vocode_batch(
                    fused_ids[rsel],
                    fused_mask[rsel],
                    fused_globals[rsel],
                    temperature=temperature,
                    top_k=top_k,
                    top_p=top_p,
                    seed=[batch[i].seed for i in fused_in_group],
                )
                infer_ms = (time.perf_counter() - t0) * 1000
                for i, wav in zip(fused_in_group, wavs_out):
                    outcomes[i] = TTSResult(
                        wav=wav,
                        sample_rate=pipe.sample_rate,
                        queue_ms=(t0 - batch[i].enqueue_time) * 1000,
                        infer_ms=infer_ms,
                    )
                idxs = [i for i in idxs if i not in fused_rows]
                if not idxs:
                    continue
            outs = pipe.generate_tokens_batch(
                [prompts[i] for i in idxs],
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                seed=[batch[i].seed for i in idxs],
                mode=mode,
            )
            for i, out in zip(idxs, outs):
                generated[i] = out

        token_num = pipe.config.bicodec.speaker_encoder.token_num
        live = sorted(generated)
        if live:
            sem_list, glob_rows = [], []
            for i in live:
                sem = extract_semantic_ids(tok, generated[i])
                if sem.size == 0:
                    sem = np.zeros(1, np.int32)
                sem_list.append(sem)
                g = globals_list[i]
                if g is None:
                    g = padded_global_tokens(tok, generated[i], token_num)
                glob_rows.append(np.asarray(g).reshape(-1)[:token_num])

            wavs_out = pipe.detokenize_batch(np.stack(glob_rows), sem_list)
            infer_ms = (time.perf_counter() - t0) * 1000
            for i, wav in zip(live, wavs_out):
                outcomes[i] = TTSResult(
                    wav=wav,
                    sample_rate=pipe.sample_rate,
                    queue_ms=(t0 - batch[i].enqueue_time) * 1000,
                    infer_ms=infer_ms,
                )
        return outcomes

    def stats_summary(self) -> Dict[str, Any]:
        s = dict(self.stats)
        if s["batches"]:
            s["avg_batch_occupancy"] = s["batch_occupancy_sum"] / s["batches"]
        return s


# ---------------------------------------------------------------------------
# stdlib HTTP front-end (role of reference client_http.py's server side)
# ---------------------------------------------------------------------------


def warmup_servers(
    pipeline,
    server,
    cserver,
    loop,
    timeout: float = 900.0,
    wav_seconds: tuple = (1.0, 3.0, 6.0),
):
    """Warm the hot serving paths for REPRESENTATIVE shapes BEFORE the HTTP
    socket opens (role of the reference deploy pipeline's engine prebuild,
    reference `run.sh` stages 1-2): offline clone + controllable batches
    through the window server, the continuous engine's full decode dispatch
    ladder, and streaming clones through the chained, fused and voice-cache
    admissions — per prompt-wav duration bucket in `wav_seconds`.  On the
    card "warm" is a first run: the decode units are captured, cuDNN and
    cuBLAS make their first choices of algorithm, the kernels are built.  A
    production request outside these buckets (longer wav, longer text)
    still pays that on first use; extend wav_seconds to the deployment's
    expected durations to pre-pay those too.  Stats counters are reset
    afterwards so production metrics start clean."""
    sr = pipeline.sample_rate
    text = "warmup utterance"

    def mk_wav(seconds):
        tgrid = np.arange(int(sr * seconds)) / sr
        return (0.2 * np.sin(2 * np.pi * 220.0 * tgrid)).astype(np.float32)

    # distinct wav-pad buckets only: durations that round to the same bucket
    # run the same shapes
    wavs, seen = [], set()
    for s in wav_seconds:
        w = mk_wav(s)
        bucket = -(-max(len(w), pipeline.wav_bucket) // pipeline.wav_bucket)
        if bucket not in seen:
            seen.add(bucket)
            wavs.append(w)

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    t0 = time.perf_counter()
    for i, wav in enumerate(wavs):
        logger.info("warmup: offline clone batch (wav bucket %d/%d)", i + 1, len(wavs))
        run(server.synthesize(TTSRequest(text=text, prompt_wav=wav)))
    logger.info("warmup: offline controllable batch")
    run(
        server.synthesize(
            TTSRequest(text=text, gender="female", pitch="moderate", speed="moderate")
        )
    )
    if cserver is not None:
        # every dispatch-ladder rung the adaptive scheduler can pick (a cold
        # rung would pay its first run inside a live stream's chunk cadence)
        from sparktts_tpu_torch.lm.continuous import DISPATCH_LADDER

        eng = cserver.engine
        rungs = [n for n in DISPATCH_LADDER if n <= cserver.steps]
        if cserver.steps not in rungs:
            rungs.append(cserver.steps)

        async def walk_ladder():
            for n in rungs:
                if all(o is None for o in eng.owner):
                    eng.submit(
                        list(range(10, 10 + pipeline.prompt_bucket // 2)),
                        max_new_tokens=cserver.default_max_new,
                        mode="clone",
                    )
                eng.step(n)
            for slot, owner in enumerate(eng.owner):
                if owner is not None:
                    eng.release_slot(slot)

        logger.info("warmup: decode dispatch ladder %s", rungs)
        run(walk_ladder())

        async def stream_once(wav):
            async for _chunk in cserver.synthesize_streaming(text, prompt_wav=wav):
                pass

        for i, wav in enumerate(wavs):
            logger.info(
                "warmup: streaming clone, chained admission (wav bucket %d/%d)",
                i + 1, len(wavs),
            )
            run(stream_once(wav))
        # chained admissions above started background warm-ups of the fused
        # admission; wait for them, then admit each signature once fused.
        # The JAX server checks its engine's compiled fused executables
        # (`_fused_exe`); the port's dense engine keeps the signatures that
        # have run once in `_admit_ready` (the paged engine has none)
        deadline = time.perf_counter() + timeout
        while cserver._fused_warming and time.perf_counter() < deadline:
            time.sleep(0.5)
        if getattr(cserver.engine, "_admit_ready", None):
            for i, wav in enumerate(wavs):
                logger.info(
                    "warmup: streaming clone, fused admission (wav bucket %d/%d)",
                    i + 1, len(wavs),
                )
                run(stream_once(wav))
        if pipeline.voice_cache_size > 0 and hasattr(
            cserver.engine, "submit_assembled"
        ):
            # the passes above populated the voice cache, so repeats take the
            # cache-hit (assembled) admission: one pass starts its background
            # warm-ups, then each signature is admitted once warm
            for wav in wavs:
                run(stream_once(wav))
            while cserver._fused_warming and time.perf_counter() < deadline:
                time.sleep(0.5)
            for i, wav in enumerate(wavs):
                logger.info(
                    "warmup: streaming clone, voice-cache admission (wav bucket %d/%d)",
                    i + 1, len(wavs),
                )
                run(stream_once(wav))
        if cserver.spec_first_chunk:
            # the speculative first-chunk vocodes behind a dispatch: a cold
            # signature would leave a live stream's first chunk to the vocode
            # worker while it warms in the background (JAX compiles these
            # with the dispatch programs; the port runs each once here)
            from sparktts_tpu_torch.serve.continuous_server import warm_spec_chains

            n_spec = warm_spec_chains(cserver, len(cserver.engine.owner))
            logger.info("warmup: %d speculative first-chunk chains", n_spec)
        if getattr(cserver, "vocode_batch", False):
            # the streaming passes above recorded the window lengths their
            # vocode drains routed; run the cross-stream batched vocodes of
            # those shapes now, instead of warming them against live traffic
            from sparktts_tpu_torch.serve.continuous_server import (
                warm_vocode_batches_seen,
            )

            n_voc = warm_vocode_batches_seen(pipeline, len(cserver.engine.owner))
            logger.info("warmup: %d batched-vocode signatures", n_voc)
        # the vocode window cap closes the scalar streaming detokenize shape
        # set — run all of it now so no sampled generation length lands a
        # first vocode of a shape inside a live drain
        from sparktts_tpu_torch.serve.continuous_server import warm_stream_windows

        n_win = warm_stream_windows(
            pipeline, cserver.max_vocode_window + cserver.stream_ctx
        )
        logger.info("warmup: %d scalar stream-window signatures", n_win)
        for k in cserver.stats:
            cserver.stats[k] = 0
        cserver.stage_stats = type(cserver.stage_stats)()
    for k in server.stats:
        server.stats[k] = 0
    logger.info("warmup done in %.1f s", time.perf_counter() - t0)


def serve_http(
    pipeline,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_batch: int = 16,
    streaming: bool = True,
    stream_max_slots: int = 2,
    stream_steps_per_dispatch: int = 512,
    paged_kv: bool = False,
    warmup: bool = False,
    grpc_port: Optional[int] = None,
    control: Optional[dict] = None,
    voices: Optional["VoiceRegistry"] = None,
):
    """Blocking HTTP JSON server.

    Endpoints (role of the reference's Triton gRPC/HTTP front, reference
    `client_http.py`, `model_repo/spark_tts/1/model.py:347-399`):

      * POST /tts        — offline: {"text", "prompt_wav_b64": <b64 f32 pcm>,
                           ...} → {"wav_b64", "sample_rate", ...}
      * POST /tts_stream — decoupled streaming over chunked transfer encoding:
                           NDJSON lines {"wav_b64", "sample_rate"} as each
                           audio chunk is ready, terminated by {"done": true}.
                           Backed by the continuous-batching engine so
                           concurrent streams share the decode batch.
      * POST /v1/audio/speech — OpenAI-compatible speech endpoint
                           ({"input", "voice", "response_format": wav|pcm,
                           "speed", "stream"}): returns audio BYTES
                           (audio/wav or audio/pcm); "stream": true streams
                           chunked audio through the continuous engine.
                           Voices: built-in "female"/"male" (creation mode)
                           or any name registered via the voice registry.
      * POST/GET /v1/voices, DELETE /v1/voices/<name> — register / list /
                           remove named clone voices (prompt wav uploaded
                           once, then synthesized by name; pairs with the
                           pipeline voice cache for one-dispatch admission).
      * POST /v2/models/<name>/infer — the Triton v2 (KServe) JSON protocol
                           of the reference's own HTTP client.
      * GET /, /stats, /health, /v1/models, /v2/health/{ready,live}

    `control`, when given, is filled with a `"stop"` callable (graceful
    shutdown: HTTP socket, gRPC front, serving loops and their decode units,
    event loop) and the bound servers — for embedding/tests; production
    deployments just let the process own the socket.  `port=0` binds a free
    port: read it back from `control["httpd"].server_address`.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from sparktts_tpu_torch.serve.voices import (
        BUILTIN_VOICES,
        WAV_STREAM_SIZE,
        VoiceRegistry,
        openai_speed_level,
        pcm16_bytes,
        wav_bytes,
        wav_header,
    )

    voice_registry = voices if voices is not None else VoiceRegistry()

    if grpc_port is not None and not streaming:
        # the gRPC front shares the continuous streaming engine; accepting
        # the flag and silently not listening would strand clients with a
        # connection-refused and no server-side hint
        raise ValueError("grpc_port requires streaming=True (the gRPC front shares the continuous decode engine)")

    server = TTSServer(pipeline, max_batch=max_batch)
    cserver = None
    if streaming:
        from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

        cserver = ContinuousTTSServer(
            pipeline,
            max_slots=stream_max_slots,
            steps_per_dispatch=stream_steps_per_dispatch,
            paged=paged_kv,
        )
    loop = asyncio.new_event_loop()

    def loop_thread():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        if cserver is not None:
            loop.run_until_complete(cserver.start())
        loop.run_forever()

    t = threading.Thread(target=loop_thread, daemon=True)
    t.start()
    if warmup:
        # pay every first run before the socket opens — a load balancer sees
        # the port only once the first real request would be fast
        warmup_servers(pipeline, server, cserver, loop)
    stop_grpc = None
    if grpc_port is not None and cserver is not None:
        # gRPC front door SHARING the streaming engine: requests from both
        # transports join the same decode batch (one KV pool, like Triton
        # exposing gRPC+HTTP over one TRT-LLM engine).  Imported only here:
        # the HTTP front needs neither grpc nor google.protobuf
        try:
            from sparktts_tpu_torch.serve.grpc_server import serve_grpc

            grpc_srv, _grpc_backend = serve_grpc(
                pipeline, host=host, port=grpc_port, cserver=cserver, loop=loop
            )
            stop_grpc = lambda: grpc_srv.stop(grace=0)  # noqa: E731
            logger.info("gRPC front listening on %s:%d", host, grpc_srv.bound_port)
        except ImportError:
            # grpcio absent: same messages/semantics over the framed transport
            from sparktts_tpu_torch.serve.grpc_server import FramedSocketServer

            framed = FramedSocketServer(
                pipeline, host=host, port=grpc_port, cserver=cserver, loop=loop
            )
            stop_grpc = framed.close
            logger.info(
                "grpcio not installed; framed gRPC transport on %s:%d",
                framed.host, framed.port,
            )

    def streaming_alive() -> bool:
        return cserver._task is not None and not cserver._task.done()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # required for chunked transfer encoding

        def _send_json(self, obj, code: int = 200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/ui"):
                # native browser UI (role of the reference's gradio webui.py;
                # gradio-free — see serve/ui.py)
                from sparktts_tpu_torch.serve.ui import render_ui

                body = render_ui(pipeline.sample_rate).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                stats = server.stats_summary()
                if cserver is not None:
                    stats["streaming"] = dict(cserver.stats)
                    stats["streaming_stages"] = cserver.stage_stats.summary()
                if pipeline.voice_cache_size > 0:
                    stats["voice_cache"] = dict(pipeline.voice_cache_stats)
                self._send_json(stats)
            elif self.path == "/health":
                ok = server.healthy
                if cserver is not None:
                    # a dead streaming loop must not hide behind a green
                    # batch-server check
                    ok = ok and streaming_alive()
                self._send_json({"healthy": ok}, 200 if ok else 503)
            elif self.path == "/v1/voices":
                self._send_json(
                    {"voices": voice_registry.describe(pipeline.sample_rate)}
                )
            elif self.path == "/v1/models":
                # OpenAI SDK handshake surface (client.models.list())
                self._send_json(
                    {
                        "object": "list",
                        "data": [
                            {
                                "id": "spark-tts",
                                "object": "model",
                                "owned_by": "sparktts_tpu_torch",
                            }
                        ],
                    }
                )
            elif self.path in ("/v2/health/ready", "/v2/health/live"):
                # Triton v2 health surface (reference clients probe these).
                # Content-Length is mandatory on a keep-alive connection —
                # without it body-reading probes block until timeout.
                self.send_response(200 if server.healthy else 503)
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                self._send_json({"error": "not found"}, 404)

        @staticmethod
        def _parse_payload(payload) -> TTSRequest:
            req = TTSRequest(
                text=payload["text"],
                prompt_text=payload.get("prompt_text"),
                gender=payload.get("gender"),
                pitch=payload.get("pitch"),
                speed=payload.get("speed"),
                temperature=payload.get("temperature", 0.8),
                top_k=payload.get("top_k", 50),
                top_p=payload.get("top_p", 0.95),
                seed=payload.get("seed", 0),
            )
            if "prompt_wav_b64" in payload:
                req.prompt_wav = np.frombuffer(
                    base64.b64decode(payload["prompt_wav_b64"]), dtype=np.float32
                )
            return req

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            path = self.path.split("?")[0]
            # Triton v2 inference protocol (KServe): lets the reference's own
            # HTTP client (reference runtime/triton_trtllm/client_http.py)
            # talk to this server unchanged
            if path.startswith("/v2/models/") and path.endswith("/infer"):
                try:
                    payload = json.loads(raw)
                    req, model_name = self._parse_v2_payload(payload)
                except (
                    json.JSONDecodeError, ValueError, KeyError,
                    TypeError, IndexError, AttributeError,
                ) as e:
                    self._send_json({"error": f"bad request: {e}"}, 400)
                    return
                try:
                    self._do_v2_infer(req, model_name)
                except Exception as e:  # noqa: BLE001 — server-side failure
                    logger.exception("v2 infer failed")
                    self._send_json({"error": f"inference failed: {e}"}, 500)
                return
            try:
                payload = json.loads(raw)
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
            except (json.JSONDecodeError, ValueError) as e:
                self._send_json({"error": f"bad request: {e}"}, 400)
                return
            if path == "/v1/audio/speech":
                self._do_openai_speech(payload)
                return
            if path == "/v1/voices":
                self._do_register_voice(payload)
                return
            if "text" not in payload:
                self._send_json(
                    {"error": 'bad request: missing required field "text"'}, 400
                )
                return
            if self.path == "/tts":
                try:
                    req = self._parse_payload(payload)
                except Exception as e:  # bad field types / broken base64
                    self._send_json({"error": f"bad request: {e}"}, 400)
                    return
                try:
                    if payload.get("longform"):
                        self._do_tts_long(req, payload)
                    else:
                        self._do_tts(req)
                except Exception as e:  # noqa: BLE001 — server-side failure
                    logger.exception("tts failed")
                    self._send_json({"error": f"inference failed: {e}"}, 500)
            elif self.path == "/tts_stream":
                try:
                    req = self._parse_payload(payload)
                except Exception as e:
                    self._send_json({"error": f"bad request: {e}"}, 400)
                    return
                self._do_tts_stream(req, payload)
            else:
                self._send_json({"error": "not found"}, 404)

        def _parse_v2_payload(self, payload):
            """KServe/Triton v2 JSON infer payload → (TTSRequest, model name):
            inputs reference_wav (FP32), reference_wav_len (INT32),
            reference_text / target_text (BYTES) (the reference server's I/O
            contract, model_repo/spark_tts/config.pbtxt)."""
            inputs = {i["name"]: i for i in payload["inputs"]}

            def text_input(name):
                # KServe allows data nested per shape ([["hi"]]) or flat
                data = inputs.get(name, {}).get("data")
                flat = np.asarray(data, dtype=object).reshape(-1) if data else []
                # empty string == no transcript (clone prompts change shape
                # on prompt_text presence)
                return (str(flat[0]) or None) if len(flat) else None

            wav = np.asarray(
                inputs["reference_wav"]["data"], np.float32
            ).reshape(-1)
            if "reference_wav_len" in inputs:
                n = int(np.asarray(inputs["reference_wav_len"]["data"]).reshape(-1)[0])
                wav = wav[:n]
            ref_text = text_input("reference_text")
            target_text = text_input("target_text")
            if target_text is None:
                raise ValueError("missing target_text")
            return (
                TTSRequest(text=target_text, prompt_wav=wav, prompt_text=ref_text),
                self.path.split("/")[3],
            )

        def _do_v2_infer(self, req, model_name):
            fut = asyncio.run_coroutine_threadsafe(server.synthesize(req), loop)
            res: TTSResult = fut.result()
            out = res.wav.astype(np.float32)
            self._send_json(
                {
                    "model_name": model_name,
                    "outputs": [
                        {
                            "name": "waveform",
                            "datatype": "FP32",
                            "shape": [1, len(out)],
                            "data": out.tolist(),
                        }
                    ],
                }
            )

        def _do_tts(self, req):
            fut = asyncio.run_coroutine_threadsafe(server.synthesize(req), loop)
            res: TTSResult = fut.result()
            self._send_json(
                {
                    "wav_b64": base64.b64encode(res.wav.astype(np.float32).tobytes()).decode(),
                    "sample_rate": res.sample_rate,
                    "queue_ms": res.queue_ms,
                    "infer_ms": res.infer_ms,
                }
            )

        def _longform_kwargs(self, req, payload) -> dict:
            kwargs = dict(
                text=req.text,
                prompt_wav=req.prompt_wav,
                prompt_text=req.prompt_text,
                gender=req.gender,
                pitch=req.pitch,
                speed=req.speed,
                temperature=payload.get("temperature"),
                top_p=payload.get("top_p"),
            )
            if payload.get("max_segment_chars"):
                kwargs["max_segment_chars"] = int(payload["max_segment_chars"])
            return kwargs

        def _do_tts_long(self, req, payload):
            """Offline longform ({"longform": true}): sentence-segmented
            synthesis with one stable voice through the continuous engine."""
            if cserver is None:
                self._send_json(
                    {"error": "longform requires the streaming engine"}, 501
                )
                return
            kwargs = self._longform_kwargs(req, payload)
            kwargs["max_new_tokens"] = payload.get("max_new_tokens")
            t0 = time.perf_counter()
            fut = asyncio.run_coroutine_threadsafe(
                cserver.synthesize_long(**kwargs), loop
            )
            wav = fut.result()
            self._send_json(
                {
                    "wav_b64": base64.b64encode(
                        wav.astype(np.float32).tobytes()
                    ).decode(),
                    "sample_rate": pipeline.sample_rate,
                    "infer_ms": (time.perf_counter() - t0) * 1000.0,
                }
            )

        def _do_tts_stream(self, req, payload):
            def encode_chunk(val):
                return (
                    json.dumps(
                        {
                            "wav_b64": base64.b64encode(
                                np.asarray(val, np.float32).tobytes()
                            ).decode(),
                            "sample_rate": pipeline.sample_rate,
                        }
                    ).encode()
                    + b"\n"
                )

            self._stream_engine(
                req,
                payload,
                content_type="application/x-ndjson",
                preamble=b"",
                encode_chunk=encode_chunk,
                encode_done=lambda: json.dumps({"done": True}).encode() + b"\n",
                encode_error=lambda msg: json.dumps({"error": msg}).encode() + b"\n",
            )

        def _stream_engine(
            self, req, payload, content_type, preamble,
            encode_chunk, encode_done, encode_error,
        ):
            """Decoupled streaming scaffold: run the request through the
            continuous engine, write each audio chunk through the given
            encoder over chunked transfer encoding.  Transport-format
            agnostic (NDJSON for /tts_stream, raw audio for the OpenAI
            endpoint)."""
            if cserver is None:
                self._send_json({"error": "streaming disabled"}, 501)
                return
            if not streaming_alive():
                self._send_json({"error": "streaming loop not running"}, 503)
                return
            import queue as _queue

            chunk_q: _queue.Queue = _queue.Queue()
            client_gone = threading.Event()

            if "top_k" in payload or "seed" in payload:
                logger.warning(
                    "streaming: top_k/seed are engine-wide on the continuous "
                    "path (shared batch) — per-request values ignored"
                )

            async def pump():
                kwargs = dict(
                    text=req.text,
                    prompt_wav=req.prompt_wav,
                    prompt_text=req.prompt_text,
                    gender=req.gender,
                    pitch=req.pitch,
                    speed=req.speed,
                    max_new_tokens=payload.get("max_new_tokens"),
                    temperature=payload.get("temperature"),
                    top_p=payload.get("top_p"),
                )
                if payload.get("longform"):
                    if payload.get("max_segment_chars"):
                        kwargs["max_segment_chars"] = int(
                            payload["max_segment_chars"]
                        )
                    agen = cserver.synthesize_streaming_long(**kwargs)
                else:
                    agen = cserver.synthesize_streaming(**kwargs)
                try:
                    async for chunk in agen:
                        if client_gone.is_set():
                            # the socket died: stop consuming so the engine
                            # slot isn't held for an abandoned request
                            break
                        chunk_q.put(("chunk", chunk))
                    chunk_q.put(("done", None))
                except Exception as e:  # surfaced as an in-band error line
                    logger.exception("stream failed")
                    chunk_q.put(("error", str(e)))
                finally:
                    await agen.aclose()

            asyncio.run_coroutine_threadsafe(pump(), loop)

            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_http_chunk(data: bytes):
                if not data:
                    return
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            try:
                write_http_chunk(preamble)
                while True:
                    try:
                        # bounded wait: if the streaming loop dies mid-request
                        # the handler must not hold this thread forever
                        kind, val = chunk_q.get(timeout=600)
                    except _queue.Empty:
                        kind, val = "error", "stream timed out server-side"
                    if kind == "chunk":
                        write_http_chunk(encode_chunk(val))
                    elif kind == "done":
                        write_http_chunk(encode_done())
                        break
                    else:
                        write_http_chunk(encode_error(val))
                        break
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                # client disconnected mid-stream: signal the pump so the
                # synthesis stops and the engine slot is freed
                client_gone.set()
                logger.info("stream client disconnected; aborting synthesis")

        # ---- OpenAI-compatible surface (/v1/audio/speech, /v1/voices) ----

        def _send_openai_error(
            self, message, status=400, etype="invalid_request_error"
        ):
            # OpenAI error envelope so SDK clients raise typed errors
            self._send_json(
                {"error": {"message": message, "type": etype, "code": None}},
                status,
            )

        def _openai_request(self, payload):
            """OpenAI speech payload → (TTSRequest, response_format, stream).
            Raises ValueError (400) / KeyError (unknown voice, 404)."""
            text = payload.get("input")
            if not isinstance(text, str) or not text.strip():
                raise ValueError('missing required field "input"')
            response_format = payload.get("response_format", "wav")
            if response_format not in ("wav", "pcm"):
                raise ValueError(
                    f"unsupported response_format {response_format!r} "
                    "(supported: wav, pcm)"
                )
            stream = bool(payload.get("stream", False)) or (
                payload.get("stream_format") == "audio"
            )
            level = None
            if payload.get("speed") is not None:
                level = openai_speed_level(payload["speed"])
            voice = payload.get("voice", "female")
            req = TTSRequest(
                text=text,
                temperature=payload.get("temperature", 0.8),
                top_p=payload.get("top_p", 0.95),
                seed=payload.get("seed", 0),
            )
            if voice in BUILTIN_VOICES:
                # creation mode: attribute-token controllable synthesis
                req.gender = voice
                req.pitch = "moderate"
                req.speed = level or "moderate"
            else:
                wav, prompt_text = voice_registry.get(voice)  # KeyError → 404
                req.prompt_wav = wav
                req.prompt_text = prompt_text
                if level is not None:
                    logger.warning(
                        "/v1/audio/speech: speed is ignored for clone voices "
                        "(attribute tokens only apply in creation mode)"
                    )
            return req, response_format, stream

        def _do_openai_speech(self, payload):
            try:
                req, response_format, stream = self._openai_request(payload)
            except KeyError as e:
                self._send_openai_error(f"unknown voice {e.args[0]!r}", 404)
                return
            except (ValueError, TypeError) as e:
                self._send_openai_error(str(e))
                return
            # longform: explicit flag, or automatic for inputs long enough to
            # overrun the generation budget (the text would otherwise be
            # silently truncated at max_new_tokens)
            if (
                payload.get("longform")
                or len(req.text) > OPENAI_LONGFORM_AUTO_CHARS
            ) and cserver is not None:
                payload = dict(payload, longform=True)
                if not stream:
                    try:
                        fut = asyncio.run_coroutine_threadsafe(
                            cserver.synthesize_long(**self._longform_kwargs(req, payload)),
                            loop,
                        )
                        wav = fut.result()
                    except Exception as e:  # noqa: BLE001
                        logger.exception("openai longform failed")
                        self._send_openai_error(
                            f"inference failed: {e}", 500, "server_error"
                        )
                        return
                    self._send_audio(wav, response_format)
                    return
            if stream:
                # chunked audio bytes as each chunk is vocoded; WAV gets a
                # read-to-EOF header up front, PCM is raw 16-bit frames
                preamble = (
                    wav_header(WAV_STREAM_SIZE, pipeline.sample_rate)
                    if response_format == "wav"
                    else b""
                )

                def encode_error(msg):
                    # can't switch to an error status mid-stream: truncate
                    logger.error("openai stream failed: %s", msg)
                    return b""

                self._stream_engine(
                    req,
                    payload,
                    content_type=(
                        "audio/wav" if response_format == "wav" else "audio/pcm"
                    ),
                    preamble=preamble,
                    encode_chunk=pcm16_bytes,
                    encode_done=lambda: b"",
                    encode_error=encode_error,
                )
                return
            try:
                fut = asyncio.run_coroutine_threadsafe(server.synthesize(req), loop)
                res: TTSResult = fut.result()
            except Exception as e:  # noqa: BLE001 — server-side failure
                logger.exception("openai speech failed")
                self._send_openai_error(f"inference failed: {e}", 500, "server_error")
                return
            self._send_audio(res.wav, response_format)

        def _send_audio(self, wav, response_format):
            if response_format == "wav":
                body = wav_bytes(wav, pipeline.sample_rate)
                ctype = "audio/wav"
            else:
                body = pcm16_bytes(wav)
                ctype = "audio/pcm"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _do_register_voice(self, payload):
            try:
                name = payload["name"]
                wav = np.frombuffer(
                    base64.b64decode(payload["wav_b64"]), dtype=np.float32
                )
                voice_registry.register(name, wav, payload.get("prompt_text"))
            except (KeyError, ValueError, TypeError) as e:
                self._send_openai_error(f"bad voice registration: {e}")
                return
            self._send_json(
                {
                    "name": name,
                    "duration_s": round(len(wav) / pipeline.sample_rate, 3),
                }
            )

        def do_DELETE(self):
            path = self.path.split("?")[0]
            if path.startswith("/v1/voices/"):
                name = path[len("/v1/voices/") :]
                if voice_registry.remove(name):
                    self._send_json({"deleted": name})
                else:
                    self._send_openai_error(f"unknown voice {name!r}", 404)
            else:
                self._send_json({"error": "not found"}, 404)

        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

    httpd = ThreadingHTTPServer((host, port), Handler)

    def stop(timeout: float = 10.0):
        """Graceful shutdown (tests/embedding): HTTP socket, gRPC front,
        serving loops (the streaming engine's decode units go with its
        stop), the loop's executor, event loop — in dependency order, so no
        thread keeps pinning the pipeline after the caller returns."""
        httpd.shutdown()
        httpd.server_close()
        if stop_grpc is not None:
            try:
                stop_grpc()
            except Exception:
                logger.exception("gRPC front shutdown failed")

        async def _stop_servers():
            if cserver is not None:
                await cserver.stop()
            await server.stop()
            await loop.shutdown_default_executor()

        try:
            asyncio.run_coroutine_threadsafe(_stop_servers(), loop).result(timeout)
        finally:
            # even if the graceful drain times out (e.g. a first-run decode
            # dispatch still in flight), the loop thread must not outlive
            # stop() and keep pinning the pipeline
            loop.call_soon_threadsafe(loop.stop)
            t.join(timeout)
            if not t.is_alive():
                loop.close()

    if control is not None:
        control.update(httpd=httpd, loop=loop, server=server,
                       cserver=cserver, stop=stop)
    logger.info("TTS server listening on %s:%d", *httpd.server_address[:2])
    httpd.serve_forever()
