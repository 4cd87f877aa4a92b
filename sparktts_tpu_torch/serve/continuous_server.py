"""Continuous-batching TTS server: the production serving architecture.

Port of `sparktts_tpu/serve/continuous_server.py`.  It couples the inflight
batching engines (`lm/continuous.py`, `lm/paged.py`) with the codec:
requests join the running decode batch the moment a slot frees, tokens
stream out per decode dispatch, and finished or chunked token runs are
vocoded on a worker thread while the LM keeps decoding.

Dispatch sizing is adaptive: each decode dispatch is sized to the nearest
first-audio event across the running batch (a streaming request's first
chunk, or a budget end), snapped to the engine's fixed dispatch ladder, so
no size captures a new decode unit while serving.  A streaming request's
first chunk can be vocoded inside the decode dispatch's chain and fetched
with its tokens (`spec_first_chunk`); bursts of clone requests admit
through one batched prefill; windows of several streams that share a
padded length vocode as one batch.

Where the port differs from the JAX server:

  * Threads and streams.  JAX overlaps the vocoder with decode through its
    asynchronous dispatch.  Here the vocode worker runs on a CUDA stream of
    its own, so its kernels do not queue behind the loop thread's graph
    replays on the default stream; device ids it reads from the loop thread
    (an admission's speaker ids) are handed over with an event, and marked
    used on its stream for the caching allocator.  The fetch worker also
    has its own stream.  Background warm threads run on the default
    stream, in order with the loop's work.
  * Every thread the server starts enters `torch.inference_mode()` itself
    (the mode is per thread, and the engine state holds inference tensors).
  * "Warm" means run once: a signature of an admission, a vocode batch or
    a speculative chain is ready once it has run on scratch state, which
    builds its kernels and library plans.  The engine's decode units are
    captured at `start` (`warm_units`), never inside a live burst.
  * Tensor parallelism (`pipeline.shard_llm(mesh)`): the dense engine
    takes `mesh=pipeline.mesh` (the paged one refuses a mesh, as in JAX),
    and the server runs on the row's rank 0 while the other ranks follow
    its engine's LM calls (`parallel/worker.py`); a burst's first-time
    clones admit one by one, as JAX skips the batched fused row on a mesh.
    With a `codec_device`, the device-chained admission and the
    speculative first chunk are off, as in JAX (both chain codec work onto
    the LM's card).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, Optional

import numpy as np
import torch

from sparktts_tpu_torch.lm.continuous import (
    ADMIT_BATCH_LADDER,
    AdmissionDeferred,
    RequestTooLong,
    snap_to_ladder,
)
from sparktts_tpu_torch.lm.qwen import aligned_cache_len
from sparktts_tpu_torch.prompt import (
    build_clone_prompt,
    build_control_prompt,
    clone_prompt_scaffold,
    extract_semantic_ids,
    padded_global_tokens,
)
from sparktts_tpu_torch.utils.profiling import StageStats

logger = logging.getLogger(__name__)

#: Batch sizes of the cross-stream vocode batcher: both the up-front warm
#: pass (warm_vocode_batches_seen) and the server's runtime ladder read it.
VOCODE_BATCH_LADDER = (2, 4, 8, 16)

# guards the first-touch creation of a pipeline's vocode warm state (the
# vocode worker, warm threads and a warming main thread can race it)
_VOC_STATE_LOCK = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _voc_state(pipe) -> Dict[str, set]:
    """Per-pipeline vocode warm state, kept on the pipeline object (so it
    lives exactly as long as the pipeline): `warm` (batch, t_pad) vocode
    signatures that have run, `warming` ones with a background warm-up in
    flight, `sizes_seen` raw window lengths the vocode drains have routed,
    and (set on first use) `stream_tpads`, `spec_warm`, `spec_warming`."""
    st = getattr(pipe, "_voc_batch_state", None)
    if st is None:
        with _VOC_STATE_LOCK:
            st = getattr(pipe, "_voc_batch_state", None)
            if st is None:
                st = {"warm": set(), "warming": set(), "sizes_seen": set()}
                pipe._voc_batch_state = st
    return st


def warm_vocode_batch(pipe, batch: int, t_pad: int) -> None:
    """Run the (batch, t_pad) batched vocode once and mark it warm, so
    servers over `pipe` batch that shape from their first drain."""
    t_pad = _round_up(t_pad, pipe.vocode_bucket)
    st = _voc_state(pipe)
    if (batch, t_pad) in st["warm"]:
        return
    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    pipe.detokenize_batch(np.zeros((batch, n_glob), np.int32), [np.zeros(t_pad, np.int32)] * batch)
    st["warm"].add((batch, t_pad))


def default_stream_ctx(pipe) -> int:
    """The codec's one-sided receptive field rounded up to the vocode
    bucket: the streaming left context that makes a windowed vocode equal
    the full-prefix one."""
    from sparktts_tpu_torch.codec.bicodec import detokenize_receptive_field

    return _round_up(detokenize_receptive_field(pipe.config.bicodec), pipe.vocode_bucket)


def vocode_window_cap(pipe, max_vocode_window: Optional[int] = None,
                      stream_ctx: Optional[int] = None) -> int:
    """The streaming vocode window cap (see ContinuousTTSServer):
    bucket-aligned, at least ctx + 2 buckets so a window can advance past
    its own context.  The default max(8 bucket, 4 ctx) keeps the re-render
    overhead of split windows near 2 ctx / cap."""
    bucket = pipe.vocode_bucket
    if stream_ctx is None:
        stream_ctx = default_stream_ctx(pipe)
    if max_vocode_window is None:
        max_vocode_window = max(8 * bucket, 4 * stream_ctx)
    return _round_up(max(max_vocode_window, stream_ctx + 2 * bucket), bucket)


def warm_stream_windows(pipe, max_window: int) -> int:
    """Run the scalar streaming vocode once at every window shape the
    capped planner can produce: t_pad in {bucket, 2 bucket, ...} up to
    `max_window` (pass cap + stream_ctx: a split window renders look-ahead
    past its cut).  Returns the number of shapes newly warmed."""
    bucket = pipe.vocode_bucket
    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    globs = np.zeros((1, n_glob), np.int32)
    warmed = _voc_state(pipe).setdefault("stream_tpads", set())
    n = 0
    for t_pad in range(bucket, _round_up(int(max_window), bucket) + 1, bucket):
        if t_pad in warmed:
            continue
        pipe.detokenize(globs, np.zeros((1, t_pad), np.int32))
        warmed.add(t_pad)
        n += 1
    return n


def warm_vocode_batches_seen(pipe, max_batch: int) -> int:
    """Warm the batched vocode at every window length the vocode drains of
    `pipe` have routed so far (run a representative pass first), at each
    ladder batch size up to max_batch.  Raw lengths are padded with the
    pipeline's current vocode bucket.  Returns the number of signatures
    warmed."""
    st = _voc_state(pipe)
    bucket = pipe.vocode_bucket
    tpads = {_round_up(max(s, 1), bucket) for s in st["sizes_seen"]}
    n = 0
    for t_pad in sorted(tpads):
        for b in VOCODE_BATCH_LADDER:
            if b > max_batch:
                break
            if (b, t_pad) not in st["warm"]:
                warm_vocode_batch(pipe, b, t_pad)
                n += 1
    return n


@torch.inference_mode()
def warm_spec_chain(pipe, max_slots: int, batch: int, target: int, n_steps: int) -> None:
    """Run the speculative first-chunk chain of one (batch, target,
    dispatch size) signature once on zeros and mark it warm.  The packed
    step result it reads is (max_slots, 2 n_steps + 1)."""
    st = _voc_state(pipe)
    warm_set = st.setdefault("spec_warm", set())
    key = (batch, target, _round_up(max(target, 1), pipe.vocode_bucket), n_steps)
    if key in warm_set:
        return
    dev = pipe.device
    tn = pipe.config.bicodec.speaker_encoder.token_num
    zeros = lambda n, dtype=torch.int64: torch.zeros(n, dtype=dtype, device=dev)  # noqa: E731
    pipe._spec_chain_fn(batch, target)(
        pipe.bicodec_params, zeros((max_slots, 2 * n_steps + 1), torch.int32), zeros(batch),
        zeros(batch), zeros(batch, torch.bool), zeros((batch, tn)))
    warm_set.add(key)


def first_chunk_target(pipe) -> int:
    """The streaming schedule's first chunk, in semantic tokens: the
    speculative chain's `target` for every fresh stream."""
    from sparktts_tpu_torch.serve.streaming import chunk_sizes

    return next(chunk_sizes(pipe.config.streaming))


def warm_spec_chains(server, max_batch: int) -> int:
    """Warm every speculative-chain signature the server's dispatch sizing
    can put on a first-chunk dispatch: rungs >= the first chunk target
    (clone) or target + token_num + 2 (controllable), capped at the
    co-dispatch cap, at batch 1 and every ladder size <= max_batch.
    Returns the number of signatures warmed."""
    pipe = server.pipe
    target = first_chunk_target(pipe)
    tn = pipe.config.bicodec.speaker_encoder.token_num
    rungs = {
        snap_to_ladder(target, server.steps, overshoot=target),
        snap_to_ladder(target + tn + 2, server.steps, overshoot=target + tn + 2),
    }
    if server.co_dispatch_cap >= target:
        rungs.add(snap_to_ladder(server.co_dispatch_cap, server.steps))
    sizes = [1] + [b for b in VOCODE_BATCH_LADDER if b <= max(max_batch, 2)]
    warm_set = _voc_state(pipe).setdefault("spec_warm", set())
    t_pad = _round_up(max(target, 1), pipe.vocode_bucket)
    n = 0
    for rung in sorted(rungs):
        if rung < target:
            continue
        for b in sizes:
            if (b, target, t_pad, rung) not in warm_set:
                warm_spec_chain(pipe, server.engine.max_slots, b, target, rung)
                n += 1
    return n


def warm_admit_batches(server, tasks, max_batch: int) -> int:
    """Warm the batched admissions for every distinct (wav bucket, prompt
    bucket) signature in `tasks` (rows with .text, .prompt_wav,
    .prompt_text), at each ADMIT_BATCH_LADDER size <= max_batch, both the
    fused (first-time voice) and the assembled (voice-cache hit) ones.  The
    registry is process-wide, so fresh servers over the same pipeline adopt
    them.  Returns the number of signatures warmed or adopted."""
    eng = server.engine
    if not hasattr(eng, "warm_fused_batch"):
        return 0
    pipe = server.pipe
    n_glob = pipe.config.bicodec.speaker_encoder.token_num
    sizes = [b for b in ADMIT_BATCH_LADDER if b <= max_batch]
    seen, n = set(), 0
    for t in tasks:
        pending = _Pending(
            text=t.text, prompt_wav=t.prompt_wav, prompt_text=t.prompt_text,
            gender=None, pitch=None, speed=None,
            max_new_tokens=server.default_max_new, future=None,
        )
        fn, tok_args, n_sem_true, s_pad = pipe.tokenize_host_prep(t.prompt_wav)
        use_sem = n_sem_true if t.prompt_text is not None else 0
        _, _, _, _, t_pad = server._clone_scaffold(n_glob, use_sem, pending)
        sig = (tok_args[2].shape[-1], s_pad, t_pad, use_sem and 1)
        if sig in seen:
            continue
        seen.add(sig)
        assemble_fn = pipe._assemble_fn_batch(t_pad, s_pad)
        for b in sizes:
            eng.warm_fused_batch(fn, assemble_fn, b, tok_args, t_pad)
            eng.warm_assembled_batch(assemble_fn, b, n_glob, s_pad, t_pad)
            n += 2
    return n


def _split_first_audio(jobs: list, deferred: set):
    """First-chunk-priority split of one vocode drain (see _vocode_loop):
    returns (run_now, backlog, deferred').  When a drain mixes first-audio
    jobs (offline ones, and streams that have emitted nothing) with
    steady-state ones, the steady-state jobs wait one cycle, unless one of
    them already waited (its id is in `deferred`): then the whole drain
    runs.  `deferred'` holds exactly the ids in the backlog."""
    def first_audio(job) -> bool:
        pending, _, _, offline = job
        return offline or (pending.chunk_queue is not None and pending.stream_emitted == 0)

    urgent = [j for j in jobs if first_audio(j)]
    rest = [j for j in jobs if not first_audio(j)]
    if urgent and rest and all(id(j[0]) not in deferred for j in rest):
        return urgent, [tuple(j) for j in rest], {id(j[0]) for j in rest}
    return jobs, [], set()


@dataclass
class _Pending:
    text: str
    prompt_wav: Optional[np.ndarray]
    prompt_text: Optional[str]
    gender: Optional[str]
    pitch: Optional[str]
    speed: Optional[str]
    max_new_tokens: int
    future: asyncio.Future
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # (1, N) speaker ids: a host array, or a device tensor made on the loop
    # thread, with `global_event` recorded after it on the loop's stream
    global_tokens: Optional[object] = None
    global_event: Optional[object] = None
    # a pre-supplied speaker identity: admission builds a globals-only clone
    # prompt (longform continuations reuse the first segment's voice)
    speaker_globals: Optional[np.ndarray] = None
    enqueue_time: float = field(default_factory=time.perf_counter)
    # streaming: chunks go to this queue instead of one final future
    chunk_queue: Optional[asyncio.Queue] = None
    stream_buf: list = field(default_factory=list)
    # absolute semantic index of stream_buf[0] (the dead prefix is trimmed)
    stream_base: int = 0
    # emitted ids kept only until the speaker identity is known
    raw_buf: list = field(default_factory=list)
    stream_emitted: int = 0
    stream_target: int = 0
    stream_schedule: Optional[object] = None
    cancelled: bool = False  # the consumer abandoned the stream
    # increments and tokens handed off by the loop thread: the loop's
    # planning reads these, never the stream fields the vocode worker writes
    loop_increments: int = 0
    loop_tokens: int = 0
    # the first chunk's token target, fixed at submit time
    first_target: int = 0


class ContinuousTTSServer:
    """Asyncio server with per-step request admission."""

    def __init__(
        self,
        pipeline,
        max_slots: int = 8,
        cache_len: Optional[int] = None,
        steps_per_dispatch: int = 512,
        default_max_new_tokens: Optional[int] = None,
        paged: bool = False,
        page_size: int = 256,
        n_pages: Optional[int] = None,
        greedy: bool = False,
        device_admission: bool = True,
        spec_first_chunk: bool = True,
        fused_admission: bool = True,
        fused_warm: str = "background",
        arrival_window_s: float = 4.0,
        stream_context_frames: Optional[int] = None,
        vocode_batch: bool = True,
        max_vocode_window: Optional[int] = None,
        dispatch_depth: int = 2,
    ):
        self.pipe = pipeline
        # decode dispatches in flight at once: at 2, dispatch N+1 is queued
        # before N's blocking fetch, so the card runs across the fetch; the
        # planned-token ledger (_planned_ahead) keeps sizing and spec
        # planning right for dispatched but uncommitted work
        self.dispatch_depth = max(1, int(os.environ.get("SPARKTTS_DISPATCH_DEPTH", dispatch_depth)))
        # streaming vocode left context: each chunk re-renders [emitted -
        # ctx, upto) and emits the tail, equal to a full-prefix vocode at
        # O(chunk + ctx) cost (detokenize is purely convolutional)
        if stream_context_frames is None:
            stream_context_frames = default_stream_ctx(pipeline)
        self.stream_ctx = int(stream_context_frames)
        # window cap: a window emits at most this many tokens past its
        # context start (a split one renders stream_ctx of look-ahead
        # more), so the vocode shapes form the closed set warm-up enumerates
        self.max_vocode_window = vocode_window_cap(pipeline, max_vocode_window, self.stream_ctx)
        # how long after the last concurrent activity a lone stream keeps
        # its dispatches short (see _requested_steps)
        self.arrival_window_s = arrival_window_s
        self._last_concurrent = float("-inf")
        # admission with no host read (tokenize -> assemble -> prefill on
        # the device) and the first streaming chunk vocoded inside the
        # decode dispatch's chain; outputs equal the plain path's
        self.device_admission = device_admission and pipeline.codec_device is None
        self.spec_first_chunk = spec_first_chunk and pipeline.codec_device is None
        # tokenize + assembly + prefill as one admission (dense engine);
        # "background" warms a first-seen signature on a thread while the
        # request takes the chained path, "sync" warms inline
        self.fused_admission = fused_admission
        if fused_warm not in ("background", "sync"):
            raise ValueError(f"fused_warm must be 'background' or 'sync', got {fused_warm!r}")
        self.fused_warm = fused_warm
        self._fused_warming: set = set()
        # the co-dispatch caps are absolute: a larger ladder top must not
        # lengthen how long a mid-flight admission waits
        self.steps = steps_per_dispatch
        self.co_dispatch_cap = max(min(steps_per_dispatch // 2, 64), 1)
        self.anticipation_cap = max(min(steps_per_dispatch // 4, 32), 1)
        self.default_max_new = default_max_new_tokens or pipeline.max_new_tokens
        cache_len = aligned_cache_len(cache_len or (pipeline.prompt_bucket * 4 + self.default_max_new))
        # one engine serves clone and controllable requests: the control
        # superset constraint, narrowed per clone slot by the mode mask
        vocab_slice, extra_ids = pipeline.guided_constraint("control")
        clone_slice, clone_extras = pipeline.guided_constraint("clone")
        common = dict(
            prompt_pad=pipeline.prompt_bucket,
            eos_ids=tuple(pipeline.tokenizer.eos_ids),
            pad_id=pipeline.tokenizer.pad_id,
            cache_dtype=pipeline.lm_dtype,
            vocab_slice=vocab_slice,
            extra_ids=extra_ids,
            clone_slice=clone_slice,
            clone_extras=clone_extras,
            max_dispatch=steps_per_dispatch,
            greedy=greedy,
            device=pipeline.device,
        )
        if paged and pipeline.mesh is not None:
            raise ValueError("paged KV does not compose with shard_llm; use the dense engine")
        if paged:
            from sparktts_tpu_torch.lm.paged import PagedContinuousEngine

            if pipeline.prompt_bucket % page_size and page_size % pipeline.prompt_bucket:
                page_size = pipeline.prompt_bucket  # keep admission page-aligned
            # the table holds the rounded prompt region plus the budget
            prompt_cap = _round_up(pipeline.prompt_bucket * 4, page_size)
            pages_per_slot = prompt_cap // page_size + -(-self.default_max_new // page_size) + 1
            # default pool: half the dense worst case; admission reserves
            # each request's worst case, so a short pool defers requests
            # instead of failing them mid-decode
            n_pages = n_pages or (max_slots * pages_per_slot // 2 + 1)
            self.engine = PagedContinuousEngine(
                pipeline.llm_params, pipeline.config.llm, max_slots=max_slots, n_pages=n_pages,
                page_size=page_size, pages_per_slot=pages_per_slot, **common,
            )
        else:
            from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine

            self.engine = ContinuousBatchingEngine(
                pipeline.llm_params, pipeline.config.llm, max_slots=max_slots,
                cache_len=cache_len, mesh=pipeline.mesh, **common,
            )
        self.waiting: asyncio.Queue = asyncio.Queue()
        self._deferred: deque = deque()  # backpressured admissions, retried first
        self.inflight: Dict[int, _Pending] = {}
        # per-slot decode steps dispatched but not yet committed
        self._planned_ahead = [0] * max_slots
        self._task: Optional[asyncio.Task] = None
        self._vocode_task: Optional[asyncio.Task] = None
        self._vocode_q: asyncio.Queue = asyncio.Queue()
        # cross-stream vocode batching over already-warm (b, t_pad)
        # signatures only (a cold one warms in the background while the
        # drain stays scalar)
        self.vocode_batch = vocode_batch
        # first-chunk-priority deferral across drains: off by default, as in
        # the JAX server (it costs cross-stream batching under saturation);
        # SPARKTTS_VOCODE_DEFER=1 turns it on
        self.first_chunk_priority = bool(os.environ.get("SPARKTTS_VOCODE_DEFER"))
        self._voc_batch_sizes = [b for b in VOCODE_BATCH_LADDER if b <= max(max_slots, 2)]
        # the workers' streams come from PyTorch's high-priority pool: the
        # decode units capture on streams of the default pool, which PyTorch
        # hands out in turn, and a capture on a stream a worker is running
        # work on would take that work into the graph
        dev = self.engine.device
        self._vocode_stream, self._fetch_stream = (
            (torch.cuda.Stream(dev, priority=-1) if dev.type == "cuda" else None)
            for _ in range(2))
        self._vocode_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vocode")
        # the blocking decode fetch: a concurrent future the loop can still
        # wait on when it is cancelled mid-step (commit-on-cancel)
        self._fetch_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fetch")
        self._units_warm = False
        self.stage_stats = StageStats()
        self.stats = {"requests": 0, "completed": 0, "admitted_midflight": 0, "deferrals": 0}
        if paged:
            self.stats["pages_in_use"] = 0
            self.stats["pages_free"] = len(self.engine.free_pages)

    # -- threads -----------------------------------------------------------

    @staticmethod
    def _on_worker(stream, fn, *args):
        """Run fn(*args) as a pool thread must: in inference mode (the
        engine state holds inference tensors), on the pool's own stream."""
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with torch.inference_mode(), ctx:
            return fn(*args)

    def _spawn(self, name: str, fn) -> None:
        """A daemon warm thread running fn() in inference mode, on the
        default stream (in order with the loop's work); fn logs its own
        errors.  `stop` waits for it."""
        def go():
            with torch.inference_mode():
                fn()

        thread = threading.Thread(target=go, daemon=True, name=name)
        self.__dict__.setdefault("_warm_threads", []).append(thread)
        thread.start()

    @staticmethod
    def _set_globals(pending: _Pending, g) -> None:
        """Hand speaker ids made on the loop thread to `pending`, with an
        event after them on the loop's stream for the vocode worker."""
        pending.global_tokens = g
        pending.global_event = None
        if isinstance(g, torch.Tensor) and g.is_cuda:
            pending.global_event = torch.cuda.Event()
            pending.global_event.record(torch.cuda.current_stream(g.device))

    @staticmethod
    def _worker_globals(pending: _Pending):
        """`pending`'s speaker ids as the vocode worker may read them: a
        device tensor is waited for on the worker's stream and marked used
        there (so the caching allocator keeps its memory until then)."""
        g = pending.global_tokens
        if isinstance(g, torch.Tensor) and g.is_cuda:
            stream = torch.cuda.current_stream(g.device)
            if pending.global_event is not None:
                stream.wait_event(pending.global_event)
            g.record_stream(stream)
        return g

    async def start(self):
        if self._vocode_pool._shutdown:  # restarted after stop()
            self._vocode_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vocode")
        if self._fetch_pool._shutdown:
            self._fetch_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fetch")
        if not self._units_warm:
            # every dispatch size's decode unit, captured before serving
            self.engine.warm_units()
            self._units_warm = True
        if self._task is None:
            self._task = asyncio.create_task(self._loop())
        if self._vocode_task is None:
            self._vocode_task = asyncio.create_task(self._vocode_loop())

    async def stop(self):
        for attr in ("_task", "_vocode_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        self._vocode_pool.shutdown(wait=False)
        self._fetch_pool.shutdown(wait=False)
        # a warm run still in torch when the process exits would abort it
        # (a daemon thread is unwound through C++ frames at finalization)
        for thread in self.__dict__.pop("_warm_threads", []):
            await asyncio.to_thread(thread.join)
        # the engine's decode units and their graph pools go now, not when
        # the server is dropped; a restart captures them again
        self.engine.close()
        self._units_warm = False

    # -- request entry points ----------------------------------------------

    async def synthesize(
        self,
        text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        speaker_globals: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        fut = asyncio.get_running_loop().create_future()
        self.stats["requests"] += 1
        await self.waiting.put(
            _Pending(
                text=text, prompt_wav=prompt_wav, prompt_text=prompt_text, gender=gender,
                pitch=pitch, speed=speed, max_new_tokens=max_new_tokens or self.default_max_new,
                future=fut, temperature=temperature, top_p=top_p,
                speaker_globals=speaker_globals,
            )
        )
        return await fut

    async def synthesize_streaming(
        self,
        text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        speaker_globals: Optional[np.ndarray] = None,
    ) -> AsyncIterator[np.ndarray]:
        """Async generator of waveform chunks (the growing-chunk schedule)
        while the request shares the continuous decode batch.  Temperature
        and top_p are kept per slot; top_k and the generator are
        engine-wide."""
        pending = self._make_stream_pending(
            text=text, prompt_wav=prompt_wav, prompt_text=prompt_text, gender=gender,
            pitch=pitch, speed=speed, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, speaker_globals=speaker_globals,
        )
        async for chunk in self._drain_stream(pending):
            yield chunk

    def _make_stream_pending(self, max_new_tokens=None, **kw) -> _Pending:
        from sparktts_tpu_torch.serve.streaming import chunk_sizes

        schedule = chunk_sizes(self.pipe.config.streaming)
        first = next(schedule)
        return _Pending(
            future=asyncio.get_running_loop().create_future(),
            chunk_queue=asyncio.Queue(),
            stream_target=first,
            first_target=first,
            stream_schedule=schedule,
            max_new_tokens=max_new_tokens or self.default_max_new,
            **kw,
        )

    async def _drain_stream(self, pending: _Pending) -> AsyncIterator[np.ndarray]:
        """Submit a streaming pending and yield its chunks until it ends."""
        fut, q = pending.future, pending.chunk_queue
        self.stats["requests"] += 1
        await self.waiting.put(pending)
        try:
            while True:
                chunk = await q.get()
                if chunk is None:
                    break
                yield chunk
        except (GeneratorExit, asyncio.CancelledError):
            # the consumer closed the stream early: the loop frees its slot
            pending.cancelled = True
            raise
        if fut.done() and not fut.cancelled() and fut.exception() is not None:
            raise fut.exception()

    @staticmethod
    def _host_globals(g) -> np.ndarray:
        if isinstance(g, torch.Tensor):
            g = g.cpu().numpy()
        return np.asarray(g, np.int32).reshape(1, -1)

    async def synthesize_streaming_long(
        self,
        text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        max_segment_chars: int = 400,
        inter_segment_silence_s: float = 0.1,
    ) -> AsyncIterator[np.ndarray]:
        """Longform streaming: the text packed at sentence boundaries
        (`utils/textseg.py`), the segments streamed back to back in one
        voice.  The first segment sets the speaker identity; every later one
        admits as a globals-only clone prompt.  Segment i + 1 is admitted as
        soon as the identity is known, so it decodes while segment i still
        renders; chunks are yielded strictly in segment order."""
        from sparktts_tpu_torch.utils.textseg import pack_segments

        segments = pack_segments(text, max_segment_chars)
        gap = np.zeros(int(self.pipe.sample_rate * max(inter_segment_silence_s, 0.0)), np.float32)
        speaker_globals: Optional[np.ndarray] = None

        def continuation(segment: str) -> _Pending:
            return self._make_stream_pending(
                text=segment, prompt_wav=None, prompt_text=None, gender=None, pitch=None,
                speed=None, max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                speaker_globals=speaker_globals,
            )

        pending = self._make_stream_pending(
            text=segments[0], prompt_wav=prompt_wav, prompt_text=prompt_text, gender=gender,
            pitch=pitch, speed=speed, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p,
        )
        self.stats["requests"] += 1
        await self.waiting.put(pending)
        for i, segment in enumerate(segments):
            next_pending: Optional[_Pending] = None
            q = pending.chunk_queue
            try:
                while True:
                    chunk = await q.get()
                    if chunk is None:
                        break
                    if (next_pending is None and i + 1 < len(segments)
                            and pending.global_tokens is not None):
                        if speaker_globals is None:
                            # one host read per longform request
                            speaker_globals = self._host_globals(pending.global_tokens)
                        next_pending = continuation(segments[i + 1])
                        self.stats["requests"] += 1
                        await self.waiting.put(next_pending)
                    yield chunk
            except (GeneratorExit, asyncio.CancelledError):
                pending.cancelled = True
                if next_pending is not None:
                    next_pending.cancelled = True
                raise
            fut = pending.future
            if fut.done() and not fut.cancelled() and fut.exception() is not None:
                if next_pending is not None:
                    next_pending.cancelled = True
                raise fut.exception()
            self.stats["longform_segments"] = self.stats.get("longform_segments", 0) + 1
            if speaker_globals is None and pending.global_tokens is not None:
                speaker_globals = self._host_globals(pending.global_tokens)
            if i + 1 < len(segments):
                if next_pending is None:  # a segment with no chunk: admit now
                    next_pending = continuation(segments[i + 1])
                    self.stats["requests"] += 1
                    await self.waiting.put(next_pending)
                if gap.size:
                    yield gap
                pending = next_pending

    async def synthesize_long(self, **kw) -> np.ndarray:
        """Offline longform: `synthesize_streaming_long`'s chunks joined."""
        parts = [c async for c in self.synthesize_streaming_long(**kw)]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    # -- the streaming chunk plan and the vocode worker --------------------

    def _plan_stream_chunks(self, pending: _Pending, new_tokens: np.ndarray, final: bool):
        """Advance a stream's chunk schedule and return the vocode windows
        now due, without vocoding (worker thread).  A window is (start,
        emitted, upto, render): vocode stream_buf[start:render] and emit the
        samples of [emitted, upto).  start = emitted - stream_ctx rounded
        down to a vocode bucket: the context covers the codec's receptive
        field, and (upto - start) = upto (mod bucket) keeps detokenize's
        edge pad that of the full prefix, so the emitted tail equals a
        full-prefix vocode bit for bit."""
        tok = self.pipe.tokenizer
        if pending.global_tokens is None:
            pending.raw_buf.extend(np.asarray(new_tokens).tolist())
        pending.stream_buf.extend(extract_semantic_ids(tok, new_tokens).tolist())
        total = pending.stream_base + len(pending.stream_buf)
        windows = []

        def plan(upto: int):
            """Windows advancing emission to `upto`, split so that none
            emits more than max_vocode_window tokens past its start; a split
            piece renders stream_ctx tokens of look-ahead past its cut
            (bounded by `upto`) and emits up to the cut only."""
            while True:
                start = max(pending.stream_emitted - self.stream_ctx, 0)
                start -= start % self.pipe.vocode_bucket
                cut = min(upto, start + self.max_vocode_window)
                render = min(cut + self.stream_ctx, upto)
                windows.append((start, pending.stream_emitted, cut, render))
                pending.stream_emitted = cut
                if cut >= upto:
                    return
                self.stats["vocode_split_windows"] = self.stats.get("vocode_split_windows", 0) + 1

        while total >= pending.stream_emitted + pending.stream_target:
            plan(pending.stream_emitted + pending.stream_target)
            pending.stream_target = next(pending.stream_schedule)
        if final and total > pending.stream_emitted:
            plan(total)
        if windows and pending.global_tokens is None:
            # controllable mode: the speaker identity from the whole raw
            # stream (its globals may have come in an earlier increment)
            pending.global_tokens = self._speaker_tokens(np.asarray(pending.raw_buf, np.int32))
            pending.raw_buf.clear()
        return windows

    def _trim_stream_buf(self, pending: _Pending):
        """Drop stream_buf's dead prefix (worker thread, after the windows'
        slices are taken): later windows start at or after bucket-aligned
        stream_emitted - stream_ctx."""
        keep = max(pending.stream_emitted - self.stream_ctx, 0)
        keep -= keep % self.pipe.vocode_bucket
        if keep > pending.stream_base:
            del pending.stream_buf[: keep - pending.stream_base]
            pending.stream_base = keep

    def _speaker_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """(1, token_num) speaker ids from an emitted token stream
        (controllable mode)."""
        return padded_global_tokens(self.pipe.tokenizer, tokens,
                                    self.pipe.config.bicodec.speaker_encoder.token_num)

    def _glob_np(self, pending: _Pending) -> np.ndarray:
        """`pending`'s speaker ids as a host (1, N) int32 array, read once
        and kept on the pending.  Only a window that joins a batched group
        needs host rows; the scalar path passes device ids as they are."""
        g = self._host_globals(self._worker_globals(pending))
        pending.global_tokens, pending.global_event = g, None
        return g

    def _run_vocode_jobs(self, jobs: list, deliver=None) -> list:
        """One drain's vocode work (worker thread): plan every job's
        windows, then batch same-padded-length windows across streams into
        one vocode each.  Returns per-job result dicts aligned with `jobs`;
        errors stay with their job (a failed batch falls back to per-window
        scalar calls).  Each job's result goes to `deliver` as soon as its
        last window lands, first-audio jobs vocoded first."""
        up = self.pipe._wave_upsample
        bucket = self.pipe.vocode_bucket
        results, work, prio = [], [], []
        for i, (pending, tokens, final, offline) in enumerate(jobs):
            res = {"pending": pending, "offline": offline, "final": final,
                   "chunks": [], "wav": None, "error": None, "n_windows": 0}
            results.append(res)
            prio.append(0 if (not offline and pending.chunk_queue is not None
                              and pending.stream_emitted == 0) else 1)
            try:
                if offline:
                    sem = extract_semantic_ids(self.pipe.tokenizer, tokens)
                    if pending.gender is not None:
                        pending.global_tokens = self._speaker_tokens(tokens)
                    if sem.size == 0:
                        res["wav"] = np.zeros(0, np.float32)
                        continue
                    res["n_windows"] = 1
                    work.append((i, 0, sem.astype(np.int32), pending, 0, sem.size * up))
                else:
                    windows = self._plan_stream_chunks(pending, tokens, final)
                    res["n_windows"] = len(windows)
                    base = pending.stream_base
                    for k, (start, emitted, upto, render) in enumerate(windows):
                        # render [start, render), emit [emitted, upto)
                        sem = np.asarray(pending.stream_buf[start - base : render - base], np.int32)
                        work.append((i, k, sem, pending, (emitted - start) * up,
                                     (upto - start) * up))
                    self._trim_stream_buf(pending)
            except Exception as e:
                res["error"] = e

        out: Dict[tuple, np.ndarray] = {}
        done: set = set()

        def finish(i: int):
            if i in done:
                return
            done.add(i)
            res = results[i]
            if res["error"] is None and res["n_windows"]:
                try:
                    parts = [out[(i, k)] for k in range(res["n_windows"])]
                except KeyError as e:  # a scalar fallback also failed
                    res["error"] = e
                else:
                    if res["offline"]:
                        res["wav"] = parts[0]
                    else:
                        res["chunks"] = parts
            if deliver is not None:
                try:
                    deliver(res)
                except Exception:
                    # a loop closed by a concurrent stop(): finish the drain
                    logger.exception("vocode result delivery failed")

        for i, res in enumerate(results):  # nothing to vocode: deliver now
            if res["error"] is not None or res["n_windows"] == 0:
                finish(i)

        # group windows by padded length; each group runs in batched slices
        # of a warm (b, t_pad) signature, scalar otherwise; groups holding a
        # first-audio window go first, and such windows lead their group
        groups: Dict[int, list] = {}
        seen = _voc_state(self.pipe)["sizes_seen"]
        remaining = [r["n_windows"] for r in results]
        for w in work:
            seen.add(max(w[2].size, 1))
            groups.setdefault(_round_up(max(w[2].size, 1), bucket), []).append(w)
        ordered = sorted(groups.items(), key=lambda kv: (min(prio[w[0]] for w in kv[1]), kv[0]))
        try:
            for t_pad, ws in ordered:
                ws.sort(key=lambda w: prio[w[0]])
                idx = 0
                while idx < len(ws):
                    n = len(ws) - idx
                    b = self._pick_vocode_batch(n, t_pad) if self.vocode_batch else None
                    take = ws[idx : idx + (min(b, n) if b else 1)]
                    idx += len(take)
                    if b and len(take) >= 2:
                        try:
                            self._vocode_group(take, b, out)
                        except Exception:
                            logger.exception("batched vocode failed; scalar fallback")
                            for w in take:
                                try:
                                    self._vocode_scalar(w, out)
                                except Exception as e2:
                                    if results[w[0]]["error"] is None:
                                        results[w[0]]["error"] = e2
                    else:
                        try:
                            self._vocode_scalar(take[0], out)
                        except Exception as e:
                            if results[take[0][0]]["error"] is None:
                                results[take[0][0]]["error"] = e
                    for w in take:
                        remaining[w[0]] -= 1
                        if remaining[w[0]] <= 0 or results[w[0]]["error"] is not None:
                            finish(w[0])
        except Exception as e:
            # code outside the per-item guards (e.g. a warm thread's start)
            # must not kill the vocode task: fail this drain's open jobs
            logger.exception("vocode drain failed; failing its pending jobs")
            for i, res in enumerate(results):
                if i not in done and res["error"] is None:
                    res["error"] = e

        for i in range(len(results)):  # catch-all; a no-op when all delivered
            finish(i)
        return results

    def _vocode_scalar(self, w, out: Dict[tuple, np.ndarray]):
        job, order, sem, pending, lo, hi = w
        t0 = time.perf_counter()
        wav = self.pipe.detokenize(self._worker_globals(pending), sem[None, :])
        self.stage_stats.record("vocode", time.perf_counter() - t0)
        out[(job, order)] = wav[lo:hi]

    def _vocode_group(self, take: list, b: int, out: Dict[tuple, np.ndarray]):
        """One batched vocode of `take` (one padded length), padded with
        repeated rows up to the warm batch size `b`."""
        pad = b - len(take)
        sems = [w[2] for w in take] + [take[-1][2]] * pad
        globs = np.concatenate([self._glob_np(w[3]) for w in take]
                               + [self._glob_np(take[-1][3])] * pad, axis=0)
        t0 = time.perf_counter()
        wavs = self.pipe.detokenize_batch(globs, sems)
        self.stage_stats.record("vocode", time.perf_counter() - t0)
        for w, wav in zip(take, wavs):
            out[(w[0], w[1])] = wav[w[4] : w[5]]
        self.stats["vocode_batched_calls"] = self.stats.get("vocode_batched_calls", 0) + 1
        self.stats["vocode_batched_rows"] = self.stats.get("vocode_batched_rows", 0) + len(take)

    def _pick_vocode_batch(self, n: int, t_pad: int) -> Optional[int]:
        """The batch size for `n` same-shape windows among the warm ones:
        the smallest covering n, else the largest below n (the rest loops).
        A cold size that is wanted warms in the background meanwhile."""
        if n < 2 or not self._voc_batch_sizes:
            return None
        warm_set = _voc_state(self.pipe)["warm"]
        warm = [b for b in self._voc_batch_sizes if (b, t_pad) in warm_set]
        want = next((b for b in self._voc_batch_sizes if b >= n), self._voc_batch_sizes[-1])
        cover = [b for b in warm if b >= n]
        if cover:
            # an oversized warm batch covers n; keep warming the tight size
            if cover[0] != want:
                self._warm_vocode_batch_bg(want, t_pad)
            return cover[0]
        self._warm_vocode_batch_bg(want, t_pad)
        return warm[-1] if warm else None

    def _warm_vocode_batch_bg(self, b: int, t_pad: int):
        st = _voc_state(self.pipe)
        key = (b, t_pad)
        if key in st["warm"] or key in st["warming"]:
            return
        st["warming"].add(key)

        def go():
            try:
                warm_vocode_batch(self.pipe, b, t_pad)
            except Exception:
                logger.exception("vocode batch warm (%d, %d) failed", b, t_pad)
            finally:
                st["warming"].discard(key)

        self._spawn(f"voc-warm-{b}x{t_pad}", go)

    def _drain_vocode_jobs(self, first_item, backlog=()) -> list:
        """Everything queued, as an ordered job list: consecutive increments
        of one stream merge into one job; streams that have emitted nothing
        sort first; per-stream order holds; offline jobs never merge;
        `backlog` (jobs the previous cycle deferred) rejoins first."""
        items = list(backlog)
        if first_item is not None:
            items.append(first_item)
        while True:
            try:
                items.append(self._vocode_q.get_nowait())
            except asyncio.QueueEmpty:
                break
        jobs: list = []  # [pending, tokens, final, offline]
        stream_job: Dict[int, int] = {}  # id(pending) -> index in jobs
        for pending, tokens, final, offline in items:
            if pending.cancelled:
                continue
            j = stream_job.get(id(pending))
            if offline or pending.chunk_queue is None or j is None:
                if not offline and pending.chunk_queue is not None:
                    stream_job[id(pending)] = len(jobs)
                jobs.append([pending, np.asarray(tokens, np.int32), final, offline])
                continue
            merged = jobs[j]
            merged[1] = np.concatenate([merged[1], np.asarray(tokens, np.int32)])
            merged[2] = merged[2] or final
            self.stats["vocode_merged"] = self.stats.get("vocode_merged", 0) + 1
        jobs.sort(key=lambda job: 0 if (not job[3] and job[0].chunk_queue is not None
                                        and job[0].stream_emitted == 0) else 1)
        return jobs

    async def _vocode_loop(self):
        """Drain vocode work on the worker thread, so the codec renders a
        chunk while the engine decodes the next dispatch."""
        loop = asyncio.get_running_loop()

        def deliver(res):  # worker thread -> loop thread, one job at a time
            loop.call_soon_threadsafe(self._push_vocode_result, res)

        backlog: list = []
        deferred: set = set()
        while True:
            first = None if backlog else await self._vocode_q.get()
            jobs = self._drain_vocode_jobs(first, backlog)
            backlog = []
            if not jobs:
                continue
            if self.first_chunk_priority:
                jobs, backlog, deferred = _split_first_audio(jobs, deferred)
                if backlog:
                    self.stats["vocode_deferrals"] = (
                        self.stats.get("vocode_deferrals", 0) + len(backlog))
            try:
                await loop.run_in_executor(self._vocode_pool, self._on_worker,
                                           self._vocode_stream, self._run_vocode_jobs, jobs,
                                           deliver)
            except Exception as e:
                # a shut-down pool (stop/restart race) or an escape of the
                # drain's own containment: fail these jobs, keep the task
                logger.exception("vocode drain dispatch failed")
                self.stats["failures"] = self.stats.get("failures", 0) + 1
                for pending, *_ in jobs:
                    self._fail_pending(pending, e)

    def _push_vocode_result(self, res):
        """Hand one vocoded job to its consumer (loop thread: the queues
        and futures are not thread-safe)."""
        pending = res["pending"]
        if res["error"] is not None:
            logger.error("vocode failed", exc_info=res["error"])
            self.stats["failures"] = self.stats.get("failures", 0) + 1
            self._fail_pending(pending, res["error"])
            return
        if res["offline"]:
            self.stats["completed"] += 1
            if not pending.future.done():
                pending.future.set_result(res["wav"])
        else:
            for c in res["chunks"]:
                pending.chunk_queue.put_nowait(c)
            if res["final"]:
                pending.chunk_queue.put_nowait(None)
                self.stats["completed"] += 1
                if not pending.future.done():
                    pending.future.set_result(np.zeros(0, np.float32))

    # -- admission ---------------------------------------------------------

    def _slot_capacity(self) -> int:
        """Tokens one slot can hold (prompt + generation), either engine."""
        cap = getattr(self.engine, "cache_len", None)
        if cap is None:  # paged engine: the page table's bound
            cap = self.engine.pages_per_slot * self.engine.page_size
        return cap

    def _check_fits(self, t_pad: int, pending: _Pending):
        """Reject a request that can never fit a slot, before any warm-up or
        submit (waiting cannot help: this is not backpressure)."""
        cap = self._slot_capacity()
        if t_pad + pending.max_new_tokens > cap:
            raise RequestTooLong(
                f"prompt ({t_pad} padded ids) + max_new_tokens ({pending.max_new_tokens}) "
                f"exceeds the engine's per-slot capacity of {cap} tokens: shorten the "
                f"prompt/transcript or lower max_new_tokens"
            )

    def _clone_scaffold(self, n_glob: int, use_sem: int, pending: _Pending):
        """The bucket-padded clone prompt scaffold both the fused and the
        chained admission use, so their prompts are the same ids."""
        tok = self.pipe.tokenizer
        bucket = getattr(self.engine, "_admit_bucket", self.engine.prompt_pad)
        scaffold, prompt_len, g_off, s_off = clone_prompt_scaffold(
            tok, pending.text, n_glob, use_sem, pending.prompt_text)
        t_pad = _round_up(prompt_len, bucket)
        scaffold = np.pad(scaffold, (0, t_pad - prompt_len), constant_values=tok.pad_id)
        return scaffold, prompt_len, g_off, s_off, t_pad

    def _start_warm(self, key, thunk):
        """Warm an admission signature on a background thread, at most one
        thread per signature."""
        if key in self._fused_warming:
            return
        self._fused_warming.add(key)

        def warm():
            try:
                thunk()
            except Exception:
                logger.exception("admission warm failed for %s", key)
            finally:
                self._fused_warming.discard(key)

        self._spawn("fused-warm", warm)

    def _start_fused_warm(self, fn, assemble_fn, tok_args, t_pad):
        self._start_warm(self.engine.fused_key(tok_args, t_pad),
                         lambda: self.engine.warm_fused(fn, assemble_fn, tok_args, t_pad))

    @torch.inference_mode()
    def _admit(self, pending: _Pending) -> Optional[int]:
        # time queued, not counting the admission itself
        self.stage_stats.record("queue_wait", time.perf_counter() - pending.enqueue_time)
        tok = self.pipe.tokenizer
        prompt_len = None
        if pending.speaker_globals is not None:
            # a longform continuation: the voice is known, a globals-only
            # clone prompt (no audio tokenize)
            g = np.asarray(pending.speaker_globals, np.int32).reshape(1, -1)
            self._set_globals(pending, g)
            ids = build_clone_prompt(tok, pending.text, g)
            mode = "clone"
        elif pending.gender is not None:
            ids = build_control_prompt(tok, pending.text, pending.gender, pending.pitch,
                                       pending.speed)
            mode = "control"
        elif self.device_admission:
            vkey = self.pipe.voice_cache_key(pending.prompt_wav)
            cached = self.pipe.voice_cache_get(vkey)
            use_fused = self.fused_admission and hasattr(self.engine, "submit_fused")
            if cached is not None:
                # a voice-cache hit: the codec ids are on the device already;
                # the dense engine admits with one assembly + prefill, the
                # paged one takes the chained path below with them
                g_dev, s_dev, n_sem_true = cached
                use_sem = n_sem_true if pending.prompt_text is not None else 0
                scaffold, prompt_len, g_off, s_off, t_pad = self._clone_scaffold(
                    g_dev.shape[1], use_sem, pending)
                self._check_fits(t_pad, pending)
                if hasattr(self.engine, "submit_assembled"):
                    assemble_fn = self.pipe._assemble_fn_batch(t_pad, s_dev.shape[1])
                    if not self.engine.assembled_ready(g_dev, s_dev, t_pad):
                        if self.fused_warm == "sync":
                            self.engine.warm_assembled(assemble_fn, g_dev, s_dev, t_pad)
                        else:
                            self._start_warm(
                                self.engine.assembled_key(g_dev, s_dev, t_pad),
                                lambda: self.engine.warm_assembled(assemble_fn, g_dev, s_dev,
                                                                   t_pad))
                    if self.engine.assembled_ready(g_dev, s_dev, t_pad):
                        req_id = self.engine.submit_assembled(
                            assemble_fn, g_dev, s_dev, scaffold, g_off, s_off, use_sem,
                            prompt_len, max_new_tokens=pending.max_new_tokens,
                            temperature=pending.temperature, top_p=pending.top_p)
                        self.stats["voice_cache_admissions"] = (
                            self.stats.get("voice_cache_admissions", 0) + 1)
                        self._set_globals(pending, g_dev)
                        self.inflight[req_id] = pending
                        return req_id
                # a cold assembled signature (or the paged engine): the
                # chained admission with the cached device ids
            elif use_fused:
                # tokenize + assembly + prefill as one admission
                fn, tok_args, n_sem_true, s_pad = self.pipe.tokenize_host_prep(pending.prompt_wav)
                use_sem = n_sem_true if pending.prompt_text is not None else 0
                n_glob = self.pipe.config.bicodec.speaker_encoder.token_num
                scaffold, prompt_len, g_off, s_off, t_pad = self._clone_scaffold(
                    n_glob, use_sem, pending)
                self._check_fits(t_pad, pending)
                assemble_fn = self.pipe._assemble_fn_batch(t_pad, s_pad)
                if not self.engine.fused_ready(tok_args, t_pad):
                    if self.fused_warm == "sync":
                        self.engine.warm_fused(fn, assemble_fn, tok_args, t_pad)
                    else:
                        # warm off the loop; this request takes the chain
                        self._start_fused_warm(fn, assemble_fn, tok_args, t_pad)
                if self.engine.fused_ready(tok_args, t_pad):
                    req_id, g_dev, s_dev = self.engine.submit_fused(
                        fn, assemble_fn, tok_args, scaffold, g_off, s_off, use_sem, prompt_len,
                        max_new_tokens=pending.max_new_tokens, temperature=pending.temperature,
                        top_p=pending.top_p)
                    self.stats["fused_admissions"] = self.stats.get("fused_admissions", 0) + 1
                    self.pipe.voice_cache_put(vkey, (g_dev, s_dev, n_sem_true))
                    self._set_globals(pending, g_dev)
                    self.inflight[req_id] = pending
                    return req_id
                # a cold signature: the chained path, reusing the host prep
                # and the scaffold (fn(*tok_args) is tokenize_audio_device's
                # device half)
                g_dev, s_dev = fn(*tok_args)
                self.pipe.voice_cache_put(vkey, (g_dev, s_dev, n_sem_true))
            else:
                # the chained admission: codec ids stay on the device, the
                # prompt is assembled there, prefill follows with no host read
                g_dev, s_dev, n_sem = self.pipe.tokenize_audio_device(pending.prompt_wav,
                                                                      cache_key=vkey)
                use_sem = n_sem if pending.prompt_text is not None else 0
                scaffold, prompt_len, g_off, s_off, t_pad = self._clone_scaffold(
                    g_dev.shape[1], use_sem, pending)
                self._check_fits(t_pad, pending)
            self._set_globals(pending, g_dev)
            ids = self.pipe.assemble_clone_ids(scaffold, g_dev, s_dev, g_off, s_off, use_sem)
            mode = "clone"
        else:
            g, s = self.pipe.tokenize_audio(pending.prompt_wav)
            self._set_globals(pending, g)
            ids = build_clone_prompt(tok, pending.text, g,
                                     s if pending.prompt_text is not None else None,
                                     pending.prompt_text)
            mode = "clone"
        if prompt_len is None:  # a host-built id list (control / plain clone)
            bucket = getattr(self.engine, "_admit_bucket", self.engine.prompt_pad)
            self._check_fits(_round_up(len(ids), bucket), pending)
        req_id = self.engine.submit(ids, max_new_tokens=pending.max_new_tokens, mode=mode,
                                    temperature=pending.temperature, top_p=pending.top_p,
                                    prompt_len=prompt_len)
        self.inflight[req_id] = pending
        return req_id

    def _finish(self, req_id: int, tokens: np.ndarray):
        pending = self.inflight.pop(req_id)
        if pending.chunk_queue is not None:
            self._vocode_q.put_nowait((pending, np.zeros(0, np.int32), True, False))
        else:
            self._vocode_q.put_nowait((pending, tokens, True, True))

    def _fail_pending(self, pending: _Pending, exc: Exception):
        """Fail a request whichever way it waits (future or chunk queue),
        and mark it cancelled so the loop frees its decode slot."""
        pending.cancelled = True
        if not pending.future.done():
            pending.future.set_exception(exc)
        if pending.chunk_queue is not None:
            pending.chunk_queue.put_nowait(None)

    # -- dispatch sizing and the speculative first chunk -------------------

    def _requested_steps(self) -> Optional[int]:
        """The next dispatch's size: a streaming slot whose first chunk is
        not covered yet caps it at that distance, every other slot asks for
        its remaining budget.  With more than one live slot (or arrivals
        waiting) it is capped at the absolute co_dispatch_cap; a lone slot
        that had company within arrival_window_s at anticipation_cap; a lone
        stream before its first chunk rounds up to the covering rung (within
        2x), so the first chunk rides one dispatch.  None when every live
        slot's budget is covered by dispatches in flight."""
        need = None
        active = 0
        first_chunk_bound = False
        for slot, req in enumerate(self.engine.owner):
            if req is None:
                continue
            active += 1
            # what is left after the dispatches in flight
            remaining = int(self.engine.budget[slot]) - self._planned_ahead[slot]
            if remaining <= 0:
                continue
            p = self.inflight.get(req)
            slot_first = False
            if p is not None and p.chunk_queue is not None:
                covered = p.loop_tokens + self._planned_ahead[slot]
                first_need = p.first_target
                if p.gender is not None:
                    # controllable mode emits its speaker identity first
                    first_need += self.pipe.config.bicodec.speaker_encoder.token_num + 2
                if covered < first_need:
                    slot_need = max(min(first_need - covered, remaining), 1)
                    slot_first = True
                else:
                    slot_need = remaining
            else:
                slot_need = remaining
            if need is None or slot_need < need:
                need, first_chunk_bound = slot_need, slot_first
            elif slot_need == need:
                first_chunk_bound = first_chunk_bound or slot_first
        if need is None:
            return None if active else self.steps
        if active > 1 or self._deferred or not self.waiting.empty():
            self._last_concurrent = time.perf_counter()
            need = min(need, self.co_dispatch_cap)
        elif time.perf_counter() - self._last_concurrent < self.arrival_window_s:
            need = min(need, self.anticipation_cap)
        elif first_chunk_bound:
            need = snap_to_ladder(need, self.steps, overshoot=need)
        return need

    def _plan_spec(self, n_dispatch: int):
        """Every streaming slot whose first chunk this dispatch covers, for
        the speculative chain (one batched vocode behind the decode
        dispatch, fetched with its tokens).  Clone slots take their first
        `target` emissions as semantic ids; controllable slots the trained
        layout (start marker, token_num globals, end marker, semantic ids).
        Each row is validated at commit (`_apply_specs`).  Returns (entries,
        chain_fn) or None; an entry is (req_id, slot, target, sem_off,
        control)."""
        if not self.spec_first_chunk:
            return None
        tn = self.pipe.config.bicodec.speaker_encoder.token_num
        entries = []
        for slot, req in enumerate(self.engine.owner):
            if req is None:
                continue
            p = self.inflight.get(req)
            if (p is None or p.cancelled or p.chunk_queue is None
                    or p.loop_increments  # an earlier increment exists
                    or self._planned_ahead[slot]):  # a dispatch in flight covers its head
                continue
            control = p.gender is not None
            if control:
                off = tn + 2
            elif p.global_tokens is not None:
                off = 0
            else:
                continue
            target = p.stream_target
            if entries and target != entries[0][2]:
                continue  # one (batch, t_pad) chain per dispatch
            budget = int(self.engine.budget[slot]) - self._planned_ahead[slot]
            if 0 < off + target <= min(n_dispatch, budget):
                entries.append((req, slot, target, off, control))
        if not entries:
            return None
        n_spec, batch = self._spec_batch(len(entries), entries[0][2], n_dispatch)
        if n_spec < 1:
            return None
        entries = entries[:n_spec]
        chain = self.pipe.spec_vocode_chain_multi(
            [(slot, target, off, None if control else self.inflight[req].global_tokens)
             for req, slot, target, off, control in entries],
            batch,
        )
        return entries, chain

    def _spec_batch(self, n: int, target: int, n_dispatch: int):
        """(n_spec, batch) for a chain of `n` eligible slots over warm
        signatures only: slots past the largest warm batch take the normal
        vocode path while the wanted size warms ((0, 0): no warm one)."""
        # the spec window length counts as seen for the follow-up drains
        _voc_state(self.pipe)["sizes_seen"].add(max(target, 1))
        t_pad = _round_up(max(target, 1), self.pipe.vocode_bucket)
        warm_set = _voc_state(self.pipe).setdefault("spec_warm", set())
        sizes = [1] + [b for b in VOCODE_BATCH_LADDER if b <= max(self.engine.max_slots, 2)]
        warm = [b for b in sizes if (b, target, t_pad, n_dispatch) in warm_set]
        want = next((b for b in sizes if b >= n), sizes[-1])
        if (want, target, t_pad, n_dispatch) not in warm_set:
            if self.fused_warm == "sync":
                warm_spec_chain(self.pipe, self.engine.max_slots, want, target, n_dispatch)
                warm.append(want)
            else:
                self._warm_spec_chain_bg(want, target, n_dispatch)
        cover = [b for b in warm if b >= n]
        if cover:
            return n, cover[0]
        if warm:
            return warm[-1], warm[-1]
        return 0, 0

    def _warm_spec_chain_bg(self, batch: int, target: int, n_dispatch: int):
        """Warm a speculative-chain signature in the background; until it
        lands, first chunks take the normal vocode path."""
        st = _voc_state(self.pipe)
        key = (batch, target, _round_up(max(target, 1), self.pipe.vocode_bucket), n_dispatch)
        warm_set = st.setdefault("spec_warm", set())
        warming = st.setdefault("spec_warming", set())
        if key in warm_set or key in warming:
            return
        warming.add(key)

        def go():
            try:
                warm_spec_chain(self.pipe, self.engine.max_slots, batch, target, n_dispatch)
            except Exception:
                logger.exception("spec chain warm %s failed", key)
            finally:
                warming.discard(key)

        self._spawn(f"spec-warm-{batch}x{target}", go)

    def _apply_specs(self, spec, chained: np.ndarray, increments) -> set:
        """Validate each speculative first chunk against the fetched tokens;
        a valid one is pushed and its stream bookkeeping done here.  Returns
        the request ids consumed (the normal vocode path skips those
        increments).  A row misses when EOS fired inside its window or, for
        a controllable stream, when the emission left the trained layout;
        the normal path then renders its valid prefix."""
        entries, _ = spec
        tok = self.pipe.tokenizer
        tn = self.pipe.config.bicodec.speaker_encoder.token_num
        up = self.pipe._wave_upsample
        start_id = tok.token_id("<|start_global_token|>")
        end_id = tok.token_id("<|end_global_token|>")
        consumed: set = set()
        off_samp = 0
        for req_id, slot, target, off, control in entries:
            bits = chained[off_samp : off_samp + target * up]
            off_samp += target * up
            p = self.inflight.get(req_id)
            new = increments.get(req_id)
            if p is None or p.cancelled or new is None or len(new) < off + target:
                continue
            new = np.asarray(new)
            head = new[off : off + target]
            if not ((head >= tok.semantic_base) & (head < tok.semantic_base + tok.n_semantic)).all():
                continue
            if control:
                globs = new[1 : 1 + tn]
                if not (new[0] == start_id and new[1 + tn] == end_id
                        and ((globs >= tok.global_base)
                             & (globs < tok.global_base + tok.n_global)).all()):
                    continue
                # the chain rendered with exactly these speaker ids
                self._set_globals(p, (globs - tok.global_base).astype(np.int32)[None, :])
            wav = bits.view(np.float32).copy()
            p.stream_buf.extend(extract_semantic_ids(tok, new).tolist())
            p.stream_emitted = target
            p.stream_target = next(p.stream_schedule)
            p.chunk_queue.put_nowait(wav)
            p.loop_increments += 1
            consumed.add(req_id)
            self.stats["spec_chunks"] = self.stats.get("spec_chunks", 0) + 1
            # a dispatch that over-covered the first chunk: hand the rest to
            # the vocode worker now, as the plain path would
            if p.stream_base + len(p.stream_buf) >= p.stream_emitted + p.stream_target:
                self._vocode_q.put_nowait((p, np.zeros(0, np.int32), False, False))
        return consumed

    # -- burst admission ---------------------------------------------------

    def _prep_cache_hit_row(self, pending: _Pending):
        """A voice-cache-hit clone admission as a batched-admission row, or
        None when the pending does not qualify."""
        if (pending.speaker_globals is not None or pending.gender is not None
                or not self.device_admission):
            return None
        cached = self.pipe.voice_cache_get(self.pipe.voice_cache_key(pending.prompt_wav))
        if cached is None:
            return None
        g_dev, s_dev, n_sem_true = cached
        use_sem = n_sem_true if pending.prompt_text is not None else 0
        scaffold, prompt_len, g_off, s_off, t_pad = self._clone_scaffold(
            g_dev.shape[1], use_sem, pending)
        self._check_fits(t_pad, pending)
        return dict(global_t=g_dev, semantic=s_dev, scaffold=scaffold, g_off=g_off, s_off=s_off,
                    n_sem=use_sem, prompt_len=prompt_len, max_new_tokens=pending.max_new_tokens,
                    temperature=pending.temperature, top_p=pending.top_p)

    def _prep_fused_row(self, pending: _Pending):
        """A first-time (cache-miss) clone admission as a batched fused
        admission row, or None when the pending does not qualify."""
        if (pending.speaker_globals is not None or pending.gender is not None
                or not self.device_admission or not self.fused_admission):
            return None
        vkey = self.pipe.voice_cache_key(pending.prompt_wav)
        fn, tok_args, n_sem_true, s_pad = self.pipe.tokenize_host_prep(pending.prompt_wav)
        use_sem = n_sem_true if pending.prompt_text is not None else 0
        n_glob = self.pipe.config.bicodec.speaker_encoder.token_num
        scaffold, prompt_len, g_off, s_off, t_pad = self._clone_scaffold(n_glob, use_sem, pending)
        self._check_fits(t_pad, pending)
        return dict(tok_args=tok_args, tokenize_fn=fn, s_pad=s_pad, n_sem_true=n_sem_true,
                    vkey=vkey, scaffold=scaffold, g_off=g_off, s_off=s_off, n_sem=use_sem,
                    prompt_len=prompt_len, max_new_tokens=pending.max_new_tokens,
                    temperature=pending.temperature, top_p=pending.top_p)

    @torch.inference_mode()
    def _admit_burst(self, pendings: list) -> list:
        """Admit a burst of waiting requests as batched admissions:
        voice-cache-hit clones of one (n_glob, S_pad, t_pad) signature
        through `submit_assembled_batch`, first-time clones of one (wav
        bucket, t_pad) signature through `submit_fused_batch` (with a voice
        cache fill per row).  Outside fused_warm="sync" only warm batch
        signatures are used (a cold one warms in the background and the
        burst takes the single path).  Returns the pendings not admitted
        here, in arrival order."""
        eng = self.engine
        if len(pendings) < 2 or not hasattr(eng, "submit_assembled_batch"):
            return pendings
        groups: Dict[tuple, list] = {}
        passthrough = {id(p) for p in pendings}
        for p in pendings:
            try:
                row = self._prep_cache_hit_row(p)
                kind = "asm"
                if row is None and getattr(eng, "mesh", None) is None:
                    row = self._prep_fused_row(p)
                    kind = "fus"
            except Exception as e:
                self._fail_pending(p, e)
                passthrough.discard(id(p))
                continue
            if row is None:
                continue
            if kind == "asm":
                sig = ("asm", row["global_t"].shape[-1], row["semantic"].shape[-1],
                       len(row["scaffold"]))
            else:
                _, _, wav, mask, ref = row["tok_args"]
                sig = ("fus", wav.shape[-1], mask.shape[-1], ref.shape[-1], row["s_pad"],
                       len(row["scaffold"]))
            groups.setdefault(sig, []).append((p, row))
        busy = any(o is not None for o in eng.owner)
        for sig, items in groups.items():
            if len(items) < 2:
                continue
            b = next((x for x in ADMIT_BATCH_LADDER if x >= len(items)), ADMIT_BATCH_LADDER[-1])
            items = items[:b]
            rows = [row for _, row in items]
            t_pad = len(rows[0]["scaffold"])
            if sig[0] == "asm":
                asig = sig[1:]
                assemble_fn = self.pipe._assemble_fn_batch(t_pad, asig[1])
                ready = eng.assembled_batch_ready(b, *asig)
                warm_key = eng.assembled_batch_key(b, *asig)
                warm = lambda a=assemble_fn, b_=b, s=asig: eng.warm_assembled_batch(a, b_, *s)  # noqa: E731
                submit = lambda a=assemble_fn, r=rows: (eng.submit_assembled_batch(a, r), None, None)  # noqa: E731
            else:
                assemble_fn = self.pipe._assemble_fn_batch(t_pad, rows[0]["s_pad"])
                tokenize_fn = rows[0]["tokenize_fn"]
                ready = eng.fused_batch_ready(b, rows[0]["tok_args"], t_pad)
                warm_key = eng.fused_batch_key(b, rows[0]["tok_args"], t_pad)
                warm = lambda tf=tokenize_fn, a=assemble_fn, b_=b, ta=rows[0]["tok_args"], tp=t_pad: (  # noqa: E731
                    eng.warm_fused_batch(tf, a, b_, ta, tp))
                submit = lambda tf=tokenize_fn, a=assemble_fn, r=rows: eng.submit_fused_batch(tf, a, r)  # noqa: E731
            if not ready:
                if self.fused_warm == "sync":
                    warm()
                else:
                    self._start_warm(warm_key, warm)
                    continue  # this burst takes the single path
            t0 = time.perf_counter()
            try:
                req_ids, global_t, semantic = submit()
            except Exception as e:
                logger.exception("batched admission failed; failing its pendings")
                for p, _ in items:
                    self._fail_pending(p, e)
                    passthrough.discard(id(p))
                continue
            dt = time.perf_counter() - t0
            for i, ((p, row), req_id) in enumerate(zip(items, req_ids)):
                self.stage_stats.record("queue_wait", t0 - p.enqueue_time)
                self.stage_stats.record("admit_prefill", dt / len(items))
                if sig[0] == "asm":
                    self._set_globals(p, row["global_t"])
                else:
                    g_row, s_row = global_t[i : i + 1], semantic[i : i + 1]
                    self._set_globals(p, g_row)
                    self.pipe.voice_cache_put(row["vkey"], (g_row, s_row, row["n_sem_true"]))
                self.inflight[req_id] = p
                passthrough.discard(id(p))
                if busy:
                    self.stats["admitted_midflight"] += 1
                busy = True
            self._last_concurrent = time.perf_counter()
            stat = "voice_cache_admissions" if sig[0] == "asm" else "fused_admissions"
            self.stats[stat] = self.stats.get(stat, 0) + len(items)
            self.stats["batched_admissions"] = self.stats.get("batched_admissions", 0) + len(items)
        return [p for p in pendings if id(p) in passthrough]

    def _try_admit(self, pending: _Pending, engine_idle: bool) -> bool:
        """Admit one request; False when it was deferred (paged
        backpressure).  A deferral with an idle engine is a failure: the
        request alone exceeds the pool."""
        busy = any(o is not None for o in self.engine.owner)
        try:
            t0 = time.perf_counter()
            self._admit(pending)
            self.stage_stats.record("admit_prefill", time.perf_counter() - t0)
            if busy:
                self.stats["admitted_midflight"] += 1
                self._last_concurrent = time.perf_counter()
            return True
        except AdmissionDeferred as e:
            if engine_idle:
                logger.error("request exceeds the page pool even alone: %s", e)
                self._fail_pending(pending, e)
                return True
            self.stats["deferrals"] += 1
            self._deferred.append(pending)
            return False
        except Exception as e:
            logger.exception("admission failed")
            self._fail_pending(pending, e)
            return True

    async def _admit_while_fetching(self, fetch_fut):
        """Admit arrivals while a decode fetch blocks its worker thread: an
        admission's device work queues behind the dispatch in flight, so a
        mid-decode arrival joins the very next dispatch."""
        while not fetch_fut.done():
            if self.engine.free_slots() <= 0 or self._deferred:
                # no room, or deferred admissions retry after a commit
                await asyncio.wait({fetch_fut})
                return
            getter = asyncio.ensure_future(self.waiting.get())
            try:
                await asyncio.wait({fetch_fut, getter}, return_when=asyncio.FIRST_COMPLETED)
            except asyncio.CancelledError:
                getter.cancel()  # stop(): leak no queue getter
                raise
            if not getter.done():
                getter.cancel()
                try:
                    pending = await getter  # it won the race with the cancel
                except asyncio.CancelledError:
                    # the getter's own cancel (fetch done) or stop() cancelling
                    # this task here: swallowing the latter would hang stop()
                    task = asyncio.current_task()
                    if task is not None and task.cancelling():
                        raise
                    return
            else:
                pending = getter.result()
            # let the rest of a burst land, so it admits through one prefill
            await asyncio.sleep(0)
            burst = [pending]
            while self.engine.free_slots() - len(burst) > 0 and not self.waiting.empty():
                burst.append(self.waiting.get_nowait())
            for p in self._admit_burst(burst):
                self._try_admit(p, engine_idle=False)

    # -- the loop ----------------------------------------------------------

    def _deliver_step(self, increments, chained, spec, before):
        """Host delivery of a committed step: token accounting for dispatch
        sizing, the speculative first chunks, vocode handoff for streaming
        consumers, finishes.  Host bookkeeping only, so also safe from the
        loop's cancellation handler."""
        for req_id, new_tokens in increments.items():
            p = self.inflight.get(req_id)
            if p is not None:
                p.loop_tokens += len(new_tokens)
        spec_reqs = (self._apply_specs(spec, chained, increments)
                     if spec is not None and chained is not None else set())
        for req_id, new_tokens in increments.items():
            if req_id in spec_reqs:
                continue
            pending = self.inflight.get(req_id)
            if pending is not None and pending.chunk_queue is not None:
                pending.loop_increments += 1
                self._vocode_q.put_nowait((pending, new_tokens, False, False))
        for req_id in set(self.engine.finished) - before:
            self._finish(req_id, self.engine.finished.pop(req_id))

    @torch.inference_mode()
    def _dispatch_one(self):
        """Queue one sized decode dispatch (with its speculative chain) and
        book it in the planned-token ledger.  Returns (handle, spec, t0), or
        None when no dispatch is useful."""
        req_steps = self._requested_steps()
        if req_steps is None:
            return None
        spec = self._plan_spec(snap_to_ladder(req_steps, self.engine.max_dispatch))
        t0 = time.perf_counter()
        handle = self.engine.step_begin(req_steps, spec[1] if spec else None)
        if handle is None:
            return None
        n_snapped = handle[2]
        for slot, req in enumerate(handle[3]):
            if req is not None:
                self._planned_ahead[slot] += n_snapped
        return handle, spec, t0

    @torch.inference_mode()
    def _commit_one(self, entry, fetched):
        """Commit one fetched dispatch: release its ledger bookings, the
        engine's bookkeeping, then delivery."""
        handle, spec, t0 = entry
        n_snapped = handle[2]
        for slot, req in enumerate(handle[3]):
            if req is not None:
                self._planned_ahead[slot] = max(self._planned_ahead[slot] - n_snapped, 0)
        before = set(self.engine.finished)
        increments, chained = self.engine.step_commit(handle, fetched)
        self.stage_stats.record("decode_dispatch", time.perf_counter() - t0)
        self._deliver_step(increments, chained, spec, before)

    def _drain_window_blocking(self, window: deque, cfut):
        """Commit and deliver every dispatch in flight at shutdown (blocking
        fetches on this thread): the dispatches already advanced the device
        state, so the host bookkeeping must follow, or a restart resumes
        with their tokens missing (and the paged engine's page counts
        short)."""
        for i, entry in enumerate(window):
            try:
                if i == 0 and cfut is not None:
                    fetched = cfut.result(timeout=120)
                else:
                    fetched = self.engine.step_fetch(entry[0])
                self._commit_one(entry, fetched)
            except Exception:
                logger.exception("step commit during shutdown failed")
        window.clear()

    async def _loop(self):
        # dispatches in flight, oldest first
        window: deque = deque()
        self._planned_ahead = [0] * len(self._planned_ahead)
        while True:
            # admit as many waiting requests as slots (and pages) allow;
            # deferred ones first, to keep arrival order
            n_free = self.engine.free_slots()
            if n_free > 0 and (self._deferred or not self.waiting.empty()):
                burst = []
                while len(burst) < n_free and (self._deferred or not self.waiting.empty()):
                    burst.append(self._deferred.popleft() if self._deferred
                                 else self.waiting.get_nowait())
                leftover = self._admit_burst(burst)
                for i, pending in enumerate(leftover):
                    idle = all(o is None for o in self.engine.owner) and not window
                    if not self._try_admit(pending, engine_idle=idle):
                        # deferred: the rest follows it in arrival order
                        self._deferred.extend(leftover[i + 1:])
                        break

            # finishes a failed cancel-time delivery left behind
            for req_id in [r for r in self.engine.finished if r in self.inflight]:
                self._finish(req_id, self.engine.finished.pop(req_id))

            if all(o is None for o in self.engine.owner) and not window:
                # idle: wait for the next request; the yield lets the rest of
                # a burst land so it admits through one batched prefill
                pending = await self.waiting.get()
                await asyncio.sleep(0)
                burst = [pending]
                while self.engine.free_slots() - len(burst) > 0 and not self.waiting.empty():
                    burst.append(self.waiting.get_nowait())
                leftover = self._admit_burst(burst)
                for p in leftover:
                    idle = all(o is None for o in self.engine.owner)
                    self._try_admit(p, engine_idle=idle and len(burst) == 1)
                continue

            cfut = None
            try:
                # top up the window, then fetch the oldest dispatch on the
                # fetch worker and admit arrivals meanwhile
                while len(window) < self.dispatch_depth:
                    entry = self._dispatch_one()
                    if entry is None:
                        break
                    window.append(entry)
                if not window:
                    await asyncio.sleep(0)
                    continue
                entry = window.popleft()
                cfut = self._fetch_pool.submit(self._on_worker, self._fetch_stream,
                                               self.engine.step_fetch, entry[0])
                try:
                    fetch_fut = asyncio.wrap_future(cfut)
                    await self._admit_while_fetching(fetch_fut)
                    fetched = await fetch_fut
                except asyncio.CancelledError:
                    # stop() mid-step: commit every dispatch in flight
                    window.appendleft(entry)
                    self._drain_window_blocking(window, cfut)
                    raise
                self._commit_one(entry, fetched)
            except Exception as e:
                # an engine failure must not kill the loop: fail every request
                # in flight and keep serving
                logger.exception("engine step failed; failing inflight requests")
                for req_id in list(self.inflight):
                    self._fail_pending(self.inflight.pop(req_id), e)
                for slot, owner in enumerate(self.engine.owner):
                    if owner is not None:
                        self.engine.release_slot(slot)
                window.clear()
                self._planned_ahead = [0] * len(self._planned_ahead)
                self.stats["failures"] = self.stats.get("failures", 0) + 1
                continue
            # free the slots of streams whose consumer went away
            for req_id, p in list(self.inflight.items()):
                if p.cancelled:
                    self.inflight.pop(req_id)
                    if req_id in self.engine.owner:
                        self.engine.release_slot(self.engine.owner.index(req_id))
                    self.engine.finished.pop(req_id, None)
            if "pages_in_use" in self.stats:
                self.stats["pages_in_use"] = self.engine.pages_in_use()
                self.stats["pages_free"] = len(self.engine.free_pages)
            try:
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                # stop() between iterations with dispatches still in flight
                self._drain_window_blocking(window, None)
                raise
