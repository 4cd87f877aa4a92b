"""One run of a cell: set-up, the measured window, the drain, the trace
slice, and the comparison with the reference.

The system under test is `sparktts_tpu_torch`'s `ContinuousTTSServer` over
a `SparkTTSPipeline`, built as the configuration's file says (its `server`
keys are the only constructor arguments given; the rest keep their
defaults), on weights the benchmark makes from the seed.  A closed loop of
clients drives it: each sends its next request when the last has returned,
while the window is open, and each request is a whole utterance
(`synthesize`).  Requests sent inside the window are drained after it
closes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.harness import check, stats, traffic
from perfbench.harness import weights as bw
from perfbench.harness.probe import CURRENT, Probe
from perfbench.harness.trace import Slice
from perfbench.reference import qwen as ref_lm
from perfbench.reference.prompt import Layout

logger = logging.getLogger("perfbench")

GREEDY_TOP_P = 1e-6  # the nucleus holds the top id alone: a greedy request
WARM_CLIENT_OFFSET = 1 << 20  # the warm pass's traffic streams, apart from the window's
LOWER = {"bfloat16": "int8", "int8": "int4"}  # the control: one step below the stated precision
VOCODE_BUCKET = 50  # the codec's edge-padding bucket in semantic ids (the server's)
DRAIN_S = 60.0  # how long past the window's close its requests may take to come
SLICE_S = 2.0  # the traced slice's length: ~1 M device events, a trace of ~0.3 GB
CODEC_SAMPLE = 12  # requests whose audio the reference renders, besides the longest


@dataclasses.dataclass
class Options:
    device: str = "cuda"
    lm_dtype: torch.dtype = torch.bfloat16
    control: Tuple[str, ...] = ()  # the controls switched on: "lm", "codec"
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up seconds by phase

    def mark(self, name: str) -> None:
        """Book the seconds since the last mark under `name`."""
        now = time.perf_counter()
        self.phases[name] = now - self.phases.pop("_last", now)
        self.phases["_last"] = now


def program_config(cfg: Dict):
    """The program's config tree from the configuration's published files."""
    from sparktts_tpu_torch.config import (
        SparkTTSConfig,
        SamplingConfig,
        bicodec_config_from_dict,
        qwen_config_from_dict,
        wav2vec2_config_from_dict,
    )

    s = cfg["sampling"]
    return SparkTTSConfig(
        llm=qwen_config_from_dict(cfg["llm"]),
        bicodec=bicodec_config_from_dict(cfg["bicodec"]),
        wav2vec2=wav2vec2_config_from_dict(cfg["wav2vec2"]),
        sampling=SamplingConfig(temperature=s["temperature"], top_k=s["top_k"], top_p=s["top_p"]),
    )


def layout_of(cfg: Dict) -> Layout:
    b = cfg["bicodec"]
    return Layout(b["quantizer"]["codebook_size"],
                  int(np.prod(b["speaker_encoder"]["fsq_levels"])))


def templates(pcfg, lm_dtype):
    """The program's tree layouts, on the `meta` device (no memory, no values)."""
    from sparktts_tpu_torch.weights import init_bicodec, init_qwen, init_wav2vec2

    return (init_qwen(pcfg.llm, None, lm_dtype, "meta"), init_bicodec(pcfg.bicodec, None, "meta"),
            init_wav2vec2(pcfg.wav2vec2, None, "meta"))


def silence_of(layout: Layout, vocab: int) -> List[int]:
    """The embedding rows made zero: EOS, the four structure markers voice
    creation may emit, and every global id (`weights.py`)."""
    markers = [layout.special[f"<|{t}|>"] for t in ("start_global_token", "end_global_token",
                                                    "start_semantic_token", "end_semantic_token")]
    globals_ = range(layout.global_base, layout.global_base + layout.n_global)
    return bw.silenced_rows(vocab, [layout.eos], [*markers, *globals_])


def lm_scheme(cfg: Dict, control: Tuple[str, ...]) -> str:
    scheme = cfg["precision"]["lm"]
    return LOWER[scheme] if "lm" in control else scheme


def build(cfg: Dict, seed: int, opts: Options):
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int4, quantize_qwen_int8
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    opts.mark("imports")
    pcfg = program_config(cfg)
    layout = layout_of(cfg)
    t_lm, t_codec, t_w2v = templates(pcfg, opts.lm_dtype)
    dev = torch.device(opts.device)
    llm = bw.lm_weights(t_lm, seed, dev, opts.lm_dtype, silence_of(layout, pcfg.llm.vocab_size))
    codec, w2v = bw.codec_weights(t_codec, seed, dev), bw.wav2vec2_weights(t_w2v, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    opts.mark("weights")
    pipe = SparkTTSPipeline(config=pcfg, device=dev, lm_dtype=opts.lm_dtype, llm_params=llm,
                            bicodec_params=codec, wav2vec2_params=w2v)
    del llm, codec, w2v
    scheme = lm_scheme(cfg, opts.control)
    if scheme == "int8":
        pipe.llm_params = quantize_qwen_int8(pipe.llm_params)
    elif scheme == "int4":
        pipe.llm_params = quantize_qwen_int4(pipe.llm_params, group=cfg["precision"]["int4_group"])
    server = ContinuousTTSServer(pipe, **cfg["server"])
    probe = Probe(server, cfg["llm"], len(layout.control_allowed()))
    opts.mark("pipeline")
    return pipe, server, probe, layout


def _request_kwargs(req: traffic.Request) -> Dict:
    return dict(text=req.text, gender=req.gender, pitch=req.pitch, speed=req.speed,
                max_new_tokens=req.budget, top_p=GREEDY_TOP_P if req.greedy else None)


class Window:
    """The closed loop: every client's requests, what they delivered, when."""

    def __init__(self, server, mix: Dict, seed: int, client_offset: int = 0):
        self.server, self.mix, self.seed = server, mix, seed
        self.offset = client_offset
        self.served: Dict[tuple, stats.Served] = {}
        self.requests: Dict[tuple, traffic.Request] = {}
        self.audio: Dict[tuple, List[np.ndarray]] = {}

    async def one(self, key, req) -> None:
        rec = stats.Served(submitted=time.perf_counter())
        self.served[key], self.requests[key], self.audio[key] = rec, req, []
        CURRENT.set(key)
        try:
            wav = await self.server.synthesize(**_request_kwargs(req))
            rec.done = time.perf_counter()
            rec.chunks.append((rec.done, len(wav)))
            self.audio[key].append(np.asarray(wav, np.float32))
        except Exception:
            logger.exception("request %s failed", key)
            rec.failed = True

    async def client(self, c: int, until: float, count: Optional[int] = None) -> None:
        gen = traffic.requests(self.mix, self.seed, c + self.offset)
        n = 0
        while time.perf_counter() < until and (count is None or n < count):
            req = next(gen)
            await self.one((c, req.index), req)
            n += 1

    def launch(self, until: float, count: Optional[int] = None) -> List[asyncio.Task]:
        return [asyncio.create_task(self.client(c, until, count))
                for c in range(self.mix["clients"])]


async def _warm(server, pipe, mix: Dict, seed: int, slots: int, opts: Options) -> None:
    """Every shape the cell's traffic can reach, run once before the window:
    the decode units (captured at `start`), one request from each client,
    then the batched vocode at every padded length the mix can give and
    every batch size the server may pick, so that nothing warms in the
    background inside the window."""
    from sparktts_tpu_torch.serve.continuous_server import VOCODE_BATCH_LADDER, warm_vocode_batch

    await server.start()
    opts.mark("start (decode units)")
    longest = max(mix["budgets"])
    warm = Window(server, mix, seed, WARM_CLIENT_OFFSET)
    await asyncio.gather(*warm.launch(math.inf, count=1))
    if any(r.failed for r in warm.served.values()):
        raise RuntimeError("a warm-up request failed")
    opts.mark("warm requests")
    bucket = pipe.vocode_bucket
    for t_pad in range(bucket, -(-longest // bucket) * bucket + 1, bucket):
        for b in VOCODE_BATCH_LADDER:
            if b <= max(slots, 2):
                warm_vocode_batch(pipe, b, t_pad)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    opts.mark("vocode batches")
    server.stage_stats.reset()


async def _measure(server, pipe, probe, mix: Dict, seed: int, seconds: float, trace: bool,
                   opts: Options, setup_t0: float) -> Dict:
    slots = server.engine.max_slots
    await _warm(server, pipe, mix, seed, slots, opts)
    win = Window(server, mix, seed)
    t0 = time.perf_counter()
    setup_s = t0 - setup_t0
    t1 = t0 + seconds
    tasks = win.launch(t1)
    at_close: Dict = {}
    slice_ = Slice() if trace else None

    async def close_snapshot():
        await asyncio.sleep(max(t1 - time.perf_counter(), 0))
        at_close["stage"] = server.stage_stats.summary()

    async def traced_slice():
        start = t0 + max(0.0, min(0.3 * seconds, seconds - SLICE_S - 0.1))
        await asyncio.sleep(max(start - time.perf_counter(), 0))
        slice_.begin()
        await asyncio.sleep(min(SLICE_S, seconds))
        slice_.end()

    side = [asyncio.create_task(close_snapshot())]
    if trace:
        side.append(asyncio.create_task(traced_slice()))
    await asyncio.gather(*side)
    done, pending = await asyncio.wait(tasks, timeout=max(t1 + DRAIN_S - time.perf_counter(),
                                                          1.0))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    peak = torch.cuda.max_memory_allocated(pipe.device) if pipe.device.type == "cuda" else 0
    await server.stop()
    return dict(win=win, t0=t0, t1=t1, setup_s=setup_s, at_close=at_close, slice=slice_, peak=peak)


def end_to_end(win: Window, t0: float, t1: float, rate: int, setup_s: float) -> Dict[str, float]:
    served = list(win.served.values())
    out = {"setup_s": setup_s,
           "audio_s_per_s": stats.audio_seconds(served, t0, t1, rate) / (t1 - t0)}
    lat = stats.latencies_ms(served, t0, t1)
    if lat:
        out["latency_p90_ms"] = stats.percentile(lat, 90)
    return out


def layer_records(m: Dict, probe: Probe, cfg: Dict, sample_rate: int, slots: int) -> Dict:
    """What the per-layer readers read: the window's counts and the trace
    slice's reduction."""
    t0, t1 = m["t0"], m["t1"]
    stage = m["at_close"].get("stage", {})
    rec = {"config": cfg, "slots": slots, "window_s": t1 - t0, "sample_rate": sample_rate,
           "steps": probe.steps_in(t0, t1), "lm_flops": probe.lm_flops_in(t0, t1),
           "stage": stage, "trace": None}
    sl = m["slice"]
    if sl is not None:
        red = sl.read(list(probe.spans))
        red["vocoded_samples"] = probe.vocoded_samples_in(sl.t0, sl.t1)
        rec["trace"] = red
    return rec


def correctness(m: Dict, probe: Probe, cfg: Dict, layout: Layout, seed: int, opts: Options,
                pcfg) -> Dict:
    """Compare what the window served with the reference (module `check`)."""
    win, t0, t1 = m["win"], m["t0"], m["t1"]
    keys = [k for k, r in win.served.items() if stats.in_window(r, t0, t1)]
    lost = [k for k in keys if win.served[k].failed or win.served[k].done is None
            or k not in probe.tokens]
    ok = [k for k in keys if k not in lost]
    dev = torch.device(opts.device)
    t_lm, t_codec, _ = templates(pcfg, opts.lm_dtype)
    scheme = cfg["precision"]["lm"]
    numbers: Dict[str, float] = {"lost": float(len(lost))}

    # the LM: every greedy request of the window
    greedy = [k for k in ok if win.requests[k].greedy]
    tree = bw.lm_weights(t_lm, seed, dev, opts.lm_dtype, silence_of(layout, pcfg.llm.vocab_size))
    w = ref_lm.float_weights(tree, "none" if scheme == "bfloat16" else scheme)
    del tree
    prompts = [layout.control_prompt(win.requests[k].text, win.requests[k].gender,
                                     win.requests[k].pitch, win.requests[k].speed) for k in greedy]
    with check.fp32_flags():
        gaps = check.lm_gaps(w, cfg["llm"], layout, prompts, [probe.tokens[k] for k in greedy], dev)
    del w
    numbers["lm_gap"] = max(gaps, default=0.0)
    numbers["greedy_tokens"] = float(sum(len(probe.tokens[k]) for k in greedy))
    numbers["budget_missed"] = float(sum(len(probe.tokens[k]) != win.requests[k].budget
                                         for k in ok))

    # the codec: a sample drawn from the seed, and the longest request
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 7]))
    pick = list(rng.permutation(len(ok))[: CODEC_SAMPLE])
    if ok:
        pick.append(int(np.argmax([len(probe.tokens[k]) for k in ok])))
    sample = [ok[i] for i in sorted(set(pick))]
    tn = pcfg.bicodec.speaker_encoder.token_num
    bad = sum(not check.speaker_judged(layout, probe.tokens[k], probe.speakers.get(k), tn)
              for k in sample)
    hop = int(np.prod(pcfg.bicodec.decoder.rates)) * int(np.prod(pcfg.bicodec.prenet.sample_ratios))
    for k in ok:
        n_sem = layout.semantic_ids(probe.tokens[k]).size
        bad += int(sum(len(a) for a in win.audio[k]) != n_sem * hop)
    numbers["speaker_bad"] = float(bad)
    p = bw.codec_weights(t_codec, seed, dev)
    items = [dict(tokens=probe.tokens[k], speaker=probe.speakers.get(k),
                  audio=np.concatenate(win.audio[k]) if win.audio[k] else np.zeros(0, np.float32))
             for k in sample if probe.speakers.get(k) is not None]
    errs = check.wave_errors(p, cfg["bicodec"], layout, items, VOCODE_BUCKET, hop, dev,
                             tf32_control="codec" in opts.control)
    numbers["wave_err"] = max(errs, default=0.0)
    numbers["codec_samples"] = float(sum(len(it["audio"]) for it in items))
    limits = dict(cfg["limits"], lost=0.0, budget_missed=0.0, speaker_bad=0.0)
    return {"numbers": numbers, "limits": limits,
            "correct": all(numbers[k] <= v for k, v in limits.items()),
            "attempted": len(keys), "failed": len(lost)}


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool, opts: Options,
        setup_t0: float) -> Dict:
    """Everything but the result line: the metrics, the device numbers, the
    checks."""
    pcfg = program_config(cfg)
    pipe, server, probe, layout = build(cfg, seed, opts)
    m = asyncio.run(_measure(server, pipe, probe, mix, seed, seconds, trace, opts, setup_t0))
    e2e = end_to_end(m["win"], m["t0"], m["t1"], pipe.sample_rate, m["setup_s"])
    records = layer_records(m, probe, cfg, pipe.sample_rate, server.engine.max_slots)
    records["e2e"] = e2e
    # the program's state goes before the reference runs on the card
    probe.server = m["win"].server = None
    del pipe, server
    gc.collect()
    if opts.device == "cuda":
        torch.cuda.empty_cache()
    verdict = correctness(m, probe, cfg, layout, seed, opts, pcfg)
    return {"e2e": e2e, "records": records, "peak": m["peak"], "verdict": verdict}
