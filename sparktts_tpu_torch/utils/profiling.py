"""Stage timings and device traces.

Port of `sparktts_tpu/utils/profiling.py`:

  * `StageStats`: a thread-safe registry of per-stage wall-clock timings
    (tokenize, prefill, decode, vocode, queue), summarised like the Triton
    statistics dump the reference serves;
  * `stage`: a context manager feeding a registry (`GLOBAL_STATS` unless
    given one);
  * `device_trace`: a `torch.profiler` trace of the device work inside the
    block, written as a Chrome trace (JAX writes a TensorBoard trace), and
    `device_busy_ms`, the union of the kernel, copy and set intervals of
    such a trace: the device's busy time over the traced window.

On a card the work is queued without waiting, so a `stage` around a call
that does not read the host times its enqueue, as in JAX.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class StageStats:
    """Thread-safe accumulator of per-stage wall-clock timings."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count: Dict[str, int] = defaultdict(int)
        self._total_s: Dict[str, float] = defaultdict(float)
        self._max_s: Dict[str, float] = defaultdict(float)

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._count[stage] += 1
            self._total_s[stage] += seconds
            self._max_s[stage] = max(self._max_s[stage], seconds)

    def reset(self) -> None:
        with self._lock:
            self._count.clear()
            self._total_s.clear()
            self._max_s.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {
                    "count": self._count[k],
                    "total_ms": round(self._total_s[k] * 1000, 3),
                    "avg_ms": round(self._total_s[k] / self._count[k] * 1000, 3),
                    "max_ms": round(self._max_s[k] * 1000, 3),
                }
                for k in sorted(self._count)
            }

    def report(self) -> str:
        """Human-readable table (the role of the reference's write_triton_stats)."""
        lines = [f"{'stage':<20}{'count':>8}{'avg ms':>12}{'max ms':>12}{'total ms':>12}"]
        for k, v in self.summary().items():
            lines.append(
                f"{k:<20}{v['count']:>8}{v['avg_ms']:>12.2f}{v['max_ms']:>12.2f}{v['total_ms']:>12.2f}"
            )
        return "\n".join(lines)


GLOBAL_STATS = StageStats()


@contextlib.contextmanager
def stage(name: str, stats: Optional[StageStats] = None) -> Iterator[None]:
    """Time a pipeline stage into the registry."""
    s = stats or GLOBAL_STATS
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s.record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(path: str | Path) -> Iterator[None]:
    """Trace the device work inside the block with `torch.profiler` (device
    activity only, which costs the host least) and write it to `path` as a
    Chrome trace.  The card's queue is drained before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        try:
            yield
        finally:
            torch.cuda.synchronize()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


def device_busy_ms(trace_path: str | Path) -> float:
    """Milliseconds the device was busy in a `device_trace`: the union of
    its kernel, memcpy and memset intervals.  Raises if the trace holds no
    kernel."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["cat"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not any(cat == "kernel" for _, _, cat in spans):
        raise RuntimeError("the profiler recorded no kernel on the device")
    busy_us, end = 0.0, float("-inf")
    for t0, t1, _ in spans:
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return busy_us / 1e3
