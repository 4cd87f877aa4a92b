"""A device trace of a slice of the window, and what is read from it.

`torch.profiler` records the device's kernels, copies and sets (CUDA
activity only, which costs the host least) between two synchronisations.
A short spin kernel launched on an idle card at the slice's start ties the
trace's clock to the host's `perf_counter`, so that an idle gap on the
device can be named after the benchmark's host span open at its middle.
The trace is written under `TMPDIR`, read once and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 20000
NAME_CHARS = 120  # a kernel's name in the breakdown, cut: templated names run to kilobytes


class Slice:
    """Start with `begin()` and end with `end()` on the thread that drives
    the card's work; `read(spans)` parses the trace afterwards."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.marker_host = None
        self.path = None

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        self.t0 = time.perf_counter()

    def end(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
        os.close(fd)
        self.path = Path(path)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None

    def read(self, spans: Sequence[Tuple[str, float, float]], top: int = 10) -> Dict:
        try:
            events = json.loads(self.path.read_text())["traceEvents"]
        finally:
            self.path.unlink(missing_ok=True)
        return reduce_events(events, self.t0, self.t1, self.marker_host, spans, top)


def reduce_events(events: List[Dict], t0: float, t1: float, marker_host: float,
                  spans: Sequence[Tuple[str, float, float]], top: int = 10) -> Dict:
    """Busy seconds (the union of device intervals), each kernel's count,
    seconds and streams, each stream's busy seconds, the top device
    operations and the longest idle gaps named by the host span open at
    their middle ('host' when none is)."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0.0), e.get("name", "?"),
            e.get("args", {}).get("stream", e.get("tid"))) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted(a for a, _, n, _ in dev if MARKER in n)
    if not marks:
        raise RuntimeError("the device trace holds no marker kernel: no device activity recorded")
    offset_us = marks[0] - marker_host * 1e6
    lo, hi = t0 * 1e6 + offset_us, t1 * 1e6 + offset_us
    dev = sorted((max(a, lo), min(b, hi), n, st) for a, b, n, st in dev
                 if MARKER not in n and b > lo and a < hi)
    if not dev:
        raise RuntimeError("the device trace holds no kernel inside the slice")
    kernels: Dict[str, List] = defaultdict(lambda: [0, 0.0, set()])
    stream_end: Dict = defaultdict(lambda: lo)
    stream_busy: Dict = defaultdict(float)
    busy, end, gaps = 0.0, lo, []
    for a, b, n, st in dev:
        kernels[n][0] += 1
        kernels[n][1] += (b - a) / 1e6
        kernels[n][2].add(st)
        if b > stream_end[st]:
            stream_busy[st] += (b - max(a, stream_end[st])) / 1e6
            stream_end[st] = b
        if a > end:
            gaps.append((a - end, end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((hi - end, end, hi))
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    gaps.sort(reverse=True)
    host = [(name, a * 1e6 + offset_us, b * 1e6 + offset_us) for name, a, b in spans]

    def during(mid: float) -> str:
        open_ = [name for name, a, b in host if a <= mid < b]
        return "+".join(sorted(set(open_))) or "host"

    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": {n: {"count": c, "seconds": s, "streams": sorted(st, key=str)}
                    for n, (c, s, st) in kernels.items()},
        "stream_busy_s": {str(st): v for st, v in stream_busy.items()},
        "device_ops": [[n[:NAME_CHARS], s] for n, (_, s, _) in ranked],
        "idle_gaps": [[during((a + b) / 2), d / 1e6] for d, a, b in gaps[:top]],
    }


def kernel_seconds(kernels: Dict[str, Dict], fragment: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds `fragment`."""
    hits = [v for n, v in kernels.items() if fragment in n]
    return sum(v["count"] for v in hits), sum(v["seconds"] for v in hits)


def streams_busy_s(reduced: Dict, fragments: Sequence[str]) -> float:
    """Busy seconds of the streams on which a kernel whose name holds one of
    `fragments` ran: all their work, named or not."""
    streams = {str(st) for n, v in reduced["kernels"].items()
               if any(f in n for f in fragments) for st in v["streams"]}
    return sum(reduced["stream_busy_s"].get(st, 0.0) for st in streams)
