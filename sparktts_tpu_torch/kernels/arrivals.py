"""Arrival counters for the kernels that merge across blocks in one launch.

Kernels 2, 4 and 6 (`decode_attention`, `int8_mlp`, `paged_attention`)
split one output over several blocks.  Each block writes
its partial to scratch and counts its arrival on an int32 counter; the block
that arrives last merges the partials in a fixed order and sets the counter
back to 0.
So a launch needs counters that are 0 when it starts and that no launch
running at the same time touches.

This registry keeps one zeroed int32 array for each (card, stream).  Launches
on one stream run one after another, and each leaves its counters at 0, so
every kernel on a stream shares that stream's array; two streams never share
one.  An array is made eagerly, the first time its stream asks for it, and
is never made during CUDA-graph capture: a graph binds the array's address,
and replays find it at 0 because every launch leaves it so.  A stream whose
first use is inside a capture raises; call `prepare(stream)` (or run one
eager launch on that stream) before capturing on it.  When a launch needs
more counters than its stream's array holds, a larger array takes its place
for later launches; the old one is kept alive, never freed, because a graph
captured earlier holds its address and every replay counts on it.

A decode unit counts on an array of its own instead (`private`): the unit's
warm-up and capture run inside the block, so its graph binds that array, and
no other work (another unit's warm-up on the same pooled stream, in another
thread, or another unit's replays) can share its counters.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Hashable, Iterator, List, Optional

import torch

MIN_COUNTERS = 4096  # counters per stream at the least: 16 KiB


class ArrivalRegistry:
    """Zeroed int32 counter arrays, one per stream key."""

    def __init__(self, minimum: int = MIN_COUNTERS):
        self.minimum = minimum
        self._arrays: Dict[Hashable, torch.Tensor] = {}
        self._outgrown: List[torch.Tensor] = []  # kept alive for the graphs that bind them
        self._lock = threading.Lock()

    def counters(self, key: Hashable, device, n: int, capturing: bool) -> torch.Tensor:
        """At least `n` zeroed counters of stream `key` on `device`.  Makes
        or grows the array only outside capture; inside capture (`capturing`)
        a missing or short array raises.  An outgrown array stays allocated."""
        with self._lock:
            arr = self._arrays.get(key)
            if arr is not None and arr.numel() >= n:
                return arr
            if capturing:
                have = "none" if arr is None else f"only {arr.numel()}"
                raise RuntimeError(
                    f"arrival counters: stream {key} has {have} of the {n} counters this launch "
                    f"needs, and none can be made during CUDA-graph capture; call "
                    f"arrivals.prepare(stream, n) (or launch once on that stream) before capturing")
            if arr is not None:
                self._outgrown.append(arr)
            arr = torch.zeros(max(n, self.minimum), dtype=torch.int32, device=device)
            self._arrays[key] = arr
            return arr

    def keys(self):
        with self._lock:
            return list(self._arrays)


REGISTRY = ArrivalRegistry()


def stream_key(stream: torch.cuda.Stream):
    """(card index, stream handle): handles are unique on one card only (the
    default stream is 0 on every card)."""
    return stream.device_index, stream.cuda_stream


_private = threading.local()


@contextlib.contextmanager
def private(device, n: int = MIN_COUNTERS) -> Iterator[torch.Tensor]:
    """Inside the block, this thread's launches count on a zeroed array of
    `n` counters made here, whatever their stream; yields the array (keep it
    alive as long as a graph captured in the block)."""
    array = torch.zeros(n, dtype=torch.int32, device=device)
    saved = getattr(_private, "array", None)
    _private.array = array
    try:
        yield array
    finally:
        _private.array = saved


def for_current_stream(device: torch.device, n: int) -> torch.Tensor:
    """The counters for a launch on `device`'s current stream: this thread's
    `private` array inside that block, else the stream's."""
    array = getattr(_private, "array", None)
    if array is not None:
        if array.numel() < n:
            raise RuntimeError(f"arrival counters: a launch needs {n} counters, the private "
                               f"array holds {array.numel()}")
        return array
    stream = torch.cuda.current_stream(device)
    return REGISTRY.counters(stream_key(stream), device, n,
                             torch.cuda.is_current_stream_capturing())


def prepare(stream: Optional[torch.cuda.Stream] = None, n: int = MIN_COUNTERS) -> torch.Tensor:
    """Make `stream`'s counters now (default: the current stream), outside
    any capture, so that a graph captured on it later finds them."""
    stream = torch.cuda.current_stream() if stream is None else stream
    device = torch.device("cuda", stream.device_index)
    with torch.cuda.device(device), torch.cuda.stream(stream):  # zeroed in that stream's order
        return REGISTRY.counters(stream_key(stream), device, n, capturing=False)
