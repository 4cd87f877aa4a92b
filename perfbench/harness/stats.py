"""The window's arithmetic: what counts inside it, and percentiles.

Percentiles interpolate linearly between order statistics (numpy's
default), as the program's bench summary (`bench/harness._summarize`) takes
them.  A request counts for a latency tail when it was submitted inside the
window, whenever it ended: the run drains such requests after the window
closes, so long requests stay in the tail.  Audio counts for the rate when
it was delivered inside the window, whichever request it belongs to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class Served:
    """One request as its client saw it: host clock times in seconds."""

    submitted: float
    done: Optional[float] = None
    chunks: List[Tuple[float, int]] = field(default_factory=list)  # (delivered at, samples)
    failed: bool = False


def in_window(r: Served, t0: float, t1: float) -> bool:
    return t0 <= r.submitted < t1


def audio_seconds(served: Sequence[Served], t0: float, t1: float, rate: int) -> float:
    """Seconds of audio delivered inside [t0, t1)."""
    return sum(n for r in served for t, n in r.chunks if t0 <= t < t1) / rate


def latencies_ms(served: Sequence[Served], t0: float, t1: float) -> List[float]:
    """Submit to last audio, for every request submitted in the window that
    did not fail."""
    return [(r.done - r.submitted) * 1e3 for r in served
            if in_window(r, t0, t1) and not r.failed and r.done is not None]

