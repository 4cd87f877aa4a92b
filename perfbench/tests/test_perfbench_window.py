"""The window's arithmetic: audio counts where it was delivered inside the
window, a tail over every request submitted inside it."""

import numpy as np
import pytest

from perfbench.harness import stats


def _served():
    return [
        # submitted before the window: its audio inside counts, its latency not
        stats.Served(submitted=-1.0, done=0.5, chunks=[(0.2, 1600), (0.5, 800)]),
        # inside, finished after the window closed: latency counts, late audio not
        stats.Served(submitted=9.0, done=12.0, chunks=[(9.5, 3200), (12.0, 4800)]),
        stats.Served(submitted=1.0, done=3.0, chunks=[(2.0, 16000)]),
        stats.Served(submitted=2.0, failed=True),
        # submitted after the close: nothing counts
        stats.Served(submitted=10.0, done=11.0, chunks=[(10.5, 16000)]),
    ]


def test_audio_counts_inside_the_window_only():
    assert stats.audio_seconds(_served(), 0.0, 10.0, 16000) == pytest.approx(
        (1600 + 800 + 3200 + 16000) / 16000)


def test_tails_take_every_request_submitted_inside():
    assert stats.latencies_ms(_served(), 0.0, 10.0) == pytest.approx([3000.0, 2000.0])


def test_percentile_interpolates_as_numpy():
    v = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    for q in (50, 90, 95):
        assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)))
