#!/usr/bin/env python3
"""One benchmark run on the card with a fault of `faults.py` planted in the
program, at the cell's own size:

    python3 perfbench/tests/plant.py <fault> --workload <cell> --seed <n> --seconds <s> --trace 0

<fault> is one of alter_token, alter_audio, stale_cache, half_dropped.  The
rest is `run.py`'s command line, and the last line is its result: the run
has to come out with `correct` false.  Run from the root of a checkout."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import pytest  # noqa: E402

from perfbench import run as bench  # noqa: E402
from perfbench.harness import env  # noqa: E402
from perfbench.tests.faults import FAULTS  # noqa: E402


def main(argv) -> int:
    if not argv or argv[0] not in FAULTS:
        raise SystemExit(f"usage: plant.py <{'|'.join(FAULTS)}> <run.py arguments>")
    env.pin_caches(bench.ROOT)
    with pytest.MonkeyPatch.context() as mp:
        FAULTS[argv[0]](mp)
        return bench.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
