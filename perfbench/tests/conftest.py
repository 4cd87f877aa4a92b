"""The harness's CPU tests: `python -m pytest perfbench/tests -q` from the
root of a checkout.  They import the port on the CPU (never JAX), and run
the harness at the port's tiny test sizes."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
