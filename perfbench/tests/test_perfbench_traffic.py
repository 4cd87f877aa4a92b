"""The one traffic generator: repeats from its seed, changes with it, and
gives every seed the same work in another order."""

import itertools
import json
from collections import Counter
from pathlib import Path

import pytest

from perfbench.harness import traffic
from perfbench.reference.prompt import Layout

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _take(mix, seed, client, n):
    return list(itertools.islice(traffic.requests(mix, seed, client), n))


@pytest.mark.parametrize("name", ["create-c8"])
def test_a_seed_repeats_and_another_differs(name):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    big = 2**31 + 12345
    assert _take(mix, big, 3, 20) == _take(mix, big, 3, 20)
    assert _take(mix, big, 3, 20) != _take(mix, big + 1, 3, 20)
    assert _take(mix, big, 3, 20) != _take(mix, big, 4, 20)
    assert _take(mix, -7, 0, 5)  # any whole number seeds it


@pytest.mark.parametrize("name", ["create-c8"])
def test_every_block_asks_the_same_work(name):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    block = len(mix["budgets"]) * mix["repeats"]
    for seed in (1, 2**31 + 5):
        reqs = _take(mix, seed, 0, 3 * block)
        for b in range(3):
            part = reqs[b * block : (b + 1) * block]
            assert Counter(r.budget for r in part) == Counter(
                {x: mix["repeats"] for x in mix["budgets"]})
            assert sum(r.greedy for r in part) == 1


@pytest.mark.parametrize("name", ["create-c8"])
def test_every_prompt_fits_one_creation_bucket(name):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    layout = Layout(8192, 4096)
    for client in range(mix["clients"]):
        for r in _take(mix, 99, client, 50):
            lo, hi = mix["text_bytes"]
            assert len(r.text.encode()) <= hi
            assert len(layout.control_prompt(r.text, r.gender, r.pitch, r.speed)) <= 64
