"""The one traffic generator: a mix's JSON parameters and a seed in, each
client's endless sequence of requests out.

A closed loop: each of `clients` clients sends its next request when the
last one has returned.  Requests come in blocks: every budget of
`budgets` appears `repeats` times a block, in an order drawn from the seed,
so every seed asks for the same work in another order.  One request a block
is greedy (its nucleus is the top token alone); its budget turns over the
list from block to block, so greedy requests of every length are served.
Texts are words of `words`, drawn to a byte length in `text_bytes`; voice
attributes are drawn from the listed values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class Request:
    client: int
    index: int
    text: str
    gender: str
    pitch: str
    speed: str
    budget: int
    greedy: bool


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *keys]))


def _text(rng: np.random.Generator, words, lo: int, hi: int) -> str:
    target = int(rng.integers(lo, hi + 1))
    out = words[int(rng.integers(len(words)))]
    while True:
        w = words[int(rng.integers(len(words)))]
        if len(out) + 1 + len(w) > target:
            return out
        out = f"{out} {w}"


def requests(mix: Dict, seed: int, client: int) -> Iterator[Request]:
    budgets = list(mix["budgets"])
    words = mix["words"].split()
    lo, hi = mix["text_bytes"]
    index, block = 0, 0
    while True:
        rng = _rng(seed, client, block)
        order = np.repeat(budgets, mix["repeats"])[rng.permutation(len(budgets) * mix["repeats"])]
        greedy_budget = budgets[(client + block) % len(budgets)]
        greedy_at = int(np.flatnonzero(order == greedy_budget)[0])
        for k, budget in enumerate(order):
            yield Request(
                client=client, index=index, text=_text(rng, words, lo, hi),
                gender=str(rng.choice(mix["genders"])), pitch=str(rng.choice(mix["pitches"])),
                speed=str(rng.choice(mix["speeds"])), budget=int(budget), greedy=k == greedy_at,
            )
            index += 1
        block += 1
