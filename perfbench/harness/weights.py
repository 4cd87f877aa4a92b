"""The weights of a run, made from its seed on the run's device.

The benchmark makes every weight itself and hands the same trees to the
program under test and to the plain reference, which makes them again
from the seed after the window.  The trees' layout (keys and shapes) is
what the program's loader expects; it is read from the program's own
initialisers run on the `meta` device, which allocate nothing and compute
nothing.  The values are the benchmark's: each tree is one large
`normal_` draw from a `torch.Generator` on the device, cut into views at
256-byte boundaries, each view moved to its leaf's base and spread by rule
(`leaf_rule`).

The LM's spreads are the published `initializer_range` (0.02) at the
published width (hidden 896), and scale as one over the square root of the
width elsewhere (`lm_spread`), so that a layer's outputs keep their size
against the residual stream at any width, and the ids an LM of the port's
tiny test width emits depend on their context as they do at full width
(a decode cache left stale changes them: `tests/faults.py`).

One edit makes the random LM serve the same work whatever the seed: the
embedding rows (the tied head's rows too) of the end-of-sequence id, of
the four structure markers and of the 4096 global ids that voice creation
may emit are zero.  Their logits are then 0, while thousands of semantic
ids score above it at every step, so none of them is ever in the top 50:
every emitted id is a semantic id (1/50 s of audio), and no request stops
before its budget.  Left alone, a random LM emits global ids at a share
that changes with the seed, which changed the audio a run delivers by
~10% from seed to seed.  The speaker ids of every request are then the
zero padding of no global id.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

ALIGN = 64  # elements: 256 bytes of float32
LM_WIDTH = 896  # the hidden width at which the LM's spreads are as published

# leaf name -> (base, spread) of its values; the spread multiplies a
# standard normal draw
_RULES = {
    "w": (0.0, 0.02),
    "embed": (0.0, 0.02),
    "codebook": (0.0, 1.0),
    "latents": (0.0, 0.02),
    "b": (0.0, 0.02),
    "beta": (0.0, 0.02),
    "gamma": (1.0, 0.02),
    "alpha": (1.0, 0.02),
    "mean": (0.0, 0.02),
    "var": (1.0, 0.02),
}


def leaf_rule(path: Tuple[str, ...], siblings: int) -> Tuple[float, float]:
    """(base, spread) of the leaf at `path`.  A ConvNeXt block's layer scale
    ("gamma" beside "dwconv") starts at 1 / blocks, as published Vocos
    backbones do; an AdaLN's scale projection has bias 1, so that a small
    condition modulates near identity."""
    name = path[-1]
    if name == "gamma" and len(path) >= 3 and path[-3] == "blocks" and siblings:
        return 1.0 / siblings, 0.02 / siblings
    if len(path) >= 2 and path[-2] == "scale" and name == "b":
        return 1.0, 0.02
    if name not in _RULES:
        raise KeyError(f"no rule for the weight {'/'.join(path)}")
    return _RULES[name]


def _leaves(tree, path=(), blocks=0) -> Iterable[Tuple[Tuple[str, ...], int, torch.Tensor]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            v = tree[k]
            inner = len(v) if k == "blocks" and isinstance(v, list) else blocks
            yield from _leaves(v, path + (k,), inner)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),), blocks)
    else:
        yield path, blocks, tree


def _rebuild(tree, values: Dict[Tuple[str, ...], torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (str(i),)) for i, v in enumerate(tree)]
    return values[path]


def fill(template, generator: torch.Generator, device, dtype=torch.float32, spread: float = 1.0):
    """A tree shaped as `template` (meta tensors), every float leaf drawn by
    `leaf_rule` from one normal draw of `generator` (the spreads times
    `spread`), cast to `dtype`."""
    leaves = [(p, n, t) for p, n, t in _leaves(template) if t.is_floating_point()]
    sizes = [-(-t.numel() // ALIGN) * ALIGN for _, _, t in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=generator)
    values, off = {}, 0
    for (path, blocks, t), size in zip(leaves, sizes):
        base, sd = leaf_rule(path, blocks)
        view = flat[off : off + t.numel()].view(t.shape).mul_(sd * spread).add_(base)
        values[path] = view if dtype == torch.float32 else view.to(dtype)
        off += size
    if dtype != torch.float32:
        del flat, view
    return _rebuild(template, values)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """The generator of one tree: the run's seed and the tree's number,
    folded into the 63 bits a torch seed takes."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8191 + stream) % (2**63 - 1))


def silenced_rows(vocab: int, eos_ids: Sequence[int], marker_ids: Sequence[int]) -> List[int]:
    return sorted({int(i) for i in (*eos_ids, *marker_ids) if 0 <= int(i) < vocab})


def lm_spread(hidden: int) -> float:
    """The factor on every LM spread at hidden width `hidden`: 1 at the
    published width."""
    return math.sqrt(LM_WIDTH / hidden)


def lm_weights(template, seed: int, device, dtype, silence: Sequence[int]):
    """The LM tree in `dtype` (the precision it is served in), the
    `silence` rows of the embedding zero, every spread times
    `lm_spread` of its width."""
    hidden = int(template["embed"].shape[-1])
    tree = fill(template, generator(seed, device, 1), device, dtype, lm_spread(hidden))
    if silence:
        tree["embed"][torch.as_tensor(list(silence), device=device)] = 0
    return tree


def codec_weights(template, seed: int, device):
    return fill(template, generator(seed, device, 2), device)


def wav2vec2_weights(template, seed: int, device):
    return fill(template, generator(seed, device, 3), device)
