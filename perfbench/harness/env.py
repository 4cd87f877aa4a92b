"""What a run requires of its process: a card, caches inside the checkout,
and no JAX.

The JAX package (`sparktts_tpu`) sits beside the port it was ported to
(`sparktts_tpu_torch`), whose name begins with its own: modules are told
apart by their whole top-level name, never by a prefix.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "sparktts_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def pin_caches(root: Path) -> None:
    """Keep every build and kernel cache at a fixed path inside the
    checkout, so that only a checkout's first run builds.  The port's own
    kernels build into `build/kernels/` of the checkout already."""
    cache = root / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> str:
    """The card's name, or NoCard when fewer than `n` CUDA cards are seen.
    A measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark measures a CUDA card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards, {torch.cuda.device_count()} are visible")
    return torch.cuda.get_device_name(0)
