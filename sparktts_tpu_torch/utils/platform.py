"""Device selection for the entry-point scripts (`cli.py`, `webui.py`).

Port of `sparktts_tpu/utils/platform.py`.  There, `apply_platform_env` pins
JAX's platform from $SPARKTTS_PLATFORM before any backend starts and turns
on JAX's persistent compile cache.  Here it picks the torch device from the
same variable: "cpu" or "cuda", and "cuda" when it is unset, so an entry
point runs on the card unless the caller asks for the CPU (and raises
without a card, as `SparkTTSPipeline` does).

The compile cache has no counterpart and no knob: the port's kernels are
built by nvcc into `build/kernels/` (`kernels/build.py`), a directory that
persists across processes, and its decode units are CUDA graphs captured
per process.
"""

from __future__ import annotations

import os

import torch

PLATFORMS = ("cpu", "cuda")


def apply_platform_env() -> str:
    """The torch device type named by $SPARKTTS_PLATFORM, "cuda" when unset."""
    plat = os.environ.get("SPARKTTS_PLATFORM", "").strip().lower() or "cuda"
    if plat not in PLATFORMS:
        raise ValueError(f"SPARKTTS_PLATFORM must be one of {PLATFORMS}, got {plat!r}")
    return plat


def require_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raises when it is a card and there is none
    (an entry point never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; pass device='cpu' to run on "
                           f"the CPU")
    return device
