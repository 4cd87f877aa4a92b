"""Where the port's bench scripts (`scripts/*_torch.py`) write `--out`, and
the card's line they print beside their numbers.

A relative `--out` is taken under the checkout's `chiprun_out/` (ignored by
git); a path inside the checkout but outside `chiprun_out/` is refused, so
results never land in the tree.  Any path outside the checkout is written as
given.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import Any, Dict

REPO = Path(__file__).resolve().parents[1]
OUT_DIR = REPO / "chiprun_out"


def write_result(path: str | Path, doc: Dict[str, Any]) -> Path:
    """Write a bench script's JSON document under the rule above; returns
    the path written."""
    path = Path(path)
    if not path.is_absolute():
        path = OUT_DIR / path
    path = path.resolve()
    if path.is_relative_to(REPO) and not path.is_relative_to(OUT_DIR):
        raise ValueError(f"{path} is inside the repo: write results under {OUT_DIR}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2) + "\n")
    return path


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (the first card's line), or "cpu"."""
    if str(device).startswith("cpu"):
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
