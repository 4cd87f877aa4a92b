#!/usr/bin/env python3
"""Where the time of a continuous-batching decode dispatch goes in the
PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_engines.py [--steps 32]

Builds the paged and the dense engine over `SparkTTSPipeline`'s LM at the
full Spark-TTS-0.5B widths (random weights, seed 0), sized as
`chip_smoke.py` sizes them (`chip_smoke.build_engines`), and admits
chip_smoke's eight engine requests into each (the paged engine takes as
many as its pool can guarantee).  Each engine runs one dispatch
unprofiled, then two dispatches of `--steps` decode steps traced with
`torch.profiler`: one as the engine runs it (replays of its captured decode
unit, `lm/graphs.py`) and one as the eager loop of its step function
(`chip_smoke.eager_dispatch`).  For each it prints the host-clock wall
time, the time the device was busy (the union of kernel, memcpy and memset
intervals), the device's idle share, the kernels run and the host's launch
calls per step, and the kernels that took the most device time.  The last
line is one JSON object with all of it.  Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT_DIR = REPO / "chiprun_out"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=32, help="decode steps to trace (a ladder rung)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from profile_torch_voice_creation import _profile
    from sparktts_tpu_torch.lm.continuous import AdmissionDeferred
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    pipe = SparkTTSPipeline(device=dev, seed=smoke.SEED)
    OUT_DIR.mkdir(exist_ok=True)
    requests, _ = smoke.engine_requests(pipe, smoke.make_prompt_wav(OUT_DIR / "engine_prompt.wav"))
    result = {"card": smi, "device": torch.cuda.get_device_name(0), "decode_steps": args.steps}
    for name, eng in zip(("paged", "dense"), smoke.build_engines(pipe)):
        for _, ids, mode in requests:
            try:
                eng.submit(ids, smoke.MAX_NEW_TOKENS, mode=mode)
            except AdmissionDeferred:
                pass
        eng.step(smoke.ENGINE_DISPATCH)  # unprofiled: warms every shape
        for path in ("graph", "eager"):
            with smoke.eager_dispatch() if path == "eager" else contextlib.nullcontext():
                r = _profile(f"engine_{name}_{path}", lambda: eng.step(args.steps))
            r.update(live_slots=sum(o is not None for o in eng.owner),
                     wall_ms_per_step=r["wall_ms"] / args.steps,
                     device_ms_per_step=r["device_busy_ms"] / args.steps,
                     kernels_per_step=r["kernels_launched"] / args.steps)
            if r["host_launch_calls"] is not None:
                r["host_launches_per_step"] = r["host_launch_calls"] / args.steps
            result[name if path == "graph" else f"{name}_eager"] = r
            print(f"{name} engine, {path}, {r['live_slots']} live slots, {args.steps} steps: "
                  f"wall {r['wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, idle "
                  f"share {r['device_idle_share']:.4f}, {r['kernels_per_step']:.1f} kernels and "
                  f"{r.get('host_launches_per_step')} host launch calls a step")
            for k in r["top_kernels"][:8]:
                print(f"    {k['device_ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
