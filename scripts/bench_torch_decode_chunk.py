#!/usr/bin/env python3
"""Choose the split-window decode kernel's chunk on the card.

    python3 scripts/bench_torch_decode_chunk.py [--chunks 32 64 128]

Builds `sparktts_tpu_torch/kernels/csrc/decode_attention.cu` once for each
chunk (`-DDECODE_CHUNK=n`, nvcc for sm_90a, into build/kernels/chunk-n/) and
times each build through the port's own wrapper at the decode shapes of the
main paths, at the full Qwen2.5-0.5B widths (24 layers, 14 query heads over
2 KV heads, head dim 64, bf16): voice creation's middle step (B = 1, S =
576, keys [20, 313]), voice cloning's (B = 1, S = 960, keys [29, 697]) and
eight rows of windows like the dense engine's (S = 960, 53 to 560 keys, one
finished row at pos = S).  Each build is first held against the plain
version (atol 2e-2).  Times are device time per call, `chip_smoke._time_ms`
(calls captured in one CUDA graph, replayed between CUDA events).  The last
line is one JSON object with all of it.  Needs a CUDA card; exits 2 without
one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SHAPES = {  # label: (B, S, starts, positions)
    "creation B=1 S=576": (1, 576, [20], [313]),
    "cloning B=1 S=960": (1, 960, [29], [697]),
    "dense engine B=8 S=960": (8, 960, [0] * 8, [53, 68, 560, 54, 300, 960, 120, 447]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[32, 64, 128])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from sparktts_tpu_torch.kernels import build
    from sparktts_tpu_torch.kernels import decode_attention as da

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    libs = {}
    procs = {}
    for chunk in args.chunks:  # one nvcc each, all started together
        out = build.BUILD_DIR / f"chunk-{chunk}" / "libdecode_attention.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DDECODE_CHUNK={chunk}", "-o", str(out),
               str(build.CSRC / "decode_attention.cu")]
        procs[chunk] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), out)
    for chunk, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for chunk {chunk}:\n{log}")
        print(f"chunk {chunk}: " + "; ".join(line.strip() for line in log.splitlines()
                                             if "registers" in line or "spill" in line))
        libs[chunk] = ctypes.CDLL(str(out))

    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for label, (b, s, starts, poss) in SHAPES.items():
        shape = (24, b, s, 2, 64)
        inputs[label] = (
            torch.randn((b, 14, 64), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
            torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(poss, dtype=torch.int32, device=dev),
        )
    result = {"card": smi, "device": torch.cuda.get_device_name(0), "ms": {}}
    for chunk, lib in libs.items():
        da._fn, da._chunk = da.bind(lib)
        row = {}
        for label, (q, ck, cv, st, po) in inputs.items():
            got = da.dense_decode_attention(q, ck, cv, 12, st, po, sm_scale=0.125)
            want = da.dense_decode_plain(q, ck, cv, 12, st, po, sm_scale=0.125)
            err = float((got.float() - want.float()).abs().max())
            if not err <= 2e-2:
                raise AssertionError(f"chunk {chunk}, {label}: max_abs_err {err}")
            row[label] = smoke._time_ms(
                lambda: da.dense_decode_attention(q, ck, cv, 12, st, po, sm_scale=0.125), dev,
                iters=50, reps=20)
            print(f"chunk {chunk:4d} {label}: {row[label] * 1e3:.2f} us (max_abs_err {err:.2e})")
        result["ms"][chunk] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
