#!/usr/bin/env python3
"""Time the fused int8 MLP (kernel 4) and the vocoder's ResidualUnit (kernel
3) of one checkout on the card.

    python3 scripts/bench_torch_int8_vocoder.py [--tree DIR]

Builds the checkout's kernels (nvcc, sm_90a, its own build/kernels/) and
prints each build's `-Xptxas -v` lines and, from `cuobjdump -sass`, how many
I2F (integer-to-float) instructions each library holds, how many of them
are not the I2F.RP of an integer division, and how many HMMA
(tensor-core) instructions.  Then, each held against its plain version
first (int8 within 2e-2 of max|plain|, the unit within 1e-4 of max|plain|):

* kernel 4 at 1, 8 and 16 rows, at the full Qwen2.5-0.5B widths
  (hidden 896, intermediate 4864), over 24 layers' random int8 weights in
  turn, device time per call (`chip_smoke._time_ms`: calls captured in one
  CUDA graph, replayed between CUDA events);
* kernel 3 at the 12 (channels, length, dilation) of one vocode of 350
  semantic tokens (WaveGenerator channels 1536, rates 8, 5, 4,
  2; dilations 1, 3, 9), device time per unit call and their sum;
* the vocode stage of a request: `SparkTTSPipeline.detokenize` of
  350 random semantic ids and 32 global ids at full width (random
  weights, seed 0), host clock around a synchronised call, median of 5
  after one warm-up.

`--tree DIR` imports the port and chip_smoke.py from another checkout (an
older commit, unpacked), so two commits are compared in one call, each in a
process of its own: run parent, change, change, parent.  The last line is
one JSON object with all of it.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
HIDDEN, INTER, LAYERS = 896, 4864, 24
CHANNELS, RATES, DILATIONS = 1536, (8, 5, 4, 2), (1, 3, 9)
ROWS = (1, 8, 16)  # decode rows of kernel 4: one request, a full and a double n-tile
TOKENS = 350  # semantic tokens of the vocode: 7 s of audio


def _sass_counts(build, name: str) -> dict:
    """I2F and HMMA instructions in the built library of `csrc/<name>.cu`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    lines = [ln for ln in sass.splitlines() if "/*" in ln]
    i2f = [ln for ln in lines if " I2F" in ln]
    # I2F.RP is the reciprocal step of an integer division by a runtime value
    other = [ln.split("*/")[1].split("/*")[0].strip() for ln in i2f if "I2F.RP" not in ln]
    return {"I2F": len(i2f), "I2F not in integer division": len(other),
            "those I2F": other[:8], "HMMA": sum(" HMMA" in ln for ln in lines)}


def _time_int8(smoke, dev, rows, result):
    import torch

    from sparktts_tpu_torch.kernels import int8_mlp as i8

    gen = torch.Generator(device=dev).manual_seed(0)
    layers = [(torch.randint(-127, 128, (HIDDEN, 2 * INTER), generator=gen, device=dev,
                             dtype=torch.int8),
               1e-3 * (1 + torch.rand(2 * INTER, generator=gen, device=dev)),
               torch.randint(-127, 128, (INTER, HIDDEN), generator=gen, device=dev,
                             dtype=torch.int8),
               1e-3 * (1 + torch.rand(HIDDEN, generator=gen, device=dev)))
              for _ in range(LAYERS)]
    for r in rows:
        x = torch.randn((r, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
        got, want = i8.int8_mlp_matvec(x, *layers[0]), i8.int8_mlp_matvec_plain(x, *layers[0])
        rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        if not rel <= 2e-2:
            raise AssertionError(f"int8 MLP R={r}: relative error {rel}")
        ms = smoke._time_ms(smoke._rotating([functools.partial(i8.int8_mlp_matvec, x, *w)
                                             for w in layers]), dev, iters=LAYERS, reps=10)
        result["int8_mlp_ms"][r] = ms
        print(f"int8 MLP R={r}: {ms * 1e3:.2f} us a call (relative error {rel:.2e})")


def _unit(c, gen, dev):
    import torch

    def rnd(*shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    return {"snake1": {"alpha": 0.5 + torch.rand(c, generator=gen, device=dev)},
            "conv1": {"w": rnd(7, c, c, scale=0.02), "b": rnd(c, scale=0.1)},
            "snake2": {"alpha": 0.5 + torch.rand(c, generator=gen, device=dev)},
            "conv2": {"w": rnd(1, c, c, scale=0.02), "b": rnd(c, scale=0.1)}}


def _time_vocoder(smoke, dev, tokens, result):
    import torch

    from sparktts_tpu_torch.kernels import vocoder_fusion as vf

    gen = torch.Generator(device=dev).manual_seed(1)
    t, total = tokens, 0.0
    for i, rate in enumerate(RATES):
        t *= rate
        c = CHANNELS // 2 ** (i + 1)
        for dil in DILATIONS:
            p = _unit(c, gen, dev)
            x = torch.randn((1, t, c), generator=gen, device=dev)
            got = vf.fused_residual_unit(p, x, dil)
            p64 = {k: {n: v.double() for n, v in d.items()} for k, d in p.items()}
            want = vf.fused_residual_unit_plain(p64, x.double(), dil)  # no TF32 in float64
            rel = float((got - want).abs().max() / want.abs().max())
            if not rel <= 1e-4:
                raise AssertionError(f"unit C={c} T={t} dilation={dil}: relative error {rel}")
            ms = smoke._time_ms(lambda: vf.fused_residual_unit(p, x, dil), dev, iters=3, reps=3)
            total += ms
            result["unit_ms"][f"C={c} T={t} dilation={dil}"] = ms
            print(f"unit C={c} T={t} dilation={dil}: {ms:.4f} ms (relative error {rel:.2e})")
    result["vocode_units_ms"] = total
    print(f"the 12 units of a {tokens}-token vocode: {total:.4f} ms")


def _time_vocode_stage(dev, tokens, result):
    import numpy as np
    import torch

    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    pipe = SparkTTSPipeline(device=dev, seed=0)
    rng = np.random.default_rng(0)
    glob = rng.integers(0, 4096, (1, 32))
    sem = rng.integers(0, pipe.config.bicodec.quantizer.codebook_size, (1, tokens))
    pipe.detokenize(glob, sem)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = pipe.detokenize(glob, sem)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not (np.isfinite(wav).all() and wav.shape[0] == 320 * tokens):
        raise AssertionError(f"vocode: {wav.shape} samples, finite {np.isfinite(wav).all()}")
    result["vocode_ms"] = statistics.median(times)
    result["vocode_ms_all"] = times
    print(f"detokenize of {tokens} tokens: median {result['vocode_ms']:.3f} ms of {times}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the kernels of the checkout in DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    tree = REPO if args.tree is None else args.tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as smoke
    from sparktts_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    result = {"card": smi, "device": torch.cuda.get_device_name(0), "tree": str(tree),
              "int8_mlp_ms": {}, "unit_ms": {}, "ptxas": {}, "sass": {}}
    logs = build.build_all(["int8_mlp", "vocoder_fusion"])
    for name, log in logs.items():
        result["ptxas"][name] = [ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln or "smem" in ln]
        result["sass"][name] = _sass_counts(build, name)
        print(f"{name}: {result['sass'][name]}; " + "; ".join(result["ptxas"][name]))
    _time_int8(smoke, dev, ROWS, result)
    _time_vocoder(smoke, dev, TOKENS, result)
    _time_vocode_stage(dev, TOKENS, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
