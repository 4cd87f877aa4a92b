#!/usr/bin/env python3
"""Where the vocoder ResidualUnit kernel's gap to the plain unit comes from.

    python3 scripts/check_torch_vocoder_accumulation.py

The kernel (`csrc/vocoder_fusion.cu`) takes every product of the unit's two
convolutions as three tf32 products (3xTF32) on `mma.sync.m16n8k8` and sums
them on the tensor cores in fp32.  At each of the 12 (channels, length,
dilation) of a 350-token vocode, on random fp32 params and input (seed 3),
this prints the largest gap, relative to max|plain|, of:

* the kernel, cuDNN's fp32 unit (`fused_residual_unit_plain`, TF32 off) and
  `residual_unit_3xtf32_plain` (the kernel's three products, summed by
  cuBLAS in fp32 with TF32 off) to the same unit in float64;
* the kernel to `residual_unit_3xtf32_plain` and to two step-by-step
  emulations of its sums: the kernel's mma order (8 input channels a step;
  for each, the taps in order; for each tap lo.hi, hi.lo, hi.hi), each
  step's 8 exact products added to the fp32 sum in float64, then rounded to
  fp32 toward zero (`rz`) or to nearest (`rn`);
* at dilation 1, the kernel to the unit with one of the three products left
  out: what a slip in the split would cost;
* `toward_zero`: the mean of the kernel's error to float64 times the sign of
  the unit's convolution part (out - x), over its root mean square; negative
  when the error pulls the convolutions toward zero, as truncation does.

Needs a CUDA card; exits 2 without one.  The last line is one JSON object
with every number.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CHANNELS, RATES, DILATIONS, TOKENS = 1536, (8, 5, 4, 2), (1, 3, 9), 350
PRODUCTS = ("lo.hi", "hi.lo", "hi.hi")


def _parts(a, b):
    from sparktts_tpu_torch.kernels.vocoder_fusion import tf32_round

    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return {"lo.hi": (a_lo, b_hi), "hi.lo": (a_hi, b_lo), "hi.hi": (a_hi, b_hi)}


def _toward_zero(v):
    """float64 -> float32, rounded toward zero."""
    import torch

    r = v.float()
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _conv_in_steps(y, w, dilation, t, rnd):
    """sum_k y[:, k dil : k dil + t] @ w[k], step by step in the kernel's mma order."""
    import torch

    parts = _parts(y, w)
    acc = torch.zeros((y.shape[0], t, w.shape[2]), dtype=torch.float32, device=y.device)
    for c0 in range(0, w.shape[1], 8):
        for k in range(w.shape[0]):
            rows = slice(k * dilation, k * dilation + t)
            for name in PRODUCTS:
                a, b = parts[name]
                acc = rnd(acc.double() + a[:, rows, c0:c0 + 8].double() @ b[k, c0:c0 + 8].double())
    return acc


def _conv_without(y, w, dilation, t, left_out):
    """The 3xTF32 convolution, summed by cuBLAS, without one of its products."""
    total = 0
    for k in range(w.shape[0]):
        parts = _parts(y[:, k * dilation:k * dilation + t], w[k])
        total = total + sum(a @ b for name, (a, b) in parts.items() if name != left_out)
    return total


def _unit(p, x, dilation, conv):
    import torch.nn.functional as F

    from sparktts_tpu_torch.nn.layers import snake_apply

    t, pad = x.shape[1], 3 * dilation
    y = F.pad(snake_apply(p["snake1"], x), (0, 0, pad, pad))
    z = snake_apply(p["snake2"], conv(y, p["conv1"]["w"], dilation, t) + p["conv1"]["b"])
    return x + (conv(z, p["conv2"]["w"], 1, t) + p["conv2"]["b"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from sparktts_tpu_torch.kernels import vocoder_fusion as vf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    results = {"card": smi}
    t = TOKENS
    for i, rate in enumerate(RATES):
        t *= rate
        c = CHANNELS // 2 ** (i + 1)
        for dil in DILATIONS:
            p = {"snake1": {"alpha": 0.5 + torch.rand(c, generator=gen, device=dev)},
                 "conv1": {"w": rnd(7, c, c, scale=0.02), "b": rnd(c, scale=0.1)},
                 "snake2": {"alpha": 0.5 + torch.rand(c, generator=gen, device=dev)},
                 "conv2": {"w": rnd(1, c, c, scale=0.02), "b": rnd(c, scale=0.1)}}
            x = torch.randn((1, t, c), generator=gen, device=dev)
            got = vf.fused_residual_unit(p, x, dil)
            plain = vf.fused_residual_unit_plain(p, x, dil)
            model = vf.residual_unit_3xtf32_plain(p, x, dil)
            p64 = {k: {n: v.double() for n, v in d.items()} for k, d in p.items()}
            exact = vf.fused_residual_unit_plain(p64, x.double(), dil)
            scale = float(plain.abs().max())

            def gap(a, b):
                return float((a.double() - b.double()).abs().max()) / scale

            row = {"kernel vs fp64": gap(got, exact), "plain vs fp64": gap(plain, exact),
                   "3xtf32 model vs fp64": gap(model, exact), "kernel vs plain": gap(got, plain),
                   "kernel vs 3xtf32 model": gap(got, model)}
            for mode, r in (("rz", _toward_zero), ("rn", lambda v: v.float())):
                steps = _unit(p, x, dil, functools.partial(_conv_in_steps, rnd=r))
                row[f"kernel vs {mode} steps"] = gap(got, steps)
            if dil == 1:
                for left_out in PRODUCTS:
                    without = _unit(p, x, dil, functools.partial(_conv_without, left_out=left_out))
                    row[f"kernel vs model without {left_out}"] = gap(got, without)
            err = got.double() - exact
            row["toward_zero"] = float((err * torch.sign(exact - x.double())).mean()
                                       / err.pow(2).mean().sqrt())
            key = f"C={c} T={t} dilation={dil}"
            results[key] = row
            print(f"{key}: " + ", ".join(f"{k} {v:.3e}" for k, v in row.items()), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
