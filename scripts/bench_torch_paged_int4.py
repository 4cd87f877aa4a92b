#!/usr/bin/env python3
"""Choose the paged-decode kernel's chunk and the int4 matvec's groups per
block on the card.

    python3 scripts/bench_torch_paged_int4.py [--chunks 32 64 128] [--runs 0 1 2 4]
        [--batches 1 8 32] [--tree DIR]

Paged decode (kernel 6): builds `sparktts_tpu_torch/kernels/csrc/paged_attention.cu`
once for each chunk (`-DPAGED_CHUNK=n`, nvcc for sm_90a, into
build/kernels/paged-chunk-n/) and times each build through the port's own
wrapper on pools at the full Qwen2.5-0.5B widths (24 layers, 14 query heads
over 2 KV heads, head dim 64, bf16; 8 slots, 256-token pages, 4 a slot, as
chip_smoke.py sizes the paged engine) at two states: slots of 40 to 430
keys (like the engine after its first dispatch) and every slot near the
full table of 1024 keys (late in a long burst).  `--chunks` with no value
skips it.

int4 matvec (kernel 5): times the kernel through its wrapper at the four
layer shapes of the int4 LM (group 128) at each row count in `--batches`,
each over 24 layers' random weights in turn, for each count in `--runs` of
groups a block at B > 1: 0 is the kernel as the port builds it (its own
choice), n > 0 a build with `-DINT4_RUN=n` (into build/kernels/int4-run-n/),
timed at B > 1 only (B = 1 has a layout of its own).  Beside it: the
library's int4 matmul (`chip_smoke.int4_library_call`) and the harness's
floor (one tiny elementwise kernel a call).  `--tree DIR` imports the port
and chip_smoke.py from another checkout (an older commit, unpacked) and
times only its int4 kernel as it builds it, so two commits can be compared
in one call, each in a process of its own.

Every setting is first held against the plain version (atol 2e-2 for
attention, 1e-2 of max|plain| for int4).  Times are device time per call,
`chip_smoke._time_ms` (calls captured in one CUDA graph, replayed between
CUDA events).  The last line is one JSON object with all of it.  Needs a
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PAGED_STATES = {  # label: keys per slot
    "engine-like": [101, 301, 40, 430, 228, 0, 130, 99],
    "late": [1024, 1023, 1000, 961, 1025, 1010, 999, 1017],
}
INT4_SHAPES = {"qkv": (896, 1152), "o": (896, 896), "gateup": (896, 9728), "down": (4864, 896)}


def _start(build, source, subdir, define):
    """Start nvcc for one build of `source` with `define`; (process, output path)."""
    out = build.BUILD_DIR / subdir / f"lib{source}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, define, "-o", str(out),
           str(build.CSRC / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def _time_paged(smoke, build, dev, chunks, result):
    """Kernel 6 at each chunk and state, into result["paged_ms"]."""
    import torch

    from sparktts_tpu_torch.kernels import paged_attention as pa

    procs = {chunk: _start(build, "paged_attention", f"paged-chunk-{chunk}",
                           f"-DPAGED_CHUNK={chunk}")
             for chunk in chunks}  # one nvcc for each build, all started together
    libs = {}
    for chunk, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for chunk {chunk}:\n{log}")
        print(f"paged chunk {chunk}: " + "; ".join(
            line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))
        libs[chunk] = ctypes.CDLL(str(out))

    gen = torch.Generator(device=dev).manual_seed(0)
    b, pps, page, n_pages = 8, 4, 256, 33
    kp, vp = (torch.randn((24, 2, n_pages, page, 64), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    table = torch.randperm(n_pages - 1, generator=gen, device=dev)[:b * pps].add(1)
    table = table.reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn((b, 14, 64), generator=gen, device=dev).to(torch.bfloat16)
    for chunk in chunks:
        pa._fn, pa._chunk = pa.bind(libs[chunk])
        row = {}
        for label, lens in PAGED_STATES.items():
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            call = functools.partial(pa.paged_decode_attention, q, kp, vp, table, lengths, 12,
                                     sm_scale=0.125)
            err = float((call().float() - pa.paged_decode_plain(
                q, kp, vp, table, lengths, 12, sm_scale=0.125).float()).abs().max())
            if not err <= 2e-2:
                raise AssertionError(f"paged chunk {chunk}, {label}: max_abs_err {err}")
            row[label] = smoke._time_ms(call, dev, iters=50, reps=20)
            print(f"paged chunk {chunk:4d} {label}: {row[label] * 1e3:.2f} us "
                  f"(max_abs_err {err:.2e})")
        result["paged_ms"][chunk] = row
    pa._fn = None


def _time_int4(smoke, build, dev, runs, batches, result):
    """Kernel 5 at each run, shape and row count, into result["int4_ms"];
    the library's int4 matmul into result["library_ms"] when `smoke` has it."""
    import torch

    from sparktts_tpu_torch.kernels import int4_matmul as i4

    procs = {run: _start(build, "int4_matmul", f"int4-run-{run}", f"-DINT4_RUN={run}")
             for run in runs if run > 0}
    libs = {}
    for run, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for int4 run {run}:\n{log}")
        libs[run] = ctypes.CDLL(str(out))
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = {}
    for name, (d_in, d_out) in INT4_SHAPES.items():
        layers = [(torch.randint(-128, 128, (d_in // 2, d_out), generator=gen, device=dev,
                                 dtype=torch.int8),
                   0.01 * (1 + torch.rand((d_in // 128, d_out), generator=gen, device=dev)))
                  for _ in range(24)]
        for batch in batches:
            x = torch.randn((batch, d_in), generator=gen, device=dev).to(torch.bfloat16)
            shapes[f"{name} B={batch}"] = (layers, x, i4.int4_matvec_plain(x, *layers[0]))
    if hasattr(smoke, "int4_library_call"):
        result["library_ms"] = {}
        for label, (layers, x, _) in shapes.items():
            calls = [smoke.int4_library_call(x, *w) for w in layers]
            result["library_ms"][label] = smoke._time_ms(smoke._rotating(calls), dev, iters=24,
                                                         reps=10)
            print(f"torch._weight_int4pack_mm {label}: "
                  f"{result['library_ms'][label] * 1e3:.2f} us")
    for run in runs:
        i4._fn = i4.bind(libs[run]) if run > 0 else None
        for label, (layers, x, want) in shapes.items():
            if run > 0 and x.shape[0] == 1:
                continue
            got = i4.int4_matvec(x, *layers[0])
            if not torch.equal(got, i4.int4_matvec(x, *layers[0])):
                raise AssertionError(f"int4 {label} run {run}: two calls differ")
            rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            if not rel <= 1e-2:
                raise AssertionError(f"int4 {label} run {run}: relative error {rel}")
            ms = smoke._time_ms(smoke._rotating([functools.partial(i4.int4_matvec, x, *w)
                                                 for w in layers]), dev, iters=24, reps=10)
            result["int4_ms"].setdefault(label, {})[run] = ms
            print(f"int4 {label} groups per block {run}: {ms * 1e3:.2f} us "
                  f"(relative error {rel:.2e})")
    i4._fn = None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--runs", type=int, nargs="+", default=[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the int4 kernel of the checkout in DIR (no paged part)")
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
              "paged_ms": {}, "int4_ms": {}}
    # the harness's floor: one tiny elementwise kernel a call
    tiny = torch.zeros(64, device=dev)
    result["floor_ms"] = smoke._time_ms(lambda: tiny.add_(1.0), dev, iters=24, reps=10)
    print(f"one tiny elementwise kernel a call: {result['floor_ms'] * 1e3:.2f} us")
    if args.tree is None and args.chunks:
        _time_paged(smoke, build, dev, args.chunks, result)
    _time_int4(smoke, build, dev, args.runs if args.tree is None else [0], args.batches, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
