#!/usr/bin/env python3
"""Choose the paged-decode kernel's chunk and the int4 matvec's plan on the
card.

    python3 scripts/bench_torch_paged_int4.py [--chunks 32 64 128]
        [--builds NAME:DEFINE=V,... ...] [--batches 1 8 32] [--tree DIR]

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
each over 24 layers' random weights in turn, for the port's build
("kernel") and each of `--builds`: `NAME:INT4_RUN_MAX=64` builds
`csrc/int4_matmul.cu` with those defines (into build/kernels/int4-NAME/):
INT4_RUN_MAX changes the most groups a run (so the runs of a call), and
INT4_ABLATE=n leaves a part of the work out (the header lists them; such a
build's results are wrong, and names that start with "ablate" skip the
check).  Beside it: the library's
int4 matmul (`chip_smoke.int4_library_call`), the harness's floor (one tiny
elementwise kernel a call), each launch plan (`int4_matmul.plan`), and the
SASS of the port's build (`cuobjdump -sass`: tensor-core products HMMA or
HGMMA, asynchronous copies LDGSTS or UTMALDG, integer-to-float I2F).
`--tree DIR` imports the port and chip_smoke.py from another checkout (an
older commit, unpacked) and times only its int4 kernel as it builds it, so
two commits can be compared in one call, each in a process of its own.

Every setting is first held against the plain version (atol 2e-2 for
attention, 1e-2 of max|plain| for int4, and two int4 calls bit-equal).
Times are device time per call, `chip_smoke._time_ms` (calls captured in
one CUDA graph, replayed between CUDA events).  The last line is one JSON
object with all of it.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PAGED_STATES = {  # label: keys per slot
    "engine-like": [101, 301, 40, 430, 228, 0, 130, 99],
    "late": [1024, 1023, 1000, 961, 1025, 1010, 999, 1017],
}
INT4_SHAPES = {"qkv": (896, 1152), "o": (896, 896), "gateup": (896, 9728), "down": (4864, 896)}


def _start(build, source, subdir, *defines):
    """Start nvcc for one build of `source` with `defines`; (process, output path)."""
    out = build.BUILD_DIR / subdir / f"lib{source}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(out),
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


def _sass_counts(path: Path) -> dict:
    """Instructions of a built library that show its route: tensor-core
    products, asynchronous copies and integer-to-float conversions (I2F.RP
    is the reciprocal step of an integer division by a runtime value)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    lines = [ln.split("*/")[1].split("/*")[0].strip() for ln in sass.splitlines()
             if ln.count("/*") >= 2]
    ops = [ln.split()[0] if not ln.startswith("@") else ln.split()[1] for ln in lines if ln]
    counts = {k: sum(op.split(".")[0] == k for op in ops)
              for k in ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "I2F", "PRMT", "LOP3", "HFMA2")}
    counts["I2F not in integer division"] = sum(op.startswith("I2F") and "RP" not in op
                                                for op in ops)
    return counts


def _int4_builds(build, specs):
    """name -> loaded library for each `NAME:DEFINE=V,...` in specs, one
    nvcc each, all started together."""
    procs = {}
    for spec in specs:
        name, _, defines = spec.partition(":")
        flags = [f"-D{d}" for d in defines.split(",") if d]
        procs[name] = _start(build, "int4_matmul", f"int4-{name}", *flags)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for int4 build {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _time_int4(smoke, build, dev, specs, batches, result, own_tree):
    """Kernel 5 of each build at each shape and row count, into
    result["int4_ms"]; the library's int4 matmul into result["library_ms"]
    when `smoke` has it; plans and SASS of the port's build."""
    import torch

    from sparktts_tpu_torch.kernels import int4_matmul as i4

    libs = _int4_builds(build, specs)
    i4._kernel()  # the port's build (raises if it does not build)
    lib_path = build.library_path("int4_matmul")
    result["sass"] = _sass_counts(lib_path)
    print(f"SASS of {lib_path.name}: {result['sass']}")
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
            if own_tree:
                result.setdefault("plans", {})[f"{name} B={batch}"] = i4.plan(
                    batch, d_in, d_out, d_in // 128)
    if hasattr(smoke, "int4_library_call"):
        result["library_ms"] = {}
        for label, (layers, x, _) in shapes.items():
            calls = [smoke.int4_library_call(x, *w) for w in layers]
            result["library_ms"][label] = smoke._time_ms(smoke._rotating(calls), dev, iters=24,
                                                         reps=10)
            print(f"torch._weight_int4pack_mm {label}: "
                  f"{result['library_ms'][label] * 1e3:.2f} us")
    kernel_fn = i4._fn
    for name in ["kernel", *libs]:
        i4._fn = kernel_fn if name == "kernel" else i4.bind(libs[name])
        for label, (layers, x, want) in shapes.items():
            try:
                got = i4.int4_matvec(x, *layers[0])
            except RuntimeError as e:  # a forced plan the kernel refuses at this shape
                print(f"int4 {label} {name}: {e}")
                result["int4_ms"].setdefault(label, {})[name] = None
                continue
            rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            if not name.startswith("ablate"):
                if not torch.equal(got, i4.int4_matvec(x, *layers[0])):
                    raise AssertionError(f"int4 {label} {name}: two calls differ")
                if not rel <= 1e-2:
                    raise AssertionError(f"int4 {label} {name}: relative error {rel}")
            ms = smoke._time_ms(smoke._rotating([functools.partial(i4.int4_matvec, x, *w)
                                                 for w in layers]), dev, iters=24, reps=10)
            result["int4_ms"].setdefault(label, {})[name] = ms
            print(f"int4 {label} {name}: {ms * 1e3:.2f} us (relative error {rel:.2e})")
    for batch in batches:
        for name in ["kernel", *libs]:
            times = [result["int4_ms"][f"{n} B={batch}"][name] for n in INT4_SHAPES]
            if None not in times:
                print(f"int4 layer B={batch} {name}: {sum(times) * 1e3:.2f} us")
        if "library_ms" in result:
            total = sum(result["library_ms"][f"{n} B={batch}"] for n in INT4_SHAPES)
            print(f"int4 layer B={batch} torch._weight_int4pack_mm: {total * 1e3:.2f} us")
    i4._fn = kernel_fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--builds", nargs="*", default=[],
                    help="NAME:DEFINE=V,... builds of the int4 kernel timed beside the port's")
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
    _time_int4(smoke, build, dev, args.builds if args.tree is None else [], args.batches, result,
               args.tree is None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
