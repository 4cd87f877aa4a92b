#!/usr/bin/env python3
"""Kernel 7 (`codec_gemm`) at every distinct call of a 500-token vocode and
a 6 s tokenize, under every plan the kernel has, on the card.

    python3 scripts/bench_torch_codec_tiles.py [--top N] [--out codec_tiles.json]

Builds the kernel (printing what `ptxas -v` says of it), runs
`codec_gemm.mma_probe` (one 64 x 256 x 8 product by the kernel's 3xTF32
chunks through `wgmma` and through `mma.sync`: are the bits the same?),
then records the codec's calls of one vocode and one tokenize at the full
Spark-TTS-0.5B widths (random weights, seed 0; `chip_smoke.py` phase 38's
recording) and, for each distinct kernel-7 call (the `--top` of them by
calls x cuBLAS/cuDNN time): the plan by shape against its plain version in
float64 (within chip_smoke's CODEC_REL_TOL of max|plain|), every forced plan
(`codec_gemm.forced_plan`, each tile with and without a block a k
segment) bit-equal to it, and the time of each, of the plan by shape and of
the plain version in fp32 with TF32 off (the one cuDNN/cuBLAS call, the
library yardstick), each a CUDA graph of `--iters` calls replayed `--reps`
times.  Prints the card's `nvidia-smi` line, one line a call and, as the
last line, a JSON summary; `--out` writes every number under chiprun_out/.
Exits 1 if a plan's bits differ or the tolerance is missed; needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import card_line, write_result  # noqa: E402
from time_torch_codec import prompt_signal  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=0, help="only the N heaviest calls (0: all)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ablate", action="store_true",
                    help="also time builds without the products, the copies or the splits")
    ap.add_argument("--kernel8-against", type=Path, default=None, metavar="DIR",
                    help="hold kernel 8 bit for bit to the build of another checkout's "
                         "csrc/depthwise_conv.cu at the recorded calls")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from sparktts_tpu_torch.kernels import build
    from sparktts_tpu_torch.kernels import codec_gemm as cg
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline, codec_tokenize

    smoke.library_in_fp32()  # the plain versions (the library yardstick) in full fp32
    dev = torch.device("cuda")
    smi = card_line(dev)
    print(smi, flush=True)
    log = build.build_all(["codec_gemm"])["codec_gemm"]
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "codec_gemm_build.log").write_text(log)
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "wgmma", "arning", "rror")):
            print("  ptxas:", line.strip(), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((64, 256), generator=gen, device=dev)
    b = torch.randn((256, 8), generator=gen, device=dev)
    via_wgmma, via_mma = cg.mma_probe(a, b)
    want = a.double() @ b.double()
    probe = dict(equal=bool(torch.equal(via_wgmma, via_mma)),
                 differing=int((via_wgmma != via_mma).sum()),
                 max_abs_diff=float((via_wgmma - via_mma).abs().max()),
                 wgmma_rel_err=float((via_wgmma.double() - want).abs().max() / want.abs().max()),
                 mma_rel_err=float((via_mma.double() - want).abs().max() / want.abs().max()))
    print(f"mma.sync vs wgmma, 64 x 256 x 8 by 3xTF32 chunks of 8: {probe}", flush=True)

    pipe = SparkTTSPipeline(device=dev, seed=0)
    cfg = pipe.config
    rng = np.random.default_rng(0)
    glob = rng.integers(0, 4096, (1, cfg.bicodec.speaker_encoder.token_num))
    sem = rng.integers(0, cfg.bicodec.quantizer.codebook_size, (1, 500))
    _, tok_args, _, _ = pipe.tokenize_host_prep(prompt_signal(6.0))

    @torch.inference_mode()
    def tokenize():
        return codec_tokenize(*tok_args[:2], cfg, *tok_args[2:])

    calls, dw_calls = {}, []
    for label, fn in (("vocode", lambda: pipe.detokenize(glob, sem)), ("tokenize", tokenize)):
        for key, (name, call_args, n) in smoke._record_codec_calls(fn).items():
            if not name.startswith("depthwise"):
                calls.setdefault(key, [name, call_args, 0, label])[2] += n
            else:
                dw_calls.append((name, call_args))
    kernel8 = (same_as_other_build(args.kernel8_against, dw_calls, build)
               if args.kernel8_against else None)
    wrappers = smoke._codec_wrappers()
    rows = []
    for name, call_args, n, label in calls.values():
        _, _, plain = wrappers[name]
        lib_ms = smoke._time_ms(lambda: plain(*call_args), dev, args.iters, args.reps)
        rows.append(dict(name=name, args=call_args, calls=n, label=label, library_ms=lib_ms))
    rows.sort(key=lambda r: -r["calls"] * r["library_ms"])
    if args.top:
        rows = rows[:args.top]

    n_configs, failed, out = cg.configs(), [], []
    for row in rows:
        name, call_args = row["name"], row["args"]
        mod, attr, plain = wrappers[name]
        fn = getattr(mod, attr)
        got = fn(*call_args)
        want = plain(*[v.double() if isinstance(v, torch.Tensor) else v for v in call_args])
        torch.cuda.synchronize()
        rel = float((got.double() - want).abs().max() / want.abs().max())
        _, _, text = smoke._codec_work(name, call_args)
        ms = smoke._time_ms(lambda: fn(*call_args), dev, args.iters, args.reps)
        config_ms, same = [], []
        for c in range(n_configs):
            with cg.forced_plan(c):
                try:
                    other = fn(*call_args)
                except RuntimeError as e:  # a plan whose grid the card refuses
                    config_ms.append(None)
                    same.append(None)
                    print(f"  plan {c}: {e}", flush=True)
                    continue
                same.append(bool(torch.equal(got, other)))
                config_ms.append(smoke._time_ms(lambda: fn(*call_args), dev, args.iters,
                                                args.reps))
        ok = rel <= smoke.CODEC_REL_TOL and all(s is not False for s in same)
        if not ok:
            failed.append(text)
        best = min((t, c) for c, t in enumerate(config_ms) if t is not None)
        print(f"{row['label']}, {row['calls']} calls: {text}: relative {rel:.3e}, plans bit-equal "
              f"{same}; by shape {ms:.4f} ms, library {row['library_ms']:.4f} ms "
              f"({ms / row['library_ms']:.2f}x), best plan {best[1]} {best[0]:.4f} ms; plans "
              + " ".join("-" if t is None else f"{t:.4f}" for t in config_ms), flush=True)
        out.append(dict(shape=f"{row['label']}: {text}", calls=row["calls"], ms=ms,
                        library_ms=row["library_ms"], rel_err=rel, plans_equal=same,
                        plan_ms=config_ms))
    ablated = ablate(rows[:6], args, dev, smoke, build, cg, wrappers) if args.ablate else {}
    if kernel8 is False:
        failed.append("kernel 8 differs from the other checkout's build")
    summary = dict(card=smi, probe=probe, calls=len(out), failed=failed, ablated=ablated,
                   kernel8_bit_equal_to_other_build=kernel8,
                   ms=sum(r["calls"] * r["ms"] for r in out),
                   library_ms=sum(r["calls"] * r["library_ms"] for r in out),
                   best_plan_ms=sum(r["calls"] * min(t for t in r["plan_ms"] if t is not None)
                                    for r in out))
    if args.out:
        write_result(args.out, dict(summary, rows=out))
    print(json.dumps(summary))
    return 1 if failed else 0


ABLATIONS = {1: "no products", 2: "no copies", 3: "no splits"}


def same_as_other_build(tree, dw_calls, build):
    """Kernel 8 at each recorded call, this checkout's build against the
    build of `tree`'s `csrc/depthwise_conv.cu` (the same C entry point):
    True when every output is bit-equal."""
    import ctypes
    import subprocess

    import torch

    from sparktts_tpu_torch.kernels import depthwise_conv as dw

    src = tree / "sparktts_tpu_torch" / "kernels" / "csrc" / "depthwise_conv.cu"
    out = build.BUILD_DIR / "other-depthwise" / "libdepthwise_conv.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    other = ctypes.CDLL(str(out)).depthwise_conv1d_f32
    mine = dw._kernel()
    other.argtypes, other.restype = mine.argtypes, mine.restype
    equal = True
    try:
        for name, call_args in dw_calls:
            got = getattr(dw, name.split()[-1])(*call_args)
            dw._fn = other
            ref = getattr(dw, name.split()[-1])(*call_args)
            dw._fn = mine
            torch.cuda.synchronize()
            equal = equal and bool(torch.equal(got, ref))
            print(f"kernel 8 {name} {tuple(call_args[0].shape)}: bit-equal to {tree}'s build: "
                  f"{bool(torch.equal(got, ref))}", flush=True)
    finally:
        dw._fn = mine
    return equal


def ablate(rows, args, dev, smoke, build, cg, wrappers):
    """The heaviest calls under each plan, timed with builds of the kernel
    that leave out one part (`-DCODEC_ABLATE=n`: wrong results, times
    only): {shape: {part left out: [ms a plan]}}."""
    import ctypes
    import subprocess

    procs = {}
    for n, name in ABLATIONS.items():  # one nvcc each, all started together
        out = build.BUILD_DIR / f"ablate-{n}" / "libcodec_gemm.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DCODEC_ABLATE={n}", "-o", str(out),
               str(build.CSRC / "codec_gemm.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    real = cg._kernel()
    result = {}
    try:
        for n, lib in libs.items():
            fns = (lib.codec_conv1d_f32, lib.codec_conv_transpose1d_f32, lib.codec_bmm_f32)
            for fn, ref in zip(fns, real[:3]):
                fn.argtypes, fn.restype = ref.argtypes, ref.restype
            lib.codec_gemm_configs.restype = ctypes.c_int
            cg._fns = (*fns, lib)
            for row in rows:
                mod, attr, _ = wrappers[row["name"]]
                fn = getattr(mod, attr)
                _, _, text = smoke._codec_work(row["name"], row["args"])
                times = []
                for c in range(cg.configs()):
                    with cg.forced_plan(c):
                        try:
                            times.append(smoke._time_ms(lambda: fn(*row["args"]), dev,
                                                        args.iters, args.reps))
                        except RuntimeError:
                            times.append(None)
                result.setdefault(text, {})[n] = times
                print(f"ablated ({n}): {text}: plans "
                      + " ".join("-" if t is None else f"{t:.4f}" for t in times), flush=True)
    finally:
        cg._fns = real
    return result


if __name__ == "__main__":
    sys.exit(main())
