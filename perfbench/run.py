#!/usr/bin/env python3
"""The benchmark of `sparktts_tpu_torch` on one CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the cell, its configuration, its traffic
mix and its per-layer metrics are found by name from `BENCHMARK.json`
(`harness/spec.py`).  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each number compared with its limit (also
the last lines of standard error).  Without a CUDA card, or with fewer than
the cell asks for, it exits 2 and prints no result; with JAX or the JAX
package loaded in its process, 3.

`--control lm` serves the LM one precision step below the configuration's
(bf16 -> int8, int8 -> int4); `--control codec` judges the reference's
TF32 rendering in place of the served audio (`--control lm,codec`: both).
Each must fail its number; the benchmark's own runs use neither.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """`perf_counter` at this process's start (its start time since boot,
    read from /proc), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import env, spec  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="comma-separated controls to switch on: lm, codec")
    return ap.parse_args(argv)


def _checks_line(verdict) -> dict:
    out = {}
    for k, v in verdict["numbers"].items():
        item = {"value": v if math.isfinite(v) else "inf"}
        if k in verdict["limits"]:
            item["limit"] = verdict["limits"][k]
        out[k] = item
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    bench = spec.load_bench(ROOT)
    cell = spec.Cell(bench, args.workload, ROOT)
    env.pin_caches(ROOT)
    try:
        kind = env.require_cards(cell.chips)
    except env.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    from perfbench.harness import session

    control = tuple(c for c in args.control.split(",") if c)
    if set(control) - {"lm", "codec"}:
        raise SystemExit(f"unknown control in {args.control!r}")
    opts = session.Options(control=control)
    opts.phases["_last"] = T_START
    out = session.run(cell.config, cell.traffic, args.seed, args.seconds, bool(args.trace), opts,
                      T_START)
    found = env.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    records = out["records"]
    if args.trace:
        metrics = spec.read_layer_metrics(cell.per_layer, records)
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out["e2e"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(out["verdict"]["correct"]), "attempted": out["verdict"]["attempted"],
              "failed": out["verdict"]["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = records["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    phases = {k: round(v, 3) for k, v in opts.phases.items() if not k.startswith("_")}
    print(f"setup_s {out['e2e']['setup_s']:.3f} phases {json.dumps(phases)}", file=sys.stderr)
    checks = _checks_line(out["verdict"])
    result["checks"] = checks
    for k, v in checks.items():
        limit = f" limit {v['limit']}" if "limit" in v else ""
        print(f"check {k} {v['value']}{limit}", file=sys.stderr)
    torch.cuda.synchronize()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
