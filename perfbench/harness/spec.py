"""What a run measures, found by name from `BENCHMARK.json`.

A cell names a configuration and a traffic mix; each is a JSON file of its
own (`configs/<file>`, `traffic/<name>.json`), and each per-layer metric a
reader of its own (`layer_metrics/<name>.py`, a function `read(records)`).
A new cell or metric is new files and new entries, never an edit here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


class Cell:
    """One workload of `BENCHMARK.json` with its configuration, its traffic
    and the metrics it reports."""

    def __init__(self, bench: Dict, name: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.traffic_name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_bench(root: Path) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: run from the root of a checkout")
    return json.loads(path.read_text())


def reader(metric_name: str) -> Callable[[Dict], Optional[float]]:
    """The `read` function of `layer_metrics/<metric_name>.py`."""
    path = BENCH_DIR / "layer_metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_layer_metrics(metrics: List[Dict], records: Dict) -> Dict[str, Dict]:
    """Each per-layer metric its reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
