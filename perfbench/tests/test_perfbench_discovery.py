"""Cells, configurations, mixes and per-layer readers are found by name
from BENCHMARK.json, and a new one takes new files and entries only."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.Cell(BENCH, cell, ROOT)
    assert c.config["name"] == c.workload["config"]
    assert {"budgets", "clients", "words"} <= set(c.traffic)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_readers_return_nothing_without_a_trace():
    records = {"trace": None, "stage": {}, "steps": 0, "lm_flops": 0.0, "window_s": 10.0,
               "slots": 8, "sample_rate": 16000, "config": {}}
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(records) is None, m["name"]


def test_a_new_cell_config_mix_and_metric_need_no_edit(tmp_path):
    """In a copy: a dummy configuration, mix and reader, and their entries,
    are found without an edit to any file already there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "spark-tts-0.5b-int8.json").read_text())
    (pb / "configs" / "dummy.json").write_text(json.dumps(dict(cfg, name="dummy")))
    mix = json.loads((pb / "traffic" / "create-c8.json").read_text())
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(dict(mix, clients=3)))
    (pb / "layer_metrics" / "dummy.metric.py").write_text(
        "def read(records):\n    return records['window_s'] * 2\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org",
                             "file": "perfbench/configs/dummy.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "x", "moves": "audio_s_per_s",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import sys; sys.path.insert(0, '.')\n"
        "from pathlib import Path\n"
        "from perfbench.harness import spec\n"
        "b = spec.load_bench(Path('.'))\n"
        "c = spec.Cell(b, 'dummy-cell', Path('.'))\n"
        "assert c.config['name'] == 'dummy' and c.traffic['clients'] == 3\n"
        "out = spec.read_layer_metrics(c.per_layer, {'window_s': 5.0, 'trace': None, 'stage': {},"
        " 'steps': 0, 'lm_flops': 0.0})\n"
        "print(out['dummy.metric']['value'])\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "10.0"
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []
