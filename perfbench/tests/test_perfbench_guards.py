"""What a run refuses: JAX in its process (by whole top-level names), a
machine without the card it asks for, a checkout without the program."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import env

ROOT = Path(__file__).resolve().parents[2]
RUN = ["perfbench/run.py", "--workload", "create-int8-c8", "--seed", "2147483700",
       "--seconds", "1", "--trace", "0"]


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["sparktts_tpu_torch", "sparktts_tpu_torch.lm.qwen", "jaxtyping", "flax_like",
             "jax", "jax.numpy", "jaxlib.xla", "sparktts_tpu", "sparktts_tpu.pipeline", "flax.nn"]
    assert env.forbidden_modules(names) == [
        "flax.nn", "jax", "jax.numpy", "jaxlib.xla", "sparktts_tpu", "sparktts_tpu.pipeline"]


def test_the_harness_and_the_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import perfbench.reference.qwen, perfbench.reference.bicodec, perfbench.reference.prompt\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'sparktts_tpu_torch']\n"
            "import perfbench.harness.session, perfbench.harness.check\n"
            "from perfbench.tests.tiny import tiny_config\n"
            "perfbench.harness.session.program_config(tiny_config())\n"
            "from perfbench.harness import env\n"
            "print(env.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _run(cwd):
    return subprocess.run([sys.executable, *RUN], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                            "HOME": str(cwd), "TMPDIR": str(cwd)})


def test_no_card_fails_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for a machine without one")
    res = _run(ROOT)
    assert res.returncode == 2, res.stderr
    assert res.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in res.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_benchmark_json_keeps_to_its_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(w["chips"] == 1 for w in bench["workloads"])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
