"""The port's serving A/B scripts and dataset bench (`scripts/*_torch.py`),
each run in-process through its `main` with `--tiny --device cpu` and a few
tasks.  Each JSON document holds the keys of its JAX script's (read from
the JAX script's source: the dict literals it prints, and the keys it
assigns), and where the arms must agree they do on the CPU: the windowed
and the full-prefix stream give the same samples (bit for bit: oneDNN off,
which picks its conv algorithm by length), the dense and the paged engine
the same greedy ids, and the draft that is the target accepts (k - 1) / k.
"""

import ast
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.bench import harness

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # batched torch work: one intra-op thread under xdist
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_keys(script: str, name: str) -> set:
    """The keys a JAX script gives the dict it binds to `name`: the keys of
    a dict literal assigned to it, of `name.update(key=...)` and of
    `name["key"] = ...`; for a list `name`, of the dict literals it
    appends."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == name and \
                        isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
                if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name) \
                        and target.value.id == name and isinstance(target.slice, ast.Constant):
                    keys.add(target.slice.value)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and node.func.value.id == name:
            if node.func.attr == "update":
                keys |= {k.arg for k in node.keywords}
            if node.func.attr == "append" and node.args and isinstance(node.args[0], ast.Dict):
                keys |= {k.value for k in node.args[0].keys if isinstance(k, ast.Constant)}
    assert keys, f"no keys of {name} in {script}"
    return keys


@pytest.fixture
def eos_off(monkeypatch):
    """Script pipelines that run their whole budget (random weights draw EOS
    at chance level) and stream 4-token first chunks, so a short budget
    spans several chunks."""
    from sparktts_tpu_torch import config

    tiny = config.tiny_test_config

    def small_chunks():
        cfg = tiny()
        return dataclasses.replace(cfg, streaming=dataclasses.replace(cfg.streaming,
                                                                      frame_rate=4))

    make = harness.script_pipeline

    def no_eos(*args, **kwargs):
        pipe = make(*args, **kwargs)
        pipe.tokenizer.eos_ids = ()
        return pipe

    monkeypatch.setattr(config, "tiny_test_config", small_chunks)
    monkeypatch.setattr(harness, "script_pipeline", no_eos)


def test_make_tasks_is_the_jax_scripts():
    jax_script = _script("run_dataset_bench")
    for args in ((5, (16, 24, 32), (1,)), (4, (500,), (3, 6))):
        got, want = harness.make_tasks(*args), jax_script.make_tasks(*args)
        assert [(t.text, t.max_new_tokens, t.prompt_text) for t in got] == \
            [(t.text, t.max_new_tokens, t.prompt_text) for t in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.prompt_wav, b.prompt_wav)


def test_results_never_land_in_the_tree(tmp_path):
    results = _script("results_torch")
    assert results.write_result(tmp_path / "a.json", {"x": 1}).read_text()
    with pytest.raises(ValueError, match="inside the repo"):
        results.write_result(REPO / "BENCH_X.json", {})
    with pytest.raises(ValueError, match="inside the repo"):
        results.write_result("../BENCH_X.json", {})
    written = results.write_result("pytest_write_result.json", {})
    assert written.parent == REPO / "chiprun_out"
    written.unlink()


def test_run_dataset_bench(tmp_path):
    doc = _script("run_dataset_bench_torch").main([
        "--tiny", "--device", "cpu", "--tasks", "2", "--offline_conc", "1",
        "--streaming_conc", "1", "--longform_requests", "1", "--grpc_conc", "1",
        "--out", str(tmp_path / "ds.json")])
    assert set(doc) == _jax_keys("run_dataset_bench.py", "results")
    assert json.loads((tmp_path / "ds.json").read_text()) == doc
    modes = [r["mode"] for r in doc["runs"]]
    assert modes == ["offline", "continuous_offline", "continuous_streaming",
                     "continuous_streaming_longform", "grpc_streaming"]
    for run in doc["runs"]:
        assert {"rtf", "p50_latency_ms", "p99_latency_ms", "num_tasks", "dispatch_tax"} <= set(run)
        assert run["rtf"] > 0
    assert set(doc["codec_quality"]) == {"per_prompt", "mel_distance_l1_mean",
                                         "speaker_similarity_mean"}
    assert set(doc["codec_quality"]["per_prompt"][0]) == _jax_keys("run_dataset_bench.py",
                                                                   "qual")
    assert doc["backend"] == "cpu" and doc["tasks"] == 2


def test_bench_first_chunk():
    doc = _script("bench_first_chunk_torch").main(["--tiny", "--device", "cpu", "--tasks", "2"])
    assert set(doc) == _jax_keys("bench_first_chunk.py", "results") | {"fused", "chained",
                                                                       "voice_cache"}
    for mode in ("fused", "chained", "voice_cache"):
        row = doc[mode]
        assert {"rtf", "p50_latency_ms", "per_task", "stage_stats", "first_chunk_p50_ms",
                "first_chunk_p90_ms", "dispatch_tax", "cold_pass"} <= set(row)
    # the arms differ where they should: fused admissions only where fused
    assert doc["chained"]["server_stats"].get("fused_admissions", 0) == 0
    assert doc["fused"]["server_stats"]["fused_admissions"] > 0
    assert doc["voice_cache"]["voice_cache_stats"]["hits"] > 0


def test_bench_paged_ab_arms_agree(eos_off):
    doc = _script("bench_paged_ab_torch").main(["--tiny", "--device", "cpu", "--tasks", "2",
                                                "--concurrency", "1"])
    assert _jax_keys("bench_paged_ab.py", "results") <= set(doc)
    row_keys = _jax_keys("bench_paged_ab.py", "row")
    assert [(r["engine"], r["streaming"]) for r in doc["runs"]] == [
        ("dense", False), ("dense", True), ("paged", False), ("paged", True)]
    for row in doc["runs"]:
        assert row_keys <= set(row)
        assert row["streaming"] == ("first_chunk_p50_ms" in row)
    assert doc["agreement"]["greedy_ids_equal"]
    assert doc["agreement"]["first_diff"] == [None, None]
    assert doc["agreement"]["near_ties"] == [None, None]
    assert doc["agreement"]["tokens"] == sum(t.max_new_tokens for t in
                                             harness.make_tasks(2, (16, 24, 32), (1,)))


def test_bench_paged_ab_near_tie_witness(eos_off):
    """The witness the A/B computes where the arms part: its plain forward
    over the request's prompt and prefix picks the id the greedy server
    emitted there, and its gap is the top two logits'."""
    script = _script("bench_paged_ab_torch")
    pipe = harness.script_pipeline(True, "cpu", 32)
    task = harness.make_tasks(1, (16,), (1,))[0]
    ids = script.greedy_ids(pipe, [task], False)[0]
    for step in (0, 5, len(ids) - 1):
        w = script.near_tie(pipe, task, ids, step)
        assert w["step"] == step and w["top2_ids"][0] == ids[step]
        assert w["top2"][0] >= w["top2"][1]
        assert w["near_tie"] == (w["rel_gap"] <= script.LOGITS_REL_TOL)


def test_bench_long_stream_arms_give_the_same_samples(eos_off):
    with torch.backends.mkldnn.flags(enabled=False):
        doc = _script("bench_long_stream_torch").main(["--tiny", "--device", "cpu",
                                                       "--max_new_tokens", "40",
                                                       "--passes", "1"])
    assert _jax_keys("bench_long_stream.py", "results") <= set(doc)
    arm_keys = _jax_keys("bench_long_stream.py", "out")
    for arm in ("windowed", "full_prefix"):
        assert arm_keys <= set(doc[arm])
        assert doc[arm]["chunks"] >= 3 and doc[arm]["gap_p50_ms"] is not None
    assert doc["windowed"]["samples"] == doc["full_prefix"]["samples"] > 0
    assert doc["same_audio"]


def test_bench_dispatch_scaling(capsys):
    doc = _script("bench_dispatch_scaling_torch").main([
        "--tiny", "--device", "cpu", "--rungs", "4,8", "--iters", "2", "--cache_len", "256"])
    out = capsys.readouterr().out
    # the JAX script's lines, then the JSON object
    assert re.search(r"^warm n=8: \d+ ms$", out, re.M)
    assert re.search(r"^n_steps=   8: best +[\d.]+ ms +[\d.]+ ms/step +\(all: ", out, re.M)
    assert [r["n_steps"] for r in doc["rungs"]] == [4, 8]
    for r in doc["rungs"]:
        assert r["ms_per_step"] == pytest.approx(r["best_ms"] / r["n_steps"])
        assert len(r["all_ms"]) == 2


def test_bench_speculative_draft_equal_to_target_accepts_at_the_ceiling():
    doc = _script("bench_speculative_torch").main(["--tiny", "--device", "cpu", "--repeats",
                                                   "1"])
    assert _jax_keys("bench_speculative.py", "doc") <= set(doc)
    rows = {r["config"]: r for r in doc["results"]}
    assert list(rows) == ["vanilla_greedy", "self_spec_draft8_k4", "self_spec_draft6_k4",
                          "self_spec_draft4_k2", "self_spec_draft4_k4", "self_spec_draft4_k8"]
    assert _jax_keys("bench_speculative.py", "base") <= set(rows["vanilla_greedy"])
    for name, row in rows.items():
        if name != "vanilla_greedy":
            assert {"config", "tok_s", "ms_total", "acceptance", "tokens_out"} <= set(row)
            assert row["first_diff_vs_vanilla"] is None
    assert rows["self_spec_draft8_k4"]["acceptance"] == 0.75  # (k - 1) / k
