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


def _jax_row_keys(script: str, name: str) -> set:
    """The keys of the dict literals a JAX script assigns to `name[...]`
    (its per-row results)."""
    keys = set()
    for node in ast.walk(ast.parse((REPO / "scripts" / script).read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for target in node.targets:
                if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name) \
                        and target.value.id == name:
                    keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    assert keys, f"no row keys of {name} in {script}"
    return keys


def _jax_default(script: str, option: str):
    """The default of `option` in a JAX script's argparse."""
    for node in ast.walk(ast.parse((REPO / "scripts" / script).read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "add_argument" and node.args and \
                getattr(node.args[0], "value", None) == option:
            return next(k.value.value for k in node.keywords if k.arg == "default")
    raise AssertionError(f"no {option} in {script}")


def test_bench_decode_step_units_give_the_eager_greedy_ids(capsys):
    """Every unit size's greedy ids equal the eager loop's; each row holds
    the JAX script's keys and prints its line."""
    doc = _script("bench_decode_step_torch").main([
        "--tiny", "--device", "cpu", "--n_steps", "8", "--iters", "1", "--units", "1,2,8",
        "--t_pad", "32", "--cache_len", "128"])
    row_keys = _jax_row_keys("bench_decode_step.py", "results")
    assert row_keys == {"ms_per_token", "tok_s", "compile_s"}
    names = [f"{u}_{m}" for u in ("eager", "unit1", "unit2", "unit8")
             for m in ("sampled", "greedy")]
    for name in names:
        assert set(doc[name]) == row_keys and doc[name]["ms_per_token"] > 0
    assert doc["greedy_first_diff"] == {"unit1_greedy": None, "unit2_greedy": None,
                                        "unit8_greedy": None}
    assert re.search(r"^unit2_greedy \{\"ms_per_token\": ", capsys.readouterr().out, re.M)


def test_bench_decode_step_sweep_fits_its_rows():
    doc = _script("bench_decode_step_torch").main([
        "--tiny", "--device", "cpu", "--iters", "1", "--sweep_steps", "8,16,24",
        "--t_pad", "16", "--cache_len", "64"])
    assert _jax_keys("bench_decode_step.py", "doc") <= set(doc)
    assert [r["scan_steps"] for r in doc["rows"]] == [8, 16, 24]
    for r in doc["rows"]:
        assert set(r) == _jax_keys("bench_decode_step.py", "rows")
    slope, tax = np.polyfit([8, 16, 24], [r["ms_total"] for r in doc["rows"]], 1)
    assert doc["fit"]["dispatch_tax_ms"] == pytest.approx(tax)
    assert doc["fit"]["per_step_floor_ms"] == pytest.approx(slope)


def test_bench_decode_ablate_times_the_six_variants():
    doc = _script("bench_decode_ablate_torch").main(["--tiny", "--device", "cpu", "--n_steps",
                                                     "4", "--iters", "1"])
    variants = _jax_default("bench_decode_ablate.py", "--variants").split(",")
    assert len(variants) == 6
    for v in variants:
        assert doc[v] > 0 and doc["launches_per_replay"][v] == {}  # the CPU: plain versions


def _jax_vocoder_stages(cfg, batch, t_in):
    """The JAX script's stage list and `flops` for `cfg`: the statements of
    its `main` from `stages = [` through `def flops`, run with stand-ins for
    the functions the stages name (none is called)."""
    tree = ast.parse((REPO / "scripts" / "bench_vocoder.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    first = next(i for i, n in enumerate(main.body) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "stages")
    last = next(i for i, n in enumerate(main.body) if isinstance(n, ast.FunctionDef)
                and n.name == "flops")
    ns = {"cfg": cfg, "B": batch, "T": t_in}
    ns.update(dict.fromkeys(("conv1d_apply", "snake_apply", "_decoder_block_apply",
                             "wave_generator_apply", "jnp")))
    module = ast.Module(body=main.body[first:last + 1], type_ignores=[])
    exec(compile(module, "bench_vocoder.py", "exec"), ns)
    return ns["stages"], ns["flops"]


def test_bench_vocoder_stages_and_flops_are_the_jax_scripts():
    from sparktts_tpu.config import WaveGeneratorConfig as JaxWaveGeneratorConfig

    script = _script("bench_vocoder_torch")
    doc = script.main(["--tiny", "--device", "cpu"])
    stages, flops = _jax_vocoder_stages(JaxWaveGeneratorConfig(
        input_channel=32, channels=48, rates=(2, 2), kernel_sizes=(4, 4)), 1, 16)
    assert script.TINY == dict(input_channel=32, channels=48, rates=(2, 2), kernel_sizes=(4, 4))
    for mode in ("kernel", "plain"):
        assert list(doc[mode]) == [name for name, _, _ in stages]
        for name, _, shape in stages:
            row = doc[mode][name]
            assert set(row) == {"ms", "gflop", "tflops"} and row["ms"] > 0
            assert row["gflop"] == flops(name, shape) / 1e9


def test_bench_vocoder_full_stage_is_the_vocoder():
    """Each mode's `full` stage is `wave_generator_apply` of the same
    params and input; `_decoder_block_apply` without a unit is the block as
    the codec runs it (the kernel module for float weights, the unfused unit
    for an int8 tree)."""
    from sparktts_tpu_torch.codec import wave_generator as wg
    from sparktts_tpu_torch.codec.quant import quantize_bicodec_int8
    from sparktts_tpu_torch.config import WaveGeneratorConfig
    from sparktts_tpu_torch.kernels.vocoder_fusion import fused_residual_unit_plain
    from sparktts_tpu_torch.nn.layers import conv_transpose1d_apply, snake_apply
    from sparktts_tpu_torch.weights import init_wave_generator

    script = _script("bench_vocoder_torch")
    cfg = WaveGeneratorConfig(**script.TINY)
    params = init_wave_generator(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(1, 16, cfg.input_channel, generator=torch.Generator().manual_seed(1))
    want = wg.wave_generator_apply(params, x, cfg)
    for unit in (None, script.unit_fn("kernel"), script.unit_fn("plain")):
        full = {name: fn for name, fn, _ in script.stages(cfg, 1, 16, unit)}["full"]
        torch.testing.assert_close(full(params, x), want, rtol=0, atol=0)

    def block_as_before(p, y, k, s):
        y = conv_transpose1d_apply(p["upsample"], snake_apply(p["snake"], y), stride=s,
                                   padding=(k - s) // 2).contiguous()
        for ru, dil in zip(p["res_units"], wg.DILATIONS):
            y = fused_residual_unit_plain(ru, y, dil)
        return y

    y = torch.randn(1, 16, cfg.channels, generator=torch.Generator().manual_seed(2))
    block = params["blocks"][0]
    int8_block = quantize_bicodec_int8({"decoder": params})["decoder"]["blocks"][0]
    for p in (block, int8_block):
        torch.testing.assert_close(wg._decoder_block_apply(p, y, 4, 2),
                                   block_as_before(p, y, 4, 2), rtol=0, atol=0)


def test_time_torch_export_replays_the_eager_ids():
    doc = _script("time_torch_export").main([
        "--tiny", "--device", "cpu", "--lm", "int8", "--new_tokens", "3", "--prompt_len", "16",
        "--decode_len", "4"])
    row = doc["int8"]
    assert row["ops"] == {"dense_decode_attention": 2, "int8_mlp_matvec": 2}
    assert row["first_apart"] is None and row["logits_rel_err"] == 0.0
    assert row["capture_ms"] == []  # the CPU captures nothing
