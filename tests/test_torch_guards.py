"""Guards of the PyTorch port: it imports neither JAX nor the JAX package
(nor `transformers` or `safetensors`: it reads checkpoints and tokenizers
with its own reader and the `tokenizers` package), its entry points do not
fall back to the CPU, its kernel wrappers launch on their tensors' card, and
its random init has the JAX init's tree at the full Spark-TTS-0.5B widths."""

import ast
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sparktts_tpu.codec.bicodec import init_bicodec as jax_init_bicodec
from sparktts_tpu.codec.quant import quantize_bicodec_int8 as jax_quantize_bicodec
from sparktts_tpu.config import SparkTTSConfig as JaxConfig
from sparktts_tpu.lm.quant import quantize_qwen_int4 as jax_quantize_int4
from sparktts_tpu.lm.quant import quantize_qwen_int8 as jax_quantize_int8
from sparktts_tpu.lm.qwen import init_qwen as jax_init_qwen
from sparktts_tpu.nn.wav2vec2 import init_wav2vec2 as jax_init_wav2vec2
from sparktts_tpu_torch import weights
from sparktts_tpu_torch.codec.quant import quantize_bicodec_int8
from sparktts_tpu_torch.config import SparkTTSConfig
from sparktts_tpu_torch.lm.quant import quantize_qwen_int4, quantize_qwen_int8

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import sparktts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sparktts_tpu_torch.__path__, "sparktts_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "sparktts_tpu" or m.startswith("sparktts_tpu.")
             or m.split(".")[0] in ("transformers", "safetensors"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("pipeline", "kernels.flash_attention", "kernels.decode_attention",
                 "kernels.vocoder_fusion", "kernels.int8_mlp", "kernels.int4_matmul",
                 "kernels.paged_attention", "lm.generate", "lm.graphs", "lm.continuous",
                 "lm.paged", "serve.streaming",
                 "lm.quant", "codec.quant", "io.audio", "dsp.mel", "nn.wav2vec2", "nn.ecapa",
                 "nn.perceiver", "codec.feat_encoder", "codec.fsq", "codec.fvq",
                 "codec.speaker_encoder", "codec.bicodec", "checkpoint", "utils.textseg",
                 "config", "prompt", "serve.server", "serve.voices", "serve.ui", "serve.client",
                 "serve.grpc_server", "serve.protos.sparktts_pb2", "utils.platform",
                 "utils.tokens", "cli", "webui", "bench", "bench.harness", "bench.metrics",
                 "bench.relay_probe", "lm.speculative", "lm.train", "lm.distill", "export",
                 "kernels.ops", "nn.pooling", "parallel", "parallel.mesh",
                 "parallel.shardings", "parallel.multihost", "parallel.worker", "io.native"):
        assert f"sparktts_tpu_torch.{name}" in res["modules"]
    assert res["bad"] == []


_IMPORT_FRONT = """
import importlib, json, sys
for n in ("serve.server", "serve.voices", "serve.client", "serve.ui", "cli", "webui",
          "utils.platform"):
    importlib.import_module("sparktts_tpu_torch." + n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sparktts_tpu", "grpc")
             or m == "google.protobuf" or m.startswith("google.protobuf."))
print(json.dumps(bad))
"""


_IMPORT_BENCH = """
import importlib.util, json, sys
for path in ("bench_torch.py", "scripts/benchmark_torch.py"):
    spec = importlib.util.spec_from_file_location(path.replace("/", "_")[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import sparktts_tpu_torch.bench.harness, sparktts_tpu_torch.bench.metrics
import sparktts_tpu_torch.bench.relay_probe, sparktts_tpu_torch.lm.speculative
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sparktts_tpu"))
print(json.dumps(bad))
"""


def test_bench_scripts_and_modules_import_no_jax():
    """The port's bench entry scripts (imported as modules: their work runs
    in `main`), the bench package and the speculative module import nothing
    of JAX or the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_BENCH], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


DEPLOY_AND_AB_SCRIPTS = ("run_server_torch", "run_dataset_bench_torch", "bench_first_chunk_torch",
                         "bench_paged_ab_torch", "bench_long_stream_torch",
                         "bench_dispatch_scaling_torch", "bench_speculative_torch",
                         "bench_decode_step_torch", "bench_decode_ablate_torch",
                         "bench_vocoder_torch", "time_torch_export")

_IMPORT_SCRIPTS = """
import importlib.util, json, sys
for name in %r:
    spec = importlib.util.spec_from_file_location(name, "scripts/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sparktts_tpu"))
print(json.dumps(bad))
""" % (DEPLOY_AND_AB_SCRIPTS,)


def test_deploy_and_ab_scripts_import_no_jax():
    """The deploy script, the serving A/B scripts and the attribution scripts
    (imported as modules: their work runs in `main`) import nothing of JAX or
    the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_SCRIPTS], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name", DEPLOY_AND_AB_SCRIPTS)
def test_deploy_and_ab_scripts_need_a_card(name, monkeypatch):
    """Each runs on the card unless --device or SPARKTTS_PLATFORM asks for
    the CPU, and raises without one before it serves or measures anything."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SPARKTTS_PLATFORM", raising=False)
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    argv = ["--port", "0"] if name == "run_server_torch" else ["--tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


def test_deploy_runbook_needs_a_card(tmp_path):
    """`deploy_torch.sh` runs its stages on the card unless
    SPARKTTS_PLATFORM=cpu, and stops at the first without one."""
    env = {k: v for k, v in os.environ.items() if k != "SPARKTTS_PLATFORM"}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = subprocess.run(["bash", str(REPO / "scripts" / "deploy_torch.sh"), "0", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(env, CUDA_VISIBLE_DEVICES="", WORK=str(tmp_path / "work"),
                                  PORT=str(port)))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "stage 0 OK" not in out.stdout


def test_front_doors_import_no_jax_grpc_or_protobuf():
    """The HTTP front, its client and the CLI need neither grpc nor
    google.protobuf (serve_http imports the gRPC front only for a gRPC
    port), and nothing of JAX."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_FRONT], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


WRAPPERS = ("flash_attention", "decode_attention", "vocoder_fusion", "int8_mlp", "int4_matmul",
            "paged_attention", "codec_gemm", "depthwise_conv")


def _cuda_stream_reads(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr == "cuda_stream"]


def test_kernel_wrappers_launch_inside_the_launch_helper():
    """A ctypes launch on the stream handle 0 (the default stream) goes to
    the current device, which need not be the tensor's.  So no wrapper reads
    a stream handle itself: each launches inside `build.launch_stream`, the
    one place that reads `.cuda_stream`, after making the tensor's card
    current."""
    kernels = REPO / "sparktts_tpu_torch" / "kernels"
    for name in WRAPPERS:
        src = (kernels / f"{name}.py").read_text()
        tree = ast.parse(src)
        assert not _cuda_stream_reads(tree), f"{name}.py reads .cuda_stream itself"
        assert not any(isinstance(n, ast.Attribute) and n.attr == "current_stream"
                       for n in ast.walk(tree)), f"{name}.py asks for a stream itself"
        helpers = [item.context_expr for n in ast.walk(tree) if isinstance(n, ast.With)
                   for item in n.items]
        assert any(ast.unparse(h.func) == "build.launch_stream" for h in helpers
                   if isinstance(h, ast.Call)), f"{name}.py does not launch in the helper"
    build = ast.parse((kernels / "build.py").read_text())
    helper = next(n for n in build.body if isinstance(n, ast.FunctionDef)
                  and n.name == "launch_stream")
    inside = {id(n) for n in _cuda_stream_reads(helper)}
    assert inside and all(id(n) in inside for n in _cuda_stream_reads(build))
    assert "torch.cuda.device" in ast.unparse(helper)


def test_int4_plain_version_stays_off_the_main_path():
    """The int4 kernel's plain version is named only by its own module (the
    wrapper runs it for CPU tensors) and by the op's CPU registration: the
    prefill on the card takes `nn/layers.int4_linear_wide`."""
    port = REPO / "sparktts_tpu_torch"
    users = sorted(str(f.relative_to(port)) for f in port.rglob("*.py")
                   if "int4_matvec_plain" in f.read_text())
    assert users == ["kernels/int4_matmul.py", "kernels/ops.py"], users
    ops = ast.parse((port / "kernels" / "ops.py").read_text())
    calls = [n for n in ast.walk(ops) if isinstance(n, ast.FunctionDef)
             and "int4_matvec_plain" in ast.unparse(n)]
    assert [ast.unparse(d) for n in calls for d in n.decorator_list] == [
        "int4_matvec.register_kernel('cpu')"]


def _tf32_writes(tree):
    """Assignments to an attribute named allow_tf32, and calls that pass one
    as a keyword (`torch.backends.cudnn.flags(allow_tf32=...)`)."""
    out = []
    for n in ast.walk(tree):
        targets = (n.targets if isinstance(n, ast.Assign) else [n.target]
                   if isinstance(n, (ast.AugAssign, ast.AnnAssign)) else [])
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Attribute) and sub.attr == "allow_tf32":
                    out.append(ast.unparse(n))
        if isinstance(n, ast.Call) and any(k.arg == "allow_tf32" for k in n.keywords):
            out.append(ast.unparse(n))
        if isinstance(n, ast.Call) and ast.unparse(n.func).endswith("setattr") and any(
                isinstance(a, ast.Constant) and a.value == "allow_tf32" for a in n.args):
            out.append(ast.unparse(n))
    return out


def test_port_sets_no_tf32_flag_and_full_fp32_is_gone():
    """The codec pins its own precision per call (`nn/layers.codec_fp32`, a
    context variable): no module of the port, and no script of it, assigns
    a TF32 flag, and the process-wide `full_fp32` bookkeeping is gone."""
    import sparktts_tpu_torch.nn.layers as layers

    files = sorted((REPO / "sparktts_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "scripts").glob("*_torch*.py")) + [REPO / "bench_torch.py"]
    found = {str(f.relative_to(REPO)): w for f in files
             if (w := _tf32_writes(ast.parse(f.read_text())))}
    assert found == {}
    assert not hasattr(layers, "full_fp32")
    assert not any("full_fp32" in f.read_text() for f in files)
    assert _tf32_writes(ast.parse("torch.backends.cudnn.allow_tf32 = False"))  # the probe sees one


def test_pipeline_without_device_needs_a_card(monkeypatch):
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparkTTSPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparkTTSPipeline(speculative_k=4, draft_layers=6)


def test_training_distillation_and_export_need_a_card(monkeypatch):
    """The train state, the distillation entry points and the pipeline an
    export reads default to the card and raise without one."""
    from sparktts_tpu_torch.lm import distill, train
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.zeros((2, 2), np.float32)}
    for call in (lambda: train.init_train_state(tree, train.make_optimizer()),
                 lambda: train.load_train_state("missing", train.make_optimizer()),
                 lambda: distill.make_cycler_teacher(),
                 lambda: SparkTTSPipeline()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_bench_runners_default_to_the_card_and_raise_without_one(monkeypatch):
    """Every runner that takes a pipeline serves its device, the card by
    default, and raises before it starts a server when that card is
    missing; so do the metrics' `mel_distance` and the dispatch probe."""
    import types

    from sparktts_tpu_torch.bench import harness, metrics, relay_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_card = types.SimpleNamespace(device=torch.device("cuda"), guided=True)
    task = [harness.BenchTask(text="hi", gender="female")]
    for run in (harness.run_offline_benchmark, harness.run_streaming_benchmark,
                harness.run_continuous_benchmark, harness.run_longform_benchmark,
                harness.run_grpc_streaming_benchmark):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(on_card, task)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.mel_distance(np.zeros(2048), np.zeros(2048))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relay_probe.measure_dispatch_tax()


def test_front_doors_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path):
    """serve_http serves the pipeline's device (the card by default) and
    raises before it binds a socket when that card is missing; the CLI and
    the web UI take the card unless SPARKTTS_PLATFORM or --device asks for
    the CPU."""
    import types

    from sparktts_tpu_torch.cli import parse_args, run_tts
    from sparktts_tpu_torch.serve.server import serve_http
    from sparktts_tpu_torch.webui import initialize_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SPARKTTS_PLATFORM", raising=False)
    on_card = types.SimpleNamespace(device=torch.device("cuda"), guided=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http(on_card, host="127.0.0.1", port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tts(parse_args(["--text", "hi", "--save_dir", str(tmp_path)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_model(None, max_new_tokens=8)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_random_init_has_the_jax_tree_at_full_width():
    """Same keys and shapes as jax.eval_shape of the JAX inits (which
    allocate nothing), for the LM, the whole BiCodec tree (encode and decode
    sides) and wav2vec2; the torch side is built on the meta device."""
    jcfg, tcfg = JaxConfig(), SparkTTSConfig()
    assert tcfg.llm.num_hidden_layers == 24 and tcfg.bicodec.decoder.channels == 1536
    assert tcfg.wav2vec2.num_hidden_layers == 24 and tcfg.wav2vec2.hidden_size == 1024
    key = jax.random.PRNGKey(0)
    jq = jax.eval_shape(lambda k: jax_init_qwen(k, jcfg.llm), key)
    jb = jax.eval_shape(lambda k: jax_init_bicodec(k, jcfg.bicodec), key)
    jw = jax.eval_shape(lambda k: jax_init_wav2vec2(k, jcfg.wav2vec2), key)
    tq = weights.init_qwen(tcfg.llm, device="meta")
    tb = weights.init_bicodec(tcfg.bicodec, device="meta")
    tw = weights.init_wav2vec2(tcfg.wav2vec2, device="meta")
    assert _shapes(tq) == _shapes(jq)
    assert _shapes(tb) == _shapes(jb)
    assert set(tb) == {"encoder", "quantizer", "speaker_encoder", "prenet", "postnet", "decoder"}
    assert _shapes(tw) == _shapes(jw)


def test_numpy_tree_converts_with_dtypes():
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.zeros(4, np.float64)], "i": np.arange(3)}
    out = weights.qwen_state(tree, "cpu", torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["b"][0].dtype == torch.bfloat16
    assert out["i"].dtype == torch.int64


def _shapes_and_dtypes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
            for path, leaf in leaves}


def test_quantized_trees_have_the_jax_keys_shapes_and_dtypes_at_full_width():
    """int8 and int4 (group 128) LM trees from bf16 params, and the int8
    BiCodec tree: the same keys, shapes and dtypes (int8 weights, fp32
    scales) as the JAX package's, via jax.eval_shape and the meta device."""
    jcfg, tcfg = JaxConfig(), SparkTTSConfig()
    key = jax.random.PRNGKey(0)
    jq = jax.eval_shape(lambda k: jax_init_qwen(k, jcfg.llm, dtype=jax.numpy.bfloat16), key)
    tq = weights.init_qwen(tcfg.llm, device="meta")
    for jax_fn, torch_fn in ((jax_quantize_int8, quantize_qwen_int8),
                             (jax_quantize_int4, quantize_qwen_int4)):
        want = _shapes_and_dtypes(jax.eval_shape(jax_fn, jq))
        got = _shapes_and_dtypes(torch_fn(tq))
        assert got == want
    assert got["['layers']['down']['gscale']"] == ((24, 38, 896), "float32")
    jb = jax.eval_shape(lambda k: jax_quantize_bicodec(jax_init_bicodec(k, jcfg.bicodec)), key)
    got = _shapes_and_dtypes(quantize_bicodec_int8(weights.init_bicodec(tcfg.bicodec,
                                                                        device="meta")))
    assert got == _shapes_and_dtypes(jb)


def test_native_audio_builds_only_under_build(tmp_path, monkeypatch):
    """The port builds the host audio library from the repo's
    `csrc/sparktts_audio.cpp` into `build/native/` (here redirected to a
    temporary `build/native/`), and writes nothing under `csrc/`, which the
    JAX package owns."""
    from sparktts_tpu_torch.io import native

    if subprocess.run(["which", "g++"], capture_output=True).returncode != 0:
        pytest.skip("no g++")
    assert native.library_path().parent == REPO / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    csrc = native.SOURCE.parent
    before = {p.name: p.stat().st_mtime_ns for p in csrc.iterdir()}
    target = native.library_path()
    native._build(target)
    assert target.exists() and target.parent == tmp_path / "build" / "native"
    assert sorted(p.name for p in target.parent.iterdir()) == [target.name]
    assert {p.name: p.stat().st_mtime_ns for p in csrc.iterdir()} == before

