"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points do not fall back to the CPU, and its random init has the
JAX init's tree at the full Spark-TTS-0.5B widths."""

import json
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
             or m == "sparktts_tpu" or m.startswith("sparktts_tpu."))
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
                 "lm.quant", "codec.quant", "io.audio", "dsp.mel", "nn.wav2vec2", "nn.ecapa",
                 "nn.perceiver", "codec.feat_encoder", "codec.fsq", "codec.fvq",
                 "codec.speaker_encoder", "codec.bicodec"):
        assert f"sparktts_tpu_torch.{name}" in res["modules"]
    assert res["bad"] == []


def test_pipeline_without_device_needs_a_card(monkeypatch):
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparkTTSPipeline()


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
