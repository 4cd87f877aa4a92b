"""Checkpoint loading in the port against the JAX package: the safetensors
reader, the config loaders, the three converters, the checkpoint's
tokenizer, and a `model_dir` pipeline.

The torch-named states are made from a seed with `chip_smoke`'s shape
builders (a port of `tests/test_checkpoint.py`'s, extended to the LM and
wav2vec2) and go through both packages' converters: every leaf must equal
JAX's, exactly for the copies and transposes and within 1e-6 of its scale
for a weight-norm fold (float64 sums in another order).  The reader must
equal `safetensors.torch` for F32, F16 and BF16, and JAX's reader; JAX's
reader reads BF16 only once `ml_dtypes` (imported with jax) has given numpy
a bfloat16, and raises in a process that imported only the JAX package's
`checkpoint` module, which is pinned here.  A tiny checkpoint (F32 files)
loads into one JAX and one port pipeline, whose trees, prompt ids and
greedy ids must be equal.  The converted-tree cache (`save_param_cache` /
`load_param_cache`, written by the port's safetensors writer) gives back
its tree bit for bit, and a second pipeline over the same directory reads
it, converts nothing, and holds the first one's trees bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

import chip_smoke
from sparktts_tpu import checkpoint as jckpt
from sparktts_tpu.config import load_spark_config as jax_load_spark_config
from sparktts_tpu.config import load_yaml_config as jax_load_yaml_config
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu.prompt import HFSparkTokenizer as JaxHFSparkTokenizer
from sparktts_tpu_torch import checkpoint as ckpt
from sparktts_tpu_torch.config import (
    SparkTTSConfig,
    load_spark_config,
    load_yaml_config,
    tiny_test_config,
)
from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import HFSparkTokenizer, build_clone_prompt, build_control_prompt

FIXTURE = chip_smoke.REPO / "tests" / "fixtures" / "spark_tts_0.5b"
WN_FOLD_TOL = 1e-6  # relative to the leaf's largest magnitude
CFG = tiny_test_config()


def _leaves(tree, prefix=()):
    """{path: numpy array} of a tree of dicts and lists (numpy, jax or torch
    leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, prefix + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy() if tree.is_floating_point() else tree.numpy()}
    return {prefix: np.asarray(tree)}


def _weight_norm_folded(path) -> bool:
    """The leaves that a weight-norm fold made (WaveGenerator convs, the FVQ
    projections, wav2vec2's positional conv)."""
    return path[-1] == "w" and (path[0] in ("decoder", "pos_conv")
                                or path[:2] in (("quantizer", "in_project"),
                                                ("quantizer", "out_project")))


def assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    folds = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if _weight_norm_folded(path):
            folds += 1
            np.testing.assert_allclose(g, w, rtol=0, atol=WN_FOLD_TOL * np.abs(w).max(),
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    return folds


def _state(shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return chip_smoke.random_state(shapes, gen, "cpu", torch.float32, std=0.2)


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


# --------------------------------------------------------------------- reader


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_reader_equals_safetensors_and_jax(tmp_path, dtype):
    gen = torch.Generator().manual_seed(1)
    tensors = {
        "a.weight": torch.randn((5, 7), generator=gen).to(dtype),
        "b": torch.randn((3,), generator=gen).to(dtype),
        "c.scalar": torch.randn((), generator=gen).to(dtype),
        "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
    }
    path = tmp_path / "x.safetensors"
    st_save_file(tensors, str(path))
    got, want = ckpt.load_safetensors(path), st_load_file(str(path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    jax_state = jckpt.load_safetensors(path)  # numpy's bfloat16 comes from ml_dtypes (jax)
    for k in want:
        assert str(jax_state[k].dtype) == str(got[k].dtype).split(".")[-1]
        np.testing.assert_array_equal(got[k].float().numpy() if got[k].is_floating_point()
                                      else got[k].numpy(), jax_state[k].astype(
                                          np.float32 if got[k].is_floating_point() else None))
    if dtype == torch.bfloat16:
        # the reference-side limit: without jax (and so ml_dtypes) imported,
        # the JAX package's reader cannot make a bfloat16 numpy array
        alone = subprocess.run(
            [sys.executable, "-c", "import sys; from sparktts_tpu import checkpoint; "
             "checkpoint.load_safetensors(sys.argv[1])", str(path)],
            cwd=chip_smoke.REPO, capture_output=True, text=True, timeout=120)
        assert alone.returncode != 0
        assert "TypeError: data type 'bfloat16' not understood" in alone.stderr


def test_chip_smoke_writer_reads_back(tmp_path):
    """The writer that makes chip_smoke's checkpoint gives files that
    safetensors and the port's reader read as written."""
    gen = torch.Generator().manual_seed(2)
    tensors = {"x": torch.randn((4, 3), generator=gen).to(torch.bfloat16),
               "y": torch.randn((2, 2, 5), generator=gen), "z": torch.randn((), generator=gen)}
    path = tmp_path / "w.safetensors"
    chip_smoke.write_safetensors(path, tensors)
    for read in (st_load_file(str(path)), ckpt.load_safetensors(path)):
        assert read.keys() == tensors.keys()
        for k, v in tensors.items():
            assert read[k].dtype == v.dtype and torch.equal(read[k], v)


def test_hf_state_shards_and_bin(tmp_path):
    tensors = {"p": torch.arange(4.0), "q": torch.ones(2, 2)}
    shards = tmp_path / "sharded"
    shards.mkdir()
    st_save_file({"p": tensors["p"]}, str(shards / "model-00001-of-00002.safetensors"))
    st_save_file({"q": tensors["q"]}, str(shards / "model-00002-of-00002.safetensors"))
    binary = tmp_path / "bin"
    binary.mkdir()
    torch.save(tensors, binary / "pytorch_model.bin")
    for d in (shards, binary):
        got = ckpt.load_hf_state(d)
        assert got.keys() == tensors.keys()
        assert all(torch.equal(got[k], v) for k, v in tensors.items())
    with pytest.raises(FileNotFoundError):
        ckpt.load_hf_state(tmp_path / "empty")


# ---------------------------------------------------------------- converters


@pytest.mark.parametrize("tied", [True, False])
def test_convert_qwen_equals_jax(tied):
    cfg = dataclasses.replace(CFG.llm, tie_word_embeddings=tied)
    state = _state(chip_smoke.qwen_torch_shapes(cfg))
    got = ckpt.convert_qwen(state, cfg)
    assert ("lm_head" in got) is not tied
    assert assert_trees_equal(got, jckpt.convert_qwen(_numpy(state), cfg)) == 0


def test_convert_wav2vec2_equals_jax():
    state = _state(chip_smoke.wav2vec2_torch_shapes(CFG.wav2vec2))
    got = ckpt.convert_wav2vec2(state, CFG.wav2vec2)
    assert assert_trees_equal(got, jckpt.convert_wav2vec2(_numpy(state), CFG.wav2vec2)) == 1


def test_convert_bicodec_equals_jax_and_the_init_tree():
    from sparktts_tpu_torch.weights import init_bicodec

    state = _state(chip_smoke.bicodec_torch_shapes(CFG.bicodec))
    got = ckpt.convert_bicodec(state, CFG.bicodec)
    folds = assert_trees_equal(got, jckpt.convert_bicodec(_numpy(state), CFG.bicodec))
    assert folds == 2 + 7 * len(CFG.bicodec.decoder.rates) + 2  # conv in/out, blocks, FVQ
    init = _leaves(init_bicodec(CFG.bicodec, device="cpu"))
    assert {k: v.shape for k, v in _leaves(got).items()} == {k: v.shape for k, v in init.items()}


def test_speaker_project_permutation():
    """The permuted projection on the (token, latent) flattening equals the
    torch weight on the (latent, token) one."""
    d, n, o = 4, 3, 5
    w = torch.randn((o, d * n), generator=torch.Generator().manual_seed(3))
    p = ckpt._speaker_project_permuted({"p.weight": w}, "p", d, n)
    zq = torch.randn((2, n, d), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(zq.reshape(2, -1) @ p["w"], zq.transpose(1, 2).reshape(2, -1) @ w.T)


# -------------------------------------------------------------------- config


def test_load_spark_config_of_the_fixture_is_the_default():
    got = load_spark_config(FIXTURE)
    assert got == SparkTTSConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_load_spark_config(FIXTURE))


def test_load_yaml_config_merges_base_config(tmp_path):
    (tmp_path / "base.yaml").write_text("a: 1\nb: {c: [1, 2], d: null}\nflag: true\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "mid.yaml").write_text("base_config: ../base.yaml\na: 2  # override\n")
    (tmp_path / "top.yaml").write_text("base_config: sub/mid.yaml\ne: false\n")
    got = load_yaml_config(tmp_path / "top.yaml")
    assert got == {"a": 2, "b": {"c": [1, 2], "d": None}, "flag": True, "e": False}
    assert got == jax_load_yaml_config(tmp_path / "top.yaml")


# ----------------------------------------------------------------- tokenizer


def test_hf_tokenizer_equals_jax(tmp_path):
    chip_smoke.write_spark_tokenizer(tmp_path / "LLM", n_semantic=128, n_global=64)
    got = HFSparkTokenizer(tmp_path, n_semantic=64, n_global=64)
    want = JaxHFSparkTokenizer(tmp_path, n_semantic=64, n_global=64)
    for name in ("semantic_base", "global_base", "n_semantic", "n_global", "pad_id"):
        assert getattr(got, name) == getattr(want, name), name
    assert tuple(got.eos_ids) == tuple(want.eos_ids)
    texts = ["Spark TTS speaks.", "naïve café, 12 €", " two  spaces ", ""]
    for text in texts:
        assert got.encode(text) == want.encode(text)
        assert got.decode(got.encode(text)) == want.decode(want.encode(text)) == text
    for token in chip_smoke.SPARK_SPECIAL_TOKENS + ["<|bicodec_semantic_77|>",
                                                     "<|bicodec_global_3|>"]:
        assert got.token_id(token) == want.token_id(token)
    ids = got.encode("hi ") + [got.semantic_base + 5, got.global_base + 1, got.eos_ids[0]]
    assert got.decode(ids) == want.decode(ids)
    with pytest.raises(KeyError):
        got.token_id("<|not_a_token|>")


# ------------------------------------------------------- a model_dir pipeline


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_ckpt")
    chip_smoke.write_checkpoint(d, "cpu", config=CFG, llm_dtype=torch.float32, std=0.2)
    return d


@pytest.fixture(scope="module")
def pipelines(tiny_dir):
    mp = pytest.MonkeyPatch()
    mp.setenv("SPARKTTS_DECODE_KERNEL", "1")  # read at trace time
    jax.clear_caches()
    tpipe = SparkTTSPipeline(model_dir=tiny_dir, device="cpu", lm_dtype=torch.float32,
                             max_new_tokens=24)
    jpipe = JaxPipeline(model_dir=tiny_dir, lm_dtype=jnp.float32, use_flash=True,
                        max_new_tokens=24)
    yield jpipe, tpipe
    mp.undo()
    jax.clear_caches()


def test_model_dir_config_and_trees_equal_jax(pipelines, tiny_dir):
    jpipe, tpipe = pipelines
    assert tpipe.config == CFG
    assert dataclasses.asdict(tpipe.config) == dataclasses.asdict(jpipe.config)
    assert tpipe.llm_params["embed"].dtype == torch.float32
    assert_trees_equal(tpipe.llm_params, jpipe.llm_params)
    assert_trees_equal(tpipe.bicodec_params, jpipe.bicodec_params)
    assert_trees_equal(tpipe.w2v_params, jpipe.w2v_params)
    assert set(tpipe.load_seconds) == {"read", "convert", "cache", "upload"}


def test_model_dir_greedy_ids_equal_jax(pipelines, tmp_path):
    jpipe, tpipe = pipelines
    tok = tpipe.tokenizer
    voice = dict(gender="male", pitch="low", speed="high")
    ids = build_control_prompt(tok, "Loaded from a checkpoint.", **voice)
    assert ids == build_control_prompt(jpipe.tokenizer, "Loaded from a checkpoint.", **voice)
    assert tpipe.guided_constraint("control") == jpipe.guided_constraint("control")
    np.testing.assert_array_equal(tpipe.generate_tokens(ids, greedy=True, mode="control"),
                                  jpipe.generate_tokens(ids, greedy=True, mode="control"))

    sr = 16000
    t = np.arange(sr) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)))
    path = tmp_path / "voice.wav"
    write_wav(path, wav, sr)
    g, s = tpipe.tokenize_audio(path)
    jg, js = jpipe.tokenize_audio(path)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(s, js)
    clone = build_clone_prompt(tok, "A cloned voice.", g, s, "ref words")
    np.testing.assert_array_equal(tpipe.generate_tokens(clone, greedy=True, mode="clone"),
                                  jpipe.generate_tokens(clone, greedy=True, mode="clone"))


def test_model_dir_pipeline_needs_a_card(tiny_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparkTTSPipeline(model_dir=tiny_dir)


def test_param_cache_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {
        "a": torch.randn(3, 4, generator=g),
        "b": [torch.randn(5, generator=g).to(torch.bfloat16),
              {"q": torch.randint(-127, 127, (2, 6), dtype=torch.int8, generator=g)}],
        "step": torch.tensor(7, dtype=torch.int64),
        "flag": torch.tensor([True, False]),
        "empty": {},
    }
    assert ckpt.load_param_cache(tmp_path / "c") is None
    ckpt.save_param_cache(tmp_path / "c", {"old": torch.zeros(1)})
    ckpt.save_param_cache(tmp_path / "c", tree)  # replaces the old cache
    got = ckpt.load_param_cache(tmp_path / "c")
    assert set(got) == set(tree) and got["empty"] == {} and isinstance(got["b"], list)
    want = ckpt.flatten_tree(tree)[0]
    flat = ckpt.flatten_tree(got)[0]
    assert set(flat) == set(want) == {"a", "b/0", "b/1/q", "step", "flag"}
    for name, t in want.items():
        assert flat[name].dtype == t.dtype and flat[name].shape == t.shape
        assert torch.equal(flat[name], t), name
    # the file is a plain safetensors file (tree paths as names)
    assert set(st_load_file(str(tmp_path / "c" / ckpt.CACHE_FILE))) == set(want)


def test_cached_model_dir_pipeline_equals_the_uncached(pipelines, tiny_dir):
    """The module's first load wrote `_torch_cache/`; a second load reads
    it, converts nothing, and holds the same trees bit for bit.  A
    checkpoint file with another mtime is converted again."""
    _, first = pipelines
    assert (tiny_dir / "_torch_cache" / "source.json").exists()
    again = SparkTTSPipeline(model_dir=tiny_dir, device="cpu", lm_dtype=torch.float32)
    assert again.load_seconds["read"] == again.load_seconds["convert"] == 0.0
    assert again.load_seconds["cache"] > 0
    for name in ("llm_params", "bicodec_params", "w2v_params"):
        want = ckpt.flatten_tree(getattr(first, name))[0]
        got = ckpt.flatten_tree(getattr(again, name))[0]
        assert set(got) == set(want)
        for k, t in want.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), (name, k)
    llm_file = tiny_dir / "LLM" / "model.safetensors"
    st = llm_file.stat()
    try:
        os.utime(llm_file, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        reloaded = SparkTTSPipeline(model_dir=tiny_dir, device="cpu", lm_dtype=torch.float32)
        assert reloaded.load_seconds["convert"] > 0
    finally:
        os.utime(llm_file, ns=(st.st_atime_ns, st.st_mtime_ns))
