"""The port's export (`sparktts_tpu_torch/export.py`) against the live port
and the JAX package, the cases of `tests/test_export.py`.

A toy program round trip; the tiny pipeline's five artifacts (LM weights
x4, so that greedy decoding does not repeat one id), reloaded: the vocoder
equals the live `bicodec_detokenize` and JAX's within 1e-5, and greedy ids
from `lm_prefill` + `lm_decode` equal the live `generate`'s and JAX's; the
same for an int8 LM.  The exported `vocoder` and `lm_decode` hold their
`sparktts_torch::` kernel ops, and `export_program` refuses a program that
lacks an op it must hold (a plain version traced in a kernel's place).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.codec.bicodec import bicodec_detokenize as jax_detokenize
from sparktts_tpu.config import tiny_test_config as jax_tiny_config
from sparktts_tpu.lm.generate import generate as jax_generate
from sparktts_tpu_torch import export as EXP
from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize
from sparktts_tpu_torch.config import tiny_test_config
from sparktts_tpu_torch.kernels import decode_attention, vocoder_fusion
from sparktts_tpu_torch.kernels.ops import graph_ops
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
from sparktts_tpu_torch.pipeline import SparkTTSPipeline

WAV_TOL = 1e-5
PROMPT, NEW = 16, 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file: under pytest-xdist
    each worker's own pool would oversubscribe the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(tree, factor=4):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return tree * factor


@pytest.fixture(scope="module")
def pipe():
    p = SparkTTSPipeline(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32,
                         max_new_tokens=8, prompt_bucket=32)
    p.llm_params = _scaled(p.llm_params)
    return p


@pytest.fixture(scope="module")
def artifacts(pipe, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifacts")
    manifest = EXP.export_pipeline_artifacts(pipe, out, wav_seconds=1.0, vocoder_tokens=16,
                                             prompt_len=PROMPT, decode_len=NEW)
    return out, manifest


def _jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def test_export_roundtrip_simple(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 16, generator=g)
    x = torch.randn(4, 16, generator=g)

    def fn(x):
        return torch.tanh(x @ w)

    assert EXP.export_program(fn, (x,), tmp_path / "f.pt2") == {}
    loaded = EXP.load_program(tmp_path / "f.pt2")
    torch.testing.assert_close(loaded(x), fn(x), rtol=1e-6, atol=0)


def test_export_refuses_a_program_without_its_kernel_op(pipe, tmp_path):
    """The wrapper records its op while exporting; the plain version traced
    in its place is refused."""
    unit = pipe.bicodec_params["decoder"]["blocks"][0]["res_units"][0]
    c = unit["conv1"]["w"].shape[-1]
    x = torch.randn(1, 8, c, generator=torch.Generator().manual_seed(1))
    before = vocoder_fusion.launches
    found = EXP.export_program(lambda x: vocoder_fusion.fused_residual_unit(unit, x, 3), (x,),
                               tmp_path / "ru.pt2", kernels=("fused_residual_unit",))
    assert found == {"fused_residual_unit": 1} and vocoder_fusion.launches == before
    torch.testing.assert_close(EXP.load_program(tmp_path / "ru.pt2")(x),
                               vocoder_fusion.fused_residual_unit_plain(unit, x, 3),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="lacks the kernel ops"):
        EXP.export_program(lambda x: vocoder_fusion.fused_residual_unit_plain(unit, x, 3), (x,),
                           tmp_path / "plain.pt2", kernels=("fused_residual_unit",))


def test_pipeline_artifacts_and_their_ops(artifacts):
    out, manifest = artifacts
    assert set(manifest) == {"mel", "audio_tokenize", "vocoder", "lm_prefill", "lm_decode"}
    for rel in manifest.values():
        assert (out / rel).stat().st_size > 0
    assert (out / "manifest.json").exists()
    vocode = EXP.load_program(out / "vocoder.pt2")
    assert vocode.ops == {"fused_residual_unit": 6} and vocode.fp32
    decode = EXP.load_program(out / "lm_decode.pt2")
    assert decode.ops == {"dense_decode_attention": 2} and not decode.fp32
    assert graph_ops(decode.module.graph) == decode.ops
    assert EXP.load_program(out / "lm_prefill.pt2").ops == {}


def test_vocoder_artifact_equals_live_and_jax(pipe, artifacts):
    out, _ = artifacts
    vocode = EXP.load_program(out / "vocoder.pt2")
    rng = np.random.default_rng(0)
    sem = rng.integers(0, 64, size=(1, 16))
    glob = rng.integers(0, 8, size=(1, pipe.config.bicodec.speaker_encoder.token_num))
    wav_art = vocode(torch.from_numpy(sem), torch.from_numpy(glob)).numpy()
    with torch.inference_mode():
        wav_live = bicodec_detokenize(pipe.bicodec_params, pipe.config.bicodec,
                                      torch.from_numpy(sem), torch.from_numpy(glob)).numpy()
    wav_jax = np.asarray(jax.jit(jax_detokenize, static_argnums=1)(
        _jax(pipe.bicodec_params), jax_tiny_config().bicodec, jnp.asarray(sem, jnp.int32),
        jnp.asarray(glob, jnp.int32)))
    np.testing.assert_allclose(wav_art, wav_live, rtol=WAV_TOL, atol=WAV_TOL)
    np.testing.assert_allclose(wav_art, wav_jax, rtol=WAV_TOL, atol=WAV_TOL)


def test_codec_artifacts_equal_live(pipe, artifacts):
    """mel and audio_tokenize (wav2vec2 + BiCodec) reloaded: the live
    path's numbers (the same fp32 ops, run under `full_fp32`)."""
    from sparktts_tpu_torch.codec.bicodec import bicodec_tokenize
    from sparktts_tpu_torch.dsp.mel import make_mel_basis, mel_spectrogram
    from sparktts_tpu_torch.nn.wav2vec2 import wav2vec2_features

    out, _ = artifacts
    cfg = pipe.config
    meta = json.loads((out / "manifest.json").read_text())
    rng = np.random.default_rng(4)
    wav, ref = (torch.from_numpy((0.3 * rng.standard_normal((1, meta[n]))).astype(np.float32))
                for n in ("wav_len", "ref_len"))
    with torch.inference_mode():
        mel = mel_spectrogram(ref, make_mel_basis(cfg.bicodec.mel_params))
        tokens = bicodec_tokenize(pipe.bicodec_params, cfg.bicodec,
                                  wav2vec2_features(pipe.w2v_params, wav, cfg.wav2vec2), ref)
    torch.testing.assert_close(EXP.load_program(out / "mel.pt2")(ref), mel, rtol=1e-5, atol=1e-5)
    for got, want in zip(EXP.load_program(out / "audio_tokenize.pt2")(wav, ref), tokens):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _artifact_greedy(out, ids):
    prefill = EXP.load_program(out / "lm_prefill.pt2")
    decode = EXP.load_program(out / "lm_decode.pt2")
    t = ids.shape[1]
    logits, k, v = prefill(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.bool))
    start = torch.zeros(1, dtype=torch.int32)  # no left padding in this prompt
    toks = [int(logits.argmax(-1)[0])]
    for i in range(NEW - 1):
        logits, k, v = decode(torch.tensor([toks[-1]]), torch.tensor([t + i]), start, k, v,
                              torch.tensor(t + i, dtype=torch.int32))
        toks.append(int(logits.argmax(-1)[0]))
    return np.asarray(toks)


def _live_greedy(llm, cfg, ids):
    with torch.inference_mode():
        toks, _ = generate(llm, cfg, torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.bool),
                           torch.Generator(), max_new_tokens=NEW, cache_len=PROMPT + NEW,
                           eos_ids=(), pad_id=0, greedy=True, cache_dtype=torch.float32)
    return toks[0].numpy()


def test_exported_lm_generates_greedily(pipe, artifacts):
    """Greedy ids from the lm_prefill + lm_decode artifacts equal the live
    generate's and JAX's."""
    out, _ = artifacts
    cfg = pipe.config.llm
    ids = np.random.default_rng(1).integers(5, cfg.vocab_size - 5, size=(1, PROMPT))
    got = _artifact_greedy(out, ids)
    np.testing.assert_array_equal(got, _live_greedy(pipe.llm_params, cfg, ids))
    ref, _ = jax_generate(_jax(pipe.llm_params), jax_tiny_config().llm,
                          jnp.asarray(ids, jnp.int32), jnp.ones(ids.shape, bool),
                          jax.random.PRNGKey(0), max_new_tokens=NEW, cache_len=PROMPT + NEW,
                          eos_ids=(), pad_id=0, greedy=True, cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(ref)[0])
    assert len(set(got.tolist())) > 1  # not one repeated id


def test_int8_lm_artifacts(pipe, tmp_path):
    """An int8 tree's lm_decode holds the fused int8 MLP op, and the pair's
    greedy ids equal the live int8 generate's."""
    llm = pipe.llm_params
    try:
        pipe.llm_params = quantize_qwen_int8(llm)
        EXP.export_pipeline_artifacts(pipe, tmp_path, prompt_len=PROMPT, decode_len=NEW,
                                      graphs=("lm_prefill", "lm_decode"))
        decode = EXP.load_program(tmp_path / "lm_decode.pt2")
        assert decode.ops == {"dense_decode_attention": 2, "int8_mlp_matvec": 2}
        ids = np.random.default_rng(2).integers(5, pipe.config.llm.vocab_size - 5,
                                                size=(1, PROMPT))
        np.testing.assert_array_equal(_artifact_greedy(tmp_path, ids),
                                      _live_greedy(pipe.llm_params, pipe.config.llm, ids))
    finally:
        pipe.llm_params = llm


def test_export_leaves_eager_decode_unchanged(pipe, artifacts):
    """Exporting launches nothing and caches nothing the live path then
    reads (the RoPE frequencies made during a trace are not kept)."""
    before = decode_attention.launches
    ids = np.random.default_rng(3).integers(5, pipe.config.llm.vocab_size - 5, size=(1, PROMPT))
    _live_greedy(pipe.llm_params, pipe.config.llm, ids)
    assert decode_attention.launches == before
