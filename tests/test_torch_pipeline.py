"""Voice creation and voice cloning end to end: the port's SparkTTSPipeline
against the JAX package's, on the tiny config with the same weights.

The JAX pipeline runs fp32 with its Pallas flash prefill and decode kernels
in interpret mode; the port runs on the CPU, where its kernel wrappers take
their plain versions.  Prompt ids and greedy ids must be equal; the
waveform agrees to 1e-4 of its peak (fp32, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm.quant import quantize_qwen_int4 as jax_quantize_int4
from sparktts_tpu.lm.quant import quantize_qwen_int8 as jax_quantize_int8
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu.prompt import build_clone_prompt as jax_clone_prompt
from sparktts_tpu.prompt import build_control_prompt as jax_control_prompt
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import build_clone_prompt, build_control_prompt

WAV_REL_TOL = 1e-4
VOICE = dict(gender="female", pitch="moderate", speed="high")


@pytest.fixture(scope="module")
def pipelines():
    mp = pytest.MonkeyPatch()
    mp.setenv("SPARKTTS_DECODE_KERNEL", "1")  # read at trace time
    jax.clear_caches()
    jpipe = JaxPipeline(config=tiny_test_config(), lm_dtype=jnp.float32, use_flash=True,
                        max_new_tokens=24)
    # a random tied-embedding LM decodes greedily by repeating a token; damp
    # the global-token rows so it repeats a SEMANTIC token and the vocoder
    # has something to say (both pipelines get the same weights)
    tok = jpipe.tokenizer
    embed = np.asarray(jpipe.llm_params["embed"]).copy()
    embed[tok.global_base : tok.global_base + tok.n_global] *= 0.3
    jpipe.llm_params = {**jpipe.llm_params, "embed": jnp.asarray(embed)}
    tpipe = SparkTTSPipeline(
        config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32, max_new_tokens=24,
        llm_params=jax.tree.map(np.asarray, jpipe.llm_params),
        bicodec_params=jax.tree.map(np.asarray, jpipe.bicodec_params),
        wav2vec2_params=jax.tree.map(np.asarray, jpipe.w2v_params),
    )
    yield jpipe, tpipe
    mp.undo()
    jax.clear_caches()


def test_control_prompt_ids_equal(pipelines):
    jpipe, tpipe = pipelines
    for text in ("hello world", "naïve café, 12 €"):
        assert build_control_prompt(tpipe.tokenizer, text, **VOICE) == jax_control_prompt(
            jpipe.tokenizer, text, **VOICE
        )
    assert tpipe.guided_constraint() == jpipe.guided_constraint("control")


def test_voice_creation_greedy_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    text = "The quick brown fox."
    ids = build_control_prompt(tpipe.tokenizer, text, **VOICE)
    want_ids = jpipe.generate_tokens(ids, greedy=True, mode="control")
    got_ids = tpipe.generate_tokens(ids, greedy=True)
    np.testing.assert_array_equal(got_ids, want_ids)

    want = jpipe.inference(text, greedy=True, **VOICE)
    got = tpipe.inference(text, greedy=True, **VOICE)
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)


def test_sampled_voice_creation_runs_and_is_seeded(pipelines):
    _, tpipe = pipelines
    a = tpipe.inference("Seeded sampling.", seed=3, **VOICE)
    b = tpipe.inference("Seeded sampling.", seed=3, **VOICE)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def prompt_wav(tmp_path_factory):
    """0.7 s of a decaying two-harmonic tone with a little noise, 16 kHz."""
    sr = 16000
    t = np.arange(int(0.7 * sr)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(2 * np.pi * 540 * t)) * np.exp(-t)
    wav += 0.005 * np.random.default_rng(0).standard_normal(t.size)
    path = tmp_path_factory.mktemp("clone") / "prompt.wav"
    write_wav(path, wav, sr)
    return path


def test_clone_prompt_ids_and_constraint_equal(pipelines):
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(0)
    glob = rng.integers(0, tpipe.tokenizer.n_global, 4)
    sem = rng.integers(0, tpipe.tokenizer.n_semantic, 30)
    for prompt_text in (None, "Reference words. "):
        got = build_clone_prompt(tpipe.tokenizer, "to be said", glob, sem, prompt_text)
        want = jax_clone_prompt(jpipe.tokenizer, "to be said", glob, sem, prompt_text)
        assert got == want
    assert tpipe.guided_constraint("clone") == jpipe.guided_constraint("clone")
    assert tpipe.guided_constraint("control") == jpipe.guided_constraint("control")
    with pytest.raises(ValueError):
        tpipe.guided_constraint("other")


def test_tokenize_audio_matches_jax(pipelines, prompt_wav):
    jpipe, tpipe = pipelines
    want_g, want_s = jpipe.tokenize_audio(str(prompt_wav))
    got_g, got_s = tpipe.tokenize_audio(prompt_wav)
    assert got_s.shape == want_s.shape == (1, 139)  # 0.7 s: 559 wav2vec2 frames / 4
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("prompt_text", [None, "A reference. "])
def test_voice_cloning_greedy_matches_jax(pipelines, prompt_wav, prompt_text):
    jpipe, tpipe = pipelines
    text = "Cloned speech."
    want = jpipe.inference(text, prompt_speech_path=str(prompt_wav), prompt_text=prompt_text,
                           greedy=True)
    got = tpipe.inference(text, prompt_speech_path=prompt_wav, prompt_text=prompt_text,
                          greedy=True)
    g, s = tpipe.tokenize_audio(prompt_wav)
    ids = build_clone_prompt(tpipe.tokenizer, text, g, s if prompt_text else None, prompt_text)
    np.testing.assert_array_equal(tpipe.generate_tokens(ids, greedy=True, mode="clone"),
                                  jpipe.generate_tokens(ids, greedy=True, mode="clone"))
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)


def test_inference_needs_a_voice(pipelines):
    _, tpipe = pipelines
    with pytest.raises(ValueError, match="prompt_speech_path"):
        tpipe.inference("hello")


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_lm_voice_creation_greedy_matches_jax(pipelines, kind):
    """Voice creation with a weight-only quantized LM, as users get one: the
    int8 LM by quantizing `pipe.llm_params` in place, the int4 LM (group 16
    on hidden 64) by passing the JAX package's numpy tree to the
    constructor.  Greedy ids equal, waveform within 1e-4 of its peak."""
    jpipe, tpipe = pipelines
    jax_params, torch_params = jpipe.llm_params, tpipe.llm_params
    try:
        if kind == "int8":
            jpipe.llm_params = jax_quantize_int8(jax_params)
            tpipe.llm_params = quantize_qwen_int8(torch_params)
            pipe = tpipe
        else:
            jpipe.llm_params = jax_quantize_int4(jax_params, group=16)
            pipe = SparkTTSPipeline(
                config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32,
                max_new_tokens=24, llm_params=jax.tree.map(np.asarray, jpipe.llm_params),
                bicodec_params=jax.tree.map(np.asarray, jpipe.bicodec_params),
            )
        text = "Quantized speech."
        ids = build_control_prompt(pipe.tokenizer, text, **VOICE)
        np.testing.assert_array_equal(pipe.generate_tokens(ids, greedy=True),
                                      jpipe.generate_tokens(ids, greedy=True, mode="control"))
        want = jpipe.inference(text, greedy=True, **VOICE)
        got = pipe.inference(text, greedy=True, **VOICE)
        assert got.shape == want.shape and got.size > 0
        peak = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)
    finally:
        jpipe.llm_params, tpipe.llm_params = jax_params, torch_params
