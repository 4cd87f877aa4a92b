"""Longform synthesis and the host audio helpers in the port against the JAX
package.

Text segmentation (`utils/textseg.py`) and the audio helpers of `io/audio.py`
must equal JAX's exactly.  `inference_long` on one JAX and one port pipeline
with the same tiny-config weights (fp32; the global-token rows of the
embedding damped, as `tests/test_torch_pipeline.py` does, so that a random
LM speaks semantic tokens): greedy, in voice creation and voice cloning,
every segment's prompt and ids equal JAX's, the later segments' prompts
carry the first segment's global ids, and the waveform agrees within 1e-4
of its peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.io import audio as jaudio
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu.utils.textseg import pack_segments as jax_pack_segments
from sparktts_tpu.utils.textseg import split_sentences as jax_split_sentences
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.io import audio as taudio
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import extract_global_ids
from sparktts_tpu_torch.utils.textseg import pack_segments, split_sentences

WAV_REL_TOL = 1e-4
LONG_TEXT = "Alpha beta gamma. Delta epsilon! Zeta eta theta iota?"


# ------------------------------------------------------------------- textseg


@pytest.mark.parametrize("text,want", [
    ("One. Two! Three?", ["One. ", "Two! ", "Three?"]),
    ("Wait... really?! Yes.", ["Wait... ", "really?! ", "Yes."]),
    ("no punctuation at all", ["no punctuation at all"]),
    ("你好。再见！", ["你好。", "再见！"]),
    ("line one\nline two", ["line one\n", "line two"]),
    ("   \n  ", []),
    ("", []),
])
def test_split_sentences_equals_jax(text, want):
    assert split_sentences(text) == jax_split_sentences(text) == want


@pytest.mark.parametrize("text,max_chars", [
    ("aaaa. bbbb. cccc. dddd.", 12),
    ("alpha beta gamma delta epsilon", 12),
    ("x" * 30, 12),
    ("你好。再见！你好，再见。", 4),
    (LONG_TEXT, 20),
    ("hi", 10),
    ("", 10),
    ("   \n  ", 10),
])
def test_pack_segments_equals_jax(text, max_chars):
    got = pack_segments(text, max_chars)
    assert got == jax_pack_segments(text, max_chars)
    assert all(len(s) <= max_chars for s in got) or max_chars >= len(text)
    assert "".join(got).replace(" ", "") == text.replace(" ", "").strip().replace("\n", "")


def test_pack_segments_validates():
    for fn in (pack_segments, jax_pack_segments):
        with pytest.raises(ValueError):
            fn("hi", max_chars=0)


# --------------------------------------------------------------------- audio


def _voice(seconds=2.0, sr=16000):
    """Silence, a tone under a syllable envelope, silence."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    tone = 0.4 * np.sin(2 * np.pi * 180 * t) * np.sin(np.pi * 2 * t) ** 2
    tone[: sr // 2] = 0.0
    tone[-sr // 3:] = 0.0
    return tone + 0.001 * rng.standard_normal(t.size)


def test_audio_helpers_equal_jax():
    wav, sr = _voice(), 16000
    np.testing.assert_array_equal(taudio.frame_rms(wav, 1600, 160),
                                  jaudio.frame_rms(wav, 1600, 160))
    assert taudio.detect_speech_boundaries(wav, sr) == jaudio.detect_speech_boundaries(wav, sr)
    for kw in ({}, dict(window_duration=0.05, volume_threshold=0.05)):
        np.testing.assert_array_equal(taudio.remove_silence_on_both_ends(wav, sr, **kw),
                                      jaudio.remove_silence_on_both_ends(wav, sr, **kw))
    for length in (4000, 40000):
        got = taudio.random_select_audio_segment(wav, length, np.random.default_rng(3))
        want = jaudio.random_select_audio_segment(wav, length, np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="only silence"):
        taudio.detect_speech_boundaries(np.zeros(sr), sr)


def test_load_audio_full_signature_equals_jax(tmp_path, monkeypatch):
    """Against the JAX package's scipy paths, which the port copies (both
    packages' optional C++ readers and resamplers are turned off here)."""
    from sparktts_tpu.io import native
    from sparktts_tpu_torch.io import native as torch_native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(torch_native, "get_lib", lambda: None)
    path = tmp_path / "voice.wav"
    taudio.write_wav(path, _voice(), 16000)
    for kw in (dict(sampling_rate=16000),
               dict(sampling_rate=8000, volume_normalize=True),
               dict(sampling_rate=16000, remove_silence=True),
               dict(sampling_rate=16000, segment_duration=0.5),
               dict(sampling_rate=16000, length=32300)):
        got = taudio.load_audio(path, rng=np.random.default_rng(7), **kw)
        want = jaudio.load_audio(path, rng=np.random.default_rng(7), **kw)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        taudio.load_audio(path, length=1000)


# ------------------------------------------------------------------ longform


@pytest.fixture(scope="module")
def pipelines():
    mp = pytest.MonkeyPatch()
    mp.setenv("SPARKTTS_DECODE_KERNEL", "1")  # read at trace time
    jax.clear_caches()
    jpipe = JaxPipeline(config=tiny_test_config(), lm_dtype=jnp.float32, use_flash=True,
                        max_new_tokens=24)
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


def _recording(pipe, monkeypatch):
    """Record each `generate_tokens` call's (prompt ids, generated ids)."""
    calls = []
    real = pipe.generate_tokens

    def record(prompt_ids, **kw):
        out = real(prompt_ids, **kw)
        calls.append((list(prompt_ids), np.asarray(out), kw))
        return out

    monkeypatch.setattr(pipe, "generate_tokens", record)
    return calls


@pytest.mark.parametrize("mode", ["control", "clone"])
def test_inference_long_equals_jax(pipelines, mode, monkeypatch, tmp_path):
    jpipe, tpipe = pipelines
    if mode == "control":
        voice = dict(gender="female", pitch="moderate", speed="high")
    else:
        path = tmp_path / "voice.wav"
        taudio.write_wav(path, _voice(1.0), 16000)
        voice = dict(prompt_speech_path=path, prompt_text="ref words")
    request = dict(greedy=True, max_segment_chars=20, seed=3, **voice)
    got_calls, want_calls = _recording(tpipe, monkeypatch), _recording(jpipe, monkeypatch)
    got = tpipe.inference_long(LONG_TEXT, **request)
    want = jpipe.inference_long(LONG_TEXT, **request)
    assert len(got_calls) == len(want_calls) == len(pack_segments(LONG_TEXT, 20)) == 3
    for i, ((gp, gi, gkw), (wp, wi, wkw)) in enumerate(zip(got_calls, want_calls)):
        assert gp == wp
        np.testing.assert_array_equal(gi, wi)
        assert gkw["seed"] == wkw["seed"] == 3 + i
        assert gkw["mode"] == ("clone" if i or mode == "clone" else "control")
    # the later segments are clone prompts of the first segment's global ids
    if mode == "control":
        first = extract_global_ids(tpipe.tokenizer, got_calls[0][1])[:4]
        first = np.pad(first, (0, 4 - first.size))
    else:
        first = extract_global_ids(tpipe.tokenizer, got_calls[0][0])
    assert first.size == tpipe.config.bicodec.speaker_encoder.token_num
    for prompt, _, _ in got_calls[1:]:
        np.testing.assert_array_equal(extract_global_ids(tpipe.tokenizer, prompt), first)
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * np.abs(want).max())


def test_inference_long_of_one_segment_is_inference(pipelines):
    _, tpipe = pipelines
    voice = dict(gender="male", pitch="low", speed="moderate", greedy=True)
    np.testing.assert_array_equal(tpipe.inference_long("Short.", **voice),
                                  tpipe.inference("Short.", **voice))
