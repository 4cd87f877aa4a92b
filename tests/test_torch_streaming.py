"""The port's token streaming (`serve/streaming.py`) against the JAX
package's: the chunk schedule, the overlap and the cross-fade on several
configs, the codec's receptive field, and a streamed voice clone on the
tiny config held against the offline path of the same seed, as
`tests/test_streaming.py` holds the JAX one (the streaming cache carries
slack, so ids are not compared: the length must be equal sample for
sample, the log-mel distance below 0.1)."""

import numpy as np
import pytest
import torch

from sparktts_tpu.bench.metrics import mel_distance
from sparktts_tpu.codec.bicodec import detokenize_receptive_field as jax_receptive_field
from sparktts_tpu.config import SparkTTSConfig as JaxConfig
from sparktts_tpu.config import StreamingConfig as JaxStreamingConfig
from sparktts_tpu.config import tiny_test_config as jax_tiny_config
from sparktts_tpu.serve import streaming as jstream
from sparktts_tpu_torch.codec.bicodec import detokenize_receptive_field
from sparktts_tpu_torch.config import SparkTTSConfig, StreamingConfig
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import build_clone_prompt, extract_semantic_ids
from sparktts_tpu_torch.serve import streaming as tstream

SCHEDULES = [
    {},
    dict(audio_chunk_duration=0.2, max_audio_chunk_duration=1.0,
         audio_chunk_size_scale_factor=2.0, audio_chunk_overlap_duration=0.04),
    dict(audio_chunk_duration=0.04, max_audio_chunk_duration=0.2,
         audio_chunk_size_scale_factor=2.0, audio_chunk_overlap_duration=0.0),
    dict(audio_chunk_duration=0.5, max_audio_chunk_duration=7.3,
         audio_chunk_size_scale_factor=3.5, audio_chunk_overlap_duration=0.13, frame_rate=40),
]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_overlap_and_cross_fade_equal_jax(schedule):
    jcfg, tcfg = JaxStreamingConfig(**schedule), StreamingConfig(**schedule)
    jsizes, tsizes = jstream.chunk_sizes(jcfg), tstream.chunk_sizes(tcfg)
    assert [next(tsizes) for _ in range(8)] == [next(jsizes) for _ in range(8)]
    assert tstream.overlap_tokens(tcfg) == jstream.overlap_tokens(jcfg)
    rng = np.random.default_rng(len(schedule))
    prev, nxt = (rng.standard_normal(n).astype(np.float32) for n in (300, 220))
    ov = tstream.overlap_tokens(tcfg) * 7
    for got, want in zip(tstream.cross_fade(prev, nxt, ov), jstream.cross_fade(prev, nxt, ov)):
        np.testing.assert_array_equal(got, want)
    tail = rng.standard_normal(ov + 3).astype(np.float32)
    for got, want in zip(tstream._emit_with_tail(tail, nxt, ov),
                         jstream._emit_with_tail(tail, nxt, ov)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("config", ["tiny", "0.5B"])
def test_receptive_field_equals_jax(config):
    jcfg, tcfg = ((jax_tiny_config(), torch_tiny_config()) if config == "tiny"
                  else (JaxConfig(), SparkTTSConfig()))
    assert detokenize_receptive_field(tcfg.bicodec) == jax_receptive_field(jcfg.bicodec)
    assert StreamingConfig() == StreamingConfig(**vars(JaxStreamingConfig()))
    assert tcfg.streaming == StreamingConfig()


@pytest.fixture(scope="module")
def pipe():
    return SparkTTSPipeline(config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32,
                            max_new_tokens=40)


def test_streamed_clone_matches_the_offline_path(pipe, tmp_path):
    """A streamed clone (10-token chunks growing to 20, 2 tokens of overlap)
    gives at least 3 chunks; together they are as long as the offline
    generate_tokens + detokenize of the same seed, and within 0.1 log-mel
    distance of it (seams vocoded with 2 tokens of left context)."""
    scfg = StreamingConfig(audio_chunk_duration=0.2, max_audio_chunk_duration=0.4,
                           audio_chunk_size_scale_factor=2.0, audio_chunk_overlap_duration=0.04)
    # noise, not a tone: a tone can tokenize to the FSQ mid-code global token,
    # whose zero code vector silences a random-init vocoder
    rng = np.random.default_rng(41)
    noise_path = tmp_path / "noise.wav"
    write_wav(noise_path, (0.3 * rng.standard_normal(16000)).astype(np.float32), 16000)

    syn = tstream.StreamingSynthesizer(pipe, scfg, steps_per_dispatch=8)
    chunks = list(syn.stream("hello world", prompt_speech_path=noise_path, seed=3))
    assert len(chunks) >= 3, "need several chunks to exercise seams"
    streamed = np.concatenate(chunks)
    assert np.isfinite(streamed).all()

    tok = pipe.tokenizer
    g, _ = pipe.tokenize_audio(noise_path)
    gen = pipe.generate_tokens(build_clone_prompt(tok, "hello world", g, None, None), seed=3,
                               mode="clone")
    full = pipe.detokenize(g, extract_semantic_ids(tok, gen)[None, :])
    assert np.abs(full).max() > 0, "degenerate (all-zero) vocode: the test would be vacuous"
    assert len(streamed) == len(full)
    d = mel_distance(streamed, full, jax_tiny_config().bicodec.mel_params)
    assert d < 0.1, f"chunk-boundary mel distance too high: {d}"
