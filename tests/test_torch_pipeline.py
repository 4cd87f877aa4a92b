"""Voice creation end to end: the port's SparkTTSPipeline against the JAX
package's, on the tiny config with the same weights.

The JAX pipeline runs fp32 with its Pallas flash prefill and decode kernels
in interpret mode; the port runs on the CPU, where its kernel wrappers take
their plain versions.  Greedy ids must be equal; the waveform agrees to 1e-4
of its peak (fp32, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu.prompt import build_control_prompt as jax_control_prompt
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import build_control_prompt

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


def test_clone_mode_is_not_ported(pipelines):
    _, tpipe = pipelines
    with pytest.raises(NotImplementedError, match="slice 2"):
        tpipe.inference("hello", prompt_speech_path="prompt.wav")
