"""Disaggregated serving in the port: the codec stack on a device of its own
(`SparkTTSPipeline(codec_device=...)`), the cases of
`tests/test_disaggregation.py`.

The CPU has one torch device, so here `codec_device` names the CPU
explicitly and the tests hold the plumbing: the codec trees on it, every
codec call given tensors there, the waveform equal to the plain pipeline's,
`shard_llm` refused beside it, and the servers' flags that chain codec work
onto the LM's card turned off.  chip_smoke phase 35 runs it on the card.
"""

import asyncio

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import tiny_test_config
from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.pipeline import SparkTTSPipeline

KW = dict(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32, max_new_tokens=16,
          prompt_bucket=32)


@pytest.fixture(scope="module")
def prompt_wav(tmp_path_factory):
    sr = 16000
    rng = np.random.default_rng(1)
    path = tmp_path_factory.mktemp("disagg") / "p.wav"
    write_wav(path, (0.2 * rng.standard_normal(sr)).astype(np.float32), sr)
    return str(path)


@pytest.fixture(scope="module")
def split():
    return SparkTTSPipeline(codec_device=torch.device("cpu"), **KW)


def _devices(tree):
    if isinstance(tree, dict):
        return set().union(*(_devices(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(v) for v in tree))
    return {tree.device}


def test_codec_device_placement_and_equivalence(split, prompt_wav, monkeypatch):
    base = SparkTTSPipeline(**KW)
    assert split.codec_device == torch.device("cpu") and base.codec_device is None
    assert _devices(split.bicodec_params) == _devices(split.w2v_params) == {split.codec_dev}
    assert _devices(split.llm_params) == {split.device}

    from sparktts_tpu_torch import pipeline as P

    seen = []
    detok = P.bicodec_detokenize

    def spy(params, cfg, semantic, global_t):
        seen.append((semantic.device, global_t.device))
        return detok(params, cfg, semantic, global_t)

    monkeypatch.setattr(P, "bicodec_detokenize", spy)
    w0 = base.inference("device split", prompt_speech_path=prompt_wav, greedy=True)
    w1 = split.inference("device split", prompt_speech_path=prompt_wav, greedy=True)
    assert w0.size > 0
    np.testing.assert_array_equal(w0, w1)
    assert seen[-1] == (split.codec_dev, split.codec_dev)


def test_codec_device_and_shard_llm_are_exclusive(split):
    with pytest.raises(ValueError, match="mutually exclusive"):
        split.shard_llm(object())


def test_servers_turn_off_codec_chains_with_a_codec_device(split):
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer
    from sparktts_tpu_torch.serve.server import TTSServer

    server = ContinuousTTSServer(split, max_slots=2, steps_per_dispatch=6)
    assert not server.device_admission and not server.spec_first_chunk
    assert not TTSServer(split).fused_clone
    plain = SparkTTSPipeline(**KW)
    assert ContinuousTTSServer(plain, max_slots=2).device_admission
    assert TTSServer(plain).fused_clone
    with pytest.raises(ValueError, match="codec_device"):
        split.spec_vocode_chain(0, 4, None)


def test_disaggregated_continuous_server(split):
    """Decode on the LM's device, vocode on the codec's: a creation and a
    stream, finite."""
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    async def run():
        server = ContinuousTTSServer(split, max_slots=2, steps_per_dispatch=6)
        await server.start()
        wav = await server.synthesize("split serve", gender="female", pitch="moderate",
                                      speed="moderate")
        chunks = [c async for c in server.synthesize_streaming(
            "split stream", gender="male", pitch="moderate", speed="moderate")]
        await server.stop()
        return wav, chunks

    wav, chunks = asyncio.new_event_loop().run_until_complete(run())
    assert np.isfinite(wav).all()
    assert len(chunks) >= 1 and all(np.isfinite(c).all() for c in chunks)
