"""The plain reference against the port's CPU path at the tiny test
sizes, on weights the benchmark makes (the port runs its plain versions
on the CPU, in float32)."""


import numpy as np
import pytest
import torch

from perfbench.harness import session
from perfbench.harness import weights as bw
from perfbench.reference import bicodec as ref_codec
from perfbench.reference import qwen as ref_lm
from perfbench.reference.prompt import Layout
from perfbench.tests.tiny import tiny_config

SEED = 2**31 + 77


def _setup(lm="none"):
    cfg = tiny_config(lm)
    pcfg = session.program_config(cfg)
    layout = session.layout_of(cfg)
    t_lm, t_codec, _ = session.templates(pcfg, torch.float32)
    return cfg, pcfg, layout, t_lm, t_codec


def test_weights_repeat_from_the_seed_and_follow_the_layout():
    cfg, pcfg, layout, t_lm, t_codec = _setup()
    silence = session.silence_of(layout, pcfg.llm.vocab_size)
    a = bw.lm_weights(t_lm, SEED, "cpu", torch.float32, silence)
    b = bw.lm_weights(t_lm, SEED, "cpu", torch.float32, silence)
    c = bw.lm_weights(t_lm, SEED + 1, "cpu", torch.float32, silence)
    assert torch.equal(a["layers"]["qkv"]["w"], b["layers"]["qkv"]["w"])
    assert not torch.equal(a["layers"]["qkv"]["w"], c["layers"]["qkv"]["w"])
    assert a["embed"].shape == t_lm["embed"].shape
    assert (a["embed"][silence] == 0).all() and (a["embed"][layout.semantic_base] != 0).any()
    assert layout.global_base in silence and layout.eos in silence
    p = bw.codec_weights(t_codec, SEED, "cpu")
    blocks = p["prenet"]["vocos_backbone"]["blocks"]
    assert abs(float(blocks[0]["gamma"].mean()) - 1 / len(blocks)) < 0.01
    assert abs(float(blocks[0]["norm"]["scale"]["b"].mean()) - 1.0) < 0.01


@pytest.mark.parametrize("scheme", ["none", "int8"])
def test_lm_reference_matches_the_port_forward(scheme):
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.lm.qwen import init_kv_cache, qwen_forward

    cfg, pcfg, layout, t_lm, _ = _setup()
    tree = bw.lm_weights(t_lm, SEED, "cpu", torch.float32, [])
    prog = quantize_qwen_int8(tree) if scheme == "int8" else tree
    ids = torch.randint(0, pcfg.llm.vocab_size, (1, 40), generator=torch.Generator().manual_seed(3))
    t = ids.shape[1]
    cache = init_kv_cache(pcfg.llm, 1, 64, torch.float32, "cpu")
    bias = torch.where(torch.arange(64)[None, None, :] <= torch.arange(t)[None, :, None], 0.0,
                       float("-inf"))
    with torch.no_grad():
        port, _ = qwen_forward(prog, pcfg.llm, ids, torch.arange(t)[None], cache, 0, bias)
    rows = torch.arange(pcfg.llm.vocab_size)
    ref = ref_lm.logits(ref_lm.float_weights(tree, scheme), cfg["llm"], ids[0], rows,
                        torch.arange(t))
    scale = float(ref.abs().max())
    assert float((port[0] - ref).abs().max()) <= 1e-5 * scale


def test_codec_reference_matches_the_port_decoder():
    from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize

    cfg, pcfg, layout, _, t_codec = _setup()
    p = bw.codec_weights(t_codec, SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    sem = torch.randint(0, pcfg.bicodec.quantizer.codebook_size, (1, 37), generator=g)
    spk = torch.randint(0, layout.n_global, (1, pcfg.bicodec.speaker_encoder.token_num),
                        generator=g)
    with torch.no_grad():
        port = bicodec_detokenize(p, pcfg.bicodec, sem, spk)[0]
    ref = ref_codec.decode(p, cfg["bicodec"], spk[0], sem[0], bucket=1)
    assert port.shape == ref.shape
    assert float((port - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_prompt_and_token_layout_match_the_port():
    from sparktts_tpu_torch.prompt import (
        SyntheticSparkTokenizer,
        build_control_prompt,
        extract_semantic_ids,
        padded_global_tokens,
    )

    tok = SyntheticSparkTokenizer(8192, 4096)
    layout = Layout(8192, 4096)
    assert layout.eos == tok.eos_ids[0]
    for text, g, p, s in [("hello there", "female", "low", "very_high"),
                          ("a b c", "male", "moderate", "very_low")]:
        assert layout.control_prompt(text, g, p, s) == build_control_prompt(tok, text, g, p, s)
    ids = np.random.default_rng(0).integers(0, tok.vocab_size, 500)
    assert np.array_equal(layout.semantic_ids(ids), extract_semantic_ids(tok, ids))
    assert np.array_equal(layout.speaker_ids(ids, 32), padded_global_tokens(tok, ids, 32)[0])
    assert np.array_equal(layout.speaker_ids(ids[:20], 32), padded_global_tokens(tok, ids[:20], 32)[0])


def test_guided_rows_are_the_pipelines():
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.config import tiny_test_config

    pipe = SparkTTSPipeline(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32)
    (lo, hi), extras = pipe.guided_constraint("control")
    layout = Layout(pipe.tokenizer.n_semantic, pipe.tokenizer.n_global)
    assert list(layout.control_allowed()) == sorted(set(range(lo, hi)) | set(extras))
