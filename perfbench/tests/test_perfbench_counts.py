"""Operations and bytes at the Spark-TTS-0.5B shapes against numbers
worked by hand."""

import json
from pathlib import Path

import pytest

from perfbench.roofline import counts

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "spark-tts-0.5b-int8.json")
                 .read_text())
LLM, DEC = CFG["llm"], CFG["bicodec"]["decoder"]


def test_lm_linear_weights():
    per_layer = 896 * 1152 + 896 * 896 + 896 * 2 * 4864 + 4864 * 896
    assert per_layer == 14_909_440
    assert counts.lm_linear_weights(LLM) == 24 * 14_909_440 == 357_826_560


def test_decode_and_prefill_flops():
    w2 = 2 * 357_826_560
    head = 2 * 896 * 12_293
    att = 4 * 24 * 14 * 64  # one query against one key, every layer
    assert counts.decode_token_flops(LLM, 100, 12_293) == w2 + 100 * att + head
    assert counts.decode_run_flops(LLM, 40, 3, 12_293) == sum(
        counts.decode_token_flops(LLM, 40 + k, 12_293) for k in (1, 2, 3))
    assert counts.prefill_flops(LLM, 4, 12_293) == 4 * w2 + (1 + 2 + 3 + 4) * att + head


def test_kernel4_bytes_bound():
    """gate/up 896 x 9728 and down 4864 x 896 int8, fp32 scales, bf16 rows."""
    b1 = 896 * 9728 + 4864 * 896 + 4 * 9728 + 4 * 896 + 2 * (2 * 896)
    assert counts.int8_mlp_bytes(LLM, 1) == b1 == 13_120_512
    assert counts.int8_mlp_bytes(LLM, 8) == b1 + 7 * 2 * 2 * 896
    assert counts.int8_mlp_bound_s(LLM, 1) == pytest.approx(3.916570746268657e-06, rel=1e-12)


def test_residual_units_of_one_audio_second():
    """Blocks at 400, 2000, 8000, 16000 frames a second, 768/384/192/96
    channels, three units of (7 + 1) C^2 MACs, three products each."""
    per = [400 * 768**2, 2000 * 384**2, 8000 * 192**2, 16000 * 96**2]
    expect = 3 * 3 * 2 * 8 * sum(per)
    assert counts.residual_units_flops_per_second(DEC, 50) == pytest.approx(expect)
    # PERF.md's kernel-3 bound for a 350-token vocode (7 s): 1.98 ms at 495 TFLOP/s
    assert 7 * expect / counts.TF32_FLOPS == pytest.approx(1.9818086399999997e-3)
