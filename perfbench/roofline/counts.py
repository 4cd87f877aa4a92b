"""Operations and bytes of the work a run asks for, from shapes alone, and
the peaks of one NVIDIA H100 (SXM, dense rates, 700 W).

Kept with the benchmark so that a change to the program cannot change its
own yardstick.  The int8 MLP's bytes and the residual units' 3xTF32
operations are those of the port's kernel tables (`PERF.md`); the LM's
model FLOPs count 2 a weight a token, attention over each token's real
context and the head over the guided rows.
"""

from __future__ import annotations

from typing import Dict, Sequence

BF16_FLOPS = 989e12  # dense bf16 / fp16 tensor-core peak
TF32_FLOPS = 495e12  # dense tf32 tensor-core peak
HBM_BYTES = 3.35e12  # bytes/s


def lm_dims(llm: Dict) -> Dict[str, int]:
    nh = llm["num_attention_heads"]
    hd = llm.get("head_dim", llm["hidden_size"] // nh)
    return dict(h=llm["hidden_size"], i=llm["intermediate_size"], layers=llm["num_hidden_layers"],
                nh=nh, nkv=llm["num_key_value_heads"], hd=hd)


def lm_linear_weights(llm: Dict) -> int:
    """Weights of the 24 layers' linears (q/k/v, o, gate/up, down)."""
    d = lm_dims(llm)
    qkv = d["h"] * (d["nh"] + 2 * d["nkv"]) * d["hd"]
    o = d["nh"] * d["hd"] * d["h"]
    mlp = 3 * d["h"] * d["i"]
    return d["layers"] * (qkv + o + mlp)


def attention_flops(llm: Dict, keys: int) -> int:
    """One query against `keys` keys in every layer: q.k and p.v."""
    d = lm_dims(llm)
    return 4 * d["layers"] * d["nh"] * d["hd"] * keys


def head_flops(llm: Dict, rows: int) -> int:
    return 2 * lm_dims(llm)["h"] * rows


def decode_token_flops(llm: Dict, context: int, head_rows: int) -> int:
    """One emitted token whose query sees `context` keys (itself included)."""
    return 2 * lm_linear_weights(llm) + attention_flops(llm, context) + head_flops(llm, head_rows)


def decode_run_flops(llm: Dict, start: int, n: int, head_rows: int) -> int:
    """`n` tokens emitted one after another by a request that had `start`
    tokens before them: the k-th sees start + k keys."""
    keys = n * start + n * (n + 1) // 2
    return n * (2 * lm_linear_weights(llm) + head_flops(llm, head_rows)) + attention_flops(llm, keys)


def prefill_flops(llm: Dict, n: int, head_rows: int) -> int:
    """A prompt of `n` real tokens (padding not counted), causal, with the
    head at its last position only."""
    return (2 * lm_linear_weights(llm) * n + attention_flops(llm, n * (n + 1) // 2)
            + head_flops(llm, head_rows))


def int8_mlp_bytes(llm: Dict, rows: int) -> int:
    """Kernel 4 at `rows` rows: int8 gate/up and down, their fp32 column
    scales, the bf16 input and output, each read or written once."""
    h, i = llm["hidden_size"], llm["intermediate_size"]
    return 2 * h * i + i * h + 4 * (2 * i) + 4 * h + 2 * rows * h * 2


def int8_mlp_bound_s(llm: Dict, rows: int) -> float:
    return int8_mlp_bytes(llm, rows) / HBM_BYTES


def residual_unit_flops_per_frame(channels: int) -> int:
    """One output frame of a residual unit: the k7 and the k1 convolution,
    C to C channels each, as three TF32 products (3xTF32)."""
    return 3 * 2 * (7 + 1) * channels * channels


def residual_units_flops_per_second(decoder: Dict, frame_rate: float) -> float:
    """3xTF32 operations of the WaveGenerator's residual units (three a
    block) for one second of audio: a block runs at its upsampled frame
    rate with half the channels of the block before it."""
    rates: Sequence[int] = decoder["rates"]
    total, rate = 0.0, float(frame_rate)
    for i, r in enumerate(rates):
        rate *= r
        total += 3 * rate * residual_unit_flops_per_frame(decoder["channels"] // 2 ** (i + 1))
    return total
