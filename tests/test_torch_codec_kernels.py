"""The codec's own fp32 kernels on the CPU: the models of kernel 7
(`kernels/codec_gemm.py`: conv, transposed conv by its phase mapping, bmm)
and kernel 8 (`kernels/depthwise_conv.py`) against the JAX package's layers
and einsum, at the (K, stride, dilation, groups, padding) the codec uses at
small widths; and the `codec_fp32` scope, which routes the codec's layers to
those kernels in its own thread only and leaves the CPU numbers as they
were.  The card tests are in `test_torch_cuda_kernels.py`."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.nn import layers as jl
from sparktts_tpu_torch.kernels import codec_gemm, depthwise_conv
from sparktts_tpu_torch.nn import layers

# fp32 sums in another order than XLA's, relative to the peak of the output
TOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


def _conv_inputs(seed, b, t, cin, k, cg, cout, bias=True, int8=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cin)).astype(np.float32)
    p = {"b": (0.1 * rng.standard_normal(cout)).astype(np.float32)} if bias else {}
    if int8:
        p["w_q"] = rng.integers(-127, 128, (k, cg, cout)).astype(np.int8)
        p["scale"] = (0.01 * rng.random(cout) + 1e-3).astype(np.float32)
    else:
        p["w"] = (0.1 * rng.standard_normal((k, cg, cout))).astype(np.float32)
    return x, p


def _torch_args(x, p):
    w = p["w_q"].astype(np.float32) if "w_q" in p else p["w"]
    scale = torch.from_numpy(p["scale"]) if "scale" in p else None
    bias = torch.from_numpy(p["b"]) if "b" in p else None
    return torch.from_numpy(x), torch.from_numpy(w), bias, scale


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


# (name, B, T, Cin, Cout, K, stride, padding, dilation, groups): the codec's
# convolutions at small widths
CONVS = [
    ("conv_in k7", 2, 19, 24, 40, 7, 1, 3, 1, 1),
    ("residual k7 dil 9", 1, 40, 16, 16, 7, 1, 27, 9, 1),
    ("1x1", 2, 13, 24, 8, 1, 1, 0, 1, 1),
    ("conv_out Cout 1", 2, 37, 12, 1, 7, 1, 3, 1, 1),
    ("wav2vec2 conv0 Cin 1 k10 s5", 2, 203, 1, 16, 10, 5, 0, 1, 1),
    ("wav2vec2 k3 s2", 1, 40, 16, 16, 3, 2, 0, 1, 1),
    ("wav2vec2 k2 s2", 1, 41, 16, 16, 2, 2, 0, 1, 1),
    ("pos_conv k128 16 groups", 1, 30, 64, 64, 128, 1, 64, 1, 16),
    ("ecapa k3 dil 4", 2, 33, 16, 16, 3, 1, 4, 4, 1),
    ("ecapa k5", 1, 30, 20, 24, 5, 1, 2, 1, 1),
    ("sampler downsampler k4 s2 groups 2", 1, 30, 16, 16, 4, 2, 1, 1, 2),
    ("k7 across three k segments", 1, 20, 160, 24, 7, 1, 3, 1, 1),
]


@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
def test_codec_gemm_conv_model_matches_jax(case):
    _, b, t, cin, cout, k, s, pad, dil, g = case
    x, p = _conv_inputs(1, b, t, cin, k, cin // g, cout)
    want = jl.conv1d_apply(_jax(p), jnp.asarray(x), stride=s, padding=pad, dilation=dil,
                           groups=g)
    if case[0].startswith("pos_conv"):  # as wav2vec2's positional conv: one trailing frame off
        want = want[:, :-1]
    got = codec_gemm.conv1d_model(*_torch_args(x, p), s, pad, dil, g)
    if case[0].startswith("pos_conv"):
        got = got[:, :-1]
    _close(got, want)
    plain = codec_gemm.conv1d_plain(*_torch_args(x, p), s, pad, dil, g)  # the CPU's path
    _close(plain[:, :got.shape[1]], want)


def test_codec_gemm_int8_conv_and_linear_models_apply_the_scale_before_the_bias():
    x, p = _conv_inputs(2, 2, 17, 12, 7, 12, 10, int8=True)
    want = jl.conv1d_apply(_jax(p), jnp.asarray(x), padding=3)
    _close(codec_gemm.conv1d_model(*_torch_args(x, p), 1, 3), want)
    x, p = _conv_inputs(3, 2, 9, 12, 1, 12, 10, int8=True)
    lin = {"w_q": p["w_q"][0], "scale": p["scale"], "b": p["b"]}
    want = jl.linear_apply(_jax(lin), jnp.asarray(x))
    xt, w, bias, scale = _torch_args(x, p)
    _close(codec_gemm.conv1d_model(xt, w, bias, scale), want)
    _close(codec_gemm.linear_plain(xt, w[0], bias, scale), want)


@pytest.mark.parametrize("din,dout", [(24, 40), (40, 24), (8, 1), (1300, 6)])
def test_codec_gemm_linear_is_the_k1_conv(din, dout):
    x, p = _conv_inputs(4, 3, 5, din, 1, din, dout)
    lin = {"w": p["w"][0], "b": p["b"]}
    want = jl.linear_apply(_jax(lin), jnp.asarray(x))
    _close(codec_gemm.conv1d_model(*_torch_args(x, p)), want)


# (K, stride): every upsampler of the WaveGenerator (padding (K - s) / 2)
UPSAMPLERS = [(16, 8), (11, 5), (8, 4), (4, 2)]


@pytest.mark.parametrize("k,s", UPSAMPLERS, ids=[f"k{k} s{s}" for k, s in UPSAMPLERS])
def test_codec_gemm_transposed_phase_mapping_matches_jax(k, s):
    pad = (k - s) // 2
    x, p = _conv_inputs(5, 2, 9, 16, k, 16, 12)
    want = jl.conv_transpose1d_apply(_jax(p), jnp.asarray(x), stride=s, padding=pad)
    got = codec_gemm.conv_transpose1d_model(*_torch_args(x, p), s, pad)
    _close(got, want)
    _close(codec_gemm.conv_transpose1d_plain(*_torch_args(x, p), s, pad), want)


def test_codec_gemm_transposed_across_k_segments():
    """An upsampler whose reduction (2 taps x 300 channels) spans two of
    the kernel's k segments."""
    x, p = _conv_inputs(9, 1, 7, 300, 8, 300, 12)
    want = jl.conv_transpose1d_apply(_jax(p), jnp.asarray(x), stride=4, padding=2)
    _close(codec_gemm.conv_transpose1d_model(*_torch_args(x, p), 4, 2), want)


def test_codec_gemm_segments_are_summed_from_zero_and_added_in_order():
    """The model's order of sums: each K_SEGMENT of the reduction summed
    from zero over chunks of K_CHUNK, the segments' sums added in order
    (checked against that order written out in float32)."""
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.standard_normal((3, 1100)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1100, 5)).astype(np.float32))
    segs = []
    for s0 in range(0, 1100, codec_gemm.K_SEGMENT):
        acc = torch.zeros((3, 5))
        for k0 in range(s0, min(s0 + codec_gemm.K_SEGMENT, 1100), codec_gemm.K_CHUNK):
            acc = acc + a[:, k0:k0 + codec_gemm.K_CHUNK] @ b[k0:k0 + codec_gemm.K_CHUNK]
        segs.append(acc)
    assert len(segs) == 3
    assert torch.equal(codec_gemm.bmm_model(a, b), segs[0] + segs[1] + segs[2])


def test_codec_gemm_transposed_output_padding_and_int8():
    x, p = _conv_inputs(6, 1, 7, 8, 6, 8, 8, int8=True)
    want = jl.conv_transpose1d_apply(_jax(p), jnp.asarray(x), stride=3, padding=2,
                                     output_padding=1)
    _close(codec_gemm.conv_transpose1d_model(*_torch_args(x, p), 3, 2, 1), want)


# (name, a shape, b shape, einsum): the attention scores and values of
# wav2vec2 and the Perceiver, the FVQ similarities, the mel's RFFT
BMMS = [
    ("scores", (2, 4, 11, 16), (2, 4, 13, 16), "bhid,bhjd->bhij"),
    ("values", (2, 4, 11, 13), (2, 4, 13, 16), "bhij,bhjd->bhid"),
    ("fvq", (2, 9, 8), (64, 8), "btd,kd->btk"),
    ("mel", (1, 6, 32), (32, 17), "bfn,nk->bfk"),
    ("mel across k segments", (1, 6, 1100), (1100, 17), "bfn,nk->bfk"),
]


@pytest.mark.parametrize("case", BMMS, ids=[c[0] for c in BMMS])
def test_codec_gemm_bmm_model_matches_einsum(case):
    name, sa, sb, eq = case
    rng = np.random.default_rng(7)
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    want = jnp.einsum(eq, jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tb = tb.transpose(-1, -2) if name in ("scores", "fvq") else tb  # a strided operand
    _close(codec_gemm.bmm_model(ta, tb), want)
    _close(codec_gemm.bmm_plain(ta, tb), want)


# (name, T, C, K, stride, padding, dilation, transposed, output_padding)
DEPTHWISE = [
    ("vocos dwconv k7", 23, 16, 7, 1, 3, 1, False, 0),
    ("downsampler k4 s2", 30, 8, 4, 2, 1, 1, False, 0),
    ("downsampler k6 s3", 31, 8, 6, 3, 2, 1, False, 0),
    ("dilated k3", 20, 8, 3, 1, 2, 2, False, 0),
    ("upsampler k4 s2", 9, 8, 4, 2, 1, 1, True, 0),
    ("upsampler k6 s3", 9, 8, 6, 3, 2, 1, True, 1),
]


@pytest.mark.parametrize("case", DEPTHWISE, ids=[c[0] for c in DEPTHWISE])
def test_depthwise_model_matches_jax(case):
    _, t, c, k, s, pad, dil, transposed, out_pad = case
    x, p = _conv_inputs(8, 2, t, c, k, 1, c)
    if transposed:
        want = jl.conv_transpose1d_apply(_jax(p), jnp.asarray(x), stride=s, padding=pad,
                                         output_padding=out_pad, groups=c)
    else:
        want = jl.conv1d_apply(_jax(p), jnp.asarray(x), stride=s, padding=pad, dilation=dil,
                               groups=c)
    got = depthwise_conv.conv1d_model(*_torch_args(x, p), s, pad, dil, transposed, out_pad)
    _close(got, want)
    if transposed:
        plain = depthwise_conv.conv_transpose1d_plain_dw(*_torch_args(x, p), s, pad, out_pad)
    else:
        plain = depthwise_conv.conv1d_plain_dw(*_torch_args(x, p), s, pad, dil)
    _close(plain, want)


def test_codec_scope_routes_only_its_own_thread(monkeypatch):
    """A `codec_fp32()` scope open in one thread sends that thread's layer
    calls to the codec's kernels; another thread's calls at the same time
    take the plain path."""
    calls = []
    real = codec_gemm.linear

    def spy(x, *a, **k):
        calls.append(threading.current_thread().name)
        return real(x, *a, **k)

    monkeypatch.setattr(codec_gemm, "linear", spy)
    p = {"w": torch.randn(8, 4), "b": torch.zeros(4)}
    x = torch.randn(3, 8)
    inside, meet = threading.Event(), threading.Barrier(2, timeout=30)
    out = {}

    def scoped():
        with layers.codec_fp32():
            inside.set()
            meet.wait()
            out["scoped"] = layers.linear_apply(p, x)
            meet.wait()

    def bare():
        inside.wait(30)
        meet.wait()
        out["bare"] = layers.linear_apply(p, x)
        meet.wait()

    threads = [threading.Thread(target=f, name=f.__name__) for f in (scoped, bare)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert calls == ["scoped"]
    assert torch.equal(out["scoped"], out["bare"])  # on the CPU, the same code


def test_codec_scope_leaves_the_cpu_numbers_as_they_were():
    """On the CPU the scope's wrappers run the plain versions: every layer
    gives bit for bit what it gives outside the scope."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 21, 16, generator=gen)
    conv = {"w": torch.randn(7, 16, 12, generator=gen), "b": torch.randn(12, generator=gen)}
    dw = {"w": torch.randn(7, 1, 16, generator=gen), "b": torch.randn(16, generator=gen)}
    up = {"w": torch.randn(8, 16, 12, generator=gen), "b": torch.randn(12, generator=gen)}
    q = {"w_q": torch.randint(-127, 128, (16, 12), generator=gen, dtype=torch.int8),
         "scale": torch.rand(12, generator=gen), "b": torch.randn(12, generator=gen)}

    def run():
        return [layers.conv1d_apply(conv, x, padding=3),
                layers.conv1d_apply(dw, x, padding=3, groups=16),
                layers.conv_transpose1d_apply(up, x, stride=4, padding=2),
                layers.conv_transpose1d_apply(dw, x, stride=2, padding=1, groups=16),
                layers.linear_apply(q, x),
                layers.matmul(x, x.transpose(1, 2))]

    outside = run()
    with layers.codec_fp32():
        inside = run()
    for a, b in zip(outside, inside):
        assert torch.equal(a, b)


def test_codec_timing_script_runs_on_the_cpu(capsys):
    """`scripts/time_torch_codec.py` (the card's vocode and tokenize
    timing, parent vs change) at the tiny config on the CPU: one line a
    call, then its JSON document."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "time_torch_codec.py"
    spec = importlib.util.spec_from_file_location("time_torch_codec", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--tiny", "--device", "cpu", "--tokens", "24", "--seconds", "0.5",
                        "--runs", "1"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["card"] == "cpu" and doc["vocode_ms"] > 0 and doc["tokenize_ms"] > 0


def _script(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_codec_timing_script_traces_the_device_on_request(capsys):
    """`--trace` adds each call's device-kernel time and span (on the CPU
    no device kernel runs: zeros)."""
    import json

    assert _script("time_torch_codec").main(
        ["--tiny", "--device", "cpu", "--tokens", "24", "--seconds", "0.5", "--runs", "1",
         "--trace"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("vocode", "tokenize"):
        assert doc[f"{name}_kernels"] == 0 and doc[f"{name}_busy_ms"] == 0.0


def test_codec_tile_bench_needs_a_card(monkeypatch):
    """`scripts/bench_torch_codec_tiles.py` times kernel 7 on the card
    only: without one it exits 2 before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _script("bench_torch_codec_tiles").main(["--top", "1"]) == 2
