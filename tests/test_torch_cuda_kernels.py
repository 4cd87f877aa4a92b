"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel has
no CPU mode.  This file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Attention, bf16 tolerance 2e-2: both sides read the same bf16 inputs and
accumulate in fp32, so they differ by the bf16 rounding of the output (2^-8
relative) on values of magnitude O(1), plus fp32 summation order.  The
vocoder's ResidualUnit is fp32 on both sides; see its test.  The quantized
kernels at the full Qwen2.5-0.5B widths, bf16 x: the fused int8 MLP within
2e-2 of max|plain| (the two sum in another order, so a bf16 value of h may
round one ulp apart and carry into the down projection), the int4 matvec
within 1e-2 of max|plain| (bf16 output rounding plus summation order).
"""

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import Wav2Vec2Config
from sparktts_tpu_torch.kernels import decode_attention as da
from sparktts_tpu_torch.kernels import flash_attention as fa
from sparktts_tpu_torch.kernels import int4_matmul as i4
from sparktts_tpu_torch.kernels import int8_mlp as i8
from sparktts_tpu_torch.kernels import vocoder_fusion as vf
from sparktts_tpu_torch.nn.layers import full_fp32
from sparktts_tpu_torch.nn.wav2vec2 import wav2vec2_features
from sparktts_tpu_torch.weights import init_wav2vec2, to_torch

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
HQ, HKV, D = 14, 2, 64  # Qwen2.5-0.5B attention heads
HIDDEN, INTER = 896, 4864  # Qwen2.5-0.5B hidden and intermediate widths


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,starts",
    [(1, 64, [9]), (1, 128, [70]), (4, 77, [0, 3, 40, 76]), (1, 448, [29])],
)
def test_flash_kernel_matches_plain(b, t, starts):
    """Inputs laid out (B, T, H, D) and passed transposed, as the LM does.
    T = 448 from 29 is the bucket and left pad of a 6 s clone prompt."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    q = _randn(rng, (b, t, HQ, D), dev).transpose(1, 2)
    k, v = (_randn(rng, (b, t, HKV, D), dev).transpose(1, 2) for _ in range(2))
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    before = fa.launches
    got = fa.flash_attention_prefill(q, k, v, start, sm_scale=D**-0.5)
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, start, sm_scale=D**-0.5)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    rows = np.arange(t)[None, :] >= np.asarray(starts)[:, None]  # (B, T) non-pad rows
    mask = np.broadcast_to(rows[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[mask], want[mask], **BF16_TOL)
    assert np.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,starts,poss",
    [
        (1, 704, [0], [300]),
        (8, 704, [0, 5, 9, 60, 0, 1, 63, 40], [600, 100, 9, 70, 1, 640, 62, 639]),
        (1, 960, [29], [946]),
    ],
)
def test_decode_kernel_matches_plain(b, s, starts, poss):
    """Windows of many lengths, one of them empty (pos < start: zeros).
    S = 960 with 918 keys is the last decode step of a clone request."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, HQ, D), dev)
    ck, cv = (_randn(rng, (2, b, s, HKV, D), dev) for _ in range(2))
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    pos = torch.tensor(poss, dtype=torch.int32, device=dev)
    before = da.launches
    got = da.dense_decode_attention(q, ck, cv, 1, start, pos, sm_scale=0.125)
    assert da.launches == before + 1
    want = da.dense_decode_plain(q, ck, cv, 1, start, pos, sm_scale=0.125)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **BF16_TOL)


def _residual_unit(c, dev, seed=0):
    """fp32 unit params at width c, non-trivial alphas and biases."""
    g = torch.Generator().manual_seed(seed)
    p = {
        "snake1": {"alpha": 0.5 + torch.rand(c, generator=g)},
        "conv1": {"w": 0.02 * torch.randn((7, c, c), generator=g),
                  "b": 0.1 * torch.randn(c, generator=g)},
        "snake2": {"alpha": 0.5 + torch.rand(c, generator=g)},
        "conv2": {"w": 0.02 * torch.randn((1, c, c), generator=g),
                  "b": 0.1 * torch.randn(c, generator=g)},
    }
    return {k: {n: v.to(dev) for n, v in d.items()} for k, d in p.items()}


@pytest.mark.cuda
# 333: ragged; (768, 4000): the first block of a 500-token vocode
@pytest.mark.parametrize("c,t", [(96, 2560), (192, 1280), (384, 640), (768, 333), (768, 4000)])
@pytest.mark.parametrize("dilation", (1, 3, 9))
def test_vocoder_kernel_matches_plain(c, t, dilation):
    """fp32 on both sides with TF32 off: they differ only in the order of the
    7C + C-term sums, so max|kernel - plain| <= 1e-4 max|plain|."""
    dev = _cuda()
    p = _residual_unit(c, dev)
    x = torch.randn((2, t, c), generator=torch.Generator().manual_seed(1)).to(dev)
    before = vf.launches
    got = vf.fused_residual_unit(p, x, dilation)
    assert vf.launches == before + 1
    with full_fp32():
        want = vf.fused_residual_unit_plain(p, x, dilation)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.cuda
def test_codec_is_full_fp32_under_pytorch_defaults():
    """wav2vec2's convs on the card, with PyTorch's default flags (cuDNN may
    use TF32), against a float64 CPU run of the same function (its
    LayerNorms normalise in fp32): 1e-5 of the peak.  TF32 would miss by
    ~1e-3.  The caller's flags are restored after the call."""
    dev = _cuda()
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default, left as it is
    cfg = Wav2Vec2Config(conv_dim=(256, 256, 256), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                         hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=512, num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4, hidden_state_mix=(1, 2))
    p = init_wav2vec2(cfg, torch.Generator().manual_seed(0), "cpu")
    wav = torch.randn((1, 16000), generator=torch.Generator().manual_seed(1))
    want = wav2vec2_features(to_torch(p, "cpu", torch.float64), wav.double(), cfg)
    got = wav2vec2_features(to_torch(p, dev), wav.to(dev), cfg).cpu().double()
    assert torch.backends.cudnn.allow_tf32
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """On the card there is no fallback: an unsupported input raises."""
    dev = _cuda()
    q = torch.zeros((1, HQ, 8, D), device=dev)  # fp32
    k = torch.zeros((1, HKV, 8, D), device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention_prefill(q, k, k, start)
    q = torch.zeros((1, HQ, 32), dtype=torch.bfloat16, device=dev)  # head dim 32
    cache = torch.zeros((1, 1, 64, HKV, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        da.dense_decode_attention(q, cache, cache, 0, start, start)
    p = _residual_unit(96, dev)
    with pytest.raises(TypeError):
        vf.fused_residual_unit(p, torch.zeros((1, 64, 96), dtype=torch.bfloat16, device=dev), 1)
    with pytest.raises(ValueError):
        vf.fused_residual_unit(_residual_unit(64, dev), torch.zeros((1, 64, 64), device=dev), 1)
    with pytest.raises(ValueError):
        vf.fused_residual_unit(p, torch.zeros((1, 96, 64), device=dev).transpose(1, 2), 1)


def _int8_mlp_weights(dev, k=HIDDEN, i=INTER, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    gu = torch.randint(-127, 128, (k, 2 * i), generator=g, device=dev, dtype=torch.int8)
    down = torch.randint(-127, 128, (i, k), generator=g, device=dev, dtype=torch.int8)
    gs = 1e-3 * (1 + torch.rand(2 * i, generator=g, device=dev))
    ds = 1e-3 * (1 + torch.rand(k, generator=g, device=dev))
    return gu, gs, down, ds


def _rel_err(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (1, 4, 16))
def test_int8_mlp_kernel_matches_plain(rows):
    dev = _cuda()
    w = _int8_mlp_weights(dev)
    x = torch.randn((rows, HIDDEN), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    before = i8.launches
    got = i8.int8_mlp_matvec(x, *w)
    assert i8.launches == before + 1 and got.dtype == torch.bfloat16
    assert _rel_err(got, i8.int8_mlp_matvec_plain(x, *w)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,d_out", [(896, 1152), (896, 896), (896, 9728), (4864, 896)])
@pytest.mark.parametrize("b", (1, 8, 32))
def test_int4_kernel_matches_plain(d_in, d_out, b):
    """The four layer shapes of the int4 LM, group 128."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(d_in + d_out + b)
    packed = torch.randint(-128, 128, (d_in // 2, d_out), generator=g, device=dev,
                           dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((d_in // 128, d_out), generator=g, device=dev))
    x = torch.randn((b, d_in), generator=g, device=dev).to(torch.bfloat16)
    before = i4.launches
    got = i4.int4_matvec(x, packed, gscale)
    assert i4.launches == before + 1 and got.dtype == torch.bfloat16
    assert _rel_err(got, i4.int4_matvec_plain(x, packed, gscale)) <= 1e-2


@pytest.mark.cuda
def test_quantized_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    gu, gs, down, ds = _int8_mlp_weights(dev, k=64, i=96)
    x = torch.zeros((17, 64), dtype=torch.bfloat16, device=dev)  # 17 rows
    with pytest.raises(ValueError):
        i8.int8_mlp_matvec(x, gu, gs, down, ds)
    with pytest.raises(TypeError):
        i8.int8_mlp_matvec(x[:4].float(), gu, gs, down, ds)
    with pytest.raises(ValueError):
        i8.int8_mlp_matvec(torch.zeros((64, 4), dtype=torch.bfloat16, device=dev).t(), gu, gs,
                           down, ds)
    with pytest.raises(ValueError):
        i8.int8_mlp_matvec(x[:4], gu, gs, down[:, :32], ds)
    packed = torch.zeros((32, 40), dtype=torch.int8, device=dev)
    gscale = torch.ones((4, 40), device=dev)
    x = torch.zeros((33, 64), dtype=torch.bfloat16, device=dev)  # 33 rows
    with pytest.raises(ValueError):
        i4.int4_matvec(x, packed, gscale)
    with pytest.raises(TypeError):
        i4.int4_matvec(x[:2].float(), packed, gscale)
    with pytest.raises(ValueError):
        i4.int4_matvec(torch.zeros((64, 2), dtype=torch.bfloat16, device=dev).t(), packed, gscale)
    with pytest.raises(ValueError):
        i4.int4_matvec(x[:2, :32], packed, gscale)  # in != 2 packed rows
