"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel has
no CPU mode.  This file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Attention (flash, dense and paged decode), bf16 tolerance 2e-2: both sides
read the same bf16 inputs and accumulate in fp32, so they differ by the bf16
rounding of the output (2^-8 relative) on values of magnitude O(1), plus
fp32 summation order; the flash kernel also rounds P to bf16 before P V
(2^-9 relative on each probability).  The
vocoder's ResidualUnit is fp32 on both sides; see its test.  The quantized
kernels at the full Qwen2.5-0.5B widths, bf16 x: the fused int8 MLP within
2e-2 of max|plain| and of its tiled model (the two sum in another order, so
a bf16 value of h may round one ulp apart and carry into the down
projection), the int4 matvec
within 1e-2 of max|plain| (bf16 output rounding plus summation order).
"""

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import Wav2Vec2Config
from sparktts_tpu_torch.kernels import arrivals
from sparktts_tpu_torch.kernels import decode_attention as da
from sparktts_tpu_torch.kernels import flash_attention as fa
from sparktts_tpu_torch.kernels import int4_matmul as i4
from sparktts_tpu_torch.kernels import int8_mlp as i8
from sparktts_tpu_torch.kernels import paged_attention as pa
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


def _flash_case(dev, b, t, starts, seed=0):
    """Inputs laid out (B, T, H, D) and passed transposed, as the LM does."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, t, HQ, D), dev).transpose(1, 2)
    k, v = (_randn(rng, (b, t, HKV, D), dev).transpose(1, 2) for _ in range(2))
    return q, k, v, torch.tensor(starts, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,starts",
    [
        (1, 64, [9]), (1, 128, [70]), (4, 77, [0, 3, 40, 76]), (1, 448, [29]),
        # lengths around the 16-row warp and 64-row/64-key tiles; starts at a
        # tile's edge (0, 16, 64) and inside one
        (1, 1, [0]), (2, 15, [0, 7]), (2, 16, [0, 15]), (2, 17, [16, 3]),
        (2, 63, [0, 31]), (3, 65, [64, 1, 33]), (2, 448, [64, 200]),
    ],
)
def test_flash_kernel_matches_plain(b, t, starts):
    """T = 448 from 29 is the bucket and left pad of a 6 s clone prompt.
    The kernel rounds P to bf16 before P V (the plain version does not):
    within the bf16 tolerance."""
    dev = _cuda()
    q, k, v, start = _flash_case(dev, b, t, starts)
    before = fa.launches
    got = fa.flash_attention_prefill(q, k, v, start, sm_scale=D**-0.5)
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, start, sm_scale=D**-0.5)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    rows = np.arange(t)[None, :] >= np.asarray(starts)[:, None]  # (B, T) non-pad rows
    mask = np.broadcast_to(rows[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[mask], want[mask], **BF16_TOL)
    assert np.all(got[~mask] == 0)  # rows with no valid key
    assert np.isfinite(got).all()


def _decode_case(dev, b, s, starts, poss, seed=1):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, HQ, D), dev)
    ck, cv = (_randn(rng, (2, b, s, HKV, D), dev) for _ in range(2))
    return (q, ck, cv, torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(poss, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,starts,poss",
    [
        (1, 704, [0], [300]),
        (8, 704, [0, 5, 9, 60, 0, 1, 63, 40], [600, 100, 9, 70, 1, 640, 62, 639]),
        (1, 960, [29], [946]),
        # the dense engine's kind: right-padded prompts from 0, windows of
        # ~50-560 keys, a finished row at pos = S (clamped to S - 1), an idle one
        (8, 960, [0] * 8, [447, 120, 560, 63, 960, 0, 300, 511]),
        # windows on the kernel's chunk edges and one key either side
        (6, 960, [64, 63, 65, 128, 0, 127], [127, 128, 126, 128, 63, 959]),
    ],
)
def test_decode_kernel_matches_plain(b, s, starts, poss):
    """Windows of many lengths, one of them empty (pos < start: zeros).
    S = 960 with 918 keys is the last decode step of a clone request.  Also
    against the CPU model of the kernel's split (`dense_decode_split_plain`)
    at the built kernel's chunk."""
    dev = _cuda()
    q, ck, cv, start, pos = _decode_case(dev, b, s, starts, poss)
    before = da.launches
    got = da.dense_decode_attention(q, ck, cv, 1, start, pos, sm_scale=0.125)
    assert da.launches == before + 1
    want = da.dense_decode_plain(q, ck, cv, 1, start, pos, sm_scale=0.125)
    split = da.dense_decode_split_plain(q, ck, cv, 1, start, pos, sm_scale=0.125,
                                        chunk=da.kernel_chunk())
    got = got.float().cpu().numpy()
    np.testing.assert_allclose(got, want.float().cpu().numpy(), **BF16_TOL)
    np.testing.assert_allclose(got, split.float().cpu().numpy(), **BF16_TOL)
    empty = (pos < start).cpu().numpy()
    assert np.all(got[empty] == 0)


@pytest.mark.cuda
def test_attention_kernels_repeat_bit_equal():
    """Two calls of each kernel on the same inputs give the same bits: the
    decode kernel merges its chunks in a fixed order, with no float atomics,
    and leaves its arrival counters at zero for the next call."""
    dev = _cuda()
    q, k, v, start = _flash_case(dev, 2, 448, [29, 64])
    first = fa.flash_attention_prefill(q, k, v, start, sm_scale=D**-0.5)
    assert torch.equal(first, fa.flash_attention_prefill(q, k, v, start, sm_scale=D**-0.5))
    q, ck, cv, start, pos = _decode_case(dev, 8, 960, [0] * 8, [447, 120, 560, 63, 960, 0, 300,
                                                                 511])
    first = da.dense_decode_attention(q, ck, cv, 0, start, pos, sm_scale=0.125)
    for _ in range(3):
        assert torch.equal(first, da.dense_decode_attention(q, ck, cv, 0, start, pos,
                                                            sm_scale=0.125))


def _paged_case(dev, page, lengths, pps=4, layers=24, seed=2):
    """Pools at the full widths, each slot's valid pages distinct and out of
    order, table tails zero (the trash page)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = b * pps + 1
    ids = rng.permutation(np.arange(1, n_pages)).reshape(b, pps).astype(np.int32)
    used = np.minimum(-(-np.asarray(lengths) // page), pps)
    table = np.where(np.arange(pps)[None, :] < used[:, None], ids, 0).astype(np.int32)
    q = _randn(rng, (b, HQ, D), dev)
    kp, vp = (_randn(rng, (layers, HKV, n_pages, page, D), dev) for _ in range(2))
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "page,lengths",
    [
        # the engine's page size: lengths 1, P, P + 1, the full table, empty,
        # ragged, and a finished slot one past its table (4 P + 1)
        (256, [1, 256, 257, 1024, 0, 500, 771, 1025]),
        (16, [1, 16, 17, 64, 0, 33, 5, 65]),
    ],
)
def test_paged_kernel_matches_plain(page, lengths):
    dev = _cuda()
    q, kp, vp, table, lens = _paged_case(dev, page, lengths)
    for layer in (0, kp.shape[0] - 1):
        before = pa.launches
        got = pa.paged_decode_attention(q, kp, vp, table, lens, layer, sm_scale=0.125)
        assert pa.launches == before + 1
        want = pa.paged_decode_plain(q, kp, vp, table, lens, layer, sm_scale=0.125)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **BF16_TOL)
        assert torch.all(got[4] == 0)  # the empty slot


@pytest.mark.cuda
@pytest.mark.parametrize(
    "page,lengths",
    [
        # every slot near the full table (the late state of a long burst)
        (256, [1024, 1023, 1000, 961, 1025, 1010, 999, 1017]),
        # multiples of 64 and the keys next to them: the built kernel's 128-key chunk
        # edges (128, 256) among them
        (256, [63, 64, 65, 128, 129, 191, 192, 255]),
        # pages smaller than a chunk: a chunk spans pages
        (16, [1, 15, 16, 17, 48, 49, 64, 65]),
    ],
)
def test_paged_kernel_matches_plain_and_its_split_model_and_repeats(page, lengths):
    """Also against `paged_decode_split_plain` at the built kernel's chunk,
    and two calls bit-equal (chunks merged in a fixed order)."""
    dev = _cuda()
    q, kp, vp, table, lens = _paged_case(dev, page, lengths, layers=4)
    got = pa.paged_decode_attention(q, kp, vp, table, lens, 3, sm_scale=0.125)
    again = pa.paged_decode_attention(q, kp, vp, table, lens, 3, sm_scale=0.125)
    want = pa.paged_decode_plain(q, kp, vp, table, lens, 3, sm_scale=0.125)
    split = pa.paged_decode_split_plain(q, kp, vp, table, lens, 3, sm_scale=0.125,
                                        chunk=pa.kernel_chunk())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got = got.float().cpu().numpy()
    np.testing.assert_allclose(got, want.float().cpu().numpy(), **BF16_TOL)
    np.testing.assert_allclose(got, split.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
def test_paged_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _cuda()
    q, kp, vp, table, lens = _paged_case(dev, 16, [1, 16], layers=2)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.float(), kp, vp, table, lens, 0)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, table.long(), lens, 0)  # int64 table
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, table, lens.cpu(), 0)
    with pytest.raises(IndexError):
        pa.paged_decode_attention(q, kp, vp, table, lens, 2)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp, vp, table,
                                  lens, 0)  # not contiguous
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q[:, :, :32].contiguous(), kp[..., :32].contiguous(),
                                  vp[..., :32].contiguous(), table, lens, 0)  # head dim 32
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q[:, :12].contiguous(), kp, vp, table, lens, 0)  # group 6


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


def _vocoder_model_tol(c):
    """Kernel vs `residual_unit_3xtf32_plain` (the same three tf32 products
    summed by cuBLAS in fp32, TF32 off), relative to max|model|: they differ
    in the accumulation alone, which the tensor cores round toward zero at
    each mma step, so the gap grows with C (on an H100, 8.6e-7 at C = 96 to
    3.5e-5 at C = 768, scripts/check_torch_vocoder_accumulation.py); leaving
    out one of the three products costs 4.3e-5 at C = 96 to 2.2e-4 at C = 768,
    above this limit at every C.  chip_smoke.vocoder_model_tol is the same."""
    return 7e-5 * (c / 768) ** 1.5


@pytest.mark.cuda
# 333: ragged; (768, 4000): the first block of a 500-token vocode
@pytest.mark.parametrize("c,t", [(96, 2560), (192, 1280), (384, 640), (768, 333), (768, 4000)])
@pytest.mark.parametrize("dilation", (1, 3, 9))
def test_vocoder_kernel_matches_plain(c, t, dilation):
    """fp32-accurate on both sides with TF32 off: max|kernel - plain| <= 1e-4
    max|plain|.  The kernel also keeps all three products of its hi/lo
    split: it stays within `_vocoder_model_tol(c)` of the CPU model of its
    arithmetic, run on the card."""
    dev = _cuda()
    p = _residual_unit(c, dev)
    x = torch.randn((2, t, c), generator=torch.Generator().manual_seed(1)).to(dev)
    before = vf.launches
    got = vf.fused_residual_unit(p, x, dilation)
    assert vf.launches == before + 1
    with full_fp32():
        want = vf.fused_residual_unit_plain(p, x, dilation)
        model = vf.residual_unit_3xtf32_plain(p, x, dilation)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    gap = float((got - model).abs().max()) / float(model.abs().max())
    assert gap <= _vocoder_model_tol(c), gap


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,dilation", [(768, 2800, 1), (96, 4321, 9)])
def test_vocoder_kernel_repeats_bit_equal(c, t, dilation):
    """A fixed order of 3xTF32 products and no atomics: repeats give the
    same bits, and stay within 1e-4 max|plain| of the plain unit."""
    dev = _cuda()
    p = _residual_unit(c, dev, seed=c + t)
    x = torch.randn((1, t, c), generator=torch.Generator().manual_seed(2)).to(dev)
    got = vf.fused_residual_unit(p, x, dilation)
    for _ in range(2):
        assert torch.equal(got, vf.fused_residual_unit(p, x, dilation))
    with full_fp32():
        want = vf.fused_residual_unit_plain(p, x, dilation)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


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
    q, k = (x.to(torch.bfloat16) for x in (q, k))
    with pytest.raises(ValueError):  # base pointer 2 bytes past a 16-byte boundary
        fa.flash_attention_prefill(
            torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape), k, k, start)
    wide = torch.zeros((1, 8, HKV * D + 4), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # row stride of 132 elements
        fa.flash_attention_prefill(q, wide[..., :HKV * D].view(1, 8, HKV, D).transpose(1, 2), k,
                                   start)
    cache = torch.zeros((1, 1, 64, HKV, D), dtype=torch.bfloat16, device=dev)
    qd = torch.zeros((1, HQ * D + 1), dtype=torch.bfloat16, device=dev)[:, 1:].view(1, HQ, D)
    with pytest.raises(ValueError):  # q 2 bytes past a 16-byte boundary
        da.dense_decode_attention(qd, cache, cache, 0, start, start)
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
@pytest.mark.parametrize("rows", (1, 4, 8, 16))
def test_int8_mlp_kernel_matches_plain(rows):
    """Also against the CPU model of the kernel's down-sum order
    (`int8_mlp_tiled_plain`, run on the card), and two calls bit-equal."""
    dev = _cuda()
    w = _int8_mlp_weights(dev)
    x = torch.randn((rows, HIDDEN), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    before = i8.launches
    got = i8.int8_mlp_matvec(x, *w)
    assert i8.launches == before + 1 and got.dtype == torch.bfloat16
    assert _rel_err(got, i8.int8_mlp_matvec_plain(x, *w)) <= 2e-2
    assert _rel_err(got, i8.int8_mlp_tiled_plain(x, *w)) <= 2e-2
    assert torch.equal(got, i8.int8_mlp_matvec(x, *w))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,i", [
    (3, HIDDEN, 1000),  # I not a multiple of 16: byte copies, a part tile, a padded cluster
    (9, HIDDEN, 200),  # one cluster, two n-tiles
    (1, 100, 256),  # K not a multiple of 16: rows of x and down zero-filled
    (16, 64, 96),  # tiny widths
])
def test_int8_mlp_kernel_ragged_and_repeats_bit_equal(rows, k, i):
    dev = _cuda()
    w = _int8_mlp_weights(dev, k=k, i=i, seed=rows)
    x = torch.randn((rows, k), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev).to(torch.bfloat16)
    got = i8.int8_mlp_matvec(x, *w)
    for _ in range(2):
        assert torch.equal(got, i8.int8_mlp_matvec(x, *w))
    assert _rel_err(got, i8.int8_mlp_matvec_plain(x, *w)) <= 2e-2
    assert _rel_err(got, i8.int8_mlp_tiled_plain(x, *w)) <= 2e-2


@pytest.mark.cuda
def test_int8_mlp_entry_refuses_a_workspace_or_counters_of_another_size():
    """The C entry checks the grid's workspace and counter sizes itself, so a
    wrapper that sized them from other values than the kernel's cannot make
    it write past them: it returns cudaErrorInvalidValue (1) unlaunched."""
    dev = _cuda()
    gu, gs, down, ds = _int8_mlp_weights(dev)
    x = torch.randn((1, HIDDEN), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev).to(torch.bfloat16)
    out = torch.empty_like(x)
    clusters = i8._clusters(INTER)
    ws = torch.empty((clusters + 1, 1, HIDDEN), dtype=torch.float32, device=dev)
    counters = arrivals.prepare()
    fn = i8._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (x, gu, gs, down, ds, ws)]
    for n_ws, n_counters in ((clusters - 1, counters.numel()), (clusters + 1, counters.numel()),
                             (clusters, i8.CLUSTER - 1)):
        assert fn(*ptrs, n_ws, counters.data_ptr(), n_counters, out.data_ptr(), 1, HIDDEN, INTER,
                  stream) == 1
    assert fn(*ptrs, clusters, counters.data_ptr(), counters.numel(), out.data_ptr(), 1, HIDDEN,
              INTER, stream) == 0
    assert _rel_err(out, i8.int8_mlp_matvec_plain(x, gu, gs, down, ds)) <= 2e-2


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
@pytest.mark.parametrize("d_in,d_out,group,b", [
    (896, 1000, 128, 3),  # ragged out: no 16-byte row loads, a partial column tile
    (4864, 896, 128, 9),  # down with a partial tile of 8 x rows
    (4864, 896, 128, 32),  # down at the most rows: several groups a block, merged
    (896, 9728, 128, 8),  # gate/up at the engines' 8 rows
    (896, 9728, 128, 32),  # gate/up at 32 rows: the tiles fill the card, a block walks 7 groups
    (256, 70, 16, 3),  # out not a multiple of 4: rows byte by byte, the merge without cp.async
    (896, 1152, 64, 1),  # 14 groups, more than a block holds: one a block, merged through
    # the workspace
    (256, 72, 16, 2),  # small groups: rows past a group's end in a lane's walk
    (256, 80, 16, 1),  # one row, out not a multiple of 16: rows read byte by byte
])
def test_int4_kernel_ragged_and_repeats_bit_equal(d_in, d_out, group, b):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(d_in + d_out + group + b)
    packed = torch.randint(-128, 128, (d_in // 2, d_out), generator=g, device=dev,
                           dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((d_in // group, d_out), generator=g, device=dev))
    x = torch.randn((b, d_in), generator=g, device=dev).to(torch.bfloat16)
    got = i4.int4_matvec(x, packed, gscale)
    for _ in range(2):
        assert torch.equal(got, i4.int4_matvec(x, packed, gscale))
    assert _rel_err(got, i4.int4_matvec_plain(x, packed, gscale)) <= 1e-2


def _decode_streams_case(dev):
    q, ck, cv, start, pos = _decode_case(dev, 8, 960, [0] * 8, [447, 120, 560, 63, 959, 0, 300,
                                                                 511])
    want = da.dense_decode_plain(q, ck, cv, 1, start, pos, sm_scale=0.125)
    return (q, ck, cv, 1, start, pos), want


@pytest.mark.cuda
def test_decode_kernel_on_two_streams_at_once():
    """Kernel 2 on two streams of one card, calls interleaved so they may
    run at the same time: each stream merges on its own arrival counters,
    and both match the plain version in every call."""
    dev = _cuda()
    cases = [_decode_streams_case(dev) for _ in range(2)]
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(da.dense_decode_attention(*cases[i][0], sm_scale=0.125))
    torch.cuda.synchronize()
    keys = {arrivals.stream_key(s) for s in streams}
    assert keys <= set(arrivals.REGISTRY.keys()) and len(keys) == 2
    for i in range(2):
        want = cases[i][1].float().cpu().numpy()
        for got in outs[i]:
            np.testing.assert_allclose(got.float().cpu().numpy(), want, **BF16_TOL)
        assert all(torch.equal(outs[i][0], o) for o in outs[i])


@pytest.mark.cuda
def test_merging_kernels_replay_in_a_graph_on_a_prepared_stream():
    """Kernels 2, 5, 6 and 4 captured in one CUDA graph on a stream whose
    counters were made first (`arrivals.prepare`): replays match eager
    calls bit for bit.  Capture on a stream that has no counters raises."""
    dev = _cuda()
    args2, _ = _decode_streams_case(dev)
    args6 = _paged_case(dev, 256, [1024, 500, 1, 0, 771, 1025, 256, 257], layers=2)
    g = torch.Generator(device=dev).manual_seed(5)
    packed = torch.randint(-128, 128, (2432, 896), generator=g, device=dev, dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((38, 896), generator=g, device=dev))
    x = torch.randn((1, 4864), generator=g, device=dev).to(torch.bfloat16)
    w8 = _int8_mlp_weights(dev, seed=6)
    x8 = torch.randn((8, HIDDEN), generator=g, device=dev).to(torch.bfloat16)

    def calls():
        return (da.dense_decode_attention(*args2, sm_scale=0.125),
                pa.paged_decode_attention(*args6, 1, sm_scale=0.125),
                i4.int4_matvec(x, packed, gscale),
                i8.int8_mlp_matvec(x8, *w8))

    eager = calls()
    stream = torch.cuda.Stream(device=dev)
    arrivals.prepare(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = calls()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, captured))
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=torch.cuda.Stream(device=dev)):
            calls()


@pytest.mark.cuda
def test_kernels_launch_on_the_card_of_their_tensors():
    """With card 0 current, each kernel given tensors on card 1 runs there
    (the launch helper makes card 1 current) and matches its plain version.
    Needs two cards; skips on one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    args2, want2 = _decode_streams_case(dev)
    q, kp, vp, table, lens = _paged_case(dev, 256, [1024, 500, 1, 0], layers=2)
    got6 = pa.paged_decode_attention(q, kp, vp, table, lens, 1, sm_scale=0.125)
    want6 = pa.paged_decode_plain(q, kp, vp, table, lens, 1, sm_scale=0.125)
    qf, kf, vf_, start = _flash_case(dev, 2, 77, [0, 9])
    got1 = fa.flash_attention_prefill(qf, kf, vf_, start, sm_scale=D**-0.5)
    want1 = fa.flash_attention_plain(qf, kf, vf_, start, sm_scale=D**-0.5)
    g = torch.Generator(device=dev).manual_seed(3)
    packed = torch.randint(-128, 128, (448, 1152), generator=g, device=dev, dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((7, 1152), generator=g, device=dev))
    x = torch.randn((1, 896), generator=g, device=dev).to(torch.bfloat16)
    w8 = _int8_mlp_weights(dev)
    x8 = torch.randn((2, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
    unit = _residual_unit(96, dev)
    xu = torch.randn((1, 256, 96), generator=g, device=dev)
    got2 = da.dense_decode_attention(*args2, sm_scale=0.125)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    for got, want in ((got2, want2), (got6, want6)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **BF16_TOL)
    rows = (torch.arange(77, device=dev)[None, :] >= start[:, None])[:, None, :, None]
    assert float((got1.float() - want1.float()).abs().masked_select(rows).max()) <= 2e-2
    assert _rel_err(i4.int4_matvec(x, packed, gscale), i4.int4_matvec_plain(x, packed,
                                                                            gscale)) <= 1e-2
    assert _rel_err(i8.int8_mlp_matvec(x8, *w8), i8.int8_mlp_matvec_plain(x8, *w8)) <= 2e-2
    with full_fp32():
        want_u = vf.fused_residual_unit_plain(unit, xu, 1)
    got_u = vf.fused_residual_unit(unit, xu, 1)
    torch.cuda.synchronize(dev)
    assert float((got_u - want_u).abs().max()) <= 1e-4 * float(want_u.abs().max())


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
    k = 62  # not a multiple of 4
    gu, gs, down, ds = _int8_mlp_weights(dev, k=k, i=96)
    with pytest.raises(ValueError):
        i8.int8_mlp_matvec(torch.zeros((2, k), dtype=torch.bfloat16, device=dev), gu, gs, down, ds)
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


# ---------------------------------------------------------------------------
# decode units (lm/graphs.py): captured decode loops against the eager loop
# ---------------------------------------------------------------------------

UNIT_LAYERS = 2  # the full Qwen2.5-0.5B widths, two layers
GUIDED = dict(vocab_slice=(151665, 151665 + 8192), extra_ids=(151645, 151650))


def _unit_lm(dev, lm, tied=True):
    from sparktts_tpu_torch.config import QwenConfig
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int4, quantize_qwen_int8
    from sparktts_tpu_torch.weights import init_qwen

    cfg = QwenConfig(num_hidden_layers=UNIT_LAYERS, tie_word_embeddings=tied)
    params = init_qwen(cfg, torch.Generator(device=dev).manual_seed(3), torch.bfloat16, dev)
    if lm == "int8":
        params = quantize_qwen_int8(params)
    elif lm == "int4":
        params = quantize_qwen_int4(params, group=128)
    return cfg, params


def _unit_prompt(dev, t_pad=64, n=41):
    ids = torch.full((1, t_pad), 151643, dtype=torch.long)
    ids[0, t_pad - n:] = torch.arange(1000, 1000 + n)
    mask = torch.zeros((1, t_pad), dtype=torch.bool)
    mask[0, t_pad - n:] = True
    return ids.to(dev), mask.to(dev)


def _generators(dev, seed):
    """One generator for an int seed, one per row for a list of seeds."""
    if isinstance(seed, int):
        return torch.Generator(device=dev).manual_seed(seed)
    return [torch.Generator(device=dev).manual_seed(s) for s in seed]


def _eager_generate(cfg, params, ids, mask, seed, greedy, max_new):
    """`generate`'s semantics as `decode_step` in a Python loop (`seed`: an
    int, or a list of per-row seeds)."""
    from sparktts_tpu_torch.lm import generate as tgen
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache

    dev, t_pad = ids.device, ids.shape[1]
    gen = _generators(dev, seed)
    cache = init_kv_cache(cfg, ids.shape[0], aligned_cache_len(t_pad + max_new), torch.bfloat16,
                          dev)
    temperature, top_p = (torch.full((), v, device=dev) for v in (0.8, 0.95))
    state = tgen.prefill(params, cfg, ids, mask, cache, gen, 0.8, 50, 0.95, greedy, **GUIDED)
    toks = []
    for _ in range(max_new):
        toks.append(state.cur_token)
        state = tgen.decode_step(params, cfg, state, t_pad, gen, temperature, 50, top_p, (), 0,
                                 greedy, **GUIDED)
    return torch.stack(toks, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("lm", ["bf16", "int8", "int4"])
def test_generate_replays_equal_the_eager_loop(lm):
    """`generate` on the card replays its captured unit of 8 steps: greedy
    and sampled ids equal the eager loop's with the same seed, a seed twice
    gives the same ids, and the launches are the unit's times its replays
    (kernel 2 and, quantized, kernel 4 or 5 in every step; one prefill)."""
    from sparktts_tpu_torch.lm import generate as tgen
    from sparktts_tpu_torch.lm import graphs

    dev = _cuda()
    cfg, params = _unit_lm(dev, lm)
    ids, mask = _unit_prompt(dev)
    max_new = 37
    with torch.inference_mode():
        for greedy in (True, False):
            want = _eager_generate(cfg, params, ids, mask, 5, greedy, max_new)
            graphs.reset_launches()
            runs = [tgen.generate(params, cfg, ids, mask,
                                  torch.Generator(device=dev).manual_seed(5), max_new,
                                  64 + max_new, greedy=greedy, **GUIDED)[0]
                    for _ in range(2)]
            counts = graphs.launches()
            assert torch.equal(runs[0], want) and torch.equal(runs[1], want)
            steps = 2 * 8 * -(-max_new // 8)  # two calls, whole units
            assert counts["flash_attention_prefill"] == 2 * UNIT_LAYERS
            assert counts["dense_decode_attention"] == UNIT_LAYERS * steps
            assert counts["int8_mlp_matvec"] == (UNIT_LAYERS * steps if lm == "int8" else 0)
            assert counts["int4_matvec"] == (4 * UNIT_LAYERS * steps if lm == "int4" else 0)


@pytest.mark.cuda
def test_per_row_generators_replay_equal_the_eager_loop():
    """A decode unit of B = 4 rows with one generator per row (each
    registered with its graph): sampled ids with per-row seeds [7, 9, 7, 5]
    equal the eager loop's with four such generators; rows 0 and 2 (one
    prompt, one seed) are equal; the rows swapped with their seeds give each
    row's ids again."""
    from sparktts_tpu_torch.lm import generate as tgen

    dev = _cuda()
    cfg, params = _unit_lm(dev, "bf16")
    lengths, seeds, max_new = (41, 20, 41, 60), [7, 9, 7, 5], 37
    ids = torch.full((4, 64), 151643, dtype=torch.long)
    mask = torch.zeros((4, 64), dtype=torch.bool)
    for i, n in enumerate(lengths):
        ids[i, 64 - n:] = torch.arange(1000 + 100 * (i % 2) + 50 * (i == 3),
                                       1000 + 100 * (i % 2) + 50 * (i == 3) + n)
        mask[i, 64 - n:] = True
    ids, mask = ids.to(dev), mask.to(dev)
    with torch.inference_mode():
        want = _eager_generate(cfg, params, ids, mask, seeds, False, max_new)
        got = tgen.generate(params, cfg, ids, mask, _generators(dev, seeds), max_new,
                            64 + max_new, **GUIDED)[0]
        perm = [1, 0, 3, 2]
        swapped = tgen.generate(params, cfg, ids[perm], mask[perm],
                                _generators(dev, [seeds[i] for i in perm]), max_new,
                                64 + max_new, **GUIDED)[0]
    assert torch.equal(got, want)
    assert torch.equal(got[0], got[2]) and not torch.equal(got[0], got[1])
    assert torch.equal(swapped, got[perm])


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
def test_untied_int4_head_replays_equal_the_eager_loop(greedy):
    """An untied LM whose int4 head (`w_p4`/`gscale`, its guided columns
    dequantized in the step) runs inside the captured unit: ids equal the
    eager loop's."""
    from sparktts_tpu_torch.lm import generate as tgen

    dev = _cuda()
    cfg, params = _unit_lm(dev, "int4", tied=False)
    assert set(params["lm_head"]) == {"w_p4", "gscale"}
    ids, mask = _unit_prompt(dev)
    max_new = 29
    with torch.inference_mode():
        want = _eager_generate(cfg, params, ids, mask, 4, greedy, max_new)
        got = tgen.generate(params, cfg, ids, mask, _generators(dev, 4), max_new, 64 + max_new,
                            greedy=greedy, **GUIDED)[0]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_generate_from_threads_equals_each_alone():
    """Three threads call `generate` at once (two share a decode unit, one
    has another prompt bucket): each gets the ids it gets alone."""
    import threading

    from sparktts_tpu_torch.lm import generate as tgen

    dev = _cuda()
    cfg, params = _unit_lm(dev, "bf16")
    jobs = [(*_unit_prompt(dev), 1), (*_unit_prompt(dev, n=30), 2),
            (*_unit_prompt(dev, 128, 90), 3)]

    def one(ids, mask, seed):
        with torch.inference_mode():
            gen = torch.Generator(device=dev).manual_seed(seed)
            return tgen.generate(params, cfg, ids, mask, gen, 40, ids.shape[1] + 40, **GUIDED)[0]

    alone = [one(*job) for job in jobs]
    got = [None] * len(jobs)
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, one(*jobs[i])))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(torch.equal(a, b) for a, b in zip(alone, got))


@pytest.mark.cuda
def test_failed_capture_raises_and_is_not_kept():
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import GenState

    dev = _cuda()
    state = GenState(*(torch.zeros(2, dtype=torch.long, device=dev) for _ in range(6)))

    def make_scan(_generator):
        def scan(s):
            int(s.cur_token[0])  # a host read: no capture takes it
            return s, s.cur_token[:, None], s.done[:, None].bool()
        return scan

    stream = torch.cuda.current_stream(dev)
    n = graphs.builds()
    with pytest.raises(RuntimeError):
        graphs.unit(("failing",), dev, lambda: graphs.DecodeUnit(make_scan, state, 1))
    assert graphs.builds() == n and ("failing",) not in graphs.SHARED
    assert torch.cuda.current_stream(dev) == stream
    assert float(torch.ones(1, device=dev).add_(1)) == 2.0


@pytest.mark.cuda
def test_capture_writes_nothing_queued_work_still_reads(monkeypatch):
    """A unit's capture writes its generators' seed and offset on its own
    stream, into blocks allocated on the caller's.  Here, just before the
    first registration, work on the caller's stream (as another thread's
    dispatch would) queues copies behind a long sleep and frees their
    sources, so the allocator hands those blocks out again: the copies
    must still read what their sources held."""
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import GenState

    dev = _cuda()
    state = GenState(*(torch.zeros(2, dtype=torch.long, device=dev) for _ in range(6)))
    copies = []

    class Racing(torch.cuda.CUDAGraph):
        def register_generator_state(self, generator):
            if not copies:
                src = [torch.full((2,), 5, dtype=torch.long, device=dev) for _ in range(16)]
                torch.cuda._sleep(100_000_000)  # ~50 ms of the caller's stream
                copies.extend(s.clone() for s in src)
                del src
            return super().register_generator_state(generator)

    def make_scan(_generator):
        return lambda s: (s, s.cur_token[:, None], s.done[:, None].bool())

    torch.cuda.synchronize()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Racing)
    graphs.DecodeUnit(make_scan, state, 1, n_generators=4)
    torch.cuda.synchronize()
    assert len(copies) == 16
    assert all(c.tolist() == [5, 5] for c in copies)


def _eager_dispatch(monkeypatch):
    """Both engines dispatch as their step functions in a Python loop."""
    from sparktts_tpu_torch.lm import continuous, graphs, paged

    def dispatch(kind, params, slots, n_steps, generator, make_step, static, units=None):
        new, toks, valid = continuous.scan_steps(n_steps, slots, make_step(generator))
        for mine, theirs in zip(graphs.tensors(slots), graphs.tensors(new)):
            if mine is not theirs:
                mine.copy_(theirs)
        return slots, continuous.pack_step_result(toks, valid, slots.done)

    monkeypatch.setattr(continuous, "dispatch_steps", dispatch)
    monkeypatch.setattr(paged, "dispatch_steps", dispatch)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("greedy", [True, False])
def test_engine_units_equal_the_eager_loop(monkeypatch, kind, greedy):
    """An engine's dispatches replay its captured unit of 4 steps over its
    own slot buffers: five requests (two admitted mid-decode) finish with
    the eager loop's ids, and each dispatch launches the engine's attention
    kernel layers x steps times."""
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
    from sparktts_tpu_torch.lm.paged import PagedContinuousEngine

    dev = _cuda()
    cfg, params = _unit_lm(dev, "bf16")
    kw = dict(max_slots=5, prompt_pad=64, eos_ids=(151645,), pad_id=151643, greedy=greedy,
              seed=7, device=dev, clone_slice=(151665, 151665 + 4096), clone_extras=(151645,),
              **GUIDED)
    prompts = [list(range(2000 + 7 * i, 2000 + 7 * i + n))
               for i, n in enumerate((40, 70, 9, 64, 100))]

    def serve():
        eng = (ContinuousBatchingEngine(params, cfg, cache_len=384, **kw) if kind == "dense" else
               PagedContinuousEngine(params, cfg, n_pages=24, page_size=64, pages_per_slot=6, **kw))
        reqs = [eng.submit(p, 120, mode=("control", "clone")[i % 2])
                for i, p in enumerate(prompts[:3])]
        eng.step(16)
        reqs += [eng.submit(p, 100) for p in prompts[3:]]
        eng.run_until_done(32)
        return [eng.finished[r] for r in reqs]

    graphs.reset_launches()
    got = serve()
    counts = graphs.launches()
    attn = "dense_decode_attention" if kind == "dense" else "paged_decode_attention"
    assert counts[attn] > 0 and counts[attn] % (UNIT_LAYERS * 4) == 0
    _eager_dispatch(monkeypatch)
    want = serve()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------- the continuous server's shapes


@pytest.mark.cuda
@pytest.mark.parametrize("poss", [
    # eight live slots of the dense server's cache (960): creation prompts of
    # 44 tokens, clones of 419 and 153, mid-burst and near their budgets
    [300, 250, 700, 610, 250, 900, 510, 800],
    [543, 543, 918, 918, 653, 959, 44, 419],
])
def test_decode_kernel_at_the_dense_servers_state(poss):
    """Kernel 2 as the dense server's dispatches call it: B = 8 slots of a
    960-key cache, every window from 0; within the bf16 tolerance of plain
    and of its split model, two calls bit-equal."""
    dev = _cuda()
    q, ck, cv, start, pos = _decode_case(dev, 8, 960, [0] * 8, poss, seed=11)
    got = da.dense_decode_attention(q, ck, cv, 1, start, pos, sm_scale=0.125)
    assert torch.equal(got, da.dense_decode_attention(q, ck, cv, 1, start, pos, sm_scale=0.125))
    want = da.dense_decode_plain(q, ck, cv, 1, start, pos, sm_scale=0.125)
    split = da.dense_decode_split_plain(q, ck, cv, 1, start, pos, sm_scale=0.125,
                                        chunk=da.kernel_chunk())
    got = got.float().cpu().numpy()
    np.testing.assert_allclose(got, want.float().cpu().numpy(), **BF16_TOL)
    np.testing.assert_allclose(got, split.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
def test_paged_kernel_at_the_paged_servers_state():
    """Kernel 6 as the paged server calls it: 256-token pages, 4 a slot, 8
    slots mid-burst and one finished (one past its table); within the bf16
    tolerance of plain and of its split model, two calls bit-equal."""
    dev = _cuda()
    q, kp, vp, table, lens = _paged_case(dev, 256, [300, 520, 700, 780, 260, 1025, 600, 900],
                                         layers=4, seed=12)
    got = pa.paged_decode_attention(q, kp, vp, table, lens, 2, sm_scale=0.125)
    assert torch.equal(got, pa.paged_decode_attention(q, kp, vp, table, lens, 2, sm_scale=0.125))
    want = pa.paged_decode_plain(q, kp, vp, table, lens, 2, sm_scale=0.125)
    split = pa.paged_decode_split_plain(q, kp, vp, table, lens, 2, sm_scale=0.125,
                                        chunk=pa.kernel_chunk())
    got = got.float().cpu().numpy()
    np.testing.assert_allclose(got, want.float().cpu().numpy(), **BF16_TOL)
    np.testing.assert_allclose(got, split.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
# a batched window of 100 tokens (two vocode buckets): each decoder block's
# unit at B = 2, 4 and 8 rows
@pytest.mark.parametrize("b", (2, 4, 8))
@pytest.mark.parametrize("c,t", [(768, 800), (96, 32000)])
def test_vocoder_kernel_at_the_servers_batched_windows(b, c, t):
    """Kernel 3 as the server's batched vocode calls it: within 1e-4
    max|plain| of the plain unit and `_vocoder_model_tol(c)` of its model,
    two calls bit-equal, and each row equal to the kernel on that row alone
    within the same tolerance."""
    dev = _cuda()
    p = _residual_unit(c, dev, seed=b)
    x = torch.randn((b, t, c), generator=torch.Generator().manual_seed(b + c)).to(dev)
    got = vf.fused_residual_unit(p, x, 3)
    assert torch.equal(got, vf.fused_residual_unit(p, x, 3))
    with full_fp32():
        want = vf.fused_residual_unit_plain(p, x, 3)
        model = vf.residual_unit_3xtf32_plain(p, x, 3)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float((got - model).abs().max()) / float(model.abs().max()) <= _vocoder_model_tol(c)
    row = vf.fused_residual_unit(p, x[1:2].contiguous(), 3)
    assert float((got[1:2] - row).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [True, False])
def test_speculative_unit_replays_equal_its_eager_rounds(greedy):
    """`speculative_generate(_greedy)` on the card replays its captured unit
    of ROUNDS_PER_UNIT rounds over the two-layer LM with a one-layer draft:
    its ids equal the same rounds run eagerly (`speculative_round` in a
    Python loop until the budget is spent) with the same seed, twice; one
    flash prefill a layer of target and draft a call, kernel 2 in every
    draft step of every replayed round."""
    from sparktts_tpu_torch.lm import generate as tgen
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm import speculative as sp
    from sparktts_tpu_torch.lm.qwen import aligned_cache_len, init_kv_cache

    dev = _cuda()
    cfg, params = _unit_lm(dev, "bf16")
    draft, dcfg = sp.draft_from_layers(params, 1), sp.draft_config(cfg, 1)
    ids, mask = _unit_prompt(dev)
    max_new, k, t_pad = 37, 4, ids.shape[1]
    cache_len = t_pad + max_new + k
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(5)
        s_len = aligned_cache_len(cache_len)
        tc = init_kv_cache(cfg, 1, s_len, torch.bfloat16, dev)
        dc = init_kv_cache(dcfg, 1, s_len, torch.bfloat16, dev)
        first = tgen.prefill(params, cfg, ids, mask, tc, gen, 0.8, 50, 0.95, greedy, **GUIDED)
        tgen.prefill(draft, dcfg, ids, mask, dc, gen, 0.8, 50, 0.95, True, **GUIDED)
        zero = torch.zeros((), dtype=torch.long, device=dev)
        state = sp.SpecState(tc, dc, first.cur_token, zero, torch.zeros(1, dtype=torch.bool,
                                                                        device=dev),
                             first.start, first.prompt_len, zero.clone(), zero.clone(),
                             torch.zeros((1, max_new + k + 1), dtype=torch.long, device=dev),
                             torch.zeros((1, max_new + k + 1), dtype=torch.bool, device=dev),
                             torch.zeros((1, max_new + k + 1), dtype=torch.bool, device=dev))
        temperature, top_p = (torch.full((), v, device=dev) for v in (0.8, 0.95))
        while int(state.step) < max_new and not bool(state.done.all()):
            state = sp.speculative_round(params, draft, cfg, dcfg, state, t_pad, k, max_new, gen,
                                         temperature, 50, top_p, greedy, (), 0, **GUIDED)
        want = state.tokens[:, :max_new]
        graphs.reset_launches()
        runs = []
        for _ in range(2):
            if greedy:
                got = sp.speculative_generate_greedy(params, draft, cfg, dcfg, ids, mask, max_new,
                                                     cache_len, k=k, **GUIDED)
            else:
                got = sp.speculative_generate(params, draft, cfg, dcfg, ids, mask,
                                              torch.Generator(device=dev).manual_seed(5), max_new,
                                              cache_len, k=k, **GUIDED)
            runs.append(got[0])
        counts = graphs.launches()
    assert torch.equal(runs[0], want) and torch.equal(runs[1], want)
    assert counts["flash_attention_prefill"] == 2 * (UNIT_LAYERS + 1)
    per_replay = sp.ROUNDS_PER_UNIT * k  # one draft layer
    assert counts["dense_decode_attention"] > 0
    assert counts["dense_decode_attention"] % per_replay == 0


def _op_case(name, dev):
    """(wrapper module, op args, plain version) of one custom op at a shape
    of the main path."""
    from sparktts_tpu_torch.kernels import int4_matmul, int8_mlp

    if name == "dense_decode_attention":
        q, ck, cv, start, pos = _decode_case(dev, 2, 704, [0, 5], [300, 640])
        args = (q, ck, cv, 1, start, pos, 0.125)
        return da, args, lambda: da.dense_decode_plain(*args)
    if name == "fused_residual_unit":
        p = _residual_unit(768, dev)
        x = torch.randn((1, 333, 768), generator=torch.Generator().manual_seed(1)).to(dev)
        args = (x, p["snake1"]["alpha"], p["conv1"]["w"], p["conv1"]["b"], p["snake2"]["alpha"],
                p["conv2"]["w"], p["conv2"]["b"], 3)
        return vf, args, lambda: vf.fused_residual_unit_plain(p, x, 3)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
    if name == "int8_mlp_matvec":
        w = _int8_mlp_weights(dev)
        return int8_mlp, (x, *w), lambda: int8_mlp.int8_mlp_matvec_plain(x, *w)
    packed = torch.randint(-128, 128, (HIDDEN // 2, 1152), generator=g, device=dev,
                           dtype=torch.int8)
    gscale = 0.01 * (1 + torch.rand((HIDDEN // 128, 1152), generator=g, device=dev))
    return int4_matmul, (x, packed, gscale), lambda: int4_matmul.int4_matvec_plain(x, packed,
                                                                                  gscale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense_decode_attention", "fused_residual_unit",
                                  "int8_mlp_matvec", "int4_matvec"])
def test_custom_op_launches_its_kernel_and_matches_plain(name):
    """`torch.ops.sparktts_torch.<name>` on card tensors goes through the
    wrapper (its launch count moves by one) and agrees with the plain
    version at the kernel's own tolerance; on the same inputs moved to the
    CPU the op runs the plain version."""
    from sparktts_tpu_torch.kernels import ops  # noqa: F401  (registers the ops)

    dev = _cuda()
    module, args, plain = _op_case(name, dev)
    op = getattr(torch.ops.sparktts_torch, name)
    before = module.launches
    got = op(*args)
    assert module.launches == before + 1
    with full_fp32():
        want = plain()
    tol = 1e-4 if name == "fused_residual_unit" else 2e-2
    assert _rel_err(got, want) <= tol
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    assert module.launches == before + 1
    assert _rel_err(op(*cpu_args), want.cpu()) <= tol


@pytest.mark.cuda
def test_program_exported_on_the_card_launches_its_kernel(tmp_path):
    """A program exported from card inputs holds the op node and no plain
    version; the reloaded program launches the kernel."""
    from sparktts_tpu_torch import export

    dev = _cuda()
    q, ck, cv, start, pos = _decode_case(dev, 1, 704, [0], [300])

    def fn(q, ck, cv, start, pos):
        return da.dense_decode_attention(q, ck, cv, 1, start, pos, sm_scale=0.125) * 2

    before = da.launches
    assert export.export_program(fn, (q, ck, cv, start, pos), tmp_path / "d.pt2",
                                 kernels=("dense_decode_attention",)) == {
        "dense_decode_attention": 1}
    assert da.launches == before
    program = export.load_program(tmp_path / "d.pt2")
    got = program(q, ck, cv, start, pos)
    assert da.launches == before + 1
    assert _rel_err(got, 2 * da.dense_decode_plain(q, ck, cv, 1, start, pos, 0.125)) <= 2e-2
