"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel has
no CPU mode.  This file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

bf16 tolerance 2e-2: both sides read the same bf16 inputs and accumulate in
fp32, so they differ by the bf16 rounding of the output (2^-8 relative) on
values of magnitude O(1), plus fp32 summation order.
"""

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.kernels import decode_attention as da
from sparktts_tpu_torch.kernels import flash_attention as fa

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
HQ, HKV, D = 14, 2, 64  # Qwen2.5-0.5B attention heads


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,starts", [(1, 64, [9]), (1, 128, [70]), (4, 77, [0, 3, 40, 76])])
def test_flash_kernel_matches_plain(b, t, starts):
    """Inputs laid out (B, T, H, D) and passed transposed, as the LM does."""
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
    "b,starts,poss",
    [(1, [0], [300]), (8, [0, 5, 9, 60, 0, 1, 63, 40], [600, 100, 9, 70, 1, 640, 62, 639])],
)
def test_decode_kernel_matches_plain(b, starts, poss):
    """Windows of many lengths, one of them empty (pos < start: zeros)."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, HQ, D), dev)
    ck, cv = (_randn(rng, (2, b, 704, HKV, D), dev) for _ in range(2))
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    pos = torch.tensor(poss, dtype=torch.int32, device=dev)
    before = da.launches
    got = da.dense_decode_attention(q, ck, cv, 1, start, pos, sm_scale=0.125)
    assert da.launches == before + 1
    want = da.dense_decode_plain(q, ck, cv, 1, start, pos, sm_scale=0.125)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **BF16_TOL)


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
