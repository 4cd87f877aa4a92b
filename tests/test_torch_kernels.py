"""The port's kernel modules against the JAX package's Pallas kernels
(interpret mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests hold that arithmetic against the Pallas kernels in fp32.  Tolerance
1e-5 for attention, the same fp32 math summed in another order; 2e-5 for
the vocoder's ResidualUnit, the JAX package's own tolerance for its fused
unit against the unfused one (two convs of 7C + C terms).  The CUDA kernels
themselves are held against the plain versions on the card by
`test_torch_cuda_kernels.py` (marked `cuda`, skipped without a card) and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.kernels.decode_attention import dense_decode_attention as jax_decode
from sparktts_tpu.kernels.flash_attention import flash_attention_prefill as jax_flash
from sparktts_tpu.kernels.flash_attention import reference_attention
from sparktts_tpu.kernels.vocoder_fusion import fused_residual_unit as jax_residual_unit
from sparktts_tpu_torch.kernels import decode_attention as da
from sparktts_tpu_torch.kernels import flash_attention as fa
from sparktts_tpu_torch.kernels import vocoder_fusion as vf
from sparktts_tpu_torch.weights import to_torch

FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _flash_inputs(b, hq, hkv, t, d, starts, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, t, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    return q, k, v, np.asarray(starts, np.int32)


def _valid_rows(out, starts):
    t = out.shape[2]
    valid = np.arange(t)[None, :] >= np.asarray(starts)[:, None]  # (b, t)
    return np.broadcast_to(valid[:, None, :, None], out.shape)


@pytest.mark.parametrize(
    "b,hq,hkv,t,d,block,starts",
    [
        (1, 14, 2, 64, 64, 64, [17]),          # 0.5B heads, one prompt bucket
        (1, 14, 2, 128, 64, 64, [70]),         # two query tiles, start past a tile
        (2, 4, 2, 128, 16, 32, [0, 45]),       # tiny-config head dim
        (3, 8, 2, 64, 32, 16, [5, 0, 63]),     # GQA group 4, last row the only valid one
    ],
)
def test_flash_plain_matches_pallas(b, hq, hkv, t, d, block, starts):
    q, k, v, start = _flash_inputs(b, hq, hkv, t, d, starts)
    scale = d**-0.5
    want = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
                  sm_scale=scale, block_q=block, block_k=block, interpret=True)
    )
    before = fa.launches
    got = fa.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(start),
        sm_scale=scale,
    ).numpy()
    assert fa.launches == before  # CPU tensors take the plain version
    mask = _valid_rows(got, start)
    np.testing.assert_allclose(got[mask], want[mask], **FP32_TOL)
    # left-pad rows are unspecified in JAX; the port returns zeros there
    assert np.all(got[~mask] == 0)


def test_flash_plain_ragged_length_matches_reference():
    """A prompt length no tile divides, with distinct starts per row: the
    port takes any T (the Pallas kernel needs T % block == 0, so the JAX
    side here is its XLA reference)."""
    b, hq, hkv, t, d = 4, 14, 2, 77, 64
    q, k, v, start = _flash_inputs(b, hq, hkv, t, d, [0, 3, 40, 76], seed=1)
    want = np.asarray(
        reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
                            sm_scale=d**-0.5)
    )
    got = fa.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(start),
        sm_scale=d**-0.5,
    ).numpy()
    mask = _valid_rows(got, start)
    np.testing.assert_allclose(got[mask], want[mask], **FP32_TOL)


def _decode_inputs(b, s_len, hq=14, hkv=2, d=64, n_layers=3, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    ck = rng.standard_normal((n_layers, b, s_len, hkv, d), dtype=np.float32)
    cv = rng.standard_normal((n_layers, b, s_len, hkv, d), dtype=np.float32)
    return q, ck, cv


@pytest.mark.parametrize(
    "b,s_len,block_s,starts,poss",
    [
        (1, 256, 64, [0], [0]),                      # single valid key
        (1, 256, 64, [3], [200]),                    # window straddling blocks
        (2, 512, 128, [0, 37], [511, 64]),           # full window + short window
        (3, 128, 128, [5, 0, 90], [100, 127, 90]),   # single-block grid
        (2, 128, 64, [40, 0], [39, 10]),             # row 0: empty window
    ],
)
def test_decode_plain_matches_pallas(b, s_len, block_s, starts, poss):
    q, ck, cv = _decode_inputs(b, s_len)
    start, pos = np.asarray(starts, np.int32), np.asarray(poss, np.int32)
    before = da.launches
    for layer in (0, ck.shape[0] - 1):
        want = np.asarray(
            jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), layer,
                       jnp.asarray(start), jnp.asarray(pos), sm_scale=0.125,
                       block_s=block_s, interpret=True)
        )
        got = da.dense_decode_attention(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), layer,
            torch.from_numpy(start), torch.from_numpy(pos), sm_scale=0.125,
        ).numpy()
        # an empty window gives zeros in the port; the Pallas kernel gives
        # zeros only when its S-block is skipped (here it averages V)
        live = pos >= start
        np.testing.assert_allclose(got[live], want[live], **FP32_TOL)
        assert np.all(got[~live] == 0)
    assert da.launches == before


def _residual_unit(c, seed):
    """Unit params with the non-trivial alphas and biases of
    tests/test_vocoder_kernel.py, as numpy."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (0.02 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {
        "snake1": {"alpha": (0.5 + rng.uniform(size=c)).astype(np.float32)},
        "conv1": {"w": w(7, c, c), "b": (0.1 * rng.standard_normal(c)).astype(np.float32)},
        "snake2": {"alpha": (0.5 + rng.uniform(size=c)).astype(np.float32)},
        "conv2": {"w": w(1, c, c), "b": (0.1 * rng.standard_normal(c)).astype(np.float32)},
    }


def _vocoder_case(p, x, dilation, block_t, variant):
    """(port's unit on CPU tensors, JAX's Pallas unit in interpret mode)."""
    want = np.asarray(jax_residual_unit(jax.tree.map(jnp.asarray, p), jnp.asarray(x), dilation,
                                        block_t=block_t, interpret=True, variant=variant))
    before = vf.launches
    got = vf.fused_residual_unit(to_torch(p, "cpu"), torch.from_numpy(x), dilation).numpy()
    assert vf.launches == before  # CPU tensors take the plain version
    return got, want


@pytest.mark.parametrize("variant", ("tiles", "carry"))
@pytest.mark.parametrize("dilation", (1, 3, 9))
def test_vocoder_unit_plain_matches_pallas(dilation, variant):
    """block_t 32 over T 96: interior tiles and both sequence edges (the
    halo of 27 rows at dilation 9 spans most of a tile)."""
    p = _residual_unit(16, seed=dilation)
    x = np.random.default_rng(9).standard_normal((2, 96, 16)).astype(np.float32)
    got, want = _vocoder_case(p, x, dilation, 32, variant)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("variant", ("tiles", "carry"))
@pytest.mark.parametrize("t,block_t", [(50, 32), (20, 64)])
def test_vocoder_unit_plain_ragged_and_single_tile(t, block_t, variant):
    """A T no tile divides, and a T smaller than one tile (both edges in it)."""
    p = _residual_unit(8, seed=7)
    x = np.random.default_rng(t).standard_normal((1, t, 8)).astype(np.float32)
    got, want = _vocoder_case(p, x, 3, block_t, variant)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
