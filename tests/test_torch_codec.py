"""The port's BiCodec decode side against the JAX package.

Tiny config, fp32, the same JAX-initialised weights on both sides.  The conv
layers get their own cases because the JAX package stores conv kernels WIO
and transposed-conv kernels flipped, which the port's `F.conv*` calls must
undo.  Tolerance 1e-5 per layer; on the waveform 1e-4 of its peak (random
weights give a quiet waveform): fp32 convs summed in another order, through
~40 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.codec.bicodec import bicodec_detokenize as jax_detokenize
from sparktts_tpu.codec.bicodec import init_bicodec as jax_init_bicodec
from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.nn import layers as jl
from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.nn import layers as tl
from sparktts_tpu_torch.weights import bicodec_state

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
WAV_REL_TOL = 1e-4


def _kernel(rng, k, cin_g, cout):
    return {
        "w": rng.standard_normal((k, cin_g, cout), dtype=np.float32) * 0.2,
        "b": rng.standard_normal(cout, dtype=np.float32),
    }


@pytest.mark.parametrize(
    "cin,cout,k,stride,padding,dilation,groups",
    [
        (6, 5, 7, 1, 3, 1, 1),     # dense k7, "same" padding
        (6, 6, 7, 1, 9, 3, 1),     # dilated residual-unit conv
        (8, 8, 7, 1, 3, 1, 8),     # depthwise (ConvNeXt dwconv)
        (6, 4, 1, 1, 0, 1, 1),     # 1x1
        (6, 4, 4, 2, 1, 1, 1),     # strided
    ],
)
def test_conv1d_matches_jax(cin, cout, k, stride, padding, dilation, groups):
    rng = np.random.default_rng(0)
    p = _kernel(rng, k, cin // groups, cout)
    x = rng.standard_normal((2, 19, cin), dtype=np.float32)
    want = jl.conv1d_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride,
                           padding=padding, dilation=dilation, groups=groups)
    got = tl.conv1d_apply({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                          stride=stride, padding=padding, dilation=dilation, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize(
    "cin,cout,k,stride,padding,output_padding,groups",
    [
        (6, 4, 16, 8, 4, 0, 1),    # vocoder upsample (rate 8)
        (6, 4, 11, 5, 3, 0, 1),    # odd kernel (rate 5)
        (8, 8, 4, 2, 1, 0, 8),     # depthwise sampler, ratio 2
        (8, 8, 6, 3, 2, 1, 8),     # depthwise sampler, odd ratio: output_padding
    ],
)
def test_conv_transpose1d_matches_jax(cin, cout, k, stride, padding, output_padding, groups):
    rng = np.random.default_rng(1)
    p = _kernel(rng, k, cin // groups, cout)
    x = rng.standard_normal((2, 9, cin), dtype=np.float32)
    want = jl.conv_transpose1d_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride,
                                     padding, output_padding, groups)
    got = tl.conv_transpose1d_apply({n: torch.from_numpy(a) for n, a in p.items()},
                                    torch.from_numpy(x), stride, padding, output_padding, groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_bicodec_detokenize_matches_jax():
    cfg = tiny_test_config().bicodec
    jp = jax_init_bicodec(jax.random.PRNGKey(0), cfg)
    tp = bicodec_state(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    semantic = rng.integers(0, cfg.quantizer.codebook_size, size=(2, 13))
    n_global = int(np.prod(cfg.speaker_encoder.fsq_levels))
    glob = rng.integers(0, n_global, size=(2, cfg.speaker_encoder.token_num))
    want = np.asarray(jax_detokenize(jp, cfg, jnp.asarray(semantic, jnp.int32), jnp.asarray(glob, jnp.int32)))
    got = bicodec_detokenize(tp, torch_tiny_config().bicodec, torch.from_numpy(semantic), torch.from_numpy(glob))
    assert got.shape == want.shape == (2, 13 * 8 * 4)
    peak = np.abs(want).max()
    assert peak > 1e-5  # not a silent waveform
    np.testing.assert_allclose(got.numpy(), want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)
