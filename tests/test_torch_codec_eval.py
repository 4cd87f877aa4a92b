"""The port's codec eval forwards and statistics pools against the JAX
package, on the tiny config with the same numpy weights (norms randomised
as in `tests/test_torch_encode.py`).

`fvq_forward` (indices equal; latents, perplexity and active codes within
1e-5), `speaker_encoder_forward` (x- and d-vectors), the torch model's
`get_codes_from_indices` / `get_indices`, `bicodec_forward` (every output),
the five pools TAP / TSDP / TSTP / MHASTP / MQMHASTP, and the converters of
the two attentive pools from torch-named 1x1 conv weights: all within 1e-5
(relative and absolute) of JAX's, integer outputs equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu import checkpoint as jckpt
from sparktts_tpu.codec import bicodec as jbicodec
from sparktts_tpu.codec import fvq as jfvq
from sparktts_tpu.codec import speaker_encoder as jspk
from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.nn import pooling as jpool
from sparktts_tpu_torch import checkpoint as tckpt
from sparktts_tpu_torch.codec.bicodec import bicodec_forward
from sparktts_tpu_torch.codec.fvq import fvq_forward
from sparktts_tpu_torch.codec.speaker_encoder import (
    speaker_encoder_forward,
    speaker_encoder_get_codes_from_indices,
    speaker_encoder_get_indices,
)
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.nn import pooling as tpool
from sparktts_tpu_torch.weights import bicodec_state, init_bicodec
from tests.test_torch_encode import _trees

TOL = dict(rtol=1e-5, atol=1e-5)
JCFG, TCFG = tiny_test_config(), torch_tiny_config()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file: under pytest-xdist
    each worker's own pool would oversubscribe the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bicodec():
    """The port's random init (JAX's eager init runs ~140 programs) with
    randomised norms, as a JAX tree and a port tree."""
    init = init_bicodec(TCFG.bicodec, torch.Generator().manual_seed(3), device="cpu")
    jp, np_tree = _trees(init, seed=3)
    return jp, bicodec_state(np_tree, "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_fvq_forward_matches_jax(bicodec):
    jp, tp = bicodec
    z = np.random.default_rng(1).standard_normal((2, 30, 48)).astype(np.float32)
    want = jfvq.fvq_forward(jp["quantizer"], jnp.asarray(z))
    got = fvq_forward(tp["quantizer"], _t(z))
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    for key in ("z_q", "perplexity", "active_num"):
        _close(got[key], want[key])
    assert float(got["active_num"]) == len(np.unique(np.asarray(want["indices"])))


def test_speaker_encoder_forward_and_codes_match_jax(bicodec):
    jp, tp = bicodec
    jcfg, tcfg = JCFG.bicodec.speaker_encoder, TCFG.bicodec.speaker_encoder
    mels = np.abs(np.random.default_rng(2).standard_normal((2, 31, 32))).astype(np.float32)
    jx, jd = jax.jit(jspk.speaker_encoder_forward, static_argnums=2)(
        jp["speaker_encoder"], jnp.asarray(mels), jcfg)
    tx, td = speaker_encoder_forward(tp["speaker_encoder"], _t(mels), tcfg)
    _close(tx, jx)
    _close(td, jd)
    want = np.asarray(jax.jit(jspk.speaker_encoder_get_indices, static_argnums=2)(
        jp["speaker_encoder"], jnp.asarray(mels), jcfg))
    got = speaker_encoder_get_indices(tp["speaker_encoder"], _t(mels), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    _close(speaker_encoder_get_codes_from_indices(tp["speaker_encoder"], got, tcfg),
           jspk.speaker_encoder_get_codes_from_indices(jp["speaker_encoder"], jnp.asarray(want),
                                                       jcfg))


def test_bicodec_forward_matches_jax(bicodec):
    jp, tp = bicodec
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((1, 24, 64)).astype(np.float32)
    ref = (0.3 * rng.standard_normal((1, 16000))).astype(np.float32)
    want = jax.jit(jbicodec.bicodec_forward, static_argnums=1)(jp, JCFG.bicodec,
                                                               jnp.asarray(feat), jnp.asarray(ref))
    got = bicodec_forward(tp, TCFG.bicodec, _t(feat), _t(ref))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["semantic_indices"].numpy(),
                                  np.asarray(want["semantic_indices"]))
    for key in ("recons", "pred_feat", "x_vector", "d_vector", "perplexity", "cluster_size"):
        assert got[key].shape == tuple(want[key].shape), key
        _close(got[key], want[key])


@pytest.mark.parametrize("name", ["tap", "tsdp", "tstp"])
def test_parameter_free_pools_match_jax(name):
    x = np.random.default_rng(4).standard_normal((2, 17, 12)).astype(np.float32)
    _close(getattr(tpool, f"{name}_apply")(_t(x)),
           getattr(jpool, f"{name}_apply")(jnp.asarray(x)))


def _conv1x1_state(rng, shapes):
    """Torch-named 1x1 Conv1d weights (out, in, 1) and biases."""
    state = {}
    for prefix, (d_in, d_out) in shapes.items():
        state[f"{prefix}.weight"] = (0.3 * rng.standard_normal((d_out, d_in, 1))).astype(np.float32)
        state[f"{prefix}.bias"] = (0.1 * rng.standard_normal(d_out)).astype(np.float32)
    return state


def _mhastp_shapes(pre, in_dim, layer_num, head_num, d_s, bottleneck):
    d_model = in_dim // head_num
    d_s = d_model if d_s > 1 else 1
    dims = [bottleneck] * (layer_num + 1)
    dims[0], dims[-1] = d_model, d_s
    return {f"{pre}.heads_att_trans.{h}.att_{i}": (dims[i], dims[i + 1])
            for h in range(head_num) for i in range(layer_num)}


@pytest.mark.parametrize("kind", ["mhastp", "mqmhastp"])
def test_attentive_pools_and_converters_match_jax(kind):
    """Converted torch-named weights give JAX's tree, and both pools then
    give JAX's statistics; the port's own init has JAX's tree shape."""
    rng = np.random.default_rng(5)
    in_dim, layers, heads, bottleneck = 16, 2, 4, 8
    if kind == "mhastp":
        shapes = _mhastp_shapes("pool", in_dim, layers, heads, 1, bottleneck)
        args = dict(layer_num=layers, head_num=heads)
        jinit = jpool.init_mhastp(jax.random.PRNGKey(0), in_dim, layers, heads, 1, bottleneck)
        tinit = tpool.init_mhastp(in_dim, layers, heads, 1, bottleneck, device="cpu")
    else:
        shapes = {}
        for q in range(2):
            shapes.update(_mhastp_shapes(f"pool.n_query.{q}", in_dim, layers, heads, 2,
                                         bottleneck))
        args = dict(layer_num=layers, query_num=2, head_num=heads)
        jinit = jpool.init_mqmhastp(jax.random.PRNGKey(0), in_dim, layers, 2, heads, 2,
                                    bottleneck)
        tinit = tpool.init_mqmhastp(in_dim, layers, 2, heads, 2, bottleneck, device="cpu")
    state = _conv1x1_state(rng, shapes)
    jtree = getattr(jckpt, f"_t_{kind}")(state, "pool", **args)
    ttree = getattr(tckpt, f"_t_{kind}")({k: _t(v) for k, v in state.items()}, "pool", **args)
    want_flat = tckpt.flatten_tree(jax.tree.map(np.asarray, jtree))[0]
    got_flat = tckpt.flatten_tree(ttree)[0]
    assert set(got_flat) == set(want_flat)
    for k, v in got_flat.items():
        np.testing.assert_array_equal(v.numpy(), want_flat[k], err_msg=k)
    init_shapes = {k: tuple(v.shape) for k, v in tckpt.flatten_tree(tinit)[0].items()}
    assert init_shapes == {k: tuple(v.shape) for k, v in
                           tckpt.flatten_tree(jax.tree.map(np.asarray, jinit))[0].items()}
    x = np.random.default_rng(6).standard_normal((2, 13, in_dim)).astype(np.float32)
    want = getattr(jpool, f"{kind}_apply")(jax.tree.map(jnp.asarray, jtree), jnp.asarray(x))
    got = getattr(tpool, f"{kind}_apply")(ttree, _t(x))
    assert got.shape == tuple(want.shape)
    _close(got, want)
    assert tpool.POOLING_OUT_DIM[kind.upper()](in_dim) == want.shape[-1]
