"""The port's LM training step (`sparktts_tpu_torch/lm/train.py`) against
the JAX package's `lm/train.py`, at `tests/test_train.py`'s config.

Same numpy params and ids on both sides.  `lm_loss` within 1e-5 relative
(full and partial masks); every gradient leaf within 1e-4 of its largest
element (the two sum in different orders); params after 3 AdamW steps
within 1e-6 absolute (5.5e-6 apart found where the bound below applies,
below 2e-7 elsewhere), except the K projection's bias: a shift shared by all
keys leaves the softmax unchanged, so its gradient is rounding noise, and
Adam, which divides by sqrt(v) + eps, moves such an element by about +-lr a
step whatever its size: there the bound is 2 lr a step.  Plus the overfit
test, the loss mask, autograd through the port's LM, and save/restore
resuming bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import QwenConfig as JaxQwenConfig
from sparktts_tpu.lm import train as jtrain
from sparktts_tpu.lm.qwen import init_qwen as jax_init_qwen
from sparktts_tpu_torch.checkpoint import flatten_tree
from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import train as ttrain

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=2, head_dim=16)
JCFG, CFG = JaxQwenConfig(**CFG_KW), QwenConfig(**CFG_KW)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest gradient element
LR = 1e-3
PARAM_ATOL = 1e-6  # after 3 steps; the K bias: 2 LR a step (module docstring)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file: under pytest-xdist
    each worker's own pool would oversubscribe the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def params():
    return _numpy(jax_init_qwen(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32))


def _ids(seed, shape, lo=2, hi=120):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int32)


def _state(params, lr=LR):
    return ttrain.init_train_state(params, ttrain.make_optimizer(lr), device="cpu")


@pytest.mark.parametrize("mask", ["full", "partial"])
def test_loss_equals_jax(params, mask):
    ids = _ids(1, (2, 12))
    m = np.ones((2, 12), bool)
    if mask == "partial":
        m[:] = False
        m[0, 5:7] = True
        m[1, 3:11] = True
    want = float(jtrain.lm_loss(jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(ids),
                                jnp.asarray(m)))
    got = ttrain.lm_loss(_state(params).params, CFG, ids, m).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_gradients_equal_jax(params):
    """Autograd through the port's LM (the serving forward's in-place cache
    is not on this path) gives JAX's gradients."""
    ids, m = _ids(2, (2, 16)), np.ones((2, 16), bool)
    m[:, :4] = False
    grads = jax.grad(jtrain.lm_loss)(jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(ids),
                                     jnp.asarray(m))
    want = flatten_tree(_numpy(grads))[0]
    state = _state(params)
    ttrain.lm_loss(state.params, CFG, ids, m).backward()
    got = flatten_tree(state.params)[0]
    assert set(got) == set(want)
    for name, leaf in got.items():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(leaf.grad.numpy(), want[name], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_adamw_steps_equal_jax(params):
    optimizer = jtrain.make_optimizer(LR)
    step = jax.jit(functools.partial(jtrain.train_step, cfg=JCFG, optimizer=optimizer))
    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray, params), optimizer)
    state = _state(params)
    m = np.ones((2, 12), bool)
    for i in range(3):
        ids = _ids(10 + i, (2, 12))
        jstate, jloss = step(jstate, input_ids=jnp.asarray(ids), loss_mask=jnp.asarray(m))
        state, loss = ttrain.train_step(state, CFG, ids, m)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == 3
    want = flatten_tree(_numpy(jstate.params))[0]
    k_bias = slice(CFG.num_attention_heads * CFG.head_dim,
                   (CFG.num_attention_heads + CFG.num_key_value_heads) * CFG.head_dim)
    for name, leaf in flatten_tree(state.params)[0].items():
        got, tol = leaf.detach().numpy(), np.full(want[name].shape, PARAM_ATOL)
        if name == "layers/qkv/b":
            tol[:, k_bias] = 2 * LR * 3
        assert (np.abs(got - want[name]) <= tol).all(), (name, np.abs(got - want[name]).max())


def test_loss_decreases_when_overfitting(params):
    state = _state(params, lr=1e-2)
    ids, m = _ids(0, (2, 16)), np.ones((2, 16), bool)
    first = ttrain.lm_loss(state.params, CFG, ids, m).item()
    for _ in range(20):
        state, loss = ttrain.train_step(state, CFG, ids, m)
    assert np.isfinite(float(loss)) and float(loss) < first * 0.7, (first, float(loss))


def test_loss_mask_excludes_positions(params):
    state = _state(params)
    ids = _ids(1, (1, 12))
    full = ttrain.lm_loss(state.params, CFG, ids, np.ones((1, 12), bool)).item()
    part_mask = np.zeros((1, 12), bool)
    part_mask[0, 5:7] = True
    part = ttrain.lm_loss(state.params, CFG, ids, part_mask).item()
    assert np.isfinite(full) and np.isfinite(part) and abs(full - part) > 1e-6


def test_train_state_save_restore_resumes_bit_equal(params, tmp_path):
    """Saved at step 3, restored by name, resumed: bit-equal to the
    uninterrupted run on the CPU (params, moments, loss, step)."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(1, CFG.vocab_size, size=(2, 12)) for _ in range(6)]
    m = np.ones((2, 12), bool)
    ref = _state(params)
    for b in batches:
        ref, ref_loss = ttrain.train_step(ref, CFG, b, m)
    st = _state(params)
    for b in batches[:3]:
        st, _ = ttrain.train_step(st, CFG, b, m)
    ttrain.save_train_state(tmp_path / "ckpt", st)
    restored = ttrain.load_train_state(tmp_path / "ckpt", ttrain.make_optimizer(LR), device="cpu")
    assert restored is not None and restored.step == 3
    for b in batches[3:]:
        restored, res_loss = ttrain.train_step(restored, CFG, b, m)
    assert restored.step == ref.step == 6
    assert float(res_loss) == float(ref_loss)
    got, want = flatten_tree(restored.params)[0], flatten_tree(ref.params)[0]
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(restored.optimizer.state[got[name]][key],
                                       ref.optimizer.state[want[name]][key], rtol=0, atol=0)
    assert ttrain.load_train_state(tmp_path / "missing", ttrain.make_optimizer(LR),
                                   device="cpu") is None


def test_train_state_copies_the_tree_and_refuses_inference_mode(params):
    tree = jax.tree.map(torch.from_numpy, params)
    state = _state(tree)
    before = tree["embed"].clone()
    ttrain.train_step(state, CFG, _ids(3, (1, 8)), np.ones((1, 8), bool))
    torch.testing.assert_close(tree["embed"], before, rtol=0, atol=0)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        _state(params)


def test_untied_head_trains(params):
    cfg = dataclasses.replace(CFG, tie_word_embeddings=False)
    tree = dict(params, lm_head={"w": np.random.default_rng(0).standard_normal(
        (CFG.hidden_size, CFG.vocab_size)).astype(np.float32) * 0.02})
    state = _state(tree)
    ids, m = _ids(4, (1, 10)), np.ones((1, 10), bool)
    state, loss = ttrain.train_step(state, cfg, ids, m)
    assert np.isfinite(float(loss)) and state.params["lm_head"]["w"].grad is not None
