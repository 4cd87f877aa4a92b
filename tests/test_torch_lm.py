"""The port's Qwen2.5 LM, sampler and generate loop against the JAX package.

Tiny config, fp32, the same JAX-initialised weights on both sides.  The JAX
side runs its Pallas flash prefill and decode kernels in interpret mode
(`use_flash=True`, `SPARKTTS_DECODE_KERNEL=1`); the port runs the plain
versions its kernel wrappers take on the CPU.  Logit tolerance 1e-4: fp32
through a few layers, summed in another order.  Greedy ids must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import generate as jgen
from sparktts_tpu.lm import qwen as jq
from sparktts_tpu.lm.sample import warped_probs as jax_warped_probs
from sparktts_tpu_torch.lm import generate as tgen
from sparktts_tpu_torch.lm import qwen as tq
from sparktts_tpu_torch.lm.sample import sample_token, warped_probs
from sparktts_tpu_torch.weights import qwen_state

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CFG = tiny_test_config().llm


@pytest.fixture(scope="module")
def params():
    jp = jq.init_qwen(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    return jp, qwen_state(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


@pytest.fixture
def jax_decode_kernel(monkeypatch):
    """Route the JAX decode path through the Pallas kernel (read at trace
    time, so drop cached programs before and after)."""
    monkeypatch.setenv("SPARKTTS_DECODE_KERNEL", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _left_padded(lengths, t_pad, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), t_pad), CFG.pad_token_id, np.int64)
    mask = np.zeros((len(lengths), t_pad), bool)
    for i, n in enumerate(lengths):
        ids[i, t_pad - n :] = rng.integers(5, CFG.vocab_size - 6, size=n)
        mask[i, t_pad - n :] = True
    return ids, mask


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, CFG.head_dim), dtype=np.float32)
    pos = rng.integers(0, 3000, size=(2, 5))
    want = np.asarray(jq.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), CFG))
    got = tq.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), CFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_flash", [True, False])
def test_prefill_and_decode_logits_match_jax(params, jax_decode_kernel, use_flash):
    jp, tp = params
    ids, mask = _left_padded([64, 23], 64)
    s = 128
    vocab_slice, extras = (300, 420), (7, 450)

    # prefill: full-T logits and the written cache
    jpos, jbias = jq.prefill_inputs(jnp.asarray(mask), s)
    start = (64 - mask.sum(1)).astype(np.int32)
    jcache = jq.init_kv_cache(CFG, 2, s, jnp.float32)
    jlog, jcache = jq.qwen_forward(
        jp, CFG, jnp.asarray(ids, jnp.int32), jpos, jcache, 0, jbias,
        flash_start=jnp.asarray(start), vocab_slice=vocab_slice, extra_ids=extras,
    )
    tcache = tq.init_kv_cache(CFG, 2, s, torch.float32, "cpu")
    tpos, tbias = tq.prefill_inputs(torch.from_numpy(mask), s)
    tlog, tcache = tq.qwen_forward(
        tp, CFG, torch.from_numpy(ids), tpos, tcache, 0, None if use_flash else tbias,
        flash_start=torch.from_numpy(start) if use_flash else None,
        vocab_slice=vocab_slice, extra_ids=extras,
    )
    valid = mask[:, :, None]  # logits of pad query rows are junk on both sides
    np.testing.assert_allclose(
        np.where(valid, tlog.numpy(), 0), np.where(valid, np.asarray(jlog), 0), **LOGIT_TOL
    )
    # cache slots of pad tokens past layer 0 follow the junk pad rows too
    slots = mask[None, :, :, None, None]
    np.testing.assert_allclose(
        np.where(slots, tcache.k.numpy()[:, :, :64], 0),
        np.where(slots, np.asarray(jcache.k)[:, :, :64], 0),
        **LOGIT_TOL,
    )

    # one decode step through the decode kernel paths
    tok = np.asarray([[11], [12]])
    dpos = mask.sum(1)[:, None]
    jlog, _ = jq.qwen_forward(
        jp, CFG, jnp.asarray(tok, jnp.int32), jnp.asarray(dpos, jnp.int32), jcache, 64, None,
        decode_window=(jnp.asarray(start), 64),
    )
    tlog, _ = tq.qwen_forward(
        tp, CFG, torch.from_numpy(tok), torch.from_numpy(dpos), tcache, 64, None,
        decode_window=(torch.from_numpy(start), torch.full((2,), 64, dtype=torch.int32)),
    )
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


def test_greedy_generate_ids_equal_jax(params, jax_decode_kernel):
    jp, tp = params
    ids, mask = _left_padded([40, 64, 9], 64, seed=3)
    kw = dict(max_new_tokens=12, cache_len=64 + 12, eos_ids=(300,), pad_id=1, greedy=True)
    guided = dict(vocab_slice=(288, 416), extra_ids=(256, 260, 300))
    for extra in ({}, guided):
        jt, jl = jgen.generate(
            jp, CFG, jnp.asarray(ids, jnp.int32), jnp.asarray(mask), jax.random.PRNGKey(0),
            cache_dtype=jnp.float32, use_flash=True, **kw, **extra,
        )
        tt, tl = tgen.generate(
            tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask), torch.Generator(),
            cache_dtype=torch.float32, **kw, **extra,
        )
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_generate_stops_after_eos_with_pad_and_valid_mask(params):
    """EOS stays in the output, then the row emits pad_id and stops counting;
    the loop's periodic done-check exits early without changing the ids."""
    _, tp = params
    ids, mask = _left_padded([30], 64, seed=5)
    kw = dict(cache_len=64 + 40, pad_id=1, greedy=True, cache_dtype=torch.float32)
    free, _ = tgen.generate(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.Generator(), max_new_tokens=40, **kw)
    eos = int(free[0, 3])
    toks, lengths = tgen.generate(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                                  torch.Generator(), max_new_tokens=40, eos_ids=(eos,), **kw)
    n = int(np.argmax(free[0].numpy() == eos)) + 1  # first EOS, included
    assert int(lengths[0]) == n
    np.testing.assert_array_equal(toks[0, :n].numpy(), free[0, :n].numpy())
    assert np.all(toks[0, n:].numpy() == 1)


def test_warped_probs_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 200), dtype=np.float32) * 3
    want = np.asarray(jax_warped_probs(jnp.asarray(logits), 0.8, 50, 0.95))
    got = warped_probs(torch.from_numpy(logits), 0.8, 50, 0.95).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sample_token_histogram_matches_warped_probs():
    """Sampling draws from warped_probs: total variation over 40k draws
    within 0.02 (its standard error here is about 0.005)."""
    rng = np.random.default_rng(1)
    row = torch.from_numpy(rng.standard_normal(40, dtype=np.float32) * 2)
    n = 40000
    draws = sample_token(torch.Generator().manual_seed(0), row.expand(n, -1), 0.8, 10, 0.9)
    hist = np.bincount(draws.numpy(), minlength=40) / n
    p = warped_probs(row[None], 0.8, 10, 0.9)[0].numpy()
    assert hist[p == 0].sum() == 0
    assert 0.5 * np.abs(hist - p).sum() < 0.02


def test_per_row_generators_independent_of_batch():
    """With one generator per row, a row's samples depend only on its own
    generator: the same seed alone or beside another row draws the same."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 64), dtype=np.float32))
    gens = [torch.Generator().manual_seed(5), torch.Generator().manual_seed(7)]
    alone = torch.Generator().manual_seed(7)
    for _ in range(20):
        pair = sample_token(gens, logits, 1.0, 50, 1.0)
        single = sample_token([alone], logits[1:], 1.0, 50, 1.0)
        assert int(pair[1]) == int(single[0])
