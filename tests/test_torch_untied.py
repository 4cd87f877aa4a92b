"""The untied LM head (`lm_head`, a checkpoint with tie_word_embeddings
false) in the port against the JAX package.

`head_logits` for a bf16, an int8 (`w_q`/`scale`) and an int4
(`w_p4`/`gscale`, group 16 on hidden 64) head, with and without the guided
vocabulary: within 1e-4 of JAX's logits, relative to their largest.  The
unconstrained int8 head is `linear_apply`, whose output is bf16 in both
packages: PyTorch rounds after the int8 matmul and again after its scale,
where XLA keeps the fp32 sum through the scale (its excess-precision
default), so it is held to bf16 rounding, 2^-7 of the largest logit.
Greedy ids of an untied tiny LM (fp32, JAX-initialised weights scaled by 4
so that greedy decoding does not repeat one id, as the engine tests scale
them) through `generate` (fp32, int8, int4) and through both continuous
engines must equal JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import continuous as jcont
from sparktts_tpu.lm import qwen as jq
from sparktts_tpu.lm.generate import generate as jax_generate
from sparktts_tpu.lm.paged import PagedContinuousEngine as JaxPagedEngine
from sparktts_tpu.lm.quant import quantize_linear_int4 as jax_quantize_linear_int4
from sparktts_tpu.lm.quant import quantize_linear_int8 as jax_quantize_linear_int8
from sparktts_tpu.lm.quant import quantize_qwen_int4 as jax_quantize_int4
from sparktts_tpu.lm.quant import quantize_qwen_int8 as jax_quantize_int8
from sparktts_tpu_torch.lm import qwen as tq
from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.lm.paged import PagedContinuousEngine
from sparktts_tpu_torch.weights import init_qwen, qwen_state

CFG = dataclasses.replace(tiny_test_config().llm, tie_word_embeddings=False)
PAD = 1
EOS = CFG.eos_token_id
GUIDED = dict(vocab_slice=(200, 400), extra_ids=(0, 7), clone_slice=(200, 300), clone_extras=(0,))
HEAD_TOL = 1e-4
BF16_OUT_TOL = 2**-7  # the unconstrained quantized heads' bf16 outputs


def _tree(params, dtype=torch.float32):
    return qwen_state(jax.tree.map(np.asarray, params), "cpu", dtype)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(lambda x: 4 * x, jq.init_qwen(jax.random.PRNGKey(0), CFG, dtype=jnp.float32))
    return jp, _tree(jp)


def test_init_and_quantizers_make_an_untied_head():
    tp = init_qwen(CFG, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert tp["lm_head"]["w"].shape == (CFG.hidden_size, CFG.vocab_size)


def _head(kind, jax_head):
    if kind == "bf16":
        return {"w": jax_head["w"].astype(jnp.bfloat16)}
    if kind == "int8":
        return jax_quantize_linear_int8(jax_head)
    return jax_quantize_linear_int4(jax_head, 16)


@pytest.mark.parametrize("guided", [None, ((200, 400), (0, 7))], ids=["full", "guided"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_head_logits_equal_jax(params, kind, guided):
    jp, _ = params
    head = _head(kind, jp["lm_head"])
    x = np.random.default_rng(1).standard_normal((2, 3, CFG.hidden_size)).astype(np.float32)
    vocab_slice, extra_ids = guided if guided else (None, ())
    # under jit, as the JAX package runs it; XLA's CPU runtime has no bf16 x
    # bf16 -> fp32 dot, which the JAX package's unconstrained int4 head asks
    # for on bf16 activations, so that case runs on fp32 activations
    fp32_x = kind == "int4" and guided is None
    jax_head = jax.jit(functools.partial(jq.head_logits, vocab_slice=vocab_slice,
                                         extra_ids=extra_ids))
    want = np.asarray(jax_head({"lm_head": head},
                               jnp.asarray(x, jnp.float32 if fp32_x else jnp.bfloat16)))
    t_head = _tree(head, torch.bfloat16)
    got = tq.head_logits({"lm_head": t_head},
                         torch.from_numpy(x).to(torch.float32 if fp32_x else torch.bfloat16),
                         vocab_slice=vocab_slice, extra_ids=extra_ids)
    assert got.dtype == torch.float32
    width = CFG.vocab_size if guided is None else 200 + 2
    assert got.shape == want.shape == (2, 3, width)
    tol = BF16_OUT_TOL if guided is None and kind == "int8" else HEAD_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(10, CFG.vocab_size - 10, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4"])
def test_generate_greedy_ids_equal_jax(params, kind):
    jp, _ = params
    if kind == "int8":
        jp = jax_quantize_int8(jp)
    elif kind == "int4":
        jp = jax_quantize_int4(jp, group=16)
    assert set(jp["lm_head"]) == {"fp32": {"w"}, "int8": {"w_q", "scale"},
                                  "int4": {"w_p4", "gscale"}}[kind]
    tp = _tree(jp)
    t_pad, max_new = 16, 12
    ids = np.full((2, t_pad), PAD, np.int64)
    mask = np.zeros((2, t_pad), bool)
    for i, p in enumerate(_prompts(3, (9, 14))):
        ids[i, t_pad - len(p):] = p
        mask[i, t_pad - len(p):] = True
    common = dict(max_new_tokens=max_new, cache_len=t_pad + max_new, eos_ids=(EOS,), pad_id=PAD,
                  greedy=True, vocab_slice=GUIDED["vocab_slice"],
                  extra_ids=GUIDED["extra_ids"])
    want, want_len = jax_generate(jp, CFG, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                                  jax.random.PRNGKey(0), cache_dtype=jnp.float32,
                                  use_flash=True, **common)
    got, got_len = generate(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.Generator().manual_seed(0), cache_dtype=torch.float32, **common)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got[0].tolist())) > 3  # the test weights do not repeat one id


def _serve(eng):
    """Three requests, control and clone slots, the third admitted while the
    first two decode; returns their finished ids in submission order."""
    p = _prompts(0, (7, 13, 5))
    reqs = [eng.submit(p[0], 24), eng.submit(p[1], 20, mode="clone")]
    eng.step(8)
    reqs.append(eng.submit(p[2], 24))
    eng.run_until_done(8)
    return [eng.finished[r] for r in reqs]


ENGINES = {
    "dense": (jcont.ContinuousBatchingEngine, ContinuousBatchingEngine,
              dict(max_slots=4, cache_len=160, prompt_pad=16)),
    "paged": (JaxPagedEngine, PagedContinuousEngine,
              dict(max_slots=4, n_pages=40, page_size=16, pages_per_slot=10, prompt_pad=16)),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_greedy_ids_equal_jax(params, engine):
    jp, tp = params
    jax_engine, port_engine, sizes = ENGINES[engine]
    common = dict(eos_ids=(EOS,), pad_id=PAD, greedy=True, seed=0, **GUIDED, **sizes)
    want = _serve(jax_engine(jp, CFG, cache_dtype=jnp.float32, **common))
    got = _serve(port_engine(tp, CFG, cache_dtype=torch.float32, device="cpu", **common))
    assert [len(x) for x in got] == [len(x) for x in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(got[1].tolist()) <= set(range(200, 300)) | {EOS}  # the clone slot
