"""The port's dense continuous batching engine and the pieces it shares with
the paged engine, against the JAX package.

Tiny config, fp32, the same JAX-initialised weights on both sides (scaled
by 4 so that greedy decoding does not repeat one id); the JAX engine decodes
as its own tests do.  Logit tolerance 1e-4 (fp32 through a few layers, summed
in another order), `warped_probs` rtol 1e-5; greedy ids, the guided masks,
the dispatch ladder and the packed step layout must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import continuous as jcont
from sparktts_tpu.lm import qwen as jq
from sparktts_tpu.lm.generate import packed_allowed_mask as jax_packed_allowed_mask
from sparktts_tpu.lm.sample import warped_probs as jax_warped_probs
from sparktts_tpu_torch.lm import continuous as tcont
from sparktts_tpu_torch.lm import qwen as tq
from sparktts_tpu_torch.lm.generate import packed_allowed_mask
from sparktts_tpu_torch.lm.sample import sample_token, warped_probs
from sparktts_tpu_torch.weights import init_qwen, qwen_state

CFG = tiny_test_config().llm
PAD = 1
EOS = CFG.eos_token_id
GUIDED = dict(vocab_slice=(200, 400), extra_ids=(0, 7), clone_slice=(200, 300), clone_extras=(0,))
SLOTS = dict(max_slots=4, cache_len=160, prompt_pad=16)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(lambda x: 4 * x, jq.init_qwen(jax.random.PRNGKey(0), CFG, dtype=jnp.float32))
    return jp, qwen_state(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(10, CFG.vocab_size - 10, size=n).tolist() for n in lengths]


def _serve(eng):
    """Three requests, control and clone slots, the third admitted while the
    first two decode; returns their finished ids in submission order."""
    p = _prompts(0, (7, 13, 5))
    reqs = [eng.submit(p[0], 24), eng.submit(p[1], 20, mode="clone")]
    eng.step(8)
    reqs.append(eng.submit(p[2], 24))
    eng.run_until_done(8)
    return [eng.finished[r] for r in reqs]


def _port(tp, **overrides):
    kw = dict(eos_ids=(EOS,), pad_id=PAD, greedy=True, seed=0, cache_dtype=torch.float32,
              device="cpu", **GUIDED, **SLOTS)
    kw.update(overrides)
    return tcont.ContinuousBatchingEngine(tp, CFG, **kw)


@pytest.fixture(scope="module")
def jax_ids(params):
    jp, _ = params
    eng = jcont.ContinuousBatchingEngine(jp, CFG, eos_ids=(EOS,), pad_id=PAD, greedy=True,
                                         seed=0, cache_dtype=jnp.float32, **GUIDED, **SLOTS)
    return _serve(eng)


@pytest.mark.parametrize("guided", [
    ((200, 400), (0, 7), (200, 300), (0,)),
    ((10, 50), (), (20, 30), ()),
    ((100, 300), (3, 5, 400), (150, 250), (5, 400, 7)),
])
def test_packed_allowed_mask_equals_jax(guided):
    got = packed_allowed_mask(*guided)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_packed_allowed_mask(*guided)))


def test_snap_to_ladder_equals_jax():
    for cap in (4, 6, 64, 100, 128, 512):
        got = [tcont.snap_to_ladder(n, cap) for n in range(1, 601)]
        assert got == [jcont.snap_to_ladder(n, cap) for n in range(1, 601)]
    assert tcont.DISPATCH_LADDER == jcont.DISPATCH_LADDER


def test_pack_unpack_round_trip_equals_jax():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 166000, size=(4, 9)).astype(np.int32)
    valid = rng.integers(0, 2, size=(4, 9)).astype(bool)
    done = np.asarray([True, False, True, False])
    got = tcont.pack_step_result(torch.from_numpy(toks).long(), torch.from_numpy(valid),
                                 torch.from_numpy(done)).numpy()
    want = np.asarray(jcont.pack_step_result(jnp.asarray(toks), jnp.asarray(valid),
                                             jnp.asarray(done)))
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tcont.unpack_step_result(got, 9), (toks, valid, done)):
        np.testing.assert_array_equal(a, b)


def test_per_row_warped_probs_match_jax():
    """temperature and top_p as (B, 1) per-row values, as the engines pass
    them."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 200), dtype=np.float32) * 3
    temp = np.asarray([[0.5], [0.8], [1.3]], np.float32)
    top_p = np.asarray([[0.9], [0.95], [0.5]], np.float32)
    want = np.asarray(jax_warped_probs(jnp.asarray(logits), jnp.asarray(temp), 50,
                                       jnp.asarray(top_p)))
    got = warped_probs(torch.from_numpy(logits), torch.from_numpy(temp), 50,
                       torch.from_numpy(top_p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a near-zero temperature row draws its argmax whatever the others do
    temp[1] = 1e-4
    draws = sample_token(torch.Generator().manual_seed(0), torch.from_numpy(logits),
                         torch.from_numpy(temp), 50, torch.from_numpy(top_p))
    assert int(draws[1]) == int(np.argmax(logits[1]))


def test_per_row_write_decode_step_matches_jax(params):
    """One decode step with a (B,) write position, rows at different
    positions (one at the cache's last slot): logits and the written caches."""
    jp, tp = params
    rng = np.random.default_rng(2)
    shape = (CFG.num_hidden_layers, 3, 32, CFG.num_key_value_heads, CFG.head_dim)
    ck, cv = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    tok = rng.integers(10, 500, size=(3, 1))
    wpos = np.asarray([5, 17, 31], np.int32)
    start = np.zeros(3, np.int32)
    jlog, jcache = jq.qwen_forward(
        jp, CFG, jnp.asarray(tok, jnp.int32), jnp.asarray(wpos[:, None]),
        jq.KVCache(jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(wpos), None,
        decode_window=(jnp.asarray(start), jnp.asarray(wpos)),
    )
    tcache = tq.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    tlog, tcache = tq.qwen_forward(
        tp, CFG, torch.from_numpy(tok), torch.from_numpy(wpos[:, None]), tcache,
        torch.from_numpy(wpos), None, decode_window=(torch.from_numpy(start),
                                                     torch.from_numpy(wpos)),
    )
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=1e-4, atol=1e-4)


def test_dense_engine_greedy_ids_equal_jax(params, jax_ids):
    _, tp = params
    got = _serve(_port(tp))
    assert [len(x) for x in got] == [len(x) for x in jax_ids]
    for g, w in zip(got, jax_ids):
        np.testing.assert_array_equal(g, w)
    assert set(got[1].tolist()) <= set(range(200, 300)) | {EOS}  # the clone slot
    assert len(set(got[0].tolist())) > 5  # the test weights do not repeat one id


@pytest.mark.parametrize("greedy", [True, False])
def test_dense_dispatch_partition_invariance(params, greedy):
    """The same ids whether the decode steps come in many small dispatches
    or one large one: the generator draws once a step, in either split."""
    _, tp = params
    prompts = _prompts(4, (9, 5))
    outs = []
    for plan in ([3, 5, 7, 11, 64], [64]):
        eng = _port(tp, greedy=greedy, eos_ids=(), max_dispatch=512)
        reqs = [eng.submit(p, max_new_tokens=40) for p in prompts]
        for n in plan:
            eng.step(n)
        eng.run_until_done(8)
        outs.append([eng.finished[r] for r in reqs])
    for a, b in zip(*outs):
        assert len(a) == 40
        np.testing.assert_array_equal(a, b)


def test_dense_pipelined_step_begins_equal_serialized(params):
    """Two step_begins before the first commit give the ids of serialized
    steps; a chained computation comes back with the second fetch."""
    _, tp = params
    prompts = _prompts(5, (12, 30))
    outs = []
    for pipelined in (False, True):
        eng = _port(tp, eos_ids=())
        reqs = [eng.submit(p, max_new_tokens=40) for p in prompts]
        if pipelined:
            h1 = eng.step_begin(16)
            # slots 0 and 1 hold the two requests: the sum of their first ids
            h2 = eng.step_begin(16, chain_fn=lambda p: torch.cat([p.reshape(-1), p[:2, :1].sum(0)]))
            eng.step_commit(h1, eng.step_fetch(h1))
            out, extra = eng.step_commit(h2, eng.step_fetch(h2))
            assert int(extra[0]) == sum(int(out[r][0]) for r in reqs)
        else:
            eng.step(16)
            eng.step(16)
        eng.run_until_done(8)
        outs.append([eng.finished[r] for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_dense_release_slot_and_capacity(params):
    _, tp = params
    prompts = _prompts(6, (8, 20))
    solo = _port(tp, eos_ids=())
    ref = solo.submit(prompts[1], max_new_tokens=24)
    solo.run_until_done(8)
    eng = _port(tp, eos_ids=(), max_slots=2)
    r0 = eng.submit(prompts[0], max_new_tokens=24)
    r1 = eng.submit(prompts[1], max_new_tokens=24)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.submit(prompts[0], max_new_tokens=24)
    eng.step(8)
    eng.release_slot(0)
    assert eng.free_slots() == 1 and r0 not in eng.buffers
    eng.run_until_done(8)
    assert r0 not in eng.finished
    np.testing.assert_array_equal(eng.finished[r1], solo.finished[ref])
    with pytest.raises(tcont.RequestTooLong):
        eng.submit(prompts[0], max_new_tokens=150)  # bucket 16 + 150 > 160


def test_dense_dead_slot_at_the_cache_edge(params):
    """A slot run to limit == cache_len (write_pos past the last cache slot)
    while another slot stays live: no index error, and the live slot's ids
    equal its solo run."""
    _, tp = params
    edge = dict(cache_len=64, eos_ids=(), max_dispatch=512)
    full, late = _prompts(8, (16, 5))
    solo = _port(tp, **edge)
    ref = solo.submit(late, max_new_tokens=48)
    solo.run_until_done(16)
    eng = _port(tp, **edge)
    r_full = eng.submit(full, max_new_tokens=48)  # limit 16 + 48 == cache_len
    eng.step(4)
    r_late = eng.submit(late, max_new_tokens=48)
    eng.run_until_done(16)  # r_full finishes mid-dispatch: 4 steps run past it
    assert len(eng.finished[r_full]) == 48
    np.testing.assert_array_equal(eng.finished[r_late], solo.finished[ref])


def test_device_prompt_tensor_admission(params):
    """A right-padded device tensor with its true length admits as the host
    list does."""
    _, tp = params
    p = _prompts(9, (11,))[0]
    a, b = _port(tp, eos_ids=()), _port(tp, eos_ids=())
    ra = a.submit(p, max_new_tokens=12)
    ids = torch.full((1, 16), PAD, dtype=torch.long)
    ids[0, :11] = torch.tensor(p)
    rb = b.submit(ids, max_new_tokens=12, prompt_len=11)
    a.run_until_done(8)
    b.run_until_done(8)
    np.testing.assert_array_equal(a.finished[ra], b.finished[rb])
    with pytest.raises(ValueError):
        b.submit(ids[:, :12], max_new_tokens=12, prompt_len=11)  # not a prompt_pad multiple


def test_dense_engine_needs_a_card_and_its_device(params, monkeypatch):
    _, tp = params
    with pytest.raises(ValueError, match="params lie on meta"):
        tcont.ContinuousBatchingEngine(init_qwen(CFG, device="meta"), CFG, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcont.ContinuousBatchingEngine(tp, CFG)
