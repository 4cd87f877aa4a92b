"""The port's paged decode attention and paged continuous batching engine
against the JAX package.

Tiny config, fp32, the same JAX-initialised weights on both sides (scaled
by 4 so that greedy decoding does not repeat one id).  The JAX engine runs
its Pallas paged kernel in interpret mode, as its own tests do; the port's
engine runs on CPU tensors, so its kernel wrapper takes the plain version.
Attention tolerances: fp32 2e-5 (the JAX package's own bound between its
kernel and its gather reference), bf16 pools 2e-2 (the same bound for bf16).
Greedy ids must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.kernels.paged_attention import paged_decode_attention as jax_paged
from sparktts_tpu.kernels.paged_attention import reference_paged_attention
from sparktts_tpu.lm import qwen as jq
from sparktts_tpu.lm.paged import PagedContinuousEngine as JaxPagedEngine
from sparktts_tpu_torch.kernels import paged_attention as pa
from sparktts_tpu_torch.lm.continuous import (
    AdmissionDeferred,
    ContinuousBatchingEngine,
    RequestTooLong,
)
from sparktts_tpu_torch.lm.paged import PagedContinuousEngine
from sparktts_tpu_torch.weights import init_qwen, qwen_state

CFG = tiny_test_config().llm
PAD = 1
EOS = CFG.eos_token_id
GUIDED = dict(vocab_slice=(200, 400), extra_ids=(0, 7), clone_slice=(200, 300), clone_extras=(0,))
POOL = dict(max_slots=4, n_pages=40, page_size=16, pages_per_slot=10, prompt_pad=16)


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
              device="cpu", **GUIDED, **POOL)
    kw.update(overrides)
    return PagedContinuousEngine(tp, CFG, **kw)


@pytest.fixture(scope="module")
def jax_ids(params):
    jp, _ = params
    eng = JaxPagedEngine(jp, CFG, eos_ids=(EOS,), pad_id=PAD, greedy=True, seed=0,
                         cache_dtype=jnp.float32, **GUIDED, **POOL)
    return _serve(eng)


def _pool_case(dtype, seed=0):
    """2 layers; slots of lengths 1, P, P + 1, the full table and 0, with
    zero table tails and page ids out of order."""
    rng = np.random.default_rng(seed)
    b, hq, hkv, d, page, n_pages, layers = 5, 14, 2, 64, 16, 12, 2
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((layers, hkv, n_pages, page, d), dtype=np.float32)
    vp = rng.standard_normal((layers, hkv, n_pages, page, d), dtype=np.float32)
    table = np.asarray([[7, 0, 0, 0], [3, 0, 0, 0], [11, 2, 0, 0], [9, 4, 10, 1], [5, 0, 0, 0]],
                       np.int32)
    lengths = np.asarray([1, page, page + 1, 4 * page, 0], np.int32)
    jkp, jvp = jnp.asarray(kp, dtype), jnp.asarray(vp, dtype)
    # the port reads the values the JAX side holds (bf16-rounded for bf16)
    tkp, tvp = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32) for x in (jkp, jvp))
    return (q, jkp, jvp, table, lengths), (torch.from_numpy(q), tkp, tvp,
                                           torch.from_numpy(table), torch.from_numpy(lengths))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-5), (jnp.bfloat16, 2e-2)])
def test_paged_plain_matches_pallas_and_reference(dtype, tol):
    (q, jkp, jvp, table, lengths), targs = _pool_case(dtype)
    before = pa.launches
    for layer in (0, 1):
        got = pa.paged_decode_attention(*targs, layer, sm_scale=0.125).numpy()
        want = np.asarray(jax_paged(jnp.asarray(q), jkp, jvp, jnp.asarray(table),
                                    jnp.asarray(lengths), layer=layer, sm_scale=0.125,
                                    interpret=True))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)  # length 0: zeros on both
        ref = np.asarray(reference_paged_attention(jnp.asarray(q), jkp, jvp, jnp.asarray(table),
                                                   jnp.asarray(lengths), layer=layer,
                                                   sm_scale=0.125))
        # the reference averages V over a length-0 row (its mask is -1e9)
        np.testing.assert_allclose(got[:4], ref[:4], rtol=tol, atol=tol)
        assert np.all(got[4] == 0)
    assert pa.launches == before  # CPU tensors take the plain version


SPLIT_PAGE, SPLIT_PPS = 16, 4
SPLIT_LENGTHS = {"0": 0, "1": 1, "P": SPLIT_PAGE, "P+1": SPLIT_PAGE + 1,
                 "pps*P": SPLIT_PPS * SPLIT_PAGE, "pps*P+1": SPLIT_PPS * SPLIT_PAGE + 1}


@pytest.mark.parametrize("length", list(SPLIT_LENGTHS))
@pytest.mark.parametrize("chunk", (8, 16, 32, 64, 128))
def test_paged_split_plain_matches_pallas_and_plain(chunk, length):
    """The CPU model of the split kernel (each slot's keys gathered through
    its table row, per-chunk partials merged in chunk order) against the
    Pallas kernel in interpret mode and the plain version, fp32 1e-5: the
    same fp32 math merged in another order.  Chunks inside a page (8), one
    page (16), spanning pages (32, 64) and the whole table (128, the built
    kernel's chunk); slot 0 of each length, beside a
    ragged slot and a one-key slot; a slot at pps P + 1 (finished, one past
    its table) reads only its table; length 0 gives zeros."""
    rng = np.random.default_rng(chunk)
    b, hq, hkv, d, layers = 3, 14, 2, 64, 2
    page, pps = SPLIT_PAGE, SPLIT_PPS
    lengths = np.asarray([SPLIT_LENGTHS[length], 37, 1], np.int32)
    n_pages = b * pps + 1
    ids = rng.permutation(np.arange(1, n_pages)).reshape(b, pps).astype(np.int32)
    used = np.minimum(-(-lengths // page), pps)
    table = np.where(np.arange(pps)[None, :] < used[:, None], ids, 0).astype(np.int32)
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((layers, hkv, n_pages, page, d), dtype=np.float32)
              for _ in range(2))
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
    for layer in (0, 1):
        want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(table), jnp.asarray(lengths), layer=layer,
                                    sm_scale=0.125, interpret=True))
        plain = pa.paged_decode_plain(*args, layer, sm_scale=0.125).numpy()
        got = pa.paged_decode_split_plain(*args, layer, sm_scale=0.125, chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
        assert np.all(got[lengths == 0] == 0)


def test_paged_engine_greedy_ids_equal_jax(params, jax_ids):
    _, tp = params
    got = _serve(_port(tp))
    assert [len(x) for x in got] == [len(x) for x in jax_ids]
    for g, w in zip(got, jax_ids):
        np.testing.assert_array_equal(g, w)
    assert set(got[1].tolist()) <= set(range(200, 300)) | {EOS}  # the clone slot
    assert len(set(got[0].tolist())) > 5  # the test weights do not repeat one id


def test_paged_engine_equals_dense_engine(params):
    _, tp = params
    kw = {k: v for k, v in POOL.items() if k in ("max_slots", "prompt_pad")}
    dense = ContinuousBatchingEngine(tp, CFG, cache_len=160, eos_ids=(EOS,), pad_id=PAD,
                                     greedy=True, cache_dtype=torch.float32, device="cpu",
                                     **GUIDED, **kw)
    for g, w in zip(_serve(_port(tp)), _serve(dense)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("greedy", [True, False])
def test_paged_dispatch_partition_invariance(params, greedy):
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


def test_paged_pipelined_step_begins_equal_serialized(params):
    """Two step_begins before the first commit: page growth covers both
    dispatches (steps_inflight), and the ids equal serialized steps."""
    _, tp = params
    prompts = _prompts(5, (12, 30))
    outs = []
    for pipelined in (False, True):
        eng = _port(tp, eos_ids=())
        reqs = [eng.submit(p, max_new_tokens=40) for p in prompts]
        if pipelined:
            h1 = eng.step_begin(16)
            h2 = eng.step_begin(16)
            eng.step_commit(h1, eng.step_fetch(h1))
            eng.step_commit(h2, eng.step_fetch(h2))
        else:
            eng.step(16)
            eng.step(16)
        eng.run_until_done(8)
        outs.append([eng.finished[r] for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_paged_admission_deferral_and_pool_restored(params):
    """Worst-case pages are reserved at admission: a request the pool cannot
    guarantee is deferred, and runs once the first has returned its pages."""
    _, tp = params
    eng = _port(tp, n_pages=4, eos_ids=())
    r0 = eng.submit(list(range(10, 20)), max_new_tokens=16)  # 2 pages worst case of 3
    with pytest.raises(AdmissionDeferred):
        eng.submit(list(range(10, 20)), max_new_tokens=16)
    eng.run_until_done(16)
    assert len(eng.finished[r0]) == 16
    assert eng.pages_in_use() == 0 and sorted(eng.free_pages) == [1, 2, 3]
    r1 = eng.submit(list(range(10, 20)), max_new_tokens=16)
    eng.run_until_done(16)
    np.testing.assert_array_equal(eng.finished[r1], eng.finished[r0])
    with pytest.raises(RequestTooLong):
        eng.submit(list(range(10, 20)), max_new_tokens=200)


def test_paged_release_slot(params):
    _, tp = params
    prompts = _prompts(6, (8, 20))
    solo = _port(tp, eos_ids=())
    ref = solo.submit(prompts[1], max_new_tokens=24)
    solo.run_until_done(8)
    eng = _port(tp, eos_ids=())
    r0 = eng.submit(prompts[0], max_new_tokens=24)
    r1 = eng.submit(prompts[1], max_new_tokens=24)
    eng.step(8)
    in_use = eng.pages_in_use()
    eng.release_slot(0)
    assert eng.free_slots() == 3 and r0 not in eng.buffers
    assert eng.pages_in_use() < in_use and eng.slot_pages[0] == []
    eng.run_until_done(8)
    assert r0 not in eng.finished
    np.testing.assert_array_equal(eng.finished[r1], solo.finished[ref])
    assert eng.pages_in_use() == 0 and len(eng.free_pages) == POOL["n_pages"] - 1


def test_paged_pool_under_half_the_dense_cache(params):
    """A pool of half the dense engine's bytes serves four concurrent
    requests: each holds only ceil(written / page_size) pages."""
    _, tp = params
    dense = ContinuousBatchingEngine(tp, CFG, max_slots=4, cache_len=160, prompt_pad=16,
                                     cache_dtype=torch.float32, device="cpu")
    paged = _port(tp, n_pages=19, eos_ids=())
    dense_bytes = dense.slots.cache.k.nbytes + dense.slots.cache.v.nbytes
    paged_bytes = paged.slots.k_pages.nbytes + paged.slots.v_pages.nbytes
    assert paged_bytes < dense_bytes / 2
    reqs = [paged.submit(p, 24) for p in _prompts(7, (9, 9, 9, 9))]
    paged.run_until_done(8)
    assert all(len(paged.finished[r]) == 24 for r in reqs)
    assert paged.pages_in_use() == 0


def test_paged_dead_slot_at_the_table_edge(params):
    """A slot run to limit == pages_per_slot * page_size (write_pos one page
    past its table row) while another slot stays live: no index error, and
    the live slot's ids equal its solo run."""
    _, tp = params
    edge = dict(n_pages=12, pages_per_slot=4, eos_ids=(), max_dispatch=512)
    full, late = _prompts(8, (16, 5))
    solo = _port(tp, **edge)
    ref = solo.submit(late, max_new_tokens=48)
    solo.run_until_done(16)
    eng = _port(tp, **edge)
    r_full = eng.submit(full, max_new_tokens=48)  # limit 64 == 4 pages x 16
    eng.step(4)
    r_late = eng.submit(late, max_new_tokens=48)
    eng.run_until_done(16)  # r_full finishes mid-dispatch: 4 steps run past it
    assert len(eng.finished[r_full]) == 48
    np.testing.assert_array_equal(eng.finished[r_late], solo.finished[ref])


def test_paged_engine_needs_a_card_and_its_device(params, monkeypatch):
    _, tp = params
    with pytest.raises(ValueError, match="params lie on meta"):
        PagedContinuousEngine(init_qwen(CFG, device="meta"), CFG, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedContinuousEngine(tp, CFG)
