"""The port's decode units (`lm/graphs.py`) through `decode_chunk`,
`generate` and the two engines' dispatches, on the CPU, where a unit runs
its steps eagerly.

Tiny config, fp32, the same JAX-initialised weights on both sides; the JAX
side runs its Pallas flash prefill and decode kernels in interpret mode.
Greedy ids and `valid` must equal JAX's; sampled ids must equal across the
port's own paths (the same generator, one draw per step).  The engine test
holds the static-buffer contract a CUDA graph needs: a dispatch, page
growth, admission and release leave every state tensor at its address.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import generate as jgen
from sparktts_tpu.lm import qwen as jq
from sparktts_tpu_torch.lm import generate as tgen
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm import qwen as tq
from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
from sparktts_tpu_torch.lm.paged import PagedContinuousEngine
from sparktts_tpu_torch.weights import qwen_state

CFG = tiny_test_config().llm
PAD = 1
GUIDED = dict(vocab_slice=(288, 416), extra_ids=(256, 260, 300))


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


def _left_padded(lengths, t_pad, seed):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), t_pad), CFG.pad_token_id, np.int64)
    mask = np.zeros((len(lengths), t_pad), bool)
    for i, n in enumerate(lengths):
        ids[i, t_pad - n:] = rng.integers(5, CFG.vocab_size - 6, size=n)
        mask[i, t_pad - n:] = True
    return ids, mask


def _port_prefill(tp, ids, mask, cache_len, generator, greedy):
    cache = tq.init_kv_cache(CFG, ids.shape[0], cache_len, torch.float32, "cpu")
    return tgen.prefill(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask), cache, generator,
                        0.8, 50, 0.95, greedy, **GUIDED)


@pytest.mark.parametrize("n", [1, 5, 8])
def test_greedy_decode_chunks_equal_jax_through_eos(params, jax_decode_kernel, n):
    """Two chained greedy chunks of n steps after the same prefill: ids and
    `valid` equal JAX's, with EOS (the first row's token n - 1 of a free
    run) inside them, so the rows after it emit pad_id, invalid."""
    jp, tp = params
    ids, mask = _left_padded([40, 17], 64, seed=4)
    cache_len = tq.aligned_cache_len(64 + 2 * n)
    free = tgen.generate(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                         torch.Generator(), 2 * n, cache_len, pad_id=PAD, greedy=True,
                         cache_dtype=torch.float32, **GUIDED)[0]
    kw = dict(eos_ids=(int(free[0, n - 1]),), pad_id=PAD, greedy=True, **GUIDED)

    jstate = jgen.prefill(jp, CFG, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                          jq.init_kv_cache(CFG, 2, cache_len, jnp.float32), jax.random.PRNGKey(0),
                          0.8, 50, 0.95, greedy=True, use_flash=True, **GUIDED)
    tstate = _port_prefill(tp, ids, mask, cache_len, torch.Generator(), greedy=True)
    gen = torch.Generator()
    want_t, want_v, got_t, got_v = [], [], [], []
    for _ in range(2):
        jstate, jt, jv = jgen.decode_chunk(jp, CFG, jstate, 64, n, **kw)
        tstate, tt, tv = tgen.decode_chunk(tp, CFG, tstate, 64, n, gen, **kw)
        want_t.append(np.asarray(jt))
        want_v.append(np.asarray(jv))
        got_t.append(tt.numpy())
        got_v.append(tv.numpy())
    want_v, got_v = np.concatenate(want_v, 1), np.concatenate(got_v, 1)
    np.testing.assert_array_equal(np.concatenate(got_t, 1), np.concatenate(want_t, 1))
    np.testing.assert_array_equal(got_v, want_v)
    assert not got_v[0].all() and got_v[0, 0]  # the EOS row stopped inside the chunks
    assert int(tstate.step) == int(jstate.step) == 2 * n


def test_chained_sampled_chunks_equal_generate(params):
    """Sampled decode_chunks chained from a prefill with seed s, in units of
    2 steps, give generate's ids with seed s (units of 8) over the same
    cache: one generator draw per step on both paths."""
    _, tp = params
    ids, mask = _left_padded([33, 60], 64, seed=7)
    max_new, cache_len = 12, tq.aligned_cache_len(64 + 12)
    want, _ = tgen.generate(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.Generator().manual_seed(11), max_new, cache_len, pad_id=PAD,
                            cache_dtype=torch.float32, **GUIDED)
    gen = torch.Generator().manual_seed(11)
    state = _port_prefill(tp, ids, mask, cache_len, gen, greedy=False)
    chunks = []
    for n in (4, 6, 2):
        state, toks, _ = tgen.decode_chunk(tp, CFG, state, 64, n, gen, pad_id=PAD,
                                           unit_steps=2, **GUIDED)
        chunks.append(toks)
    np.testing.assert_array_equal(torch.cat(chunks, 1).numpy(), want.numpy())


def _engine(kind, tp):
    kw = dict(max_slots=3, prompt_pad=16, eos_ids=(CFG.eos_token_id,), pad_id=PAD, greedy=True,
              cache_dtype=torch.float32, device="cpu", vocab_slice=(200, 400), extra_ids=(0, 7),
              clone_slice=(200, 300), clone_extras=(0,))
    if kind == "dense":
        return ContinuousBatchingEngine(tp, CFG, cache_len=96, **kw)
    return PagedContinuousEngine(tp, CFG, n_pages=12, page_size=16, pages_per_slot=5, **kw)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_state_keeps_its_addresses(params, kind):
    """Admission, a dispatch, page growth (`_ensure_pages`) and a release
    write the engine state in place: every tensor of `eng.slots` (cache or
    pools, page table, slot vectors) stays the same object at the same
    address, as the engine's decode unit binds them."""
    _, tp = params
    eng = _engine(kind, tp)
    before = [(t, t.data_ptr()) for t in graphs.tensors(eng.slots)]
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(10, 400, size=n).tolist(), 40, mode=m)
            for n, m in ((9, "control"), (14, "clone"))]
    eng.step(8)
    if kind == "paged":
        table = eng.slots.page_table.clone()
        eng._ensure_pages(24)
        assert not torch.equal(table, eng.slots.page_table)  # the tables grew, in place
    eng.release_slot(eng.owner.index(reqs[1]))
    eng.step(4)
    after = graphs.tensors(eng.slots)
    assert len(after) == len(before)
    for (t, ptr), now in zip(before, after):
        assert now is t and now.data_ptr() == ptr
    assert eng.buffers[reqs[0]] and reqs[1] not in eng.buffers
