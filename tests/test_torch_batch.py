"""The batch surfaces of the port's pipeline against the JAX package: per-row
seeds, batched tokenize and vocode, clone prompts assembled on the device,
the fused generate-and-vocode path, the voice cache and the guided switch.

One JAX and one port pipeline on the tiny config with the same weights
(fp32; the JAX side runs its Pallas kernels in interpret mode).  Ids must be
equal: greedy ids, codec ids, assembled prompts and cache keys.  The port's
sampled streams are held by their own invariants (torch and jax.random draw
different numbers): a row's ids depend only on its own prompt and seed.
Waveforms agree with JAX's within 1e-4 of their peak (fp32, summed in
another order), and the fused path equals the unfused one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu.prompt import clone_prompt_scaffold as jax_clone_prompt_scaffold
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.pipeline import SparkTTSPipeline, seed_generators
from sparktts_tpu_torch.prompt import (
    build_clone_prompt,
    clone_prompt_scaffold,
    extract_semantic_ids,
)

WAV_REL_TOL = 1e-4
MAX_NEW = 16


@pytest.fixture(scope="module")
def pipelines():
    jax.clear_caches()
    jpipe = JaxPipeline(config=tiny_test_config(), lm_dtype=jnp.float32, use_flash=True,
                        max_new_tokens=MAX_NEW, prompt_bucket=32, voice_cache_size=2)
    tpipe = SparkTTSPipeline(
        config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32,
        max_new_tokens=MAX_NEW, prompt_bucket=32, voice_cache_size=2,
        llm_params=jax.tree.map(np.asarray, jpipe.llm_params),
        bicodec_params=jax.tree.map(np.asarray, jpipe.bicodec_params),
        wav2vec2_params=jax.tree.map(np.asarray, jpipe.w2v_params),
    )
    yield jpipe, tpipe
    jax.clear_caches()


def _wav(freq=300.0, seconds=1.0):
    sr = 16000
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


WAVS = (_wav(300.0), _wav(440.0, 1.5), _wav(300.0), _wav(520.0, 0.7))


@pytest.fixture(scope="module")
def codec_ids(pipelines):
    """The port's batched tokenize of WAVS: (device ids, counts, per-row
    host ids)."""
    _, tpipe = pipelines
    g, s, counts = tpipe.tokenize_audio_batch_device(list(WAVS))
    return g, s, counts, tpipe.tokenize_audio_batch(list(WAVS))


def _clone_prompts(tok, per_row, texts, prompt_texts=None):
    prompt_texts = prompt_texts or [None] * len(texts)
    return [build_clone_prompt(tok, text, g, s if pt is not None else None, pt)
            for (g, s), text, pt in zip(per_row, texts, prompt_texts)]


# ------------------------------------------------------------------ tokenize


def test_tokenize_audio_batch_equals_single_and_jax(pipelines, codec_ids):
    jpipe, tpipe = pipelines
    g, s, counts, per_row = codec_ids
    want = jpipe.tokenize_audio_batch(list(WAVS))
    assert counts == [x[1].shape[1] for x in want]
    for (gb, sb), (jg, js), wav in zip(per_row, want, WAVS):
        np.testing.assert_array_equal(gb, jg)
        np.testing.assert_array_equal(sb, js)
        gs, ss = tpipe.tokenize_audio(wav)
        np.testing.assert_array_equal(gb, gs)
        np.testing.assert_array_equal(sb, ss)
    assert g.shape == (len(WAVS), 4) and s.shape[1] >= max(counts)


# ------------------------------------------------------------ clone assembly


@pytest.mark.parametrize("with_text", [False, True], ids=["globals", "transcript"])
def test_assemble_clone_ids_batch_equals_jax_and_build_clone_prompt(pipelines, codec_ids,
                                                                    with_text):
    jpipe, tpipe = pipelines
    tok = tpipe.tokenizer
    g, s, counts, per_row = codec_ids
    texts = ["alpha beta", "gamma", "alpha beta", "delta epsilon zeta"]
    prompt_texts = ["ref words", "r", "ref words", "more ref words"] if with_text else None
    want = _clone_prompts(tok, per_row, texts, prompt_texts)

    # right-padded scaffolds of one length, each row's own offsets
    parts = [clone_prompt_scaffold(tok, t, g.shape[1], n if with_text else 0,
                                   prompt_texts[i] if with_text else None)
             for i, (t, n) in enumerate(zip(texts, counts))]
    t_pad = max(p[1] for p in parts)
    scaffolds = np.stack([clone_prompt_scaffold(tok, t, g.shape[1], n if with_text else 0,
                                                prompt_texts[i] if with_text else None,
                                                t_pad=t_pad)[0]
                          for i, (t, n) in enumerate(zip(texts, counts))])
    for i, (t, n) in enumerate(zip(texts, counts)):
        j = jax_clone_prompt_scaffold(jpipe.tokenizer, t, g.shape[1], n if with_text else 0,
                                      prompt_texts[i] if with_text else None, t_pad=t_pad)
        np.testing.assert_array_equal(scaffolds[i], j[0])
        assert parts[i][1:] == j[1:]
    g_offs, s_offs = [p[2] for p in parts], [p[3] for p in parts]
    n_sems = [n if with_text else 0 for n in counts]
    got = tpipe.assemble_clone_ids_batch(scaffolds, g, s, g_offs, s_offs, n_sems)
    jax_got = jpipe.assemble_clone_ids_batch(scaffolds, jnp.asarray(g.numpy()),
                                             jnp.asarray(s.numpy()), np.asarray(g_offs),
                                             np.asarray(s_offs), np.asarray(n_sems))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_got))
    for row, p, prompt in zip(got.numpy(), parts, want):
        assert row[: p[1]].tolist() == prompt
    one = tpipe.assemble_clone_ids(scaffolds[1], g[1:2], s[1:2], g_offs[1], s_offs[1], n_sems[1])
    np.testing.assert_array_equal(one.numpy()[0], got.numpy()[1])

    # left-padded to the prompt bucket, as the batch paths take prompts
    ids, mask = tpipe.clone_batch_inputs(texts, g, s, counts, prompt_texts)
    assert ids.shape[1] % tpipe.prompt_bucket == 0
    assert [ids[i][mask[i]].tolist() for i in range(len(texts))] == want
    assert all(bool(m[-1]) for m in mask)


# ---------------------------------------------------------------- per-row seeds


@pytest.fixture(scope="module")
def prompts(pipelines, codec_ids):
    _, tpipe = pipelines
    per_row = codec_ids[3]
    return _clone_prompts(tpipe.tokenizer, [per_row[0]] * 3,
                          ["alpha beta", "gamma delta", "epsilon zeta"])


def test_per_row_seed_composition_invariance(pipelines, prompts):
    """A row's sampled ids depend only on its own (prompt, seed): swapping
    the rows or the co-batched neighbour leaves them unchanged."""
    _, tpipe = pipelines
    p1, p2, p3 = prompts
    a = tpipe.generate_tokens_batch([p1, p2], seed=[7, 9])
    b = tpipe.generate_tokens_batch([p2, p1], seed=[9, 7])
    np.testing.assert_array_equal(a[0], b[1])
    np.testing.assert_array_equal(a[1], b[0])
    c = tpipe.generate_tokens_batch([p1, p3], seed=[7, 5])
    np.testing.assert_array_equal(a[0], c[0])


def test_per_row_distinct_seeds_differ(pipelines, prompts):
    _, tpipe = pipelines
    outs = tpipe.generate_tokens_batch([prompts[0]] * 3, seed=[1, 2, 1])
    np.testing.assert_array_equal(outs[0], outs[2])
    assert not (len(outs[0]) == len(outs[1]) and np.array_equal(outs[0], outs[1]))


def test_scalar_seed_deterministic(pipelines, prompts):
    _, tpipe = pipelines
    a = tpipe.generate_tokens_batch(prompts[:2], seed=3)
    b = tpipe.generate_tokens_batch(prompts[:2], seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_seed_generators():
    one = seed_generators(3, 4, "cpu")
    assert isinstance(one, torch.Generator)
    rows = seed_generators(np.asarray([1, 2]), 2, "cpu")
    assert [g.initial_seed() for g in rows] == [1, 2]
    with pytest.raises(ValueError, match="2 seeds for a batch of 3"):
        seed_generators([1, 2], 3, "cpu")


def test_generate_tokens_batch_greedy_equals_jax(pipelines, prompts):
    jpipe, tpipe = pipelines
    batch = [prompts[0], prompts[1][:-3], prompts[2]]
    got = tpipe.generate_tokens_batch(batch, greedy=True, seed=[4, 5, 6])
    want = jpipe.generate_tokens_batch(batch, greedy=True, seed=[4, 5, 6])
    assert [len(x) for x in got] == [len(x) for x in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ fused generate + vocode


def test_generate_and_vocode_batch(pipelines, codec_ids):
    """Fused = generate_tokens_batch + detokenize_batch bit for bit in the
    port (the vocode bucket at the budget, the offline serving setting);
    ids and waveforms equal JAX's fused path (waveforms within 1e-4 of
    their peak)."""
    jpipe, tpipe = pipelines
    g, s, counts, per_row = codec_ids
    texts = ["alpha", "beta gamma", "alpha", "delta"]
    prompt_texts = ["ref", None, "ref", "words"]
    ids, mask = tpipe.clone_batch_inputs(texts, g, s, counts, prompt_texts)
    seeds = [1, 2, 1, 3]
    saved = tpipe.vocode_bucket, jpipe.vocode_bucket
    tpipe.vocode_bucket = jpipe.vocode_bucket = MAX_NEW
    try:
        wavs, toks = tpipe.generate_and_vocode_batch(ids, mask, g, seed=seeds, greedy=True)
        prompts = [ids[i][mask[i]].tolist() for i in range(len(texts))]
        want_toks = tpipe.generate_tokens_batch(prompts, seed=seeds, greedy=True)
        want_wavs = tpipe.detokenize_batch(g.numpy(), [extract_semantic_ids(tpipe.tokenizer, t)
                                                       for t in want_toks])
        jax_wavs, jax_toks = jpipe.generate_and_vocode_batch(
            ids.numpy().astype(np.int32), mask.numpy(), g.numpy().astype(np.int32), seed=seeds,
            greedy=True)
    finally:
        tpipe.vocode_bucket, jpipe.vocode_bucket = saved
    assert any(len(w) for w in wavs)
    for w, t, ww, wt, jw, jt in zip(wavs, toks, want_wavs, want_toks, jax_wavs, jax_toks):
        np.testing.assert_array_equal(t, wt)
        assert w.dtype == np.float32 and np.array_equal(w, ww)
        np.testing.assert_array_equal(t, jt)
        assert w.shape == jw.shape
        if w.size:
            peak = np.abs(jw).max()
            np.testing.assert_allclose(w, jw, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)


def test_detokenize_batch_rows_equal_jax(pipelines, codec_ids):
    jpipe, tpipe = pipelines
    g = codec_ids[0].numpy()
    rng = np.random.default_rng(5)
    semantic = [rng.integers(0, 64, size=n) for n in (20, 7, 33, 1)]
    got = tpipe.detokenize_batch(g, semantic)
    want = jpipe.detokenize_batch(g, semantic)
    for w, j, sem in zip(got, want, semantic):
        assert w.shape == j.shape == (len(sem) * tpipe._wave_upsample,)
        np.testing.assert_allclose(w, j, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * np.abs(j).max())


# ----------------------------------------------------------------- voice cache


def _reset(pipe, size=2):
    pipe.voice_cache_size = size
    pipe._voice_cache.clear()
    pipe.voice_cache_stats.update(hits=0, misses=0)


def test_voice_cache_keys_equal_jax(pipelines, tmp_path):
    jpipe, tpipe = pipelines
    path = tmp_path / "voice.wav"
    write_wav(path, WAVS[1], 16000)
    for audio in (WAVS[0], WAVS[0].astype(np.float64), WAVS[1][:100], path, str(path)):
        key = tpipe.voice_cache_key(audio)
        assert isinstance(key, bytes) and len(key) == 16
        assert key == jpipe.voice_cache_key(audio)
    assert tpipe.voice_cache_key(WAVS[0]) != tpipe.voice_cache_key(WAVS[1])


def test_voice_cache_hit_skips_tokenize_and_matches(pipelines, monkeypatch):
    _, tpipe = pipelines
    _reset(tpipe)
    g1, s1 = tpipe.tokenize_audio(WAVS[1])
    calls = []
    real = tpipe.tokenize_host_prep
    monkeypatch.setattr(tpipe, "tokenize_host_prep", lambda a: (calls.append(1), real(a))[1])
    g2, s2 = tpipe.tokenize_audio(WAVS[1])
    assert not calls, "a cache hit must not touch the tokenize stack"
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(s1, s2)
    assert tpipe.voice_cache_stats == {"hits": 1, "misses": 1}
    g3, _ = tpipe.tokenize_audio(WAVS[3])
    assert calls and g3.shape == g1.shape
    _reset(tpipe)


def test_voice_cache_lru_eviction_and_off_switch(pipelines):
    _, tpipe = pipelines
    _reset(tpipe, size=2)
    a, b, c = _wav(220), _wav(330), _wav(445)
    for w in (a, b, c):
        tpipe.tokenize_audio_device(w)
    assert len(tpipe._voice_cache) == 2
    assert tpipe._voice_cache.get(tpipe.voice_cache_key(a)) is None, "LRU evicts the oldest"
    tpipe.tokenize_audio_device(b)  # b becomes the newest: c is evicted next
    tpipe.tokenize_audio_device(a)
    assert tpipe._voice_cache.get(tpipe.voice_cache_key(c)) is None
    assert tpipe._voice_cache.get(tpipe.voice_cache_key(b)) is not None
    g, s, n = tpipe.tokenize_audio_device(b)
    assert g.shape[0] == 1 and s.shape[1] >= n
    tpipe.voice_cache_size = 0
    assert tpipe.voice_cache_key(a) is None
    _reset(tpipe)


# ------------------------------------------------------------------ guided off


def test_unguided_greedy_ids_equal_jax(pipelines, prompts):
    """guided=False: no constraint, the LM samples the full vocabulary."""
    jpipe, tpipe = pipelines
    try:
        tpipe.guided = jpipe.guided = False
        assert tpipe.guided_constraint("clone") == jpipe.guided_constraint("clone") == (None, ())
        got = tpipe.generate_tokens(prompts[0], greedy=True, mode="clone")
        want = jpipe.generate_tokens(prompts[0], greedy=True, mode="clone")
        with pytest.raises(ValueError, match="guided"):
            tpipe.generate_and_vocode_batch(*tpipe.batch_inputs([prompts[0]]),
                                            torch.zeros((1, 4), dtype=torch.long))
    finally:
        tpipe.guided = jpipe.guided = True
    np.testing.assert_array_equal(got, want)
