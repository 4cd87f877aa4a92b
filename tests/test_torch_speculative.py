"""Speculative decoding of the port against the JAX package's.

The same seeded numpy inputs and JAX-initialised weights go through JAX's
`speculative_generate_greedy` and the port's; greedy ids must be equal bit
for bit to JAX's and to the port's own vanilla greedy `generate`, whatever
the draft (the greedy invariant), and the accepted counts equal JAX's; the
emissions the port marks as rejected proposals are ones the draft's own
greedy pick disagrees with (none for a perfect draft, all but the first
for the cycler's).  Caches
are fp32 on both sides.  Sampled: top-k 1 equals greedy, and the first
sampled token's distribution over 8192 rows lies within total variation 0.05
of the exact marginal computed from `warped_probs`.  The pipeline with
`speculative_k=4, draft_layers=1` gives JAX's greedy ids and its waveform
within 1e-4 of the peak (fp32, summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import QwenConfig as JaxQwenConfig
from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import speculative as jspec
from sparktts_tpu.lm.distill import make_cycler_teacher
from sparktts_tpu.lm.qwen import init_qwen as jax_init_qwen
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.lm import generate as tgen
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm import qwen as tq
from sparktts_tpu_torch.lm import speculative as tspec
from sparktts_tpu_torch.lm.generate import expand_constrained
from sparktts_tpu_torch.lm.sample import greedy_token, warped_probs
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.weights import qwen_state

VOCAB, EOS, PAD = 96, 5, 3
JCFG = JaxQwenConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                     head_dim=16, eos_token_id=EOS, pad_token_id=PAD)
CFG = QwenConfig(**dataclasses.asdict(JCFG))
TV_TOL = 0.05  # noise at 8192 rows ~0.025; dropping the residual gives ~0.1
WAV_REL_TOL = 1e-4


def _pair(jparams):
    return jparams, qwen_state(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file.  Under pytest-xdist
    each worker's own pool oversubscribes the shared cores, and the 8192-row
    sampled test's small batched matmuls then stall at the pool's barriers
    (100 s against 15 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Target and two random drafts, each as (JAX tree, port tree), and the
    cycler target (token i -> i + 1) with its shift-2 draft, which rejects
    every proposal, and their config."""
    out = {name: _pair(jax_init_qwen(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32))
           for name, seed in (("target", 0), ("random", 42), ("random7", 7))}
    jc, jccfg = make_cycler_teacher(32, shift=1)
    out["cycler"] = _pair(jc)
    out["cycler2"] = _pair(make_cycler_teacher(32, shift=2)[0])
    return out, jccfg


def _prompt(seed, b, t, pad_rows=()):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, VOCAB, size=(b, t))
    mask = np.ones((b, t), bool)
    for row, n in pad_rows:
        ids[row, :n], mask[row, :n] = PAD, False
    return ids, mask


def _draft(models, name, jcfg):
    """(JAX draft, port draft, JAX draft config, port draft config)."""
    tree, n = (name, None) if not name.startswith("layers") else ("target", int(name[6:]))
    jd, td = models[tree]
    if n is None:
        return jd, td, jcfg, QwenConfig(**dataclasses.asdict(jcfg))
    return (jspec.draft_from_layers(jd, n), tspec.draft_from_layers(td, n),
            jspec.draft_config(jcfg, n), tspec.draft_config(QwenConfig(**dataclasses.asdict(jcfg)), n))


def _draft_picks(td, dcfg, ids, mask, toks, vocab_slice, extra_ids):
    """(B, max_new): the draft's greedy pick for each emission given the
    prompt and the emissions before it, by one causal forward."""
    x = torch.cat([ids, toks], dim=1)
    m = torch.cat([mask, torch.ones_like(toks, dtype=torch.bool)], dim=1)
    cache = tq.init_kv_cache(dcfg, x.shape[0], x.shape[1], torch.float32, "cpu")
    pos, bias = tq.prefill_inputs(m, x.shape[1])
    logits, _ = tq.qwen_forward(td, dcfg, x, pos, cache, 0, bias, vocab_slice=vocab_slice,
                                extra_ids=extra_ids)
    picks = greedy_token(logits[:, ids.shape[1] - 1 : -1])
    return expand_constrained(picks, vocab_slice, extra_ids)


# (target, draft, prompt (seed, b, t, padded rows) or ids, max_new, k, guided, eos)
CASES = {
    "perfect_draft": ("target", "target", (0, 1, 8, ()), 16, 4, None, ()),
    "random_draft": ("target", "random", (1, 1, 8, ()), 16, 4, None, ()),
    "early_exit_draft": ("target", "layers2", (2, 1, 8, ()), 20, 3, None, ()),
    "batched_left_padded": ("target", "layers2", (3, 3, 10, ((1, 4),)), 12, 3, None, ()),
    "eos_semantics": ("target", "random7", (4, 2, 6, ()), 14, 4, None, "first"),
    "guided": ("target", "layers2", (5, 1, 8, ()), 12, 3, ((20, 60), (EOS,)), (EOS,)),
    "cycler_rejects_every_draft": ("cycler", "cycler2", [[4, 9, 2]], 8, 3, None, ()),
    "cycler_batched_mixed_phases": ("cycler", "cycler2", [[4, 9, 2], [0, 7, 20]], 6, 4, None,
                                    ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_ids_equal_jax_and_vanilla_greedy(models, case):
    trees, ccfg = models
    tgt_name, drf_name, prompt, max_new, k, guided, eos = CASES[case]
    jcfg = ccfg if tgt_name == "cycler" else JCFG
    cfg = QwenConfig(**dataclasses.asdict(jcfg))
    if isinstance(prompt, list):
        ids, mask = np.asarray(prompt), np.ones((len(prompt), len(prompt[0])), bool)
    else:
        ids, mask = _prompt(prompt[0], prompt[1], prompt[2], prompt[3])
    pad = 0 if tgt_name == "cycler" else PAD
    vocab_slice, extra_ids = guided or (None, ())
    jt, tt = trees[tgt_name]
    jd, td, jdcfg, dcfg = _draft(trees, drf_name, jcfg)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    cache_len = ids.shape[1] + max_new + 8

    def vanilla(eos_ids):
        toks, lengths = tgen.generate(tt, cfg, tids, tmask, torch.Generator(), max_new, cache_len,
                                      eos_ids=eos_ids, pad_id=pad, greedy=True,
                                      cache_dtype=torch.float32, vocab_slice=vocab_slice,
                                      extra_ids=extra_ids)
        return toks.numpy(), lengths.numpy()

    if eos == "first":  # an EOS id that fires mid-stream in the free greedy output
        free, _ = vanilla(())
        eos = (int(next(t for t in free[0][2:] if t != pad)),)
    want, want_len = vanilla(eos)
    jtoks, jlen, jacc = jspec.speculative_generate_greedy(
        jt, jd, jcfg, jdcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        max_new_tokens=max_new, cache_len=cache_len, k=k, eos_ids=eos, pad_id=pad,
        vocab_slice=vocab_slice, extra_ids=extra_ids, cache_dtype=jnp.float32)
    toks, lengths, acc = tspec.speculative_generate_greedy(
        tt, td, cfg, dcfg, tids, tmask, max_new_tokens=max_new, cache_len=cache_len, k=k,
        eos_ids=eos, pad_id=pad, vocab_slice=vocab_slice, extra_ids=extra_ids,
        cache_dtype=torch.float32)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(toks.numpy(), want)
    np.testing.assert_array_equal(lengths.numpy(), want_len)
    assert int(acc) == int(jacc)
    # the rejected proposals the port marks: the draft picked otherwise there
    *_, rejected = tspec.speculative_decode(
        tt, td, cfg, dcfg, tids, tmask, None, max_new, cache_len, k, greedy=True, eos_ids=eos,
        pad_id=pad, vocab_slice=vocab_slice, extra_ids=extra_ids, cache_dtype=torch.float32)
    picks = _draft_picks(td, dcfg, tids, tmask, toks, vocab_slice, extra_ids)
    assert not (rejected & (picks == toks)).any()
    assert not (rejected & (toks == pad)).any()
    if case == "perfect_draft":
        assert int(acc) == max_new // k * (k - 1)  # every proposal accepted
        assert not rejected.any()
    elif case.startswith("cycler"):  # every round stops on a rejection after one token
        assert not rejected[:, 0].any() and rejected[:, 1:].all()
    if case == "cycler_rejects_every_draft":
        np.testing.assert_array_equal(toks[0].numpy(), np.arange(3, 11))
        assert int(acc) == 0
    if case == "cycler_batched_mixed_phases":
        np.testing.assert_array_equal(toks.numpy(), [[3, 4, 5, 6, 7, 8], [21, 22, 23, 24, 25, 26]])


@pytest.mark.parametrize("target,draft", [("target", "random"), ("cycler", "cycler2")])
def test_sampled_at_top_k_1_equals_greedy(models, target, draft):
    """At top-k 1 the warped distribution is the argmax: sampled speculative
    decode must equal vanilla greedy, for any draft."""
    trees, ccfg = models
    cfg = QwenConfig(**dataclasses.asdict(ccfg if target == "cycler" else JCFG))
    tt, td = trees[target][1], trees[draft][1]
    ids, mask = (torch.tensor([[4, 9, 2]]), torch.ones((1, 3), dtype=torch.bool)) \
        if target == "cycler" else map(torch.from_numpy, _prompt(6, 2, 8))
    pad, eos = (0, ()) if target == "cycler" else (PAD, (EOS,))
    want, want_len = tgen.generate(tt, cfg, ids, mask, torch.Generator(), 12, ids.shape[1] + 20,
                                   eos_ids=eos, pad_id=pad, greedy=True, cache_dtype=torch.float32)
    got, got_len, _ = tspec.speculative_generate(
        tt, td, cfg, cfg, ids, mask, torch.Generator().manual_seed(123), 12, ids.shape[1] + 20,
        k=4, temperature=1.0, top_k=1, top_p=1.0, eos_ids=eos, pad_id=pad,
        cache_dtype=torch.float32)
    assert torch.equal(got, want) and torch.equal(got_len, want_len)


def test_sampled_first_tokens_follow_warped_probs(models):
    """The marginal of the first token a speculative round samples (position
    1), over 8192 rows of one prompt with a random draft (its proposals are
    mostly rejected, so the residual draws run): within total variation TV_TOL of the exact marginal, the sum
    over the prefill's token t0 of P(t0) P(t1 | t0), both from
    `warped_probs` of the target."""
    trees, _ = models
    tt = trees["target"][1]
    td = trees["random"][1]
    n, t = 8192, 6
    ids, _ = _prompt(7, 1, t)
    ids = torch.from_numpy(np.repeat(ids, n, axis=0))
    mask = torch.ones((n, t), dtype=torch.bool)
    warp = dict(temperature=1.0, top_k=8, top_p=0.9)
    toks, _, _ = tspec.speculative_generate(tt, td, CFG, CFG, ids, mask,
                                            torch.Generator().manual_seed(11), 3, t + 3 + 8, k=3,
                                            pad_id=PAD, cache_dtype=torch.float32, **warp)

    def probs(prefix):
        x = torch.tensor([prefix])
        cache = tq.init_kv_cache(CFG, 1, len(prefix), torch.float32, "cpu")
        pos, bias = tq.prefill_inputs(torch.ones_like(x, dtype=torch.bool), len(prefix))
        logits, _ = tq.qwen_forward(tt, CFG, x, pos, cache, 0, bias, logits_last_only=True)
        return warped_probs(logits[:, -1], **warp)[0]

    prompt = ids[0].tolist()
    p0 = probs(prompt)
    want = sum(p0[t0] * probs(prompt + [t0]) for t0 in torch.nonzero(p0)[:, 0].tolist())
    got = torch.bincount(toks[:, 1], minlength=VOCAB).double() / n
    tv = 0.5 * float((got - want.double()).abs().sum())
    assert tv < TV_TOL, f"total variation {tv}"


def test_window_bias_and_multi_token_device_write_pos(models):
    """`_window_bias` equals JAX's; a (B,) device write position with T = 3
    writes each row's keys at [write_pos[b], write_pos[b] + 3), as a slice
    write of that row alone does, with the same logits."""
    tt = models[0]["target"][1]
    start, first = np.array([0, 2], np.int32), 7
    want = np.asarray(jspec._window_bias(jnp.asarray(start), jnp.int32(first), 3, 16))
    got = tspec._window_bias(torch.from_numpy(start), torch.tensor(first), 3, 16)
    np.testing.assert_array_equal(got.numpy(), want)

    rng = np.random.default_rng(8)
    s, t = 16, 3
    wp = torch.tensor([5, 9], dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(10, VOCAB, size=(2, t)))
    positions = wp.long()[:, None] + torch.arange(t)
    base = tq.init_kv_cache(CFG, 2, s, torch.float32, "cpu")
    for c in base:
        c.copy_(torch.from_numpy(rng.standard_normal(c.shape, dtype=np.float32)))
    bias = tspec._window_bias(torch.zeros(2, dtype=torch.int32), wp, t, s)
    cache = tq.KVCache(base.k.clone(), base.v.clone())
    logits, _ = tq.qwen_forward(tt, CFG, ids, positions, cache, wp, bias)
    for b in range(2):
        row = tq.KVCache(base.k[:, b : b + 1].clone(), base.v[:, b : b + 1].clone())
        want_logits, _ = tq.qwen_forward(tt, CFG, ids[b : b + 1], positions[b : b + 1], row,
                                         int(wp[b]), bias[b : b + 1])
        torch.testing.assert_close(cache.k[:, b : b + 1], row.k, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(cache.v[:, b : b + 1], row.v, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(logits[b : b + 1], want_logits, rtol=1e-5, atol=1e-5)


def test_pipeline_speculative_inference_matches_jax(monkeypatch):
    """`SparkTTSPipeline(speculative_k=4, draft_layers=1).inference`, greedy
    voice creation: the JAX pipeline's ids and waveform (1e-4 of the peak);
    with units cached on the CPU, the pipeline keeps one unit for a second
    call, which gives the same ids, and a new `llm_params` evicts it."""
    tpipe = SparkTTSPipeline(config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32,
                             max_new_tokens=24, speculative_k=4, draft_layers=1)
    tok = tpipe.tokenizer
    embed = tpipe.llm_params["embed"].clone()
    embed[tok.global_base : tok.global_base + tok.n_global] *= 0.3  # speak semantic ids
    tpipe.llm_params = {**tpipe.llm_params, "embed": embed}

    def same_weights(self, seed, lm_dtype):  # the port's trees, not ~140 compiled inits
        def jax_tree(tree):
            return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)

        self.llm_params = jax_tree(tpipe.llm_params)
        self.bicodec_params = jax_tree(tpipe.bicodec_params)
        self.w2v_params = jax_tree(tpipe.w2v_params)

    monkeypatch.setattr(JaxPipeline, "_random_init", same_weights)
    jpipe = JaxPipeline(config=tiny_test_config(), lm_dtype=jnp.float32, max_new_tokens=24,
                        speculative_k=4, draft_layers=1)
    voice = dict(gender="female", pitch="moderate", speed="high")
    text = "The quick brown fox."
    want = jpipe.inference(text, greedy=True, **voice)
    monkeypatch.setattr(graphs, "CACHED_DEVICE_TYPES", ("cuda", "cpu"))
    got = tpipe.inference(text, greedy=True, **voice)
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)

    from sparktts_tpu_torch.prompt import build_control_prompt

    ids = build_control_prompt(tpipe.tokenizer, text, **voice)
    first = tpipe.generate_tokens(ids, greedy=True, mode="control")
    assert len(tpipe.units) == 1
    np.testing.assert_array_equal(tpipe.generate_tokens(ids, greedy=True, mode="control"), first)
    np.testing.assert_array_equal(first, jpipe.generate_tokens(ids, greedy=True, mode="control"))
    tpipe.speculative_k = 0
    np.testing.assert_array_equal(tpipe.generate_tokens(ids, greedy=True, mode="control"), first)
    tpipe.llm_params = tpipe.llm_params
    assert len(tpipe.units) == 0
