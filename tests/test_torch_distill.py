"""The port's draft distillation (`sparktts_tpu_torch/lm/distill.py`)
against the JAX package's `lm/distill.py` and `tests/test_distill.py`.

`sample_target_corpus`'s greedy continuation of JAX's prompts equals JAX's
corpus id for id (the LM of `tests/test_train.py`'s config, same numpy
params, bf16 caches on both sides); `corpus_stats` equals JAX's; the port's
cycler teacher equals JAX's tree; the distilled one-layer draft of the
cycler accepts > 0.5 and > the random draft + 0.3 (`tests/test_distill.py`'s
gates), and its loss curve descends.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import QwenConfig as JaxQwenConfig
from sparktts_tpu.lm import distill as jdistill
from sparktts_tpu.lm.qwen import init_qwen as jax_init_qwen
from sparktts_tpu_torch.checkpoint import flatten_tree
from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm import distill as tdistill
from sparktts_tpu_torch.weights import init_qwen

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=2, head_dim=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file: under pytest-xdist
    each worker's own pool would oversubscribe the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab_slice", [None, (10, 90)])
def test_greedy_corpus_equals_jax(vocab_slice):
    jparams = jax_init_qwen(jax.random.PRNGKey(0), JaxQwenConfig(**CFG_KW), dtype=jnp.float32)
    want = jdistill.sample_target_corpus(jparams, JaxQwenConfig(**CFG_KW), jax.random.PRNGKey(1),
                                         n_seqs=6, prompt_len=5, gen_len=12, greedy=True,
                                         vocab_slice=vocab_slice)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    got = tdistill.sample_target_corpus(params, QwenConfig(**CFG_KW), torch.Generator(),
                                        n_seqs=6, prompt_len=5, gen_len=12, greedy=True,
                                        vocab_slice=vocab_slice, prompts=want[:, :5])
    np.testing.assert_array_equal(got, want)
    # drawn prompts: in range, from the generator
    drawn = tdistill.sample_target_corpus(params, QwenConfig(**CFG_KW),
                                          torch.Generator().manual_seed(3), n_seqs=6,
                                          prompt_len=5, gen_len=4, vocab_slice=(10, 20))
    assert drawn.shape == (6, 9) and ((drawn[:, :5] >= 10) & (drawn[:, :5] < 20)).all()


def test_corpus_stats_equal_jax():
    rng = np.random.default_rng(0)
    corpora = [
        np.concatenate([np.arange(32).reshape(8, 4) % 7, np.full((8, 16), 3)], axis=1),
        np.concatenate([np.zeros((8, 4), int), np.tile(np.arange(8), (8, 2))], axis=1),
        rng.integers(0, 20, size=(16, 24)),
    ]
    for corpus in corpora:
        assert tdistill.corpus_stats(corpus, 4) == jdistill.corpus_stats(corpus, 4)
    assert tdistill.corpus_stats(corpora[0], 4)["top_token_share"] == 1.0


def test_cycler_teacher_equals_jax():
    jparams, jcfg = jdistill.make_cycler_teacher(32, shift=3)
    params, cfg = tdistill.make_cycler_teacher(32, shift=3, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = flatten_tree(jax.tree.map(np.asarray, jparams))[0]
    got = flatten_tree(params)[0]
    assert set(got) == set(want)
    for name, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[name], err_msg=name)
    # any head layout gives the same greedy map (the attention is zeroed)
    wide, wcfg = tdistill.make_cycler_teacher(32, num_attention_heads=14, num_key_value_heads=2,
                                              head_dim=64, device="cpu")
    assert wide["layers"]["qkv"]["w"].shape == (1, 32, 18 * 64)
    assert tdistill.measure_acceptance(wide, wide, wcfg, wcfg, n_prompts=2, gen_len=8,
                                       device="cpu") == pytest.approx(0.75, abs=0.05)


def test_distilled_draft_beats_random_draft():
    target, cfg = tdistill.make_cycler_teacher(device="cpu")
    dcfg = dataclasses.replace(cfg, num_hidden_layers=1)
    random_draft = init_qwen(dcfg, torch.Generator().manual_seed(3), dtype=torch.float32,
                             device="cpu")
    base_rate = tdistill.measure_acceptance(target, random_draft, cfg, dcfg, k=4, seed=0,
                                            device="cpu")
    draft, losses = tdistill.distill_draft(
        target, cfg, dcfg, steps=150, batch=8, prompt_len=4, gen_len=24, corpus_seqs=128,
        learning_rate=5e-3, seed=0, device="cpu",
    )
    rate = tdistill.measure_acceptance(target, draft, cfg, dcfg, k=4, seed=0, device="cpu")
    assert rate > 0.5, f"distilled acceptance too low: {rate} (loss {losses[-1]})"
    assert rate > base_rate + 0.3, (rate, base_rate)
    assert len(losses) == 150 and losses[0] > 0.5 and losses[-1] < losses[4] * 0.5
    assert not any(t.requires_grad for t in flatten_tree(draft)[0].values())


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target, cfg = tdistill.make_cycler_teacher(device="cpu")
    for call in (lambda: tdistill.make_cycler_teacher(),
                 lambda: tdistill.distill_draft(target, cfg, cfg, steps=1),
                 lambda: tdistill.measure_acceptance(target, target, cfg, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
