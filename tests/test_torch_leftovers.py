"""The port's small API leftovers against the JAX package: the token maps and
`TokenParser`, `fvq_vq2emb` / `fvq_get_emb`, `topk_two_stage`,
`torch_state_to_numpy` and `frame_signal`.

Tolerances: maps, `TokenParser` strings, `topk_two_stage` (values and
indices), `frame_signal` and `torch_state_to_numpy` exact; `fvq_vq2emb`
within 1e-6 (one fp32 linear, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu import checkpoint as jax_checkpoint
from sparktts_tpu.codec import fvq as jax_fvq
from sparktts_tpu.config import QuantizerConfig
from sparktts_tpu.dsp import mel as jax_mel
from sparktts_tpu.lm import sample as jax_sample
from sparktts_tpu.utils import tokens as jax_tokens
from sparktts_tpu_torch import checkpoint as torch_checkpoint
from sparktts_tpu_torch import prompt as torch_prompt
from sparktts_tpu_torch.codec import fvq as torch_fvq
from sparktts_tpu_torch.dsp import mel as torch_mel
from sparktts_tpu_torch.lm import sample as torch_sample
from sparktts_tpu_torch.utils import tokens as torch_tokens
from sparktts_tpu_torch.weights import bicodec_state

MAPS = ("TASK_TOKEN_MAP", "LEVELS_MAP", "LEVELS_MAP_UI", "GENDER_MAP", "AGE_MAP", "EMO_MAP")
EMB_TOL = 1e-6


@pytest.mark.parametrize("name", MAPS)
def test_token_maps_equal_jax(name):
    assert getattr(torch_tokens, name) == getattr(jax_tokens, name)


def test_prompt_reads_the_one_copy_of_the_maps():
    for name in ("TASK_TOKEN_MAP", "LEVELS_MAP", "GENDER_MAP"):
        assert getattr(torch_prompt, name) is getattr(torch_tokens, name)


# (method, its whole input domain: every key of its map, or every integer of
# its clamp range and past both ends)
PARSER_DOMAINS = [
    ("age", list(jax_tokens.AGE_MAP)),
    ("gender", list(jax_tokens.GENDER_MAP)),
    ("mel_value", list(range(-5, 1006)) + [3.7, -0.5, 1e6]),
    ("mel_level", list(jax_tokens.LEVELS_MAP)),
    ("pitch_var_value", list(range(-3, 14)) + [2.9]),
    ("pitch_var_level", list(jax_tokens.LEVELS_MAP)),
    ("loudness_value", list(range(-3, 34)) + [29.99]),
    ("loudness_level", list(jax_tokens.LEVELS_MAP)),
    ("speed_value", list(range(-3, 14)) + [10.5]),
    ("speed_level", list(jax_tokens.LEVELS_MAP)),
    ("task", list(jax_tokens.TASK_TOKEN_MAP)),
    ("emotion", list(jax_tokens.EMO_MAP)),
]


@pytest.mark.parametrize("method,domain", PARSER_DOMAINS, ids=[m for m, _ in PARSER_DOMAINS])
def test_token_parser_equals_jax(method, domain):
    got = [getattr(torch_tokens.TokenParser, method)(x) for x in domain]
    want = [getattr(jax_tokens.TokenParser, method)(x) for x in domain]
    assert got == want


def test_token_parser_rejects_what_jax_rejects():
    for method, bad in (("age", "Ancient"), ("gender", "other"), ("mel_level", "loud"),
                        ("task", "sing"), ("emotion", "BORED")):
        with pytest.raises(KeyError):
            getattr(jax_tokens.TokenParser, method)(bad)
        with pytest.raises(KeyError):
            getattr(torch_tokens.TokenParser, method)(bad)


@pytest.mark.parametrize("input_dim,out_proj", [(32, True), (32, False), (8, True)])
def test_fvq_vq2emb_and_get_emb_match_jax(input_dim, out_proj):
    cfg = QuantizerConfig(input_dim=input_dim, codebook_size=64, codebook_dim=8)
    p_jax = jax_fvq.init_fvq(jax.random.PRNGKey(0), cfg)
    p_torch = bicodec_state(p_jax, "cpu")  # the weights carried over as weights.py does
    vq = np.random.default_rng(1).integers(0, cfg.codebook_size, (2, 11))
    want = jax_fvq.fvq_vq2emb(p_jax, jnp.asarray(vq, jnp.int32), out_proj=out_proj)
    got = torch_fvq.fvq_vq2emb(p_torch, torch.from_numpy(vq), out_proj=out_proj)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EMB_TOL, atol=EMB_TOL)
    np.testing.assert_array_equal(torch_fvq.fvq_get_emb(p_torch).numpy(),
                                  np.asarray(jax_fvq.fvq_get_emb(p_jax)))


@pytest.mark.parametrize("v,k", [(166000, 50), (20000, 50), (4096, 50), (5001, 50), (3000, 2100)])
def test_topk_two_stage_is_exact(v, k):
    """Bit-equal values and indices to JAX's two-stage top-k, to
    `jax.lax.top_k` and to `torch.topk`, at the vocabulary, at widths that
    are not a multiple of 2048, and with k above the chunk (chunks of k).
    With k = 2100 most of the row is kept, and a float32 normal row of 3000
    holds a repeated value there, whose order the two libraries break
    differently: that case takes distinct values (a permutation)."""
    rng = np.random.default_rng(v)
    if k > 2048:
        x = rng.permutation(3 * v).reshape(3, v).astype(np.float32)
    else:
        x = rng.standard_normal((3, v)).astype(np.float32)
    got_v, got_i = torch_sample.topk_two_stage(torch.from_numpy(x), k)
    jv, ji = jax_sample.topk_two_stage(jnp.asarray(x), k)
    fv, fi = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = torch.topk(torch.from_numpy(x), k)
    for want_v, want_i in ((jv, ji), (fv, fi), (tv, ti)):
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("t,n_fft,hop", [(16000, 1024, 320), (4000, 512, 160), (777, 64, 16)])
def test_frame_signal_equals_jax(t, n_fft, hop):
    wav = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    got = torch_mel.frame_signal(torch.from_numpy(wav), n_fft, hop)
    want = jax_mel.frame_signal(jnp.asarray(wav), n_fft, hop)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_state_to_numpy_equals_jax():
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.BatchNorm1d(3),
                                 torch.nn.Conv1d(3, 2, 3))
    got = torch_checkpoint.torch_state_to_numpy(module)
    want = jax_checkpoint.torch_state_to_numpy(module)
    assert list(got) == list(want)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
