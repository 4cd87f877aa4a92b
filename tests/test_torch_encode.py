"""The port's codec encode side (voice cloning) against the JAX package.

Tiny config, fp32, inputs made with numpy from a seed, the same
JAX-initialised weights on both sides (passed through `weights.*_state`).
BatchNorm statistics and LayerNorm gains are randomised first, so that a
layout slip in them shows.

Tolerances: float outputs agree to 1e-4 (of the peak for the mel), the same
fp32 arithmetic summed in another order through a few layers; token ids are
equal.  Where ids come from a rounding (the FVQ argmax, the FSQ grid), the
latents that are rounded are also held within 1e-5, so that a near-tie
flipping an id would show as such.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from sparktts_tpu.codec import bicodec as jbicodec
from sparktts_tpu.codec import feat_encoder as jfeat
from sparktts_tpu.codec import fsq as jfsq
from sparktts_tpu.codec import fvq as jfvq
from sparktts_tpu.codec import speaker_encoder as jspk
from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.dsp import mel as jmel
from sparktts_tpu.io import audio as jaudio
from sparktts_tpu.nn import ecapa as jecapa
from sparktts_tpu.nn import layers as jl
from sparktts_tpu.nn import perceiver as jperc
from sparktts_tpu.nn import wav2vec2 as jw2v
from sparktts_tpu_torch.codec.bicodec import bicodec_tokenize
from sparktts_tpu_torch.codec.feat_encoder import feat_encoder_apply
from sparktts_tpu_torch.codec.fsq import residual_fsq_apply
from sparktts_tpu_torch.codec.fvq import fvq_tokenize
from sparktts_tpu_torch.codec.speaker_encoder import (
    speaker_encoder_latents,
    speaker_encoder_tokenize,
)
from sparktts_tpu_torch.config import MelParams
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.dsp.mel import make_mel_basis, mel_spectrogram
from sparktts_tpu_torch.io import audio as taudio
from sparktts_tpu_torch.nn import layers as tl
from sparktts_tpu_torch.nn.ecapa import ecapa_tdnn_apply
from sparktts_tpu_torch.nn.perceiver import perceiver_resampler_apply
from sparktts_tpu_torch.nn.wav2vec2 import feature_lengths, wav2vec2_features
from sparktts_tpu_torch.weights import bicodec_state, to_torch, wav2vec2_state

TOL = dict(rtol=1e-4, atol=1e-4)
LATENT_TOL = dict(rtol=1e-5, atol=1e-5)
JCFG, TCFG = tiny_test_config(), torch_tiny_config()


def _randomise_norms(tree, rng):
    """Non-trivial BatchNorm statistics and LayerNorm gains, in place."""
    if isinstance(tree, dict):
        if {"gamma", "beta", "mean", "var"} <= set(tree):
            n = tree["gamma"].shape
            tree.update(gamma=rng.uniform(0.5, 1.5, n), beta=0.1 * rng.standard_normal(n),
                        mean=0.1 * rng.standard_normal(n), var=rng.uniform(0.5, 1.5, n))
        elif set(tree) == {"gamma", "beta"}:
            n = tree["gamma"].shape
            tree.update(gamma=rng.uniform(0.5, 1.5, n), beta=0.1 * rng.standard_normal(n))
        else:
            for v in tree.values():
                _randomise_norms(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _randomise_norms(v, rng)
    return tree


def _trees(jax_params, seed=0):
    """(JAX tree, numpy tree) with the same randomised norms."""
    np_tree = jax.tree.map(lambda a: np.array(a, np.float32), jax_params)
    np_tree = _randomise_norms(np_tree, np.random.default_rng(seed))
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), np_tree)
    return jax.tree.map(jnp.asarray, np_tree), np_tree


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def bicodec():
    return _trees(jbicodec.init_bicodec(jax.random.PRNGKey(3), JCFG.bicodec), seed=3)


@pytest.mark.parametrize("num_mels,n_samples", [(32, 16000), (128, 9600)])
def test_mel_spectrogram_matches_jax(num_mels, n_samples):
    jb = jmel.make_mel_basis(jmel.MelParams(num_mels=num_mels))
    tb = make_mel_basis(MelParams(num_mels=num_mels))
    for name in ("window", "rfft_real", "rfft_imag", "mel_fb"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    wav = np.random.default_rng(0).standard_normal((2, n_samples)).astype(np.float32) * 0.3
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(wav), jb))
    got = mel_spectrogram(_t(wav), tb).numpy()
    assert got.shape == want.shape == (2, n_samples // 320 + 1, num_mels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_wav2vec2_features_with_padded_mask_matches_jax():
    jp, np_tree = _trees(jw2v.init_wav2vec2(jax.random.PRNGKey(1), JCFG.wav2vec2), seed=1)
    tp = wav2vec2_state(np_tree, "cpu")
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((2, 16000)).astype(np.float32)
    true_len = (16000, 9000)
    wav[1, true_len[1]:] = 0.0
    n_frames = feature_lengths(TCFG.wav2vec2, 16000)
    assert n_frames == jw2v.feature_lengths(JCFG.wav2vec2, 16000)
    mask = np.arange(n_frames)[None, :] < np.asarray(
        [feature_lengths(TCFG.wav2vec2, n) for n in true_len])[:, None]
    assert not mask[1].all()
    want = np.asarray(
        jw2v.wav2vec2_features(jp, jnp.asarray(wav), JCFG.wav2vec2, jnp.asarray(mask)))
    got = wav2vec2_features(tp, _t(wav), TCFG.wav2vec2, _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


LAYER_CASES = {
    "batch_norm": lambda m, p, x: m.batch_norm_apply(p, x),
    "l2norm_scale": lambda m, p, x: m.l2norm_scale_apply(p, x, 3.5),
    "gelu": lambda m, p, x: m.gelu(x),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_encode_layers_match_jax(name):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 12), "beta": rng.standard_normal(12),
         "mean": rng.standard_normal(12), "var": rng.uniform(0.5, 1.5, 12)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = LAYER_CASES[name](jl, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = LAYER_CASES[name](tl, to_torch(p, "cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ecapa_matches_jax(bicodec):
    jp, np_tree = bicodec
    j_ecapa = jp["speaker_encoder"]["speaker_encoder"]
    t_ecapa = to_torch(np_tree["speaker_encoder"]["speaker_encoder"], "cpu")
    mels = np.random.default_rng(4).standard_normal((2, 41, 32)).astype(np.float32)
    jx, jlat = jecapa.ecapa_tdnn_apply(j_ecapa, jnp.asarray(mels))
    tx, tlat = ecapa_tdnn_apply(t_ecapa, _t(mels))
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_perceiver_matches_jax(bicodec):
    jp, np_tree = bicodec
    cfg = TCFG.bicodec.speaker_encoder
    ctx = np.random.default_rng(5).standard_normal((2, 37, cfg.perceiver_dim_context))
    ctx = ctx.astype(np.float32)
    want = jperc.perceiver_resampler_apply(jp["speaker_encoder"]["perceiver_sampler"],
                                           jnp.asarray(ctx), cfg.perceiver_heads)
    tp = to_torch(np_tree["speaker_encoder"]["perceiver_sampler"], "cpu")
    got = perceiver_resampler_apply(tp, _t(ctx), cfg.perceiver_heads)
    assert got.shape == (2, cfg.token_num, cfg.latent_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("levels,num_quantizers,dim", [((4, 4, 4), 1, 16), ((8, 5, 5, 5), 2, 4)])
def test_residual_fsq_matches_jax(levels, num_quantizers, dim):
    np_tree = jax.tree.map(np.array, jfsq.init_residual_fsq(jax.random.PRNGKey(6), levels,
                                                             num_quantizers, dim))
    if "project_in" in np_tree:  # the init's 0.02 weights would put every latent mid-grid
        np_tree["project_in"]["w"] *= 50.0
    jp = jax.tree.map(jnp.asarray, np_tree)
    x = (2.0 * np.random.default_rng(6).standard_normal((3, 50, dim))).astype(np.float32)
    jq, jidx = jfsq.residual_fsq_apply(jp, jnp.asarray(x), levels, num_quantizers)
    tq, tidx = residual_fsq_apply(to_torch(np_tree, "cpu"), _t(x), levels, num_quantizers)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert len(np.unique(tidx.numpy())) > 10  # many codes, not one corner of the grid
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)


def test_feat_encoder_and_fvq_tokenize_match_jax(bicodec):
    jp, np_tree = bicodec
    tp = bicodec_state(np_tree, "cpu")
    feat = np.random.default_rng(7).standard_normal((2, 40, 64)).astype(np.float32)
    jz = jfeat.feat_encoder_apply(jp["encoder"], jnp.asarray(feat), JCFG.bicodec.encoder)
    tz = feat_encoder_apply(tp["encoder"], _t(feat), TCFG.bicodec.encoder)
    assert tz.shape == (2, 10, 48)  # downsampled by sample_ratios (2, 2)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **LATENT_TOL)
    want = np.asarray(jfvq.fvq_tokenize(jp["quantizer"], jz))
    got = fvq_tokenize(tp["quantizer"], tz).numpy()
    np.testing.assert_array_equal(got, want)


def test_speaker_encoder_tokenize_matches_jax(bicodec):
    jp, np_tree = bicodec
    tp = bicodec_state(np_tree, "cpu")
    jcfg, tcfg = JCFG.bicodec.speaker_encoder, TCFG.bicodec.speaker_encoder
    mels = np.abs(np.random.default_rng(8).standard_normal((2, 31, 32))).astype(np.float32)
    _, jlat = jspk._latents(jp["speaker_encoder"], jnp.asarray(mels), jcfg)
    tlat = speaker_encoder_latents(tp["speaker_encoder"], _t(mels), tcfg)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **LATENT_TOL)
    want = np.asarray(jspk.speaker_encoder_tokenize(jp["speaker_encoder"], jnp.asarray(mels), jcfg))
    got = speaker_encoder_tokenize(tp["speaker_encoder"], _t(mels), tcfg).numpy()
    assert got.shape == (2, tcfg.token_num)
    np.testing.assert_array_equal(got, want)


def test_bicodec_tokenize_matches_jax(bicodec):
    jp, np_tree = bicodec
    tp = bicodec_state(np_tree, "cpu")
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((1, 48, 64)).astype(np.float32)
    ref = (0.3 * rng.standard_normal((1, 96000))).astype(np.float32)
    jsem, jglob = jbicodec.bicodec_tokenize(jp, JCFG.bicodec, jnp.asarray(feat), jnp.asarray(ref))
    tsem, tglob = bicodec_tokenize(tp, TCFG.bicodec, _t(feat), _t(ref))
    np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    np.testing.assert_array_equal(tglob.numpy(), np.asarray(jglob))


def _tone(sr, seconds, amp=0.3, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    noise = 0.01 * np.random.default_rng(seed).standard_normal(t.size)
    return amp * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + noise


@pytest.mark.parametrize("volume_normalize", [False, True])
@pytest.mark.parametrize("amp", [0.5, 0.03])  # the quiet one takes the peak-rescale branch
def test_load_audio_matches_jax(tmp_path, volume_normalize, amp):
    path = tmp_path / "prompt.wav"
    taudio.write_wav(path, _tone(16000, 0.9, amp), 16000)
    got = taudio.load_audio(path, sampling_rate=16000, volume_normalize=volume_normalize)
    want = jaudio.load_audio(path, sampling_rate=16000, volume_normalize=volume_normalize)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    for seconds in (0.5, 6.0):  # tiled when shorter than the clip, cut when longer
        np.testing.assert_array_equal(taudio.get_ref_clip(got, 16000, seconds, 320),
                                      jaudio.get_ref_clip(want, 16000, seconds, 320))


def test_resample_matches_scipy(tmp_path, monkeypatch):
    """The scipy path (the native library, held to scipy in
    tests/test_torch_native_audio.py, is turned off here)."""
    from sparktts_tpu_torch.io import native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    wav = _tone(24000, 0.5)
    np.testing.assert_array_equal(taudio.resample(wav, 24000, 16000), resample_poly(wav, 2, 3))
    path = tmp_path / "p24k.wav"
    taudio.write_wav(path, wav, 24000)
    got = taudio.load_audio(path, sampling_rate=16000)
    read, _ = taudio.read_wav(path)
    np.testing.assert_array_equal(got, resample_poly(read, 2, 3))
    assert got.size == 8000
