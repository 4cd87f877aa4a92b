"""The port's binding of the native host audio library
(`sparktts_tpu_torch/io/native.py`): the cases of `tests/test_native_audio.py`
against numpy and scipy, with the same tolerances, plus where it builds."""

import numpy as np
import pytest

from sparktts_tpu_torch.io import audio as A
from sparktts_tpu_torch.io import native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip(f"native audio library unavailable: {native.status()}")
    return lib


def test_native_resample_matches_scipy(lib):
    from scipy.signal import resample_poly

    rng = np.random.default_rng(0)
    x = rng.standard_normal(44100).astype(np.float64)
    for up, down in [(160, 441), (2, 1), (1, 2), (320, 441)]:
        ours = native.resample(x, up, down)
        ref = resample_poly(x, up, down)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-9)


def test_native_volume_normalize_matches_numpy(lib):
    rng = np.random.default_rng(1)
    x = 0.5 * rng.standard_normal(16000)
    ours = native.volume_normalize(x.copy())
    ref = A.audio_volume_normalize(x.copy())
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9)


def test_native_volume_normalize_quiet_signal(lib):
    rng = np.random.default_rng(2)
    x = 0.01 * rng.standard_normal(16000)
    ours = native.volume_normalize(x.copy())
    ref = A.audio_volume_normalize(x.copy())
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9)


def test_native_wav_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(3)
    wav = np.clip(0.8 * rng.standard_normal(8000), -1, 1)
    path = tmp_path / "t.wav"
    assert native.write_wav(path, wav, 16000)
    loaded = native.read_wav(path)
    assert loaded is not None
    audio, sr = loaded
    assert sr == 16000
    # PCM16 quantization + 32767/32768 scale asymmetry: ~6e-5 worst case
    np.testing.assert_allclose(audio, wav, atol=1e-4)


def test_native_read_matches_scipy_reader(lib, tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(4)
    wav16 = (np.clip(rng.standard_normal(4000), -1, 1) * 32767).astype(np.int16)
    path = tmp_path / "s.wav"
    wavfile.write(path, 22050, wav16)
    audio, sr = native.read_wav(path)
    assert sr == 22050
    np.testing.assert_allclose(audio, wav16.astype(np.float64) / 32768.0, atol=1e-9)


def test_load_audio_end_to_end(tmp_path):
    """load_audio through whichever path is active: resample + normalize."""
    from scipy.io import wavfile

    rng = np.random.default_rng(5)
    wav = (np.clip(0.5 * rng.standard_normal(44100), -1, 1) * 32767).astype(np.int16)
    path = tmp_path / "e.wav"
    wavfile.write(path, 44100, wav)
    out = A.load_audio(path, sampling_rate=16000, volume_normalize=True)
    assert abs(len(out) - 16000) <= 2
    assert np.abs(out).max() <= 1.0


def test_native_equals_the_jax_binding(lib):
    """The same source and flags as the JAX package's binding: the same
    numbers, bit for bit."""
    from sparktts_tpu.io import native as jax_native

    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    x = np.random.default_rng(6).standard_normal(22050)
    np.testing.assert_array_equal(native.resample(x, 160, 441), jax_native.resample(x, 160, 441))
    np.testing.assert_array_equal(native.volume_normalize(x), jax_native.volume_normalize(x))


def test_library_is_built_under_build_and_status_names_it(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.ROOT / "build" / "native"
    assert native.status() == f"native ({path})"
    assert A.backend().startswith("native")


def test_without_the_library_the_scipy_paths_run(monkeypatch, tmp_path):
    from scipy.signal import resample_poly

    monkeypatch.setattr(native, "get_lib", lambda: None)
    x = np.random.default_rng(7).standard_normal(4800)
    np.testing.assert_array_equal(A.resample(x, 48000, 16000), resample_poly(x, 1, 3))
    A.write_wav(tmp_path / "w.wav", 0.5 * x / np.abs(x).max(), 16000)
    back, sr = A.read_wav(tmp_path / "w.wav")
    assert sr == 16000 and back.shape == x.shape
