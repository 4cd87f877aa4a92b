"""The port's CLI (`cli.py`), web UI (`webui.py`) and device choice
(`utils/platform.py`): the cases of `tests/test_cli.py` and
`tests/test_webui.py`, with the same stand-in gradio module.

Every case runs on the CPU (`--device cpu`, `device="cpu"`, or
SPARKTTS_PLATFORM=cpu) at the random-init tiny config, which the CLI takes
without `--model_dir`; one module-scoped pipeline serves the web UI's
callbacks.
"""

import sys
import types

import numpy as np
import pytest

from sparktts_tpu_torch.cli import load_pipeline, parse_args, run_tts
from sparktts_tpu_torch.io.audio import read_wav, write_wav
from sparktts_tpu_torch.utils.platform import apply_platform_env


@pytest.fixture(scope="module")
def prompt_wav(tmp_path_factory):
    sr = 16000
    t = np.arange(sr) / sr
    path = tmp_path_factory.mktemp("cli") / "p.wav"
    write_wav(path, 0.3 * np.sin(2 * np.pi * 180 * t), sr)
    return str(path)


@pytest.fixture(scope="module")
def pipe():
    return load_pipeline(None, max_new_tokens=16, device="cpu")


def test_parse_args_defaults():
    args = parse_args(["--text", "hi"])
    assert args.temperature == 0.8 and args.top_k == 50 and args.top_p == 0.95
    assert args.max_new_tokens == 3000 and args.max_segment_chars == 400
    assert args.device is None and not args.stream and not args.longform


def test_platform_env(monkeypatch):
    monkeypatch.delenv("SPARKTTS_PLATFORM", raising=False)
    assert apply_platform_env() == "cuda"
    monkeypatch.setenv("SPARKTTS_PLATFORM", "CPU")
    assert apply_platform_env() == "cpu"
    monkeypatch.setenv("SPARKTTS_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="SPARKTTS_PLATFORM"):
        apply_platform_env()


def _run(tmp_path, *extra):
    out = run_tts(parse_args(["--text", "hello. and more.", "--save_dir", str(tmp_path),
                              "--max_new_tokens", "12", "--device", "cpu", *extra]))
    assert out.endswith(".wav")
    wav, sr = read_wav(out)
    assert sr == 16000
    return wav


@pytest.mark.parametrize("mode", ["offline", "stream", "longform"])
def test_cli_voice_clone(prompt_wav, tmp_path, mode):
    extra = {"offline": [], "stream": ["--stream"],
             "longform": ["--longform", "--max_segment_chars", "8"]}[mode]
    _run(tmp_path, "--prompt_speech_path", prompt_wav, *extra)


def test_cli_controllable(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKTTS_PLATFORM", "cpu")  # the device from the environment
    out = run_tts(parse_args(["--text", "hello", "--gender", "male", "--pitch", "low",
                              "--speed", "high", "--save_dir", str(tmp_path),
                              "--max_new_tokens", "12"]))
    assert read_wav(out)[1] == 16000


def test_run_tts_clone_and_creation(pipe, prompt_wav, tmp_path):
    from sparktts_tpu_torch.webui import run_tts as web_run_tts

    wav, sr = read_wav(web_run_tts(pipe, "hello", prompt_speech=prompt_wav,
                                   save_dir=str(tmp_path)))
    assert sr == pipe.sample_rate and len(wav) > 0
    wav2, _ = read_wav(web_run_tts(pipe, "hello", gender="female", pitch="moderate",
                                   speed="high", save_dir=str(tmp_path)))
    assert len(wav2) > 0


def _make_gradio_stub(clicks):
    gr = types.ModuleType("gradio")

    class Component:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Button(Component):
        def click(self, fn, inputs=None, outputs=None):
            clicks.append((fn, inputs, outputs))

    for name in ("Blocks", "Tabs", "TabItem", "Row", "HTML", "Audio", "Textbox",
                 "Radio", "Slider"):
        setattr(gr, name, type(name, (Component,), {}))
    gr.Button = Button
    return gr


def test_build_ui_wires_two_tabs_and_callbacks_run(pipe, prompt_wav, tmp_path, monkeypatch):
    """build_ui under a stand-in gradio: both tab callbacks wired, each
    writing a playable wav through the real pipeline."""
    import sparktts_tpu_torch.webui as webui

    clicks = []
    monkeypatch.setitem(sys.modules, "gradio", _make_gradio_stub(clicks))
    orig_run_tts = webui.run_tts
    monkeypatch.setattr(webui, "run_tts", lambda model, text, **kw: orig_run_tts(
        model, text, **{**kw, "save_dir": str(tmp_path)}))
    monkeypatch.setattr(webui, "initialize_model", lambda *a, **k: pipe)
    demo = webui.build_ui(model_dir=None, max_new_tokens=16, device="cpu")
    assert demo is not None
    assert len(clicks) == 2, "expected one click handler per tab"
    voice_clone, clone_inputs, _ = clicks[0]
    assert len(clone_inputs) == 4  # text, prompt_text, upload, record
    assert len(read_wav(voice_clone("hi there", "", prompt_wav, None))[0]) > 0
    voice_creation, creation_inputs, _ = clicks[1]
    assert len(creation_inputs) == 4  # text, gender, pitch, speed
    assert len(read_wav(voice_creation("hi there", "male", 3, 4))[0]) > 0


def test_build_ui_without_gradio_raises_helpful_error(monkeypatch):
    import sparktts_tpu_torch.webui as webui

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is not installed"):
        webui.build_ui()
