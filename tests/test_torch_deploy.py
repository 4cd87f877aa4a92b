"""The port's deploy path: `scripts/run_server_torch.py` and the staged
runbook `scripts/deploy_torch.sh`, on the CPU at the tiny config.

`run_server_torch.main` runs in a thread (its `control` stops it) with a
voices directory and a gRPC port: /health, an offline clone through the
client module, the registered voice through /v1/audio/speech and one gRPC
stream answer.  Its option set is `scripts/run_server.py`'s plus
`--device`, read from both `--help` outputs.  The runbook's six stages run
with SPARKTTS_PLATFORM=cpu and leave no server process behind.
"""

import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.serve import client as C

REPO = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"


def _free_port() -> int:
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _wav(freq=240.0, seconds=1.0):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _wait_healthy(port, thread, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not thread.is_alive():
            raise AssertionError("run_server_torch.main returned before it served")
        try:
            with urllib.request.urlopen(f"http://{HOST}:{port}/health", timeout=5) as r:
                if json.loads(r.read()) == {"healthy": True}:
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("the server never became healthy")


def test_run_server_torch_serves_a_checkpointless_tiny_pipeline(tmp_path):
    voices = tmp_path / "voices"
    voices.mkdir()
    write_wav(voices / "narrator.wav", _wav(300.0), 16000)
    port, grpc_port = _free_port(), _free_port()
    ctl: dict = {}
    server = _load_script("run_server_torch")
    thread = threading.Thread(target=server.main, daemon=True, kwargs=dict(
        argv=["--host", HOST, "--port", str(port), "--grpc_port", str(grpc_port),
              "--voices_dir", str(voices), "--voice_cache", "2", "--max_new_tokens", "16",
              "--device", "cpu"],
        control=ctl))
    thread.start()
    try:
        _wait_healthy(port, thread)
        wav, sr, _ = C.synthesize(HOST, port, "a deployed clone", prompt_wav=_wav(), timeout=120)
        assert sr == 16000 and wav.dtype == np.float32 and np.isfinite(wav).all()

        req = urllib.request.Request(
            f"http://{HOST}:{port}/v1/audio/speech",
            data=json.dumps({"input": "a named voice", "voice": "narrator"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
            body = resp.read()
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        pcm = np.frombuffer(body[44:], "<i2")
        assert np.isfinite(pcm.astype(np.float32)).all()
        with urllib.request.urlopen(f"http://{HOST}:{port}/v1/voices", timeout=10) as resp:
            names = [v["name"] for v in json.loads(resp.read())["voices"]]
        assert "narrator" in names

        from sparktts_tpu_torch.serve import grpc_server as G

        chunks = [c for c, rate in G.grpc_synthesize_stream(
            HOST, grpc_port, "over grpc", gender="male", pitch="moderate", speed="moderate")]
        assert all(np.isfinite(c).all() for c in chunks)
        G.close_cached_channels()
    finally:
        if "stop" in ctl:
            ctl["stop"]()
        thread.join(60)
    assert not thread.is_alive()


def _options(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])(--[a-z_]+)", help_text)) - {"--help"}


def test_run_server_torch_takes_run_server_options_plus_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu", SPARKTTS_COMPILE_CACHE="")
    outs = [subprocess.run([sys.executable, str(REPO / "scripts" / name), "--help"],
                           cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
            for name in ("run_server.py", "run_server_torch.py")]
    for out in outs:
        assert out.returncode == 0, out.stderr
    jax_opts, torch_opts = (_options(o.stdout) for o in outs)
    assert "--voices_dir" in jax_opts and "--grpc_port" in jax_opts
    assert torch_opts == jax_opts | {"--device"}


def test_deploy_runbook_runs_every_stage_on_the_cpu(tmp_path):
    env = dict(os.environ, SPARKTTS_PLATFORM="cpu", PORT=str(_free_port()),
               WORK=str(tmp_path / "work"))
    out = subprocess.run(["bash", str(REPO / "scripts" / "deploy_torch.sh"), "0", "5"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for stage in range(6):
        assert re.search(rf"^stage {stage} OK", out.stdout, re.M), out.stdout[-3000:]
        assert re.search(rf"^stage {stage} seconds: [0-9.]+$", out.stdout, re.M)
    assert "server stopped" in out.stdout
    pid = int((tmp_path / "work" / "server.pid").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    for name in ("smoke_offline.wav", "smoke_stream.wav", "bench.json"):
        assert (tmp_path / "work" / name).stat().st_size > 0
    assert json.loads((tmp_path / "work" / "artifacts" / "manifest.json").read_text())


def test_deploy_runbook_stops_its_server_when_a_stage_fails(tmp_path):
    """A stage that fails after the server started still stops it (the trap
    on its saved pid): stage 3 cannot write its prompt wav where a directory
    stands."""
    work = tmp_path / "work"
    (work / "prompt.wav").mkdir(parents=True)
    env = dict(os.environ, SPARKTTS_PLATFORM="cpu", PORT=str(_free_port()), WORK=str(work))
    out = subprocess.run(["bash", str(REPO / "scripts" / "deploy_torch.sh"), "2", "5"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert re.search(r"^stage 2 OK", out.stdout, re.M), out.stdout[-3000:] + out.stderr[-3000:]
    assert "stage 3 OK" not in out.stdout and "server stopped" in out.stdout
    pid = int((work / "server.pid").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
