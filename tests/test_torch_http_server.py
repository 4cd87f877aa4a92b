"""The port's HTTP front door (`serve/server.serve_http`) over a real socket:
the cases of `tests/test_http_server.py` and `tests/test_openai_api.py`.

One module-scoped server (tiny config, fp32, a 2-token first chunk so that
a short generation streams several chunks), started with `warmup=True` and
a gRPC port, driven only through the port's client (`serve/client.py`),
`urllib` and `http.client`: /tts (clone, creation, longform), /tts_stream
(NDJSON, longform), the OpenAI /v1/audio/speech (wav and pcm, offline and
streamed, built-in and registered voices, automatic longform above
OPENAI_LONGFORM_AUTO_CHARS), /v1/voices, /v1/models, the Triton v2 infer
and health routes, /stats, /health, the UI page, every error status and
envelope, gRPC and HTTP streams sharing one engine, and `control["stop"]`
closing it all (the last test).  The network-streaming benchmark case of
`tests/test_http_server.py` is in `tests/test_torch_bench.py`.
"""

import base64
import dataclasses
import http.client
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import StreamingConfig, tiny_test_config
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.serve import client as C
from sparktts_tpu_torch.serve.server import OPENAI_LONGFORM_AUTO_CHARS, serve_http
from sparktts_tpu_torch.serve.voices import VoiceRegistry, openai_speed_level, wav_bytes

HOST = "127.0.0.1"


def _free_port() -> int:
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _prompt(freq=240.0, seconds=1.0):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture(scope="module")
def front():
    cfg = dataclasses.replace(
        tiny_test_config(),
        streaming=StreamingConfig(
            audio_chunk_duration=0.04,
            max_audio_chunk_duration=0.2,
            audio_chunk_size_scale_factor=2.0,
            audio_chunk_overlap_duration=0.0,
        ),
    )
    pipe = SparkTTSPipeline(config=cfg, device="cpu", lm_dtype=torch.float32,
                            max_new_tokens=12, prompt_bucket=32, voice_cache_size=4)
    control, grpc_port = {}, _free_port()
    t = threading.Thread(
        target=lambda: serve_http(pipe, host=HOST, port=0, max_batch=2,
                                  stream_steps_per_dispatch=4, warmup=True,
                                  grpc_port=grpc_port, control=control),
        daemon=True,
    )
    t.start()
    deadline = time.time() + 120
    while "stop" not in control and time.time() < deadline and t.is_alive():
        time.sleep(0.05)
    assert "stop" in control, "the server did not come up"
    port = control["httpd"].server_address[1]
    # the counters as warm-up left them, before any test's request
    after_warmup = dict(server=dict(control["server"].stats),
                        streaming=dict(control["cserver"].stats),
                        stages=control["cserver"].stage_stats.summary(),
                        admit_ready=len(control["cserver"].engine._admit_ready))
    yield dict(port=port, grpc_port=grpc_port, control=control, thread=t, pipe=pipe,
               after_warmup=after_warmup)
    if t.is_alive():
        control["stop"]()


def _request(port, path, payload=None, method="POST", raw=None):
    conn = http.client.HTTPConnection(HOST, port, timeout=300)
    body = raw if raw is not None else (json.dumps(payload).encode() if payload is not None
                                        else b"")
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, data


def _parse_wav(data: bytes):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    sr = struct.unpack_from("<I", data, 24)[0]
    return sr, np.frombuffer(data[44:], dtype="<i2")


def _stats(port):
    return C.get_stats(HOST, port)


# ------------------------------------------------------------- the native routes


def test_warmup_ran_then_reset_the_counters(front):
    w = front["after_warmup"]
    assert w["server"]["requests"] == 0 and w["server"]["batches"] == 0
    assert w["streaming"]["requests"] == 0 and w["streaming"]["completed"] == 0
    assert w["stages"] == {}
    assert w["admit_ready"] >= 1, "warm-up admitted no signature on the dense engine"


def test_http_roundtrip(front):
    wav, rate, stats = C.synthesize(HOST, front["port"], "hello over http",
                                    prompt_wav=_prompt())
    assert rate == 16000 and wav.size and np.isfinite(wav).all()
    assert "infer_ms" in stats and "queue_ms" in stats
    wav, rate, _ = C.synthesize(HOST, front["port"], "a creation", gender="male",
                                pitch="low", speed="high")
    assert rate == 16000 and wav.size and np.isfinite(wav).all()


def test_http_stats_and_health(front):
    stats = _stats(front["port"])
    assert stats["requests"] >= 1 and "streaming" in stats and "voice_cache" in stats
    with urllib.request.urlopen(f"http://{HOST}:{front['port']}/health", timeout=10) as r:
        assert json.loads(r.read())["healthy"] is True


def test_http_streaming_chunks(front):
    """>= 2 audio chunks over the chunked-transfer /tts_stream endpoint,
    ending with {"done": true} on the wire."""
    chunks = list(C.synthesize_stream(HOST, front["port"], "hello streaming",
                                      prompt_wav=_prompt(), max_new_tokens=48))
    assert len(chunks) >= 2
    assert all(rate == 16000 and np.isfinite(c).all() for c, rate in chunks)
    status, headers, data = _request(front["port"], "/tts_stream",
                                     {"text": "raw stream", "gender": "female",
                                      "pitch": "moderate", "speed": "moderate"})
    assert status == 200 and headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in data.decode().splitlines() if x.strip()]
    assert lines[-1] == {"done": True} and any("wav_b64" in x for x in lines)


def test_tts_longform_offline(front):
    before = _stats(front["port"])["streaming"].get("longform_segments", 0)
    status, _, data = _request(front["port"], "/tts", {
        "text": "one two three. four five six. seven eight nine.", "gender": "female",
        "pitch": "moderate", "speed": "moderate", "longform": True, "max_segment_chars": 16})
    assert status == 200
    body = json.loads(data)
    wav = np.frombuffer(base64.b64decode(body["wav_b64"]), np.float32)
    assert body["sample_rate"] == 16000 and wav.size and np.isfinite(wav).all()
    assert _stats(front["port"])["streaming"]["longform_segments"] - before >= 2


def _v2_input(name, datatype, data):
    arr = np.asarray(data, dtype=object if datatype == "BYTES" else None)
    return {"name": name, "shape": list(arr.shape), "datatype": datatype, "data": data}


def test_triton_v2_infer_endpoint(front):
    """The reference's own Triton v2 HTTP client payload works unchanged."""
    wav = (0.2 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    data = {"inputs": [
        _v2_input("reference_wav", "FP32", wav.reshape(1, -1).tolist()),
        _v2_input("reference_wav_len", "INT32", [[len(wav)]]),
        _v2_input("reference_text", "BYTES", ["reference words"]),
        _v2_input("target_text", "BYTES", ["hello from the v2 protocol"]),
    ]}
    status, _, body = _request(front["port"], "/v2/models/spark_tts/infer?request_id=0", data)
    assert status == 200
    result = json.loads(body)
    out = result["outputs"][0]
    assert result["model_name"] == "spark_tts"
    assert out["name"] == "waveform" and out["datatype"] == "FP32"
    audio = np.asarray(out["data"], np.float32)
    assert audio.size and np.isfinite(audio).all() and out["shape"] == [1, audio.size]
    for probe in ("/v2/health/ready", "/v2/health/live"):
        status, headers, body = _request(front["port"], probe, method="GET")
        assert status == 200 and headers["Content-Length"] == "0" and body == b""


def test_v2_endpoint_robustness(front):
    """Malformed v2 payloads get 400 (not a dropped connection); nested BYTES
    data works; an empty reference_text means no transcript."""
    port = front["port"]
    assert _request(port, "/v2/models/spark_tts/infer", [])[0] == 400
    assert _request(port, "/v2/models/spark_tts/infer", {"inputs": [
        _v2_input("reference_wav", "FP32", [[0.0, 0.0, 0.0, 0.0]]),
        {"name": "target_text", "shape": [1, 1], "datatype": "BYTES", "data": []},
    ]})[0] == 400
    wav = (0.2 * np.random.default_rng(1).standard_normal(16000)).astype(np.float32)
    for text in ([["nested text data"]], ["no transcript"]):
        inputs = [_v2_input("reference_wav", "FP32", wav.reshape(1, -1).tolist()),
                  {"name": "target_text", "shape": [1, 1], "datatype": "BYTES",
                   "data": text}]
        if text == ["no transcript"]:
            inputs.append({"name": "reference_text", "shape": [1, 1], "datatype": "BYTES",
                           "data": [""]})
        status, _, body = _request(port, "/v2/models/spark_tts/infer", {"inputs": inputs})
        assert status == 200 and len(json.loads(body)["outputs"][0]["data"]) > 0


@pytest.mark.parametrize("path", ["/tts", "/tts_stream"])
def test_bad_payloads_get_400_json(front, path):
    port = front["port"]
    cases = [
        (b"{not json", "bad request"),
        (b"[1, 2]", "JSON object"),
        (json.dumps({"prompt_wav_b64": "AAAA"}).encode(), '"text"'),
        (json.dumps({"text": "hi", "prompt_wav_b64": "!!!not-base64!!!"}).encode(),
         "bad request"),
    ]
    for raw, needle in cases:
        status, headers, data = _request(port, path, raw=raw)
        assert status == 400 and headers["Content-Type"] == "application/json"
        assert needle in json.loads(data)["error"]


def test_unknown_routes_get_404_json(front):
    port = front["port"]
    for method, path, payload in (("GET", "/nope", None), ("POST", "/nope", {"text": "x"}),
                                  ("DELETE", "/nope", None)):
        status, _, data = _request(port, path, payload, method=method)
        assert status == 404 and json.loads(data) == {"error": "not found"}


def test_http_bad_request_does_not_poison_cobatched_neighbor(front):
    """A request with unusable prompt audio fails ALONE (500 JSON); a good
    request sharing its batching window still synthesizes."""
    results = {}

    def post(name, payload):
        results[name] = _request(front["port"], "/tts", payload)

    good_wav = (0.1 * np.sin(np.arange(4000) / 10)).astype(np.float32)
    bad = {"text": "bad", "prompt_wav_b64": base64.b64encode(b"").decode()}
    good = {"text": "good", "prompt_wav_b64": base64.b64encode(good_wav.tobytes()).decode()}
    threads = [threading.Thread(target=post, args=a) for a in (("bad", bad), ("good", good))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results["bad"][0] == 500 and "empty prompt audio" in json.loads(results["bad"][2])["error"]
    assert results["good"][0] == 200 and "wav_b64" in json.loads(results["good"][2])


def test_native_ui_page(front):
    with urllib.request.urlopen(f"http://{HOST}:{front['port']}/", timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/html")
        page = r.read().decode()
    assert "Voice Clone" in page and "Voice Creation" in page
    assert "const SR = 16000" in page
    for level in ("very_low", "moderate", "very_high"):
        assert level in page
    assert "/tts_stream" in page and '"/tts"' in page
    assert "clone-longform" in page and "create-longform" in page


def test_profiling_stats():
    from sparktts_tpu_torch.utils.profiling import StageStats, stage

    s = StageStats()
    with stage("x", s):
        time.sleep(0.01)
    with stage("x", s):
        pass
    summary = s.summary()
    assert summary["x"]["count"] == 2 and summary["x"]["max_ms"] >= 10
    assert "x" in s.report()


def test_http_and_grpc_share_one_engine(front):
    """gRPC (grpcio) and HTTP streams land in the same continuous engine:
    both show in the shared /stats streaming counters."""
    pytest.importorskip("grpc")
    from sparktts_tpu_torch.serve.grpc_server import close_cached_channels, grpc_synthesize_stream

    before = _stats(front["port"])["streaming"]
    wav = np.zeros(4000, np.float32)
    wav[::50] = 0.2
    try:
        chunks = list(grpc_synthesize_stream(HOST, front["grpc_port"], "over grpc",
                                             prompt_wav=wav))
    finally:
        close_cached_channels()  # the process-wide cache: leave no channel to this front
    assert chunks and np.isfinite(np.concatenate([c for c, _ in chunks])).all()
    got = list(C.synthesize_stream(HOST, front["port"], "over http", prompt_wav=wav))
    assert got and all(np.isfinite(c).all() for c, _ in got)
    after = _stats(front["port"])["streaming"]
    assert after["requests"] - before["requests"] == 2
    assert after["completed"] - before["completed"] == 2


# ------------------------------------------------------- the OpenAI surface


@pytest.mark.parametrize("response_format", ["wav", "pcm"])
def test_speech_offline(front, response_format):
    status, headers, data = _request(front["port"], "/v1/audio/speech", {
        "input": "hello openai surface", "voice": "female", "speed": 1.0,
        "response_format": response_format})
    assert status == 200 and headers["Content-Type"] == f"audio/{response_format}"
    if response_format == "wav":
        sr, pcm = _parse_wav(data)
        assert sr == 16000 and len(pcm) > 0
        assert struct.unpack_from("<I", data, 4)[0] == len(data) - 8
    else:
        assert len(data) > 0 and len(data) % 2 == 0


@pytest.mark.parametrize("response_format", ["wav", "pcm"])
def test_speech_streamed(front, response_format):
    """A streamed creation request answers chunked audio.  The continuous
    engine's generator is engine-wide, so a free draw depends on how many
    dispatches earlier requests ran, and with random weights about 1 draw
    in 15 ends before any semantic id (no audio).  A top_p near 0 keeps
    only the most likely token, so this request's ids do not depend on the
    generator: 12 semantic ids on the tiny model."""
    status, headers, data = _request(front["port"], "/v1/audio/speech", {
        "input": "stream me", "voice": "male", "stream": True, "top_p": 1e-6,
        "response_format": response_format})
    assert status == 200 and headers["Content-Type"] == f"audio/{response_format}"
    assert headers.get("Transfer-Encoding") == "chunked"
    if response_format == "wav":
        assert data[:4] == b"RIFF"
        data = data[44:]
    assert len(np.frombuffer(data, dtype="<i2")) > 0


def test_voice_register_clone_delete(front):
    port = front["port"]
    status, _, data = _request(port, "/v1/voices", {
        "name": "narrator", "wav_b64": base64.b64encode(_prompt().tobytes()).decode()})
    assert status == 200 and json.loads(data) == {"name": "narrator", "duration_s": 1.0}
    status, _, data = _request(port, "/v1/voices", method="GET")
    voices = {v["name"]: v for v in json.loads(data)["voices"]}
    assert {"female", "male", "narrator"} <= set(voices)
    assert voices["narrator"]["kind"] == "clone"
    status, _, data = _request(port, "/v1/audio/speech",
                               {"input": "cloned by name", "voice": "narrator"})
    assert status == 200 and len(_parse_wav(data)[1]) > 0
    assert _request(port, "/v1/voices/narrator", method="DELETE")[0] == 200
    status, _, data = _request(port, "/v1/audio/speech", {"input": "gone", "voice": "narrator"})
    assert status == 404
    err = json.loads(data)["error"]
    assert err["type"] == "invalid_request_error" and "narrator" in err["message"]
    status, _, data = _request(port, "/v1/voices/narrator", method="DELETE")
    assert status == 404 and "narrator" in json.loads(data)["error"]["message"]
    status, _, data = _request(port, "/v1/voices", {
        "name": "female", "wav_b64": base64.b64encode(np.ones(4, np.float32).tobytes()).decode()})
    assert status == 400 and "built-in" in json.loads(data)["error"]["message"]


@pytest.mark.parametrize("payload, needle", [
    ({"voice": "female"}, "input"),
    ({"input": "x", "response_format": "opus"}, "response_format"),
    ({"input": "x", "speed": 9.0}, "speed"),
])
def test_openai_error_envelope(front, payload, needle):
    status, _, data = _request(front["port"], "/v1/audio/speech", payload)
    assert status == 400
    err = json.loads(data)["error"]
    assert err["type"] == "invalid_request_error" and needle in err["message"]
    assert err["code"] is None


def test_openai_longform_explicit(front):
    before = _stats(front["port"])["streaming"].get("longform_segments", 0)
    status, _, data = _request(front["port"], "/v1/audio/speech", {
        "input": "one two three. four five six. seven eight nine.", "voice": "female",
        "longform": True, "max_segment_chars": 16})
    assert status == 200 and len(_parse_wav(data)[1]) > 0
    assert _stats(front["port"])["streaming"]["longform_segments"] - before >= 2


def test_openai_longform_automatic_above_600_chars(front):
    text = " ".join(f"Sentence number {i} is here." for i in range(30))
    assert len(text) > OPENAI_LONGFORM_AUTO_CHARS
    before = _stats(front["port"])["streaming"].get("longform_segments", 0)
    status, _, data = _request(front["port"], "/v1/audio/speech", {
        "input": text, "voice": "male", "max_segment_chars": 60})
    assert status == 200 and len(_parse_wav(data)[1]) > 0
    assert _stats(front["port"])["streaming"]["longform_segments"] - before >= 10


def test_tts_stream_longform_ndjson(front):
    status, _, data = _request(front["port"], "/tts_stream", {
        "text": "alpha beta. gamma delta. epsilon zeta.",
        "prompt_wav_b64": base64.b64encode(_prompt(200.0).tobytes()).decode(),
        "longform": True, "max_segment_chars": 14})
    assert status == 200
    lines = [json.loads(x) for x in data.decode().splitlines() if x.strip()]
    assert lines[-1] == {"done": True}
    assert len([x for x in lines if "wav_b64" in x]) >= 2


def test_models_listing(front):
    status, _, data = _request(front["port"], "/v1/models", method="GET")
    body = json.loads(data)
    assert status == 200 and body["object"] == "list" and body["data"][0]["id"] == "spark-tts"


def test_speed_level_mapping():
    assert openai_speed_level(0.25) == "very_low"
    assert openai_speed_level(1.0) == "moderate"
    assert openai_speed_level(4.0) == "very_high"
    with pytest.raises(ValueError):
        openai_speed_level(0.1)


def test_registry_limits_and_builtin_collision():
    reg = VoiceRegistry(max_voices=1)
    wav = np.zeros(16, np.float32)
    with pytest.raises(ValueError):
        reg.register("female", wav)
    reg.register("a", wav)
    reg.register("a", np.ones(16, np.float32))
    with pytest.raises(ValueError):
        reg.register("b", wav)
    assert reg.remove("a") and not reg.remove("a")


def test_wav_bytes_roundtrip():
    audio = np.sin(np.linspace(0, 20, 400)).astype(np.float32) * 0.5
    sr2, pcm = _parse_wav(wav_bytes(audio, 8000))
    assert sr2 == 8000 and len(pcm) == len(audio)
    np.testing.assert_allclose(pcm / 32767.0, audio, atol=2e-4)


# ------------------------------------------------------------------ shutdown


def test_stop_closes_everything(front):
    """control["stop"]: the HTTP and gRPC sockets refuse, serve_http returns,
    the loop thread ends and the loop is closed, and the streaming engine's
    decode units are gone."""
    ctl = front["control"]
    ctl["stop"]()
    front["thread"].join(10)
    assert not front["thread"].is_alive()
    assert ctl["loop"].is_closed()
    assert len(ctl["cserver"].engine.units) == 0 and not ctl["cserver"]._units_warm
    for port in (front["port"], front["grpc_port"]):
        with pytest.raises(OSError):
            socket.create_connection((HOST, port), timeout=2).close()
