"""The port's benchmark package (`sparktts_tpu_torch/bench/`) against the
JAX package's, on the tiny config with the same weights.

One module-scoped pair of pipelines with the same weights (the port's on
the CPU from its random init, the JAX one fp32 from the port's trees).  The runners' cases of
`tests/test_bench_harness.py` (offline, streaming, continuous dense and
paged, gRPC over both transports, the local `save_to_disk` dataset) and
`tests/test_http_server.py::test_network_streaming_benchmark` run on the
port's pipeline; `_summarize`, `load_manifest` and `_distinct_shape_tasks`
equal JAX's on the same inputs; `mel_distance` within 1e-5 relative of
JAX's on broadband signals (1e-3 on pure tones, whose near-floor log bins
carry fp32 cancellation in both), `x_vector` within 1e-4 (of the largest element) with the same
speaker-encoder weights, `speaker_similarity` within 1e-5, and the ids
under `semantic_consistency` (tokenize of a wav and of its round trip)
equal to JAX's bit for bit, so the metric equal exactly.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.bench import harness as jh
from sparktts_tpu.bench import metrics as jm
from sparktts_tpu.config import MelParams as JaxMelParams
from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu_torch.bench import harness as th
from sparktts_tpu_torch.bench import metrics as tm
from sparktts_tpu_torch.bench import relay_probe
from sparktts_tpu_torch.config import MelParams, StreamingConfig
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.io.audio import write_wav
from sparktts_tpu_torch.pipeline import SparkTTSPipeline

HOST = "127.0.0.1"
MEL_REL_TOL = 1e-5
MEL_TONE_REL_TOL = 1e-3
XVEC_REL_TOL = 1e-4
SIM_TOL = 1e-5


def _wav(freq=200.0, seconds=1.0):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.2 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _tone(freq, seconds=1.0):
    t = np.arange(int(seconds * 16000)) / 16000
    return 0.3 * np.sin(2 * np.pi * freq * t)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file: under pytest-xdist
    each worker's own pool would oversubscribe the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    """The port's pipeline from its own random init, and the JAX pipeline
    with the same weights (its `_random_init` takes them from the port's
    trees instead of compiling ~140 init programs)."""
    tpipe = SparkTTSPipeline(config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32,
                             max_new_tokens=16, prompt_bucket=32)

    def same_weights(self, seed, lm_dtype):
        def jax_tree(tree):
            return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)

        self.llm_params = jax_tree(tpipe.llm_params)
        self.bicodec_params = jax_tree(tpipe.bicodec_params)
        self.w2v_params = jax_tree(tpipe.w2v_params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPipeline, "_random_init", same_weights)
        jpipe = JaxPipeline(config=tiny_test_config(), lm_dtype=jnp.float32, max_new_tokens=16,
                            prompt_bucket=32)
    return jpipe, tpipe


def test_offline_benchmark(pipes):
    tasks = [th.BenchTask(text=f"text {i}", prompt_wav=_wav()) for i in range(2)]
    stats = th.run_offline_benchmark(pipes[1], tasks, concurrency=2)
    assert stats["num_tasks"] == 2 and stats["mode"] == "offline"
    assert stats["rtf"] is not None and stats["rtf"] > 0
    assert stats["p50_latency_ms"] > 0
    assert stats["server_stats"]["requests"] == 2
    # the two clones took one batch through the fused clone path
    assert stats["stage_stats"]["llm_generate_vocode_fused"]["count"] >= 1


def test_streaming_benchmark(pipes):
    scfg = StreamingConfig(audio_chunk_duration=0.1, audio_chunk_overlap_duration=0.02)
    tasks = [th.BenchTask(text="hello", prompt_wav=_wav())]
    stats = th.run_streaming_benchmark(pipes[1], tasks, scfg)
    assert stats["num_tasks"] == 1 and stats["mode"] == "streaming"
    assert stats["first_chunk_p50_ms"] >= 0 and stats["rtf"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_continuous_benchmark_offline_and_streaming(pipes, paged):
    tasks = [th.BenchTask(text=f"text {i}", prompt_wav=_wav(), max_new_tokens=8 + 4 * (i % 2))
             for i in range(3)]
    stats = th.run_continuous_benchmark(pipes[1], tasks, concurrency=2, max_slots=4, paged=paged)
    assert stats["mode"] == "continuous_offline"
    assert stats["num_tasks"] == 3 and len(stats["per_task"]) == 3
    assert stats["rtf"] > 0 and stats["total_audio_s"] > 0
    stats_s = th.run_continuous_benchmark(pipes[1], tasks, concurrency=2, streaming=True,
                                          max_slots=4, paged=paged)
    assert stats_s["mode"] == "continuous_streaming"
    assert stats_s["num_tasks"] == 3
    assert stats_s["first_chunk_p50_ms"] > 0


def test_longform_benchmark(pipes):
    tasks = [th.BenchTask(text="one short part", prompt_wav=_wav(seconds=0.5))]
    stats = th.run_longform_benchmark(pipes[1], tasks, n_requests=1, segments=2, max_slots=2,
                                      segment_max_new_tokens=8)
    assert stats["mode"] == "continuous_streaming_longform"
    assert stats["num_tasks"] == 1 and stats["rtf"] > 0 and stats["first_chunk_p50_ms"] > 0


@pytest.mark.parametrize("transport", ["framed", "grpcio"])
def test_grpc_streaming_benchmark(pipes, transport):
    tasks = [th.BenchTask(text=f"grpc bench {i}", prompt_wav=_wav(), max_new_tokens=8)
             for i in range(2)]
    stats = th.run_grpc_streaming_benchmark(pipes[1], tasks, concurrency=2, transport=transport,
                                            max_slots=2, steps_per_dispatch=4)
    assert stats["mode"] == "grpc_streaming" and stats["transport"] == transport
    assert stats["num_tasks"] == 2
    assert stats["rtf"] > 0 and stats["total_audio_s"] > 0
    assert stats["first_chunk_p50_ms"] >= 0 and "stage_stats" in stats


def _healthy(port) -> bool:
    try:
        with urllib.request.urlopen(f"http://{HOST}:{port}/health", timeout=10) as resp:
            return resp.status == 200
    except urllib.error.HTTPError:
        return False


def test_network_streaming_benchmark(pipes):
    from sparktts_tpu_torch.serve.server import serve_http

    control = {}
    t = threading.Thread(target=lambda: serve_http(pipes[1], host=HOST, port=0, max_batch=2,
                                                   stream_steps_per_dispatch=4, control=control),
                         daemon=True)
    t.start()
    deadline = time.time() + 120
    while "stop" not in control and time.time() < deadline and t.is_alive():
        time.sleep(0.05)
    assert "stop" in control, "the server did not come up"
    try:
        port = control["httpd"].server_address[1]
        # the socket opens while the streaming server still starts: /health
        # answers 503 until it serves
        while not _healthy(port) and time.time() < deadline:
            time.sleep(0.05)
        tasks = [th.BenchTask(text=f"bench {i}", prompt_wav=_wav(240.0)) for i in range(2)]
        stats = th.run_network_streaming_benchmark(HOST, port, tasks, concurrency=2,
                                                   max_new_tokens=8)
        assert stats["num_tasks"] == 2
        assert stats["first_chunk_p50_ms"] > 0
        assert stats["mode"] == "network_streaming"
    finally:
        control["stop"]()
        t.join(timeout=30)


def test_load_hf_dataset_tasks(tmp_path):
    """seed_tts-protocol loading (reference client_grpc.py:641-658 field
    mapping) from a local save_to_disk dataset; nothing is fetched."""
    datasets = pytest.importorskip("datasets")
    sr = 8000
    rows = {
        "id": ["a", "b"],
        "prompt_text": ["ref one", "ref two"],
        "target_text": ["say one", "say two"],
        "prompt_audio": [
            {"array": np.ones(sr, np.float32) * 0.1, "sampling_rate": sr},
            {"array": np.ones(2 * sr, np.float32) * 0.2, "sampling_rate": sr},
        ],
    }
    path = str(tmp_path / "seed_like")
    datasets.Dataset.from_dict(rows).save_to_disk(path)
    tasks = th.load_hf_dataset_tasks(path, sample_rate=16000)
    want = jh.load_hf_dataset_tasks(path, sample_rate=16000)
    assert [t.text for t in tasks] == ["say one", "say two"]
    assert [t.prompt_text for t in tasks] == ["ref one", "ref two"]
    for got, ref in zip(tasks, want):
        np.testing.assert_allclose(got.prompt_wav, ref.prompt_wav, rtol=1e-6, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        th.load_hf_dataset_tasks(str(tmp_path / "not_there"))


def test_summarize_and_manifest_equal_jax(tmp_path):
    args = ([0.25, 0.5, 1.75, 0.125], 12.5, 3.0, {"mode": "x"})
    assert th._summarize(*args) == jh._summarize(*args)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        wav = None
        if i < 2:
            wav = tmp_path / f"ref{i}.wav"
            write_wav(wav, (0.1 * rng.standard_normal(8000 * (i + 1))).astype(np.float32), 8000)
        item = {"target_text": f"say {i}"}
        if wav is not None:
            item.update(reference_wav_path=str(wav), reference_text=f"ref {i}")
        lines.append(json.dumps(item))
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("\n".join(lines) + "\n\n")
    got, want = th.load_manifest(manifest), jh.load_manifest(manifest)
    assert [(t.text, t.prompt_text) for t in got] == [(t.text, t.prompt_text) for t in want]
    for g, w in zip(got, want):
        assert (g.prompt_wav is None) == (w.prompt_wav is None)
        if w.prompt_wav is not None:
            np.testing.assert_allclose(g.prompt_wav, w.prompt_wav, rtol=1e-6, atol=1e-6)


def test_distinct_shape_tasks_equal_jax(pipes):
    jpipe, tpipe = pipes
    tasks = [
        th.BenchTask(text="a", prompt_wav=_wav(seconds=0.5)),
        th.BenchTask(text="b", prompt_wav=_wav(seconds=0.9)),
        th.BenchTask(text="a much longer target text than the others " * 3,
                     prompt_wav=_wav(seconds=0.5)),
        th.BenchTask(text="c", prompt_wav=_wav(seconds=2.5), prompt_text="with words"),
        th.BenchTask(text="d", prompt_wav=_wav(seconds=2.5)),
        th.BenchTask(text="e", gender="male"),
        th.BenchTask(text="f", gender="female"),
        th.BenchTask(text="g", gender="female", max_new_tokens=8),
    ]
    jtasks = [jh.BenchTask(**dataclasses.asdict(t)) for t in tasks]
    got = [tasks.index(t) for t in th._distinct_shape_tasks(tpipe, tasks)]
    want = [jtasks.index(t) for t in jh._distinct_shape_tasks(jpipe, jtasks)]
    assert got == want and len(got) < len(tasks)


def _mel_pair(kind):
    rng = np.random.default_rng(0)
    a = 0.2 * rng.standard_normal(16000)
    return {"same_tone": (_tone(220), _tone(220)), "near_tones": (_tone(220), _tone(225)),
            "far_tones": (_tone(220), _tone(880)),
            "noise": (a, 0.2 * rng.standard_normal(16000)),
            "near_noise": (a, a + 0.01 * rng.standard_normal(16000))}[kind]


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kind", ["same_tone", "near_tones", "far_tones", "noise", "near_noise"])
def test_mel_distance_matches_jax(order, kind):
    """Broadband signals within MEL_REL_TOL of JAX's (both agree to ~2e-7);
    pure tones within MEL_TONE_REL_TOL: their leakage bins sit near the
    log floor, where fp32 cancellation in either package's DFT sums moves
    the log by ~1e-3 (near tones 4e-4 and 6e-4 apart, far tones 8e-6)."""
    a, b = _mel_pair(kind)
    got = tm.mel_distance(a, b, MelParams(num_mels=32), order=order, device="cpu")
    want = jm.mel_distance(a, b, JaxMelParams(num_mels=32), order=order)
    tol = MEL_TONE_REL_TOL if "tone" in kind else MEL_REL_TOL
    assert got == pytest.approx(want, rel=tol, abs=1e-7)
    if kind == "same_tone":
        assert got == 0.0


def test_mel_distance_orders_signals():
    a, near, far = _tone(220), _tone(225), _tone(880)
    mp = MelParams(num_mels=32)
    assert tm.mel_distance(a, near, mp, device="cpu") < tm.mel_distance(a, far, mp, device="cpu")


def test_speaker_metrics_match_jax(pipes):
    """x_vector within 1e-4 of JAX's largest element, speaker_similarity
    within 1e-5, and the JAX test's bounds (self-similarity 1, a different
    tone lower, consistency in [0, 1]).  semantic_consistency's ids are
    JAX's bit for bit: tokenize(wav), and tokenize of the round trip
    through detokenize, so the metric is JAX's exactly."""
    jpipe, tpipe = pipes
    a, b = _tone(220), _tone(700)
    for wav in (a, b):
        got, want = tm.x_vector(tpipe, wav), jm.x_vector(jpipe, wav)
        np.testing.assert_allclose(got, want, rtol=XVEC_REL_TOL,
                                   atol=XVEC_REL_TOL * np.abs(want).max())
    s_same, s_diff = tm.speaker_similarity(tpipe, a, a), tm.speaker_similarity(tpipe, a, b)
    assert s_same == pytest.approx(1.0, abs=1e-4) and -1.0 <= s_diff < s_same
    assert s_diff == pytest.approx(jm.speaker_similarity(jpipe, a, b), abs=SIM_TOL)
    wav = (0.2 * np.random.default_rng(3).standard_normal(16000)).astype(np.float32)
    ids = []
    for pipe in (tpipe, jpipe):
        g, s = pipe.tokenize_audio(wav)
        _, s2 = pipe.tokenize_audio(np.asarray(pipe.detokenize(g, s)))
        ids.append([np.asarray(t) for t in (g, s, s2)])
    for got, want in zip(*ids):
        np.testing.assert_array_equal(got, want)
    got = tm.semantic_consistency(tpipe, wav)
    assert 0.0 <= got <= 1.0
    assert got == jm.semantic_consistency(jpipe, wav)


def test_dispatch_probe_keys_and_record(monkeypatch):
    rec = relay_probe.measure_dispatch_tax(n=3, depth=4, device="cpu")
    assert rec["device"] == "cpu" and rec["chain_depth"] == 4 and rec["n"] == 3
    assert rec["roundtrip_ms"] >= 0 and rec["pipelined_ms"] >= 0
    assert rec["roundtrip_p10_ms"] <= rec["roundtrip_p90_ms"]
    out = relay_probe.bracket(lambda: 7, n=2, depth=2, device="cpu")
    assert out["result"] == 7 and out["before"]["label"] == "before"
    # the card by default: without one the probe raises, and its record
    # keeps the error instead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relay_probe.measure_dispatch_tax()
    assert "no CUDA device" in relay_probe.probe_record("x")["error"]
