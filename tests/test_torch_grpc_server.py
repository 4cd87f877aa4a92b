"""The port's gRPC front (`serve/grpc_server.py`): the cases of
`tests/test_grpc_server.py`, both transports.

One module-scoped `ContinuousTTSServer` (tiny config, fp32, a 2-token first
chunk) behind the framed socket transport, which the grpcio transport adopts
(`serve_grpc(cserver=..., loop=...)`): the same protobuf messages (a copy of
the JAX package's, so either package's client talks to either server),
chunked delivery with a final flag, longform, unary calls, concurrent
streams sharing the decode batch, an unknown method's error chunk, a dropped
client freeing its decode slot, and the cached grpc channels.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import StreamingConfig, tiny_test_config
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.serve.grpc_server import (
    FramedSocketServer,
    _read_frame,
    _write_frame,
    framed_synthesize,
    framed_synthesize_stream,
)
from sparktts_tpu_torch.serve.protos import sparktts_pb2 as pb


@pytest.fixture(scope="module")
def pipe():
    cfg = dataclasses.replace(
        tiny_test_config(),
        streaming=StreamingConfig(
            audio_chunk_duration=0.04,
            max_audio_chunk_duration=0.2,
            audio_chunk_size_scale_factor=2.0,
            audio_chunk_overlap_duration=0.0,
        ),
    )
    return SparkTTSPipeline(config=cfg, device="cpu", lm_dtype=torch.float32,
                            max_new_tokens=16, prompt_bucket=32)


@pytest.fixture(scope="module")
def server(pipe):
    srv = FramedSocketServer(pipe, max_slots=2, steps_per_dispatch=4)
    yield srv
    srv.close()


def _wav(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(n)).astype(np.float32)


def test_proto_roundtrip_and_the_jax_messages():
    from sparktts_tpu.serve.protos import sparktts_pb2 as jax_pb

    req = pb.SynthesisRequest(text="hi", prompt_wav=_wav().tobytes(), max_new_tokens=8,
                              longform=True, max_segment_chars=14)
    for parse in (pb.SynthesisRequest.FromString, jax_pb.SynthesisRequest.FromString):
        req2 = parse(req.SerializeToString())
        assert req2.text == "hi" and req2.max_new_tokens == 8 and req2.longform
        assert req2.max_segment_chars == 14
        np.testing.assert_array_equal(np.frombuffer(req2.prompt_wav, "<f4"), _wav())
    chunk = jax_pb.AudioChunk(pcm=b"\0" * 8, sample_rate=16000, final=True, error="e")
    assert pb.AudioChunk.FromString(chunk.SerializeToString()) == chunk


def test_streaming_through_real_socket(server, pipe):
    """Multiple chunks before the final flag, all audio finite."""
    chunks = list(framed_synthesize_stream(server.host, server.port, "stream over the wire",
                                           prompt_wav=_wav(1)))
    assert len(chunks) >= 2, "expected chunked (decoupled) delivery"
    total = np.concatenate([c for c, _ in chunks])
    assert total.size > 0 and np.isfinite(total).all()
    assert all(sr == pipe.sample_rate for _, sr in chunks)


def test_longform_streaming_through_real_socket(server, pipe):
    before = server.backend.server.stats.get("longform_segments", 0)
    chunks = list(framed_synthesize_stream(
        server.host, server.port, "seg one here. seg two here. seg three.",
        prompt_wav=_wav(3), longform=True, max_segment_chars=14))
    assert len(chunks) >= 2
    total = np.concatenate([c for c, _ in chunks])
    assert total.size > 0 and np.isfinite(total).all()
    assert server.backend.server.stats["longform_segments"] - before >= 2


@pytest.mark.parametrize("longform", [False, True])
def test_unary_through_real_socket(server, pipe, longform):
    kw = dict(longform=True, max_segment_chars=14) if longform else {}
    wav, sr = framed_synthesize(server.host, server.port,
                                "offline over the wire. and a second part.",
                                prompt_wav=_wav(2), **kw)
    assert wav.size > 0 and np.isfinite(wav).all() and sr == pipe.sample_rate


def test_concurrent_streams_share_batch(server):
    results = {}
    before = server.backend.server.stats["completed"]

    def one(name, seed):
        got = list(framed_synthesize_stream(server.host, server.port, f"concurrent {name}",
                                            prompt_wav=_wav(seed)))
        results[name] = np.concatenate([c for c, _ in got]) if got else np.zeros(0)

    threads = [threading.Thread(target=one, args=(f"t{i}", i)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(results) == {"t0", "t1"}
    assert sum(v.size for v in results.values()) > 0
    assert server.backend.server.stats["completed"] - before >= 2


def test_unknown_method_yields_error_chunk(server):
    with socket.create_connection((server.host, server.port)) as sock:
        r, w = sock.makefile("rb"), sock.makefile("wb")
        _write_frame(w, b"/sparktts.SparkTTS/NoSuchMethod")
        _write_frame(w, pb.SynthesisRequest(text="x").SerializeToString())
        chunk = pb.AudioChunk.FromString(_read_frame(r))
    assert chunk.final and "unknown method" in chunk.error


def test_grpcio_transport_shares_the_engine(pipe):
    """The grpcio transport adopts a running continuous server (its engine,
    loop and stats) and leaves it running when it stops.  The server is this
    test's own, as in the JAX package's test: the engine-wide generator then
    starts from its seed, so the two sampled clones are the same draws in
    every run.  On the module's shared server its state depended on how many
    dispatches earlier tests had run, and on the random tiny LM some states
    end a sampled clone before any semantic id (an empty stream).  The
    channel cache is process-wide: it starts empty here, so that a channel
    another test file left in this worker process does not count."""
    pytest.importorskip("grpc")
    from sparktts_tpu_torch.serve.grpc_server import (
        _CHANNEL_CACHE,
        close_cached_channels,
        grpc_synthesize_stream,
        serve_grpc,
    )

    close_cached_channels()
    server = FramedSocketServer(pipe, max_slots=2, steps_per_dispatch=4)
    backend = server.backend
    try:
        grpc_srv, adopted = serve_grpc(backend.pipe, host="127.0.0.1", port=0,
                                       cserver=backend.server, loop=backend.loop)
        before = backend.server.stats["requests"]
        try:
            for text in ("real grpc", "again on the cached channel"):
                chunks = list(grpc_synthesize_stream("127.0.0.1", grpc_srv.bound_port, text,
                                                     prompt_wav=_wav(3)))
                assert chunks and np.concatenate([c for c, _ in chunks]).size > 0
            assert len(_CHANNEL_CACHE) == 1
            assert backend.server.stats["requests"] - before == 2
        finally:
            grpc_srv.stop(0)
            adopted.close()  # an adopted server is not stopped
            close_cached_channels()
        assert not _CHANNEL_CACHE and backend.server._task is not None
    finally:
        server.close()


def test_client_disconnect_frees_decode_slot(server):
    """Dropping the socket mid-stream cancels the backend request (its slot
    reaped) instead of decoding to the budget's end for nobody."""
    backend = server.backend
    max_slots = len(backend.server.engine.owner)
    req = pb.SynthesisRequest(text="abandon me", prompt_wav=_wav(9).tobytes(), max_new_tokens=16)
    sock = socket.create_connection((server.host, server.port))
    r, w = sock.makefile("rb"), sock.makefile("wb")
    _write_frame(w, b"/sparktts.SparkTTS/SynthesizeStream")
    _write_frame(w, req.SerializeToString())
    chunk = pb.AudioChunk.FromString(_read_frame(r))
    assert not chunk.error
    sock.close()
    deadline = time.time() + 60
    while time.time() < deadline:
        if backend.server.engine.free_slots() == max_slots and not backend.server.inflight:
            break
        time.sleep(0.1)
    assert backend.server.engine.free_slots() == max_slots
    assert not backend.server.inflight
