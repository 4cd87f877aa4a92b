"""gRPC streaming front-end (role of the reference's Triton gRPC endpoint).

Port of `sparktts_tpu/serve/grpc_server.py`, over the port's
`ContinuousTTSServer`; `serve/protos/` is a copy of the JAX package's
messages, so clients of either package talk to servers of either.  This
module imports `google.protobuf` (and `grpc`, for the grpcio transport and
client); `serve/server.py` imports it only when a gRPC port is asked for.

The reference's production front door is Triton's decoupled gRPC streaming
(reference `runtime/triton_trtllm/client_grpc.py:332-433`: one request in, a
stream of waveform chunks out, terminated by a final flag).  This module
provides that surface in two transports over the SAME protobuf messages
(`serve/protos/sparktts.proto`) and the same continuous-batching backend:

  * `serve_grpc`      — a real grpcio server (generic RPC handlers, so no
    grpc_tools codegen is needed), used when the `grpc` package is
    installed.  Methods: /sparktts.SparkTTS/Synthesize (unary-unary) and
    /SynthesizeStream (unary-stream, decoupled-style).
  * `FramedSocketServer` — a dependency-free TCP transport speaking gRPC's
    DATA-frame message layout (1-byte compressed flag + 4-byte big-endian
    length + serialized protobuf) over a plain socket, preceded by one
    length-prefixed method path.  It keeps the streaming surface available
    (and testable through a real socket) in deployments without grpcio; the
    chunking/final-flag semantics are identical to the grpcio path.

Both transports drive one `ContinuousTTSServer`, so concurrent gRPC streams
share the inflight decode batch exactly like HTTP streams do.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import socketserver
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from sparktts_tpu_torch.serve.protos import sparktts_pb2 as pb

logger = logging.getLogger(__name__)

_STREAM_METHOD = "/sparktts.SparkTTS/SynthesizeStream"
_UNARY_METHOD = "/sparktts.SparkTTS/Synthesize"


def _request_kwargs(req: "pb.SynthesisRequest") -> dict:
    wav = None
    if req.prompt_wav:
        wav = np.frombuffer(req.prompt_wav, dtype="<f4").astype(np.float32)
    return dict(
        text=req.text,
        prompt_wav=wav,
        prompt_text=req.prompt_text or None,
        gender=req.gender or None,
        pitch=req.pitch or None,
        speed=req.speed or None,
        max_new_tokens=req.max_new_tokens or None,
    )


class _Backend:
    """Owns the asyncio ContinuousTTSServer on a private event-loop thread
    and exposes sync generators the transport handlers consume.

    Pass `cserver` + `loop` to ADOPT an already-running continuous server
    instead (e.g. `serve_http(grpc_port=...)`: HTTP and gRPC requests then
    join the SAME decode batch and share one KV pool); adopted servers are
    not stopped by close()."""

    def __init__(self, pipeline, cserver=None, loop=None, **server_kwargs):
        self.pipe = pipeline
        if cserver is not None:
            assert loop is not None, "adopting a cserver requires its loop"
            self.server, self.loop = cserver, loop
            self._owns = False
            self._thread = None
            return
        from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

        self.server = ContinuousTTSServer(pipeline, **server_kwargs)
        self.loop = asyncio.new_event_loop()
        self._owns = True
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(), self.loop).result()

    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def close(self):
        if not self._owns:
            return
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)

    def _longform_kwargs(self, req) -> dict:
        kw = _request_kwargs(req)
        if req.max_segment_chars:
            kw["max_segment_chars"] = int(req.max_segment_chars)
        return kw

    def synthesize(self, req: "pb.SynthesisRequest") -> "pb.AudioChunk":
        if req.longform:
            coro = self.server.synthesize_long(**self._longform_kwargs(req))
        else:
            coro = self.server.synthesize(**_request_kwargs(req))
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        wav = fut.result()
        return pb.AudioChunk(
            pcm=np.asarray(wav, np.float32).tobytes(),
            sample_rate=self.pipe.sample_rate,
            final=True,
        )

    def synthesize_stream(self, req: "pb.SynthesisRequest") -> Iterator["pb.AudioChunk"]:
        """Bridge the async chunk generator to a sync iterator: chunks cross
        threads through a queue fed by a coroutine on the backend loop.

        Closing the sync iterator (client disconnect) CANCELS the pump
        coroutine — cancellation closes the async generator, which marks the
        request cancelled so the continuous server's reap path frees its
        decode slot instead of synthesizing to budget end for nobody."""
        import queue as _q
        import time as _time

        out: _q.Queue = _q.Queue()
        t_handler = _time.perf_counter()

        async def pump():
            try:
                # transport-attribution stage: handler entry → the request
                # decoded and the backend coroutine actually running (thread
                # hop + proto decode + event-loop wakeup).  Lets a bench
                # separate "gRPC bridge cost" from the serving engine's own
                # first-chunk stages.
                self.server.stage_stats.record(
                    "grpc_bridge_in", _time.perf_counter() - t_handler
                )
                if req.longform:
                    agen = self.server.synthesize_streaming_long(
                        **self._longform_kwargs(req)
                    )
                else:
                    agen = self.server.synthesize_streaming(**_request_kwargs(req))
                async for chunk in agen:
                    out.put(("chunk", chunk))
                out.put(("done", None))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # surfaced as an error chunk, like Triton
                out.put(("error", e))

        pump_fut = asyncio.run_coroutine_threadsafe(pump(), self.loop)
        sr = self.pipe.sample_rate
        first = True
        try:
            while True:
                kind, payload = out.get()
                if kind == "chunk":
                    if first:
                        first = False
                        self.server.stage_stats.record(
                            "grpc_first_chunk_bridge",
                            _time.perf_counter() - t_handler,
                        )
                    yield pb.AudioChunk(
                        pcm=np.asarray(payload, np.float32).tobytes(), sample_rate=sr
                    )
                elif kind == "done":
                    yield pb.AudioChunk(sample_rate=sr, final=True)
                    return
                else:
                    yield pb.AudioChunk(sample_rate=sr, final=True, error=str(payload))
                    return
        finally:
            if not pump_fut.done():
                self.loop.call_soon_threadsafe(pump_fut.cancel)


# ---------------------------------------------------------------------------
# Transport 1: real grpcio (when installed)
# ---------------------------------------------------------------------------


def serve_grpc(
    pipeline,
    host: str = "0.0.0.0",
    port: int = 8001,
    max_workers: int = 8,
    **server_kwargs,
):
    """Start a grpcio server; returns (grpc_server, backend).  port=0 binds
    an ephemeral port — read it back from `grpc_server.bound_port` (avoids
    the pick-free-port TOCTOU race).  Raises ImportError when grpcio is not
    installed — callers can fall back to `FramedSocketServer` (same
    messages, same semantics)."""
    import grpc  # hard dependency of THIS transport only
    from concurrent import futures

    backend = _Backend(pipeline, **server_kwargs)

    def unary(request, context):
        return backend.synthesize(request)

    def stream(request, context):
        yield from backend.synthesize_stream(request)

    handler = grpc.method_handlers_generic_handler(
        "sparktts.SparkTTS",
        {
            "Synthesize": grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=pb.SynthesisRequest.FromString,
                response_serializer=pb.AudioChunk.SerializeToString,
            ),
            "SynthesizeStream": grpc.unary_stream_rpc_method_handler(
                stream,
                request_deserializer=pb.SynthesisRequest.FromString,
                response_serializer=pb.AudioChunk.SerializeToString,
            ),
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((handler,))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        backend.close()
        raise OSError(f"could not bind gRPC server to {host}:{port}")
    server.bound_port = bound  # actual port (== port unless port was 0)
    server.start()
    return server, backend


# ---------------------------------------------------------------------------
# Transport 2: stdlib socket with gRPC message framing
# ---------------------------------------------------------------------------


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = rfile.read(n - len(buf))
        if not got:
            raise ConnectionError("peer closed mid-frame")
        buf += got
    return buf


def _read_frame(rfile) -> bytes:
    header = _read_exact(rfile, 5)
    compressed, length = struct.unpack(">BI", header)
    if compressed:
        raise ValueError("compressed frames unsupported")
    return _read_exact(rfile, length)


def _write_frame(wfile, payload: bytes) -> None:
    wfile.write(struct.pack(">BI", 0, len(payload)) + payload)
    wfile.flush()


class FramedSocketServer:
    """Threaded TCP server speaking length-prefixed protobuf frames (gRPC's
    DATA-frame layout) — the dependency-free stand-in for the grpcio
    transport.  Wire protocol per connection:

        client → method path frame (UTF-8, e.g. "/sparktts.SparkTTS/SynthesizeStream")
        client → one SynthesisRequest frame
        server → AudioChunk frames … last one has final=true
    """

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 0, **server_kwargs):
        backend = self.backend = _Backend(pipeline, **server_kwargs)

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    method = _read_frame(self.rfile).decode()
                    req = pb.SynthesisRequest.FromString(_read_frame(self.rfile))
                    if method == _STREAM_METHOD:
                        for chunk in backend.synthesize_stream(req):
                            _write_frame(self.wfile, chunk.SerializeToString())
                    elif method == _UNARY_METHOD:
                        _write_frame(self.wfile, backend.synthesize(req).SerializeToString())
                    else:
                        err = pb.AudioChunk(final=True, error=f"unknown method {method}")
                        _write_frame(self.wfile, err.SerializeToString())
                except ConnectionError:
                    pass  # client went away — the stream consumer handles cleanup
                except Exception as e:
                    logger.exception("framed handler failed")
                    try:
                        _write_frame(
                            self.wfile,
                            pb.AudioChunk(final=True, error=str(e)).SerializeToString(),
                        )
                    except Exception:
                        pass

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.server = Server((host, port), Handler)
        self.host, self.port = self.server.server_address
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.backend.close()


# ---------------------------------------------------------------------------
# Client helpers (both transports)
# ---------------------------------------------------------------------------


def _build_request(
    text: str,
    prompt_wav: Optional[np.ndarray] = None,
    prompt_text: Optional[str] = None,
    gender: Optional[str] = None,
    pitch: Optional[str] = None,
    speed: Optional[str] = None,
    max_new_tokens: Optional[int] = None,
    longform: bool = False,
    max_segment_chars: Optional[int] = None,
) -> "pb.SynthesisRequest":
    return pb.SynthesisRequest(
        text=text,
        prompt_wav=b"" if prompt_wav is None else np.asarray(prompt_wav, "<f4").tobytes(),
        prompt_text=prompt_text or "",
        gender=gender or "",
        pitch=pitch or "",
        speed=speed or "",
        max_new_tokens=max_new_tokens or 0,
        longform=longform,
        max_segment_chars=max_segment_chars or 0,
    )


def framed_synthesize_stream(
    host: str, port: int, text: str, **kwargs
) -> Iterator[Tuple[np.ndarray, int]]:
    """Stream (chunk, sample_rate) pairs from a FramedSocketServer.  Raises
    RuntimeError when the final chunk carries an error."""
    req = _build_request(text, **kwargs)
    with socket.create_connection((host, port)) as sock:
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        _write_frame(wfile, _STREAM_METHOD.encode())
        _write_frame(wfile, req.SerializeToString())
        while True:
            chunk = pb.AudioChunk.FromString(_read_frame(rfile))
            if chunk.error:
                raise RuntimeError(chunk.error)
            if chunk.pcm:
                yield np.frombuffer(chunk.pcm, "<f4"), chunk.sample_rate
            if chunk.final:
                return


def framed_synthesize(host: str, port: int, text: str, **kwargs) -> Tuple[np.ndarray, int]:
    """Offline one-shot through the framed transport."""
    req = _build_request(text, **kwargs)
    with socket.create_connection((host, port)) as sock:
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        _write_frame(wfile, _UNARY_METHOD.encode())
        _write_frame(wfile, req.SerializeToString())
        chunk = pb.AudioChunk.FromString(_read_frame(rfile))
        if chunk.error:
            raise RuntimeError(chunk.error)
        return np.frombuffer(chunk.pcm, "<f4"), chunk.sample_rate


# One channel per (host, port), reused across calls and threads: gRPC
# channel establishment (TCP + HTTP/2 setup + subchannel readiness) costs
# tens of ms, which a channel per request would pay ON the first-chunk
# critical path of EVERY request.  The reference bench client opens one
# channel for its whole run too
# (`runtime/triton_trtllm/client_grpc.py:667-672`).  grpc channels are
# thread-safe; entries are evicted with close_cached_channels().
_CHANNEL_CACHE: dict = {}
_CHANNEL_LOCK = threading.Lock()


def _cached_channel(host: str, port: int):
    import grpc

    key = (host, int(port))
    with _CHANNEL_LOCK:
        ch = _CHANNEL_CACHE.get(key)
        if ch is None:
            ch = grpc.insecure_channel(f"{host}:{port}")
            _CHANNEL_CACHE[key] = ch
    return ch


def close_cached_channels() -> None:
    """Close and drop every cached client channel (benches tearing down
    ephemeral-port servers call this so the cache cannot hold stale
    connections to dead ports)."""
    with _CHANNEL_LOCK:
        for ch in _CHANNEL_CACHE.values():
            try:
                ch.close()
            except Exception:
                pass
        _CHANNEL_CACHE.clear()


def grpc_synthesize_stream(
    host: str, port: int, text: str, **kwargs
) -> Iterator[Tuple[np.ndarray, int]]:
    """Stream chunks from a grpcio `serve_grpc` server (requires grpcio).
    Reuses one cached channel per (host, port) — see _CHANNEL_CACHE."""
    req = _build_request(text, **kwargs)
    channel = _cached_channel(host, port)
    call = channel.unary_stream(
        _STREAM_METHOD,
        request_serializer=pb.SynthesisRequest.SerializeToString,
        response_deserializer=pb.AudioChunk.FromString,
    )
    for chunk in call(req):
        if chunk.error:
            raise RuntimeError(chunk.error)
        if chunk.pcm:
            yield np.frombuffer(chunk.pcm, "<f4"), chunk.sample_rate
        if chunk.final:
            return
