"""The trace slice's reduction: busy time as a union, each stream's busy
time, idle gaps named by the host span open at their middle, and the
per-layer readers that take the codec's streams and kernels from it."""

import pytest

from perfbench.harness import spec, trace


def _ev(name, ts, dur, stream, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": stream,
            "args": {"stream": stream}}


def _events():
    # device clock = host clock (us) + 1000; the marker at host 0.0
    return [
        _ev("spin_kernel", 1000.0, 5.0, 7),
        _ev("int8_mlp_kernel", 1100.0, 200.0, 7),  # LM stream: 100..300 host us
        _ev("elementwise", 1250.0, 100.0, 7),  # overlaps the last on its stream
        _ev("unit_gemm", 1200.0, 100.0, 9),  # vocode stream: 200..300
        _ev("elementwise", 1400.0, 50.0, 9),  # 400..450, unnamed codec work
        _ev("codec_gemm_kernel<1, 64>", 1600.0, 100.0, 9),  # 600..700
        _ev("outside", 5000.0, 10.0, 7),  # after the slice
    ]


def test_busy_streams_and_gaps():
    spans = [("dispatch", 450e-6, 600e-6)]
    red = trace.reduce_events(_events(), 0.0, 1000e-6, 0.0, spans)
    assert red["window_s"] == pytest.approx(1000e-6)
    # union: 100..350, 400..450, 600..700
    assert red["busy_s"] == pytest.approx(400e-6)
    assert red["stream_busy_s"] == {"7": pytest.approx(250e-6), "9": pytest.approx(250e-6)}
    assert red["kernels"]["elementwise"]["streams"] == [7, 9]
    assert red["idle_gaps"][0] == ["host", pytest.approx(300e-6)]  # 700..1000
    assert red["idle_gaps"][1] == ["dispatch", pytest.approx(150e-6)]  # 450..600
    assert trace.streams_busy_s(red, ("unit_gemm", "codec_gemm")) == pytest.approx(250e-6)


def test_codec_reader_takes_the_vocode_streams_work_per_audio_second():
    red = trace.reduce_events(_events(), 0.0, 1000e-6, 0.0, [])
    red["vocoded_samples"] = 16000.0 * 0.5
    records = {"trace": red, "sample_rate": 16000}
    got = spec.reader("codec.device_ms_per_audio_s")(records)
    assert got == pytest.approx(1e3 * 250e-6 / 0.5)
    red["vocoded_samples"] = 0.0
    assert spec.reader("codec.device_ms_per_audio_s")(records) is None
