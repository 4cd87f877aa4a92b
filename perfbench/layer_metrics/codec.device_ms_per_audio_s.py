"""Device milliseconds the codec decode takes per second of audio it emits,
in the trace slice: the busy time of the streams that ran the codec's
kernels (3 `unit_gemm`, 7 `codec_gemm`/`codec_fold`, 8 `depthwise_`; the
server's vocode stream, every kernel on it counted, the codec's elementwise
work too) over the seconds of audio the vocode calls emitted in the slice
(each call weighted by the share of its span inside).  Padded batch rows
are overhead, not audio."""

from perfbench.harness.trace import streams_busy_s

CODEC_KERNELS = ("unit_gemm", "codec_gemm", "codec_fold", "depthwise_")


def read(records):
    tr = records["trace"]
    if tr is None:
        return None
    audio_s = tr["vocoded_samples"] / records["sample_rate"]
    busy = streams_busy_s(tr, CODEC_KERNELS)
    if audio_s <= 0 or busy <= 0:
        return None
    return 1e3 * busy / audio_s
