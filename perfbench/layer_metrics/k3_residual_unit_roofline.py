"""Kernel 3 (`unit_gemm`, two launches a residual unit) against its
operations bound: the residual units' 3xTF32 products for the audio the
vocode calls emitted in the trace slice (padded batch rows are overhead,
not work), at 495 TFLOP/s.
The bound over the kernel's device time, in percent."""

import math

from perfbench.harness.trace import kernel_seconds
from perfbench.roofline import counts


def read(records):
    tr = records["trace"]
    if tr is None:
        return None
    n, seconds = kernel_seconds(tr["kernels"], "unit_gemm")
    audio_s = tr["vocoded_samples"] / records["sample_rate"]
    if not n or seconds <= 0 or audio_s <= 0:
        return None
    bic = records["config"]["bicodec"]
    frame_rate = records["sample_rate"] / float(math.prod(bic["decoder"]["rates"]))
    flops = audio_s * counts.residual_units_flops_per_second(bic["decoder"], frame_rate)
    return 100.0 * flops / counts.TF32_FLOPS / seconds
