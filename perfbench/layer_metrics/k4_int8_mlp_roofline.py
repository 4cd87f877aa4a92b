"""Kernel 4 (`int8_mlp_kernel`) against its bytes bound: each launch in the
trace slice reads the int8 gate/up and down, their fp32 scales and the
bf16 rows once and writes the rows once, at 3.35 TB/s; a decode unit runs
it over all the engine's slots.  The bound's sum over the kernel's device
time, in percent."""

from perfbench.harness.trace import kernel_seconds
from perfbench.roofline import counts


def read(records):
    tr = records["trace"]
    if tr is None:
        return None
    n, seconds = kernel_seconds(tr["kernels"], "int8_mlp_kernel")
    if not n or seconds <= 0:
        return None
    return 100.0 * n * counts.int8_mlp_bound_s(records["config"]["llm"], records["slots"]) / seconds
