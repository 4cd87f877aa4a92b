"""PyTorch/CUDA port of sparktts_tpu for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package (`config`, `prompt`, `nn/`, `lm/`,
`kernels/`, `codec/`, `pipeline`) and imports nothing of it: the JAX package
is the reference the tests hold this one against.  Every Pallas kernel on
the ported path is a CUDA kernel under `kernels/csrc/`, built for `sm_90a`
at first use.
"""
