"""The hand-written kernels as PyTorch custom ops, for exported programs.

`torch.export` traces Python, and a kernel launched through `ctypes` is
invisible to it: a trace would record nothing on the card, or on the CPU
the plain version in the kernel's place.  So kernels 2 to 5 are registered
here under the `sparktts_torch::` namespace, and their wrappers call the op
instead of launching while `torch.compiler.is_exporting()` is true: an
exported graph holds the op node, and a loaded program runs the op.

Each op's CUDA implementation calls the wrapper (which launches the kernel,
counts the launch, and raises on failure); its CPU implementation is the
plain version; its fake implementation gives the output's shape and dtype.
Arguments are tensors and scalars only (kernel 3's param dict travels as
its seven tensors).  Serving paths call the wrappers directly and never pay
the dispatcher.  Importing this module builds nothing: kernels are built at
their first launch.
"""

from __future__ import annotations

import torch

NAMESPACE = "sparktts_torch"


# ---------------------------------------------------------------------------
# kernel 2: dense-cache decode attention
# ---------------------------------------------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::dense_decode_attention", mutates_args=(),
                         device_types="cuda")
def dense_decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                           layer: int, start: torch.Tensor, pos: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    from sparktts_tpu_torch.kernels import decode_attention

    return decode_attention.dense_decode_attention(q.contiguous(), cache_k, cache_v, layer,
                                                   start.contiguous(), pos.contiguous(), sm_scale)


@dense_decode_attention.register_kernel("cpu")
def _(q, cache_k, cache_v, layer, start, pos, sm_scale):
    from sparktts_tpu_torch.kernels import decode_attention

    return decode_attention.dense_decode_plain(q, cache_k, cache_v, layer, start, pos, sm_scale)


@dense_decode_attention.register_fake
def _(q, cache_k, cache_v, layer, start, pos, sm_scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# kernel 3: the WaveGenerator's ResidualUnit
# ---------------------------------------------------------------------------


def _unit_params(alpha1, w1, b1, alpha2, w2, b2) -> dict:
    return {"snake1": {"alpha": alpha1}, "conv1": {"w": w1, "b": b1},
            "snake2": {"alpha": alpha2}, "conv2": {"w": w2, "b": b2}}


@torch.library.custom_op(f"{NAMESPACE}::fused_residual_unit", mutates_args=(),
                         device_types="cuda")
def fused_residual_unit(x: torch.Tensor, alpha1: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, alpha2: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, dilation: int) -> torch.Tensor:
    from sparktts_tpu_torch.kernels import vocoder_fusion

    return vocoder_fusion.fused_residual_unit(
        _unit_params(alpha1, w1, b1, alpha2, w2, b2), x.contiguous(), dilation)


@fused_residual_unit.register_kernel("cpu")
def _(x, alpha1, w1, b1, alpha2, w2, b2, dilation):
    from sparktts_tpu_torch.kernels import vocoder_fusion

    return vocoder_fusion.fused_residual_unit_plain(
        _unit_params(alpha1, w1, b1, alpha2, w2, b2), x, dilation)


@fused_residual_unit.register_fake
def _(x, alpha1, w1, b1, alpha2, w2, b2, dilation):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# kernel 4: the fused int8 SwiGLU MLP
# ---------------------------------------------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::int8_mlp_matvec", mutates_args=(), device_types="cuda")
def int8_mlp_matvec(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                    down_q: torch.Tensor, down_scale: torch.Tensor) -> torch.Tensor:
    from sparktts_tpu_torch.kernels import int8_mlp

    return int8_mlp.int8_mlp_matvec(x.contiguous(), gu_q, gu_scale, down_q, down_scale)


@int8_mlp_matvec.register_kernel("cpu")
def _(x, gu_q, gu_scale, down_q, down_scale):
    from sparktts_tpu_torch.kernels import int8_mlp

    return int8_mlp.int8_mlp_matvec_plain(x, gu_q, gu_scale, down_q, down_scale)


@int8_mlp_matvec.register_fake
def _(x, gu_q, gu_scale, down_q, down_scale):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# kernel 5: the grouped int4 matvec
# ---------------------------------------------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::int4_matvec", mutates_args=(), device_types="cuda")
def int4_matvec(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    from sparktts_tpu_torch.kernels import int4_matmul

    return int4_matmul.int4_matvec(x.contiguous(), packed, gscale)


@int4_matvec.register_kernel("cpu")
def _(x, packed, gscale):
    from sparktts_tpu_torch.kernels import int4_matmul

    return int4_matmul.int4_matvec_plain(x, packed, gscale)


@int4_matvec.register_fake
def _(x, packed, gscale):
    return x.new_empty((x.shape[0], packed.shape[1]))


def graph_ops(graph: torch.fx.Graph) -> dict:
    """{op name: count} of the `sparktts_torch::` op nodes in an FX graph."""
    counts: dict = {}
    for node in graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == NAMESPACE:
            name = node.target.name().split("::")[-1].split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts
