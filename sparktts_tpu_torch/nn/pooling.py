"""Statistics pooling layers: TAP / TSDP / TSTP / ASTP / MHASTP / MQMHASTP.

Port of `sparktts_tpu/nn/pooling.py`.  The published Spark-TTS checkpoint
uses only ASTP with global context (`nn/ecapa.py`); the others complete the
set of `pooling_func`s an ECAPA variant can name.  Channels last: every
input is (B, T, F).  The torch model's 1x1 Conv1d attention stacks are
linears over the channel axis (`checkpoint._t_mhastp` / `_t_mqmhastp`
convert them).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from sparktts_tpu_torch.nn.ecapa import astp_apply  # noqa: F401  (the registry's ASTP)
from sparktts_tpu_torch.nn.layers import linear_apply
from sparktts_tpu_torch.weights import _Init


# ---------------------------------------------------------------------------
# parameter-free pools
# ---------------------------------------------------------------------------


def tap_apply(x: torch.Tensor) -> torch.Tensor:
    """Temporal average pooling: (B, T, F) -> (B, F)."""
    return x.mean(dim=1)


def tsdp_apply(x: torch.Tensor) -> torch.Tensor:
    """Temporal standard-deviation pooling (unbiased variance, as torch.var)."""
    return torch.sqrt(x.var(dim=1, unbiased=True) + 1e-7)


def tstp_apply(x: torch.Tensor) -> torch.Tensor:
    """Temporal statistics pooling: mean then std -> (B, 2F)."""
    return torch.cat([tap_apply(x), tsdp_apply(x)], dim=-1)


# ---------------------------------------------------------------------------
# MHASTP
# ---------------------------------------------------------------------------


def init_mhastp(
    in_dim: int,
    layer_num: int = 2,
    head_num: int = 2,
    d_s: int = 1,
    bottleneck_dim: int = 64,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> dict:
    """Multi-head attentive statistics pooling: per head, an MLP over each
    frame's channel chunk gives attention scores, softmaxed over time."""
    assert in_dim % head_num == 0
    d_model = in_dim // head_num
    d_s = d_model if d_s > 1 else 1
    dims = [bottleneck_dim] * (layer_num + 1)
    dims[0], dims[-1] = d_model, d_s
    ini = _Init(generator, device)
    return {"heads": [[ini.linear(dims[i], dims[i + 1]) for i in range(layer_num)]
                      for _ in range(head_num)]}


def mhastp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, F) -> (B, 2F); the heads attend over disjoint channel chunks."""
    head_num = len(p["heads"])
    outs: List[torch.Tensor] = []
    for head, chunk in zip(p["heads"], x.chunk(head_num, dim=-1)):
        score = chunk
        for i, lin in enumerate(head):
            score = linear_apply(lin, score)
            if i < len(head) - 1:
                score = torch.tanh(score)
        alpha = torch.softmax(score, dim=1)  # over time
        mean = (alpha * chunk).sum(dim=1)
        var = (alpha * chunk * chunk).sum(dim=1) - mean**2
        std = torch.sqrt(var.clamp_min(1e-7))
        outs.append(torch.cat([mean, std], dim=-1))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# MQMHASTP
# ---------------------------------------------------------------------------


def init_mqmhastp(
    in_dim: int,
    layer_num: int = 2,
    query_num: int = 2,
    head_num: int = 8,
    d_s: int = 2,
    bottleneck_dim: int = 64,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> dict:
    """Multi-query multi-head attentive statistics pooling."""
    return {"queries": [init_mhastp(in_dim, layer_num, head_num, d_s, bottleneck_dim,
                                    generator, device) for _ in range(query_num)]}


def mqmhastp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, F) -> (B, 2F * query_num)."""
    return torch.cat([mhastp_apply(q, x) for q in p["queries"]], dim=-1)


# ---------------------------------------------------------------------------
# registry (the torch model picks a pool by name)
# ---------------------------------------------------------------------------

POOLING_OUT_DIM = {
    "TAP": lambda d: d,
    "TSDP": lambda d: d,
    "TSTP": lambda d: 2 * d,
    "ASTP": lambda d: 2 * d,
    "MHASTP": lambda d: 2 * d,
    "MQMHASTP": lambda d, q=2: 2 * d * q,
}
