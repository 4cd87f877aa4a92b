"""LM training step: fine-tuning the speech-token LM.

Port of `sparktts_tpu/lm/train.py`: next-token cross entropy over a loss
mask, AdamW (optax's `adamw` with its defaults: betas (0.9, 0.999), eps
1e-8, decay on every leaf), and a resumable train state.

The loss runs its own forward (`train_forward`): the serving forward
(`lm/qwen.qwen_forward`) writes each layer's K/V into one stacked cache in
place and reads the plane back, and the next layer's write then changes a
tensor autograd saved.  This forward gives the dense attention each layer's
fresh K/V and the causal bias over the T keys instead, from the same
pieces (`project_qkv`, `dense_attention`, `mlp_block`, `output_logits`), as
JAX's `lm_loss` runs the dense path.  No kernel is involved: the JAX
package has no backward kernel either.  Nothing here may run under
`torch.inference_mode`, whose tensors cannot be saved for backward.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from sparktts_tpu_torch.checkpoint import flatten_tree, load_param_cache, save_param_cache
from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm.qwen import (
    dense_attention,
    embed_lookup,
    mlp_block,
    output_logits,
    prefill_inputs,
    project_qkv,
    rope_cos_sin,
    unstack_layers,
)
from sparktts_tpu_torch.nn.layers import linear_apply, rms_norm_apply
from sparktts_tpu_torch.utils.platform import require_device
from sparktts_tpu_torch.parallel.mesh import tp_of
from sparktts_tpu_torch.weights import to_torch

Optimizer = Callable[[list], torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    params: dict  # fp32 leaves with requires_grad
    optimizer: torch.optim.Optimizer  # over the leaves of `params`
    step: int


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> Optimizer:
    """AdamW as optax's `adamw(learning_rate, weight_decay=weight_decay)`:
    a factory the train state calls on its leaves."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(params, optimizer: Optimizer, device="cuda") -> TrainState:
    """A train state over fresh fp32 copies of `params` (a tree of numpy
    arrays or tensors, on any device) on `device`."""
    device = require_device(device, "init_train_state")
    if torch.is_inference_mode_enabled():
        raise RuntimeError("init_train_state: called under torch.inference_mode")
    leaves = flatten_tree(params)[0]
    ints = [name for name, leaf in leaves.items() if not _is_float(leaf)]
    if ints:
        raise TypeError(f"init_train_state: non-float leaves {ints[:3]} (a quantized tree?)")
    tree = map_tree(to_torch(params, device, torch.float32),
                    lambda t: t.detach().clone().requires_grad_(True))
    return TrainState(params=tree, optimizer=optimizer(list(flatten_tree(tree)[0].values())),
                      step=0)


def _is_float(leaf) -> bool:
    return leaf.is_floating_point() if isinstance(leaf, torch.Tensor) else leaf.dtype.kind == "f"


def map_tree(tree, fn):
    """`fn` of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def _params_device(params) -> torch.device:
    return next(iter(flatten_tree(params)[0].values())).device


def train_forward(params, cfg: QwenConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) ids with no padding -> fp32 logits (B, T, V), causal dense
    attention over each layer's own K/V (no cache).  A whole tree: the
    train step on a mesh is not ported."""
    if tp_of(params) is not None:
        raise ValueError("train_forward takes a whole tree, not a tensor-parallel shard")
    b, t = input_ids.shape
    mask = torch.ones((b, t), dtype=torch.bool, device=input_ids.device)
    positions, bias = prefill_inputs(mask, t)
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    x = embed_lookup(params, input_ids)
    rope = rope_cos_sin(positions, cfg)
    for layer in unstack_layers(params["layers"]):
        y = rms_norm_apply(layer["ln1"], x, eps=cfg.rms_norm_eps)
        q, k, v = project_qkv(layer, y, rope, cfg)
        attn = dense_attention(q, k, v, bias).reshape(b, t, nh * hd).to(y.dtype)
        x = x + linear_apply(layer["o"], attn)
        y = rms_norm_apply(layer["ln2"], x, eps=cfg.rms_norm_eps)
        x = x + mlp_block(layer, y)
    x = rms_norm_apply(params["final_ln"], x, eps=cfg.rms_norm_eps)
    return output_logits(params, cfg, x)


def lm_loss(params, cfg: QwenConfig, input_ids, loss_mask) -> torch.Tensor:
    """Next-token cross entropy.  input_ids (B, T); loss_mask (B, T) True on
    the positions whose prediction counts (the speech-token region): the
    mean over them of -log p(ids[t + 1] | ids[:t + 1])."""
    dev = _params_device(params)
    ids = torch.as_tensor(input_ids, device=dev).long()
    m = torch.as_tensor(loss_mask, device=dev)[:, 1:].float()
    logp = torch.log_softmax(train_forward(params, cfg, ids)[:, :-1], dim=-1)
    nll = -logp.gather(-1, ids[:, 1:, None])[..., 0]
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def train_step(state: TrainState, cfg: QwenConfig, input_ids, loss_mask
               ) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step on the loss of (input_ids, loss_mask); the state is
    updated in place and returned with the step's loss (a detached scalar
    on the params' device)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = lm_loss(state.params, cfg, input_ids, loss_mask)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, loss.detach()


_MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def save_train_state(ckpt_dir: str | Path, state: TrainState) -> None:
    """Persist the params, AdamW's moments and step counts, and the step
    (one safetensors file, `checkpoint.save_param_cache`), for resumable
    fine-tuning."""
    names = flatten_tree(state.params)[0]
    tree = {"params": state.params, "step": torch.tensor(state.step, dtype=torch.int64)}
    opt = state.optimizer.state
    if all(leaf in opt for leaf in names.values()):
        tree["optimizer"] = {key: {name: opt[leaf][key] for name, leaf in names.items()}
                             for key in _MOMENTS}
    save_param_cache(ckpt_dir, tree)


def load_train_state(ckpt_dir: str | Path, optimizer: Optimizer,
                     device="cuda") -> Optional[TrainState]:
    """Restore a saved train state on `device`, each moment matched to its
    param by tree path; None if absent.  `optimizer` makes the optimizer
    (`make_optimizer`), whose state is then filled in."""
    device = require_device(device, "load_train_state")
    raw = load_param_cache(ckpt_dir)
    if raw is None:
        return None
    state = init_train_state(raw["params"], optimizer, device)
    state.step = int(raw["step"])
    if "optimizer" in raw:
        moments = raw["optimizer"]
        dev = _params_device(state.params)
        for name, leaf in flatten_tree(state.params)[0].items():
            state.optimizer.state[leaf] = {
                "step": moments["step"][name].clone(),  # AdamW keeps it on the host
                "exp_avg": moments["exp_avg"][name].to(dev, copy=True),
                "exp_avg_sq": moments["exp_avg_sq"][name].to(dev, copy=True),
            }
    return state
