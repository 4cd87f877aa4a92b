"""LM training step: fine-tuning the speech-token LM.

Port of `sparktts_tpu/lm/train.py`: next-token cross entropy over a loss
mask, AdamW (optax's `adamw` with its defaults: betas (0.9, 0.999), eps
1e-8, decay on every leaf), and a resumable train state.

The loss runs its own forward (`train_forward`): the serving forward
(`lm/qwen.qwen_forward`) writes each layer's K/V into one stacked cache in
place and reads the plane back, and the next layer's write then changes a
tensor autograd saved.  This forward gives the dense attention each layer's
fresh K/V and the causal bias over the T keys instead, from the same
pieces (`embed_lookup`, `project_qkv`, `dense_attention`, `row_parallel`,
`mlp_block`, `output_logits`), as JAX's `lm_loss` runs the dense path.  No kernel is involved: the JAX
package has no backward kernel either.  Nothing here may run under
`torch.inference_mode`, whose tensors cannot be saved for backward.

On a (dp, tp, pp) mesh (a tree placed by `parallel.shardings.place`) the
same step runs sharded, as JAX's `train_step` does under a mesh: tp through
the forward's autograd pairs (`parallel/autograd.py`, which `lm/qwen.py`'s
shard forward runs) and the vocab-parallel cross entropy, pp stage by stage (the hand-offs carry the
activations forward and their gradients back; like JAX's pp, which cuts the
layer axis, it runs no microbatch schedule), and dp over the rows of the
global batch.  The loss is JAX's loss over the global batch, sum(nll * m) /
sum(m) over every dp row: the mask count is all-reduced over the dp column
and the gradients are summed over it, not averaged.  A tied embedding's two
copies (first and last stage) take the sum of their gradients, so they
take the same AdamW update and stay equal.  Each rank then runs AdamW on
its own leaves, which equals AdamW on the whole tree (it acts element by
element; optax's `adamw` clips nothing globally).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from sparktts_tpu_torch.checkpoint import (flatten_tree, load_param_cache, save_param_cache,
                                           unflatten_tree)
from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm.qwen import (
    dense_attention,
    embed_lookup,
    mlp_block,
    output_logits,
    prefill_inputs,
    project_qkv,
    rope_cos_sin,
    row_parallel,
    shard_head_logits,
    unstack_layers,
)
from sparktts_tpu_torch.nn.layers import rms_norm_apply
from sparktts_tpu_torch.parallel.autograd import (copy_to_row, handoff_receive, handoff_send,
                                                  vocab_parallel_nll)
from sparktts_tpu_torch.parallel.mesh import Mesh, tp_of
from sparktts_tpu_torch.parallel.shardings import ShardedTree, place, shard_batch, unplace
from sparktts_tpu_torch.utils.platform import require_device
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
    arrays or tensors, on any device) on `device`; a placed tree
    (`shardings.place`) keeps its placement."""
    device = require_device(device, "init_train_state")
    if torch.is_inference_mode_enabled():
        raise RuntimeError("init_train_state: called under torch.inference_mode")
    leaves = flatten_tree(params)[0]
    ints = [name for name, leaf in leaves.items() if not _is_float(leaf)]
    if ints:
        raise TypeError(f"init_train_state: non-float leaves {ints[:3]} (a quantized tree?)")
    tree = map_tree(to_torch(params, device, torch.float32),
                    lambda t: t.detach().clone().requires_grad_(True))
    if isinstance(params, ShardedTree):
        tree = params.like(tree)
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


def _layers(params, cfg: QwenConfig, x: torch.Tensor) -> torch.Tensor:
    """The tree's layers over x (B, T, H), causal dense attention over each
    layer's own K/V; a shard's through its row's autograd pairs."""
    b, t, _ = x.shape
    mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    positions, bias = prefill_inputs(mask, t)
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    rope = rope_cos_sin(positions, cfg)
    tp = tp_of(params)
    for layer in unstack_layers(params["layers"]):
        y = rms_norm_apply(layer["ln1"], x, eps=cfg.rms_norm_eps)
        q, k, v = project_qkv(layer, y, rope, cfg, tp)
        attn = dense_attention(q, k, v, bias).reshape(b, t, nh * hd).to(y.dtype)
        x = x + row_parallel(layer["o"], attn, tp)
        y = rms_norm_apply(layer["ln2"], x, eps=cfg.rms_norm_eps)
        x = x + mlp_block(layer, y, tp=tp)
    return x


def train_forward(params, cfg: QwenConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) ids with no padding -> fp32 logits (B, T, V), causal dense
    attention over each layer's own K/V (no cache).  A whole tree; a placed
    tree's stages run in `lm_loss`."""
    if isinstance(params, ShardedTree):
        raise ValueError("train_forward takes a whole tree; lm_loss runs a placed one")
    x = _layers(params, cfg, embed_lookup(params, input_ids))
    x = rms_norm_apply(params["final_ln"], x, eps=cfg.rms_norm_eps)
    return output_logits(params, cfg, x)


def lm_loss(params, cfg: QwenConfig, input_ids, loss_mask) -> torch.Tensor:
    """Next-token cross entropy.  input_ids (B, T); loss_mask (B, T) True on
    the positions whose prediction counts (the speech-token region): the
    mean over them of -log p(ids[t + 1] | ids[:t + 1]).

    On a placed tree (`cfg` its part's config, `placed_config`) the ids and
    mask are the GLOBAL batch and this returns the rank's part of the loss:
    on the last stage, its dp rows' sum of nll * m over the whole batch's
    mask count (the parts of the dp column sum to the loss); on another
    stage a zero that carries the hand-off.  backward() on the part runs the
    rank's share of the backward; `compute_grads` adds the reductions."""
    dev = _params_device(params)
    if isinstance(params, ShardedTree):
        return _placed_loss(params, cfg, input_ids, loss_mask, dev)
    ids = torch.as_tensor(input_ids, device=dev).long()
    m = torch.as_tensor(loss_mask, device=dev)[:, 1:].float()
    logp = torch.log_softmax(train_forward(params, cfg, ids)[:, :-1], dim=-1)
    nll = -logp.gather(-1, ids[:, 1:, None])[..., 0]
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def _dp_rows(x, mesh: Mesh, device) -> torch.Tensor:
    """This rank's rows of a global (B, ...) batch."""
    return shard_batch(torch.as_tensor(x), mesh.dp_rank, mesh.shape["dp"]).to(device)


def _placed_loss(params: ShardedTree, cfg: QwenConfig, input_ids, loss_mask, dev):
    mesh, tp, pp = params.mesh, params.tp, params.pp
    ids = _dp_rows(input_ids, mesh, dev).long()
    if params.first:
        x = embed_lookup(params, ids)
    else:
        x = handoff_receive(pp, (*ids.shape, cfg.hidden_size),
                            params["layers"]["ln1"]["gamma"].dtype, dev)
    x = _layers(params, cfg, x)
    if not params.last:
        return handoff_send(x, pp)
    x = copy_to_row(rms_norm_apply(params["final_ln"], x, eps=cfg.rms_norm_eps), tp)
    logits = shard_head_logits(params, cfg, x)
    nll = vocab_parallel_nll(logits[:, :-1], ids[:, 1:], params.vocab[0], tp)
    m = _dp_rows(loss_mask, mesh, dev)[:, 1:].float()
    count = m.sum()
    if mesh.shape["dp"] > 1:
        dist.all_reduce(count, group=mesh.dp_group)
    return (nll * m).sum() / count.clamp_min(1.0)


def compute_grads(state: TrainState, cfg: QwenConfig, input_ids, loss_mask) -> torch.Tensor:
    """The loss of (input_ids, loss_mask) and its gradients in each leaf's
    `.grad` (added to what is there): `train_step` without the update.  On
    a mesh, in this order: the backward of every stage (the last stage's
    loss first, the hand-offs carrying the gradients back), this call's
    gradients summed over the dp column, a tied embedding's summed over the
    first and last stage, and then added to what was there (which is
    global already).  Returns the loss (detached; on a mesh the global
    batch's, the same on every rank)."""
    params = state.params
    if not isinstance(params, ShardedTree):
        part = lm_loss(params, cfg, input_ids, loss_mask)
        part.backward()
        return part.detach()
    mesh, pp = params.mesh, params.pp
    leaves = flatten_tree(params)[0]
    held = {name: leaf.grad for name, leaf in leaves.items()}
    for leaf in leaves.values():
        leaf.grad = None
    part = lm_loss(params, cfg, input_ids, loss_mask)
    part.backward()
    if mesh.shape["dp"] > 1:
        for leaf in leaves.values():
            dist.all_reduce(leaf.grad, group=mesh.dp_group)
    if pp is not None and cfg.tie_word_embeddings and (pp.first or pp.last):
        pp.sum_ends(params["embed"].grad)
    for name, leaf in leaves.items():
        if held[name] is not None:
            leaf.grad = held[name].add_(leaf.grad)
    loss = part.detach().clone()
    if params.last and mesh.shape["dp"] > 1:
        dist.all_reduce(loss, group=mesh.dp_group)
    return loss if pp is None else pp.share(loss)


def train_step(state: TrainState, cfg: QwenConfig, input_ids, loss_mask
               ) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step on the loss of (input_ids, loss_mask); the state is
    updated in place and returned with the step's loss (a detached scalar
    on the params' device).  On a mesh every rank calls it with the global
    batch and its placed state, and returns the global batch's loss."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = compute_grads(state, cfg, input_ids, loss_mask)
    state.optimizer.step()
    state.step += 1
    return state, loss


_MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def _state_tree(state: TrainState, host: bool = False) -> dict:
    """The params, the step and, once AdamW has stepped, its moments by
    leaf name ({key: {name: tensor}}); `host`: detached CPU copies."""
    names = flatten_tree(state.params)[0]
    move = (lambda t: t.detach().cpu()) if host else (lambda t: t)
    tree = {"params": map_tree(dict(state.params), move),
            "step": torch.tensor(state.step, dtype=torch.int64)}
    opt = state.optimizer.state
    if all(leaf in opt for leaf in names.values()):
        tree["optimizer"] = {key: {name: move(opt[leaf][key]) for name, leaf in names.items()}
                             for key in _MOMENTS}
    return tree


def _unplace_state(parts: dict, cfg: QwenConfig, grid) -> dict:
    """The whole state tree from every rank's `_state_tree` ({global rank:
    tree}): params and moments unplaced, every leaf's AdamW step the one
    step of the run."""
    first = parts[int(grid.reshape(-1)[0])]
    params = unplace({r: t["params"] for r, t in parts.items()}, cfg, grid)
    tree = {"params": params, "step": first["step"]}
    if "optimizer" in first:
        names, whole_shape = flatten_tree(params)
        shapes = {r: flatten_tree(t["params"])[1] for r, t in parts.items()}
        tree["optimizer"] = {
            key: flatten_tree(unplace({r: unflatten_tree(shapes[r], t["optimizer"][key])
                                       for r, t in parts.items()}, cfg, grid))[0]
            for key in ("exp_avg", "exp_avg_sq")}
        step = next(iter(first["optimizer"]["step"].values()))
        tree["optimizer"]["step"] = {name: step.clone() for name in names}
    return tree


def save_train_state(ckpt_dir: str | Path, state: TrainState) -> None:
    """Persist the params, AdamW's moments and step counts, and the step
    (one safetensors file, `checkpoint.save_param_cache`), for resumable
    fine-tuning.  A state on a mesh is saved whole, as JAX's save of sharded
    arrays writes whole arrays: every rank calls it, the mesh's first rank
    gathers every rank's part as host tensors over the mesh's gloo group
    (`Mesh.side`), unplaces them and writes the same single file."""
    params = state.params
    if not isinstance(params, ShardedTree):
        save_param_cache(ckpt_dir, _state_tree(state))
        return
    mesh = params.mesh
    ranks = [int(r) for r in mesh.grid.reshape(-1)]
    gathered = [None] * len(ranks) if mesh.rank == ranks[0] else None
    dist.gather_object(_state_tree(state, host=True), gathered, dst=ranks[0], group=mesh.side)
    if gathered is not None:
        save_param_cache(ckpt_dir, _unplace_state(dict(zip(ranks, gathered)), params.config,
                                                  mesh.grid))
    dist.barrier(group=mesh.side)


def load_train_state(ckpt_dir: str | Path, optimizer: Optimizer, device="cuda",
                     mesh: Optional[Mesh] = None,
                     cfg: Optional[QwenConfig] = None) -> Optional[TrainState]:
    """Restore a saved train state on `device`, each moment matched to its
    param by tree path; None if absent.  `optimizer` makes the optimizer
    (`make_optimizer`), whose state is then filled in.  With `mesh` (and
    `cfg`, the whole model's config) every rank of the mesh calls it and
    gets its part of the saved whole state (`place`)."""
    device = require_device(device, "load_train_state")
    raw = load_param_cache(ckpt_dir)
    if raw is None:
        return None
    params = raw["params"]
    if mesh is not None:
        params = place(params, cfg, mesh)
    state = init_train_state(params, optimizer, device)
    state.step = int(raw["step"])
    if "optimizer" in raw:
        moments = dict(raw["optimizer"])
        if mesh is not None:
            shape = flatten_tree(raw["params"])[1]
            for key in ("exp_avg", "exp_avg_sq"):
                moments[key] = flatten_tree(place(unflatten_tree(shape, moments[key]), cfg,
                                                  mesh))[0]
        dev = _params_device(state.params)
        for name, leaf in flatten_tree(state.params)[0].items():
            state.optimizer.state[leaf] = {
                "step": moments["step"][name].clone(),  # AdamW keeps it on the host
                "exp_avg": moments["exp_avg"][name].to(dev, copy=True),
                "exp_avg_sq": moments["exp_avg_sq"][name].to(dev, copy=True),
            }
    return state
