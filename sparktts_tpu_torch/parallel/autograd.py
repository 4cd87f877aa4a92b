"""Collectives that autograd passes through: the train step on a mesh.

JAX differentiates the sharded program and GSPMD inserts the collectives
of the backward pass.  Here the forward does its collectives itself, and
the tp forward of `lm/qwen.py` runs them through Megatron's pairs, which
the train step (`lm/train.py`) differentiates:

  * `copy_to_row`: identity forward, the gradient all-reduced over the row
    backward.  Before a column-parallel linear (`qkv`, `gateup`) and the
    vocab-parallel head: each rank's columns give only their part of the
    input's gradient.
  * `reduce_from_row`: all-reduce forward, identity backward.  After a
    row-parallel linear (`o`, `down`) and the masked embedding lookup.
    (`torch.distributed.nn.functional.all_reduce` would all-reduce the
    gradient too, and with the loss replicated on every rank of the row
    that multiplies every gradient before o and down by tp.)
  * `handoff_send` / `handoff_receive`: a stage's output goes forward to
    the next stage, and its gradient comes back.  The sender's result is a
    zero scalar that carries the hand-off: `backward()` on it receives the
    next stage's gradient and runs the stage's backward.
  * `vocab_parallel_nll`: cross entropy over logits cut by vocabulary rows
    over the row: the max and the sum of exponentials all-reduced, the
    target's logit from the rank that owns its row; the backward touches
    only the rank's own columns.

Where autograd records nothing (the serving forward runs under
`torch.inference_mode`), the pair is what the serving forward did before
it: `copy_to_row` returns its input, `reduce_from_row` all-reduces in
place, and a CUDA graph captures them as it captures `TPGroup.all_reduce`.
"""

from __future__ import annotations

import torch

from sparktts_tpu_torch.parallel.mesh import PPGroup, TPGroup


class _CopyToRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _ReduceFromRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_row(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """`x` as is; its gradient summed over the row."""
    return _CopyToRow.apply(x, tp) if _recorded(x) else x


def reduce_from_row(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """`x` summed over the row (in place where autograd records nothing);
    the gradient passed to each rank as is."""
    return _ReduceFromRow.apply(x, tp) if _recorded(x) else tp.all_reduce(x)


class _HandoffSend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pp):
        ctx.pp, ctx.shape, ctx.dtype = pp, x.shape, x.dtype
        pp.send(x.detach())
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        return ctx.pp.receive_back(ctx.shape, ctx.dtype, g.device), None


class _HandoffReceive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, pp, shape, dtype):
        ctx.pp = pp
        return pp.receive(shape, dtype, anchor.device)

    @staticmethod
    def backward(ctx, g):
        ctx.pp.send_back(g)
        return None, None, None, None


def handoff_send(x: torch.Tensor, pp: PPGroup) -> torch.Tensor:
    """Send this stage's output `x` to the next stage; returns a zero
    scalar whose backward receives the gradient of `x` from there."""
    return _HandoffSend.apply(x, pp)


def handoff_receive(pp: PPGroup, shape, dtype, device) -> torch.Tensor:
    """The previous stage's output (`handoff_send` there); its gradient
    goes back there in the backward."""
    anchor = torch.zeros((), device=device, requires_grad=True)
    return _HandoffReceive.apply(anchor, pp, tuple(shape), dtype)


class _VocabParallelNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, lo, tp):
        # logits (..., V_local) fp32 over vocabulary rows [lo, lo + V_local)
        m = logits.max(dim=-1).values
        tp.all_reduce_max(m)
        e = torch.exp(logits - m[..., None])
        sumexp = tp.all_reduce(e.sum(dim=-1))
        local = targets - lo
        mine = (local >= 0) & (local < logits.shape[-1])
        picked = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        target_logit = tp.all_reduce(torch.where(mine, picked, torch.zeros_like(picked)))
        ctx.save_for_backward(e, sumexp, local, mine)
        return torch.log(sumexp) + m - target_logit

    @staticmethod
    def backward(ctx, g):
        e, sumexp, local, mine = ctx.saved_tensors
        grad = e / sumexp[..., None]
        cols = local.clamp(0, grad.shape[-1] - 1)[..., None]
        grad.scatter_add_(-1, cols, -mine[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, lo: int,
                       tp: TPGroup) -> torch.Tensor:
    """-log softmax(whole logits)[target] from this rank's fp32 columns
    `logits` (..., V_local) of vocabulary rows [lo, lo + V_local), the
    whole row's logits being those of every rank of `tp`; whole on every
    rank."""
    return _VocabParallelNll.apply(logits, targets, lo, tp)
