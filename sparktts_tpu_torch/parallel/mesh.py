"""The rank mesh: a (dp, tp, pp) grid of `torch.distributed` ranks.

Port of `sparktts_tpu/parallel/mesh.py`.  JAX builds a `jax.sharding.Mesh`
of devices with named axes and lets GSPMD insert the collectives.  PyTorch
runs one process a card, so here the mesh is the grid of ranks of the
default process group (`init_process_group`, NCCL on the card, gloo on the
CPU), with one process group for each tp row and each dp column of the
grid, and, where pp > 1, for each pipe column (the ranks of one (dp, tp)
index across the stages), each stage boundary of a column and each
column's first and last stage.  The collectives are explicit: the
tensor-parallel forward (`lm/qwen.py`) all-reduces over its row's
`TPGroup`, and a staged forward hands its hidden states on over its
column's `PPGroup`; a placed param tree carries both
(`parallel/shardings.py`).

Every hand-off is a `broadcast` over a two-rank group, and the logits go
back over the column by a `broadcast` too: gloo takes no `send`/`recv` or
`all_gather` of CUDA tensors, but it does take `broadcast` and
`all_reduce` of them, and NCCL's broadcast is captured in a CUDA graph
like its all-reduce.

JAX's `named(mesh, *spec)` has no counterpart: its specs become the shard
functions of `parallel/shardings.py`.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparktts_tpu_torch.utils.platform import require_device

#: Seconds a rank waits in one collective before its process group fails it.
DEFAULT_TIMEOUT_S = 600.0


@dataclass(eq=False)
class TPGroup:
    """One tensor-parallel row of the mesh, as this rank sees it: the
    process group, this rank's index in it and its size, and the backend.

    `side` is a gloo group of the same ranks for the leader's announcements
    and the followers' replies (`parallel/worker.py`), apart from `group`
    so that they never pair with an all-reduce.  `leader` is set on the
    row's rank 0 while it drives followers: the engines and the pipeline
    then announce each LM call on it before they run it."""

    group: Any
    rank: int
    size: int
    backend: str
    ranks: Tuple[int, ...] = ()       # the row's global ranks, in row order
    side: Any = None
    timeout_s: float = DEFAULT_TIMEOUT_S  # of every collective on the row's groups
    leader: Any = field(default=None, repr=False)
    # host calls of `all_reduce`: a captured decode unit's replays make none
    # (its all-reduces are in the graph), an eager step makes every one
    reduces: int = 0

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this row's collectives: NCCL's
        can; gloo's run on the host, so a decode unit over them runs
        eagerly on the card, as it does on the CPU."""
        return self.backend == "nccl"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the row, in place; returns it."""
        self.reduces += 1
        dist.all_reduce(x, group=self.group)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest `x` over the row, in place; returns it."""
        self.reduces += 1
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x


@dataclass(eq=False)
class PPGroup:
    """One pipe column of the mesh, as this rank sees it: the column's
    global ranks in stage order, this rank's stage and the number of
    stages, and the backend.  `group` spans the column (the last stage's
    logits are broadcast over it), `handoffs[s]` is the two-rank group of
    stages s and s + 1 (the hidden states go forward over it, their
    gradient back), and `embed_pair` the group of the first and the last
    stage, which both hold a tied embedding.  Every method is a
    collective of the ranks it names."""

    group: Any
    stage: int
    size: int
    backend: str
    ranks: Tuple[int, ...]
    handoffs: Tuple[Any, ...]
    embed_pair: Any = None

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the column's broadcasts (NCCL)."""
        return self.backend == "nccl"

    def _broadcast(self, x: torch.Tensor, src_stage: int, group) -> torch.Tensor:
        dist.broadcast(x, src=self.ranks[src_stage], group=group)
        return x

    def send(self, x: torch.Tensor) -> None:
        """Hand `x` on to the next stage (`receive` there)."""
        self._broadcast(x.contiguous(), self.stage, self.handoffs[self.stage])

    def receive(self, shape, dtype, device) -> torch.Tensor:
        """The tensor the previous stage `send`s."""
        buf = torch.empty(shape, dtype=dtype, device=device)
        return self._broadcast(buf, self.stage - 1, self.handoffs[self.stage - 1])

    def send_back(self, g: torch.Tensor) -> None:
        """Hand a gradient back to the previous stage (`receive_back` there)."""
        self._broadcast(g.contiguous(), self.stage, self.handoffs[self.stage - 1])

    def receive_back(self, shape, dtype, device) -> torch.Tensor:
        """The gradient the next stage `send_back`s."""
        buf = torch.empty(shape, dtype=dtype, device=device)
        return self._broadcast(buf, self.stage + 1, self.handoffs[self.stage])

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's `x` on every stage of the column: the last stage
        passes its tensor, the others a buffer of its shape, filled in
        place; returns it."""
        return self._broadcast(x, self.size - 1, self.group)

    def sum_ends(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the first and the last stage, in place."""
        dist.all_reduce(x, group=self.embed_pair)
        return x


@dataclass(eq=False)
class Mesh:
    """A (dp, tp, pp) grid of global ranks and this rank's place in it.
    `tp` is this rank's tensor-parallel row, `dp_group` the process group
    of its data-parallel column (the ranks that hold the same part of the
    model), `pp` its pipe column (None where pp = 1) and `side` a gloo
    group of every rank of the mesh, for host tensors (a whole tree
    gathered onto one rank)."""

    grid: np.ndarray               # (dp, tp, pp) global ranks
    rank: int
    tp: TPGroup
    dp_group: Any
    dp_rank: int
    pp_rank: int
    device: torch.device
    pp: Optional[PPGroup] = None
    side: Any = None

    @property
    def shape(self) -> dict:
        dp, tp, pp = self.grid.shape
        return {"dp": dp, "tp": tp, "pp": pp}


def default_axes(n: int, dp: Optional[int], tp: Optional[int], pp: int) -> Tuple[int, int, int]:
    """JAX's defaults: pp = 1, tp = 2 on an even count, dp = n / (tp * pp)."""
    if tp is None:
        tp = 2 if (n // pp) % 2 == 0 and n // pp > 1 else 1
    if dp is None:
        dp = n // (tp * pp)
    assert dp * tp * pp == n, f"dp*tp*pp={dp * tp * pp} != ranks={n}"
    return dp, tp, pp


def make_mesh(
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    pp: int = 1,
    ranks: Optional[Sequence[int]] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """The (dp, tp, pp) mesh over `ranks` (default: every rank of the
    default process group, which must be initialised).  Defaults as JAX's
    `make_mesh`.  Collective: every rank of the default group calls it with
    the same arguments, since it creates each row's and column's process
    group (each with `timeout_s`).  `device`: the card this rank computes
    on, whatever the backend (default: cuda:<local rank>; raises without a
    card: pass device="cpu" for the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise torch.distributed first "
                           "(parallel.multihost.initialize_distributed)")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    dp, tp, pp = default_axes(len(ranks), dp, tp, pp)
    grid = np.asarray(ranks).reshape(dp, tp, pp)
    return _mesh_from_grid(grid, device, timeout_s)


def local_card(rank: int) -> torch.device:
    """The card of a rank of this host: cuda:$LOCAL_RANK, else cuda:(rank
    modulo the host's cards).  Raises without a card."""
    require_device("cuda", "parallel")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def _mesh_from_grid(grid: np.ndarray, device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    backend = dist.get_backend()
    me = dist.get_rank()
    device = local_card(me) if device is None else require_device(device, "parallel")
    timeout = datetime.timedelta(seconds=timeout_s)
    dp, tp, pp = grid.shape
    mine = {}
    # every rank creates every group, in the same order
    for i in range(dp):
        for p in range(pp):
            row = [int(r) for r in grid[i, :, p]]
            group = dist.new_group(row, timeout=timeout)
            side = dist.new_group(row, backend="gloo", timeout=timeout)
            if me in row:
                mine["tp"] = (group, side, tuple(row))
                mine["dp_rank"], mine["pp_rank"] = i, p
    for j in range(tp):
        for p in range(pp):
            col = [int(r) for r in grid[:, j, p]]
            group = dist.new_group(col, timeout=timeout)
            if me in col:
                mine["dp"] = group
    if pp > 1:
        for i in range(dp):
            for j in range(tp):
                pipe = [int(r) for r in grid[i, j, :]]
                group = dist.new_group(pipe, timeout=timeout)
                handoffs = tuple(dist.new_group(pipe[s : s + 2], timeout=timeout)
                                 for s in range(pp - 1))
                # at pp = 2 the ends are the one boundary's pair
                ends = (handoffs[0] if pp == 2
                        else dist.new_group([pipe[0], pipe[-1]], timeout=timeout))
                if me in pipe:
                    mine["pp"] = PPGroup(group, pipe.index(me), pp, backend, tuple(pipe),
                                         handoffs, ends)
    side = dist.new_group([int(r) for r in grid.reshape(-1)], backend="gloo", timeout=timeout)
    if "tp" not in mine:
        raise ValueError(f"rank {me} is not in the mesh {grid.tolist()}")
    group, row_side, row_ranks = mine["tp"]
    row = TPGroup(group, row_ranks.index(me), tp, backend, row_ranks, row_side, timeout_s)
    return Mesh(grid, me, row, mine["dp"], mine["dp_rank"], mine["pp_rank"], device,
                mine.get("pp"), side)


def tp_of(params) -> Optional[TPGroup]:
    """The tensor-parallel row a param tree is a shard of, or None for a
    whole tree (`shardings.ShardedTree`)."""
    return getattr(params, "tp", None)


def pp_of(params) -> Optional[PPGroup]:
    """The pipe column a param tree is a stage of, or None (a whole tree,
    or a tp shard of all the layers)."""
    return getattr(params, "pp", None)


def capturable(params) -> bool:
    """Whether a decode unit over `params` can be a CUDA graph: a whole
    tree, or a placed tree whose row's all-reduces and column's broadcasts
    a graph captures (NCCL)."""
    tp, pp = tp_of(params), pp_of(params)
    return (tp is None or tp.capturable) and (pp is None or pp.capturable)
