"""The rank mesh: a (dp, tp, pp) grid of `torch.distributed` ranks.

Port of `sparktts_tpu/parallel/mesh.py`.  JAX builds a `jax.sharding.Mesh`
of devices with named axes and lets GSPMD insert the collectives.  PyTorch
runs one process a card, so here the mesh is the grid of ranks of the
default process group (`init_process_group`, NCCL on the card, gloo on the
CPU), with one process group for each tp row and each dp column of the
grid.  The collectives are explicit: the tensor-parallel forward
(`lm/qwen.py`) all-reduces over its row's `TPGroup`, which a sharded param
tree carries (`parallel/shardings.py`).

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


@dataclass(eq=False)
class Mesh:
    """A (dp, tp, pp) grid of global ranks and this rank's place in it.
    `tp` is this rank's tensor-parallel row, `dp_group` the process group
    of its data-parallel column (the ranks that hold the same shard)."""

    grid: np.ndarray               # (dp, tp, pp) global ranks
    rank: int
    tp: TPGroup
    dp_group: Any
    dp_rank: int
    pp_rank: int
    device: torch.device

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
    if "tp" not in mine:
        raise ValueError(f"rank {me} is not in the mesh {grid.tolist()}")
    group, side, row_ranks = mine["tp"]
    row = TPGroup(group, row_ranks.index(me), tp, backend, row_ranks, side, timeout_s)
    return Mesh(grid, me, row, mine["dp"], mine["dp_rank"], mine["pp_rank"], device)


def tp_of(params) -> Optional[TPGroup]:
    """The tensor-parallel row a param tree is a shard of, or None for a
    whole tree (`shardings.ShardedTree`)."""
    return getattr(params, "tp", None)


def capturable(params) -> bool:
    """Whether a decode unit over `params` can be a CUDA graph: a whole
    tree, or a shard whose row's collectives a graph captures (NCCL)."""
    tp = tp_of(params)
    return tp is None or tp.capturable
