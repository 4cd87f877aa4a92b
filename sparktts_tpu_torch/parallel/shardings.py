"""Megatron tensor parallelism of the Qwen LM as shard functions.

Port of `sparktts_tpu/parallel/shardings.py`.  The JAX package writes its
sharding as GSPMD PartitionSpecs and XLA cuts the arrays and inserts the
collectives.  Here each spec becomes a function that cuts a whole port
tree into one tp rank's shard, with its inverse, and the forward
(`lm/qwen.py`) does the collectives itself:

  * attention q/k/v and MLP gate/up: column-parallel (output columns);
  * attention o and MLP down: row-parallel (input rows; the forward
    all-reduces their outputs, then adds a bias);
  * embedding: by vocabulary row (the forward masks the ids outside the
    rank's rows and all-reduces); an untied `lm_head` by column;
  * norms: replicated; the KV cache by KV head; a batch by row over dp.

JAX's specs cut the *fused* `qkv` and `gateup` weights into contiguous
column blocks (`P(lp, None, "tp")`), which GSPMD can do without regard to
meaning.  A rank here computes with its shard alone, so the cut follows the
heads: `qkv` is `[q (nh*hd) | k (nkv*hd) | v (nkv*hd)]`, and rank r takes q
heads [r*nh/tp, (r+1)*nh/tp), the same share of the k heads and of the v
heads, with their biases; `gateup` is `[gate | up]`, and rank r takes its
share of each.  A shard is then the tree of a smaller Qwen (`shard_config`:
nh/tp query heads, nkv/tp KV heads, intermediate/tp) whose partial outputs
sum to the whole model's.

The vocabulary is cut into `vocab_bounds` rows a rank; the guided logits of
Spark-TTS (semantic ids and markers above the base vocabulary) may all lie
on one rank, so nothing assumes a balanced share.  JAX's `shard_llm` maps
its specs over a bf16 tree; a weight-only quantized tree's keys do not
match them, and here `shard_qwen` refuses one.

The pp axis (`qwen_param_specs(cfg, pp=True)`) cuts the stacked layer axis
into stages (`stage_qwen`): stage s of pp owns layers [s*L/pp,
(s+1)*L/pp), the first stage the embedding, the last the final norm and
the head (with a tied embedding, a second copy of `embed`).  `place` makes
a rank's part of a whole tree on a (dp, tp, pp) mesh: its tp shard, then
its stage; `unplace` rebuilds the whole tree from every rank's part.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.lm.qwen import KVCache
from sparktts_tpu_torch.parallel.mesh import Mesh, PPGroup, TPGroup

#: Keys of a weight-only quantized linear or table (`lm/quant.py`).
QUANT_KEYS = ("w_q", "w_p4", "scale", "gscale")


class ShardedTree(dict):
    """One rank's part of a Qwen tree on a mesh (`place`: a dict with keys
    of the whole tree's), with the mesh (`mesh`: the train step reads its
    dp column), the whole model's config (`config`), and from them the row
    it belongs to (`tp`), the vocabulary rows of its embedding and head
    (`vocab`, [lo, hi)) and its pipe column (`pp`, None for all the
    layers).  The forward reads them."""

    def __init__(self, tree: dict, mesh: Mesh, config: QwenConfig):
        super().__init__(tree)
        self.mesh = mesh
        self.config = config
        self.tp: TPGroup = mesh.tp
        self.pp: Optional[PPGroup] = mesh.pp
        self.vocab: Tuple[int, int] = vocab_bounds(config.vocab_size, mesh.tp.rank, mesh.tp.size)

    def like(self, tree: dict) -> "ShardedTree":
        """`tree` (of this part's keys) with this part's placement."""
        return ShardedTree(tree, self.mesh, self.config)

    @property
    def first(self) -> bool:
        """Whether this part holds the first stage (the embedding lookup)."""
        return self.pp is None or self.pp.first

    @property
    def last(self) -> bool:
        """Whether this part holds the last stage (the final norm, the head)."""
        return self.pp is None or self.pp.last


def vocab_bounds(vocab_size: int, rank: int, size: int) -> Tuple[int, int]:
    """Rank `rank`'s rows [lo, hi) of a `vocab_size`-row table cut in `size`."""
    return vocab_size * rank // size, vocab_size * (rank + 1) // size


def shard_config(cfg: QwenConfig, size: int) -> QwenConfig:
    """The config of one rank's shard: nh/size query heads, nkv/size KV
    heads, intermediate/size MLP columns; everything else the whole
    model's.  The KV cache, the decode kernel and the engines size
    themselves from it."""
    nh, nkv, inter = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    if nh % size or nkv % size or inter % size:
        raise ValueError(f"tp={size} must divide the query heads ({nh}), the KV heads ({nkv}) "
                         f"and the intermediate size ({inter})")
    return dataclasses.replace(cfg, num_attention_heads=nh // size,
                               num_key_value_heads=nkv // size, intermediate_size=inter // size)


def _check_float(tree: dict) -> None:
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in QUANT_KEYS:
                    raise ValueError(f"shard_qwen takes a bf16 or fp32 tree; {path + k} is a "
                                     f"weight-only quantized leaf (quantize after sharding is "
                                     f"not supported either)")
                walk(v, f"{path}{k}/")
    walk(tree, "")


def _qkv_parts(cfg: QwenConfig) -> List[int]:
    hd = cfg.head_dim
    return [cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd,
            cfg.num_key_value_heads * hd]


def _column_cut(t: torch.Tensor, parts: Sequence[int], rank: int, size: int) -> torch.Tensor:
    """The last axis holds `parts` side by side; take rank's share of each."""
    pieces, off = [], 0
    for n in parts:
        share = n // size
        pieces.append(t[..., off + rank * share : off + (rank + 1) * share])
        off += n
    return torch.cat(pieces, dim=-1).contiguous()


def _column_join(shards: Sequence[torch.Tensor], parts: Sequence[int]) -> torch.Tensor:
    size = len(shards)
    out, off = [], 0
    for n in parts:
        share = n // size
        out.extend(s[..., off : off + share] for s in shards)
        off += share
    return torch.cat(out, dim=-1)


def _row_cut(t: torch.Tensor, axis: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[axis]
    if n % size:
        raise ValueError(f"{size} shards must divide {n} rows")
    return t.narrow(axis, rank * (n // size), n // size).contiguous()


def shard_qwen_layers(layers: dict, cfg: QwenConfig, rank: int, size: int) -> dict:
    """Rank's shard of the STACKED layer tree (`qwen_layer_specs`): qkv and
    gateup by head-aligned columns, o and down by input rows, norms whole."""
    gu = [cfg.intermediate_size, cfg.intermediate_size]
    out = {"ln1": dict(layers["ln1"]), "ln2": dict(layers["ln2"])}
    out["qkv"] = {k: _column_cut(v, _qkv_parts(cfg), rank, size) for k, v in layers["qkv"].items()}
    out["gateup"] = {k: _column_cut(v, gu, rank, size) for k, v in layers["gateup"].items()}
    for name in ("o", "down"):
        # a bias is added once, after the all-reduce: every rank keeps it
        out[name] = {k: v if k == "b" else _row_cut(v, 1, rank, size)
                     for k, v in layers[name].items()}
    return out


def unshard_qwen_layers(shards: Sequence[dict], cfg: QwenConfig) -> dict:
    """Inverse of `shard_qwen_layers` over every rank's shard, in rank order."""
    gu = [cfg.intermediate_size, cfg.intermediate_size]
    first = shards[0]
    out = {"ln1": dict(first["ln1"]), "ln2": dict(first["ln2"])}
    out["qkv"] = {k: _column_join([s["qkv"][k] for s in shards], _qkv_parts(cfg))
                  for k in first["qkv"]}
    out["gateup"] = {k: _column_join([s["gateup"][k] for s in shards], gu)
                     for k in first["gateup"]}
    for name in ("o", "down"):
        out[name] = {k: first[name][k] if k == "b" else torch.cat([s[name][k] for s in shards], 1)
                     for k in first[name]}
    return out


def shard_qwen(tree: dict, cfg: QwenConfig, rank: int, size: int) -> dict:
    """Rank's shard of a whole Qwen tree (`qwen_param_specs`): the layers
    as `shard_qwen_layers`, the embedding's `vocab_bounds` rows, an untied
    head's same columns, the final norm whole.  A plain dict; `place`
    binds it to its mesh.  Refuses a weight-only quantized tree."""
    _check_float(tree)
    lo, hi = vocab_bounds(cfg.vocab_size, rank, size)
    out = {
        "embed": tree["embed"][lo:hi].contiguous(),
        "layers": shard_qwen_layers(tree["layers"], cfg, rank, size),
        "final_ln": dict(tree["final_ln"]),
    }
    if "lm_head" in tree:
        out["lm_head"] = {k: v[..., lo:hi].contiguous() for k, v in tree["lm_head"].items()}
    return out


def unshard_qwen(shards: Sequence[dict], cfg: QwenConfig) -> dict:
    """Inverse of `shard_qwen` over every rank's shard, in rank order."""
    first = shards[0]
    out = {
        "embed": torch.cat([s["embed"] for s in shards], 0),
        "layers": unshard_qwen_layers([s["layers"] for s in shards], cfg),
        "final_ln": dict(first["final_ln"]),
    }
    if "lm_head" in first:
        out["lm_head"] = {k: torch.cat([s["lm_head"][k] for s in shards], -1)
                          for k in first["lm_head"]}
    return out


def stage_layers(layers: dict, stage: int, stages: int) -> dict:
    """The pp=True cut of JAX's `qwen_layer_specs`: stage `stage` of
    `stages` owns layers [stage*L/stages, (stage+1)*L/stages) of the
    stacked tree, which the staged forward (`lm/qwen.py`) runs with the
    local plane indices 0 .. L/stages - 1 of its stage's cache.  Requires
    L % stages == 0."""
    return {name: {k: _row_cut(v, 0, stage, stages) for k, v in sub.items()}
            for name, sub in layers.items()}


def unstage_layers(stages: Sequence[dict]) -> dict:
    """Inverse of `stage_layers` over every stage, in order."""
    return {name: {k: torch.cat([s[name][k] for s in stages], 0) for k in sub}
            for name, sub in stages[0].items()}


def stage_config(cfg: QwenConfig, stages: int) -> QwenConfig:
    """The config of one stage: L/stages layers, everything else as is (a
    stage's KV cache then holds its own planes)."""
    if cfg.num_hidden_layers % stages:
        raise ValueError(f"pp={stages} must divide the layers ({cfg.num_hidden_layers})")
    return dataclasses.replace(cfg, num_hidden_layers=cfg.num_hidden_layers // stages)


def stage_qwen(tree: dict, cfg: QwenConfig, stage: int, stages: int) -> dict:
    """Stage `stage` of a Qwen tree (whole or a tp shard): its layers
    (`stage_layers`), `embed` on the first stage, `final_ln` and an untied
    `lm_head` on the last, and with a tied embedding `embed` on the last
    stage too (both ends then hold a copy)."""
    out = {"layers": stage_layers(tree["layers"], stage, stages)}
    first, last = stage == 0, stage == stages - 1
    if first or (last and cfg.tie_word_embeddings):
        out["embed"] = tree["embed"]
    if last:
        out["final_ln"] = dict(tree["final_ln"])
        if "lm_head" in tree:
            out["lm_head"] = dict(tree["lm_head"])
    return out


def unstage_qwen(stages: Sequence[dict]) -> dict:
    """Inverse of `stage_qwen` over every stage, in order (the embedding
    of the first stage)."""
    out = {"embed": stages[0]["embed"], "layers": unstage_layers([s["layers"] for s in stages]),
           "final_ln": dict(stages[-1]["final_ln"])}
    if "lm_head" in stages[-1]:
        out["lm_head"] = dict(stages[-1]["lm_head"])
    return out


def placed_config(cfg: QwenConfig, mesh: Mesh) -> QwenConfig:
    """The config of a rank's part on `mesh` (`place`): its shard's heads
    and MLP columns, its stage's layers."""
    shape = mesh.shape
    return stage_config(shard_config(cfg, shape["tp"]), shape["pp"])


def place(tree: dict, cfg: QwenConfig, mesh: Mesh) -> ShardedTree:
    """This rank's part of a whole Qwen tree on a (dp, tp, pp) mesh: its tp
    shard (`shard_qwen`), then its stage (`stage_qwen`), bound to its row,
    its pipe column and the mesh.  Every rank of the mesh calls it on the
    same whole tree; the forward over the part takes `placed_config`."""
    shape = mesh.shape
    shard = shard_qwen(tree, cfg, mesh.tp.rank, shape["tp"])
    return ShardedTree(stage_qwen(shard, cfg, mesh.pp_rank, shape["pp"]), mesh, cfg)


def unplace(parts: Sequence[dict], cfg: QwenConfig, grid) -> dict:
    """Inverse of `place`: the whole tree from every rank's part, `parts`
    indexed by global rank, `grid` the mesh's (dp, tp, pp) ranks (the dp
    replicas are alike: dp index 0's parts are read)."""
    _, tp, pp = grid.shape
    shards = [unstage_qwen([parts[int(grid[0, j, s])] for s in range(pp)]) for j in range(tp)]
    return unshard_qwen(shards, cfg)


def shard_kv_cache(cache: KVCache, rank: int, size: int) -> KVCache:
    """`kv_cache_specs`' tp half: rank's KV heads of an (L, B, S, nkv, hd)
    cache.  (The slot vectors of the engines are replicated.)"""
    return KVCache(_row_cut(cache.k, 3, rank, size), _row_cut(cache.v, 3, rank, size))


def unshard_kv_cache(shards: Sequence[KVCache]) -> KVCache:
    return KVCache(torch.cat([s.k for s in shards], 3), torch.cat([s.v for s in shards], 3))


def shard_batch(x: torch.Tensor, dp_rank: int, dp: int) -> torch.Tensor:
    """`batch_spec`: rank's rows of a (B, ...) batch over dp."""
    return _row_cut(x, 0, dp_rank, dp)


def unshard_batch(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(shards), 0)
