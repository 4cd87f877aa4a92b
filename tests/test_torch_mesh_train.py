"""The port's pipeline parallelism and training on a (dp, tp, pp) mesh
(`sparktts_tpu_torch/parallel/`, `lm/train.py`) against the JAX package's
single-device results, at `tests/test_parallel.py`'s config and seeds.

Eight gloo ranks on the CPU, one spawned group for the module
(`worker.spawn`, one intra-op thread a rank), which run every case, the
dry run's included, and return their results; the tests below read them:

  * the stage cut and `place` round-trip bit for bit (no ranks needed); the
    pipe columns, hand-off pairs and end pairs match the grid;
  * pp = 2 on a (2, 2, 2) mesh, each dp row its half of the batch: greedy
    `generate`, plain and guided (every guided row on tp rank 1), equal to
    JAX's single-device `generate` (the LM's weights x4, so that greedy
    decoding does not repeat one id), and the prefill's logits within 1e-5
    of the peak of JAX's;
  * one train step on (2, 2, 2) and on (4, 2, 1) against JAX's `lm_loss`,
    `jax.grad` and `train_step` over the global batch: loss within
    LOSS_RTOL, first-step gradients within GRAD_TOL of each leaf's largest
    element (and two `compute_grads` calls' within GRAD_TOL of the sum of
    JAX's two gradients: the second call reduces only its own), params after three steps within PARAM_ATOL with
    `tests/test_torch_train.py`'s K-bias rule, which also covers the few
    elements whose gradient is rounding noise (NOISE_FLOOR).  The batch's dp halves (and
    quarters) carry different mask counts, so a mean of per-rank means
    would fail;
  * a tied embedding's first- and last-stage copies bit-equal after three
    steps; a mesh state saved, loaded and stepped bit-equal to the
    uninterrupted run;
  * `dryrun_multichip(8, device="cpu")`'s rank body (`dryrun_rank`) on the
    module's eight ranks, then its checks (`dryrun_check`);
  * `shard_llm` refuses pp > 1; the mesh train state and the dry run run on
    the card unless asked for the CPU.

JAX is imported inside the fixtures only: the ranks import this module.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import QwenConfig
from sparktts_tpu_torch.parallel import shardings as S
from sparktts_tpu_torch.parallel import worker
from sparktts_tpu_torch.parallel.mesh import Mesh, PPGroup, TPGroup

# tests/test_parallel.py's CFG
CFG = QwenConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16, eos_token_id=0,
                 pad_token_id=1)
GEN_KW = dict(max_new_tokens=8, cache_len=16, eos_ids=(), pad_id=1, greedy=True)
GUIDED = dict(vocab_slice=(160, 240), extra_ids=(130, 200, 255))  # all on tp rank 1's rows
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest gradient element
LR = 1e-3
PARAM_ATOL = 1e-6  # after 3 steps; the K bias: 2 LR a step (tests/test_torch_train.py)
# Adam moves an element whose gradient is rounding noise by about +-LR a
# step whatever its size (tests/test_torch_train.py's K-bias rule): on this
# batch that holds for a few elements of o and down too, whose first-step
# gradient is below NOISE_FLOOR of their leaf's largest (the port on one
# device is 1.5e-6 from JAX there, as on the mesh); they take the K bias's
# bound, and they must stay a few (NOISE_SHARE of the elements at most)
NOISE_FLOOR = 1e-5
NOISE_SHARE = 5e-3
STEPS = 3
B, T = 8, 12
MASK_COUNTS = (11, 9, 7, 5, 3, 2, 10, 1)  # halves 32 / 16, quarters 20 / 12 / 5 / 11


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    """tests/test_parallel.py's ids (seed 3), left-padded to lengths 8, 5, 8, 3."""
    ids = np.random.default_rng(3).integers(5, 250, size=(4, 8)).astype(np.int64)
    mask = np.ones((4, 8), bool)
    for row, n in ((1, 5), (3, 3)):
        ids[row, : 8 - n] = 1
        mask[row, : 8 - n] = False
    return ids, mask


def _batches():
    """STEPS + 2 global batches (B, T); row r's mask counts MASK_COUNTS[r]
    predictions."""
    mask = np.zeros((B, T), bool)
    for r, n in enumerate(MASK_COUNTS):
        mask[r, T - n :] = True
    return [(np.random.default_rng(10 + i).integers(2, 250, size=(B, T)).astype(np.int64), mask)
            for i in range(STEPS + 2)]


# ---------------------------------------------------------------------------
# what the ranks run (module-level functions: they are pickled to the ranks)
# ---------------------------------------------------------------------------


def _plain(tree, grad=False):
    """A placed part (or its gradients) as plain dicts of numpy arrays:
    tensors would cross to the parent through shared memory, which a rank
    that has exited no longer serves."""
    if isinstance(tree, dict):
        return {k: _plain(v, grad) for k, v in tree.items()}
    return (tree.grad if grad else tree).detach().numpy().copy()


def _train(mesh, inputs, ckpt=None):
    """One mesh's train cases: first-step gradients, STEPS AdamW steps, and
    with `ckpt` the save / load / resume check."""
    from sparktts_tpu_torch.checkpoint import flatten_tree
    from sparktts_tpu_torch.lm import train
    from sparktts_tpu_torch.weights import qwen_place

    part, pcfg = qwen_place(inputs["train_tree"], CFG, mesh, device="cpu", dtype=torch.float32)
    batches = inputs["batches"]
    state = train.init_train_state(part, train.make_optimizer(LR), device="cpu")
    out = {"first_loss": float(train.compute_grads(state, pcfg, *batches[0])),
           "grads": _plain(dict(state.params), grad=True), "keys": sorted(part)}
    train.compute_grads(state, pcfg, *batches[1])
    out["grads_sum"] = _plain(dict(state.params), grad=True)
    state = train.init_train_state(part, train.make_optimizer(LR), device="cpu")
    out["losses"] = [float(train.train_step(state, pcfg, *b)[1]) for b in batches[:STEPS]]
    out["params"] = _plain(dict(state.params))
    if ckpt is None:
        return out
    train.save_train_state(ckpt, state)
    for b in batches[STEPS:]:
        state, loss = train.train_step(state, pcfg, *b)
    restored = train.load_train_state(ckpt, train.make_optimizer(LR), device="cpu", mesh=mesh,
                                      cfg=CFG)
    for b in batches[STEPS:]:
        restored, res_loss = train.train_step(restored, pcfg, *b)
    got, want = flatten_tree(restored.params)[0], flatten_tree(state.params)[0]
    equal = float(res_loss) == float(loss) and restored.step == state.step == STEPS + 2
    for name in want:
        equal &= torch.equal(got[name], want[name])
        for key in ("exp_avg", "exp_avg_sq", "step"):
            equal &= torch.equal(restored.optimizer.state[got[name]][key],
                                 state.optimizer.state[want[name]][key])
    out["resume_equal"] = bool(equal)
    return out


def _rank(mesh, inputs):
    """Every rank: the groups, pp generate and prefill on (2, 2, 2), the
    train cases on (2, 2, 2) and (4, 2, 1), then the dry run's rank body."""
    import torch.distributed as dist

    from sparktts_tpu_torch.parallel.dryrun import dryrun_rank

    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.lm.qwen import init_kv_cache, prefill_inputs, qwen_forward
    from sparktts_tpu_torch.parallel.mesh import make_mesh
    from sparktts_tpu_torch.weights import qwen_place

    pp = mesh.pp
    out = {"rank": mesh.rank, "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp.rank,
           "stage": pp.stage, "pipe": pp.ranks,
           "handoffs": [tuple(dist.get_process_group_ranks(g)) if mesh.rank in pp.ranks[s : s + 2]
                        else None for s, g in enumerate(pp.handoffs)],
           "ends": tuple(dist.get_process_group_ranks(pp.embed_pair))}
    part, pcfg = qwen_place(inputs["llm"], CFG, mesh, device="cpu", dtype=torch.float32)
    out["kv_planes"] = init_kv_cache(pcfg, 1, 16, torch.float32, "cpu").k.shape
    ids, mask = (torch.from_numpy(a[mesh.dp_rank * 2 : mesh.dp_rank * 2 + 2])
                 for a in inputs["prompts"])
    for name, extra in (("plain", {}), ("guided", GUIDED)):
        out[name] = [t.numpy() for t in generate(part, pcfg, ids, mask,
                                                 torch.Generator().manual_seed(1), **GEN_KW,
                                                 cache_dtype=torch.float32, **extra)]
    pos, bias = prefill_inputs(mask, ids.shape[1])
    with torch.inference_mode():
        cache = init_kv_cache(pcfg, 2, ids.shape[1], torch.float32, "cpu")
        out["logits"] = qwen_forward(part, pcfg, ids, pos, cache, 0, bias, **GUIDED)[0].numpy()
    out["train_222"] = _train(mesh, inputs, inputs["ckpt"])
    mesh_421 = make_mesh(dp=4, tp=2, pp=1, device="cpu", timeout_s=300)
    out["grid_421"] = mesh_421.grid
    out["train_421"] = _train(mesh_421, inputs)
    out["dryrun"] = dryrun_rank(mesh, inputs["dryrun"])
    return out


# ---------------------------------------------------------------------------
# fixtures: the JAX references and the ranks' results
# ---------------------------------------------------------------------------


def _jax_cfg():
    from sparktts_tpu.config import QwenConfig as JaxQwenConfig

    return JaxQwenConfig(**dataclasses.asdict(CFG))


def _numpy(tree, factor=1.0):
    import jax

    return jax.tree.map(lambda a: np.array(a, np.float32) * np.float32(factor), tree)


@pytest.fixture(scope="module")
def jax_refs():
    import jax
    import jax.numpy as jnp

    from sparktts_tpu.lm import generate as jgen
    from sparktts_tpu.lm import qwen as jq

    jcfg = _jax_cfg()
    base = jq.init_qwen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    llm = _numpy(base, 4.0)
    ids, mask = _prompts()
    jp = jax.tree.map(jnp.asarray, llm)
    refs = {}
    for name, extra in (("plain", {}), ("guided", GUIDED)):
        toks, lens = jgen.generate(jp, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                                   jax.random.PRNGKey(1), cache_dtype=jnp.float32, **GEN_KW,
                                   **extra)
        refs[name] = (np.asarray(toks), np.asarray(lens))
    pos, bias = jq.prefill_inputs(jnp.asarray(mask), ids.shape[1])
    logits, _ = jq.qwen_forward(jp, jcfg, jnp.asarray(ids, jnp.int32), pos,
                                jq.init_kv_cache(jcfg, 4, ids.shape[1], jnp.float32), 0, bias,
                                **GUIDED)
    refs["logits"] = np.asarray(logits)
    return refs, dict(llm=llm, prompts=(ids, mask), train_tree=_numpy(base),
                      batches=_batches())


@pytest.fixture(scope="module")
def jax_train(jax_refs):
    """JAX's single-device loss and gradients of the first batch, and the
    params and losses of STEPS train steps."""
    import functools

    import jax
    import jax.numpy as jnp

    from sparktts_tpu.lm import train as jtrain

    jcfg = _jax_cfg()
    params = jax.tree.map(jnp.asarray, jax_refs[1]["train_tree"])
    batches = jax_refs[1]["batches"]
    ids0, m0 = (jnp.asarray(a) for a in batches[0])
    loss0, grads = jax.value_and_grad(jtrain.lm_loss)(params, jcfg, ids0.astype(jnp.int32), m0)
    optimizer = jtrain.make_optimizer(LR)
    step = jax.jit(functools.partial(jtrain.train_step, cfg=jcfg, optimizer=optimizer))
    state = jtrain.init_train_state(params, optimizer)
    losses = []
    for ids, m in batches[:STEPS]:
        state, loss = step(state, input_ids=jnp.asarray(ids, jnp.int32), loss_mask=jnp.asarray(m))
        losses.append(float(loss))
    halves = [float(jtrain.lm_loss(params, jcfg, ids0[h].astype(jnp.int32), m0[h]))
              for h in (slice(0, B // 2), slice(B // 2, B))]
    ids1, m1 = (jnp.asarray(a) for a in batches[1])
    grads1 = jax.grad(jtrain.lm_loss)(params, jcfg, ids1.astype(jnp.int32), m1)
    return dict(loss=float(loss0), grads=_numpy(grads), losses=losses,
                grads_sum=_numpy(jax.tree.map(jnp.add, grads, grads1)),
                params=_numpy(state.params), mean_of_means=float(np.mean(halves)))


@pytest.fixture(scope="module")
def ranks(jax_refs, tmp_path_factory):
    from sparktts_tpu_torch.parallel.dryrun import dryrun_args

    inputs = dict(jax_refs[1], ckpt=str(tmp_path_factory.mktemp("mesh_state") / "ckpt"),
                  dryrun=dryrun_args(8, device="cpu", timeout_s=300))
    return worker.spawn(_rank, 8, "gloo", args=(inputs,), device="cpu", threads=1,
                        timeout_s=300, mesh_kwargs=dict(dp=2, tp=2, pp=2))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _fake_mesh(grid, rank):
    """A Mesh for the pure cut functions: groups of None."""
    i, j, p = (int(a[0]) for a in np.nonzero(grid == rank))
    dp, tp, pp = grid.shape
    pipe = PPGroup(None, p, pp, "gloo", tuple(int(r) for r in grid[i, j, :]), ())
    return Mesh(grid, rank, TPGroup(None, j, tp, "gloo"), None, i, p, torch.device("cpu"),
                pipe if pp > 1 else None)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.mark.parametrize("shape,tied", [((2, 2, 2), True), ((1, 2, 2), False), ((1, 1, 4), True),
                                        ((2, 2, 1), True)])
def test_place_round_trips_bit_for_bit(shape, tied):
    """Every rank's part of a whole tree rebuilds it exactly; the first
    stage holds the embedding, the last the final norm and the head (a tied
    embedding's second copy); a stage holds L/pp layers, and the KV cache
    of its config L/pp planes of the shard's KV heads."""
    cfg = dataclasses.replace(CFG, num_hidden_layers=4, tie_word_embeddings=tied)
    gen = torch.Generator().manual_seed(0)
    from sparktts_tpu_torch.weights import init_qwen

    tree = init_qwen(cfg, gen, torch.float32, "cpu")
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    parts = {int(r): S.place(tree, cfg, _fake_mesh(grid, int(r))) for r in grid.reshape(-1)}
    for path, a, b in _pairs(tree, S.unplace(parts, cfg, grid)):
        assert torch.equal(a, b), path
    stages = shape[2]
    for r, part in parts.items():
        stage = int(np.nonzero(grid == r)[2][0])
        assert part["layers"]["qkv"]["w"].shape[0] == 4 // stages
        assert ("embed" in part) == (stage == 0 or (stage == stages - 1 and tied))
        assert ("final_ln" in part) == (stage == stages - 1)
        assert ("lm_head" in part) == (stage == stages - 1 and not tied)
        assert part.first == (stage == 0) and part.last == (stage == stages - 1)
    pcfg = S.placed_config(cfg, _fake_mesh(grid, 0))
    assert (pcfg.num_hidden_layers, pcfg.num_key_value_heads) == (4 // stages, 2 // shape[1])
    from sparktts_tpu_torch.lm.qwen import init_kv_cache

    assert init_kv_cache(pcfg, 1, 8, torch.float32, "cpu").k.shape == (4 // stages, 1, 8,
                                                                       2 // shape[1], 16)


def test_pipe_and_handoff_groups_match_the_grid(ranks):
    grid = np.arange(8).reshape(2, 2, 2)
    for out in ranks:
        i, j = out["dp_rank"], out["tp_rank"]
        assert out["pipe"] == tuple(int(r) for r in grid[i, j, :])
        assert out["pipe"][out["stage"]] == out["rank"]
        assert out["handoffs"] == [out["pipe"]]  # one boundary at pp = 2
        assert out["ends"] == out["pipe"]
        # a stage's cache: L/pp planes of the shard's KV heads
        assert tuple(out["kv_planes"])[0] == 1 and tuple(out["kv_planes"])[3] == 1
    assert (ranks[0]["grid_421"] == np.arange(8).reshape(4, 2, 1)).all()


@pytest.mark.parametrize("name", ["plain", "guided"])
def test_pp_generate_equals_jax_single_device(ranks, jax_refs, name):
    """(2, 2, 2): every rank of a dp row returns its rows' ids, equal to
    JAX's single-device greedy ids (both stages sample from the logits the
    last stage broadcasts)."""
    want_toks, want_lens = jax_refs[0][name]
    assert len(set(want_toks.reshape(-1).tolist())) > 3, "the reference repeats one id"
    for out in ranks:
        rows = slice(out["dp_rank"] * 2, out["dp_rank"] * 2 + 2)
        toks, lens = out[name]
        np.testing.assert_array_equal(toks, want_toks[rows], err_msg=f"rank {out['rank']}")
        np.testing.assert_array_equal(lens, want_lens[rows], err_msg=f"rank {out['rank']}")


def test_pp_prefill_logits_match_jax(ranks, jax_refs):
    want = jax_refs[0]["logits"]
    mask = jax_refs[1]["prompts"][1][:, :, None]
    for out in ranks:
        rows = slice(out["dp_rank"] * 2, out["dp_rank"] * 2 + 2)
        got = out["logits"]
        assert got.shape == want[rows].shape
        err = np.abs(np.where(mask[rows], got - want[rows], 0)).max()
        assert err <= 1e-5 * np.abs(want).max(), (out["rank"], err)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _unplaced(ranks, key, field, grid):
    return S.unplace({out["rank"]: _tensors(out[key][field]) for out in ranks}, CFG, grid)


MESHES = [("train_222", np.arange(8).reshape(2, 2, 2)),
          ("train_421", np.arange(8).reshape(4, 2, 1))]


@pytest.mark.parametrize("key,grid", MESHES, ids=["2x2x2", "4x2x1"])
def test_mesh_loss_and_gradients_equal_jax(ranks, jax_train, key, grid):
    """The global batch's loss on every rank, within LOSS_RTOL of JAX's
    (a mean of the dp halves' means is not: the halves' mask counts
    differ), and the unplaced first-step gradients (summed over dp, the
    tied embedding over its two stages) within GRAD_TOL of JAX's."""
    from sparktts_tpu_torch.checkpoint import flatten_tree

    want = jax_train["loss"]
    assert abs(jax_train["mean_of_means"] - want) > 10 * LOSS_RTOL * abs(want)
    for out in ranks:
        np.testing.assert_allclose(out[key]["first_loss"], want, rtol=LOSS_RTOL)
    got = flatten_tree(_unplaced(ranks, key, "grads", grid))[0]
    ref = flatten_tree(jax_train["grads"])[0]
    assert set(got) == set(ref)
    for name, leaf in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(leaf.numpy(), ref[name], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("key,grid", MESHES, ids=["2x2x2", "4x2x1"])
def test_mesh_gradients_accumulate_as_jax(ranks, jax_train, key, grid):
    """Two `compute_grads` calls without zeroing (the first batch, then the
    second): the unplaced gradients within GRAD_TOL of the sum of JAX's
    two gradients (the second call sums only its own part over dp and the
    tied embedding's ends, not what the first left)."""
    from sparktts_tpu_torch.checkpoint import flatten_tree

    got = flatten_tree(_unplaced(ranks, key, "grads_sum", grid))[0]
    ref = flatten_tree(jax_train["grads_sum"])[0]
    assert set(got) == set(ref)
    for name, leaf in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(leaf.numpy(), ref[name], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("key,grid", MESHES, ids=["2x2x2", "4x2x1"])
def test_mesh_train_steps_equal_jax(ranks, jax_train, key, grid):
    from sparktts_tpu_torch.checkpoint import flatten_tree

    for out in ranks:
        np.testing.assert_allclose(out[key]["losses"], jax_train["losses"], rtol=LOSS_RTOL)
    want = flatten_tree(jax_train["params"])[0]
    grads = flatten_tree(jax_train["grads"])[0]
    k_bias = slice(CFG.num_attention_heads * CFG.head_dim,
                   (CFG.num_attention_heads + CFG.num_key_value_heads) * CFG.head_dim)
    noise = 0
    for name, leaf in flatten_tree(_unplaced(ranks, key, "params", grid))[0].items():
        got, tol = leaf.numpy(), np.full(want[name].shape, PARAM_ATOL)
        if name == "layers/qkv/b":
            tol[:, k_bias] = 2 * LR * STEPS
        floor = np.abs(grads[name]) < NOISE_FLOOR * np.abs(grads[name]).max()
        tol[floor] = 2 * LR * STEPS
        noise += int(floor.sum())
        assert (np.abs(got - want[name]) <= tol).all(), (name, np.abs(got - want[name]).max())
    assert noise <= NOISE_SHARE * sum(a.size for a in want.values()), noise


def test_tied_embedding_copies_stay_equal(ranks):
    """(2, 2, 2): each tp rank's first-stage and last-stage embed after
    STEPS steps, bit for bit."""
    by_place = {(o["dp_rank"], o["tp_rank"], o["stage"]): o["train_222"]["params"] for o in ranks}
    for (i, j, stage), params in by_place.items():
        if stage == 0:
            assert np.array_equal(params["embed"], by_place[i, j, 1]["embed"]), (i, j)
    assert ranks[0]["train_222"]["keys"] == ["embed", "layers"]
    assert ranks[1]["train_222"]["keys"] == ["embed", "final_ln", "layers"]


def test_mesh_state_resumes_bit_equal(ranks):
    """(2, 2, 2): saved whole after STEPS steps (one file), loaded and
    placed again on every rank, two steps on: params, moments, loss and
    step equal to the uninterrupted run's."""
    assert all(out["train_222"]["resume_equal"] for out in ranks)


def test_dryrun_multichip_on_the_cpu(ranks):
    """`dryrun_multichip(8, device="cpu")` on the module's eight ranks: its
    rank body ran there (`dryrun_rank`), its checks run here."""
    from sparktts_tpu_torch.parallel.dryrun import dryrun_args, dryrun_check

    summary = dryrun_check([out["dryrun"] for out in ranks],
                           dryrun_args(8, device="cpu", timeout_s=300))
    assert (summary["dp"], summary["tp"], summary["pp"]) == (2, 2, 2)
    assert np.isfinite(summary["loss"]) and summary["server_rows"] == 4
    assert summary["samples"] > 0


def test_shard_llm_refuses_pp_and_the_card_is_the_default():
    """`shard_llm` serves no stages; without a card the dry run and the
    mesh train state raise unless asked for the CPU."""
    from sparktts_tpu_torch.lm import train
    from sparktts_tpu_torch.parallel.dryrun import dryrun_multichip
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline
    from sparktts_tpu_torch.weights import init_qwen

    grid = np.arange(4).reshape(1, 2, 2)
    plain = SimpleNamespace(codec_device=None, speculative_k=0)
    with pytest.raises(ValueError, match="pp=2"):
        SparkTTSPipeline.shard_llm(plain, _fake_mesh(grid, 0))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    part = S.place(init_qwen(CFG, torch.Generator().manual_seed(0), torch.float32, "cpu"), CFG,
                   _fake_mesh(grid, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.init_train_state(part, train.make_optimizer(LR))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.load_train_state("missing", train.make_optimizer(LR), mesh=_fake_mesh(grid, 0),
                               cfg=CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(8)
