"""The port's tensor-parallel serving (`sparktts_tpu_torch/parallel/`)
against the JAX package's single-device results.

Two gloo ranks on the CPU, one spawned row for the module (`worker.spawn`),
tiny config in fp32 with the LM's weights x4 (so that greedy decoding of the
random LM does not repeat one id).  The rows run every case at once and
return their results; the tests below read them:

  * the shard round trip and the head alignment of `qkv` and `gateup`
    (no ranks needed);
  * tp = 2 greedy `generate` (plain and guided: every guided row of the
    tiny vocabulary lies on rank 1) equal to JAX's single-device `generate`,
    and the prefill's logits within 1e-5 of the peak of JAX's;
  * the two ranks' ids equal at every step, greedy and sampled, from
    `generate` and from a sampled engine;
  * the tp = 2 dense engine with a staggered join equal to JAX's unsharded
    engine (JAX's own sharded-engine test fails on the reference side);
  * through the launcher (`worker.serve`, a second spawned row): a tp = 2
    `ContinuousTTSServer` led from rank 0, rank 1 following, whose offline
    and streamed audio equals the port's tp = 1 server's bit for bit, with
    both clone admissions fused as in JAX (`tests/test_parallel.py:226`);
    a sampled one, every call's results checked equal on both ranks by the
    leader; a call that fails on both ranks alike leaves the row serving,
    one that fails on the follower only breaks it;
  * the paged engine and a quantized tree refuse a mesh;
  * four ranks as two hosts of two: `make_multihost_mesh` keeps each tp row
    within a host, and a dp all-reduce crosses the hosts;
  * the launcher computes on the card unless asked for the CPU.

JAX is imported inside the tests only: the ranks import this module.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from sparktts_tpu_torch.config import QwenConfig, tiny_test_config
from sparktts_tpu_torch.parallel import shardings as S
from sparktts_tpu_torch.parallel import worker

MAX_NEW = 16
GEN_NEW = 12
GUIDED = dict(vocab_slice=(288, 416), extra_ids=(256, 260, 300))
# the engine case of tests/test_parallel.py
ENGINE_CFG = QwenConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        head_dim=16, eos_token_id=0, pad_token_id=1)
ENGINE_KW = dict(max_slots=4, cache_len=64, prompt_pad=16, eos_ids=(), pad_id=1, greedy=True)
SERVER_KW = dict(max_slots=4, steps_per_dispatch=4, greedy=True, vocode_batch=False,
                 fused_warm="sync")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _left_padded(lengths, t_pad, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), t_pad), 1, np.int64)
    mask = np.zeros((len(lengths), t_pad), bool)
    for i, n in enumerate(lengths):
        ids[i, t_pad - n:] = rng.integers(5, vocab - 6, size=n)
        mask[i, t_pad - n:] = True
    return ids, mask


def _wav(freq, seconds=1.0):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _pipeline(trees):
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    return SparkTTSPipeline(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32,
                            max_new_tokens=MAX_NEW, prompt_bucket=32, llm_params=trees["llm"],
                            bicodec_params=trees["bicodec"], wav2vec2_params=trees["w2v"])


async def _serve(server):
    """The JAX test's two requests: an offline clone, then a streamed one."""
    await server.start()
    offline = await server.synthesize("hello sharded world", prompt_wav=_wav(320.0))
    chunks = [c async for c in server.synthesize_streaming("stream me", prompt_wav=_wav(250.0))]
    await server.stop()
    return offline, np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _run_server(pipe, **kw):
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    server = ContinuousTTSServer(pipe, **dict(SERVER_KW, **kw))
    offline, stream = asyncio.new_event_loop().run_until_complete(_serve(server))
    return offline, stream, dict(server.stats)


# ---------------------------------------------------------------------------
# what the ranks run (module-level functions: they are pickled to the ranks)
# ---------------------------------------------------------------------------


def _row(mesh, inputs):
    """The tp = 2 cases every rank runs alike (no leader); returns its
    results."""
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.lm.qwen import init_kv_cache, prefill_inputs, qwen_forward
    from sparktts_tpu_torch.weights import qwen_place

    cfg = tiny_test_config().llm
    out = {}
    shard, scfg = qwen_place(inputs["llm"], cfg, mesh, dtype=torch.float32)
    ids, mask = (torch.from_numpy(a) for a in inputs["prompts"])
    kw = dict(max_new_tokens=GEN_NEW, cache_len=ids.shape[1] + GEN_NEW, eos_ids=(300,), pad_id=1,
              cache_dtype=torch.float32)
    for name, extra in (("plain", {}), ("guided", GUIDED)):
        toks, lens = generate(shard, scfg, ids, mask, torch.Generator().manual_seed(3),
                              greedy=True, **kw, **extra)
        out[f"greedy_{name}"] = (toks.numpy(), lens.numpy())
        toks, _ = generate(shard, scfg, ids, mask, torch.Generator().manual_seed(3),
                           greedy=False, **kw, **extra)
        out[f"sampled_{name}"] = toks.numpy()
    pos, bias = prefill_inputs(mask, ids.shape[1])
    with torch.inference_mode():
        cache = init_kv_cache(scfg, ids.shape[0], ids.shape[1], torch.float32, "cpu")
        logits, _ = qwen_forward(shard, scfg, ids, pos, cache, 0, bias, **GUIDED)
    out["logits"] = logits.numpy()
    out["kv_heads"] = cache.k.shape[3]

    eshard, ecfg = qwen_place(inputs["engine_tree"], ENGINE_CFG, mesh, dtype=torch.float32)
    eng = ContinuousBatchingEngine(eshard, ecfg, cache_dtype=torch.float32, device="cpu",
                                   mesh=mesh, **ENGINE_KW)
    p0, p1 = inputs["engine_prompts"]
    r0 = eng.submit(p0, max_new_tokens=12)
    eng.step(4)
    r1 = eng.submit(p1, max_new_tokens=12)  # a staggered join mid-flight
    eng.run_until_done(6)
    out["engine"] = (eng.finished[r0], eng.finished[r1])
    eng = ContinuousBatchingEngine(eshard, ecfg, cache_dtype=torch.float32, device="cpu",
                                   mesh=mesh, **dict(ENGINE_KW, greedy=False, seed=7))
    r0 = eng.submit(p0, max_new_tokens=12)
    eng.step(4)
    r1 = eng.submit(p1, max_new_tokens=12)
    eng.run_until_done(6)
    out["engine_sampled"] = (eng.finished[r0], eng.finished[r1])
    return out


def _led_setup(mesh, trees):
    pipe = _pipeline(trees)
    pipe.shard_llm(mesh)
    return pipe


def _led_main(pipe, mesh, trees):
    """Rank 0 of the launcher's row: the greedy and the sampled server, then
    a small engine's faults (one on every rank, then one on the follower
    only)."""
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine

    leader = mesh.tp.leader
    out = {"server": _run_server(pipe)}
    out["server_sampled"] = _run_server(pipe, greedy=False)
    out["checked"] = leader.checked
    leader.ping()
    eng = ContinuousBatchingEngine(pipe.llm_params, pipe.config.llm, max_slots=2, cache_len=64,
                                   prompt_pad=16, cache_dtype=torch.float32, device="cpu",
                                   mesh=mesh)
    try:
        eng.release_slot(7)  # no slot 7: fails on both ranks before any collective
    except IndexError as e:
        out["symmetric"] = repr(e)
    req = eng.submit([5, 6, 7, 8, 9], max_new_tokens=4)
    eng.run_until_done(4)
    out["after_symmetric"] = eng.finished[req]
    try:
        eng.close()  # fails on the follower only
    except worker.RowBroken as e:
        out["broken"] = str(e)
    try:
        eng.release_slot(0)
    except worker.RowBroken as e:
        out["after_broken"] = str(e)
    return out


def _led_follow(pipe, mesh, trees):
    from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine

    close = ContinuousBatchingEngine.close

    def faulty_close(self):
        if self.max_slots == 2:
            raise RuntimeError("a fault on the follower only")
        return close(self)

    ContinuousBatchingEngine.close = faulty_close
    try:
        return worker.follow(pipe, mesh)
    except worker.RowBroken as e:
        return dict(e.report, aborted=str(e))


def _hosts(mesh):
    """Four ranks as two hosts of two."""
    import torch.distributed as dist

    from sparktts_tpu_torch.parallel.multihost import make_multihost_mesh

    mh = make_multihost_mesh(tp=2, local_size=2, device=mesh.device)
    x = torch.tensor([float(mh.rank + 1)])
    dist.all_reduce(x, group=mh.dp_group)
    y = torch.tensor([float(mh.rank + 1)])
    mh.tp.all_reduce(y)
    return {"shape": mh.shape, "row": mh.tp.ranks, "dp_sum": float(x), "tp_sum": float(y),
            "dp_rank": mh.dp_rank}


# ---------------------------------------------------------------------------
# fixtures: the references and the rows' results
# ---------------------------------------------------------------------------


def _scaled(tree, factor=4):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return np.asarray(tree) * np.float32(factor)


@pytest.fixture(scope="module")
def jax_refs():
    import jax
    import jax.numpy as jnp

    from sparktts_tpu.config import QwenConfig as JaxQwenConfig
    from sparktts_tpu.config import tiny_test_config as jax_tiny
    from sparktts_tpu.lm import generate as jgen
    from sparktts_tpu.lm import qwen as jq
    from sparktts_tpu.lm.continuous import ContinuousBatchingEngine as JaxEngine
    from sparktts_tpu.lm.qwen import init_qwen as jax_init_qwen

    jcfg = jax_tiny().llm
    llm = _scaled(jax.tree.map(np.asarray, jq.init_qwen(jax.random.PRNGKey(0), jcfg,
                                                          dtype=jnp.float32)))
    ids, mask = _left_padded([20, 32, 9], 32, jcfg.vocab_size, seed=3)
    jp = jax.tree.map(jnp.asarray, llm)
    kw = dict(max_new_tokens=GEN_NEW, cache_len=32 + GEN_NEW, eos_ids=(300,), pad_id=1,
              greedy=True, cache_dtype=jnp.float32)
    refs = {}
    for name, extra in (("plain", {}), ("guided", GUIDED)):
        toks, lens = jgen.generate(jp, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                                   jax.random.PRNGKey(0), **kw, **extra)
        refs[f"greedy_{name}"] = (np.asarray(toks), np.asarray(lens))
    jpos, jbias = jq.prefill_inputs(jnp.asarray(mask), 32)
    logits, _ = jq.qwen_forward(jp, jcfg, jnp.asarray(ids, jnp.int32), jpos,
                                jq.init_kv_cache(jcfg, 3, 32, jnp.float32), 0, jbias, **GUIDED)
    refs["logits"] = np.asarray(logits)

    ecfg = JaxQwenConfig(**dataclasses.asdict(ENGINE_CFG))
    etree = _scaled(jax.tree.map(np.asarray, jax_init_qwen(jax.random.PRNGKey(0), ecfg)))
    rng = np.random.default_rng(11)
    prompts = (rng.integers(5, 250, size=10).tolist(), rng.integers(5, 250, size=7).tolist())
    eng = JaxEngine(jax.tree.map(jnp.asarray, etree), ecfg, cache_dtype=jnp.float32,
                    **ENGINE_KW)
    r0 = eng.submit(prompts[0], max_new_tokens=12)
    eng.step(4)
    r1 = eng.submit(prompts[1], max_new_tokens=12)
    eng.run_until_done(6)
    refs["engine"] = (np.asarray(eng.finished[r0]), np.asarray(eng.finished[r1]))
    return refs, dict(llm=llm, prompts=(ids, mask), engine_tree=etree, engine_prompts=prompts)


@pytest.fixture(scope="module")
def trees(jax_refs):
    """The server's trees: the scaled LM and a seeded codec of the port."""
    base = _pipeline(dict(llm=jax_refs[1]["llm"], bicodec=None, w2v=None))
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} if isinstance(t, dict) else (  # noqa
        [to_np(v) for v in t] if isinstance(t, (list, tuple)) else t.numpy())
    return dict(llm=jax_refs[1]["llm"], bicodec=to_np(base.bicodec_params),
                w2v=to_np(base.w2v_params))


@pytest.fixture(scope="module")
def rows(jax_refs):
    return worker.spawn(_row, 2, "gloo", args=(jax_refs[1],), device="cpu", threads=1,
                        timeout_s=300)


@pytest.fixture(scope="module")
def led(trees):
    """The launcher's row: rank 0's results, then rank 1's."""
    return worker.serve(_led_setup, _led_main, 2, backend="gloo", args=(trees,),
                        follow=_led_follow, device="cpu", threads=1, timeout_s=300)


@pytest.fixture(scope="module")
def tp1_server(trees):
    return _run_server(_pipeline(trees))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _numbered_tree(cfg: QwenConfig, layers: int = 2) -> dict:
    """A whole tree whose every column holds its own index (so a shard's
    columns name themselves)."""
    hd, h, inter, v = cfg.head_dim, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * hd
    q_dim = cfg.num_attention_heads * hd

    def cols(rows, n):
        return torch.arange(n, dtype=torch.float32).expand(layers, rows, n).clone()

    return {
        "embed": torch.arange(v, dtype=torch.float32)[:, None].expand(v, h).clone(),
        "layers": {
            "ln1": {"gamma": torch.ones(layers, h)}, "ln2": {"gamma": torch.ones(layers, h)},
            "qkv": {"w": cols(h, qkv), "b": torch.arange(qkv, dtype=torch.float32).expand(
                layers, qkv).clone()},
            "o": {"w": cols(h, q_dim).transpose(1, 2).contiguous()},
            "gateup": {"w": cols(h, 2 * inter)},
            "down": {"w": cols(h, inter).transpose(1, 2).contiguous()},
        },
        "final_ln": {"gamma": torch.ones(h)},
        "lm_head": {"w": torch.arange(v, dtype=torch.float32).expand(h, v).clone()},
    }


def test_shards_are_head_aligned_and_round_trip():
    """At the 0.5B head layout (14 q heads, 2 KV heads): rank r holds q heads
    [7r, 7r+7), KV head r of k and of v (with their biases), its half of
    gate and of up, the matching rows of o and down, its vocabulary rows;
    the shards rebuild the tree exactly, and so do the cache, batch and
    stage cuts."""
    cfg = QwenConfig(vocab_size=10, hidden_size=8, intermediate_size=6, num_hidden_layers=2,
                     num_attention_heads=14, num_key_value_heads=2, head_dim=4,
                     tie_word_embeddings=False)
    tree = _numbered_tree(cfg)
    hd, q_dim, kv_dim = 4, 56, 8
    shards = [S.shard_qwen(tree, cfg, r, 2) for r in range(2)]
    for r, sh in enumerate(shards):
        got = sh["layers"]["qkv"]["w"][0, 0].long().tolist()
        want = (list(range(r * 7 * hd, (r + 1) * 7 * hd))
                + list(range(q_dim + r * hd, q_dim + (r + 1) * hd))
                + list(range(q_dim + kv_dim + r * hd, q_dim + kv_dim + (r + 1) * hd)))
        assert got == want
        assert sh["layers"]["qkv"]["b"][0].long().tolist() == want
        assert sh["layers"]["gateup"]["w"][0, 0].long().tolist() == (
            list(range(3 * r, 3 * r + 3)) + list(range(6 + 3 * r, 6 + 3 * r + 3)))
        assert sh["layers"]["o"]["w"][0, :, 0].long().tolist() == want[:7 * hd]
        assert sh["layers"]["down"]["w"][0, :, 0].long().tolist() == list(range(3 * r, 3 * r + 3))
        assert sh["embed"][:, 0].long().tolist() == list(range(5 * r, 5 * r + 5))
        assert sh["lm_head"]["w"][0].long().tolist() == list(range(5 * r, 5 * r + 5))
        scfg = S.shard_config(cfg, 2)
        assert (scfg.num_attention_heads, scfg.num_key_value_heads) == (7, 1)
    back = S.unshard_qwen(shards, cfg)
    for path, a, b in _pairs(tree, back):
        assert torch.equal(a, b), path
    cache = torch.randn(2, 3, 5, 2, 4)
    from sparktts_tpu_torch.lm.qwen import KVCache

    kv = S.unshard_kv_cache([S.shard_kv_cache(KVCache(cache, -cache), r, 2) for r in range(2)])
    assert torch.equal(kv.k, cache) and torch.equal(kv.v, -cache)
    batch = torch.randn(6, 5)
    assert torch.equal(S.unshard_batch([S.shard_batch(batch, r, 3) for r in range(3)]), batch)
    stages = [S.stage_layers(tree["layers"], s, 2) for s in range(2)]
    assert stages[1]["qkv"]["w"].shape[0] == 1
    for path, a, b in _pairs(tree["layers"], S.unstage_layers(stages)):
        assert torch.equal(a, b), path


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.mark.parametrize("name", ["plain", "guided"])
def test_tp_generate_equals_jax_single_device(rows, jax_refs, name):
    want_toks, want_lens = jax_refs[0][f"greedy_{name}"]
    assert len(set(want_toks.reshape(-1).tolist())) > 3, "the reference repeats one id"
    for r, out in enumerate(rows):
        toks, lens = out[f"greedy_{name}"]
        np.testing.assert_array_equal(toks, want_toks, err_msg=f"rank {r}")
        np.testing.assert_array_equal(lens, want_lens, err_msg=f"rank {r}")


def test_tp_prefill_logits_match_jax(rows, jax_refs):
    """Each rank holds 1 of the 2 KV heads, and its guided logits (all on
    rank 1's vocabulary rows) are within 1e-5 of the peak of JAX's."""
    want = jax_refs[0]["logits"]
    mask = jax_refs[1]["prompts"][1][:, :, None]
    for out in rows:
        assert out["kv_heads"] == 1
        got = out["logits"]
        assert got.shape == want.shape
        err = np.abs(np.where(mask, got - want, 0)).max()
        assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("kind", ["greedy_plain", "greedy_guided", "sampled_plain",
                                  "sampled_guided"])
def test_tp_ranks_commit_the_same_ids(rows, kind):
    a, b = (np.asarray(out[kind][0] if kind.startswith("greedy") else out[kind]) for out in rows)
    np.testing.assert_array_equal(a, b)


def test_tp_engine_staggered_join_equals_jax_engine(rows, jax_refs):
    want = jax_refs[0]["engine"]
    assert len(set(np.concatenate(want).tolist())) > 3, "the reference repeats one id"
    for r, out in enumerate(rows):
        for got, ref in zip(out["engine"], want):
            np.testing.assert_array_equal(got, ref, err_msg=f"rank {r}")


def test_tp_sampled_engine_ranks_agree(rows):
    """A sampled engine on a mesh: both ranks draw from the engine's seed
    and commit the same ids, with a staggered join."""
    a, b = (out["engine_sampled"] for out in rows)
    assert len(set(np.concatenate(a).tolist())) > 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tp_server_audio_equals_tp1_server(led, tp1_server):
    """Led from rank 0 with rank 1 following every engine call: offline and
    streamed audio bit-equal to the tp = 1 server's, both admissions fused."""
    offline, stream, stats = led[0]["server"]
    ref_off, ref_stream, ref_stats = tp1_server
    assert offline.size > 0 and stream.size > 0
    np.testing.assert_array_equal(offline, ref_off)
    np.testing.assert_array_equal(stream, ref_stream)
    assert stats["fused_admissions"] == ref_stats["fused_admissions"] == 2, stats
    assert led[1]["calls"] > 10


def test_tp_sampled_server_ranks_agree(led):
    """A sampled server on the row: the leader checked every call of both
    servers (the follower's ids and slot vectors hashed equal to its own),
    the audio is finite, and the follower took a ping between calls."""
    offline, stream, _ = led[0]["server_sampled"]
    assert offline.size > 0 and stream.size > 0
    assert np.isfinite(offline).all() and np.isfinite(stream).all()
    assert led[0]["checked"] > 20
    assert led[1]["pings"] >= 1


def test_tp_row_survives_a_symmetric_fault_and_breaks_on_a_lone_one(led):
    """A call that fails on both ranks raises on the leader and the row
    serves on (the next request decodes); one that fails on the follower
    only breaks the row: the leader raises `RowBroken` for it and for every
    later call, and the follower leaves with it."""
    main, follower = led
    assert "IndexError" in main["symmetric"]
    assert len(main["after_symmetric"]) > 0
    assert "engine_call close" in main["broken"]
    assert "a fault on the follower only" in main["broken"]
    assert main["after_broken"] == main["broken"]
    assert follower["aborted"] == main["broken"]


def test_launcher_computes_on_the_card_unless_asked():
    """No device named: the rank's card, whatever the backend (raising
    here, with no card); the launchers default to NCCL."""
    import inspect

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_rank(0, 1, "gloo", "tcp://127.0.0.1:1", _hosts)
    for fn in (worker.spawn, worker.serve):
        assert inspect.signature(fn).parameters["backend"].default == "nccl"


def test_paged_mesh_and_quantized_shards_raise(trees):
    from sparktts_tpu_torch.lm.paged import PagedContinuousEngine
    from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer
    from sparktts_tpu_torch.weights import qwen_state

    cfg = tiny_test_config().llm
    whole = qwen_state(trees["llm"], "cpu", torch.float32)
    with pytest.raises(ValueError, match="tensor-parallel"):
        PagedContinuousEngine(whole, cfg, max_slots=2, n_pages=8, page_size=32,
                              pages_per_slot=4, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="quantized"):
        S.shard_qwen(quantize_qwen_int8(whole), cfg, 0, 2)
    pipe = _pipeline(trees)
    pipe.mesh = object()  # as shard_llm leaves it
    with pytest.raises(ValueError, match="paged KV"):
        ContinuousTTSServer(pipe, paged=True)


def test_multihost_rows_stay_within_a_host():
    """Ranks 0-1 are host 0, 2-3 host 1: each tp row is one host's pair, and
    the dp column all-reduce sums across the hosts (1 + 3, 2 + 4)."""
    out = worker.spawn(_hosts, 4, "gloo", device="cpu", threads=1, timeout_s=120)
    assert [o["shape"] for o in out] == [{"dp": 2, "tp": 2, "pp": 1}] * 4
    assert [o["row"] for o in out] == [(0, 1), (0, 1), (2, 3), (2, 3)]
    assert [o["dp_sum"] for o in out] == [4.0, 6.0, 4.0, 6.0]
    assert [o["tp_sum"] for o in out] == [3.0, 3.0, 7.0, 7.0]
    assert [o["dp_rank"] for o in out] == [0, 0, 1, 1]


# the 0.5B model's head layout (kernels 1 and 2 take 64-wide heads, 7 query
# heads a KV head), two narrow layers
CARD_CFG = QwenConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=14, num_key_value_heads=2,
                      head_dim=64, eos_token_id=0, pad_token_id=1)


def _nccl_generate(mesh, tree, ids, mask):
    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.weights import qwen_place

    shard, scfg = qwen_place(tree, CARD_CFG, mesh)
    toks, _ = generate(shard, scfg, torch.from_numpy(ids).to(mesh.device),
                       torch.from_numpy(mask).to(mesh.device), torch.Generator(mesh.device),
                       GEN_NEW, 32 + GEN_NEW, greedy=True, **GUIDED)
    return toks.cpu().numpy()


@pytest.mark.cuda
def test_tp_over_two_cards_with_nccl():
    """tp = 2 over NCCL on cuda:0 and cuda:1, decode units captured with
    their all-reduces: each rank's greedy ids equal the one-card ids.
    Needs two cards; skips on one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.weights import init_qwen, qwen_state

    cfg = CARD_CFG
    tree = _scaled(_to_np(init_qwen(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")))
    ids, mask = _left_padded([20, 32, 9], 32, cfg.vocab_size, seed=3)
    whole = qwen_state(tree, "cuda:0", torch.bfloat16)
    want, _ = generate(whole, cfg, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(),
                       torch.Generator("cuda"), GEN_NEW, 32 + GEN_NEW, greedy=True, **GUIDED)
    got = worker.spawn(_nccl_generate, 2, "nccl", args=(tree, ids, mask), timeout_s=300)
    for toks in got:
        np.testing.assert_array_equal(toks, want.cpu().numpy())


def _to_np(t):
    if isinstance(t, dict):
        return {k: _to_np(v) for k, v in t.items()}
    return t.numpy()
