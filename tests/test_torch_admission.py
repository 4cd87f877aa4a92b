"""The port's batched and device-chained admission against the JAX package:
`prefill_many`, the fused and assembled admissions (one request and a
ladder-padded burst), clone prompts assembled on the device, the
speculative first-chunk chain and the server's validation of it.

One JAX and one port pipeline on the tiny config with the same weights
(fp32; the JAX side runs its Pallas kernels in interpret mode), greedy
engines.  First tokens, slot vectors and assembled prompts must be equal;
installed KV within 1e-5 (fp32 through a few layers, summed in another
order); a speculative chunk equal to the plain vocode path bit for bit.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import continuous as jcont
from sparktts_tpu.pipeline import SparkTTSPipeline as JaxPipeline
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.lm import continuous as tcont
from sparktts_tpu_torch.pipeline import SparkTTSPipeline
from sparktts_tpu_torch.prompt import build_clone_prompt, clone_prompt_scaffold
from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer, _Pending

KV_TOL = 1e-5
MAX_NEW = 16
BUCKET = 32
ENGINE = dict(max_slots=4, cache_len=256, prompt_pad=BUCKET)


@pytest.fixture(scope="module")
def pipelines():
    jax.clear_caches()
    jpipe = JaxPipeline(config=tiny_test_config(), lm_dtype=jnp.float32,
                        max_new_tokens=MAX_NEW, prompt_bucket=BUCKET)
    tpipe = SparkTTSPipeline(
        config=torch_tiny_config(), device="cpu", lm_dtype=torch.float32,
        max_new_tokens=MAX_NEW, prompt_bucket=BUCKET, voice_cache_size=4,
        llm_params=jax.tree.map(np.asarray, jpipe.llm_params),
        bicodec_params=jax.tree.map(np.asarray, jpipe.bicodec_params),
        wav2vec2_params=jax.tree.map(np.asarray, jpipe.w2v_params),
    )
    yield jpipe, tpipe
    jax.clear_caches()


def _wav(freq=300.0, seconds=0.5):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _guided(pipe):
    vocab_slice, extra_ids = pipe.guided_constraint("control")
    clone_slice, clone_extras = pipe.guided_constraint("clone")
    return dict(vocab_slice=vocab_slice, extra_ids=extra_ids, clone_slice=clone_slice,
                clone_extras=clone_extras, eos_ids=tuple(pipe.tokenizer.eos_ids),
                pad_id=pipe.tokenizer.pad_id, greedy=True)


def _engines(jpipe, tpipe):
    jeng = jcont.ContinuousBatchingEngine(jpipe.llm_params, jpipe.config.llm,
                                          cache_dtype=jnp.float32, **ENGINE, **_guided(jpipe))
    teng = tcont.ContinuousBatchingEngine(tpipe.llm_params, tpipe.config.llm, device="cpu",
                                          cache_dtype=torch.float32, **ENGINE, **_guided(tpipe))
    return jeng, teng


def _scaffold(pipe, text, n_glob, use_sem, prompt_text):
    scaffold, prompt_len, g_off, s_off = clone_prompt_scaffold(
        pipe.tokenizer, text, n_glob, use_sem, prompt_text)
    t_pad = -(-prompt_len // BUCKET) * BUCKET
    return np.pad(scaffold, (0, t_pad - prompt_len), constant_values=pipe.tokenizer.pad_id), \
        prompt_len, g_off, s_off


def _assert_slots_equal(jeng, teng, slots):
    js, ts = jeng.slots, teng.slots
    for name in ("cur_token", "write_pos", "position", "limit", "active", "done", "control"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for slot, t_pad in slots:
        for j, t in ((js.cache.k, ts.cache.k), (js.cache.v, ts.cache.v)):
            np.testing.assert_allclose(t[:, slot, :t_pad].numpy(),
                                       np.asarray(j)[:, slot, :t_pad], rtol=0, atol=KV_TOL)


def test_prefill_many_first_tokens_and_kv_equal_jax(pipelines):
    jpipe, tpipe = pipelines
    cfg = tpipe.config.llm
    g = _guided(tpipe)
    rng = np.random.default_rng(0)
    lens = [9, 32, 20]
    ids = np.full((3, BUCKET), tpipe.tokenizer.pad_id, np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(10, cfg.vocab_size - 10, size=n)
    control = [True, False, False]
    temps, top_ps = [0.8, 0.7, 1.0], [0.95, 0.9, 0.8]
    j_first, j_cache, _ = jcont.prefill_many(
        jpipe.llm_params, jpipe.config.llm, jnp.asarray(ids, jnp.int32), jnp.asarray(lens),
        jax.random.PRNGKey(0), jnp.float32, jnp.asarray(temps), 50, jnp.asarray(top_ps), True,
        g["vocab_slice"], g["extra_ids"], jnp.asarray(control), g["clone_slice"],
        g["clone_extras"])
    allowed = tcont.packed_allowed_mask(g["vocab_slice"], g["extra_ids"], g["clone_slice"],
                                        g["clone_extras"])
    t_first, t_cache = tcont.prefill_many(
        tpipe.llm_params, cfg, torch.from_numpy(ids), lens, torch.Generator().manual_seed(0),
        torch.float32, temps, 50, top_ps, True, g["vocab_slice"], g["extra_ids"], control,
        allowed)
    np.testing.assert_array_equal(t_first.numpy(), np.asarray(j_first))
    np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k), rtol=0, atol=KV_TOL)
    np.testing.assert_allclose(t_cache.v.numpy(), np.asarray(j_cache.v), rtol=0, atol=KV_TOL)


@pytest.mark.parametrize("kind", ["fused", "assembled"])
@pytest.mark.parametrize("n", [1, 3])
def test_admissions_install_what_jax_installs(pipelines, kind, n):
    """One admission, or a burst of three padded to the ladder's 4: the slot
    vectors equal and the installed prompt KV within KV_TOL of JAX's."""
    jpipe, tpipe = pipelines
    jeng, teng = _engines(jpipe, tpipe)
    texts = ["first words", "second one here", "third"][:n]
    prompt_texts = ["prompt words", None, "more prompt"][:n]
    wavs = [_wav(300.0), _wav(440.0), _wav(520.0)][:n]
    n_glob = tpipe.config.bicodec.speaker_encoder.token_num
    rows = {"jax": [], "port": []}
    for side, pipe in (("jax", jpipe), ("port", tpipe)):
        for text, pt, wav in zip(texts, prompt_texts, wavs):
            fn, tok_args, n_sem, s_pad = pipe.tokenize_host_prep(wav)
            use_sem = n_sem if pt is not None else 0
            scaffold, plen, g_off, s_off = _scaffold(pipe, text, n_glob, use_sem, pt)
            row = dict(tokenize_fn=fn, tok_args=tok_args, s_pad=s_pad, scaffold=scaffold,
                       g_off=g_off, s_off=s_off, n_sem=use_sem, prompt_len=plen,
                       max_new_tokens=MAX_NEW, temperature=None, top_p=None)
            if kind == "assembled":
                if side == "jax":
                    s, g = fn(*tok_args)
                else:
                    g, s = fn(*tok_args)
                row.update(global_t=g, semantic=s)
            rows[side].append(row)
    t_pads = [len(r["scaffold"]) for r in rows["port"]]
    if n > 1:  # one shape signature per burst
        t_pads = [max(t_pads)] * n
        for side in rows:
            for r in rows[side]:
                r["scaffold"] = np.pad(r["scaffold"], (0, t_pads[0] - len(r["scaffold"])),
                                       constant_values=tpipe.tokenizer.pad_id)
    for side, eng, pipe in (("jax", jeng, jpipe), ("port", teng, tpipe)):
        rs = rows[side]
        asm = pipe._assemble_fn_batch(t_pads[0], rs[0]["s_pad"])
        if n == 1:
            r = rs[0]
            args = (r["scaffold"], r["g_off"], r["s_off"], r["n_sem"], r["prompt_len"])
            if kind == "fused":
                eng.submit_fused(r["tokenize_fn"], asm, r["tok_args"], *args,
                                 max_new_tokens=MAX_NEW)
            else:
                eng.submit_assembled(asm, r["global_t"], r["semantic"], *args,
                                     max_new_tokens=MAX_NEW)
        elif kind == "fused":
            eng.submit_fused_batch(rs[0]["tokenize_fn"], asm, rs)
        else:
            eng.submit_assembled_batch(asm, rs)
    _assert_slots_equal(jeng, teng, list(enumerate(t_pads)))


@pytest.mark.parametrize("with_prompt_text", [False, True])
def test_device_assembled_prompt_equals_build_clone_prompt(pipelines, with_prompt_text):
    _, tpipe = pipelines
    prompt_text = "transcript words" if with_prompt_text else None
    g_dev, s_dev, n_sem = tpipe.tokenize_audio_device(_wav())
    g, s = g_dev.numpy(), s_dev[:, :n_sem].numpy()
    host_ids = build_clone_prompt(tpipe.tokenizer, "hello world", g,
                                  s if with_prompt_text else None, prompt_text)
    use_sem = n_sem if with_prompt_text else 0
    scaffold, prompt_len, g_off, s_off = _scaffold(tpipe, "hello world", g.shape[1], use_sem,
                                                   prompt_text)
    assert prompt_len == len(host_ids)
    dev_ids = tpipe.assemble_clone_ids(scaffold, g_dev, s_dev, g_off, s_off, use_sem).numpy()
    np.testing.assert_array_equal(dev_ids[0, :prompt_len], np.asarray(host_ids))
    assert (dev_ids[0, prompt_len:] == tpipe.tokenizer.pad_id).all()


def test_fused_path_ids_equal_the_three_program_chain(pipelines):
    """The fused admission (tokenize, assembly and prefill chained with no
    host read) decodes the greedy ids of tokenize -> assemble -> submit."""
    _, tpipe = pipelines
    _, fused = _engines(*pipelines)
    _, chain = _engines(*pipelines)
    wav, text, pt = _wav(330.0), "fused admission", "the prompt says"
    fn, tok_args, n_sem, s_pad = tpipe.tokenize_host_prep(wav)
    n_glob = tpipe.config.bicodec.speaker_encoder.token_num
    scaffold, plen, g_off, s_off = _scaffold(tpipe, text, n_glob, n_sem, pt)
    req, g_f, s_f = fused.submit_fused(fn, tpipe._assemble_fn_batch(len(scaffold), s_pad),
                                       tok_args, scaffold, g_off, s_off, n_sem, plen,
                                       max_new_tokens=MAX_NEW)
    fused.run_until_done(8)
    g_c, s_c, _ = tpipe.tokenize_audio_device(wav, cache_key=None)
    ids = tpipe.assemble_clone_ids(scaffold, g_c, s_c, g_off, s_off, n_sem)
    req_c = chain.submit(ids, MAX_NEW, mode="clone", prompt_len=plen)
    chain.run_until_done(8)
    np.testing.assert_array_equal(g_f.numpy(), g_c.numpy())
    np.testing.assert_array_equal(s_f.numpy(), s_c.numpy())
    np.testing.assert_array_equal(fused.finished[req], chain.finished[req_c])
    assert len(fused.finished[req]) > 0


def test_admission_registry_is_shared_across_engines(pipelines):
    """A signature runs its warm-up once per process: a fresh engine over the
    same pipeline adopts it from the registry."""
    _, tpipe = pipelines
    fn, tok_args, _, s_pad = tpipe.tokenize_host_prep(_wav(610.0, 2.0))
    asm = tpipe._assemble_fn_batch(64, s_pad)
    _, first = _engines(*pipelines)
    assert not first.fused_ready(tok_args, 64)
    first.warm_fused(fn, asm, tok_args, 64)
    assert first.fused_ready(tok_args, 64) and first.warm_runs == 1
    _, second = _engines(*pipelines)
    assert not second.fused_ready(tok_args, 64)
    second.warm_fused(fn, asm, tok_args, 64)
    assert second.fused_ready(tok_args, 64) and second.warm_runs == 0
    assert tpipe._assemble_fn_batch(64, s_pad) is asm
    assert tpipe.tokenize_host_prep(_wav(610.0, 2.0))[0] is fn


def test_spec_vocode_chain_multi_equals_the_plain_vocode_path(pipelines):
    """The chain's packed tokens pass through, and each row's chunk equals
    `detokenize_batch` of the same rows padded the same way bit for bit
    (a controllable row's speaker ids read from its own emission); at batch
    1 it equals the scalar `detokenize`."""
    _, tpipe = pipelines
    tok = tpipe.tokenizer
    tn = tpipe.config.bicodec.speaker_encoder.token_num
    up = tpipe._wave_upsample
    n_steps, target, max_slots = 16, 6, 4
    rng = np.random.default_rng(3)
    packed = np.zeros((max_slots, 2 * n_steps + 1), np.int32)
    sem = rng.integers(0, tok.n_semantic, size=(max_slots, n_steps))
    packed[:, :n_steps] = tok.semantic_base + sem
    globs_ctrl = rng.integers(0, tok.n_global, size=tn)
    packed[2, 0] = tok.token_id("<|start_global_token|>")
    packed[2, 1 : 1 + tn] = tok.global_base + globs_ctrl
    packed[2, 1 + tn] = tok.token_id("<|end_global_token|>")
    g1 = rng.integers(0, tok.n_global, size=(1, tn)).astype(np.int32)
    g3 = torch.from_numpy(rng.integers(0, tok.n_global, size=(1, tn)).astype(np.int32))
    specs = [(1, target, 0, g1), (2, target, tn + 2, None), (3, target, 0, g3)]
    flat = tpipe.spec_vocode_chain_multi(specs, 4)(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(flat[: packed.size], packed.reshape(-1))
    chunks = flat[packed.size :].view(np.float32).reshape(4, target * up)
    rows = [(g1, sem[1, :target]), (globs_ctrl[None], sem[2, tn + 2 : tn + 2 + target]),
            (g3.numpy(), sem[3, :target])]
    rows += [rows[0]]
    plain = tpipe.detokenize_batch(np.concatenate([g for g, _ in rows]), [s for _, s in rows])
    for got, want in zip(chunks, plain):
        np.testing.assert_array_equal(got, want)
    one = tpipe.spec_vocode_chain(1, target, g1)(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(one[packed.size :].view(np.float32),
                                  tpipe.detokenize(g1, sem[1, :target][None]))


# ---------------------------------------------------------------- _apply_specs


@pytest.fixture(scope="module")
def server(pipelines):
    return ContinuousTTSServer(pipelines[1], max_slots=2, steps_per_dispatch=8)


def _stream_pending(gender=None, globals_known=True):
    p = _Pending(text="x", prompt_wav=None, prompt_text=None, gender=gender,
                 pitch="moderate" if gender else None, speed="moderate" if gender else None,
                 max_new_tokens=8, future=None, chunk_queue=asyncio.Queue(), stream_target=2,
                 stream_schedule=iter([4, 8, 16]))
    if globals_known:
        p.global_tokens = np.zeros((1, 4), np.int32)
    return p


def test_apply_specs_rejects_a_non_semantic_head(server):
    tok, up = server.pipe.tokenizer, server.pipe._wave_upsample
    bits = np.arange(2 * up, dtype=np.float32).view(np.int32)
    p = _stream_pending()
    server.inflight = {7: p}
    bad = np.asarray([tok.semantic_base, tok.eos_ids[0], tok.semantic_base + 1])
    assert server._apply_specs(([(7, 0, 2, 0, False)], None), bits, {7: bad}) == set()
    assert p.stream_emitted == 0 and not p.stream_buf
    p = _stream_pending()
    server.inflight = {9: p}
    good = np.asarray([tok.semantic_base + 5, tok.semantic_base + 6, tok.semantic_base + 7])
    assert server._apply_specs(([(9, 0, 2, 0, False)], None), bits, {9: good}) == {9}
    assert p.stream_emitted == 2 and p.stream_buf == [5, 6, 7] and p.stream_target == 4
    np.testing.assert_array_equal(p.chunk_queue.get_nowait(), bits.view(np.float32))


def test_apply_specs_splits_rows_in_order_and_contains_a_miss(server):
    tok, up = server.pipe.tokenizer, server.pipe._wave_upsample
    a, b = _stream_pending(), _stream_pending()
    server.inflight = {1: a, 2: b}
    wav_a = np.arange(2 * up, dtype=np.float32)
    wav_b = wav_a + 1000.0
    chained = np.concatenate([wav_a, wav_b]).view(np.int32)
    good = np.asarray([tok.semantic_base + 1, tok.semantic_base + 2])
    bad = np.asarray([tok.eos_ids[0], tok.semantic_base + 3])
    entries = [(1, 0, 2, 0, False), (2, 1, 2, 0, False)]
    assert server._apply_specs((entries, None), chained, {1: bad, 2: good}) == {2}
    assert a.stream_emitted == 0 and not a.stream_buf
    np.testing.assert_array_equal(b.chunk_queue.get_nowait(), wav_b)


def test_apply_specs_control_layout(server):
    tok, up = server.pipe.tokenizer, server.pipe._wave_upsample
    tn = server.pipe.config.bicodec.speaker_encoder.token_num
    bits = np.arange(2 * up, dtype=np.float32).view(np.int32)
    layout = ([tok.token_id("<|start_global_token|>")] + [tok.global_base + i for i in range(tn)]
              + [tok.token_id("<|end_global_token|>"), tok.semantic_base + 5,
                 tok.semantic_base + 6])
    entries = [(4, 0, 2, tn + 2, True)]
    p = _stream_pending(gender="female", globals_known=False)
    server.inflight = {4: p}
    assert server._apply_specs((entries, None), bits, {4: np.asarray(layout)}) == {4}
    np.testing.assert_array_equal(p.global_tokens, np.arange(tn, dtype=np.int32)[None, :])
    assert p.stream_emitted == 2 and p.stream_buf == [5, 6]
    p = _stream_pending(gender="female", globals_known=False)
    server.inflight = {4: p}
    broken = list(layout)
    broken[1 + tn] = tok.semantic_base  # the end marker replaced
    assert server._apply_specs((entries, None), bits, {4: np.asarray(broken)}) == set()
    assert p.global_tokens is None and p.stream_emitted == 0
