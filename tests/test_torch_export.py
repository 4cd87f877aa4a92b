"""The port's export (`sparktts_tpu_torch/export.py`) against the live port
and the JAX package, the cases of `tests/test_export.py`.

A toy program round trip; the tiny pipeline's five artifacts (LM weights
x4, so that greedy decoding does not repeat one id), reloaded: the vocoder
equals the live `bicodec_detokenize` and JAX's within 1e-5, and greedy ids
from `lm_prefill` + `lm_decode` equal the live `generate`'s and JAX's; the
same for an int8 LM.  The exported `vocoder` and `lm_decode` hold their
`sparktts_torch::` kernel ops, and `export_program` refuses a program that
lacks an op it must hold (a plain version traced in a kernel's place).  On
the CPU a loaded program runs its module eagerly (nothing captured).

The `cuda`-marked case holds a loaded `lm_decode` at full width on the card,
replayed as a CUDA graph, to the eager run of its module.  JAX is imported
inside the cases that compare with it, so that case runs where JAX is not
installed: `python -m pytest --noconftest -m cuda tests/test_torch_export.py`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sparktts_tpu_torch import export as EXP
from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize
from sparktts_tpu_torch.config import tiny_test_config
from sparktts_tpu_torch.kernels import decode_attention, vocoder_fusion
from sparktts_tpu_torch.kernels.ops import graph_ops
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.lm.quant import quantize_qwen_int8
from sparktts_tpu_torch.pipeline import SparkTTSPipeline

WAV_TOL = 1e-5
PROMPT, NEW = 16, 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread for this file: under pytest-xdist
    each worker's own pool would oversubscribe the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(tree, factor=4):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return tree * factor


@pytest.fixture(scope="module")
def pipe():
    p = SparkTTSPipeline(config=tiny_test_config(), device="cpu", lm_dtype=torch.float32,
                         max_new_tokens=8, prompt_bucket=32)
    p.llm_params = _scaled(p.llm_params)
    return p


@pytest.fixture(scope="module")
def artifacts(pipe, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifacts")
    manifest = EXP.export_pipeline_artifacts(pipe, out, wav_seconds=1.0, vocoder_tokens=16,
                                             prompt_len=PROMPT, decode_len=NEW)
    return out, manifest


def _jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def test_export_roundtrip_simple(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 16, generator=g)
    x = torch.randn(4, 16, generator=g)

    def fn(x):
        return torch.tanh(x @ w)

    assert EXP.export_program(fn, (x,), tmp_path / "f.pt2") == {}
    loaded = EXP.load_program(tmp_path / "f.pt2")
    torch.testing.assert_close(loaded(x), fn(x), rtol=1e-6, atol=0)


def test_host_constants_move_to_the_card_with_their_checks(tmp_path):
    """A table built with numpy in the traced code is a host constant that
    the graph copies and checks to lie on the CPU at every call; moved to
    the card (here the meta device stands for it), the checks name the card
    (on the card the copies are then device to device, which a CUDA graph
    captures).  On the CPU nothing moves."""
    w = torch.randn(3, generator=torch.Generator().manual_seed(0))

    def fn(x):
        c = torch.from_numpy(np.arange(3, dtype=np.float32)).to(x.device)
        return x * w + c + torch.as_tensor(np.ones(3, np.float32), device=x.device)

    EXP.export_program(fn, (torch.randn(3),), tmp_path / "c.pt2")
    program = EXP.load_program(tmp_path / "c.pt2")
    x = torch.randn(3, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(program(x), fn(x), rtol=0, atol=0)
    assert program.captured == {}
    card = torch.device("meta")
    assert EXP._host_constants_to_card(program.module, card) == 3  # w and the two tables
    assert all(t.device == card for *_, t in EXP._tensor_attrs(program.module))
    checks = [n for n in program.module.graph.nodes
              if n.target is torch.ops.aten._assert_tensor_metadata.default]
    assert len(checks) == 2 and all(n.kwargs["device"] == card for n in checks)


def test_export_refuses_a_program_without_its_kernel_op(pipe, tmp_path):
    """The wrapper records its op while exporting; the plain version traced
    in its place is refused."""
    unit = pipe.bicodec_params["decoder"]["blocks"][0]["res_units"][0]
    c = unit["conv1"]["w"].shape[-1]
    x = torch.randn(1, 8, c, generator=torch.Generator().manual_seed(1))
    before = vocoder_fusion.launches
    found = EXP.export_program(lambda x: vocoder_fusion.fused_residual_unit(unit, x, 3), (x,),
                               tmp_path / "ru.pt2", kernels=("fused_residual_unit",))
    assert found == {"fused_residual_unit": 1} and vocoder_fusion.launches == before
    torch.testing.assert_close(EXP.load_program(tmp_path / "ru.pt2")(x),
                               vocoder_fusion.fused_residual_unit_plain(unit, x, 3),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="lacks the kernel ops"):
        EXP.export_program(lambda x: vocoder_fusion.fused_residual_unit_plain(unit, x, 3), (x,),
                           tmp_path / "plain.pt2", kernels=("fused_residual_unit",))


def test_pipeline_artifacts_and_their_ops(artifacts):
    out, manifest = artifacts
    assert set(manifest) == {"mel", "audio_tokenize", "vocoder", "lm_prefill", "lm_decode"}
    for rel in manifest.values():
        assert (out / rel).stat().st_size > 0
    assert (out / "manifest.json").exists()
    vocode = EXP.load_program(out / "vocoder.pt2")
    # the codec's own kernels (7 and 8) stand in every convolution and linear
    assert vocode.ops == {"fused_residual_unit": 6, "codec_linear": 23, "codec_conv1d": 5,
                          "codec_conv_transpose1d": 2, "depthwise_conv1d": 8} and vocode.fp32
    assert EXP.load_program(out / "mel.pt2").ops == {"codec_bmm": 3}
    decode = EXP.load_program(out / "lm_decode.pt2")
    assert decode.ops == {"dense_decode_attention": 2} and not decode.fp32
    assert graph_ops(decode.module.graph) == decode.ops
    assert EXP.load_program(out / "lm_prefill.pt2").ops == {}


def test_vocoder_artifact_equals_live_and_jax(pipe, artifacts):
    import jax
    import jax.numpy as jnp

    from sparktts_tpu.codec.bicodec import bicodec_detokenize as jax_detokenize
    from sparktts_tpu.config import tiny_test_config as jax_tiny_config

    out, _ = artifacts
    vocode = EXP.load_program(out / "vocoder.pt2")
    rng = np.random.default_rng(0)
    sem = rng.integers(0, 64, size=(1, 16))
    glob = rng.integers(0, 8, size=(1, pipe.config.bicodec.speaker_encoder.token_num))
    wav_art = vocode(torch.from_numpy(sem), torch.from_numpy(glob)).numpy()
    with torch.inference_mode():
        wav_live = bicodec_detokenize(pipe.bicodec_params, pipe.config.bicodec,
                                      torch.from_numpy(sem), torch.from_numpy(glob)).numpy()
    wav_jax = np.asarray(jax.jit(jax_detokenize, static_argnums=1)(
        _jax(pipe.bicodec_params), jax_tiny_config().bicodec, jnp.asarray(sem, jnp.int32),
        jnp.asarray(glob, jnp.int32)))
    np.testing.assert_allclose(wav_art, wav_live, rtol=WAV_TOL, atol=WAV_TOL)
    np.testing.assert_allclose(wav_art, wav_jax, rtol=WAV_TOL, atol=WAV_TOL)


def test_codec_artifacts_equal_live(pipe, artifacts):
    """mel and audio_tokenize (wav2vec2 + BiCodec) reloaded: the live
    path's numbers (the same fp32 ops, the codec's kernel ops in the
    program, whose CPU implementations are the plain versions)."""
    from sparktts_tpu_torch.codec.bicodec import bicodec_tokenize
    from sparktts_tpu_torch.dsp.mel import make_mel_basis, mel_spectrogram
    from sparktts_tpu_torch.nn.wav2vec2 import wav2vec2_features

    out, _ = artifacts
    cfg = pipe.config
    meta = json.loads((out / "manifest.json").read_text())
    rng = np.random.default_rng(4)
    wav, ref = (torch.from_numpy((0.3 * rng.standard_normal((1, meta[n]))).astype(np.float32))
                for n in ("wav_len", "ref_len"))
    with torch.inference_mode():
        mel = mel_spectrogram(ref, make_mel_basis(cfg.bicodec.mel_params))
        tokens = bicodec_tokenize(pipe.bicodec_params, cfg.bicodec,
                                  wav2vec2_features(pipe.w2v_params, wav, cfg.wav2vec2), ref)
    mel_program = EXP.load_program(out / "mel.pt2")
    torch.testing.assert_close(mel_program(ref), mel, rtol=1e-5, atol=1e-5)
    assert mel_program.captured == {}  # the CPU runs the module eagerly
    for got, want in zip(EXP.load_program(out / "audio_tokenize.pt2")(wav, ref), tokens):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _artifact_greedy(out, ids):
    prefill = EXP.load_program(out / "lm_prefill.pt2")
    decode = EXP.load_program(out / "lm_decode.pt2")
    t = ids.shape[1]
    logits, k, v = prefill(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.bool))
    start = torch.zeros(1, dtype=torch.int32)  # no left padding in this prompt
    toks = [int(logits.argmax(-1)[0])]
    for i in range(NEW - 1):
        logits, k, v = decode(torch.tensor([toks[-1]]), torch.tensor([t + i]), start, k, v,
                              torch.tensor(t + i, dtype=torch.int32))
        toks.append(int(logits.argmax(-1)[0]))
    return np.asarray(toks)


def _live_greedy(llm, cfg, ids):
    with torch.inference_mode():
        toks, _ = generate(llm, cfg, torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.bool),
                           torch.Generator(), max_new_tokens=NEW, cache_len=PROMPT + NEW,
                           eos_ids=(), pad_id=0, greedy=True, cache_dtype=torch.float32)
    return toks[0].numpy()


def test_exported_lm_generates_greedily(pipe, artifacts):
    """Greedy ids from the lm_prefill + lm_decode artifacts equal the live
    generate's and JAX's."""
    import jax
    import jax.numpy as jnp

    from sparktts_tpu.config import tiny_test_config as jax_tiny_config
    from sparktts_tpu.lm.generate import generate as jax_generate

    out, _ = artifacts
    cfg = pipe.config.llm
    ids = np.random.default_rng(1).integers(5, cfg.vocab_size - 5, size=(1, PROMPT))
    got = _artifact_greedy(out, ids)
    np.testing.assert_array_equal(got, _live_greedy(pipe.llm_params, cfg, ids))
    ref, _ = jax_generate(_jax(pipe.llm_params), jax_tiny_config().llm,
                          jnp.asarray(ids, jnp.int32), jnp.ones(ids.shape, bool),
                          jax.random.PRNGKey(0), max_new_tokens=NEW, cache_len=PROMPT + NEW,
                          eos_ids=(), pad_id=0, greedy=True, cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(ref)[0])
    assert len(set(got.tolist())) > 1  # not one repeated id


def test_int8_lm_artifacts(pipe, tmp_path):
    """An int8 tree's lm_decode holds the fused int8 MLP op, and the pair's
    greedy ids equal the live int8 generate's."""
    llm = pipe.llm_params
    try:
        pipe.llm_params = quantize_qwen_int8(llm)
        EXP.export_pipeline_artifacts(pipe, tmp_path, prompt_len=PROMPT, decode_len=NEW,
                                      graphs=("lm_prefill", "lm_decode"))
        decode = EXP.load_program(tmp_path / "lm_decode.pt2")
        assert decode.ops == {"dense_decode_attention": 2, "int8_mlp_matvec": 2}
        ids = np.random.default_rng(2).integers(5, pipe.config.llm.vocab_size - 5,
                                                size=(1, PROMPT))
        np.testing.assert_array_equal(_artifact_greedy(tmp_path, ids),
                                      _live_greedy(pipe.llm_params, pipe.config.llm, ids))
    finally:
        pipe.llm_params = llm


def test_export_leaves_eager_decode_unchanged(pipe, artifacts):
    """Exporting launches nothing and caches nothing the live path then
    reads (the RoPE frequencies made during a trace are not kept)."""
    before = decode_attention.launches
    ids = np.random.default_rng(3).integers(5, pipe.config.llm.vocab_size - 5, size=(1, PROMPT))
    _live_greedy(pipe.llm_params, pipe.config.llm, ids)
    assert decode_attention.launches == before


@pytest.mark.cuda
def test_loaded_lm_decode_replays_a_cuda_graph(tmp_path):
    """A reloaded full-width `lm_decode` (bf16, cut to 2 layers) replays the
    graph captured at its first call: its logits within 1e-3 x max|logit| of
    the eager run of its module (cuBLAS may pick other algorithms under
    capture), a result held across a second call (its cache fed back in)
    unchanged, and each replay adding the program's kernel launches to
    `graphs.launches()`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a loaded program replays a CUDA graph there")
    from sparktts_tpu_torch.lm.speculative import draft_config, draft_from_layers

    layers, prompt, new = 2, 32, 32
    pipe = SparkTTSPipeline(device="cuda")
    pipe.config = dataclasses.replace(pipe.config, llm=draft_config(pipe.config.llm, layers))
    pipe.llm_params = draft_from_layers(pipe.llm_params, layers)
    EXP.export_pipeline_artifacts(pipe, tmp_path, prompt_len=prompt, decode_len=new,
                                  graphs=("lm_decode",))
    decode = EXP.load_program(tmp_path / "lm_decode.pt2")
    cfg = pipe.config.llm
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (layers, 1, prompt + new, cfg.num_key_value_heads, cfg.head_dim)
    k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))

    def args(tok, pos, k, v):
        return (torch.tensor([tok], device="cuda"), torch.tensor([pos], device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda"), k, v,
                torch.tensor(pos, dtype=torch.int32, device="cuda"))

    want = decode.eager(*args(7, prompt, k, v))
    graphs.reset_launches()
    got = decode(*args(7, prompt, k, v))
    torch.cuda.synchronize()
    (call,) = decode.captured.values()
    assert call.graph is not None and call.launches["dense_decode_attention"] == layers
    assert graphs.launches()["dense_decode_attention"] == layers  # the replay, not the capture
    peak = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-3 * peak
    others = torch.ones(prompt + new, dtype=torch.bool)
    others[prompt] = False
    for a, b in zip(got[1:], want[1:]):  # the cache: the one row written, the rest copied
        torch.testing.assert_close(a[:, :, others], b[:, :, others], rtol=0, atol=0)
        row = (a[:, :, prompt] - b[:, :, prompt]).float().abs().max()
        assert float(row) <= 1e-2 * float(b[:, :, prompt].float().abs().max())
    held = [t.clone() for t in got]
    again = decode(*args(int(got[0].argmax()), prompt + 1, got[1], got[2]))
    torch.cuda.synchronize()
    for a, b in zip(got, held):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(again[1], got[1])  # the second call wrote its own row
    assert graphs.launches()["dense_decode_attention"] == 2 * layers
