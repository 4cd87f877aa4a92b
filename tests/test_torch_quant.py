"""The port's weight-only quantization (int8/int4 LM, int8 BiCodec) against
the JAX package.

Tiny config, inputs and weights made with numpy or torch from a seed, the
same values on both sides.  Tolerances:

* quantized ints and fp32 scales: equal (both round half to even an fp32
  quotient);
* quantized linears and convs in fp32: 1e-5, the same arithmetic summed in
  another order;
* LM logits in fp32: 1e-4 of the largest logit against the JAX package's
  unfused path; 5e-2 against its fused int8 MLP kernel (interpret mode),
  the JAX package's own bound between its kernel and its unfused path;
* greedy ids and codec ids: equal; waveform: 1e-4 of its peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.codec import bicodec as jbicodec
from sparktts_tpu.codec import quant as jcq
from sparktts_tpu.config import tiny_test_config
from sparktts_tpu.lm import generate as jgen
from sparktts_tpu.lm import quant as jquant
from sparktts_tpu.lm import qwen as jq
from sparktts_tpu.nn import layers as jl
from sparktts_tpu_torch.codec import quant as tcq
from sparktts_tpu_torch.codec import wave_generator
from sparktts_tpu_torch.kernels import int4_matmul as i4
from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize, bicodec_tokenize
from sparktts_tpu_torch.config import tiny_test_config as torch_tiny_config
from sparktts_tpu_torch.lm import generate as tgen
from sparktts_tpu_torch.lm import quant as tquant
from sparktts_tpu_torch.lm import qwen as tq
from sparktts_tpu_torch.nn import layers as tl
from sparktts_tpu_torch.weights import (
    bicodec_state,
    init_bicodec,
    init_qwen,
    qwen_state,
    to_torch,
)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_REL = 1e-4
KERNEL_REL = 5e-2
WAV_REL_TOL = 1e-4
JCFG, TCFG = tiny_test_config(), torch_tiny_config()
CFG = JCFG.llm
GROUP = 16  # int4 group on hidden 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    """Port tree (tensors) == JAX tree (arrays): keys, dtypes, values."""
    flat_t, tdef_t = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    flat_j, tdef_j = jax.tree.flatten(_np(want))
    assert tdef_t == tdef_j
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _weights(seed, *shape, bias=False):
    rng = np.random.default_rng(seed)
    p = {"w": (0.05 * rng.standard_normal(shape)).astype(np.float32)}
    p["w"][..., 0, :3] = 0.0  # zero-max columns and groups take scale 1
    p["w"][..., :, 3] = 0.0
    if bias:
        p["b"] = rng.standard_normal(shape[-1]).astype(np.float32)
    return p


@pytest.mark.parametrize("shape", [(64, 40), (3, 32, 24)])
def test_quantize_linear_int8_equals_jax(shape):
    p = _weights(0, *shape, bias=True)
    want = jquant.quantize_linear_int8(jax.tree.map(jnp.asarray, p))
    got = tquant.quantize_linear_int8(to_torch(p, "cpu"))
    _assert_trees_equal(got, want)
    assert got["scale"].dtype == torch.float32 and got["w_q"].dtype == torch.int8


@pytest.mark.parametrize("shape,group", [((64, 40), 16), ((2, 128, 24), 128), ((32, 8), 2)])
def test_quantize_linear_int4_and_unpack_equal_jax(shape, group):
    p = _weights(1, *shape, bias=True)
    want = jquant.quantize_linear_int4(jax.tree.map(jnp.asarray, p), group=group)
    got = tquant.quantize_linear_int4(to_torch(p, "cpu"), group=group)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(tquant.unpack_int4(got["w_p4"]).numpy(),
                                  np.asarray(jquant.unpack_int4(want["w_p4"])))
    # every byte value unpacks as JAX unpacks it
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(tquant.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(jquant.unpack_int4(jnp.asarray(every))))


def _jax_tree(torch_tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), torch_tree)


@pytest.fixture(scope="module")
def lm():
    """(JAX fp32 LM tree, its int8 and int4 trees); random weights from the
    port's init (the JAX init's distributions, and faster to build)."""
    jp = _jax_tree(init_qwen(TCFG.llm, torch.Generator().manual_seed(0), torch.float32, "cpu"))
    # eagerly, as users call it: under jit, XLA turns the division by 127 (or
    # 7) into a product with its reciprocal, one ulp off on some scales
    return jp, jquant.quantize_qwen_int8(jp), jquant.quantize_qwen_int4(jp, group=GROUP)


def test_quantize_qwen_equals_jax(lm):
    jp, j8, j4 = lm
    tp = qwen_state(_np(jp), "cpu", torch.float32)
    _assert_trees_equal(tquant.quantize_qwen_int8(tp), j8)
    _assert_trees_equal(tquant.quantize_qwen_int4(tp, group=GROUP), j4)
    _assert_trees_equal(tquant.quantize_embedding_int8(tp["embed"]),
                        jquant.quantize_embedding_int8(jp["embed"]))
    # an embedding that is already quantized passes through
    emb8 = tquant.quantize_embedding_int8(tp["embed"])
    for quantize in (tquant.quantize_qwen_int8, tquant.quantize_qwen_int4):
        kw = {} if quantize is tquant.quantize_qwen_int8 else {"group": GROUP}
        assert quantize({**tp, "embed": emb8}, **kw)["embed"] is emb8
    # from bf16 weights too: the quotient is taken in fp32 on both sides
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = qwen_state(_np(jax.tree.map(lambda a: a.astype(jnp.float32), jb)), "cpu", torch.bfloat16)
    got = tquant.quantize_qwen_int8(tb)
    want = jquant.quantize_qwen_int8(jb)
    for k in tquant.QUANT_KEYS:
        np.testing.assert_array_equal(got["layers"][k]["w_q"].numpy(),
                                      np.asarray(want["layers"][k]["w_q"]))
        np.testing.assert_array_equal(got["layers"][k]["scale"].numpy(),
                                      np.asarray(want["layers"][k]["scale"]))


def test_qwen_state_keeps_int8_and_fp32_scales(lm):
    """A JAX-quantized numpy tree converted at bf16: integer leaves stay
    int8, `scale` and `gscale` stay fp32 and equal, the rest is bf16."""
    _, j8, j4 = lm
    for jtree in (j8, j4):
        t = qwen_state(_np(jtree), "cpu", torch.bfloat16)
        emb = t["embed"]
        assert emb["w_q"].dtype == torch.int8 and emb["scale"].dtype == torch.float32
        np.testing.assert_array_equal(emb["scale"].numpy(), np.asarray(jtree["embed"]["scale"]))
        assert t["layers"]["ln1"]["gamma"].dtype == torch.bfloat16
        assert t["layers"]["qkv"]["b"].dtype == torch.bfloat16
        for k in tquant.QUANT_KEYS:
            leaf = t["layers"][k]
            scale_key, q_key = ("gscale", "w_p4") if "w_p4" in leaf else ("scale", "w_q")
            assert leaf[q_key].dtype == torch.int8 and leaf[scale_key].dtype == torch.float32
            np.testing.assert_array_equal(leaf[scale_key].numpy(),
                                          np.asarray(jtree["layers"][k][scale_key]))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("lead", [(2, 3), (40,), (2, 33)])  # 6 rows: the int4 matvec module;
# 40 and 66: the wide path (prefill)
def test_linear_apply_quantized_matches_jax(kind, lead):
    p = _weights(2, 64, 48, bias=True)
    jp = jax.tree.map(jnp.asarray, p)
    jp = jquant.quantize_linear_int8(jp) if kind == "int8" else jquant.quantize_linear_int4(jp, 16)
    x = np.random.default_rng(3).standard_normal((*lead, 64)).astype(np.float32)
    want = np.asarray(jl.linear_apply(jp, jnp.asarray(x)))
    got = tl.linear_apply(to_torch(_np(jp), "cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == (*lead, 48)
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_wide_path_is_the_plain_arithmetic(dtype):
    """`linear_apply`'s path for more rows than the int4 kernel takes
    (`int4_linear_wide`) gives the int4 kernel's plain version bit for bit:
    giving the prefill its own function moved no result, and the plain
    version stays off the main path."""
    p = jquant.quantize_linear_int4(jax.tree.map(jnp.asarray, _weights(4, 128, 40)), 32)
    tp = to_torch(_np(p), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 17, 128))).to(dtype)
    want = i4.int4_matvec_plain(x, tp["w_p4"], tp["gscale"])
    assert torch.equal(tl.int4_linear_wide(x, tp["w_p4"], tp["gscale"]), want)
    assert torch.equal(tl.linear_apply(tp, x), want)


def _conv_int8(rng, k, cin_g, cout):
    p = {"w": (0.2 * rng.standard_normal((k, cin_g, cout))).astype(np.float32),
         "b": rng.standard_normal(cout).astype(np.float32)}
    return jcq.quantize_weight_int8(jnp.asarray(p["w"])) | {"b": jnp.asarray(p["b"])}


@pytest.mark.parametrize(
    "cin,cout,k,stride,padding,dilation,groups",
    [
        (6, 6, 7, 1, 9, 3, 1),     # dilated residual-unit conv
        (8, 8, 7, 1, 3, 1, 8),     # depthwise
        (6, 4, 4, 2, 1, 1, 1),     # strided
    ],
)
def test_conv1d_int8_matches_jax(cin, cout, k, stride, padding, dilation, groups):
    rng = np.random.default_rng(4)
    jp = _conv_int8(rng, k, cin // groups, cout)
    x = rng.standard_normal((2, 19, cin), dtype=np.float32)
    want = jl.conv1d_apply(jp, jnp.asarray(x), stride=stride, padding=padding,
                           dilation=dilation, groups=groups)
    got = tl.conv1d_apply(to_torch(_np(jp), "cpu"), torch.from_numpy(x), stride=stride,
                          padding=padding, dilation=dilation, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize(
    "cin,cout,k,stride,padding,output_padding,groups",
    [
        (6, 4, 16, 8, 4, 0, 1),    # vocoder upsample
        (8, 8, 6, 3, 2, 1, 8),     # depthwise, output_padding
    ],
)
def test_conv_transpose1d_int8_matches_jax(cin, cout, k, stride, padding, output_padding, groups):
    rng = np.random.default_rng(5)
    jp = _conv_int8(rng, k, cin // groups, cout)
    x = rng.standard_normal((2, 9, cin), dtype=np.float32)
    want = jl.conv_transpose1d_apply(jp, jnp.asarray(x), stride, padding, output_padding, groups)
    got = tl.conv_transpose1d_apply(to_torch(_np(jp), "cpu"), torch.from_numpy(x), stride,
                                    padding, output_padding, groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def _left_padded(lengths, t_pad, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), t_pad), CFG.pad_token_id, np.int64)
    mask = np.zeros((len(lengths), t_pad), bool)
    for i, n in enumerate(lengths):
        ids[i, t_pad - n :] = rng.integers(5, CFG.vocab_size - 6, size=n)
        mask[i, t_pad - n :] = True
    return ids, mask


def _assert_logits_close(got, want, rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_prefill_and_decode_logits_match_jax(lm, kind, monkeypatch):
    _, j8, j4 = lm
    jp = j8 if kind == "int8" else j4
    tp = qwen_state(_np(jp), "cpu", torch.float32)
    ids, mask = _left_padded([64, 23], 64)
    s, vocab_slice, extras = 128, (300, 420), (7, 450)
    start = (64 - mask.sum(1)).astype(np.int32)

    jpos, _ = jq.prefill_inputs(jnp.asarray(mask), s)
    jcache = jq.init_kv_cache(CFG, 2, s, jnp.float32)
    jlog, jcache = jq.qwen_forward(jp, CFG, jnp.asarray(ids, jnp.int32), jpos, jcache, 0, None,
                                   flash_start=jnp.asarray(start), vocab_slice=vocab_slice,
                                   extra_ids=extras)
    tcache = tq.init_kv_cache(CFG, 2, s, torch.float32, "cpu")
    tpos, _ = tq.prefill_inputs(torch.from_numpy(mask), s)
    tlog, tcache = tq.qwen_forward(tp, CFG, torch.from_numpy(ids), tpos, tcache, 0, None,
                                   flash_start=torch.from_numpy(start), vocab_slice=vocab_slice,
                                   extra_ids=extras)
    valid = mask[:, :, None]  # logits of pad query rows are junk on both sides
    _assert_logits_close(np.where(valid, tlog.numpy(), 0), np.where(valid, np.asarray(jlog), 0),
                         LOGIT_REL)

    tok, dpos = np.asarray([[11], [12]]), mask.sum(1)[:, None]
    tlog, _ = tq.qwen_forward(
        tp, CFG, torch.from_numpy(tok), torch.from_numpy(dpos), tcache, 64, None,
        decode_window=(torch.from_numpy(start), torch.full((2,), 64, dtype=torch.int32)),
    )
    runs = ("0", "1") if kind == "int8" else ("0",)  # the JAX fused MLP kernel: off, on
    for mode in runs:
        monkeypatch.setenv("SPARKTTS_MLP_KERNEL", mode)  # read at trace time
        jax.clear_caches()
        jlog, _ = jq.qwen_forward(jp, CFG, jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(dpos, jnp.int32), jcache, 64, None,
                                  decode_window=(jnp.asarray(start), 64))
        _assert_logits_close(tlog.numpy(), np.asarray(jlog),
                             LOGIT_REL if mode == "0" else KERNEL_REL)
    jax.clear_caches()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_greedy_generate_ids_equal_jax(lm, kind):
    _, j8, j4 = lm
    jp = j8 if kind == "int8" else j4
    tp = qwen_state(_np(jp), "cpu", torch.float32)
    ids, mask = _left_padded([40, 64, 9], 64, seed=3)
    kw = dict(max_new_tokens=12, cache_len=64 + 12, eos_ids=(300,), pad_id=1, greedy=True,
              vocab_slice=(288, 416), extra_ids=(256, 260, 300))
    jt, jlen = jgen.generate(jp, CFG, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                             jax.random.PRNGKey(0), cache_dtype=jnp.float32, use_flash=True, **kw)
    tt, tlen = tgen.generate(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                             torch.Generator(), cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


@pytest.fixture(scope="module")
def codec():
    """(JAX fp32 BiCodec tree, its int8 tree, the port's int8 tree)."""
    jp = _jax_tree(init_bicodec(TCFG.bicodec, torch.Generator().manual_seed(3), "cpu"))
    t8 = tcq.quantize_bicodec_int8(bicodec_state(_np(jp), "cpu"))
    return jp, jcq.quantize_bicodec_int8(jp), t8


def test_quantize_bicodec_int8_equals_jax(codec):
    jp, j8, t8 = codec
    _assert_trees_equal(t8, j8)
    assert tcq.quantized_bytes(t8) == jcq.quantized_bytes(j8)
    assert tcq.quantized_bytes(t8) < 0.45 * tcq.quantized_bytes(bicodec_state(_np(jp), "cpu"))
    # a sub-tree alone, as for a vocoder-only int8 variant
    _assert_trees_equal(tcq.quantize_bicodec_int8(bicodec_state(_np(jp["decoder"]), "cpu")),
                        jcq.quantize_bicodec_int8(jp["decoder"]))


def test_int8_codec_detokenize_and_tokenize_match_jax(codec):
    _, j8, t8 = codec
    cfg = JCFG.bicodec
    rng = np.random.default_rng(0)
    semantic = rng.integers(0, cfg.quantizer.codebook_size, size=(2, 13))
    glob = rng.integers(0, int(np.prod(cfg.speaker_encoder.fsq_levels)),
                        size=(2, cfg.speaker_encoder.token_num))
    want = np.asarray(jbicodec.bicodec_detokenize(j8, cfg, jnp.asarray(semantic, jnp.int32),
                                                  jnp.asarray(glob, jnp.int32)))
    got = bicodec_detokenize(t8, TCFG.bicodec, torch.from_numpy(semantic),
                             torch.from_numpy(glob)).numpy()
    peak = np.abs(want).max()
    assert got.shape == want.shape and peak > 1e-5
    np.testing.assert_allclose(got, want, rtol=WAV_REL_TOL, atol=WAV_REL_TOL * peak)

    feat = rng.standard_normal((1, 48, 64)).astype(np.float32)
    ref = (0.3 * rng.standard_normal((1, 96000))).astype(np.float32)
    jsem, jglob = jbicodec.bicodec_tokenize(j8, cfg, jnp.asarray(feat), jnp.asarray(ref))
    tsem, tglob = bicodec_tokenize(t8, TCFG.bicodec, torch.from_numpy(feat), torch.from_numpy(ref))
    np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    np.testing.assert_array_equal(tglob.numpy(), np.asarray(jglob))


def test_int8_units_skip_the_vocoder_kernel_module(codec, monkeypatch):
    """The vocoder kernel takes fp32 weights only: an int8 tree's
    ResidualUnits run the unfused unit, an fp32 tree's go to the kernel
    module (which on the CPU runs its plain version)."""
    jp, _, t8 = codec
    calls = []
    kernel = wave_generator.fused_residual_unit

    def counting(p, x, dilation):
        calls.append(dilation)
        return kernel(p, x, dilation)

    monkeypatch.setattr(wave_generator, "fused_residual_unit", counting)
    cfg = TCFG.bicodec.decoder
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 6, cfg.input_channel),
                                                                   dtype=np.float32))
    wave_generator.wave_generator_apply(t8["decoder"], x, cfg)
    assert calls == []
    wave_generator.wave_generator_apply(bicodec_state(_np(jp), "cpu")["decoder"], x, cfg)
    assert len(calls) == 3 * len(cfg.rates)
