"""The port's kernel modules against the JAX package's Pallas kernels
(interpret mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests hold that arithmetic against the Pallas kernels in fp32.  Tolerance
1e-5 for attention, the same fp32 math summed in another order; 2e-5 for
the vocoder's ResidualUnit, the JAX package's own tolerance for its fused
unit against the unfused one (two convs of 7C + C terms).  The quantized
kernels run in bf16 as on the main path: the int8 MLP within 5e-2 (the JAX
package's bound between its kernel and its unfused path; measured
1.95e-3, one bf16 ulp of outputs under 0.54, from fp32 sums taken in
another order), the int4 matvec within 5e-3 of the largest output
(`tests/test_int4_kernel.py`'s bound; measured 2.7e-7 relative at most).
The CPU models of the CUDA kernels' summation orders are held here too: the
int8 MLP's tiled down sum (`int8_mlp_tiled_plain`) within one bf16 ulp of
the largest output (2^-8 of max|plain|) of the plain version, whose down
sum it only reorders, and within 2e-2 of max|ref| of the Pallas kernel,
whose gate/up sums are in another order too, so that a value of h may round
one ulp apart and carry into the down projection (measured 4e-3 to 8e-3);
the ResidualUnit's 3xTF32 arithmetic (`residual_unit_3xtf32_plain`) within
2e-5 of the Pallas unit and of the plain fp32 unit; the int4 matvec's runs
of groups (`int4_matvec_split_plain`, the groups in order within a run, the
runs in order) within the int4 bound above, at the kernel's edges (1 to 32
rows, groups of 16, 24, 64 and 128, an `out` that is not a multiple of a
column tile).
The CUDA kernels themselves are held against the plain versions on the card
by `test_torch_cuda_kernels.py` (marked `cuda`, skipped without a card) and
by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktts_tpu.kernels.decode_attention import dense_decode_attention as jax_decode
from sparktts_tpu.kernels.flash_attention import flash_attention_prefill as jax_flash
from sparktts_tpu.kernels.flash_attention import reference_attention
from sparktts_tpu.kernels.int4_matmul import int4_matvec as jax_int4_matvec
from sparktts_tpu.kernels.int4_matmul import reference_int4_matvec
from sparktts_tpu.kernels.int8_mlp import int8_mlp_matvec as jax_int8_mlp
from sparktts_tpu.kernels.vocoder_fusion import fused_residual_unit as jax_residual_unit
from sparktts_tpu.lm.quant import quantize_linear_int4, quantize_linear_int8
from sparktts_tpu_torch.kernels import decode_attention as da
from sparktts_tpu_torch.kernels import flash_attention as fa
from sparktts_tpu_torch.kernels import int4_matmul as i4
from sparktts_tpu_torch.kernels import int8_mlp as i8
from sparktts_tpu_torch.kernels import vocoder_fusion as vf
from sparktts_tpu_torch.weights import to_torch

FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _flash_inputs(b, hq, hkv, t, d, starts, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, t, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    return q, k, v, np.asarray(starts, np.int32)


def _valid_rows(out, starts):
    t = out.shape[2]
    valid = np.arange(t)[None, :] >= np.asarray(starts)[:, None]  # (b, t)
    return np.broadcast_to(valid[:, None, :, None], out.shape)


@pytest.mark.parametrize(
    "b,hq,hkv,t,d,block,starts",
    [
        (1, 14, 2, 64, 64, 64, [17]),          # 0.5B heads, one prompt bucket
        (1, 14, 2, 128, 64, 64, [70]),         # two query tiles, start past a tile
        (2, 4, 2, 128, 16, 32, [0, 45]),       # tiny-config head dim
        (3, 8, 2, 64, 32, 16, [5, 0, 63]),     # GQA group 4, last row the only valid one
    ],
)
def test_flash_plain_matches_pallas(b, hq, hkv, t, d, block, starts):
    q, k, v, start = _flash_inputs(b, hq, hkv, t, d, starts)
    scale = d**-0.5
    want = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
                  sm_scale=scale, block_q=block, block_k=block, interpret=True)
    )
    before = fa.launches
    got = fa.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(start),
        sm_scale=scale,
    ).numpy()
    assert fa.launches == before  # CPU tensors take the plain version
    mask = _valid_rows(got, start)
    np.testing.assert_allclose(got[mask], want[mask], **FP32_TOL)
    # left-pad rows are unspecified in JAX; the port returns zeros there
    assert np.all(got[~mask] == 0)


def test_flash_plain_ragged_length_matches_reference():
    """A prompt length no tile divides, with distinct starts per row: the
    port takes any T (the Pallas kernel needs T % block == 0, so the JAX
    side here is its XLA reference)."""
    b, hq, hkv, t, d = 4, 14, 2, 77, 64
    q, k, v, start = _flash_inputs(b, hq, hkv, t, d, [0, 3, 40, 76], seed=1)
    want = np.asarray(
        reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
                            sm_scale=d**-0.5)
    )
    got = fa.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(start),
        sm_scale=d**-0.5,
    ).numpy()
    mask = _valid_rows(got, start)
    np.testing.assert_allclose(got[mask], want[mask], **FP32_TOL)


def _decode_inputs(b, s_len, hq=14, hkv=2, d=64, n_layers=3, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    ck = rng.standard_normal((n_layers, b, s_len, hkv, d), dtype=np.float32)
    cv = rng.standard_normal((n_layers, b, s_len, hkv, d), dtype=np.float32)
    return q, ck, cv


@pytest.mark.parametrize(
    "b,s_len,block_s,starts,poss",
    [
        (1, 256, 64, [0], [0]),                      # single valid key
        (1, 256, 64, [3], [200]),                    # window straddling blocks
        (2, 512, 128, [0, 37], [511, 64]),           # full window + short window
        (3, 128, 128, [5, 0, 90], [100, 127, 90]),   # single-block grid
        (2, 128, 64, [40, 0], [39, 10]),             # row 0: empty window
    ],
)
def test_decode_plain_matches_pallas(b, s_len, block_s, starts, poss):
    q, ck, cv = _decode_inputs(b, s_len)
    start, pos = np.asarray(starts, np.int32), np.asarray(poss, np.int32)
    before = da.launches
    for layer in (0, ck.shape[0] - 1):
        want = np.asarray(
            jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), layer,
                       jnp.asarray(start), jnp.asarray(pos), sm_scale=0.125,
                       block_s=block_s, interpret=True)
        )
        got = da.dense_decode_attention(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), layer,
            torch.from_numpy(start), torch.from_numpy(pos), sm_scale=0.125,
        ).numpy()
        # an empty window gives zeros in the port; the Pallas kernel gives
        # zeros only when its S-block is skipped (here it averages V)
        live = pos >= start
        np.testing.assert_allclose(got[live], want[live], **FP32_TOL)
        assert np.all(got[~live] == 0)
    assert da.launches == before


def _split_windows(case, c, s_len):
    """(starts, poss) of four rows for a window kind, relative to chunk c."""
    return {
        "on_edges": ([c, 0, 2 * c, c], [2 * c - 1, c - 1, 3 * c - 1, s_len - 1]),
        "one_off_edges": ([c - 1, c + 1, c - 1, c + 1], [2 * c, 2 * c - 2, 2 * c - 2, 2 * c]),
        "inside_one_chunk": ([c + 3, 2 * c + 1, 0, c + 5], [c + 7, 2 * c + 1, 4, 2 * c - 2]),
        "empty": ([40, 0, c, 17], [39, 5, c - 1, 16]),
        "last_key": ([5, 0, c + 1, s_len - 1], [s_len - 1] * 4),
        "mixed": ([0, 37, c - 1, 90], [s_len - 1, 64, c, 89]),
    }[case]


@pytest.mark.parametrize("case", ("on_edges", "one_off_edges", "inside_one_chunk", "empty",
                                  "last_key", "mixed"))
@pytest.mark.parametrize("chunk", (16, 64, 128))
def test_decode_split_plain_matches_pallas(chunk, case):
    """The CPU model of the split-window kernel (per-chunk partials merged in
    chunk order) against the Pallas kernel in interpret mode and the dense
    plain version, fp32 1e-5: windows on chunk edges and one key either side,
    inside one chunk, empty (zeros), ending at S - 1, and mixed in a batch."""
    s_len = 256
    q, ck, cv = _decode_inputs(4, s_len, seed=chunk)
    starts, poss = _split_windows(case, chunk, s_len)
    start, pos = np.asarray(starts, np.int32), np.asarray(poss, np.int32)
    args = [torch.from_numpy(x) for x in (q, ck, cv)]
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 1,
                                 jnp.asarray(start), jnp.asarray(pos), sm_scale=0.125,
                                 block_s=64, interpret=True))
    plain = da.dense_decode_plain(*args, 1, torch.from_numpy(start), torch.from_numpy(pos),
                                  sm_scale=0.125).numpy()
    got = da.dense_decode_split_plain(*args, 1, torch.from_numpy(start), torch.from_numpy(pos),
                                      sm_scale=0.125, chunk=chunk).numpy()
    live = pos >= start
    np.testing.assert_allclose(got[live], want[live], **FP32_TOL)
    np.testing.assert_allclose(got, plain, **FP32_TOL)
    assert np.all(got[~live] == 0)


def test_decode_split_plain_ragged_cache_and_clamped_pos():
    """A cache length no chunk divides (the last chunk is short) and pos = S,
    which the kernel clamps to S - 1: against the dense plain version."""
    s_len = 200
    q, ck, cv = _decode_inputs(3, s_len, seed=3)
    start = torch.tensor([0, 130, 199], dtype=torch.int32)
    pos = torch.tensor([s_len, 199, s_len], dtype=torch.int32)
    args = [torch.from_numpy(x) for x in (q, ck, cv)]
    want = da.dense_decode_plain(*args, 2, start, pos, sm_scale=0.125)
    for chunk in (16, 64):
        got = da.dense_decode_split_plain(*args, 2, start, pos, sm_scale=0.125, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32_TOL)


def _residual_unit(c, seed):
    """Unit params with the non-trivial alphas and biases of
    tests/test_vocoder_kernel.py, as numpy."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (0.02 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {
        "snake1": {"alpha": (0.5 + rng.uniform(size=c)).astype(np.float32)},
        "conv1": {"w": w(7, c, c), "b": (0.1 * rng.standard_normal(c)).astype(np.float32)},
        "snake2": {"alpha": (0.5 + rng.uniform(size=c)).astype(np.float32)},
        "conv2": {"w": w(1, c, c), "b": (0.1 * rng.standard_normal(c)).astype(np.float32)},
    }


def _vocoder_case(p, x, dilation, block_t, variant):
    """(port's unit on CPU tensors, JAX's Pallas unit in interpret mode)."""
    want = np.asarray(jax_residual_unit(jax.tree.map(jnp.asarray, p), jnp.asarray(x), dilation,
                                        block_t=block_t, interpret=True, variant=variant))
    before = vf.launches
    got = vf.fused_residual_unit(to_torch(p, "cpu"), torch.from_numpy(x), dilation).numpy()
    assert vf.launches == before  # CPU tensors take the plain version
    return got, want


@pytest.mark.parametrize("variant", ("tiles", "carry"))
@pytest.mark.parametrize("dilation", (1, 3, 9))
def test_vocoder_unit_plain_matches_pallas(dilation, variant):
    """block_t 32 over T 96: interior tiles and both sequence edges (the
    halo of 27 rows at dilation 9 spans most of a tile)."""
    p = _residual_unit(16, seed=dilation)
    x = np.random.default_rng(9).standard_normal((2, 96, 16)).astype(np.float32)
    got, want = _vocoder_case(p, x, dilation, 32, variant)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("variant", ("tiles", "carry"))
@pytest.mark.parametrize("t,block_t", [(50, 32), (20, 64)])
def test_vocoder_unit_plain_ragged_and_single_tile(t, block_t, variant):
    """A T no tile divides, and a T smaller than one tile (both edges in it)."""
    p = _residual_unit(8, seed=7)
    x = np.random.default_rng(t).standard_normal((1, t, 8)).astype(np.float32)
    got, want = _vocoder_case(p, x, 3, block_t, variant)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _bf16(a):
    """numpy fp32 -> (JAX bf16, torch bf16) of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("r,k,i", [(1, 128, 512), (4, 64, 256), (16, 64, 256)])
def test_int8_mlp_plain_matches_pallas(r, k, i):
    """bf16 x and weights quantized from bf16, as the int8 LM holds them."""
    rng = np.random.default_rng(r + k + i)
    gu = quantize_linear_int8({"w": _bf16(0.05 * rng.standard_normal((k, 2 * i)))[0]})
    down = quantize_linear_int8({"w": _bf16(0.05 * rng.standard_normal((i, k)))[0]})
    jx, tx = _bf16(rng.standard_normal((r, k)))
    want = np.asarray(jax_int8_mlp(jx, gu["w_q"], gu["scale"], down["w_q"], down["scale"],
                                   block_i=128, interpret=True), np.float32)
    before = i8.launches
    got = i8.int8_mlp_matvec(tx, *(torch.from_numpy(np.asarray(a)) for a in
                                   (gu["w_q"], gu["scale"], down["w_q"], down["scale"])))
    assert i8.launches == before and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("r,k,i,block_i", [
    (1, 64, 256, 128), (5, 64, 1000, 8), (16, 128, 512, 128),
    (1, 896, 1000, 40),  # the hidden width, a ragged intermediate width
])
def test_int8_mlp_tiled_model_matches_pallas_and_plain(r, k, i, block_i):
    """The kernel's order of the down sum (16-column tiles, clusters of 8
    tiles, then the clusters) at 1, 5 and 16 rows and an I that no 16 x 8
    columns divide."""
    rng = np.random.default_rng(r + k + i)
    gu = quantize_linear_int8({"w": _bf16(0.05 * rng.standard_normal((k, 2 * i)))[0]})
    down = quantize_linear_int8({"w": _bf16(0.05 * rng.standard_normal((i, k)))[0]})
    jx, tx = _bf16(rng.standard_normal((r, k)))
    args = [torch.from_numpy(np.asarray(a)) for a in (gu["w_q"], gu["scale"], down["w_q"],
                                                       down["scale"])]
    got = i8.int8_mlp_tiled_plain(tx, *args)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    plain = i8.int8_mlp_matvec_plain(tx, *args).float().numpy()
    assert np.abs(got - plain).max() <= 2**-8 * np.abs(plain).max()
    want = np.asarray(jax_int8_mlp(jx, gu["w_q"], gu["scale"], down["w_q"], down["scale"],
                                   block_i=block_i, interpret=True), np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("variant", ("tiles", "carry"))
@pytest.mark.parametrize("dilation", (1, 3, 9))
def test_vocoder_3xtf32_model_matches_pallas_and_plain(dilation, variant):
    """The kernel's 3xTF32 products at a ragged T (50 over tiles of 32)."""
    p = _residual_unit(16, seed=10 + dilation)
    x = np.random.default_rng(dilation).standard_normal((1, 50, 16)).astype(np.float32)
    want = np.asarray(jax_residual_unit(jax.tree.map(jnp.asarray, p), jnp.asarray(x), dilation,
                                        block_t=32, interpret=True, variant=variant))
    tp, tx = to_torch(p, "cpu"), torch.from_numpy(x)
    got = vf.residual_unit_3xtf32_plain(tp, tx, dilation).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, vf.fused_residual_unit_plain(tp, tx, dilation).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_tf32_rounding_is_to_nearest_ties_away():
    """`cvt.rna.tf32.f32`: 10 explicit mantissa bits, ties away from zero."""
    v = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12,
                      1 + 2**-10 - 2**-23])
    want = [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 1 + 2**-10]
    assert vf.tf32_round(v).tolist() == want


@pytest.mark.parametrize("d_in,d_out,group,b", [
    (64, 512, 16, 3), (896, 1152, 128, 1),
    (4864, 896, 128, 2),  # down: 38 groups in four runs
    (96, 40, 24, 9),  # groups of 24 (k steps of 16 padded), out not a multiple of a tile
    (48, 8, 24, 1),  # out = 8, a tile mostly past the edge
    (128, 33, 64, 8),  # out one past a 32-column tile
    (1024, 48, 128, 16),  # 8 groups
    (640, 24, 64, 32),  # 10 groups, 32 rows
    (1920, 24, 64, 32),  # 30 groups: three runs of ten
    (256, 72, 16, 17),  # 16 groups: two runs of eight, 17 rows
])
def test_int4_matvec_plain_matches_pallas(d_in, d_out, group, b):
    """The plain version (the wrapper on the CPU) and the CPU model of the
    kernel's runs (`int4_matvec_split_plain`) against the Pallas kernel and
    the XLA reference."""
    rng = np.random.default_rng(d_in + d_out)
    q = quantize_linear_int4({"w": jnp.asarray(rng.standard_normal((d_in, d_out)), jnp.float32)},
                             group=group)
    jx, tx = _bf16(rng.standard_normal((b, d_in)))
    packed, gscale = (torch.from_numpy(np.asarray(q[n])) for n in ("w_p4", "gscale"))
    before = i4.launches
    got = i4.int4_matvec(tx, packed, gscale).float().numpy()
    assert i4.launches == before
    model = i4.int4_matvec_split_plain(tx, packed, gscale).float().numpy()
    for ref in (jax_int4_matvec(jx, q["w_p4"], q["gscale"], interpret=True),
                reference_int4_matvec(jx, q["w_p4"], q["gscale"])):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()
        assert np.abs(model - ref).max() <= 5e-3 * np.abs(ref).max()


@pytest.mark.parametrize("groups,b,group,run,split", [
    (1, 32, 896, 1, 1), (7, 1, 128, 7, 1), (7, 32, 128, 7, 1),  # qkv, o, gate/up: one run
    (38, 1, 128, 10, 4), (38, 32, 128, 10, 4),  # down: runs of at most 12 groups
    (14, 1, 64, 7, 2), (30, 32, 64, 10, 3), (10, 32, 64, 10, 1),
    (304, 32, 16, 38, 8)])  # at most eight runs
def test_int4_group_split_runs_cover_the_groups_in_order(groups, b, group, run, split):
    """The kernel's runs: the fewest (at most eight) of at most 12 groups
    whose staged x fits a block, `run` consecutive groups each, the last
    possibly shorter and none empty."""
    assert i4.group_split(groups, b, group) == (run, split)
    assert split <= i4.MAX_SPLIT and (split - 1) * run < groups <= split * run
