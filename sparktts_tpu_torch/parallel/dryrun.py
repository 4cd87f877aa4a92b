"""`dryrun_multichip`: one train step, sharded generate and the sharded
server on a rank mesh.

Port of `__graft_entry__.dryrun_multichip`.  JAX builds a virtual mesh of
n CPU devices in one process; here `n_ranks` gloo ranks are spawned
(`worker.spawn`), each on the card (every rank on the host's cards in turn)
unless `device="cpu"`.  JAX's axis rule (8 ranks: dp = 2, tp = 2, pp = 2)
and JAX's tiny config; then, as in JAX:

  1. one AdamW step of the LM placed on the (dp, tp, pp) mesh, the global
     batch split over dp: the loss must be finite (and the same on every
     rank);
  2. greedy `generate` on the same mesh against a single-rank run of the
     whole tree: on the CPU the ids must be equal; on the card they must
     agree up to their first divergence and at least on the first token
     (JAX's accelerator branch: the row's reductions sum in another order,
     so a near tie may flip one argmax);
  3. JAX's `_dryrun_sharded_server`: every row of a (n/tp, tp) mesh serves
     one clone request through a `ContinuousTTSServer` led from its rank 0
     (`worker.lead`, the rest following), with the fused admission taken;
     its audio must equal the unsharded server's (on the card: the ids by
     the rule of 2, and the audio within 1e-4 of the peak where the ids are
     equal).

On the card the tiny config takes the kernels' shapes: the LM at the
0.5B model's head layout (14 query / 2 KV heads of 64, so a tp shard has
kernel 2's group of 7) in bf16 for generate and serving, and the vocoder
at 384 channels (its units at 192 and 96, multiples of kernel 3's tile).
The train step runs in fp32 everywhere and runs no kernel, as in JAX.  The
random tiny LM's weights are scaled x4 for serving, so that greedy decoding
does not repeat one id.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Tuple

import numpy as np
import torch

from sparktts_tpu_torch.config import QwenConfig, tiny_test_config
from sparktts_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

#: JAX's dryrun config: tiny dims, divisible by tp on every sharded axis.
TINY = QwenConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16)
GEN_KW = dict(max_new_tokens=8, cache_len=32, eos_ids=(), pad_id=1, greedy=True)
SERVER_TEXT = "hello sharded world"
AUDIO_REL_TOL = 1e-4  # of the peak, on the card, where the ids are equal


def dryrun_axes(n: int) -> Tuple[int, int, int]:
    """JAX's rule: all three axes when the count allows (8 -> 2, 2, 2)."""
    pp = 2 if n % 4 == 0 and n >= 8 else 1
    tp = 2 if (n // pp) % 2 == 0 and n // pp > 1 else 1
    return n // (tp * pp), tp, pp


def card_shapes(cfg):
    """A config (Qwen or the whole pipeline's) at the kernels' shapes: the
    LM at 14 query / 2 KV heads of 64, the vocoder at 384 channels."""
    heads = dict(num_attention_heads=14, num_key_value_heads=2, head_dim=64)
    if isinstance(cfg, QwenConfig):
        return dataclasses.replace(cfg, **heads)
    bicodec = dataclasses.replace(
        cfg.bicodec, decoder=dataclasses.replace(cfg.bicodec.decoder, channels=384))
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **heads), bicodec=bicodec)


def _scaled(tree, factor: float = 4.0):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return tree * factor


def _wav(seconds: float = 1.0, sr: int = 16000) -> np.ndarray:
    """JAX's prompt: a 320 Hz tone."""
    return (0.3 * np.sin(2 * np.pi * 320.0 * np.arange(int(sr * seconds)) / sr)).astype(np.float32)


def _serve_once(pipe) -> Tuple[np.ndarray, np.ndarray, dict]:
    """One clone request through a greedy ContinuousTTSServer over `pipe`
    (JAX's settings); returns (waveform, ids, stats)."""
    from sparktts_tpu_torch.serve.continuous_server import ContinuousTTSServer

    server = ContinuousTTSServer(pipe, max_slots=2, steps_per_dispatch=4, greedy=True,
                                 vocode_batch=False, fused_warm="sync")
    ids, finish = [], server._finish

    def spy(req_id, tokens):
        ids.append(np.asarray(tokens))
        return finish(req_id, tokens)

    server._finish = spy

    async def go():
        await server.start()
        try:
            return await server.synthesize(SERVER_TEXT, prompt_wav=_wav())
        finally:
            await server.stop()

    wav = asyncio.new_event_loop().run_until_complete(go())
    return np.asarray(wav), ids[0], dict(server.stats)


def _pipeline(device, on_card: bool):
    from sparktts_tpu_torch.pipeline import SparkTTSPipeline

    cfg = tiny_test_config()
    if on_card:
        cfg = card_shapes(cfg)
    pipe = SparkTTSPipeline(config=cfg, device=device, seed=0,
                            lm_dtype=torch.bfloat16 if on_card else torch.float32,
                            max_new_tokens=16, prompt_bucket=32)
    with torch.no_grad():
        pipe.llm_params = _scaled(pipe.llm_params)
    return pipe


def dryrun_args(n_ranks: int, device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """What every rank of a dry run takes (`dryrun_rank`): the config, the
    device kind, the (dp, tp, pp) axes and the collectives' timeout.
    Raises on device=None (the card) without a card."""
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu' for the CPU)")
    return dict(cfg=card_shapes(TINY) if on_card else TINY, on_card=on_card,
                axes=dryrun_axes(n_ranks), timeout_s=timeout_s)


def dryrun_rank(mesh, args: dict) -> dict:
    """Every rank of a (dp, tp, pp) mesh of `args["axes"]`: the train step
    and generate on the mesh, then the (n/tp, tp) server rows; rank 0 also
    the single-rank references.  `dryrun_check` reads every rank's result."""
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.lm.train import init_train_state, make_optimizer, train_step
    from sparktts_tpu_torch.parallel import worker
    from sparktts_tpu_torch.parallel.mesh import make_mesh
    from sparktts_tpu_torch.weights import init_qwen, qwen_place

    cfg, on_card, timeout_s = args["cfg"], args["on_card"], args["timeout_s"]
    dev = mesh.device
    dp, tp, _ = mesh.grid.shape
    whole = init_qwen(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    out = {"rank": mesh.rank, "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp.rank,
           "pp_rank": mesh.pp_rank}

    # 1. one train step on the global batch (JAX's: zeros, every position counted)
    graphs.reset_launches()
    b = dp * 2
    part, pcfg = qwen_place(whole, cfg, mesh, device=dev, dtype=torch.float32)
    state = init_train_state(part, make_optimizer(), device=dev)
    _, loss = train_step(state, pcfg, np.zeros((b, 16), np.int64), np.ones((b, 16), bool))
    out["loss"] = float(loss)
    del state, part

    # 2. sharded greedy generate: this rank's dp rows of the batch
    gen_dtype = torch.bfloat16 if on_card else torch.float32
    ids = np.random.default_rng(0).integers(5, cfg.vocab_size - 6, size=(b, 16))
    rows = slice(mesh.dp_rank * 2, mesh.dp_rank * 2 + 2)
    kw = dict(GEN_KW, cache_dtype=gen_dtype)
    part, pcfg = qwen_place(whole, cfg, mesh, device=dev, dtype=gen_dtype)
    mask = torch.ones((2, 16), dtype=torch.bool, device=dev)
    toks, _ = generate(part, pcfg, torch.from_numpy(ids[rows]).to(dev), mask,
                       torch.Generator(device=dev).manual_seed(1), **kw)
    out["generate"] = toks.cpu().numpy()
    launches = graphs.launches()  # the sharded paths' kernel launches, not the references'
    del part
    if mesh.rank == 0:
        from sparktts_tpu_torch.weights import qwen_state

        ref, _ = generate(qwen_state(whole, dev, gen_dtype), cfg,
                          torch.from_numpy(ids).to(dev),
                          torch.ones((b, 16), dtype=torch.bool, device=dev),
                          torch.Generator(device=dev).manual_seed(1), **kw)
        out["generate_ref"] = ref.cpu().numpy()

    # 3. the sharded server: every row of a (n/tp, tp) mesh serves one request
    n = mesh.grid.size
    rows_mesh = make_mesh(dp=n // tp, tp=tp, pp=1, device=dev, timeout_s=timeout_s)
    pipe = _pipeline(dev, on_card)
    pipe.shard_llm(rows_mesh)
    graphs.reset_launches()
    if rows_mesh.tp.rank == 0:
        with worker.lead(rows_mesh):
            out["served"] = _serve_once(pipe)
    else:
        worker.follow(pipe, rows_mesh)
    out["launches"] = {k: n + launches[k] for k, n in graphs.launches().items()}
    del pipe
    if mesh.rank == 0:
        out["served_ref"] = _serve_once(_pipeline(dev, on_card))
    return out


def _agree(ref: np.ndarray, got: np.ndarray, exact: bool) -> Tuple[bool, int]:
    """Whether sharded ids pass: equal (the CPU), or equal up to their
    first divergence and at least on the first token (the card); returns
    (pass, the agreeing prefix)."""
    agree = (ref == got).all(axis=0) if ref.ndim == 2 else ref == got
    prefix = int(agree.argmin()) if not agree.all() else agree.size
    return (prefix == agree.size if exact else prefix >= 1), prefix


def dryrun_multichip(n_ranks: int, device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Spawn `n_ranks` gloo ranks (on the card, or on the CPU with
    device="cpu"), run the three checks of the module docstring
    (`dryrun_rank`), print one summary line and return what it says
    (`dryrun_check`).  Raises on any failed check."""
    from sparktts_tpu_torch.parallel import worker

    args = dryrun_args(n_ranks, device, timeout_s)
    dp, tp, pp = args["axes"]
    ranks = worker.spawn(dryrun_rank, n_ranks, "gloo", args=(args,), device=device,
                         timeout_s=timeout_s, mesh_kwargs=dict(dp=dp, tp=tp, pp=pp),
                         threads=None if args["on_card"] else 1)
    return dryrun_check(ranks, args)


def dryrun_check(ranks, args: dict) -> dict:
    """The checks over every rank's `dryrun_rank` result, in rank order:
    print one summary line and return what it says (with `launches`: each
    kernel's launches by the sharded paths, summed over the ranks; the
    single-rank references' are left out).  Raises on any failed check."""
    on_card = args["on_card"]
    dp, tp, pp = args["axes"]
    n_ranks = len(ranks)
    losses = {r["loss"] for r in ranks}
    if len(losses) != 1 or not np.isfinite(next(iter(losses))):
        raise AssertionError(f"dryrun_multichip: train step losses {sorted(losses)}")
    loss = losses.pop()

    ref = ranks[0]["generate_ref"]
    prefixes = []
    for r in ranks:
        got = r["generate"]
        want = ref[r["dp_rank"] * 2 : r["dp_rank"] * 2 + 2]
        ok, prefix = _agree(want, got, exact=not on_card)
        if not ok:
            raise AssertionError(f"dryrun_multichip: rank {r['rank']}'s generate agrees with "
                                 f"the single-rank run for {prefix} of {want.shape[1]} tokens")
        prefixes.append(prefix)

    ref_wav, ref_ids, _ = ranks[0]["served_ref"]
    leaders = [r for r in ranks if "served" in r]
    samples = 0
    for r in leaders:
        wav, ids, stats = r["served"]
        if stats.get("fused_admissions", 0) < 1:
            raise AssertionError(f"dryrun_multichip: rank {r['rank']}'s admission did not take "
                                 f"the fused path: {stats}")
        if not on_card:
            np.testing.assert_array_equal(wav, ref_wav)
        else:
            ok, prefix = _agree(ref_ids, ids, exact=False)
            if not ok:
                raise AssertionError(f"dryrun_multichip: rank {r['rank']}'s served ids leave the "
                                     "unsharded server's at the first token")
            if np.array_equal(ids, ref_ids):
                peak = float(np.abs(ref_wav).max()) if ref_wav.size else 0.0
                err = (float(np.abs(wav - ref_wav).max()) if wav.shape == ref_wav.shape
                       else np.inf)
                if err > AUDIO_REL_TOL * peak:
                    raise AssertionError(f"dryrun_multichip: rank {r['rank']}'s audio {err} "
                                         f"from the unsharded server's (peak {peak})")
        samples = int(ref_wav.size)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    summary = dict(ranks=n_ranks, dp=dp, tp=tp, pp=pp, loss=loss, generate_shape=ref.shape,
                   generate_prefix=min(prefixes), server_rows=len(leaders), samples=samples,
                   device="cuda" if on_card else "cpu", launches=launches)
    print(f"dryrun_multichip OK: {n_ranks} ranks on the {summary['device']} (dp={dp}, tp={tp}, "
          f"pp={pp}), loss={loss:.4f}, sharded-generate token parity over {ref.shape} verified"
          f"{'' if not on_card else f' (first {min(prefixes)} tokens)'}, sharded serving audio "
          f"parity over {samples} samples verified on {len(leaders)} rows; engine=dense (the "
          f"paged engine refuses a mesh, as in JAX)")
    return summary
