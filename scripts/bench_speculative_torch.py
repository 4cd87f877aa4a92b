#!/usr/bin/env python
"""Speculative-decoding benchmark of the PyTorch/CUDA port: tok/s and draft
acceptance of self-speculative greedy decode (`lm/speculative.py`: the
first n layers as the draft, exact verification, captured units of rounds)
against vanilla greedy decode at batch 1, full Qwen2.5-0.5B widths.  Random
weights make a shallow draft's acceptance chance, so the sweep brackets it:
draft_layers=24 (draft = target) is the ceiling of the machinery ((k - 1) /
k of the emissions accepted), 6 and 4 the floor of the production draft
shapes (a distilled draft lands in between: `--distill`).

The counterpart of `scripts/bench_speculative.py`: its arguments, plus
`--device` (default $SPARKTTS_PLATFORM, else cuda; it raises without a card
unless the CPU is asked for); `--out` is written under chiprun_out/.  On the
card the `--sanity` cycler teacher takes the LM's head layout in bf16 (the
kernels'), as chip_smoke's phase 32 does.

    python scripts/bench_speculative_torch.py --out SPEC_BENCH_torch.json
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from results_torch import write_result  # noqa: E402

PROMPT_LEN = 128
NEW_TOKENS = 500
SEM_BASE, N_SEM, EOS = 151665, 8192, 151645


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None,
                        help="JSON document, under chiprun_out/ when relative")
    parser.add_argument("--new_tokens", type=int, default=NEW_TOKENS)
    parser.add_argument("--int8", action="store_true", default=True)
    parser.add_argument("--no_int8", dest="int8", action="store_false")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--tiny", action="store_true", help="tiny dims CPU smoke")
    parser.add_argument("--distill", type=int, default=0, metavar="STEPS",
                        help="also distill a 4-layer draft for STEPS optimizer steps "
                        "(lm/distill.py) and measure its acceptance and tok/s")
    parser.add_argument("--sanity", action="store_true",
                        help="run the distillation sanity task (the cycler teacher, a 1-layer "
                        "draft; in-domain acceptance must clear 0.5)")
    parser.add_argument("--sanity_steps", type=int, default=300)
    parser.add_argument("--only_sanity", action="store_true",
                        help="skip the production-width sweep (implies --sanity)")
    parser.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from sparktts_tpu_torch.config import QwenConfig
    from sparktts_tpu_torch.lm import graphs
    from sparktts_tpu_torch.lm.generate import generate
    from sparktts_tpu_torch.lm.speculative import (
        draft_config,
        draft_from_layers,
        speculative_generate_greedy,
    )
    from sparktts_tpu_torch.utils.platform import apply_platform_env, require_device
    from sparktts_tpu_torch.weights import init_qwen

    dev = require_device(args.device or apply_platform_env(), "bench_speculative_torch")
    cfg, dtype = QwenConfig(), torch.bfloat16
    prompt_len, sem_base, n_sem, eos = PROMPT_LEN, SEM_BASE, N_SEM, EOS
    if args.tiny:
        cfg = QwenConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=8, num_attention_heads=4, num_key_value_heads=2,
                         head_dim=16, eos_token_id=0, pad_token_id=1)
        prompt_len, sem_base, n_sem, eos = 16, 100, 100, 0
        args.new_tokens = min(args.new_tokens, 32)
        args.int8, dtype = False, torch.float32
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})",
          file=sys.stderr)

    params = init_qwen(cfg, torch.Generator(device=dev).manual_seed(0), dtype, dev)
    if args.int8:
        from sparktts_tpu_torch.lm.quant import quantize_qwen_int8

        params = quantize_qwen_int8(params)
    gen = np.random.default_rng(0)
    ids = torch.as_tensor(gen.integers(100, 5000 if not args.tiny else 256, (1, prompt_len)),
                          device=dev)
    mask = torch.ones((1, prompt_len), dtype=torch.bool, device=dev)
    new = args.new_tokens
    vocab_slice, extra = (sem_base, sem_base + n_sem), (eos,)
    units = graphs.UnitCache("bench_speculative_torch")
    results = []
    if args.only_sanity:
        args.sanity = True

    def timed(fn):
        with torch.inference_mode():
            out = fn()  # the units' captures and first runs
            t_best = float("inf")
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                out = fn()
                out[0].cpu()  # the host fetch ends the timing
                t_best = min(t_best, time.perf_counter() - t0)
        return out, t_best

    def vanilla():
        return generate(params, cfg, ids, mask, torch.Generator(device=dev).manual_seed(1), new,
                        prompt_len + new, eos_ids=(), pad_id=0, greedy=True, cache_dtype=dtype,
                        vocab_slice=vocab_slice, extra_ids=extra, units=units)

    def spec_row(label, draft, dcfg, k):
        def spec():
            return speculative_generate_greedy(
                params, draft, cfg, dcfg, ids, mask, new, prompt_len + new + k, k=k,
                eos_ids=(), pad_id=0, vocab_slice=vocab_slice, extra_ids=extra,
                cache_dtype=dtype, units=units)

        (tokens, lengths, accepted), t = timed(spec)
        n_out = int(lengths[0])
        # the verify's dense attention and vanilla's decode kernel sum in
        # another order, so on the card the ids may part at a near tie
        apart = (tokens[0, :n_out].cpu() != base_ids[:n_out]).nonzero()
        return {"config": label, "tok_s": round(n_out / t, 1), "ms_total": round(t * 1000, 1),
                "acceptance": round(int(accepted) / max(n_out, 1), 3), "tokens_out": n_out,
                "first_diff_vs_vanilla": int(apart[0, 0]) if apart.numel() else None}

    if not args.only_sanity:
        (base_tokens, _), t = timed(vanilla)
        base_ids = base_tokens[0].cpu()
        base = {"config": "vanilla_greedy", "tok_s": round(new / t, 1),
                "ms_total": round(t * 1000, 1)}
        print(json.dumps(base), file=sys.stderr)
        results.append(base)

    full_layers = cfg.num_hidden_layers
    sweep = () if args.only_sanity else ((full_layers, (4,)), (6, (4,)), (4, (2, 4, 8)))
    for draft_layers, ks in sweep:
        draft = draft_from_layers(params, draft_layers)
        dcfg = draft_config(cfg, draft_layers)
        for k in ks:
            rec = spec_row(f"self_spec_draft{draft_layers}_k{k}", draft, dcfg, k)
            print(json.dumps(rec), file=sys.stderr)
            results.append(rec)
        units.clear()

    if args.distill and not args.only_sanity:
        # a distilled 4-layer draft: acceptance between the random floor and
        # the self-draft ceiling, measured in-domain (prompts of semantic
        # ids) and on the sweep's prompt, with the teacher corpus's
        # degeneracy and the loss curve recorded
        from sparktts_tpu_torch.lm.distill import (
            corpus_stats,
            distill_draft,
            measure_acceptance,
            sample_target_corpus,
        )

        dcfg = draft_config(cfg, 4)
        stats_corpus = sample_target_corpus(params, cfg, torch.Generator(device=dev)
                                            .manual_seed(7), 32, 8, 56, greedy=True,
                                            vocab_slice=vocab_slice, extra_ids=extra)
        teacher_stats = corpus_stats(stats_corpus, prompt_len=8)
        t0 = time.perf_counter()
        draft, losses = distill_draft(params, cfg, dcfg, steps=args.distill, batch=8,
                                      prompt_len=8, gen_len=56, corpus_seqs=128,
                                      vocab_slice=vocab_slice, extra_ids=extra, device=dev)
        train_s = time.perf_counter() - t0
        curve = [round(losses[i], 4) for i in sorted({0, 1, len(losses) // 4, len(losses) // 2,
                                                      3 * len(losses) // 4, len(losses) - 1})]
        acc_in_domain = measure_acceptance(params, draft, cfg, dcfg, n_prompts=4, prompt_len=8,
                                           gen_len=64, k=4, seed=3, vocab_slice=vocab_slice,
                                           extra_ids=extra, device=dev)
        draft = {k: v for k, v in draft.items()}
        from sparktts_tpu_torch.weights import to_torch

        rec = spec_row(f"distilled_draft4_k4_steps{args.distill}", to_torch(draft, dev, dtype),
                       dcfg, 4)
        rec["acceptance_ood_prompt"] = rec.pop("acceptance")
        rec.update(acceptance_in_domain=round(acc_in_domain, 3), distill_loss_curve=curve,
                   teacher_corpus=teacher_stats, distill_train_s=round(train_s, 1))
        print(json.dumps(rec), file=sys.stderr)
        results.append(rec)

    if args.sanity:
        # the cycler teacher (greedy map i -> i + 1 mod h): non-constant and
        # fully predictable, so a distilled 1-layer draft must clear 0.5
        # in-domain acceptance where a random one scores about the floor
        # (fp32 matmuls in full fp32, PyTorch's default: the pass rides
        # greedy argmax agreement)
        from sparktts_tpu_torch.lm.distill import (
            corpus_stats,
            distill_draft,
            make_cycler_teacher,
            measure_acceptance,
            sample_target_corpus,
        )

        heads = (dict(num_attention_heads=14, num_key_value_heads=2, head_dim=64,
                      dtype=torch.bfloat16) if dev.type == "cuda" else {})
        steacher, scfg = make_cycler_teacher(32, shift=1, device=dev, **heads)
        sdcfg = dataclasses.replace(scfg, num_hidden_layers=1)
        s_corpus = sample_target_corpus(steacher, scfg, torch.Generator(device=dev)
                                        .manual_seed(12), 32, 4, 28, greedy=True)
        s_stats = corpus_stats(s_corpus, prompt_len=4)
        t0 = time.perf_counter()
        sdraft, s_losses = distill_draft(steacher, scfg, sdcfg, steps=args.sanity_steps,
                                         batch=8, prompt_len=4, gen_len=24, corpus_seqs=128,
                                         learning_rate=5e-3, seed=5, device=dev)
        s_train_s = time.perf_counter() - t0
        srand = init_qwen(sdcfg, torch.Generator(device=dev).manual_seed(13), torch.float32,
                          dev)
        acc_rand = measure_acceptance(steacher, srand, scfg, sdcfg, n_prompts=8,
                                      prompt_len=4, gen_len=32, k=4, seed=6, device=dev)
        acc_dist = measure_acceptance(steacher, sdraft, scfg, sdcfg, n_prompts=8,
                                      prompt_len=4, gen_len=32, k=4, seed=6, device=dev)
        s_curve = [round(s_losses[i], 4) for i in sorted({0, 1, len(s_losses) // 2,
                                                          len(s_losses) - 1})]
        rec = {"config": f"sanity_distill_cycler32_L1_steps{args.sanity_steps}",
               "acceptance_random_draft": round(acc_rand, 3),
               "acceptance_distilled": round(acc_dist, 3),
               "distill_loss_curve": s_curve, "teacher_corpus": s_stats,
               "distill_train_s": round(s_train_s, 1),
               "pass": acc_dist > 0.5 and acc_rand < 0.25}
        print(json.dumps(rec), file=sys.stderr)
        results.append(rec)

    units.clear()
    doc = {"new_tokens": new, "int8": args.int8, "batch": 1, "backend": dev.type,
           "results": results}
    print(json.dumps(doc, indent=2))
    if args.out:
        write_result(args.out, doc)
    return doc


if __name__ == "__main__":
    main()
