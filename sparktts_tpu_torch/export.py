"""Ahead-of-time export: serialized `torch.export` programs.

Port of `sparktts_tpu/export.py`, which serializes each jitted program with
its weights embedded as StableHLO.  Here each program is `torch.export`ed
from a small module around the function (weights embedded as the
program's constants) and written by `torch.export.save` as a `.pt2` file,
which `load_program` reloads and runs without the model code.  The graph
set and the manifest are JAX's: mel / audio_tokenize / vocoder / lm_prefill
/ lm_decode, at static shapes.  Precision follows the trees, as in JAX: a
bf16 or quantized LM tree gives a bf16 or quantized program.

The hand-written kernels stay in the programs: while exporting, each
kernel wrapper records its `sparktts_torch::` op (`kernels/ops.py`) in
place of a launch, and a loaded program runs the op, whose CUDA
implementation launches the kernel (its CPU one runs the plain version).
`export_program` raises when a program lacks an op it was expected to
hold, so no export records a plain version in a kernel's place.  Programs
of the codec (mel, tokenize, vocoder) record that they run in full fp32,
and `load_program` runs them under `nn/layers.full_fp32` (a program does
not carry PyTorch's TF32 flags).
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

from sparktts_tpu_torch.kernels import ops
from sparktts_tpu_torch.lm.qwen import int8_mlp_fusable
from sparktts_tpu_torch.nn.layers import full_fp32

META = "sparktts.json"
GRAPHS = ("mel", "audio_tokenize", "vocoder", "lm_prefill", "lm_decode")


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, args: Tuple, path: str | Path, kernels: Iterable[str] = (),
                   fp32: bool = False) -> Dict[str, int]:
    """Export fn(*args) (tensors closed over are embedded) and write it to
    `path`.  `kernels`: the ops (`kernels/ops.py` names) the program must
    hold; it raises if one is missing.  `fp32`: trace, and later run, under
    `full_fp32`.  Returns {op: count} of the program's kernel ops."""
    with torch.no_grad(), (full_fp32() if fp32 else contextlib.nullcontext()):
        program = torch.export.export(_Program(fn), tuple(args), strict=False)
    found = ops.graph_ops(program.graph)
    missing = sorted(set(kernels) - set(found))
    if missing:
        raise RuntimeError(f"export_program: {Path(path).name} lacks the kernel ops {missing} "
                           f"(holds {found})")
    meta = {"ops": found, "fp32": fp32}
    torch.export.save(program, str(path), extra_files={META: json.dumps(meta)})
    return found


class LoadedProgram:
    """A loaded program: call it as the exported function.  `module` is the
    runnable graph module, `ops` the kernel ops it holds."""

    def __init__(self, module: torch.nn.Module, meta: dict):
        self.module = module
        self.ops = ops.graph_ops(module.graph)
        self.fp32 = bool(meta.get("fp32"))

    def __call__(self, *args):
        with torch.no_grad(), (full_fp32() if self.fp32 else contextlib.nullcontext()):
            return self.module(*args)


def load_program(path: str | Path) -> LoadedProgram:
    """Load a program written by `export_program` (its kernel ops are
    registered by importing `kernels/ops.py`, which this module does)."""
    extra = {META: ""}
    program = torch.export.load(str(path), extra_files=extra)
    return LoadedProgram(program.module(), json.loads(extra[META] or "{}"))


def _lm_kernels(llm) -> Tuple[str, ...]:
    """The kernel ops a decode step of this LM tree runs: decode attention,
    and the fused int8 MLP or the int4 matvec on a quantized tree."""
    layers = llm["layers"]
    out = ["dense_decode_attention"]
    if int8_mlp_fusable(layers):
        out.append("int8_mlp_matvec")
    if any("w_p4" in sub for sub in layers.values()):
        out.append("int4_matvec")
    return tuple(out)


def export_pipeline_artifacts(
    pipeline,
    out_dir: str | Path,
    wav_seconds: float = 6.0,
    vocoder_tokens: int = 500,
    prompt_len: int = 128,
    decode_len: int = 512,
    graphs: Sequence[str] = GRAPHS,
) -> Dict[str, str]:
    """Export the deployment graph set of a pipeline (weights embedded), on
    the pipeline's device, and write `manifest.json`.  Returns {graph: file}.

      mel            ref wav (1, ref_len) -> mel spectrogram
      audio_tokenize wav (1, wav_len), ref wav -> (semantic, global) ids
      vocoder        (semantic (1, vocoder_tokens), global) int64 ids ->
                     waveform (kernel 3)
      lm_prefill     prompt ids (1, prompt_len) int64 + mask -> last
                     logits and the K/V cache, sized prompt_len + decode_len
      lm_decode      (token (1,), position (1,), start (1,) int32, k, v,
                     write_pos () int32) -> next logits and the cache with
                     the token's K/V at write_pos: one step, attention over
                     [start, write_pos] (kernel 2; kernel 4 on an int8 tree,
                     kernel 5 on an int4 one)

    `graphs` exports a subset (for instance lm_decode of a quantized tree)."""
    from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize, bicodec_tokenize
    from sparktts_tpu_torch.dsp.mel import make_mel_basis, mel_spectrogram
    from sparktts_tpu_torch.lm.qwen import KVCache, init_kv_cache, prefill_inputs, qwen_forward
    from sparktts_tpu_torch.nn.wav2vec2 import wav2vec2_features

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = pipeline.config
    dev = pipeline.device
    sr = cfg.sample_rate
    ref_len = int(cfg.ref_segment_duration * sr) // cfg.latent_hop_length * cfg.latent_hop_length
    wav_len = int(wav_seconds * sr)
    cache_len = prompt_len + decode_len
    w2v, bc, llm = pipeline.w2v_params, pipeline.bicodec_params, pipeline.llm_params
    lm_dtype = pipeline.lm_dtype

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def mel(wav):
        return mel_spectrogram(wav, make_mel_basis(cfg.bicodec.mel_params))

    def tokenize(wav, ref_wav):
        return bicodec_tokenize(bc, cfg.bicodec, wav2vec2_features(w2v, wav, cfg.wav2vec2),
                                ref_wav)

    def vocode(semantic, global_t):
        return bicodec_detokenize(bc, cfg.bicodec, semantic, global_t)

    def lm_prefill(ids, mask):
        cache = init_kv_cache(cfg.llm, ids.shape[0], cache_len, lm_dtype, device=ids.device)
        positions, bias = prefill_inputs(mask, cache_len)
        logits, cache = qwen_forward(llm, cfg.llm, ids, positions, cache, 0, bias,
                                     logits_last_only=True)
        return logits[:, -1], cache.k, cache.v

    def lm_decode(tok, position, start, k, v, write_pos):
        pos = write_pos.reshape(1).expand(tok.shape[0]).contiguous()
        cache = KVCache(k=k.clone(), v=v.clone())  # the program returns a new cache
        logits, cache = qwen_forward(llm, cfg.llm, tok[:, None], position[:, None], cache, pos,
                                     None, decode_window=(start, pos))
        return logits[:, -1], cache.k, cache.v

    kv_shape = (cfg.llm.num_hidden_layers, 1, cache_len, cfg.llm.num_key_value_heads,
                cfg.llm.head_dim)
    float_units = "w" in bc["decoder"]["blocks"][0]["res_units"][0]["conv1"]
    specs = {
        "mel": (mel, (zeros(1, ref_len),), (), True),
        "audio_tokenize": (tokenize, (zeros(1, wav_len), zeros(1, ref_len)), (), True),
        "vocoder": (vocode, (zeros(1, vocoder_tokens, dtype=torch.long),
                             zeros(1, cfg.bicodec.speaker_encoder.token_num, dtype=torch.long)),
                    ("fused_residual_unit",) if float_units else (), True),
        "lm_prefill": (lm_prefill, (zeros(1, prompt_len, dtype=torch.long),
                                    torch.ones((1, prompt_len), dtype=torch.bool, device=dev)),
                       (), False),
        "lm_decode": (lm_decode, (zeros(1, dtype=torch.long), zeros(1, dtype=torch.long),
                                  zeros(1, dtype=torch.int32), zeros(*kv_shape, dtype=lm_dtype),
                                  zeros(*kv_shape, dtype=lm_dtype), zeros(dtype=torch.int32)),
                      _lm_kernels(llm), False),
    }
    manifest: Dict[str, str] = {}
    for name in graphs:
        fn, args, kernels, fp32 = specs[name]
        manifest[name] = f"{name}.pt2"
        export_program(fn, args, out / manifest[name], kernels=kernels, fp32=fp32)
    with open(out / "manifest.json", "w") as f:
        json.dump({"graphs": manifest, "sample_rate": sr, "wav_len": wav_len,
                   "ref_len": ref_len, "vocoder_tokens": vocoder_tokens,
                   "prompt_len": prompt_len, "decode_len": decode_len}, f, indent=2)
    return manifest
