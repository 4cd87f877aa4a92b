"""End-to-end Spark-TTS: the port's public API.

Port of `SparkTTSPipeline` of `sparktts_tpu/pipeline.py`:

  * voice creation (gender/pitch/speed): the control prompt; the Qwen2.5 LM
    emits both the global speaker tokens and the semantic tokens;
  * voice cloning (a prompt wav): wav2vec2 features and the BiCodec encoder
    tokenize the wav into global and semantic ids, which go into the clone
    prompt; the LM emits semantic tokens only;
  * longform (`inference_long`): sentence-packed segments in one voice;
  * the batch surfaces a server calls: `tokenize_audio_batch(_device)`,
    clone prompts assembled on the device (`assemble_clone_ids_batch`),
    `generate_tokens_batch` with per-row seeds, `detokenize_batch` and the
    fused `generate_and_vocode_batch`; and a voice cache of tokenized
    prompt wavs.

Every mode vocodes with the BiCodec decoder into a 16 kHz waveform.  The
LM's decode replays captured CUDA graphs on the card (`lm/graphs.py`);
token streaming over the same pipeline is `serve/streaming.py`.  The
pipeline runs on the CUDA card unless the caller passes `device="cpu"`;
without a card the default raises instead of falling back to the CPU.
Weights come from a checkpoint directory (`model_dir`, the published
Spark-TTS-0.5B layout, `checkpoint.py`), from numpy or tensor trees with the
JAX package's keys, or at random from `seed`.

Two cards or more: `codec_device` puts the codec stack (wav2vec2 and the
BiCodec) on a card of its own, so that vocoding overlaps the LM's decode;
`shard_llm(mesh)` cuts the LM into this rank's tensor-parallel shard
(`parallel/`), to be served from rank 0 with the other ranks following
(`parallel/worker.py`).  The two are exclusive, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparktts_tpu_torch import checkpoint as ckpt
from sparktts_tpu_torch.codec.bicodec import bicodec_detokenize, bicodec_tokenize
from sparktts_tpu_torch.config import SparkTTSConfig, load_spark_config
from sparktts_tpu_torch.io.audio import get_ref_clip, load_audio
from sparktts_tpu_torch.lm import graphs
from sparktts_tpu_torch.lm.continuous import to_device
from sparktts_tpu_torch.lm.generate import generate
from sparktts_tpu_torch.lm.sample import Generators
from sparktts_tpu_torch.lm.speculative import draft_config, draft_from_layers, speculative_decode
from sparktts_tpu_torch.nn.wav2vec2 import feature_lengths, normalize_input, wav2vec2_features
from sparktts_tpu_torch.parallel.shardings import place, placed_config
from sparktts_tpu_torch.parallel.worker import lead_generate, leader_of
from sparktts_tpu_torch.prompt import (
    HFSparkTokenizer,
    SparkTokenizerBase,
    SyntheticSparkTokenizer,
    build_clone_prompt,
    build_control_prompt,
    clone_prompt_scaffold,
    extract_semantic_ids,
    padded_global_tokens,
)
from sparktts_tpu_torch.utils.platform import require_device
from sparktts_tpu_torch.utils.profiling import stage
from sparktts_tpu_torch.utils.textseg import pack_segments
from sparktts_tpu_torch.weights import (
    bicodec_state,
    fp32_state,
    init_bicodec,
    init_qwen,
    init_wav2vec2,
    qwen_state,
    wav2vec2_state,
)

logger = logging.getLogger(__name__)

#: Where `SparkTTSPipeline(model_dir)` caches the converted trees.
CACHE_DIR = "_torch_cache"
CACHE_TREES = ("bicodec", "wav2vec2", "llm")
_CHECKPOINT_DIRS = ("BiCodec", "wav2vec2-large-xlsr-53", "LLM")


def _checkpoint_stamp(model_dir: Path) -> list:
    """(path, size, mtime) of every weight file the load reads: a cache
    written from other files is not used."""
    files = sorted(f for d in _CHECKPOINT_DIRS for f in (model_dir / d).glob("*")
                   if f.suffix in (".safetensors", ".bin"))
    return [[str(f.relative_to(model_dir)), f.stat().st_size, f.stat().st_mtime_ns]
            for f in files]


def _read_tree_cache(cache_root: Path, stamp: list) -> Optional[dict]:
    """The cached trees, or None when a tree is missing or the stamp that
    was written with them is not `stamp`."""
    try:
        if json.loads((cache_root / "source.json").read_text()) != stamp:
            return None
    except (OSError, ValueError):
        return None
    trees = {name: ckpt.load_param_cache(cache_root / name) for name in CACHE_TREES}
    return None if any(t is None for t in trees.values()) else trees


def _write_tree_cache(cache_root: Path, trees: dict, stamp: list) -> None:
    """Best-effort (a read-only model dir loads all the same): the trees,
    then the stamp, so that an interrupted write leaves no cache that reads."""
    try:
        (cache_root / "source.json").unlink(missing_ok=True)
        for name in CACHE_TREES:
            ckpt.save_param_cache(cache_root / name, trees[name])
        (cache_root / "source.json").write_text(json.dumps(stamp))
    except OSError:
        logger.warning("could not write the param cache under %s", cache_root, exc_info=True)

PROMPT_BUCKET = 64  # default: prompts are left-padded to a multiple of this many tokens
VOCODE_BUCKET = 50  # default: semantic tokens are edge-padded to a multiple of this
MODES = ("control", "clone")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def seed_generators(seed, b: int, device) -> Generators:
    """Sampling generator(s) for a batch of `b` rows.  An int seed gives one
    generator for the whole batch; a sequence of per-row seeds gives one
    generator per row, so each row's draws depend on its own seed alone and
    its ids do not change with the rest of the batch (at equal padding)."""
    if isinstance(seed, (int, np.integer)):
        return torch.Generator(device=device).manual_seed(int(seed))
    seeds = [int(s) for s in seed]
    if len(seeds) != b:
        raise ValueError(f"got {len(seeds)} seeds for a batch of {b}")
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def codec_tokenize(
    w2v_params, bicodec_params, cfg: SparkTTSConfig, wav, feature_mask, ref_wav
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device half of audio tokenization, on the params' device:
    (wav (B, P), feature_mask (B, F), ref_wav (B, R)) -> (global ids
    (B, token_num), semantic ids (B, F / enc_ratio))."""
    feat = wav2vec2_features(w2v_params, wav, cfg.wav2vec2, feature_mask)
    semantic, global_ids = bicodec_tokenize(bicodec_params, cfg.bicodec, feat, ref_wav)
    return global_ids, semantic


def assemble_ids(global_base: int, semantic_base: int, scaffolds, global_ids: torch.Tensor,
                 semantic: torch.Tensor, g_offs, s_offs, n_sems) -> torch.Tensor:
    """Each row's codec ids gathered into its prompt scaffold on the
    device (a masked gather, no host read): scaffolds (B, t_pad) int32 from
    `clone_prompt_scaffold`, left- or right-padded; global_ids (B, N) and
    semantic (B, S_pad) on the device; g_offs, s_offs, n_sems (B,): each
    row's global and semantic offsets and how many semantic ids it takes
    (0 = none).  Host arguments go up without blocking.  Returns (B, t_pad)
    int32 ids, equal to `build_clone_prompt` at those positions."""
    dev = global_ids.device

    def up(a, dtype):
        return a.to(dev) if isinstance(a, torch.Tensor) else to_device(np.asarray(a, dtype), dev)

    scaffolds = up(scaffolds, np.int32)
    g_off, s_off, n_sem = (up(a, np.int64)[:, None] for a in (g_offs, s_offs, n_sems))
    g = global_ids.to(torch.int64)
    s = semantic.to(torch.int64)
    pos = torch.arange(scaffolds.shape[1], device=dev)[None, :]
    n_g = g.shape[1]
    from_g = torch.gather(g, 1, (pos - g_off).clamp(0, n_g - 1)) + global_base
    from_s = torch.gather(s, 1, (pos - s_off).clamp(0, s.shape[1] - 1)) + semantic_base
    in_g = (pos >= g_off) & (pos < g_off + n_g)
    in_s = (pos >= s_off) & (pos < s_off + n_sem)
    return torch.where(in_g, from_g, torch.where(in_s, from_s, scaffolds)).to(torch.int32)


class SparkTTSPipeline:
    """Voice creation, voice cloning and longform at the config's widths
    (default: Spark-TTS-0.5B), plus the batch surfaces of a server.

    `model_dir` loads a checkpoint directory (config, tokenizer and the
    three weight trees; `config` and the `*_params` arguments are then not
    read).  `prompt_bucket` / `wav_bucket_s` set the prompt and wav padding,
    `guided=False` samples the full vocabulary instead of the mode's token
    ranges, `speculative_k > 0` decodes one request speculatively (k drafted
    tokens a round from the first `draft_layers` layers, `lm/speculative.py`;
    the batch and streaming surfaces ignore it), `voice_cache_size > 0`
    keeps that many tokenized prompt voices (LRU), and `codec_device` (a
    card) holds the codec stack apart from the LM: tokenize and vocode run
    there, and ids cross between the two cards."""

    def __init__(
        self,
        model_dir: Optional[str | Path] = None,
        config: Optional[SparkTTSConfig] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        lm_dtype: torch.dtype = torch.bfloat16,
        max_new_tokens: Optional[int] = None,
        prompt_bucket: int = PROMPT_BUCKET,
        wav_bucket_s: float = 1.0,
        guided: bool = True,
        speculative_k: int = 0,
        draft_layers: int = 6,
        voice_cache_size: int = 0,
        llm_params=None,
        bicodec_params=None,
        wav2vec2_params=None,
        codec_device=None,
    ):
        self.device = require_device(device, "SparkTTSPipeline")
        # the decode units of `generate` and `decode_chunk` over this
        # pipeline's LM: they go with the pipeline, or when `llm_params` is
        # replaced (as JAX keeps its program cache per pipeline)
        self.units = graphs.UnitCache("SparkTTSPipeline")
        self._draft = None  # (key, the early-exit draft tree over llm_params)
        self.lm_dtype = lm_dtype
        self.load_seconds: dict = {}
        if model_dir is not None:
            self.config = load_spark_config(model_dir)
            bc = self.config.bicodec
            self.tokenizer: SparkTokenizerBase = HFSparkTokenizer(
                model_dir,
                n_semantic=bc.quantizer.codebook_size,
                n_global=int(np.prod(bc.speaker_encoder.fsq_levels)),
            )
            self._load_params(Path(model_dir))
        else:
            self.config = config or SparkTTSConfig()
            bc = self.config.bicodec
            self.tokenizer = SyntheticSparkTokenizer(
                n_semantic=bc.quantizer.codebook_size,
                n_global=int(np.prod(bc.speaker_encoder.fsq_levels)),
            )
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if llm_params is None:
                self.llm_params = init_qwen(self.config.llm, gen, lm_dtype, self.device)
            else:
                self.llm_params = qwen_state(llm_params, self.device, lm_dtype)
            if bicodec_params is None:
                self.bicodec_params = init_bicodec(bc, gen, self.device)
            else:
                self.bicodec_params = bicodec_state(bicodec_params, self.device)
            if wav2vec2_params is None:
                self.w2v_params = init_wav2vec2(self.config.wav2vec2, gen, self.device)
            else:
                self.w2v_params = wav2vec2_state(wav2vec2_params, self.device)

        # disaggregated serving: the codec stack on a card of its own, so
        # that vocoding overlaps the LM's decode (the reference runs separate
        # Triton model instances; JAX places the trees with device_put)
        self.codec_device = None
        if codec_device is not None:
            self.codec_device = require_device(codec_device, "SparkTTSPipeline codec_device")
            self.bicodec_params = fp32_state(self.bicodec_params, self.codec_device)
            self.w2v_params = fp32_state(self.w2v_params, self.codec_device)
        self.mesh = None  # set by shard_llm

        self.sample_rate = self.config.sample_rate
        self.prompt_bucket = prompt_bucket
        self.wav_bucket = int(wav_bucket_s * self.sample_rate)  # prompt wavs are zero-padded to it
        self.vocode_bucket = VOCODE_BUCKET
        self.max_new_tokens = max_new_tokens or self.config.sampling.max_new_tokens
        self.guided = guided
        # speculative decoding: k > 0 drafts k tokens a round with the first
        # `draft_layers` layers of the LM (views of its stacked layers) and
        # verifies them in one forward; the output distribution is vanilla
        # decode's (lm/speculative.py)
        self.speculative_k = speculative_k
        self.draft_layers = draft_layers
        self._enc_ratio = int(np.prod(bc.encoder.sample_ratios))  # wav2vec2 frames per semantic id
        self._wave_upsample = int(np.prod(bc.decoder.rates)) * int(np.prod(bc.prenet.sample_ratios))

        # tokenized prompt voices, LRU, keyed by content; tokenize is a pure
        # function of the wav, so a hit changes no output
        self.voice_cache_size = voice_cache_size
        self._voice_cache: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._voice_lock = threading.Lock()
        self.voice_cache_stats = {"hits": 0, "misses": 0}
        # per-shape device functions with stable identities (the engines key
        # their registry of ready admissions on them, as JAX keys its jit cache)
        self._fn_cache: dict = {}
        self._fn_lock = threading.Lock()

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    @property
    def llm_params(self):
        return self._llm_params

    @llm_params.setter
    def llm_params(self, tree) -> None:
        """A new LM tree (quantized, reloaded) evicts the decode units that
        close over the old one, and with them the old tree's last holder."""
        self._llm_params = tree
        self._draft = None
        self.units.clear()

    @property
    def draft_params(self):
        """The early-exit draft of `speculative_k`: the first `draft_layers`
        layers of `llm_params`, one tree while both stay (the speculative
        units key on its identity)."""
        key = (id(self._llm_params), self.draft_layers)
        if self._draft is None or self._draft[0] != key:
            self._draft = (key, draft_from_layers(self._llm_params, self.draft_layers))
        return self._draft[1]

    @property
    def codec_dev(self) -> torch.device:
        """The card of the codec stack: `codec_device`, else the LM's."""
        return self.codec_device if self.codec_device is not None else self.device

    def shard_llm(self, mesh) -> None:
        """Make `llm_params` this rank's tensor-parallel shard over
        `mesh.tp` (`parallel.shardings.place` at pp = 1: head-aligned q/k/v
        and gate/up columns, o and down rows, vocabulary rows of the
        embedding) and `config.llm` its shard's config; every rank of the row calls it
        on the same whole tree.  Engines built after it (a server passes
        `mesh=pipeline.mesh`) keep this rank's KV heads.  The codec stays
        whole on this rank, and only rank 0, which serves, uses it: the JAX
        package replicates it over the mesh instead, since there one
        controller runs every program.  A bf16 or fp32 LM only (JAX's specs
        do not match a quantized tree's keys); not with `codec_device` or
        `speculative_k`, and not on a mesh with pp > 1: the served paths cut
        no stages (nor does JAX's `shard_llm`); a staged tree runs through
        `generate` directly (`parallel.shardings.place`)."""
        if self.codec_device is not None:
            raise ValueError("shard_llm and codec_device are mutually exclusive")
        if self.speculative_k > 0:
            raise ValueError("speculative decoding does not run on a tensor-parallel shard")
        if mesh.shape["pp"] > 1:
            raise ValueError(f"shard_llm serves a (dp, tp) mesh; this one has pp="
                             f"{mesh.shape['pp']} (place the LM with parallel.shardings.place "
                             f"and call generate on every stage)")
        whole = self.config.llm
        self.llm_params = place(self.llm_params, whole, mesh)
        self.config = dataclasses.replace(self.config, llm=placed_config(whole, mesh))
        self.mesh = mesh

    def _load_params(self, model_dir: Path) -> None:
        """Read the three checkpoints (`BiCodec/`, `wav2vec2-large-xlsr-53/`,
        `LLM/`), convert them to the JAX trees on the CPU, and upload them
        once: the LM in `lm_dtype`, the codec in fp32.  The converted trees
        (in the checkpoint's dtypes) are cached under
        `<model_dir>/_torch_cache/`, best-effort, as the JAX package caches
        them under `_tpu_cache/`; a later load whose checkpoint files have
        the same sizes and mtimes reads the cache and converts nothing.
        `load_seconds` keeps the time of each stage: `read` and `convert`
        (0 on a cached load), `cache` (reading the cache, or writing it)
        and `upload`."""
        cfg = self.config
        cache_root = model_dir / CACHE_DIR
        stamp = _checkpoint_stamp(model_dir)
        t0 = time.perf_counter()
        trees = _read_tree_cache(cache_root, stamp)
        t1 = time.perf_counter()
        read = convert = 0.0
        cache = t1 - t0
        if trees is None:
            bc_state = ckpt.load_safetensors(model_dir / "BiCodec" / "model.safetensors")
            w2v_state = ckpt.load_hf_state(model_dir / "wav2vec2-large-xlsr-53")
            llm_state = ckpt.load_hf_state(model_dir / "LLM")
            t2 = time.perf_counter()
            trees = {
                "bicodec": ckpt.convert_bicodec(bc_state, cfg.bicodec),
                "wav2vec2": ckpt.convert_wav2vec2(w2v_state, cfg.wav2vec2),
                "llm": ckpt.convert_qwen(llm_state, cfg.llm),
            }
            del bc_state, w2v_state, llm_state
            t3 = time.perf_counter()
            read, convert = t2 - t1, t3 - t2
            _write_tree_cache(cache_root, trees, stamp)
            cache += time.perf_counter() - t3
        t4 = time.perf_counter()
        self.bicodec_params = bicodec_state(trees["bicodec"], self.device)
        self.w2v_params = wav2vec2_state(trees["wav2vec2"], self.device)
        self.llm_params = qwen_state(trees["llm"], self.device, self.lm_dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        upload = time.perf_counter() - t4
        self.load_seconds = {"read": read, "convert": convert, "cache": cache, "upload": upload}

    # ------------------------------------------------------------------
    # voice cache
    # ------------------------------------------------------------------

    def voice_cache_key(self, audio) -> Optional[bytes]:
        """Cache key of a prompt voice, or None when the cache is off.  An
        array is keyed by its content; a path by (realpath, size, mtime), so
        an edited file tokenizes again.  The same bytes as the JAX
        package's keys."""
        if self.voice_cache_size <= 0 or audio is None:
            return None
        if isinstance(audio, (str, Path)):
            st = os.stat(audio)
            basis = f"p:{os.path.realpath(audio)}:{st.st_size}:{st.st_mtime_ns}".encode()
        else:
            a = np.ascontiguousarray(audio)
            basis = b"a:" + str((a.shape, a.dtype)).encode() + a.tobytes()
        return hashlib.blake2b(basis, digest_size=16).digest()

    def voice_cache_get(self, key: Optional[bytes]):
        """(global ids, semantic ids, true semantic count) of a cached voice
        (the ids on the device), else None."""
        if key is None:
            return None
        with self._voice_lock:
            hit = self._voice_cache.get(key)
            if hit is not None:
                self._voice_cache.move_to_end(key)
                self.voice_cache_stats["hits"] += 1
            else:
                self.voice_cache_stats["misses"] += 1
            return hit

    def voice_cache_put(self, key: Optional[bytes], value: tuple) -> None:
        if key is None:
            return
        with self._voice_lock:
            self._voice_cache[key] = value
            self._voice_cache.move_to_end(key)
            while len(self._voice_cache) > self.voice_cache_size:
                self._voice_cache.popitem(last=False)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def inference(
        self,
        text: str,
        prompt_speech_path: Optional[str | Path] = None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
    ) -> np.ndarray:
        """Text -> 16 kHz waveform (float32), in the voice of
        `prompt_speech_path` (a wav path or a 16 kHz float array; with
        `prompt_text`, its transcript) or of gender/pitch/speed."""
        wav, _ = self._synthesize_segment(
            text,
            prompt_speech_path=prompt_speech_path,
            prompt_text=prompt_text,
            gender=gender,
            pitch=pitch,
            speed=speed,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_new_tokens=max_new_tokens,
            seed=seed,
            greedy=greedy,
        )
        return wav

    def _synthesize_segment(
        self,
        text: str,
        prompt_speech_path=None,
        prompt_text=None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
        speaker_globals: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One prompt -> (wav, the codec global ids it was vocoded with: the
        prompt wav's in voice cloning, the LM-emitted ones in voice creation,
        or `speaker_globals` when given: a longform continuation, a clone
        prompt of those global ids alone)."""
        if speaker_globals is not None:
            global_ids = np.asarray(speaker_globals, np.int32).reshape(1, -1)
            ids = build_clone_prompt(self.tokenizer, text, global_ids)
            mode = "clone"
        elif gender is not None:
            ids = build_control_prompt(self.tokenizer, text, gender, pitch, speed)
            mode = "control"
        elif prompt_speech_path is not None:
            global_ids, prompt_semantic = self.tokenize_audio(prompt_speech_path)
            ids = build_clone_prompt(
                self.tokenizer,
                text,
                global_ids,
                prompt_semantic if prompt_text is not None else None,
                prompt_text,
            )
            mode = "clone"
        else:
            raise ValueError(
                "pass prompt_speech_path (voice cloning) or gender/pitch/speed (voice creation)"
            )
        generated = self.generate_tokens(
            ids,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_new_tokens=max_new_tokens,
            seed=seed,
            greedy=greedy,
            mode=mode,
        )
        semantic_ids = extract_semantic_ids(self.tokenizer, generated)
        if mode == "control":
            global_ids = padded_global_tokens(
                self.tokenizer, generated, self.config.bicodec.speaker_encoder.token_num, warn=True
            )
        if semantic_ids.size == 0:
            logger.warning("no semantic tokens generated; returning silence")
            return np.zeros(0, dtype=np.float32), global_ids
        return self.detokenize(global_ids, semantic_ids[None, :]), global_ids

    def inference_long(
        self,
        text: str,
        prompt_speech_path: Optional[str | Path] = None,
        prompt_text: Optional[str] = None,
        gender: Optional[str] = None,
        pitch: Optional[str] = None,
        speed: Optional[str] = None,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
        max_segment_chars: int = 400,
        inter_segment_silence_s: float = 0.1,
    ) -> np.ndarray:
        """Longform synthesis: `text` packed at sentence boundaries into
        segments of at most `max_segment_chars`, each synthesized in one
        voice, joined with `inter_segment_silence_s` of silence between them.

        The first segment sets the voice: the prompt wav's global ids
        (cloning) or the LM-emitted ones (creation); every later segment is
        a clone prompt of exactly those global ids, so the voice cannot
        drift.  Segment i samples with seed `seed + i`."""
        segments = pack_segments(text, max_segment_chars)
        shared = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                      max_new_tokens=max_new_tokens, greedy=greedy)
        if len(segments) <= 1:
            return self.inference(text, prompt_speech_path=prompt_speech_path,
                                  prompt_text=prompt_text, gender=gender, pitch=pitch,
                                  speed=speed, seed=seed, **shared)
        wavs = []
        speaker_globals: Optional[np.ndarray] = None
        for i, segment in enumerate(segments):
            if speaker_globals is None:
                wav, speaker_globals = self._synthesize_segment(
                    segment, prompt_speech_path=prompt_speech_path, prompt_text=prompt_text,
                    gender=gender, pitch=pitch, speed=speed, seed=seed + i, **shared,
                )
            else:
                wav, _ = self._synthesize_segment(
                    segment, speaker_globals=speaker_globals, seed=seed + i, **shared
                )
            if wav.size:
                wavs.append(wav)
        if not wavs:
            return np.zeros(0, dtype=np.float32)
        gap = np.zeros(int(self.sample_rate * max(inter_segment_silence_s, 0.0)), np.float32)
        joined = [wavs[0]]
        for wav in wavs[1:]:
            joined += [gap, wav]
        return np.concatenate(joined)

    # ------------------------------------------------------------------
    # audio tokenization
    # ------------------------------------------------------------------

    def _load_prompt_wav(self, audio) -> np.ndarray:
        """A path is loaded at 16 kHz (with the config's loudness
        normalisation); an array is taken as it is."""
        if isinstance(audio, (str, Path)):
            return load_audio(audio, sampling_rate=self.sample_rate,
                              volume_normalize=self.config.volume_normalize)
        return np.asarray(audio, dtype=np.float64)

    def _pad_wavs(self, wavs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Wavs -> (wav (B, P) float32: each normalised and zero-padded to the
        longest's whole wav bucket; feature_mask (B, F) bool: each row's
        true wav2vec2 frames; the true semantic id count of each row)."""
        cfg = self.config
        lens = [len(w) for w in wavs]
        pad_len = _round_up(max(max(lens), self.wav_bucket), self.wav_bucket)
        wav_in = np.zeros((len(wavs), pad_len), np.float32)
        for i, w in enumerate(wavs):
            wav_in[i, : lens[i]] = (normalize_input(w[None, :])[0] if cfg.wav2vec2.do_normalize
                                    else w)
        frames = [feature_lengths(cfg.wav2vec2, n) for n in lens]
        total = feature_lengths(cfg.wav2vec2, pad_len)
        feature_mask = np.arange(total)[None, :] < np.asarray(frames)[:, None]
        return wav_in, feature_mask, [f // self._enc_ratio for f in frames]

    def _ref_clip(self, wav: np.ndarray) -> np.ndarray:
        cfg = self.config
        return get_ref_clip(wav, self.sample_rate, cfg.ref_segment_duration,
                            cfg.latent_hop_length).astype(np.float32)

    def _cached_fn(self, key: tuple, make):
        with self._fn_lock:
            fn = self._fn_cache.get(key)
            if fn is None:
                fn = self._fn_cache[key] = make()
            return fn

    def _tokenize_fn(self, wav_len: int, ref_len: int):
        """The device half of audio tokenization for one (wav bucket, ref
        clip) shape: fn(w2v params, codec params, wav, feature_mask,
        ref_wav) -> (global ids, semantic ids).  One object per shape."""
        cfg = self.config

        def make():
            def fn(w2v_params, bc_params, wav, feature_mask, ref_wav):
                return codec_tokenize(w2v_params, bc_params, cfg, wav, feature_mask, ref_wav)
            return fn

        return self._cached_fn(("tokenize", wav_len, ref_len), make)

    def _assemble_fn_batch(self, t_pad: int, s_pad: int):
        """`assemble_ids` with this tokenizer's bases, one object per (t_pad,
        S_pad) prompt shape."""
        tok = self.tokenizer
        return self._cached_fn(("assemble_b", t_pad, s_pad), lambda: functools.partial(
            assemble_ids, tok.global_base, tok.semantic_base))

    def tokenize_host_prep(self, audio):
        """Host half of audio tokenization: the wav loaded, normalised and
        zero-padded to whole wav buckets, its wav2vec2 frame mask and its
        reference clip, sent to the device without blocking.  Returns
        (tokenize_fn, tok_args, true semantic count, S_pad): `tokenize_fn(
        *tok_args)` is the device half (`tokenize_audio_device`), or a part
        of a longer chain of device work (the engine's fused admission);
        tok_args = (w2v params, codec params, wav (1, P), feature_mask (1,
        F), ref_wav (1, R))."""
        wav = self._load_prompt_wav(audio)
        wav_in, feature_mask, (true_sem,) = self._pad_wavs([wav])
        ref = self._ref_clip(wav)[None, :]
        fn = self._tokenize_fn(wav_in.shape[1], ref.shape[1])
        tok_args = (self.w2v_params, self.bicodec_params,
                    *(to_device(a, self.codec_dev) for a in (wav_in, feature_mask, ref)))
        return fn, tok_args, true_sem, feature_mask.shape[1] // self._enc_ratio

    _KEY_UNSET = object()

    @torch.inference_mode()
    def tokenize_audio_device(self, audio, cache_key=_KEY_UNSET):
        """Audio path or float array -> (global ids (1, N), semantic ids
        (1, S_pad), true semantic count) with the ids left on the device: the
        count follows from the wav's length, so a caller that assembles the
        prompt on the device never reads the ids.  Through the voice cache;
        `cache_key`: a key the caller already looked up and missed (the get
        is skipped, the put is not)."""
        if cache_key is SparkTTSPipeline._KEY_UNSET:
            cache_key = self.voice_cache_key(audio)
            hit = self.voice_cache_get(cache_key)
            if hit is not None:
                return hit
        fn, tok_args, true_sem, _ = self.tokenize_host_prep(audio)
        with stage("tokenize_audio"):
            global_ids, semantic = fn(*tok_args)
        self.voice_cache_put(cache_key, (global_ids, semantic, true_sem))
        return global_ids, semantic, true_sem

    def tokenize_audio(self, audio) -> Tuple[np.ndarray, np.ndarray]:
        """Audio path or float array -> (global ids (1, token_num), semantic
        ids (1, T)), the semantic ids cropped to the wav's true frames."""
        global_ids, semantic, true_sem = self.tokenize_audio_device(audio)
        return global_ids.cpu().numpy(), semantic[:, :true_sem].cpu().numpy()

    @torch.inference_mode()
    def tokenize_audio_batch_device(self, wavs) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """Float arrays -> (global ids (B, N), semantic ids (B, S_pad), the
        true semantic count of each row), the ids on the device: one padded
        batch through wav2vec2 (with its feature mask) and the BiCodec
        encoder."""
        wavs = [np.asarray(w, dtype=np.float64) for w in wavs]
        wav_in, feature_mask, counts = self._pad_wavs(wavs)
        refs = np.stack([self._ref_clip(w) for w in wavs])
        fn = self._tokenize_fn(wav_in.shape[1], refs.shape[1])
        with stage("tokenize_audio_batch"):
            global_ids, semantic = fn(self.w2v_params, self.bicodec_params,
                                      *(to_device(a, self.codec_dev)
                                        for a in (wav_in, feature_mask, refs)))
        return global_ids, semantic, counts

    def tokenize_audio_batch(self, wavs) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Float arrays -> [(global ids (1, N), semantic ids (1, T_i))], one
        padded batch on the device."""
        global_ids, semantic, counts = self.tokenize_audio_batch_device(wavs)
        global_ids, semantic = global_ids.cpu().numpy(), semantic.cpu().numpy()
        return [(global_ids[i : i + 1], semantic[i : i + 1, :n]) for i, n in enumerate(counts)]

    # ------------------------------------------------------------------
    # clone prompts assembled on the device
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def assemble_clone_ids_batch(self, scaffolds, global_ids, semantic, g_offs, s_offs,
                                 n_sems) -> torch.Tensor:
        """Each row's codec ids gathered into its scaffold on the device
        (`assemble_ids`): (B, t_pad) int32 ids equal to `build_clone_prompt`
        at those positions, on the LM's card (codec ids cross to it)."""
        scaffolds = np.asarray(scaffolds, np.int32)
        return self._assemble_fn_batch(scaffolds.shape[1], semantic.shape[1])(
            scaffolds, global_ids.to(self.device), semantic.to(self.device), g_offs, s_offs,
            n_sems)

    def assemble_clone_ids(self, scaffold, global_ids, semantic, g_off: int, s_off: int,
                           n_sem: int) -> torch.Tensor:
        """One row of `assemble_clone_ids_batch`: (1, t_pad) int32 ids."""
        return self.assemble_clone_ids_batch(np.asarray(scaffold, np.int32)[None, :], global_ids,
                                             semantic, [g_off], [s_off], [n_sem])

    def clone_batch_inputs(
        self,
        texts: Sequence[str],
        global_ids: torch.Tensor,
        semantic: torch.Tensor,
        sem_counts: Sequence[int],
        prompt_texts: Optional[Sequence[Optional[str]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clone prompts of a batch assembled on the device from the
        still-on-device output of `tokenize_audio_batch_device`: (input_ids
        (B, t_pad) int64, mask (B, t_pad) bool), left-padded to the prompt
        bucket as `generate_tokens_batch` pads.  Row i's semantic ids go in
        only with a `prompt_texts[i]`, as `build_clone_prompt` does."""
        prompt_texts = list(prompt_texts) if prompt_texts is not None else [None] * len(texts)
        parts = []
        for text, count, prompt_text in zip(texts, sem_counts, prompt_texts):
            use_sem = count if prompt_text is not None else 0
            parts.append((use_sem,) + clone_prompt_scaffold(
                self.tokenizer, text, global_ids.shape[1], use_sem, prompt_text))
        t_pad = _round_up(max(p[2] for p in parts), self.prompt_bucket)
        b = len(parts)
        rows = np.full((b, t_pad), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((b, t_pad), bool)
        g_offs, s_offs, n_sems = (np.zeros(b, np.int64) for _ in range(3))
        for r, (use_sem, scaffold, plen, g_off, s_off) in enumerate(parts):
            shift = t_pad - plen
            rows[r, shift:] = scaffold
            mask[r, shift:] = True
            g_offs[r], s_offs[r], n_sems[r] = g_off + shift, s_off + shift, use_sem
        ids = self.assemble_clone_ids_batch(rows, global_ids, semantic, g_offs, s_offs, n_sems)
        return ids.long(), torch.from_numpy(mask).to(self.device)

    # ------------------------------------------------------------------
    # LM
    # ------------------------------------------------------------------

    def guided_constraint(self, mode: str = "control"):
        """(vocab_slice, extra_ids) for guided decoding, or (None, ()) with
        `guided=False` (the full vocabulary).  Voice creation ("control")
        emits global and semantic tokens, their start/end markers and EOS;
        voice cloning ("clone") emits semantic tokens and EOS only."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if not self.guided:
            return None, ()
        tok = self.tokenizer
        if mode == "control":
            lo = min(tok.semantic_base, tok.global_base)
            hi = max(tok.semantic_base + tok.n_semantic, tok.global_base + tok.n_global)
            extras = tuple(tok.eos_ids) + tuple(
                tok.token_id(t)
                for t in (
                    "<|start_global_token|>",
                    "<|end_global_token|>",
                    "<|start_semantic_token|>",
                    "<|end_semantic_token|>",
                )
            )
        else:
            lo, hi = tok.semantic_base, tok.semantic_base + tok.n_semantic
            extras = tuple(tok.eos_ids)
        return (lo, hi), tuple(e for e in extras if not lo <= e < hi)

    def _generate(self, input_ids, mask, generator: Generators, max_new: int, temperature,
                  top_k, top_p, greedy, mode) -> Tuple[torch.Tensor, torch.Tensor]:
        """`generate` over this pipeline's LM; on a leading tensor-parallel
        row, announced to the followers first and the ranks' ids checked to
        agree (`parallel/worker.py`)."""
        vocab_slice, extra_ids = self.guided_constraint(mode)
        kwargs = dict(
            max_new_tokens=max_new,
            cache_len=input_ids.shape[1] + max_new,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            eos_ids=tuple(self.tokenizer.eos_ids),
            pad_id=self.tokenizer.pad_id,
            greedy=greedy,
            cache_dtype=self.lm_dtype,
            vocab_slice=vocab_slice,
            extra_ids=extra_ids,
            units=self.units,
        )
        leader = leader_of(self.llm_params)
        if leader is None:
            return generate(self.llm_params, self.config.llm, input_ids, mask, generator,
                            **kwargs)
        return lead_generate(
            leader, lambda: generate(self.llm_params, self.config.llm, input_ids, mask,
                                     generator, **kwargs),
            input_ids, mask, generator, **kwargs)

    def _speculative(self, input_ids, mask, seed: int, max_new: int, temperature, top_k, top_p,
                     greedy, mode):
        """`speculative_decode` over the early-exit draft, with the cache
        `speculative_k` slots longer than vanilla decode's (JAX's
        `generate_tokens`); returns (tokens, lengths, accepted, rounds,
        rejected)."""
        vocab_slice, extra_ids = self.guided_constraint(mode)
        k = self.speculative_k
        return speculative_decode(
            self.llm_params, self.draft_params, self.config.llm,
            draft_config(self.config.llm, self.draft_layers), input_ids, mask,
            None if greedy else torch.Generator(device=self.device).manual_seed(seed),
            max_new, input_ids.shape[1] + max_new + k, k, temperature, top_k, top_p, greedy,
            tuple(self.tokenizer.eos_ids), self.tokenizer.pad_id, vocab_slice, extra_ids,
            self.lm_dtype, self.units)

    def generate_tokens(
        self,
        prompt_ids,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        greedy: bool = False,
        mode: str = "control",
    ) -> np.ndarray:
        """Run the LM on one prompt under `mode`'s guided vocabulary; returns
        the generated ids (new tokens only, up to and including EOS).  On
        the card the decode replays a captured decode unit (`generate`,
        `lm/graphs.py`), which takes the state of this request's generator,
        seeded with `seed`; with `speculative_k > 0` a speculative unit of
        rounds (`lm/speculative.py`)."""
        input_ids, mask = self.prompt_inputs(prompt_ids)
        if self.speculative_k > 0:
            with stage("llm_generate"):
                tokens, lengths, *_ = self._speculative(
                    input_ids, mask, seed, max_new_tokens or self.max_new_tokens, temperature,
                    top_k, top_p, greedy, mode)
                return tokens[0, : int(lengths[0])].cpu().numpy()
        with stage("llm_generate"):
            tokens, lengths = self._generate(
                input_ids, mask, torch.Generator(device=self.device).manual_seed(seed),
                max_new_tokens or self.max_new_tokens, temperature, top_k, top_p, greedy, mode)
            return tokens[0, : int(lengths[0])].cpu().numpy()

    def batch_inputs(self, prompts: Sequence[Sequence[int]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompts -> (input_ids (B, T_pad) int64, mask (B, T_pad) bool) on
        the device, each left-padded with pad_id to a multiple of the
        prompt bucket that holds the longest."""
        t_pad = _round_up(max(max(len(p) for p in prompts), 1), self.prompt_bucket)
        input_ids = np.full((len(prompts), t_pad), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(prompts), t_pad), bool)
        for i, p in enumerate(prompts):
            input_ids[i, t_pad - len(p) :] = p
            mask[i, t_pad - len(p) :] = True
        return torch.from_numpy(input_ids).to(self.device), torch.from_numpy(mask).to(self.device)

    def prompt_inputs(self, prompt_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prompt -> (input_ids (1, T_pad) int64, mask (1, T_pad) bool)."""
        return self.batch_inputs([prompt_ids])

    def generate_tokens_batch(
        self,
        prompts,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed=0,
        greedy: bool = False,
        mode: str = "clone",
    ) -> List[np.ndarray]:
        """Prompt id lists -> generated id arrays (new tokens up to and
        including EOS), as one left-padded batch through one decode unit.
        `seed`: an int (one generator for the batch) or one seed per row
        (`seed_generators`: a row's ids then depend on its own prompt and
        seed alone)."""
        input_ids, mask = self.batch_inputs(prompts)
        with stage("llm_generate_batch"):
            tokens, lengths = self._generate(
                input_ids, mask, seed_generators(seed, len(prompts), self.device),
                max_new_tokens or self.max_new_tokens, temperature, top_k, top_p, greedy, mode)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [tokens[i, : int(n)] for i, n in enumerate(lengths)]

    # ------------------------------------------------------------------
    # vocode
    # ------------------------------------------------------------------

    def _vocode(self, global_tokens, semantic_list) -> List[np.ndarray]:
        semantic_list = [np.asarray(s, np.int64).reshape(-1) for s in semantic_list]
        b = len(semantic_list)
        t_pad = _round_up(max(max(len(s) for s in semantic_list), 1), self.vocode_bucket)
        padded = np.zeros((b, t_pad), np.int64)
        for i, s in enumerate(semantic_list):
            padded[i, : len(s)] = s
            if 0 < len(s) < t_pad:
                padded[i, len(s) :] = s[-1]
        dev = self.codec_dev
        if isinstance(global_tokens, torch.Tensor):
            # ids the device produced stay there: no host round trip
            global_t = global_tokens.to(dev, torch.int64).reshape(b, -1)
        else:
            global_t = to_device(np.asarray(global_tokens, np.int64).reshape(b, -1), dev)
        wav = bicodec_detokenize(self.bicodec_params, self.config.bicodec,
                                 to_device(padded, dev), global_t)
        wav = wav.float().cpu().numpy()
        return [wav[i, : len(s) * self._wave_upsample] for i, s in enumerate(semantic_list)]

    @torch.inference_mode()
    def detokenize(self, global_tokens, semantic_tokens) -> np.ndarray:
        """(global (1, N), semantic (1, T)) -> waveform float32 (T * hop,).
        The global ids may be a device tensor (a device-chained admission's)."""
        with stage("vocode"):
            return self._vocode(global_tokens, [semantic_tokens])[0]

    @torch.inference_mode()
    def detokenize_batch(self, global_tokens, semantic_list) -> List[np.ndarray]:
        """Global ids (B, N), a host array or a device tensor, and B semantic
        id arrays -> B waveforms: one vocode of the batch, each row
        edge-replicated to the longest row's vocode bucket (no spectral step
        at the crop point), then cropped to its own length."""
        with stage("vocode_batch"):
            return self._vocode(global_tokens, semantic_list)

    def _spec_chain_fn(self, batch: int, target: int):
        """The speculative first-chunk chain for one (batch, target): gather
        the listed rows of a dispatch's packed result, take each row's
        `target` ids from its offset as semantic ids (edge-replicated to the
        vocode bucket, as `detokenize` pads), take a controllable row's
        speaker ids from its own emission, vocode the batch, and return the
        flat int32 transfer: the packed result, then the chunks' float32
        bits.  One object per signature."""
        t_pad = _round_up(max(target, 1), self.vocode_bucket)
        cfg, tok = self.config, self.tokenizer
        tn = cfg.bicodec.speaker_encoder.token_num
        up = self._wave_upsample

        def make():
            def fn(bc_params, packed, slot_ids, offs, ctrl, globs):
                rows = packed[slot_ids].long()  # (B, W)
                steps = torch.arange(target, device=packed.device)
                ids = torch.gather(rows, 1, offs[:, None] + steps[None, :])
                sem = (ids - tok.semantic_base).clamp(0, tok.n_semantic - 1)
                pad = torch.arange(t_pad, device=packed.device).clamp(max=target - 1)
                g_pack = (rows[:, 1 : 1 + tn] - tok.global_base).clamp(0, tok.n_global - 1)
                g = torch.where(ctrl[:, None], g_pack, globs)
                wav = bicodec_detokenize(bc_params, cfg.bicodec, sem[:, pad], g)
                bits = wav[:, : target * up].float().contiguous().reshape(-1).view(torch.int32)
                return torch.cat([packed.reshape(-1), bits])
            return fn

        return self._cached_fn(("spec_chain", batch, target, t_pad), make)

    def spec_vocode_chain(self, slot: int, target: int, global_tokens):
        """Single-slot `spec_vocode_chain_multi`."""
        return self.spec_vocode_chain_multi([(slot, target, 0, global_tokens)], 1)

    def spec_vocode_chain_multi(self, specs, batch: int):
        """A `chain_fn` for the continuous engines' `step_begin`: vocode the
        first streaming chunk of every listed slot behind the decode
        dispatch, in the same stream and one batched vocode, and pack the
        waveform bits behind the step result, so the host fetches tokens
        and chunks in one transfer.

        `specs`: (slot, target, sem_off, global ids or None).  A clone
        stream passes its speaker ids (on the device or the host) and
        sem_off 0: its first `target` emissions are taken as semantic ids.
        A controllable stream passes None and sem_off token_num + 2: its
        emission is taken to be the trained layout `<|start_global_token|>
        g * token_num <|end_global_token|> semantic ...`, so the speaker ids
        come from this dispatch's own tokens.  All targets must be equal;
        `batch` pads the rows (repeating row 0) to a warm batch size.  The
        caller validates each row against the fetched tokens and takes the
        normal vocode path for a row that misses.  A validated chunk equals
        `detokenize_batch` of the same rows padded the same way, bit for
        bit."""
        if not specs or batch < len(specs):
            raise ValueError(f"{len(specs)} specs for a batch of {batch}")
        if self.codec_device is not None:
            raise ValueError("the speculative chain vocodes on the LM's card: not with "
                             "codec_device")
        target = specs[0][1]
        if any(t != target for _, t, _, _ in specs):
            raise ValueError("speculative chunks of one chain need one target")
        dev = self.device
        tn = self.config.bicodec.speaker_encoder.token_num
        fn = self._spec_chain_fn(batch, target)
        rows = list(specs) + [specs[0]] * (batch - len(specs))
        slot_ids, offs = (to_device(np.asarray([r[i] for r in rows], np.int64), dev)
                          for i in (0, 2))
        ctrl = to_device(np.asarray([r[3] is None for r in rows]), dev)
        globs = torch.cat([
            torch.zeros((1, tn), dtype=torch.int64, device=dev) if g is None
            else g.to(dev, torch.int64).reshape(1, -1) if isinstance(g, torch.Tensor)
            else to_device(np.asarray(g, np.int64).reshape(1, -1), dev)
            for *_, g in rows
        ])
        bc_params = self.bicodec_params

        def chain(packed: torch.Tensor) -> torch.Tensor:
            return fn(bc_params, packed, slot_ids, offs, ctrl, globs)

        return chain

    @torch.inference_mode()
    def generate_and_vocode_batch(
        self,
        input_ids: torch.Tensor,
        mask: torch.Tensor,
        global_rows: torch.Tensor,
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_new_tokens: Optional[int] = None,
        seed=0,
        greedy: bool = False,
    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Guided voice cloning of a batch with one host fetch: generate ->
        semantic ids extracted on the device -> one vocode -> one copy of
        ids, lengths and waveforms to the host.  input_ids / mask (B, t_pad)
        left-padded (e.g. `clone_batch_inputs`), global_rows (B, token_num),
        all on the device.  In guided clone mode every emission before EOS
        is a semantic id, so extraction is offset arithmetic on the device
        lengths.  Every row vocodes the vocode bucket of `max_new_tokens`;
        with `vocode_bucket` set to that budget the result equals
        `generate_tokens_batch` + `detokenize_batch` bit for bit.  Returns
        (waveforms, generated ids)."""
        if not self.guided:
            raise ValueError("generate_and_vocode_batch needs guided decoding")
        tok = self.tokenizer
        max_new = max_new_tokens or self.max_new_tokens
        b = input_ids.shape[0]
        with stage("llm_generate_vocode_fused"):
            tokens, lengths = self._generate(
                input_ids.to(self.device, torch.int64), mask.to(self.device),
                seed_generators(seed, b, self.device), max_new, temperature, top_k, top_p,
                greedy, "clone")
        last = torch.gather(tokens, 1, (lengths - 1).clamp_min(0)[:, None])[:, 0]
        is_eos = torch.zeros_like(lengths, dtype=torch.bool)
        for e in tok.eos_ids:
            is_eos |= last == e
        sem_count = lengths - (is_eos & (lengths > 0)).long()
        bucket = _round_up(max(max_new, 1), self.vocode_bucket)
        idx = torch.minimum(torch.arange(bucket, device=self.device)[None, :],
                            sem_count.clamp_min(1)[:, None] - 1)
        sem = (torch.gather(tokens, 1, idx) - tok.semantic_base).clamp(0, tok.n_semantic - 1)
        wav = bicodec_detokenize(self.bicodec_params, self.config.bicodec, sem.to(self.codec_dev),
                                 global_rows.to(self.codec_dev, torch.int64).reshape(b, -1))
        flat = torch.cat([
            tokens.int().reshape(-1),
            lengths.int(),
            sem_count.int(),
            wav.float().contiguous().reshape(-1).view(torch.int32),
        ]).cpu().numpy()  # the one host transfer
        toks_h = flat[: b * max_new].reshape(b, max_new).astype(np.int64)
        lens_h = flat[b * max_new : b * max_new + b]
        counts_h = flat[b * max_new + b : b * max_new + 2 * b]
        wav_h = flat[b * max_new + 2 * b :].view(np.float32).reshape(b, -1)
        up = self._wave_upsample
        wavs = [wav_h[i, : counts_h[i] * up] for i in range(b)]
        return wavs, [toks_h[i, : lens_h[i]] for i in range(b)]
