"""A cell at the port's tiny test sizes, for the harness's CPU tests: the
same files' layout as a configuration and a mix under `perfbench/`, a
float32 LM (the CPU's), short budgets."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_config(lm: str = "none") -> dict:
    from sparktts_tpu_torch.config import tiny_test_config

    t = tiny_test_config()
    cfg = json.loads((BENCH / "configs" / "spark-tts-0.5b-int8.json").read_text())
    cfg.update(
        name="tiny", llm=dataclasses.asdict(t.llm), bicodec=dataclasses.asdict(t.bicodec),
        wav2vec2=dataclasses.asdict(t.wav2vec2), server={"max_slots": 4},
        limits={"lm_gap": 1e-3, "wave_err": 1e-4})
    cfg["precision"] = dict(cfg["precision"], lm=lm, int4_group=16)
    return cfg


def tiny_mix() -> dict:
    mix = json.loads((BENCH / "traffic" / "create-c8.json").read_text())
    return dict(mix, clients=4, budgets=[12, 20, 28], repeats=1)
