"""Task / attribute special-token maps and their formatters.

A copy of `sparktts_tpu/utils/tokens.py` (reference
`sparktts/utils/token_parser.py:1-155`), so prompts built here tokenize to
the identical id sequences under the checkpoint tokenizer.  `prompt.py`
reads the maps from here; `LEVELS_MAP_UI` is the web UIs' 1-5 slider
positions (`serve/ui.py`, `webui.py`).
"""

from __future__ import annotations

TASK_TOKEN_MAP = {
    "vc": "<|task_vc|>",
    "tts": "<|task_tts|>",
    "asr": "<|task_asr|>",
    "s2s": "<|task_s2s|>",
    "t2s": "<|task_t2s|>",
    "understand": "<|task_understand|>",
    "caption": "<|task_cap|>",
    "controllable_tts": "<|task_controllable_tts|>",
    "prompt_tts": "<|task_prompt_tts|>",
    "speech_edit": "<|task_edit|>",
}

LEVELS_MAP = {
    "very_low": 0,
    "low": 1,
    "moderate": 2,
    "high": 3,
    "very_high": 4,
}

LEVELS_MAP_UI = {
    1: "very_low",
    2: "low",
    3: "moderate",
    4: "high",
    5: "very_high",
}

GENDER_MAP = {
    "female": 0,
    "male": 1,
}

AGE_MAP = {"Child": 0, "Teenager": 1, "Youth-Adult": 2, "Middle-aged": 3, "Elderly": 4}

EMO_MAP = {
    "UNKNOWN": 0,
    "NEUTRAL": 1,
    "ANGRY": 2,
    "HAPPY": 3,
    "SAD": 4,
    "FEARFUL": 5,
    "DISGUSTED": 6,
    "SURPRISED": 7,
    "SARCASTIC": 8,
    "EXCITED": 9,
    "SLEEPY": 10,
    "CONFUSED": 11,
    "EMPHASIS": 12,
    "LAUGHING": 13,
    "SINGING": 14,
    "WORRIED": 15,
    "WHISPER": 16,
    "ANXIOUS": 17,
    "NO-AGREEMENT": 18,
    "APOLOGETIC": 19,
    "CONCERNED": 20,
    "ENUNCIATED": 21,
    "ASSERTIVE": 22,
    "ENCOURAGING": 23,
    "CONTEMPT": 24,
}


class TokenParser:
    """Attribute -> special-token formatters (parity with reference
    `token_parser.py:66-155`); the numeric values are clamped to their
    token ranges."""

    @staticmethod
    def age(age: str) -> str:
        return f"<|age_{AGE_MAP[age]}|>"

    @staticmethod
    def gender(gender: str) -> str:
        return f"<|gender_{GENDER_MAP[gender]}|>"

    @staticmethod
    def mel_value(mel: int) -> str:
        mel = min(1000, max(0, int(mel)))
        return f"<|pitch_value_{mel}|>"

    @staticmethod
    def mel_level(level: str) -> str:
        return f"<|pitch_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def pitch_var_value(pitch_std: int) -> str:
        pitch_std = min(10, max(0, int(pitch_std)))
        return f"<|pitch_var_value_{pitch_std}|>"

    @staticmethod
    def pitch_var_level(level: str) -> str:
        return f"<|pitch_var_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def loudness_value(loudness: int) -> str:
        loudness = min(30, max(0, int(loudness)))
        return f"<|loudness_value_{loudness}|>"

    @staticmethod
    def loudness_level(level: str) -> str:
        return f"<|loudness_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def speed_value(speed: int) -> str:
        speed = min(10, max(0, int(speed)))
        return f"<|speed_value_{speed}|>"

    @staticmethod
    def speed_level(level: str) -> str:
        return f"<|speed_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def task(task: str) -> str:
        return TASK_TOKEN_MAP[task]

    @staticmethod
    def emotion(emotion: str) -> str:
        return f"<|emotion_{EMO_MAP[emotion]}|>"
