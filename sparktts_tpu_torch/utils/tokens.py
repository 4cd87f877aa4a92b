"""The web UIs' 1-5 slider positions for the pitch and speed attributes
(reference `sparktts/utils/token_parser.py`, LEVELS_MAP_UI): the part of the
JAX package's `utils/tokens.py` the port's `serve/ui.py` and `webui.py` read.
The attribute levels themselves are `prompt.LEVELS_MAP`."""

LEVELS_MAP_UI = {
    1: "very_low",
    2: "low",
    3: "moderate",
    4: "high",
    5: "very_high",
}
