"""The LM's model FLOPs over the window (prompt tokens prefilled and tokens
emitted: 2 a weight, attention over each token's real context, the head
over the guided rows; `roofline/counts.py`) as a share of the window's wall
at the card's dense bf16 peak, in percent."""

from perfbench.roofline import counts


def read(records):
    if not records["lm_flops"]:
        return None
    return 100.0 * records["lm_flops"] / (records["window_s"] * counts.BF16_FLOPS)
