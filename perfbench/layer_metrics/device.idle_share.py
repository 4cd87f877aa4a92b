"""The share of the trace slice's wall in which no kernel, copy or set ran
on the card, in percent."""


def read(records):
    tr = records["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
