"""The window's wall over the decode steps dispatched in it (the
benchmark's count of each `engine.step_begin`'s snapped steps).  Taken over
the whole window, not the trace slice: one dispatch holds up to 64 steps,
which a slice of a few seconds would cut."""


def read(records):
    return records["window_s"] * 1e3 / records["steps"] if records["steps"] else None
