"""Share of the profiled sub-window in which no kernel, copy or set ran
on the card (the union of the device's intervals in the trace)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
