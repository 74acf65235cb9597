"""Encoder forward FLOPs of the rows staged in the profiled sub-window
(the program's ``serve/stage`` spans, padding left out) over the card's
busy time in it at the dense bf16 peak: the served batches' share of the
peak while the card works on them."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.busy_s <= 0:
        return None
    rows = sum(s.attrs["rows"] for s in ctx["spans"]
               if s.name == "serve/stage"
               and t.perf_start <= s.t0 < t.perf_start + t.window_s)
    if not rows:
        return None
    flops = ctx["flops"]["forward"] * rows
    return 100.0 * flops / (t.busy_s * ctx["roofline"].PEAK_BF16_FLOPS)
