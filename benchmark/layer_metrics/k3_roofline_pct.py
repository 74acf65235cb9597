"""K3, flash attention, against its bound: for each batch dispatched in
the profiled sub-window, max(q, k, v, o bytes once at the HBM's
bandwidth, 4 B H S^2 D FLOPs at the bf16 peak) at its bucket's size; the
mean bound of a call times the K3 calls traced, over K3's device time."""


def read(ctx):
    r, t, conf = ctx["roofline"], ctx["trace"], ctx["conf"]
    spent = t.kind_s.get("flash_attention", 0.0) if t else 0.0
    calls = t.kind_calls.get("flash_attention", 0) if t else 0
    if spent <= 0:
        return None
    buckets = [s.attrs["bucket"] for s in ctx["spans"]
               if s.name == "serve/dispatch"
               and t.perf_start <= s.t0 < t.perf_start + t.window_s]
    if not buckets:
        return None
    arch = conf["arch"]
    seq = (conf["image_size"] // arch["patch"]) ** 2 + 1
    mean = sum(r.k3_bound_s(b, arch["heads"], seq,
                            arch["width"] // arch["heads"])
               for b in buckets) / len(buckets)
    return 100.0 * mean * calls / spent
