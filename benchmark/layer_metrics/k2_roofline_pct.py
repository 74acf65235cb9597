"""K2, both views of each microbatch, against its bound: the uint8
images read once and the two float32 views written once, once per
microbatch traced, over K2's device time."""


def read(ctx):
    r, t, conf = ctx["roofline"], ctx["trace"], ctx["conf"]
    spent = t.kind_s.get("K2_two_view", 0.0) if t else 0.0
    if spent <= 0:
        return None
    tr = conf["traffic"]
    size = conf["image_size"]
    calls = ctx["out"]["layer"]["steps_traced"] * tr["accum_steps"]
    per_call = r.bound_s(r.k2_bytes(tr["batch_size"] // tr["accum_steps"],
                                    size, size, size))
    return 100.0 * per_call * calls / spent
