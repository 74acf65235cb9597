"""K1a + K1b, the fused update, against their bound: the flat buffer's
bytes (params and gradients read by K1a; gradients, params, momentum and
target read and params, momentum and target written by K1b, each once)
at the HBM's bandwidth, once per optimizer step traced, over the two
kernels' device time."""
from reference import nets


def read(ctx):
    r, t = ctx["roofline"], ctx["trace"]
    spent = (t.kind_s.get("K1a_segment_norms", 0.0)
             + t.kind_s.get("K1b_fused_apply", 0.0)) if t else 0.0
    if spent <= 0:
        return None
    n = r.flat_elements(nets.param_shapes(ctx["conf"]).values())
    bound = r.bound_s(r.k1a_bytes(n)) + r.bound_s(r.k1b_bytes(n))
    return 100.0 * bound * ctx["out"]["layer"]["steps_traced"] / spent
