"""Model FLOPs of the traced run's images/s over the card's dense bf16
peak: the whole training step's share of the peak."""


def read(ctx):
    flops = ctx["flops"]["train"] * ctx["out"]["layer"]["img_s"]
    return 100.0 * flops / ctx["roofline"].PEAK_BF16_FLOPS
