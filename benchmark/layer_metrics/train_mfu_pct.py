"""Model FLOPs of the window's untraced steps over the card's dense bf16
peak: the configuration's training FLOPs an image x the batch, over the
host seconds a step of the steps before the profiled sub-window (timed
as ``train_img_s`` times them, the profiler off): the whole training
step's share of the peak."""


def read(ctx):
    step_s = ctx["out"]["layer"]["step_s"]
    if not step_s:
        return None
    img_s = ctx["conf"]["traffic"]["batch_size"] / step_s
    flops = ctx["flops"]["train"] * img_s
    return 100.0 * flops / ctx["roofline"].PEAK_BF16_FLOPS
