"""Share of an untraced optimizer step in which the card does no work:
1 - (the card's busy time a traced step: the union of the kernels, copies
and sets launched in the profiled sub-window, each whole, over the steps
traced) / (the host seconds a step of the window's steps before that
sub-window, from the first one's dispatch to a synchronisation after the
last).  Under the profiler the host needs longer a step than without it,
so the profiled sub-window's own idle share would measure the profiler.
The metric so mixes a traced busy time with an untraced step; the
profiler lengthens each kernel a little, so a card busy through all of an
untraced step can read below 0, and the value is reported as it is."""


def read(ctx):
    t, layer = ctx["trace"], ctx["out"]["layer"]
    if t is None or not layer["step_s"]:
        return None
    busy = t.launched_busy_s / layer["steps_traced"]
    return 100.0 * (1.0 - busy / layer["step_s"])
